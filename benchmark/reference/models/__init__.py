"""The model families' plain forward passes, one file each,
``benchmark/reference/models/<family>.py``, found by a configuration's
``family``. Each defines ``shapes(cfg)`` (every dense leaf's shape by the
program's parameter name), ``logits(cfg, w, x_dense, emb)``, ``RAW_INPUT``
(the leaves whose input is the raw dense features, which need no input
gradient) and ``extra_train_flops(cfg)`` (products that are not weight
matrices, per example)."""

import importlib


def load(family: str):
    return importlib.import_module(f"benchmark.reference.models.{family}")
