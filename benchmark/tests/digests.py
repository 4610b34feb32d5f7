"""SHA-256 digests of what the general generator and the reference give
for the small cut of a cell: the pool, the first batch's keys, and every
reading of the reference's three steps. ``parent_readings.json`` holds
them as the one-hot harness gave them before bags were added, for
``test_bench_multi_hot``."""

from __future__ import annotations

import dataclasses
import hashlib

import torch

from benchmark.lib import inputs
from benchmark.reference import train as ref_train
from benchmark.tests.small import small

SEEDS = (2 ** 32 + 101, 2 ** 31 + 7)


def digest(t) -> str:
    t = torch.as_tensor(t).detach().cpu().contiguous()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes() if t.numel() else b"")
    return h.hexdigest()


def readings(cell: str, seed: int) -> dict:
    _, _, cfg, mix = small(cell)
    pool = inputs.Pool(cfg, mix, seed, 4, "cpu")
    out = {f"pool.{k}": digest(getattr(pool, k))
           for k in ("sparse", "dense", "label")}
    out["keys0"] = digest(inputs.tag(pool[0]["sparse"], cfg["feature_shift"],
                                     inputs.column_features(cfg)))
    plan = inputs.prefill(cfg, mix, "cpu")
    weights = inputs.dense_weights(cfg, seed, "cpu")
    batches = [inputs.batch(cfg, mix, seed, k, "cpu") for k in range(3)]
    ref = ref_train.run(cfg, mix, seed, plan, weights, batches)
    for f in dataclasses.fields(ref):
        v = getattr(ref, f.name)
        if isinstance(v, dict):
            for k in sorted(v):
                out[f"ref.{f.name}.{k}"] = digest(v[k])
        elif isinstance(v, list):
            out[f"ref.{f.name}"] = digest(torch.tensor(v,
                                                       dtype=torch.float64))
        else:
            out[f"ref.{f.name}"] = digest(v)
    return out
