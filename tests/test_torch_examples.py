"""The port's nine examples (``recommenders_addons_tpu_torch/examples``)
run in process on the CPU at small sizes: each ``main([..., "--device",
"cpu"])`` returns 0 and prints its JAX counterpart's result lines. The
DLRM and MovieLens examples read fabricated files (as
``tests/test_data.py`` makes them) and meet that file's bars: a held-out
AUC above 0.8 and an eval MSE below 0.8. Sizes the command lines do not
reach (the DLRM table's capacity, the bp_v2 and retrieval demos' step
counts) are shrunk by binding the functions the examples call."""

import functools
import importlib

import numpy as np
import pytest
import torch

from recommenders_addons_tpu_torch.models import dlrm, retrieval
from test_torch_data import write_movielens


def write_learnable_criteo(path, n=2000):
    """Criteo-format lines whose label follows a hot categorical token 90%
    of the time."""
    rng = np.random.default_rng(1)
    with open(path, "w") as f:
        for _ in range(n):
            hot = rng.integers(0, 2)
            label = hot if rng.random() < 0.9 else 1 - hot
            dense = [str(rng.integers(0, 100)) for _ in range(13)]
            cats = [f"v{rng.integers(0, 50)}" for _ in range(26)]
            cats[0] = f"hot{hot}"
            f.write("\t".join([str(label)] + dense + cats) + "\n")


def _last_number(out, marker):
    line = [ln for ln in out.splitlines() if marker in ln][-1]
    return float(line.rsplit(" ", 1)[1])


def _dlrm(tmp_path, monkeypatch):
    p = str(tmp_path / "train.tsv")
    write_learnable_criteo(p)
    monkeypatch.setattr(dlrm, "DLRMConfig", functools.partial(
        dlrm.DLRMConfig, table_capacity=1 << 14))
    return ["--data", p, "--steps", "60", "--batch-size", "256", "--dim",
            "8", "--eval-batches", "2"]


def _movielens(tmp_path, monkeypatch):
    p = str(tmp_path / "ratings.dat")
    write_movielens(p, n=4000)
    return ["--data", p, "--steps", "80", "--batch-size", "256",
            "--eval-batches", "2"]


def _bpv2(tmp_path, monkeypatch):
    mod = importlib.import_module(
        "recommenders_addons_tpu_torch.examples.bpv2_train")
    monkeypatch.setattr(mod, "train", functools.partial(mod.train, steps=8,
                                                        batch=64))
    return []


def _retrieval(tmp_path, monkeypatch):
    monkeypatch.setattr(retrieval, "run_demo", functools.partial(
        retrieval.run_demo, steps=20))
    return []


# example -> (argv maker, result-line markers, check of the output)
EXAMPLES = {
    "dlrm_train": (_dlrm, ["steps in", "AUC ("],
                   lambda out: _last_number(out, "AUC (") > 0.8),
    "movielens_train": (_movielens, ["final: train_mse=", "eval_mse ("],
                        lambda out: _last_number(out, "eval_mse (") < 0.8),
    "fp16_compress_serving": (
        lambda *_: ["--steps", "6", "--batch-size", "64"],
        ["step 0: mse=", "rows as fp16", "served lookup: "], None),
    "warm_start_train": (
        lambda *_: ["--steps", "10", "--batch-size", "64"],
        ["phase 1 trained eval_mse=", "-> warm-started eval_mse="], None),
    "restrict_growth": (
        lambda *_: ["--steps", "20", "--batch-size", "128",
                    "--num-reserved", "512", "--trigger", "768"],
        ["step 20: loss=", "final live keys: "],
        lambda out: "cap honored: True" in out),
    "bpv2_train": (_bpv2, ["assign-mode  loss:", "bp_v2 (delta) loss:"],
                   lambda out: "single-writer rows agree: True" in out),
    "terabyte_hybrid": (lambda *_: [], ["device live:", "restored: device"],
                        lambda out: "every row survived" in out),
    "retrieval_train": (_retrieval, ["final: loss=", "group-recall@10="],
                        None),
    "seq_and_dense_train": (
        lambda *_: ["--steps", "10", "--batch-size", "64"],
        ["final: train_mse=", " eval_mse="], None),
}


@pytest.fixture
def one_thread():
    """One intra-op thread while an example trains: its matrices are
    small, and when every pytest-xdist worker defaults to all cores the
    host is oversubscribed, where a multi-threaded step can run many
    times slower than a single-threaded one."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, tmp_path, monkeypatch, capsys,
                             one_thread):
    make_argv, markers, check = EXAMPLES[name]
    argv = make_argv(tmp_path, monkeypatch)
    mod = importlib.import_module(
        f"recommenders_addons_tpu_torch.examples.{name}")
    assert mod.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for m in markers:
        assert m in out, (m, out[-2000:])
    if check is not None:
        assert check(out), out[-2000:]
