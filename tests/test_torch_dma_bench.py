"""The port's row-copy micro-benchmark (recommenders_addons_tpu_torch/
tools/dma_bench.py) against the JAX package's tools/dma_bench.py, whose
Pallas kernels run here through the Pallas interpreter.

The JAX tool parses ``sys.argv`` (capacity, chunks) when it is imported
and reads ``CH`` as a module global, so each chunk count loads its own
copy of it, with ``sys.argv`` patched, and with its ``pl`` swapped for a
namespace whose ``pallas_call`` interprets. The file itself is untouched.

On the CPU the port's callables run their plain PyTorch versions; the
CUDA kernels are held against those on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py. Tables hold random
32-bit words (NaN bit patterns included) and everything is data
movement, so every comparison is bit-exact (int32 views), over the rows
the reference defines: its predicated-off gather rows are unwritten and
its out-of-range unpredicated copies undefined."""

import functools
import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from recommenders_addons_tpu_torch.tools import dma_bench

LANES = 128
CAP = 1024
_JAX_TOOL = Path(__file__).resolve().parent.parent / "tools" / "dma_bench.py"


@pytest.fixture(scope="module")
def jax_tool():
    """jax_tool(ch): the JAX tool loaded at CAP and ``ch`` chunks."""
    loaded = {}

    def load(ch):
        if ch not in loaded:
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(sys, "argv", ["dma_bench", str(CAP.bit_length()
                                                          - 1), str(ch)])
                spec = importlib.util.spec_from_file_location(
                    f"jax_dma_bench_ch{ch}", _JAX_TOOL)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
            assert (mod.CAP, mod.CH) == (CAP, ch)
            interp = types.SimpleNamespace(**vars(pl))
            interp.pallas_call = functools.partial(pl.pallas_call,
                                                   interpret=True)
            mod.pl = interp
            loaded[ch] = mod
        return loaded[ch]

    return load


def _words(rows, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        size=(rows, LANES), dtype=np.int32).view(np.float32)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _odd_indices(idx):
    """Sentinels, negatives and past-the-end indices among ``idx``."""
    idx = idx.copy()
    idx[::7] = CAP
    idx[3::11] = -1
    idx[5::13] = CAP + 3
    return idx


PRED_GATHER = dict(nbuf=8, predicated=True, bitand=False, unroll=4)
GATHER_CASES = (
    [(name, kw, 1 + i % 2) for i, (name, kw) in
     enumerate(dma_bench.VARIANTS)]
    + [("predicated", dict(PRED_GATHER, premul=False), 2),
       ("predicated premul", dict(PRED_GATHER, premul=True), 2)])


@pytest.mark.parametrize("name,kw,ch", GATHER_CASES,
                         ids=[c[0] for c in GATHER_CASES])
def test_gather_matches_jax_tool(jax_tool, name, kw, ch):
    mod = jax_tool(ch)
    table = _words(CAP * ch, seed=ch)
    rng = np.random.default_rng(len(name))
    idx = rng.integers(0, CAP, size=1024).astype(np.int32)
    if kw.get("predicated"):
        idx = _odd_indices(idx)
    jkw = dict(kw)
    if jkw.pop("grouped", False):
        want = mod.make_gather_grouped(**jkw)(jnp.asarray(table),
                                              jnp.asarray(idx))
    else:
        want = mod.make_gather(**jkw)(jnp.asarray(table), jnp.asarray(idx))
    fn = dma_bench.make_variant(kw, ch=ch, scatter=False)
    got = fn(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (1024 * ch, LANES)
    # rows the reference writes: all, or those its predicate lets through
    base = idx.astype(np.int64) * ch
    tested = base if kw.get("premul") else idx
    live = np.ones(1024, bool)
    if kw.get("predicated"):
        live = (tested >= 0) & (tested < CAP)
        assert 0 < live.sum() < 1024
        dead = ~np.repeat(live, ch)
        assert not _bits(got.numpy())[dead].any()  # the port writes zeros
    rows = np.repeat(live, ch)
    np.testing.assert_array_equal(_bits(got.numpy())[rows],
                                  _bits(want)[rows])


SC_CASES = (
    [(name, kw, 2 - i % 2) for i, (name, kw) in
     enumerate(dma_bench.SC_VARIANTS)]
    + [("predicated", dict(nbuf=8, predicated=True, unroll=4, extra_rows=1,
                           premul=False), 2)])


@pytest.mark.parametrize("name,kw,ch", SC_CASES, ids=[c[0] for c in SC_CASES])
def test_scatter_matches_jax_tool(jax_tool, name, kw, ch):
    mod = jax_tool(ch)
    table = _words((CAP + 1) * ch, seed=10 + ch)  # with its trash row
    rng = np.random.default_rng(len(name))
    n = 1024
    idx = np.concatenate([rng.permutation(CAP)[:n - n // 8],
                          np.full(n // 8, CAP)]).astype(np.int32)
    rng.shuffle(idx)
    if kw.get("predicated"):
        idx = _odd_indices(idx)
    rows = _words(n * ch, seed=20 + ch)
    jkw = dict(kw)
    if jkw.pop("grouped", False):
        make = mod.make_scatter_grouped
    else:
        make = mod.make_scatter
    want = make(**jkw)(jnp.asarray(table), jnp.asarray(idx),
                       jnp.asarray(rows))
    tbl = torch.from_numpy(table.copy())
    fn = dma_bench.make_variant(kw, ch=ch, scatter=True)
    out = fn(tbl, torch.from_numpy(idx), torch.from_numpy(rows))
    assert out is tbl  # in place
    live = CAP * ch  # never the trash row
    assert not np.array_equal(_bits(out.numpy())[:live], _bits(table)[:live])
    np.testing.assert_array_equal(_bits(out.numpy())[:live],
                                  _bits(want)[:live])


def test_main_runs_on_the_cpu(monkeypatch):
    monkeypatch.setattr(dma_bench, "BATCHES", (64, 256))
    monkeypatch.setattr(dma_bench, "STEPS", 2)
    monkeypatch.setattr(dma_bench, "REPS", 1)
    out = dma_bench.main(["10", "1"], device="cpu")
    assert out["device"] == "cpu" and (out["cap"], out["ch"]) == (1024, 1)
    want_g = [n for n, _ in dma_bench.VARIANTS] + [
        "row_gather (kernel 1)", "torch.index_select"]
    want_s = [n for n, _ in dma_bench.SC_VARIANTS] + [
        "row_scatter (kernel 2)", "torch.Tensor.index_copy_"]
    assert list(out["gather"]) == want_g and list(out["scatter"]) == want_s
    for e in [*out["gather"].values(), *out["scatter"].values()]:
        assert np.isfinite(e["ns_per_row"]) and e["ms"] > 0
        assert e["bound_ms"] is None  # no card: no device bound


def test_main_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dma_bench.main(["10", "1"])


def test_tool_imports_no_jax():
    code = ("import sys, recommenders_addons_tpu_torch.tools.dma_bench; "
            "bad = [m for m in ('jax', 'recommenders_addons_tpu') "
            "if m in sys.modules]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
