"""The port's two probe tools (recommenders_addons_tpu_torch/tools/
ab_kernel_cost.py and ab_radix_plan.py) against the JAX package's
tools/ab_kernel_cost.py and tools/ab_radix_plan.py, whose Pallas kernels
run here through the Pallas interpreter.

Each JAX tool is loaded from its file with its ``pl`` swapped for a
namespace whose ``pallas_call`` interprets; ``ab_radix_plan`` parses
``sys.argv`` when it is imported, so it is loaded with ``sys.argv``
patched. The fused-apply kernel reads its row tile ``_TILE`` as a global
when it is traced: the copy here runs with a 128-row tile (it only sets
how many rows one grid step takes), and ``sub`` is passed explicitly,
since its default was bound to the 1,024-row tile. The files themselves
are untouched, and neither tool's ``main()`` runs here: its table is
2 GiB.

On the CPU the port's callables run their plain PyTorch versions; the
CUDA kernels are held against those on the card by
tests/test_torch_cuda_kernels.py and chip_smoke.py. Tolerances:
``identity``, ``rawcopy``, the histogram, the sorted rotations and
positions, and the plan's integer sums are bit-exact; Adam's updated
words agree within 4 f32 ulps (``pow`` and the divisions round
independently), its pad columns are exactly 0.0, and rows it does not
write are bit-exact; the position-weighted f32 sums of ``sort_pair``
agree within rtol 1e-5 (f32 sums taken in another order)."""

import functools
import importlib.util
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import hashing as jhashing
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.tools import ab_kernel_cost, ab_radix_plan

_TOOLS = Path(__file__).resolve().parent.parent / "tools"
LANES = 128


def _load(name, argv=None):
    """The JAX tool ``tools/<name>.py``, interpreting its kernels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", [name] + list(argv or []))
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", _TOOLS / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    interp = types.SimpleNamespace(**vars(pl))
    interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    mod.pl = interp
    return mod


@pytest.fixture(scope="module")
def jax_cost():
    mod = _load("ab_kernel_cost")
    mod._TILE = 128
    return mod


@pytest.fixture(scope="module")
def jax_radix():
    return _load("ab_radix_plan")


def _ulps32(a: np.ndarray, b: np.ndarray) -> int:
    def ordered(x):
        i = x.view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _fused_inputs(cap=1024, n=256, seed=0):
    """A table of random f32 values with its trash row, unique indices,
    and packed rows and grads of positive values: ``v >= 0`` (else Adam
    gives NaNs), and no sum cancels, so the interpreter's compiled
    program, which may contract a product and a sum into one rounding,
    stays within a few ulps of separately rounded operations."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=((cap + 1) * 2, LANES)).astype(np.float32)
    idx = rng.permutation(cap)[:n].astype(np.int32)
    packed = rng.uniform(0.05, 1.0, size=(n, 256)).astype(np.float32)
    g = rng.uniform(0.01, 0.1, size=(n, 64)).astype(np.float32)
    return table, idx, packed, g


@pytest.mark.parametrize("mode", ["adam", "identity", "rawcopy"])
def test_fused_matches_jax_tool(jax_cost, mode):
    table, idx, packed, g = _fused_inputs(seed=len(mode))
    want = np.asarray(jax_cost.make_fused(mode, sub=64, nbuf=32)(
        jnp.asarray(table), jnp.asarray(idx), jnp.asarray(packed),
        jnp.asarray(g), 3))
    tbl = torch.from_numpy(table.copy())
    fn = ab_kernel_cost.make_fused(mode, sub=64, nbuf=32)
    out = fn(tbl, torch.from_numpy(idx), torch.from_numpy(packed),
             torch.from_numpy(g), 3)
    assert out is tbl  # in place
    got = out.numpy().reshape(-1, 256)
    want = want.reshape(-1, 256)
    written = np.zeros(got.shape[0], bool)
    written[idx] = True
    np.testing.assert_array_equal(got[~written].view(np.int32),
                                  want[~written].view(np.int32))
    if mode == "adam":
        assert _ulps32(got[written, :192], want[written, :192]) <= 4
        assert not got[written, 192:].view(np.int32).any()  # +0.0 exactly
        assert not np.array_equal(got[written, :64], packed[:, :64])
    else:
        np.testing.assert_array_equal(got[written].view(np.int32),
                                      want[written].view(np.int32))


def test_fused_geometry_arguments():
    table, idx, packed, g = _fused_inputs(cap=64, n=40, seed=9)
    args = [torch.from_numpy(a) for a in (idx, packed, g)]
    want = torch.from_numpy(table.copy())
    ab_kernel_cost.ab_fused_plain(want, *args, 2, mode="adam")
    for sub in ab_kernel_cost.SUBS:
        for nbuf in ab_kernel_cost.NBUFS:
            t = torch.from_numpy(table.copy())
            ab_kernel_cost.make_fused("adam", sub=sub, nbuf=nbuf)(t, *args, 2)
            assert torch.equal(t.view(torch.int32), want.view(torch.int32))
    for kw in (dict(sub=32), dict(sub=256), dict(nbuf=16), dict(nbuf=128)):
        with pytest.raises(ValueError):
            ab_kernel_cost.make_fused("adam", **kw)
    with pytest.raises(ValueError):
        ab_kernel_cost.make_fused("sgd")
    fn = ab_kernel_cost.make_fused("identity")
    with pytest.raises(ValueError):  # g of the wrong width
        fn(torch.from_numpy(table), args[0], args[1], args[2][:, :32], 0)


def test_hist_matches_jax_tool(jax_radix):
    rng = np.random.default_rng(5)
    bids = rng.integers(-5000, 50000, size=16384).astype(np.int32)
    want = np.asarray(jax_radix.pallas_hist(jnp.asarray(bids), 1 << 15))
    got = ab_radix_plan.pallas_hist(torch.from_numpy(bids), 1 << 15)
    assert got.dtype == torch.int32 and got.shape == (1024,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(),
                                  np.bincount(bids & 1023, minlength=1024))


@pytest.mark.parametrize("i", [0, 1])
def test_sort_pair_matches_jax_expression(i):
    """The JAX tool's sort step (tools/ab_radix_plan.py:185-198) at 4,096
    keys of a 2Mi-slot table's 32Ki buckets."""
    b, nb = 4096, 1 << 15
    rng = np.random.default_rng(1)
    ids = rng.choice(np.arange(1, 1 << 22, dtype=np.int64), size=b,
                     replace=False)
    keys = jnp.asarray(ids if i % 2 == 0 else ids[::-1])
    m = jhashing.mix(keys)
    w = m.dtype.itemsize * 8
    nb_bits = nb.bit_length() - 1
    rot = (m << (w - nb_bits)) | (m >> nb_bits)
    rs, order = jax.lax.sort((rot, jnp.arange(b, dtype=jnp.int32)),
                             num_keys=1)
    wt = jnp.arange(b, dtype=jnp.float32) * 1e-6
    s_order = jnp.sum(order.astype(jnp.float32) * wt)
    s_rot = jnp.sum(rs.astype(jnp.uint32).astype(jnp.float32) * wt)

    t_rs, t_order = ab_radix_plan.sort_pair_step(torch.from_numpy(ids), i,
                                                 nb)
    np.testing.assert_array_equal(t_rs.numpy(),
                                  np.asarray(rs).view(np.int64))
    np.testing.assert_array_equal(t_order.numpy(), np.asarray(order))
    t_s_order, t_s_rot = ab_radix_plan.sort_pair_sums(t_rs, t_order)
    np.testing.assert_allclose(float(t_s_order), float(s_order), rtol=1e-5)
    np.testing.assert_allclose(float(t_s_rot), float(s_rot), rtol=1e-5)


def test_plan_sums_match_jax_tool():
    """``plan_hit`` / ``plan_miss`` steps (tools/ab_radix_plan.py:225-233)
    at a 4Ki-slot table filled as the tool fills it, 256 keys."""
    cap, n = 4096, 256
    rng = np.random.default_rng(0)
    pool = rng.choice(np.arange(1, cap * 2, dtype=np.int64), size=2 * n,
                      replace=False)
    jv = jde.Variable(name="abradix", dim=64, init_capacity=cap,
                      initializer=jax.nn.initializers.normal(0.05))
    tv = tde.Variable(name="abradix", dim=64, init_capacity=cap,
                      initializer=tde.initializers.normal(0.05),
                      device="cpu")
    jst, tst = jv.init(), tv.init()
    fill = jax.jit(lambda s, k: jv.upsert(s, k, jnp.zeros((n, 64))))
    for part in (pool[:n], pool[n:]):
        jst = fill(jst, jnp.asarray(part))
        tst = tv.upsert(tst, torch.from_numpy(part), torch.zeros((n, 64)))
    plan = jax.jit(lambda st, k: jht.plan_lookup(jv.spec, st, k))
    ids = pool[:n]
    for miss in (False, True):
        jacc = jnp.zeros(())
        tacc = torch.zeros(())
        for i in range(2):
            keys = jnp.asarray(ids if i % 2 == 0 else ids[::-1])
            if miss:
                keys = keys ^ (jnp.int64(i) + 7) << 42
            _, inv, (slot, _, ins, _), _ = plan(jst, keys)
            want = [int(jnp.sum(slot)), int(jnp.sum(inv)),
                    int(jnp.sum(ins.astype(jnp.int32)))]
            jacc = (jacc + jnp.sum(slot).astype(jnp.float32)
                    + jnp.sum(inv).astype(jnp.float32)
                    + jnp.sum(ins.astype(jnp.int32)).astype(jnp.float32))
            got = ab_radix_plan.plan_step(tv.spec, tst, torch.from_numpy(ids),
                                          i, miss)
            assert [int(s) for s in got] == want
            assert want[2] == (n if miss else 0)
            tacc = tacc + sum(s.to(torch.float32) for s in got)
        assert float(tacc) == float(jacc)


def test_both_mains_run_on_the_cpu(monkeypatch, capsys):
    for mod, kw in ((ab_kernel_cost, dict(CAP=1024, BATCHES=(64, 256),
                                          STEPS=2)),
                    (ab_radix_plan, dict(CAP=4096, BATCHES=(64, 256),
                                         STEPS=2, REPS=1))):
        for k, v in kw.items():
            monkeypatch.setattr(mod, k, v)
    cost = ab_kernel_cost.main(device="cpu")
    radix = ab_radix_plan.main([], device="cpu")
    printed = capsys.readouterr().out
    assert cost["device"] == "cpu" and radix["device"] == "cpu"
    assert list(cost["variants"]) == [n for n, _ in ab_kernel_cost.VARIANTS]
    for name, e in cost["variants"].items():
        assert name in printed and np.isfinite(e["ns_per_row"])
        assert e["bound_ns_per_row"] is None  # no card: no device bound
    assert list(radix["ns_per_key"]) == ["sort_pair", "pallas_hist",
                                         "plan_hit", "plan_miss"]
    for name, ns in radix["ns_per_key"].items():
        assert name in printed and np.isfinite(ns)
    assert list(ab_radix_plan.main(["HIST"], device="cpu")["ns_per_key"]) \
        == ["pallas_hist"]


def test_mains_without_a_card_raise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: main() runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_kernel_cost.main()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ab_radix_plan.main([])


def test_tools_import_no_jax():
    code = ("import sys, recommenders_addons_tpu_torch.tools.ab_kernel_cost, "
            "recommenders_addons_tpu_torch.tools.ab_radix_plan; "
            "bad = [m for m in ('jax', 'recommenders_addons_tpu') "
            "if m in sys.modules]; assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=Path(__file__).resolve().parent.parent)
