"""The port's row gather / row scatter (ops/cuda_ops.py) against the JAX
package's Pallas kernels, run through the Pallas interpreter
(TFRA_TPU_PALLAS_INTERPRET=1, as tests/test_pallas_interpret.py does).

On the CPU the wrappers run their plain PyTorch versions; the CUDA
kernels themselves are held against those on the card by
tests/test_torch_cuda_kernels.py and by chip_smoke.py. The tables hold random
32-bit words (NaN bit patterns included) and everything is data movement,
so every comparison is bit-exact (assert_array_equal on int32 views)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu.ops import pallas_ops
from recommenders_addons_tpu_torch.ops import cuda_ops

LANES = 128


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("TFRA_TPU_PALLAS_INTERPRET", "1")


def _table(cap, ch, seed=0):
    """Physical [(cap+1)*ch, 128] f32 container of random bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        size=((cap + 1) * ch, LANES), dtype=np.int32)
    return bits.view(np.float32)


def _bits(a):
    return np.asarray(a).view(np.int32)


def _idx(cap, n, seed):
    """Valid slots plus the sentinel, negatives and past-the-end indices."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cap, size=n).astype(np.int32)
    idx[::7] = cap
    idx[3::11] = -1
    idx[5::13] = cap + 3
    idx[0] = cap - 1
    return idx


@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("masked", [True, False])
def test_gather_matches_pallas(ch, masked):
    cap, n = 40, 77  # ragged N: the Pallas side pads to its tile
    t, idx = _table(cap, ch, seed=ch), _idx(cap, n, seed=ch)
    want = pallas_ops.gather_rows_2d(jnp.asarray(t), ch, jnp.asarray(idx),
                                     cap=cap, masked=masked)
    got = cuda_ops.gather_rows_2d(torch.from_numpy(t), ch,
                                  torch.from_numpy(idx), cap=cap,
                                  masked=masked)
    assert got.dtype == torch.float32 and got.shape == (n, ch * LANES)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_gather_flat_matches_pallas():
    cap, n, ch = 24, 50, 2
    t, idx = _table(cap, ch, seed=7), _idx(cap, n, seed=7)
    want = pallas_ops.gather_rows_2d(jnp.asarray(t), ch, jnp.asarray(idx),
                                     cap=cap, flat=True)
    got = cuda_ops.gather_rows_2d(torch.from_numpy(t), ch,
                                  torch.from_numpy(idx), cap=cap, flat=True)
    assert got.shape == (n * ch, LANES)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_gather_value_chunk_stride_matches_premultiplied_pallas():
    """vc < ch: the port passes the row stride; the JAX package
    premultiplies the index (hashtable.gather_values) — same rows."""
    cap, n, ch, vc = 32, 45, 2, 1
    t = _table(cap, ch, seed=9)
    rng = np.random.default_rng(9)
    idx = rng.integers(0, cap + 1, size=n).astype(np.int32)  # incl. trash
    want = pallas_ops.gather_rows_2d(jnp.asarray(t), vc,
                                     jnp.asarray(idx * (ch // vc)),
                                     masked=False)
    got = cuda_ops.gather_rows_2d(torch.from_numpy(t), ch,
                                  torch.from_numpy(idx), masked=False, vc=vc)
    assert got.shape == (n, vc * LANES)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("ch", [1, 2])
def test_scatter_matches_pallas(ch):
    cap = 48
    t = _table(cap, ch, seed=11)
    rng = np.random.default_rng(11)
    slots = rng.permutation(cap)[:30].astype(np.int32)  # unique valid
    idx = np.concatenate([slots, [cap, -2, cap + 5, cap]]).astype(np.int32)
    rng.shuffle(idx)
    rows = _table(len(idx) - 1, ch, seed=12).reshape(len(idx), ch * LANES)
    want = pallas_ops.scatter_rows_set_2d(
        jnp.asarray(t), ch, jnp.asarray(idx), jnp.asarray(rows), cap=cap)
    table = torch.from_numpy(t.copy())
    out = cuda_ops.scatter_rows_set_2d(table, ch, torch.from_numpy(idx),
                                       torch.from_numpy(rows), cap=cap)
    assert out is table  # in place
    live = cap * ch  # compare logical rows only, never the trash row
    np.testing.assert_array_equal(_bits(out.numpy()[:live]),
                                  _bits(np.asarray(want)[:live]))


def test_logical_gather_and_scatter_match_pallas():
    cap, ch = 16, 2
    t = _table(cap - 1, ch, seed=13).reshape(cap, ch * LANES)
    idx = np.array([3, 0, 15, 16, -1, 7], np.int32)
    np.testing.assert_array_equal(
        _bits(cuda_ops.gather_rows(torch.from_numpy(t),
                                   torch.from_numpy(idx)).numpy()),
        _bits(pallas_ops.gather_rows(jnp.asarray(t), jnp.asarray(idx))))
    sidx = np.array([2, 9, 16, 5], np.int32)
    rows = _table(3, ch, seed=14).reshape(4, ch * LANES)
    got = cuda_ops.scatter_rows_set(torch.from_numpy(t),
                                    torch.from_numpy(sidx),
                                    torch.from_numpy(rows))
    want = pallas_ops.scatter_rows_set(jnp.asarray(t), jnp.asarray(sidx),
                                       jnp.asarray(rows))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
