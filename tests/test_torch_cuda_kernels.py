"""The port's CUDA kernels (ops/cuda_ops.py) against their plain PyTorch
versions, plus the wrappers' dispatch and argument checks. This file
imports nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tests marked ``gpu`` need an NVIDIA card and skip without one. The tables
hold random 32-bit words (NaN bit patterns included) and the kernels only
move them, so every comparison is bit-exact (on int32 views)."""

import numpy as np
import pytest
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops

LANES = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA)")
    return torch.device("cuda")


def _table(cap, ch, seed=0):
    """Physical [(cap+1)*ch, 128] f32 container of random bits."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(np.iinfo(np.int32).min, np.iinfo(np.int32).max,
                        size=((cap + 1) * ch, LANES), dtype=np.int32)
    return torch.from_numpy(bits.view(np.float32))


def _idx(cap, n, seed):
    """Valid slots plus the sentinel, negatives and past-the-end indices."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, cap, size=n).astype(np.int32)
    idx[::7] = cap
    idx[3::11] = -1
    idx[5::13] = cap + 3
    return torch.from_numpy(idx)


@pytest.mark.parametrize("ch,vc", [(1, 1), (2, 2), (2, 1)])
def test_plain_gather_against_numpy(ch, vc):
    cap, n = 30, 64
    t, idx = _table(cap, ch, seed=ch), _idx(cap, n, seed=vc)
    got = cuda_ops.gather_rows_2d(t, ch, idx, cap=cap, vc=vc)
    logical = t.view(torch.int32).numpy().reshape(cap + 1, ch * LANES)
    i = idx.numpy()
    want = logical[np.clip(i, 0, cap), : vc * LANES].copy()
    want[(i < 0) | (i >= cap)] = 0
    np.testing.assert_array_equal(got.view(torch.int32).numpy(), want)


def test_plain_scatter_against_numpy():
    cap, ch = 20, 2
    t = _table(cap, ch, seed=3)
    want = t.view(torch.int32).numpy().reshape(cap + 1, ch * LANES).copy()
    idx = torch.tensor([4, 19, cap, -1, 0], dtype=torch.int32)
    rows = _table(4, ch, seed=4).reshape(5, ch * LANES)
    for j, i in enumerate(idx.tolist()):
        if 0 <= i < cap:
            want[i] = rows[j].view(torch.int32).numpy()
    cuda_ops.scatter_rows_set_2d(t, ch, idx, rows, cap=cap)
    got = t.view(torch.int32).numpy().reshape(cap + 1, ch * LANES)
    np.testing.assert_array_equal(got[:cap], want[:cap])


def test_cpu_tensors_never_launch_a_kernel():
    cuda_ops.reset_launches()
    t = _table(8, 1)
    cuda_ops.gather_rows_2d(t, 1, torch.arange(4))
    cuda_ops.scatter_rows_set_2d(t, 1, torch.arange(4),
                                 torch.zeros(4, LANES))
    assert [k.launches for k in cuda_ops.KERNELS] == [0, 0]


def test_argument_checks():
    with pytest.raises(TypeError):
        cuda_ops.gather_rows_2d(torch.zeros(4, LANES, dtype=torch.float64),
                                1, torch.arange(2))
    with pytest.raises(ValueError):  # no trash row
        cuda_ops.scatter_rows_set_2d(torch.zeros(4, LANES), 1,
                                     torch.arange(2), torch.zeros(2, LANES),
                                     cap=4)
    with pytest.raises(ValueError):  # vc > ch
        cuda_ops.gather_rows_2d(torch.zeros(4, LANES), 1, torch.arange(2),
                                vc=2)
    with pytest.raises(ValueError):  # not [rows, 128]
        cuda_ops.gather_rows_2d(torch.zeros(4, 64), 1, torch.arange(2))


def test_kernel_sources_are_present():
    for k in cuda_ops.KERNELS:
        assert k.source.is_file(), k.source
        assert k.library.name.startswith(f"lib{k.name}-")


@pytest.mark.gpu
@pytest.mark.parametrize("ch,vc", [(1, 1), (2, 2), (2, 1)])
def test_kernels_match_plain_on_card(cuda, ch, vc):
    cap, n = 1 << 12, 1000
    t = _table(cap, ch, seed=ch).to(cuda)
    idx = _idx(cap, n, seed=vc).to(cuda)
    before = cuda_ops.ROW_GATHER.launches
    for masked in (True, False):
        got = cuda_ops.gather_rows_2d(t, ch, idx, cap=cap, masked=masked,
                                      vc=vc)
        want = cuda_ops.gather_rows_2d_plain(t, ch, idx, cap=cap,
                                             masked=masked, vc=vc)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert cuda_ops.ROW_GATHER.launches == before + 2
    slots = torch.randperm(cap, device=cuda)[:n].to(torch.int32)
    slots[::9] = cap
    rows = _table(n - 1, ch, seed=5).reshape(n, ch * LANES).to(cuda)
    a, b = t.clone(), t.clone()
    cuda_ops.scatter_rows_set_2d(a, ch, slots, rows, cap=cap)
    cuda_ops.scatter_rows_set_2d_plain(b, ch, slots, rows, cap=cap)
    torch.cuda.synchronize()
    live = cap * ch
    assert torch.equal(a[:live].view(torch.int32), b[:live].view(torch.int32))
