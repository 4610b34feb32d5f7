"""The port's CUDA kernels (ops/cuda_ops.py) against their plain PyTorch
versions, plus the wrappers' dispatch and argument checks. This file
imports nothing of JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py

Tests marked ``gpu`` need an NVIDIA card and skip without one. For the
row gather and scatter the tables hold random 32-bit words (NaN bit
patterns included) and the kernels only move them, so every comparison is
bit-exact (on int32 views). The fused optimizer-scatter computes: rows it
does not write stay bit-exact, and updated f32 words agree within 4 ulps
(powf and the divisions round independently), bf16 halves within 1 ulp;
its pipeline's turns are held bit-exact (the kernel repeats the plain
version's operations without fused multiply-add), and the trash row,
which the kernel leaves alone, unchanged.
The fused-apply probe's kernel (tools/ab_kernel_cost.py) follows the same
rule, its identity and raw-copy modes bit-exact; the radix probe's
histogram (tools/ab_radix_plan.py) counts integers, so it is exact."""

import re

import numpy as np
import pytest
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.ops import optimizer as opt_lib
from recommenders_addons_tpu_torch.tools import (
    ab_kernel_cost,
    ab_radix_plan,
    dma_bench,
    fused_sweep,
    gather_sweep,
    hist_bench,
    row_sweep,
)

LANES = 128
OPTIMIZERS = {"sgd": opt_lib.SGD(0.05), "momentum": opt_lib.Momentum(0.05),
              "nesterov": opt_lib.Momentum(0.05, nesterov=True),
              "adagrad": opt_lib.Adagrad(0.05), "adam": opt_lib.Adam(0.05),
              "adamw": opt_lib.AdamW(0.05), "rmsprop": opt_lib.RMSprop(0.05),
              "ftrl": opt_lib.FTRL(0.05, l1_regularization_strength=0.01,
                                   l2_regularization_strength=0.01)}


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
    cuda_ops.fused_update_scatter(
        t, 1, torch.arange(4), torch.zeros(4, LANES), torch.zeros(4, 8),
        opt_lib.SGD().fused_rule(), dim=8, slot_names=(), cap=8)
    ab_kernel_cost.make_fused("adam")(_table(8, 2), torch.arange(4),
                                      torch.rand(4, 256), torch.rand(4, 64), 0)
    ab_radix_plan.pallas_hist(torch.arange(-9, 9), 0)
    assert [k.launches for k in cuda_ops.KERNELS] == [0] * len(
        cuda_ops.KERNELS)


def _fused_case(name, pf, cap, n, dim=64, seed=0):
    """A table with the optimizer's slots plus one foreign slot column
    ("zz", passed through), packed rows of valid values, grads, and
    indices with unique slots, sentinels, negatives and past-the-end."""
    opt = OPTIMIZERS[name]
    names = tuple(sorted(set(opt.slot_specs()) | {"zz"}))
    vdt = torch.float32 if pf == 1 else torch.bfloat16
    w = -(-dim * (1 + len(names)) // (LANES * pf)) * LANES * pf
    ch = w // (LANES * pf)
    rng = np.random.default_rng(seed)
    logical = rng.uniform(0.05, 1.0, size=(cap + 1, w)).astype(np.float32)
    table = torch.from_numpy(logical).to(vdt).contiguous().view(
        torch.float32).reshape((cap + 1) * ch, LANES)
    packed = torch.from_numpy(rng.uniform(0.05, 1.0, size=(n, w)).astype(
        np.float32)).to(vdt).contiguous().view(torch.float32)
    grads = torch.from_numpy(rng.normal(size=(n, dim)).astype(np.float32))
    idx = torch.from_numpy(rng.permutation(cap)[:n].astype(np.int32))
    idx[::7], idx[3::11], idx[5::13] = cap, -1, cap + 3
    return opt, names, ch, table, packed, grads, idx


def test_plain_fused_update_against_numpy():
    """SGD into an f32 table with a foreign slot column: values move by
    -lr * g, the foreign slot and the untouched rows keep their words, the
    padding is zeroed."""
    cap, n, dim = 40, 24, 16
    opt, names, ch, table, packed, grads, idx = _fused_case(
        "sgd", 1, cap, n, dim=dim)
    assert names == ("zz",) and ch == 1
    before = table.clone().numpy()
    want = before.copy()
    for j, i in enumerate(idx.tolist()):
        if 0 <= i < cap:
            row = packed[j].numpy().copy()
            row[:dim] = row[:dim] - np.float32(0.05) * grads[j].numpy()
            row[2 * dim:] = 0.0
            want[i] = row
    out = cuda_ops.fused_update_scatter(
        table, ch, idx, packed, grads, opt.fused_rule(), dim=dim,
        slot_names=names, cap=cap, step=3.0)
    assert out is table  # in place
    np.testing.assert_array_equal(table.numpy()[:cap].view(np.int32),
                                  want[:cap].view(np.int32))


def test_fused_update_argument_checks():
    opt, names, ch, table, packed, grads, idx = _fused_case("adam", 1, 16, 8)
    rule = opt.fused_rule()
    kw = dict(dim=64, slot_names=names, cap=16)
    with pytest.raises(ValueError):  # the table lacks the optimizer's slots
        cuda_ops.fused_update_scatter(table, ch, idx, packed, grads, rule,
                                      dim=64, slot_names=("zz",), cap=16)
    with pytest.raises(ValueError):  # grads of the wrong width
        cuda_ops.fused_update_scatter(table, ch, idx, packed, grads[:, :8],
                                      rule, **kw)
    with pytest.raises(ValueError):  # no trash row
        cuda_ops.fused_update_scatter(table, ch, idx, packed, grads, rule,
                                      dim=64, slot_names=names, cap=17)
    with pytest.raises(ValueError):  # a rule the kernel does not know
        cuda_ops.fused_update_scatter(
            table, ch, idx, packed, grads,
            cuda_ops.FusedRule("lion", (0.1,), (), opt.update), **kw)


def _ulps32(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in f32 ulps between two f32 tensors of one sign."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def _ulps_bf16(a: torch.Tensor, b: torch.Tensor) -> int:
    def ordered(t):
        i = t.contiguous().view(torch.int16).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((ordered(a) - ordered(b)).abs().max())


def test_argument_checks():
    # 64-bit tables are moved as pairs of words; 8- and 16-bit ones raise
    for dt in (torch.bool, torch.float16):
        with pytest.raises(TypeError):
            cuda_ops.gather_rows_2d(torch.zeros(4, LANES, dtype=dt), 1,
                                    torch.arange(2))
        with pytest.raises(TypeError):
            cuda_ops.scatter_rows_set_2d(torch.zeros(4, LANES, dtype=dt), 1,
                                         torch.arange(2),
                                         torch.zeros(2, LANES, dtype=dt))
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


# (ch, vc, n, share of the scatter's rows bound for the trash row): the
# main paths' widths, ragged batches of 1, 31 and 33 rows around a
# warp's 32, trash shares 0, ~70% and 100%, and a batch long enough that
# every warp of the kernels' resident grid takes many units (an H100
# holds at most 132 SMs x 8 blocks x 8 warps, 8,448 warps)
ROW_CASES = [(1, 1, 1000, 1 / 9), (2, 2, 1000, 1 / 9), (2, 1, 1000, 1 / 9),
             (4, 1, 1037, 1 / 9), (4, 4, 1037, 0.7), (1, 1, 1, 0.0),
             (2, 2, 31, 0.0), (4, 4, 33, 0.0), (1, 1, 33, 1.0),
             (2, 1, 1000, 1.0), (1, 1, (1 << 19) + 3, 0.7)]
WIDE_CASES = [(1, 1, 1037, 1 / 9), (2, 2, 1037, 1 / 9), (2, 1, 1037, 1 / 9),
              (2, 2, 33, 0.7), (2, 1, 31, 1.0)]


def _bits_dtype(dt):
    """The integer dtype of ``dt``'s width (32 or 64 bits)."""
    wide = torch.empty((), dtype=dt).element_size() == 8
    return torch.int64 if wide else torch.int32


def _card_bits(shape, dt, gen, dev):
    """Random bits of ``dt`` (32- or 64-bit) made on the card."""
    k = torch.empty((), dtype=dt).element_size() // 4
    return torch.randint(-(1 << 31), (1 << 31) - 1,
                         (*shape[:-1], shape[-1] * k), dtype=torch.int32,
                         device=dev, generator=gen).view(dt)


def _scatter_idx(cap, n, trash, gen, dev):
    """``n`` indices: unique slots of ``[0, cap)``, a ``trash`` share of
    them (at random places) the sentinel, negative, past the end or the
    int32 extremes."""
    idx = torch.randperm(cap, device=dev, generator=gen)[:n].to(torch.int32)
    bad = torch.randperm(n, device=dev, generator=gen)[:round(trash * n)]
    junk = torch.tensor([cap, -1, cap + 3, (1 << 31) - 1, -(1 << 31)],
                        dtype=torch.int32, device=dev)
    idx[bad] = junk[torch.arange(bad.numel(), device=dev) % junk.numel()]
    return idx


def _check_row_kernels(dev, dt, ch, vc, n, trash, seed):
    """Both row kernels against their plain versions on a table of ``dt``
    (random bits, NaN patterns included): the gather masked, unmasked
    and flat, with sentinel, negative and past-the-end indices; the
    scatter with ``trash`` of its rows bound for the trash row. Rows
    [0, cap) must be bit-exact, rows not named keep their bits and the
    kernel leaves the trash row alone."""
    it = _bits_dtype(dt)
    cap = max(1 << 12, n)
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = _card_bits(((cap + 1) * ch, LANES), dt, gen, dev)
    idx = _idx(cap, n, seed=seed).to(dev)
    before = cuda_ops.ROW_GATHER.launches
    for kw in (dict(masked=True), dict(masked=False), dict(flat=True)):
        got = cuda_ops.gather_rows_2d(t, ch, idx, cap=cap, vc=vc, **kw)
        want = cuda_ops.gather_rows_2d_plain(t, ch, idx, cap=cap, vc=vc,
                                             **kw)
        assert got.dtype == dt
        assert torch.equal(got.view(it), want.view(it)), kw
    assert cuda_ops.ROW_GATHER.launches == before + 3
    slots = _scatter_idx(cap, n, trash, gen, dev)
    rows = _card_bits((n, ch * LANES), dt, gen, dev)
    a, b = t.clone(), t.clone()
    before = cuda_ops.ROW_SCATTER.launches
    cuda_ops.scatter_rows_set_2d(a, ch, slots, rows, cap=cap)
    cuda_ops.scatter_rows_set_2d_plain(b, ch, slots, rows, cap=cap)
    torch.cuda.synchronize()
    assert cuda_ops.ROW_SCATTER.launches == before + 1
    live = cap * ch
    assert torch.equal(a[:live].view(it), b[:live].view(it))
    named = torch.zeros(cap, dtype=torch.bool, device=dev)
    ok = (slots >= 0) & (slots < cap)
    named[slots[ok].long()] = True
    wide = (cap, ch * LANES)
    assert torch.equal(a[:live].view(it).view(wide)[~named],
                       t[:live].view(it).view(wide)[~named])
    assert torch.equal(a[live:].view(it), t[live:].view(it))  # trash row


@pytest.mark.gpu
@pytest.mark.parametrize("ch,vc,n,trash", ROW_CASES)
def test_kernels_match_plain_on_card(cuda, ch, vc, n, trash):
    _check_row_kernels(cuda, torch.float32, ch, vc, n, trash,
                       seed=ch * 7 + vc + n)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float64, torch.int64])
@pytest.mark.parametrize("ch,vc,n,trash", WIDE_CASES)
def test_64bit_kernels_match_plain_on_card(cuda, dt, ch, vc, n, trash):
    """f64 and int64 tables: the kernels move each row as twice the
    128-word chunks (random bits, NaN patterns included)."""
    _check_row_kernels(cuda, dt, ch, vc, n, trash, seed=ch + vc + n)


@pytest.mark.gpu
@pytest.mark.parametrize("name,pf", [(k, 1) for k in OPTIMIZERS]
                         + [("adam", 2), ("adagrad", 2)])
def test_fused_update_scatter_matches_plain_on_card(cuda, name, pf):
    cap, n = 1 << 12, 1000
    opt, names, ch, table, packed, grads, idx = _fused_case(name, pf, cap, n)
    table, packed, grads, idx = (t.to(cuda) for t in (table, packed, grads,
                                                       idx))
    a, b = table.clone(), table.clone()
    before = cuda_ops.FUSED_UPDATE_SCATTER.launches
    for t, fn in ((a, cuda_ops.fused_update_scatter),
                  (b, cuda_ops.fused_update_scatter_plain)):
        fn(t, ch, idx, packed, grads, opt.fused_rule(), dim=64,
           slot_names=names, cap=cap, step=4.0, pf=pf)
    torch.cuda.synchronize()
    assert cuda_ops.FUSED_UPDATE_SCATTER.launches == before + 1
    live = cap * ch
    written = torch.zeros(cap, dtype=torch.bool, device=cuda)
    valid = idx[(idx >= 0) & (idx < cap)].long()
    written[valid] = True
    rows_a = a[:live].reshape(cap, ch * LANES)
    rows_b = b[:live].reshape(cap, ch * LANES)
    assert torch.equal(rows_a[~written].view(torch.int32),
                       rows_b[~written].view(torch.int32))
    assert not torch.equal(rows_a[written], table[:live].reshape(
        cap, ch * LANES)[written])
    if pf == 1:
        assert _ulps32(rows_a[written], rows_b[written]) <= 4
    else:
        assert _ulps_bf16(rows_a[written].view(torch.bfloat16),
                          rows_b[written].view(torch.bfloat16)) <= 1


def _fused_stage_rows(used_words, dim):
    """R, the staged rows of one stage of the fused kernel's ring for
    rows of ``used_words`` value and slot words and ``dim`` staged grads
    (at least one)."""
    kib = int(re.search(r"constexpr int kStageBytes = (\d+) \* 1024;",
                        cuda_ops.FUSED_UPDATE_SCATTER.source.read_text())
              .group(1))
    return max(1, kib * 1024 // ((-(-used_words // 4) * 4 + dim) * 4))


# (optimizer, pf, cap, N, dim, indices): where the pipeline turns
FUSED_TURNS = {
    "N below one batch": ("adam", 1, 1 << 12, 19, 64, "mixed"),
    "N ragged past a stage": ("adagrad", 1, 1 << 12, None, 64, "mixed"),
    "ring wraps": ("adagrad", 1, 1 << 19, (1 << 18) + 3, 64, "mixed"),
    "all trash": ("adam", 1, 1 << 12, 1037, 64, "trash"),
    "two thirds trash in runs": ("adagrad", 1, 1 << 14, 9001, 64, "runs"),
    "two thirds trash scattered": ("adagrad", 1, 1 << 14, 9001, 64,
                                   "scattered"),
    "negative and past the end": ("sgd", 1, 1 << 12, 1037, 64, "extremes"),
    "dim % 4 != 0 (scalar path)": ("adam", 1, 1 << 12, 1037, 6, "mixed"),
    "bf16 dim/2 % 4 != 0": ("adam", 2, 1 << 12, 1037, 12, "mixed"),
    "grads off 16 bytes": ("adagrad", 1, 1 << 12, 1037, 64, "grads off"),
    "ch = 256 shrinks the ring": ("adam", 1, 64, 50, 8192, "mixed"),
    **{f"{k} f32": (k, 1, 1 << 12, 3001, 64, "scattered")
       for k in OPTIMIZERS},
    "adam bf16": ("adam", 2, 1 << 12, 3001, 64, "scattered"),
    "adagrad bf16": ("adagrad", 2, 1 << 12, 3001, 64, "scattered"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("turn", list(FUSED_TURNS))
def test_fused_pipeline_turns_match_plain_on_card(cuda, turn):
    """The fused kernel's persistent pipeline, bit-exact on rows [0, cap)
    against the plain version (rows it must not write unchanged), and
    the trash row left as it was: N below one 32-row batch and ragged
    past a stage; N = 2^18 + 3, where every block wraps its ring many
    times; all rows trash; two thirds trash in runs of 64 and scattered;
    int32's extremes as indices; a value block of dim/pf % 4 != 0 words
    (the scalar path); grads one word off 16-byte alignment (read from
    device memory); rows of 128 KiB (ch = 256), one a stage; every rule
    in f32 and Adam and Adagrad in bf16. Every table carries a foreign
    slot column the kernel passes through."""
    name, pf, cap, n, dim, kind = FUSED_TURNS[turn]
    if n is None:  # three stages and a bit
        words = dim // pf * (1 + len(OPTIMIZERS[name].slot_specs()) + 1)
        n = 3 * _fused_stage_rows(words, dim) + 17
    opt, names, ch, table, packed, grads, idx = _fused_case(
        name, pf, cap, n, dim=dim)
    rng = np.random.default_rng(n)
    if kind == "trash":
        idx[:] = cap
    elif kind == "runs":
        for s in range(0, n, 96):
            idx[s + 32:s + 96] = cap
    elif kind == "scattered":
        drop = torch.from_numpy(rng.random(n) < 2 / 3)
        idx[drop] = torch.from_numpy(np.where(
            rng.random(n) < 0.5, cap, -5).astype(np.int32))[drop]
    elif kind == "extremes":
        idx[::3] = -(1 << 31)
        idx[1::5] = (1 << 31) - 1
    table, packed, grads, idx = (t.to(cuda) for t in (table, packed, grads,
                                                       idx))
    if kind == "grads off":
        buf = torch.zeros(n * dim + 1, device=cuda)
        buf[1:] = grads.reshape(-1)
        grads = buf[1:].view(n, dim)
        assert grads.data_ptr() % 16
    a, b = table.clone(), table.clone()
    before = cuda_ops.FUSED_UPDATE_SCATTER.launches
    for t, fn in ((a, cuda_ops.fused_update_scatter),
                  (b, cuda_ops.fused_update_scatter_plain)):
        fn(t, ch, idx, packed, grads, opt.fused_rule(), dim=dim,
           slot_names=names, cap=cap, step=4.0, pf=pf)
    torch.cuda.synchronize()
    assert cuda_ops.FUSED_UPDATE_SCATTER.launches == before + 1
    live = cap * ch
    assert torch.equal(a[:live].view(torch.int32), b[:live].view(torch.int32))
    assert torch.equal(a[live:].view(torch.int32),
                       table[live:].view(torch.int32))


@pytest.mark.gpu
def test_fused_update_scatter_empty_batch_launches_nothing(cuda):
    opt, names, ch, table, packed, grads, idx = _fused_case("adam", 1, 64, 8)
    table = table.to(cuda)
    want = table.clone()
    before = cuda_ops.FUSED_UPDATE_SCATTER.launches
    cuda_ops.fused_update_scatter(
        table, ch, idx[:0].to(cuda), packed[:0].to(cuda),
        grads[:0].to(cuda), opt.fused_rule(), dim=64, slot_names=names,
        cap=64)
    torch.cuda.synchronize()
    assert cuda_ops.FUSED_UPDATE_SCATTER.launches == before
    assert torch.equal(table.view(torch.int32), want.view(torch.int32))


def test_fused_sweep_rewrites_the_ring_constants(tmp_path, monkeypatch):
    """The sweep's copy of the fused kernel carries the geometry it asks
    for (each constant found once) and builds under its own library
    name; its default grid keeps only rings that fit beside each other."""
    monkeypatch.setattr(fused_sweep, "_SWEEP_DIR", tmp_path)
    k = fused_sweep.copy_kernel("f", cuda_ops._PKG / "csrc", dict(zip(
        fused_sweep.CONSTS, ("16 * 1024", 2, 3, 8))))
    text = k.source.read_text()
    for line in ("constexpr int kStageBytes = 16 * 1024;",
                 "constexpr int kStages = 2;",
                 "constexpr int kBlocksPerSm = 3;",
                 "constexpr int kConsumers = 8;"):
        assert line in text, line
    assert (k.source.parent / "bulk_copy.cuh").is_file()
    assert k.library.name != cuda_ops.FUSED_UPDATE_SCATTER.library.name
    grid = fused_sweep.default_geometries()
    assert (32, 4, 1, 4) in grid and (32, 4, 2, 4) not in grid
    assert all(kib * s * b < 227 for kib, s, b, _ in grid)
    with pytest.raises(RuntimeError):  # the sweep times kernels on a card
        fused_sweep.main([], device="cpu")


def test_fused_sweep_main_path_inputs_on_cpu():
    """Input (c) of the sweep at a small width: one DLRM step's call of
    the fused apply, captured before it ran. Its padding and duplicate
    rows are bound for the trash row; the bound counts what the rows
    with a valid index move."""
    from recommenders_addons_tpu_torch.models import dlrm

    inp = fused_sweep.main_path_inputs(
        torch.device("cpu"), 0, dlrm.DLRMConfig(table_capacity=1 << 12),
        batch=64)
    n = 64 * 26
    assert inp.idx.shape == (n,) and inp.grads.shape == (n, 64)
    assert inp.rule.kind == "adagrad" and inp.ch == 1
    assert 0.2 < inp.trash_share() < 0.9
    valid = int(inp.valid().sum())
    assert inp.bound_bytes() == valid * (1024 + 256) + 4 * n
    assert inp.moved_bytes() == inp.bound_bytes()
    want = inp.table.clone()
    inp.plain(want)
    got = inp.table.clone()
    inp.call(got)  # CPU tensors: the plain version
    assert fused_sweep.compare(got, want, inp, "cpu") == (0, 0.0)


def test_fused_sweep_bound_counts_valid_rows_and_used_words():
    """The bytes bound counts, for each row with a valid index, its value
    and slot words read (not the padding), its grads read and its whole
    row written, plus 4 B an index; the kernel's moved bytes round each
    row's read up to 16 B."""
    gen = torch.Generator().manual_seed(0)
    adam = opt_lib.Adam(0.001).fused_rule()
    inp = fused_sweep.fused_inputs(torch.device("cpu"), gen, adam, 1, 512,
                                   300, foreign=False)
    valid = int(inp.valid().sum())
    assert inp.ch == 2 and 0 < valid < 300
    assert inp.bound_bytes() == valid * (192 * 4 + 256 + 1024) + 4 * 300
    assert inp.moved_bytes() == inp.bound_bytes()
    inp = fused_sweep.fused_inputs(torch.device("cpu"), gen,
                                   opt_lib.Adagrad(0.01).fused_rule(), 1,
                                   512, 300, dim=5, foreign=False)
    assert (inp.moved_bytes() - inp.bound_bytes()
            == int(inp.valid().sum()) * 8)


# -- the row-copy micro-benchmark's kernels (tools/dma_bench.py) ------------

DMA_GATHERS = [kw for _, kw in dma_bench.VARIANTS] + [
    dict(nbuf=8, predicated=True, bitand=False, unroll=4, premul=False),
    dict(nbuf=6, predicated=True, bitand=False, unroll=1, premul=True)]
DMA_SCATTERS = [kw for _, kw in dma_bench.SC_VARIANTS] + [
    dict(nbuf=8, predicated=True, unroll=4, extra_rows=1, premul=False),
    dict(nbuf=1, predicated=False, unroll=1, extra_rows=0, premul=False)]


def test_dma_bench_argument_checks():
    with pytest.raises(ValueError):  # bitand needs a power of two
        dma_bench.make_gather(6, False, True, 4)
    with pytest.raises(ValueError):  # no kernel instantiated for unroll 3
        dma_bench.make_scatter(8, False, 3)
    with pytest.raises(ValueError):  # a group past one barrier phase
        dma_bench.make_gather_grouped(8, 32, ch=64)
    scatter = dma_bench.make_scatter(8, True, 4, extra_rows=1, ch=2)
    with pytest.raises(ValueError):  # only the trash row
        scatter(torch.zeros(2, LANES), torch.arange(1), torch.zeros(2, LANES))
    with pytest.raises(ValueError):  # not whole rows of ch chunks
        scatter(torch.zeros(5, LANES), torch.arange(1), torch.zeros(2, LANES))
    with pytest.raises(ValueError):  # rows of the wrong count
        scatter(torch.zeros(8, LANES), torch.arange(2), torch.zeros(2, LANES))


@pytest.mark.gpu
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("kw", DMA_GATHERS, ids=str)
def test_dma_gather_kernels_match_plain_on_card(cuda, ch, kw):
    cap, n = 1 << 12, 1037  # ragged: a partial tile and group
    gather = dma_bench.make_variant(kw, ch=ch, scatter=False)
    t = _table(cap - 1, ch, seed=ch).to(cuda)  # [cap*ch, 128]
    idx = _idx(cap, n, seed=3).to(cuda)
    before = gather.kernel.launches
    got = gather(t, idx)
    want = gather.plain(t, idx)
    torch.cuda.synchronize()
    assert gather.kernel.launches == before + 1
    assert got.shape == (n * ch, LANES)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    with pytest.raises(ValueError):  # the kernels move 16-byte words
        gather(torch.empty(cap * ch * LANES + 1, device=cuda)[1:].view(
            cap * ch, LANES), idx)



def _stage_rows(kernel, ch):
    """R, the rows of one pipeline stage in ``kernel``'s source at ``ch``
    chunks a row (at least one)."""
    kib = int(re.search(r"constexpr int kStageBytes = (\d+) \* 1024;",
                        kernel.source.read_text()).group(1))
    return max(1, kib * 1024 // (ch * 512))


@pytest.mark.gpu
@pytest.mark.parametrize("n_kind", ["1", "R-1", "1037", "ring wrap"])
@pytest.mark.parametrize("ch", [1, 2, 4, 256])
@pytest.mark.parametrize("kw", DMA_GATHERS, ids=str)
def test_dma_gather_pipelines_match_plain_on_card(cuda, kw, ch, n_kind):
    """Both gathers' persistent pipelines, every variant, bit-exact against
    the plain version: one row; one row short of a stage (R - 1, at least
    1); a ragged N; and N = 2^18 + 3, where every block wraps its ring of
    stages many times (2^11 + 3 at ch = 256: rows of 128 KiB, one a
    stage). ch = 256 runs on a table of 64 rows, its grouped variants with
    the largest group one barrier phase takes (4 rows). The indices mix in
    sentinels, negatives, past-the-end rows and indices whose premultiplied
    value wraps int32."""
    if kw.get("grouped") and kw["group"] * ch * 512 >= 1 << 20:
        kw = dict(kw, group=(1 << 19) // (ch * 512))
    gather = dma_bench.make_variant(kw, ch=ch, scatter=False)
    rows = 64 if ch == 256 else 1 << 12
    n = {"1": 1, "R-1": max(1, _stage_rows(gather.kernel, ch) - 1),
         "1037": 1037,
         "ring wrap": (1 << 11 if ch == 256 else 1 << 18) + 3}[n_kind]
    t = _table(rows - 1, ch, seed=ch).to(cuda)  # [rows*ch, 128]
    idx = _idx(rows, n, seed=n)
    idx[2::17] = (1 << 31) - 5
    idx[4::19] = -(1 << 30) - 3
    idx = idx.to(cuda)
    before = gather.kernel.launches
    got = gather(t, idx)
    want = gather.plain(t, idx)
    torch.cuda.synchronize()
    assert gather.kernel.launches == before + 1
    assert got.shape == (n * ch, LANES)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_gather_sweep_rewrites_the_ring_constants(tmp_path, monkeypatch):
    """The sweep's copies of both gathers carry the geometry it asks for
    (each constant found once) and build under their own library names;
    its default grid keeps only rings that fit beside each other."""
    monkeypatch.setattr(gather_sweep, "_SWEEP_DIR", tmp_path)
    copies = gather_sweep._copy("g", cuda_ops._PKG / "csrc", {
        "kStageBytes": "16 * 1024", "kStages": 5, "kBlocksPerSm": 1})
    assert sorted(copies) == ["dma_gather", "dma_gather_grouped"]
    for name, k in copies.items():
        text = k.source.read_text()
        for line in ("constexpr int kStageBytes = 16 * 1024;",
                     "constexpr int kStages = 5;",
                     "constexpr int kBlocksPerSm = 1;"):
            assert line in text, (name, line)
        assert (k.source.parent / "bulk_copy.cuh").is_file()
        assert k.library.name != getattr(
            cuda_ops, name.upper()).library.name
    grid = gather_sweep.default_geometries()
    assert (32, 2, 3) in grid and (32, 8, 1) not in grid
    assert all(kib * s * b < 227 for kib, s, b in grid)


def test_gather_sweep_needs_a_card():
    with pytest.raises(RuntimeError):
        gather_sweep.main([], device="cpu")


def test_row_sweep_rewrites_its_copies_and_needs_a_card(tmp_path,
                                                        monkeypatch):
    """The row sweep's copies of both row kernels carry the constants it
    asks for (each found once in each source) and build under their own
    library names; a constant a source lacks is refused; the sweep times
    kernels on a card only."""
    monkeypatch.setattr(row_sweep, "_SWEEP_DIR", tmp_path)
    consts = row_sweep.parse_consts("kDepth=4,kBlocksPerSm=2")
    assert consts == {"kDepth": "4", "kBlocksPerSm": "2"}
    copies = row_sweep.copy_kernels("v", cuda_ops._PKG / "csrc", consts)
    assert sorted(copies) == ["row_gather", "row_scatter"]
    for name, k in copies.items():
        text = k.source.read_text()
        assert "constexpr int kDepth = 4;" in text, name
        assert "constexpr int kBlocksPerSm = 2;" in text, name
        assert (k.source.parent / "bulk_copy.cuh").is_file()
        assert k.library.name != getattr(cuda_ops,
                                         name.upper()).library.name
    with pytest.raises(RuntimeError):
        row_sweep.copy_kernels("w", cuda_ops._PKG / "csrc", {"kNoSuch": 1})
    with pytest.raises(ValueError):
        row_sweep.parse_consts("kDepth")
    with pytest.raises(RuntimeError):
        row_sweep.main([], device="cpu")


def test_row_sweep_inputs_on_cpu():
    """The sweep's f64 step at a small size: its writeback scatter sends
    many rows to the trash row (the zipf batch's duplicates; about half
    here, about 70% at the full size), and the bound counts only the others
    (read and written once, plus the indices); its gather reads 2 KiB
    rows as 4 chunks of the int32 view. The serving-shape gather's bound
    counts each distinct row read once."""
    dev = torch.device("cpu")
    g, s = row_sweep.f64_step_calls(dev, cap=1 << 12, keys=2048, block=512,
                                    steps=2)
    assert (g.ch, g.vc, s.ch) == (4, 4, 4)
    valid = int(s.valid().sum())
    assert 0 < valid < 512 and 0.3 < s.trash_share() < 0.9
    assert row_sweep.scatter_bytes(s) == valid * 2 * 2048 + 512 * 4
    assert (row_sweep.scatter_bytes_every_row(s)
            == (512 + valid + 1) * 2048 + 512 * 4)
    assert s.all_trash().trash_share() == 1.0
    assert row_sweep.scatter_bytes(s.all_trash()) == 512 * 4
    gen = torch.Generator().manual_seed(0)
    a = row_sweep.gather_input(dev, gen, 1 << 10, 1, n=2048)
    distinct = int(torch.unique(a.idx).numel())
    assert row_sweep.gather_bytes(a) == (distinct + 2048) * 512 + 2048 * 4
    assert a.whole_rows_in_table() and 0 < a.trash_share() < 0.02
    assert torch.equal(a.library(), a.plain())


@pytest.mark.gpu
def test_grad_combines_are_deterministic_on_card(cuda):
    """The duplicate-grad combines (``segment_sum_rows``, and through it
    ``sorted_combine_batch``) give the same bits on every run on the card,
    however many duplicates a row has, and stay within the worst-case
    error of an f32 sum of n terms in any order, n * 2^-24 * sum |terms|,
    of the exact (f64) sums."""
    from recommenders_addons_tpu_torch.ops import hashtable

    g = torch.Generator(device=cuda).manual_seed(7)
    n = 1 << 16
    seg = torch.randint(0, 64, (n,), device=cuda, generator=g)
    seg[: n // 2] = 3  # one hot row with 32,768 occurrences
    rows = torch.randn((n, 64), device=cuda, generator=g)
    found = torch.rand(n, device=cuda, generator=g) > 0.05
    a = hashtable.segment_sum_rows(rows, seg, 64)
    assert torch.equal(a, hashtable.segment_sum_rows(rows, seg, 64))
    r64 = rows.cpu().double()
    exact = torch.zeros(64, 64, dtype=torch.float64).index_add_(
        0, seg.cpu(), r64)
    mag = torch.zeros(64, 64, dtype=torch.float64).index_add_(
        0, seg.cpu(), r64.abs())
    count = torch.bincount(seg.cpu(), minlength=64).double()[:, None]
    assert bool(((a.cpu().double() - exact).abs()
                 <= count * 2.0 ** -24 * mag).all())
    c, rep = hashtable.sorted_combine_batch(rows, seg.to(torch.int32), found)
    c2, rep2 = hashtable.sorted_combine_batch(rows, seg.to(torch.int32),
                                              found)
    assert torch.equal(c, c2) and torch.equal(rep, rep2)
    assert int(rep.sum()) == int(seg[found].unique().numel())


def test_hist_bench_needs_a_card_and_writes_the_floor_kernel():
    """The histogram's launch-floor tool times CUDA kernels only; its
    empty kernel and graph-node counter are a source it writes under
    build/ (compiled on a card), hashed into its library's name."""
    with pytest.raises(RuntimeError):
        hist_bench.main(["--clusters", "4,8"], device="cpu")
    k = hist_bench.floor_kernel()
    text = k.source.read_text()
    assert "extern \"C\" int launch_floor(void* stream)" in text
    assert "cudaGraphGetNodes" in text and k.library.name.startswith(
        "liblaunch_floor-")

@pytest.mark.gpu
@pytest.mark.parametrize("kw", DMA_GATHERS, ids=str)
def test_dma_gather_empty_batch_launches_nothing(cuda, kw):
    gather = dma_bench.make_variant(kw, ch=2, scatter=False)
    t = _table(63, 2).to(cuda)
    before = gather.kernel.launches
    got = gather(t, torch.empty(0, dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert got.shape == (0, LANES)
    assert gather.kernel.launches == before

@pytest.mark.gpu
@pytest.mark.parametrize("ch", [1, 2])
@pytest.mark.parametrize("kw", DMA_SCATTERS, ids=str)
def test_dma_scatter_kernels_match_plain_on_card(cuda, ch, kw):
    cap, n = 1 << 12, 1037
    scatter = dma_bench.make_variant(kw, ch=ch, scatter=True)
    t = _table(cap, ch, seed=ch).to(cuda)  # with the trash row
    idx = torch.randperm(cap, device=cuda)[:n].to(torch.int32)
    idx[::7], idx[3::11], idx[5::13] = cap, -1, cap + 3
    rows = _table(n - 1, ch, seed=5).reshape(n * ch, LANES).to(cuda)
    a, b = t.clone(), t.clone()
    before = scatter.kernel.launches
    assert scatter(a, idx, rows) is a  # in place
    scatter.plain(b, idx, rows)
    torch.cuda.synchronize()
    assert scatter.kernel.launches == before + 1
    live = cap * ch  # never the trash row
    assert not torch.equal(a[:live], t[:live])
    assert torch.equal(a[:live].view(torch.int32), b[:live].view(torch.int32))


# -- the probes' kernels (tools/ab_kernel_cost.py, tools/ab_radix_plan.py) --


@pytest.mark.gpu
@pytest.mark.parametrize("nbuf", ab_kernel_cost.NBUFS)
@pytest.mark.parametrize("sub", ab_kernel_cost.SUBS)
@pytest.mark.parametrize("mode", list(ab_kernel_cost.MODES))
def test_ab_fused_matches_plain_on_card(cuda, mode, sub, nbuf):
    """Every mode x sub x nbuf at a ragged N (a partial tile and chunk),
    in place, sentinels on the trash row, negative and past-the-end
    indices skipped."""
    cap, n = 1 << 12, 1037
    rng = np.random.default_rng(sub + nbuf)
    t = _table(cap, 2, seed=7).to(cuda)  # random bits, with the trash row
    packed = torch.from_numpy(rng.uniform(0.05, 1.0, size=(n, 256)).astype(
        np.float32)).to(cuda)
    g = torch.from_numpy(rng.normal(size=(n, 64)).astype(np.float32)).to(cuda)
    idx = torch.randperm(cap, device=cuda)[:n].to(torch.int32)
    idx[::7], idx[3::11], idx[5::13] = cap, -1, cap + 3
    fn = ab_kernel_cost.make_fused(mode, sub=sub, nbuf=nbuf)
    a, b = t.clone(), t.clone()
    before = fn.kernel.launches
    assert fn(a, idx, packed, g, 3) is a  # in place
    fn.plain(b, idx, packed, g, 3)
    torch.cuda.synchronize()
    assert fn.kernel.launches == before + 1
    live = cap * 2  # never the trash row
    ra, rb = a[:live].view(cap, 256), b[:live].view(cap, 256)
    written = torch.zeros(cap, dtype=torch.bool, device=cuda)
    written[idx[(idx >= 0) & (idx < cap)].long()] = True
    assert torch.equal(ra[~written].view(torch.int32),
                       rb[~written].view(torch.int32))
    wa, wb = ra[written], rb[written]
    assert not torch.equal(wa, t[:live].view(cap, 256)[written])
    if mode == "adam":
        assert _ulps32(wa[:, :192], wb[:, :192]) <= 4
        assert not wa[:, 192:].view(torch.int32).any()  # +0.0 exactly
    else:
        assert torch.equal(wa.view(torch.int32), wb.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("n,offset", [(70001, 0), (70001, 1), (1 << 22, 0),
                                      (1 << 22, 3), (0, 0), (5, 2)])
def test_radix_hist_matches_bincount_on_card(cuda, n, offset):
    """Exact for every N: ragged, 4,194,304 ids (a grid of many clusters
    and the last-cluster ticket), none, and ids that start off a 16-byte
    boundary (the scalar head); one launch per call, no memset."""
    g = torch.Generator(device=cuda).manual_seed(n + offset)
    ids = torch.randint(-5000, 50000, (n + offset,), dtype=torch.int32,
                        device=cuda, generator=g)  # negatives, ids >= 1024
    bids = ids[offset:]
    before = cuda_ops.RADIX_HIST.launches
    got = ab_radix_plan.pallas_hist(bids, 1 << 15)
    want = ab_radix_plan.radix_hist_plain(bids)
    torch.cuda.synchronize()
    assert cuda_ops.RADIX_HIST.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got.long(), torch.bincount((bids & 1023).long(),
                                                  minlength=1024))
    assert int(got.sum()) == n
    # the ticket is back at 0: the next call is exact too
    assert torch.equal(ab_radix_plan.pallas_hist(bids, 0), want)
    # int64 ids are cut to int32 first, as the reference's astype
    assert torch.equal(ab_radix_plan.pallas_hist(
        bids.to(torch.int64) + (1 << 33), 0), got)


def _lifecycle_table(device, value_dtype, seed=0):
    """A 4,096-slot table of dim 16 with Adam's slots, 3,000 random keys
    and tied int32 scores, filled on the CPU and copied to ``device``."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de

    rng = np.random.default_rng(seed)
    var = de.Variable(name="life", dim=16, init_capacity=4096,
                      value_dtype=value_dtype, device="cpu")
    st = de.create_slots(var, var.init(), de.Adam(0.001))
    n = 3000
    rows = {nm: torch.from_numpy(rng.normal(size=(n, 16)).astype(np.float32))
            for nm in ("value",) + st.slot_names}
    st = var.import_batch(
        st, torch.from_numpy(rng.choice(1 << 40, n, replace=False)),
        rows.pop("value"),
        scores=torch.from_numpy(rng.integers(0, 100, n).astype(np.int32)),
        slot_rows=rows)
    return var, st.replace(**{f: getattr(st, f).to(device) for f in (
        "key_lo", "key_hi", "rows", "scores")})


def _same_table(a, b):
    for f in ("key_lo", "key_hi", "scores"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f
    n = a.capacity * a.chunks  # the trash row holds unspecified data
    assert torch.equal(a.rows[:n].cpu().view(torch.int32),
                       b.rows[:n].cpu().view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_lifecycle_on_card_matches_cpu(cuda, value_dtype, tmp_path):
    """The table lifecycle on the card against the same calls on a CPU
    copy: the save's compaction (value and slot columns in one row
    gather) writes byte-identical files; the restore (row scatter),
    restrict, grow and the chunked export agree bit for bit."""
    import dataclasses
    import filecmp
    import os

    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    var, cpu = _lifecycle_table("cpu", value_dtype)
    _, card = _lifecycle_table(cuda, value_dtype)
    gvar = dataclasses.replace(var, device="cuda")
    before = cuda_ops.ROW_GATHER.launches
    ckpt.save_dynamic_embedding(gvar, card, str(tmp_path / "card"))
    assert cuda_ops.ROW_GATHER.launches == before + 1
    ckpt.save_dynamic_embedding(var, cpu, str(tmp_path / "cpu"))
    sub = os.path.join(ckpt.DE_DIR_NAME, "life")
    names = sorted(os.listdir(tmp_path / "cpu" / sub))
    assert len(names) == 6
    _, diff, err = filecmp.cmpfiles(tmp_path / "card" / sub,
                                    tmp_path / "cpu" / sub, names,
                                    shallow=False)
    assert not diff and not err
    before = cuda_ops.ROW_SCATTER.launches
    back = ckpt.load_dynamic_embedding(gvar, gvar.init(),
                                       str(tmp_path / "card"),
                                       buffer_size=1000)
    assert cuda_ops.ROW_SCATTER.launches == before + 3
    _same_table(back, ckpt.load_dynamic_embedding(
        var, var.init(), str(tmp_path / "cpu"), buffer_size=1000))
    for policy in (de.TimestampRestrictPolicy, de.FrequencyRestrictPolicy):
        _same_table(policy(gvar).apply_restriction(card, 1000),
                    policy(var).apply_restriction(cpu, 1000))
    gv, grown = gvar.grow(card, 8192, chunk_size=1000)
    cv, cgrown = var.grow(cpu, 8192, chunk_size=1000)
    _same_table(grown, cgrown)
    got = list(gv.export_chunked(grown, 1500))
    want = list(cv.export_chunked(cgrown, 1500))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def _sharded_run(where, tmp_path):
    """A 4-shard Adagrad table on ``where`` (a mesh of 4 logical shards of
    one device): 3 lookup + apply steps, the second a hot-key batch (one
    key over more than K positions of block 0), then an inference lookup
    and a save. Returns the contexts' planes, the state and the lookup."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    var = de.Variable(name="shc", dim=16, init_capacity=1 << 12,
                      initializer=de.initializers.normal(0.1), device=where)
    sv = parallel.ShardedVariable(var, parallel.create_mesh(
        devices=[where] * 4))
    opt = de.Adagrad(0.1)
    st = sv.create_slots(sv.init(), opt)
    rng = np.random.default_rng(0)
    planes = []
    for t in range(3):
        ids = rng.integers(1, 3000, size=512).astype(np.int64)
        if t == 1:
            ids[:128] = 77  # block 0: one key 128 times, K = 64
        g = rng.normal(size=(512, 16)).astype(np.float32)
        _, ctx = sv.embedding_lookup(st, torch.from_numpy(ids).to(where),
                                     step=t)
        assert ctx.deduped == (t == 1)
        planes.append([x.cpu() for x in ctx.send_pos + ctx.routed]
                      + [getattr(o, f).cpu() for o in ctx.octx
                         for f in ("unique_keys", "found", "inserted")])
        st = sv.apply_gradients(st, ctx, torch.from_numpy(g).to(where), opt,
                                step=t)
    probe = torch.arange(1, 3100).to(where)
    ckpt.save_dynamic_embedding(sv, st, str(tmp_path / str(where)))
    return sv, planes, st, sv.lookup(st, probe).cpu()


@pytest.mark.gpu
def test_sharded_route_on_card_matches_cpu(cuda, tmp_path):
    """The sharded route (4 logical shards of the card) against the same
    calls on 4 CPU shards: routing and owner planes and every shard's key
    and score planes bit-exact, rows within rtol 1e-5 / atol 1e-6, the
    shard files' keys and scores byte-identical and their values and slots
    within the same tolerance; the card run launches row_gather and
    fused_update_scatter, its direct restore row_scatter."""
    import filecmp
    import os

    from recommenders_addons_tpu_torch.train import checkpoint as ckpt

    before = {k.name: k.launches for k in cuda_ops.KERNELS}
    sv, gp, gst, glook = _sharded_run(cuda, tmp_path)
    for name in ("row_gather", "fused_update_scatter"):
        assert getattr(cuda_ops, name.upper()).launches > before[name]
    _, cp, cst, clook = _sharded_run("cpu", tmp_path)
    for a, b in zip(gp, cp):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    for g, c in zip(gst.shards, cst.shards):
        for f in ("key_lo", "key_hi", "scores"):
            assert torch.equal(getattr(g, f).cpu(), getattr(c, f)), f
        torch.testing.assert_close(g.rows_logical.cpu(), c.rows_logical,
                                   rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(glook, clook, rtol=1e-5, atol=1e-6)
    sub = os.path.join(ckpt.DE_DIR_NAME, "shc")
    names = sorted(os.listdir(tmp_path / "cpu" / sub))
    assert sum("of4_" in n for n in names) == 16
    exact = [n for n in names if n.endswith(("-keys", "-scores"))]
    _, diff, err = filecmp.cmpfiles(tmp_path / str(cuda) / sub,
                                    tmp_path / "cpu" / sub, exact,
                                    shallow=False)
    assert len(exact) == 8 and not diff and not err
    for n in names:
        if n.endswith(("-values", "-slots.accumulator")):
            np.testing.assert_allclose(
                np.fromfile(tmp_path / str(cuda) / sub / n, np.float32),
                np.fromfile(tmp_path / "cpu" / sub / n, np.float32),
                rtol=1e-5, atol=1e-6)
    before = cuda_ops.ROW_SCATTER.launches
    back = ckpt.load_dynamic_embedding(sv, sv.init(),
                                       str(tmp_path / str(cuda)))
    assert ckpt.LAST_RESTORE_USED_DIRECT
    assert cuda_ops.ROW_SCATTER.launches >= before + 4
    assert torch.equal(sv.lookup(back, torch.arange(1, 3100).to(cuda)).cpu(),
                       glook)


@pytest.mark.gpu
def test_group_mesh_world_of_one_on_card(cuda, tmp_path):
    """The process-group exchange on NCCL, a world of one rank (a
    FileStore; no network): a one-shard table trains 3 steps like one
    unsharded table on the card (planes bit-exact, rows within rtol 1e-5 /
    atol 1e-6)."""
    import torch.distributed as dist

    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch import parallel
    from recommenders_addons_tpu_torch.parallel import multihost

    assert multihost.initialize(f"file://{tmp_path}/store", world_size=1,
                                rank=0, backend="nccl")
    try:
        mesh = multihost.global_mesh(device=cuda)
        assert isinstance(mesh, parallel.GroupMesh)
        var = de.Variable(name="g1", dim=16, init_capacity=1 << 12,
                          initializer=de.initializers.normal(0.1))
        sv = parallel.ShardedVariable(var, mesh)
        opt = de.Adagrad(0.1)
        st = sv.create_slots(sv.init(), opt)
        one = de.create_slots(var, var.init(), opt)
        rng = np.random.default_rng(1)
        for t in range(3):
            ids = torch.from_numpy(rng.integers(1, 3000, size=512)).to(cuda)
            g = torch.from_numpy(rng.normal(size=(512, 16)).astype(
                np.float32)).to(cuda)
            _, ctx = sv.embedding_lookup(st, ids, step=t)
            st = sv.apply_gradients(st, ctx, g, opt, step=t)
            _, c1 = var.embedding_lookup(one, ids, step=t)
            one = var.apply_gradients(one, c1, g, opt, step=t)
        (shard,) = st.shards
        for f in ("key_lo", "key_hi", "scores"):
            assert torch.equal(getattr(shard, f), getattr(one, f)), f
        torch.testing.assert_close(shard.rows_logical, one.rows_logical,
                                   rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()
