"""Row-copy micro-benchmark: how fast can a kernel move table rows, one
bulk copy per row, and what does the copy loop's geometry (copies in
flight, grouped waits, unrolling, predication) cost? The port's
counterpart of the JAX package's ``tools/dma_bench.py``, on an NVIDIA
Hopper card.

    python -m recommenders_addons_tpu_torch.tools.dma_bench [log2_capacity] [chunks]

(defaults 21 and 2: a table of 2Mi rows of 2 x 128 32-bit words). For
every variant of :data:`VARIANTS` (gathers) and :data:`SC_VARIANTS`
(scatters) it prints ns/row, the slope between adjacently timed batches of
8,192 and 65,536 rows (median of 7, 10 calls each, CUDA events behind a
device spin that lets the host queue them all), the ms of one 65,536-row
call, and the bytes bound; then the same for the library's
row kernel (``row_gather`` / ``row_scatter``) and for
``torch.index_select`` / ``Tensor.index_copy_`` at that shape.

The four factories keep the JAX tool's arguments and return callables of
its signatures, ``gather(table2d, idx) -> [N*ch, 128]`` and
``scatter(table2d, idx, rows) -> table2d`` (in place), on the physical
``[rows*ch, 128]`` table of 32-bit words. ``ch`` is an argument here
instead of a module global. A CUDA tensor launches the factory's CUDA
kernel (``csrc/dma_*.cu``: Hopper bulk copies counted on mbarriers or
bulk groups), or raises; a CPU tensor runs the plain PyTorch version
(:func:`gather_plain`, :func:`scatter_plain`), which each callable also
carries as ``.plain``, beside its kernel as ``.kernel``.

Semantics, including where the reference is undefined:

* the index is premultiplied in int32 (``idx * ch`` wraps as the
  reference's does); ``premul`` only picks what a predicate tests: the
  premultiplied index (``premul``) or the row index must lie in
  ``[0, cap)``, with ``cap = rows - extra_rows`` (the reference's quirk);
* a predicated-off gather row is zeros (the reference leaves it
  unwritten), a predicated-off scatter row is not written;
* without a predicate, a gather clamps the row start into the table and a
  scatter skips a row whose start falls outside it (both undefined in the
  reference); the sentinel index ``CAP`` of a table with a trash row
  writes the trash row, whose contents are then unspecified;
* any N runs (the reference drops rows past its last 1,024-row tile);
* valid scatter indices must be unique.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.ops.hashing import _wrap32
from recommenders_addons_tpu_torch.utils.config import resolve_device

_LANES = 128
_ROW_BYTES = _LANES * 4  # one chunk
_MAX_TX_BYTES = (1 << 20) - 1  # one mbarrier phase
_POW2 = (1, 2, 4, 8, 16, 32)  # template instantiations of the kernels
BATCHES = (1 << 13, 1 << 16)
STEPS = 10
REPS = 7

# device memory rate by card name (NVIDIA data sheets), for the bounds
MEM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                   ("H100 PCIe", 2.0e12), ("H100", 3.35e12))

# the JAX tool's main() lists (tools/dma_bench.py:408-417, :434-441)
VARIANTS = [
    ("unroll16  nbuf32 premul", dict(nbuf=32, predicated=False,
                                     bitand=True, unroll=16,
                                     premul=True)),
    ("grouped g16 x 4sem", dict(grouped=True, ngroups=4, group=16)),
    ("grouped g16 x 8sem", dict(grouped=True, ngroups=8, group=16)),
    ("grouped g16 x 16sem", dict(grouped=True, ngroups=16, group=16)),
    ("grouped g32 x 8sem", dict(grouped=True, ngroups=8, group=32)),
    ("grouped g8 x 8sem", dict(grouped=True, ngroups=8, group=8)),
]
SC_VARIANTS = [
    ("SC u16 nbuf32 premul", dict(nbuf=32, predicated=False,
                                  unroll=16, extra_rows=1,
                                  premul=True)),
    ("SC grouped g8 x 8sem", dict(grouped=True, ngroups=8, group=8)),
    ("SC grouped g16 x 8sem", dict(grouped=True, ngroups=8, group=16)),
    ("SC grouped g8 x 16sem", dict(grouped=True, ngroups=16, group=8)),
]


def mem_rate(card_name: str) -> float:
    """Device memory bytes/s of the card named ``card_name``."""
    for sub, rate in MEM_BYTES_PER_S:
        if sub in card_name:
            return rate
    raise RuntimeError(f"no memory rate on record for card {card_name!r}")


# ---------------------------------------------------------------------------
# arguments and plain versions
# ---------------------------------------------------------------------------


def _check_pow2(what: str, v: int, allowed=_POW2) -> None:
    if v not in allowed:
        raise ValueError(f"{what} must be one of {allowed}, got {v}")


def _table_words(table2d: torch.Tensor, ch: int) -> torch.Tensor:
    if not 1 <= ch <= 256:
        raise ValueError(f"need 1 <= ch <= 256, got {ch}")
    if table2d.dim() != 2 or table2d.shape[1] != _LANES:
        raise ValueError(f"table must be [rows*ch, {_LANES}], got "
                         f"{tuple(table2d.shape)}")
    if table2d.shape[0] < ch or table2d.shape[0] % ch:
        raise ValueError(f"table of {table2d.shape[0]} chunks is not whole "
                         f"rows of ch={ch}")
    return cuda_ops._words(table2d, "table")


def _rows_words(table2d, rows, n, ch) -> torch.Tensor:
    if rows.device != table2d.device:
        raise ValueError(f"rows on {rows.device}, table on {table2d.device}")
    rows32 = cuda_ops._words(rows.to(table2d.dtype).reshape(-1, _LANES)
                             .contiguous(), "rows")
    if rows32.shape[0] != n * ch:
        raise ValueError(f"{n} indices for {rows32.shape[0]} chunks of rows "
                         f"(need {n * ch})")
    return rows32


def _bases(idx: torch.Tensor, ch: int):
    """(row index, premultiplied index wrapped to int32), both int64."""
    raw = idx.to(torch.int64)
    return raw, _wrap32((raw * ch) & 0xFFFFFFFF).to(torch.int64)


def _in_cap(raw, base, cap, premul):
    v = base if premul else raw
    return (v >= 0) & (v < cap)


def _gather_plain(t32, idx, ch, predicated, premul):
    nphys = t32.shape[0]
    raw, base = _bases(idx, ch)
    start = base.clamp(0, nphys - ch)
    phys = start[:, None] + torch.arange(ch, device=t32.device)
    out = t32[phys.reshape(-1)]
    if predicated:
        ok = _in_cap(raw, base, nphys // ch, premul)
        out = out.masked_fill(~ok.repeat_interleave(ch)[:, None], 0)
    return out


def _scatter_plain(t32, idx, rows32, ch, predicated, premul, extra_rows):
    nphys = t32.shape[0]
    raw, base = _bases(idx, ch)
    if predicated:
        keep = _in_cap(raw, base, nphys // ch - extra_rows, premul)
    else:
        keep = (base >= 0) & (base <= nphys - ch)
    phys = base[keep][:, None] + torch.arange(ch, device=t32.device)
    t32[phys.reshape(-1)] = rows32.reshape(-1, ch, _LANES)[keep].reshape(
        -1, _LANES)


def gather_plain(table2d: torch.Tensor, idx: torch.Tensor, *, ch: int,
                 predicated: bool = False,
                 premul: bool = False) -> torch.Tensor:
    """The plain PyTorch version of the gathers (advanced indexing), on
    any device: ``[N*ch, 128]`` in the table's dtype."""
    t32 = _table_words(table2d, ch)
    idx = cuda_ops._index(idx, t32.device)
    return _gather_plain(t32, idx, ch, predicated, premul).view(
        table2d.dtype)


def scatter_plain(table2d: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor, *, ch: int, predicated: bool = False,
                  premul: bool = False, extra_rows: int = 0) -> torch.Tensor:
    """The plain PyTorch version of the scatters (an indexed assignment),
    on any device; in place, returns ``table2d``."""
    t32 = _table_words(table2d, ch)
    idx = cuda_ops._index(idx, t32.device)
    rows32 = _rows_words(table2d, rows, idx.shape[0], ch)
    _scatter_plain(t32, idx, rows32, ch, predicated, premul, extra_rows)
    return table2d


# ---------------------------------------------------------------------------
# the four factories
# ---------------------------------------------------------------------------


def _with(fn, plain, kernel):
    fn.plain, fn.kernel = plain, kernel
    return fn


def _gathering(kernel, plain, ch, extra):
    """A gather callable: the kernel on CUDA tensors, the plain version on
    CPU tensors. ``extra(rows)`` checks the table's row count and returns
    the kernel's arguments after the index count. It launches the kernel
    its ``.kernel`` names at call time (``tools/gather_sweep.py`` sets a
    rebuilt copy there)."""

    def gather(table2d, idx):
        t32 = _table_words(table2d, ch)
        idx = cuda_ops._index(idx, t32.device)
        args = extra(t32.shape[0] // ch)
        if not cuda_ops._is_cuda(t32):
            return plain(table2d, idx)
        n = idx.shape[0]
        out = torch.empty((n * ch, _LANES), dtype=torch.int32,
                          device=t32.device)
        cuda_ops._check_aligned(t32, out)
        if n:
            gather.kernel.launch(t32.device, t32.data_ptr(), t32.shape[0],
                                 ch, idx.data_ptr(), n, *args,
                                 out.data_ptr())
        return out.view(table2d.dtype)

    return _with(gather, plain, kernel)


def _scattering(kernel, plain, ch, extra):
    """A scatter callable, as :func:`_gathering`; in place."""

    def scatter(table2d, idx, rows):
        t32 = _table_words(table2d, ch)
        idx = cuda_ops._index(idx, t32.device)
        rows32 = _rows_words(table2d, rows, idx.shape[0], ch)
        args = extra(t32.shape[0] // ch)
        if not cuda_ops._is_cuda(t32):
            return plain(table2d, idx, rows)
        cuda_ops._check_aligned(t32, rows32)
        n = idx.shape[0]
        if n:
            kernel.launch(t32.device, t32.data_ptr(), t32.shape[0], ch,
                          idx.data_ptr(), n, rows32.data_ptr(), *args)
        return table2d

    return _with(scatter, plain, kernel)


def make_gather(nbuf: int, predicated: bool, bitand: bool, unroll: int,
                premul: bool = False, *, ch: int = 2):
    """Row gather with one wait per row and ``nbuf`` copies in flight
    (``csrc/dma_gather.cu``; the JAX tool's ``make_gather``)."""
    if not 1 <= nbuf <= 64 or (bitand and nbuf & (nbuf - 1)):
        raise ValueError(f"nbuf must be in [1, 64] (a power of two with "
                         f"bitand), got {nbuf}")
    _check_pow2("unroll", unroll)
    plain = functools.partial(gather_plain, ch=ch, predicated=predicated,
                              premul=premul)
    return _gathering(
        cuda_ops.DMA_GATHER, plain, ch,
        lambda cap: (cap, nbuf, int(bitand), unroll, int(predicated),
                     int(premul)))


def make_gather_grouped(ngroups: int, group: int, *, ch: int = 2):
    """Row gather whose ``group`` copies count towards one barrier, one
    wait per group, ``ngroups`` groups in flight; premultiplied index
    (``csrc/dma_gather_grouped.cu``; the JAX tool's
    ``make_gather_grouped``)."""
    _check_pow2("ngroups", ngroups, _POW2 + (64,))
    _check_pow2("group", group)
    if group * ch * _ROW_BYTES > _MAX_TX_BYTES:
        raise ValueError(f"a group of {group} rows of ch={ch} passes one "
                         f"barrier phase's {_MAX_TX_BYTES} bytes")
    plain = functools.partial(gather_plain, ch=ch, premul=True)
    return _gathering(cuda_ops.DMA_GATHER_GROUPED, plain, ch,
                      lambda cap: (ngroups, group))


def make_scatter_grouped(ngroups: int, group: int, *, ch: int = 2):
    """In-place row scatter committing ``group`` stores per bulk group,
    ``ngroups`` groups in flight; premultiplied index, sentinels on the
    trash row (``csrc/dma_scatter_grouped.cu``; the JAX tool's
    ``make_scatter_grouped``)."""
    _check_pow2("ngroups", ngroups)
    _check_pow2("group", group)

    def plain(table2d, idx, rows):
        return scatter_plain(table2d, idx, rows, ch=ch, premul=True)

    return _scattering(cuda_ops.DMA_SCATTER_GROUPED, plain, ch,
                       lambda cap: (ngroups, group))


def make_scatter(nbuf: int, predicated: bool, unroll: int,
                 extra_rows: int = 0, premul: bool = False, *, ch: int = 2):
    """In-place row scatter with one bulk group per row, ``nbuf`` in
    flight; with ``extra_rows=1`` the table carries a trash row at index
    CAP, which sentinel writes land on (``csrc/dma_scatter.cu``; the JAX
    tool's ``make_scatter``)."""
    _check_pow2("nbuf", nbuf)
    _check_pow2("unroll", unroll)
    if extra_rows < 0:
        raise ValueError(f"extra_rows must be >= 0, got {extra_rows}")

    def plain(table2d, idx, rows):
        return scatter_plain(table2d, idx, rows, ch=ch,
                             predicated=predicated, premul=premul,
                             extra_rows=extra_rows)

    def extra(nrows):
        if nrows <= extra_rows:
            raise ValueError(f"a table of {nrows} rows has no row besides "
                             f"its {extra_rows} trash rows")
        return (nrows - extra_rows, nbuf, unroll, int(predicated),
                int(premul))

    return _scattering(cuda_ops.DMA_SCATTER, plain, ch, extra)


def make_variant(kw: dict, *, ch: int, scatter: bool):
    """The callable of one entry of :data:`VARIANTS` (``scatter=False``)
    or :data:`SC_VARIANTS`."""
    kw = dict(kw)
    if kw.pop("grouped", False):
        make = make_scatter_grouped if scatter else make_gather_grouped
    else:
        make = make_scatter if scatter else make_gather
    return make(**kw, ch=ch)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


# device cycles of the spin queued ahead of each timed region, per call in
# it: about 100 us at the H100's clock, more than one call takes the host
# to enqueue
_LEAD_CYCLES_PER_CALL = 200_000


def seconds(fn, device: torch.device, calls: int) -> float:
    """Seconds that ``fn()`` (``calls`` launches) takes. On a card: CUDA
    events around it, behind a device spin long enough for the host to
    queue every launch first, so the events time the card's work and not
    the host's launch gaps. On the CPU: the host clock."""
    if device.type != "cuda":
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(_LEAD_CYCLES_PER_CALL * calls)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _pair_slope(run_by_b, device: torch.device) -> float:
    """Marginal seconds per row from ADJACENTLY timed (b0, b1) runs of
    STEPS calls each, median over REPS (the JAX tool's methodology)."""
    b0, b1 = BATCHES
    for b in BATCHES:  # build + warm
        run_by_b[b]()
    slopes = []
    for _ in range(REPS):
        ts = {b: seconds(run_by_b[b], device, STEPS) for b in BATCHES}
        slopes.append((ts[b1] - ts[b0]) / (b1 - b0) / STEPS)
    slopes.sort()
    return slopes[len(slopes) // 2]


def call_ms(fn, device: torch.device, iters: int = 20) -> float:
    """Mean ms of one ``fn()`` over ``iters`` back-to-back calls, after two
    warm-up calls."""
    for _ in range(2):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    return seconds(calls, device, iters) / iters * 1e3


def step_indices(base: torch.Tensor, cap: int) -> list:
    """The STEPS index batches of one timed run: ``base`` rotated by a
    multiplicative step each call (the JAX tool's scan), made ahead."""
    k = 2654435761 % cap
    b64 = base.to(torch.int64)
    return [((b64 + i * k) & (cap - 1)).to(torch.int32)
            for i in range(STEPS)]


def gather_bytes(idx: torch.Tensor, ch: int) -> int:
    """Bytes a gather must move: each distinct row read once, the index
    read, every output row written."""
    n = idx.shape[0]
    return (int(torch.unique(idx).numel()) + n) * ch * _ROW_BYTES + n * 4


def scatter_bytes(idx: torch.Tensor, ch: int) -> int:
    """Bytes a scatter must move: every batch row and index read, each
    distinct table row written once."""
    n = idx.shape[0]
    return (n + int(torch.unique(idx).numel())) * ch * _ROW_BYTES + n * 4


def _entry(slope_s, ms, nbytes, rate):
    n = BATCHES[1]
    bound_ms = None if rate is None else nbytes / rate * 1e3
    return {"ns_per_row": slope_s * 1e9, "ms": ms, "bytes": nbytes,
            "bound_ms": bound_ms,
            "bound_ns_per_row": None if rate is None else bound_ms / n * 1e6}


def _line(name, e):
    bound = ("not measured" if e["bound_ms"] is None else
             f"{e['bound_ns_per_row']:6.3f} ns/row {e['bound_ms']:.4f} ms")
    print(f"{name:>28}: {e['ns_per_row']:7.3f} ns/row  {e['ms']:.4f} ms "
          f"per {BATCHES[1]} rows  (bound {bound})", flush=True)


def main(argv=None, *, device=None) -> dict:
    """Run every variant at ``[log2_capacity] [chunks]`` (argv, default
    ``sys.argv[1:]``: 21 and 2) on ``device`` (default CUDA; raises
    without a card unless given ``device="cpu"``). Prints one line per
    variant and returns the numbers."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cap = 1 << (int(argv[0]) if argv else 21)
    ch = int(argv[1]) if len(argv) > 1 else 2
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rate = mem_rate(kind) if dev.type == "cuda" else None
    n = BATCHES[1]
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randint(-(1 << 31), (1 << 31) - 1, (cap * ch, _LANES),
                          dtype=torch.int32, device=dev,
                          generator=gen).view(torch.float32)
    print(f"cap={cap} row={ch * _ROW_BYTES}B device={kind}", flush=True)
    out = {"device": kind, "cap": cap, "ch": ch,
           "row_bytes": ch * _ROW_BYTES, "n": n, "mem_bytes_per_s": rate,
           "gather": {}, "scatter": {}}

    def idx_by_b():
        return {b: step_indices(torch.from_numpy(
            rng.integers(0, cap, size=b, dtype=np.int32)).to(dev), cap)
            for b in BATCHES}

    def gather_entry(fn, idx):
        def run(b):
            return lambda: [fn(i) for i in idx[b]]
        slope = _pair_slope({b: run(b) for b in BATCHES}, dev)
        ms = call_ms(lambda: fn(idx[n][0]), dev)
        return _entry(slope, ms, gather_bytes(idx[n][0], ch), rate)

    for name, kw in VARIANTS:
        g = make_variant(kw, ch=ch, scatter=False)
        out["gather"][name] = gather_entry(lambda i, g=g: g(table, i),
                                           idx_by_b())
        _line(name, out["gather"][name])
    idx = idx_by_b()
    rows_logical = table.view(cap, ch * _LANES)

    def row_gather(i):
        return cuda_ops.gather_rows_2d(table, ch, i, masked=False)

    def index_select(i):
        return torch.index_select(rows_logical, 0, i)

    for name, fn in (("row_gather (kernel 1)", row_gather),
                     ("torch.index_select", index_select)):
        out["gather"][name] = gather_entry(fn, idx)
        _line(name, out["gather"][name])

    # the scatters write a copy with a trash row (index cap)
    tbl = torch.cat([table, table.new_zeros((ch, _LANES))])
    del table, rows_logical
    rows = {b: torch.ones((b * ch, _LANES), dtype=tbl.dtype, device=dev)
            for b in BATCHES}

    def scatter_entry(fn, idx):
        def run(b):
            return lambda: [fn(i, rows[b]) for i in idx[b]]
        slope = _pair_slope({b: run(b) for b in BATCHES}, dev)
        ms = call_ms(lambda: fn(idx[n][0], rows[n]), dev)
        return _entry(slope, ms, scatter_bytes(idx[n][0], ch), rate)

    for name, kw in SC_VARIANTS:
        s = make_variant(kw, ch=ch, scatter=True)
        out["scatter"][name] = scatter_entry(
            lambda i, r, s=s: s(tbl, i, r), idx_by_b())
        _line(name, out["scatter"][name])
    idx = idx_by_b()
    idx64 = {b: [i.long() for i in idx[b]] for b in BATCHES}
    tbl_logical = tbl.view(cap + 1, ch * _LANES)

    def row_scatter(i, r):
        cuda_ops.scatter_rows_set_2d(tbl, ch, i, r.view(-1, ch * _LANES),
                                     cap=cap)

    def index_copy(i, r):
        tbl_logical.index_copy_(0, i, r.view(-1, ch * _LANES))

    for name, fn, ix in (("row_scatter (kernel 2)", row_scatter, idx),
                         ("torch.Tensor.index_copy_", index_copy, idx64)):
        out["scatter"][name] = scatter_entry(fn, ix)
        _line(name, out["scatter"][name])
    return out


if __name__ == "__main__":
    main()
