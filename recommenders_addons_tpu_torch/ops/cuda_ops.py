"""Hand-written CUDA kernels for the dynamic-embedding hot path — the
port's counterpart of the JAX package's ``ops/pallas_ops.py``.

Three kernels of the library's paths, all CUDA C++ for Hopper
(``sm_90a``) under ``csrc/``:

* ``row_gather`` (``csrc/row_gather.cu``) replaces the Pallas
  ``_gather_kernel`` (pallas_ops.py:165) behind :func:`gather_rows_2d`;
* ``row_scatter`` (``csrc/row_scatter.cu``) replaces the Pallas
  ``_scatter_kernel`` (pallas_ops.py:192) behind
  :func:`scatter_rows_set_2d`;
* ``fused_update_scatter`` (``csrc/fused_update_scatter.cu``) replaces
  ``fused_update_scatter_refs`` (pallas_ops.py:322) with the tile math of
  ``optimizer._fused_rows_pf1``/``_pf2`` behind
  :func:`fused_update_scatter`: a named optimizer's row update fused into
  the row scatter.

The registry also holds the four kernels of the row-copy
micro-benchmark (``DMA_GATHER``, ``DMA_GATHER_GROUPED``,
``DMA_SCATTER_GROUPED``, ``DMA_SCATTER``: Hopper bulk copies counted on
mbarriers or bulk groups, sharing ``csrc/bulk_copy.cuh``), whose wrappers
live in ``tools/dma_bench.py``, and the two probes' kernels: ``AB_FUSED``
(``csrc/ab_fused.cu``, the fused-apply cost probe's Adam / identity /
raw-copy row scatter, wrapped by ``tools/ab_kernel_cost.py``) and
``RADIX_HIST`` (``csrc/radix_hist.cu``, a 1,024-bin histogram, wrapped by
``tools/ab_radix_plan.py``), so one build and one launch count cover
every kernel of the port.

All are indexed data movement (the fused applies with a few flops per
word, the histogram with one atomic add per key), so all are bound by
bytes: the sources say what their design does about that. Tables keep the JAX
package's physical layout, a ``[(C+1)*ch, 128]`` container of 32-bit words
with a trash row block at logical index ``C``; the kernels move the words
through an int32 view, so f16/bf16 pairs whose bits read as NaNs pass
untouched. A 64-bit container (f64 and int64 tables) is viewed the same
way by the row gather and scatter: each 8-byte row of 128 elements is two
rows of 128 words, so the kernels move it with the chunk counts doubled
while the logical row count and ``cap`` stay as they are.

Dispatch has one rule: a CUDA tensor goes to the kernel, a CPU tensor to
the plain PyTorch version beside it (``*_plain``), which the CPU tests run
and ``chip_smoke.py`` holds each kernel against on the card. There is no
fallback: a kernel that does not build or launch raises.

Kernels are compiled with ``nvcc`` into ``build/torch_kernels/`` at a
source checkout's root (an installed copy: the user's cache directory,
``_paths.build_dir``), at first use (or all at once, in parallel, by
:func:`build_kernels`), into shared libraries with a plain C interface
that ``ctypes`` loads; the library name carries a hash of its source and
the shared headers, so an edited source is rebuilt. Each kernel counts
its launches (``ROW_GATHER.launches``, ``ROW_SCATTER.launches``, ...), so
a run can show that its path went through the kernels. The libraries are
built without fused multiply-add (``-fmad=false``): the fused apply's
products and sums then round as the separate operations of its plain
version and of XLA do.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Tuple

import torch

from recommenders_addons_tpu_torch._paths import build_dir
from recommenders_addons_tpu_torch.ops.hashing import _wrap32

_LANES = 128
_PKG = Path(__file__).resolve().parent.parent
_BUILD_DIR = build_dir("torch_kernels")
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_F32 = ctypes.c_float
_build_lock = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((os.path.join(home, "bin", "nvcc") if home else None),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


class _Kernel:
    """One hand-written CUDA kernel: its source, its library (built on
    first use) and its launch count."""

    def __init__(self, name: str, argtypes):
        self.name = name
        self.source = _PKG / "csrc" / f"{name}.cu"
        self.argtypes = argtypes
        self.launches = 0  # successful launches since the last reset
        self._fn = None

    @property
    def library(self) -> Path:
        """The built library; its name hashes the source and every shared
        header in ``csrc/``, so an edit to either is rebuilt."""
        h = hashlib.sha1(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            h.update(header.read_bytes())
        return _BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:12]}.so"

    def _start_build(self):
        """Start nvcc for this kernel (None when already built)."""
        if self.library.exists():
            return None
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)

    def _finish_build(self, started) -> None:
        if started is None:
            return
        tmp, proc = started
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {self.source.name}:\n"
                               f"{out}")
        os.replace(tmp, self.library)

    def _load(self):
        lib = ctypes.CDLL(str(self.library))
        fn = getattr(lib, self.name)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def launch(self, device: torch.device, *args) -> None:
        """Launch on ``device``'s current stream; raise on a refused
        launch. Counts the launch."""
        if self._fn is None:
            build_kernels((self,))
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name} launch failed: CUDA error {err}")
        self.launches += 1


ROW_GATHER = _Kernel("row_gather",
                     [_P, _I64, _I32, _P, _I64, _I32, _I64, _I32, _P, _P])
ROW_SCATTER = _Kernel("row_scatter", [_P, _I64, _I32, _P, _I64, _P, _P])
FUSED_UPDATE_SCATTER = _Kernel(
    "fused_update_scatter",
    [_P, _I64, _I32, _P, _I64, _P, _P, _I32, _I32, _I32, _I32, _I32, _I32,
     _F32] + [_F32] * 8 + [_P])
# the row-copy micro-benchmark's kernels (tools/dma_bench.py wraps them)
DMA_GATHER = _Kernel("dma_gather", [_P, _I64, _I32, _P, _I64, _I64, _I32,
                                    _I32, _I32, _I32, _I32, _P, _P])
DMA_GATHER_GROUPED = _Kernel("dma_gather_grouped",
                             [_P, _I64, _I32, _P, _I64, _I32, _I32, _P, _P])
DMA_SCATTER_GROUPED = _Kernel("dma_scatter_grouped",
                              [_P, _I64, _I32, _P, _I64, _P, _I32, _I32, _P])
DMA_SCATTER = _Kernel("dma_scatter", [_P, _I64, _I32, _P, _I64, _P, _I64,
                                      _I32, _I32, _I32, _I32, _P])
# the probes' kernels (tools/ab_kernel_cost.py, tools/ab_radix_plan.py)
AB_FUSED = _Kernel("ab_fused", [_P, _I64, _P, _I64, _P, _P, _F32, _I32,
                                _I32, _I32, _P])
RADIX_HIST = _Kernel("radix_hist", [_P, _I64, _P, _P, _I32, _P, _P])
KERNELS = (ROW_GATHER, ROW_SCATTER, FUSED_UPDATE_SCATTER, DMA_GATHER,
           DMA_GATHER_GROUPED, DMA_SCATTER_GROUPED, DMA_SCATTER, AB_FUSED,
           RADIX_HIST)


def build_kernels(kernels=KERNELS) -> None:
    """Build and load ``kernels``, one nvcc process each, all started
    together. Raises if any build fails."""
    with _build_lock:
        todo = [k for k in kernels if k._fn is None]
        started = [k._start_build() for k in todo]
        for k, s in zip(todo, started):
            k._finish_build(s)
        for k in todo:
            k._load()


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ---------------------------------------------------------------------------
# argument checks shared by the kernels and their plain versions
# ---------------------------------------------------------------------------


def _words(t: torch.Tensor, what: str) -> torch.Tensor:
    """int32 view of a contiguous 32-bit tensor (bits, not values)."""
    if t.element_size() != 4:
        raise TypeError(f"{what} must hold 32-bit words, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return t.view(torch.int32)


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def _check_aligned(*ts: torch.Tensor) -> None:
    for t in ts:
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels move 16-byte words: tensors "
                             "must start on a 16-byte boundary")


def _row_words(t: torch.Tensor, what: str):
    """The row kernels' view of a container of 32- or 64-bit elements:
    ``(int32 view, k)`` with ``k`` words an element. The view's last
    dimension is ``k`` times the tensor's (a 64-bit element is its low
    word, then its high word)."""
    if t.element_size() not in (4, 8):
        raise TypeError(f"{what} must hold 32- or 64-bit elements, got "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    return t.view(torch.int32), t.element_size() // 4


def _index(idx: torch.Tensor, device: torch.device) -> torch.Tensor:
    return idx.reshape(-1).to(device=device, dtype=torch.int32).contiguous()


# ---------------------------------------------------------------------------
# row gather
# ---------------------------------------------------------------------------


def _gather_args(table2d, ch, idx, cap, masked, flat, vc):
    if table2d.dim() != 2 or table2d.shape[1] != _LANES:
        raise ValueError(f"table must be [rows, {_LANES}], got "
                         f"{tuple(table2d.shape)}")
    vc = ch if vc is None else vc
    if not 1 <= vc <= ch:
        raise ValueError(f"need 1 <= vc <= ch, got vc={vc} ch={ch}")
    nrows = table2d.shape[0] // ch
    if nrows < 1:
        raise ValueError("table holds no row")
    cap = nrows if cap is None else cap
    t32, k = _row_words(table2d, "table")
    # 64-bit rows: the same logical rows as twice the 128-word chunks
    return (t32.reshape(-1, _LANES), ch * k, vc * k, nrows, cap,
            masked and not flat, _index(idx, t32.device))


def _gather_out(out32, table2d, flat):
    out = out32.view(table2d.dtype)
    return out.reshape(-1, _LANES) if flat else out


def _gather_plain(t32, ch, vc, nrows, cap, masked, idx):
    idx = idx.to(torch.int64)
    safe = idx.clamp(0, nrows - 1)
    phys = (safe * ch)[:, None] + torch.arange(vc, device=t32.device)
    out = t32[phys.reshape(-1)].reshape(idx.shape[0], vc * _LANES)
    if masked:
        out = out.masked_fill(((idx < 0) | (idx >= cap))[:, None], 0)
    return out


def _gather_cuda(t32, ch, vc, nrows, cap, masked, idx, kernel=None):
    """Launch ``kernel`` (default :data:`ROW_GATHER`; the row sweep passes
    its rebuilt copies)."""
    n = idx.shape[0]
    out = torch.empty((n, vc * _LANES), dtype=torch.int32, device=t32.device)
    _check_aligned(t32, out)
    if n:
        (kernel or ROW_GATHER).launch(
            t32.device, t32.data_ptr(), nrows, ch, idx.data_ptr(), n, vc,
            cap, int(masked), out.data_ptr())
    return out


def gather_rows_2d(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                   cap: int | None = None, masked: bool = True,
                   flat: bool = False, vc: int | None = None):
    """Gather logical rows from the PHYSICAL ``[(C+1)*ch, 128]`` layout;
    returns ``[N, vc*128]`` in the table's dtype (``vc`` defaults to
    ``ch``: whole rows).

    ``ch`` is the row stride in 128-element chunks and ``vc`` how many of
    a row's leading chunks to copy (the JAX package reaches ``vc < ch`` by
    premultiplying the index, hashtable.py:657; here the stride is an
    argument). Indices are clamped to ``[0, C+1)``. ``cap`` is the LOGICAL
    capacity (default: every physical row); with ``masked``, rows whose
    index lies outside ``[0, cap)`` are zero, otherwise they carry the
    clamped row's data. ``flat=True`` returns the physical
    ``[N*vc, 128]`` block, unmasked. The table holds 32- or 64-bit
    elements (others raise ``TypeError``).

    CUDA tensors run the ``row_gather`` kernel; CPU tensors run
    :func:`gather_rows_2d_plain`."""
    t32, ch, vc, nrows, cap, masked, idx = _gather_args(
        table2d, ch, idx, cap, masked, flat, vc)
    impl = _gather_cuda if _is_cuda(t32) else _gather_plain
    return _gather_out(impl(t32, ch, vc, nrows, cap, masked, idx),
                       table2d, flat)


def gather_rows_2d_plain(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                         cap: int | None = None, masked: bool = True,
                         flat: bool = False, vc: int | None = None):
    """The plain PyTorch version of :func:`gather_rows_2d` (advanced
    indexing), on any device."""
    t32, ch, vc, nrows, cap, masked, idx = _gather_args(
        table2d, ch, idx, cap, masked, flat, vc)
    return _gather_out(_gather_plain(t32, ch, vc, nrows, cap, masked, idx),
                       table2d, flat)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for a logical ``[C, W]`` table of 32-bit words with
    ``W % 128 == 0``; out-of-range indices (< 0 or >= C, the drop
    sentinel) yield zero rows."""
    cap, w = table.shape
    ch = w // _LANES
    return gather_rows_2d(table.reshape(cap * ch, _LANES), ch, idx, cap=cap)


# ---------------------------------------------------------------------------
# row scatter (in place)
# ---------------------------------------------------------------------------


def _scatter_args(table2d, ch, idx, rows, cap):
    if table2d.dim() != 2 or table2d.shape[1] != _LANES:
        raise ValueError(f"table must be [rows, {_LANES}], got "
                         f"{tuple(table2d.shape)}")
    if rows.device != table2d.device:
        raise ValueError(f"rows on {rows.device}, table on {table2d.device}")
    nrows = table2d.shape[0] // ch
    cap = nrows - 1 if cap is None else cap
    if nrows <= cap:
        raise ValueError(
            "scatter_rows_set_2d requires a table with a trash row "
            "(physical rows > logical capacity)")
    t32, k = _row_words(table2d, "table")
    rows32, _ = _row_words(rows.to(table2d.dtype).reshape(-1, ch * _LANES)
                           .contiguous(), "rows")
    idx = _index(idx, t32.device)
    if rows32.shape[0] != idx.shape[0]:
        raise ValueError(f"{idx.shape[0]} indices for {rows32.shape[0]} rows")
    # 64-bit rows: the same logical rows as twice the 128-word chunks
    return t32.reshape(-1, _LANES), ch * k, cap, idx, rows32


def _scatter_plain(t32, ch, cap, idx, rows32):
    idx = idx.to(torch.int64)
    safe = torch.where((idx >= 0) & (idx < cap), idx, cap)
    phys = (safe * ch)[:, None] + torch.arange(ch, device=t32.device)
    t32[phys.reshape(-1)] = rows32.reshape(-1, _LANES)


def _scatter_cuda(t32, ch, cap, idx, rows32, kernel=None):
    """Launch ``kernel`` (default :data:`ROW_SCATTER`; the row sweep passes
    its rebuilt copies)."""
    _check_aligned(t32, rows32)
    n = idx.shape[0]
    if n:
        (kernel or ROW_SCATTER).launch(t32.device, t32.data_ptr(), cap, ch,
                                       idx.data_ptr(), n, rows32.data_ptr())


def scatter_rows_set_2d(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                        rows: torch.Tensor, cap: int | None = None):
    """Set logical rows of the PHYSICAL ``[(C+1)*ch, 128]`` layout IN
    PLACE and return ``table2d`` itself (the JAX version aliases the table
    to its output). ``rows`` is ``[N, ch*128]``; ``cap`` the logical
    capacity (default: all rows but the trailing trash row block). The
    table MUST carry the trash row, whose contents are unspecified: rows
    with invalid and sentinel indices belong to it, the plain version
    writes them there, the kernel does no work for them and leaves it as
    it is. Valid indices must be unique. The table holds 32- or 64-bit
    elements.

    CUDA tensors run the ``row_scatter`` kernel; CPU tensors run
    :func:`scatter_rows_set_2d_plain`."""
    t32, ch, cap, idx, rows32 = _scatter_args(table2d, ch, idx, rows, cap)
    impl = _scatter_cuda if _is_cuda(t32) else _scatter_plain
    impl(t32, ch, cap, idx, rows32)
    return table2d


def scatter_rows_set_2d_plain(table2d: torch.Tensor, ch: int,
                              idx: torch.Tensor, rows: torch.Tensor,
                              cap: int | None = None):
    """The plain PyTorch version of :func:`scatter_rows_set_2d` (an
    indexed assignment), on any device; also in place."""
    t32, ch, cap, idx, rows32 = _scatter_args(table2d, ch, idx, rows, cap)
    _scatter_plain(t32, ch, cap, idx, rows32)
    return table2d


def scatter_rows_set(table: torch.Tensor, idx: torch.Tensor,
                     rows: torch.Tensor) -> torch.Tensor:
    """``table[idx] = rows`` on a logical ``[C, W]`` table of 32-bit words
    (``W % 128 == 0``), returned as a NEW table: a copy with a transient
    trash row is written and sliced back. Valid indices must be unique;
    out-of-range indices (the drop sentinel) are skipped."""
    cap, w = table.shape
    ch = w // _LANES
    padded = torch.cat([table.reshape(cap * ch, _LANES),
                        table.new_zeros((ch, _LANES))])
    scatter_rows_set_2d(padded, ch, idx, rows, cap=cap)
    return padded[: cap * ch].reshape(cap, w)


# ---------------------------------------------------------------------------
# fused optimizer update + row scatter (in place)
# ---------------------------------------------------------------------------

# the kernel's Rule enum (csrc/fused_update_scatter.cu), by optimizer kind
_RULES = {"sgd": 0, "momentum": 1, "adagrad": 2, "adam": 3, "adamw": 4,
          "rmsprop": 5, "ftrl": 6}
_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True, eq=False)
class FusedRule:
    """The row update :func:`fused_update_scatter` applies.

    ``kind`` names the optimizer (a key of the kernel's rule table),
    ``hparams`` are its hyper-parameters in the kernel's order (see
    ``update`` in the source), ``slots`` its slot names in its own order
    (at most two), and ``update(rows, grads, slots, step)`` is the
    optimizer's own update in torch ops, which the plain version runs on
    the same tile."""

    kind: str
    hparams: Tuple[float, ...]
    slots: Tuple[str, ...]
    update: Callable


def _fused_args(table2d, ch, idx, packed, grads, rule, dim, slot_names, cap,
                pf):
    if table2d.dim() != 2 or table2d.shape[1] != _LANES:
        raise ValueError(f"table must be [rows, {_LANES}], got "
                         f"{tuple(table2d.shape)}")
    if rule.kind not in _RULES or len(rule.slots) > 2 or len(rule.hparams) > 8:
        raise ValueError(f"no fused kernel rule for {rule.kind!r}")
    if not set(rule.slots) <= set(slot_names):
        raise ValueError(f"table slots {slot_names} lack {rule.slots}")
    if pf not in (1, 2) or dim % pf or dim * (1 + len(slot_names)) > (
            ch * _LANES * pf):
        raise ValueError(f"dim {dim} with {len(slot_names)} slots does not "
                         f"fit a pf={pf}, ch={ch} row")
    if table2d.shape[0] // ch <= cap:
        raise ValueError("the table needs its trash row")
    t32 = _words(table2d, "table")
    idx = _index(idx, t32.device)
    n = idx.shape[0]
    pk = _words(packed.reshape(n, ch * _LANES).contiguous(), "packed")
    if grads.dtype != torch.float32 or tuple(grads.shape) != (n, dim):
        raise ValueError(f"grads must be [{n}, {dim}] float32, got "
                         f"{tuple(grads.shape)} {grads.dtype}")
    for t in (pk, grads):
        if t.device != t32.device:
            raise ValueError(f"operand on {t.device}, table on {t32.device}")
    return t32, idx, pk.view(torch.float32), grads.contiguous()


def _planes(words: torch.Tensor):
    """bf16 pairs in 32-bit words -> (even, odd) f32 planes, exactly."""
    bits = words.view(torch.int32).to(torch.int64) & _M32
    even = _wrap32((bits << 16) & _M32).view(torch.float32)
    odd = _wrap32(bits & 0xFFFF0000).view(torch.float32)
    return even, odd


def _repack(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """(even, odd) f32 planes -> bf16 pairs in f32 words, each half
    rounded to nearest even."""
    def rne(x):
        b = x.contiguous().view(torch.int32).to(torch.int64) & _M32
        return (b + 0x7FFF + ((b >> 16) & 1)) & _M32

    word = (rne(odd) & 0xFFFF0000) | (rne(even) >> 16)
    return _wrap32(word).view(torch.float32)


def fused_update_tile(packed, grads, rule, dim, slot_names, step, pf):
    """The plain version's tile math: ``[N, ch*128]`` packed words and
    ``[N, dim]`` f32 grads -> the new ``[N, ch*128]`` rows (value, every
    slot column, zero padding), as ``optimizer._fused_rows_pf1``/``_pf2``
    compute them."""
    n, wc = packed.shape
    names = tuple(slot_names)
    step2d = torch.full((1, 1), float(step), dtype=torch.float32,
                        device=packed.device)

    def plane(src, rows, g):
        d = rows.shape[1]
        slots = {nm: src[:, d * (1 + i):d * (2 + i)]
                 for i, nm in enumerate(names)}
        new_rows, new_slots = rule.update(rows, g, slots, step2d)
        parts = [new_rows] + [new_slots.get(nm, slots[nm]) for nm in names]
        full = torch.cat([x.to(torch.float32) for x in parts], dim=1)
        return torch.nn.functional.pad(full, (0, wc - full.shape[1]))

    if pf == 1:
        return plane(packed, packed[:, :dim], grads)
    half = dim // 2
    even, odd = _planes(packed)
    return _repack(plane(even, even[:, :half], grads[:, 0::2]),
                   plane(odd, odd[:, :half], grads[:, 1::2]))


def _fused_plain(t32, ch, cap, idx, packed, grads, rule, dim, slot_names,
                 step, pf):
    new = fused_update_tile(packed, grads, rule, dim, slot_names, step, pf)
    _scatter_plain(t32, ch, cap, idx, new.view(torch.int32))


def _fused_cuda(t32, ch, cap, idx, packed, grads, rule, dim, slot_names,
                step, pf, kernel=None):
    """Launch ``kernel`` (default :data:`FUSED_UPDATE_SCATTER`; the ring
    sweep passes its rebuilt copies)."""
    _check_aligned(t32, packed)
    n = idx.shape[0]
    if not n:
        return
    pos = [slot_names.index(nm) for nm in rule.slots] + [-1, -1]
    hp = [float(h) for h in rule.hparams] + [0.0] * (8 - len(rule.hparams))
    (kernel or FUSED_UPDATE_SCATTER).launch(
        t32.device, t32.data_ptr(), cap, ch, idx.data_ptr(), n,
        packed.data_ptr(), grads.data_ptr(), dim, len(slot_names), pf,
        _RULES[rule.kind], pos[0], pos[1], float(step), *hp)


def fused_update_scatter(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                         packed: torch.Tensor, grads: torch.Tensor,
                         rule: FusedRule, *, dim: int, slot_names,
                         cap: int, step: float = 0.0, pf: int = 1):
    """Apply ``rule`` to each batch row and write the whole new row into
    the PHYSICAL ``[(C+1)*ch, 128]`` table IN PLACE, at ``idx`` where
    ``0 <= idx < cap``. Returns ``table2d``. Rows with any other index
    belong to the trash row at ``cap``, whose contents are unspecified:
    the plain version writes their updates there, the kernel does no work
    for them and leaves it as it is.

    ``packed`` is the lookup's ``[N, ch*128]`` block of 32-bit words (or
    the same bytes as ``[N*ch, 128]``): ``[value | slot columns | pad]``
    in f32 (``pf=1``) or as bf16 pairs (``pf=2``); ``grads`` ``[N, dim]``
    f32; ``slot_names`` the table's sorted slot columns. The table's other
    slot columns pass through, the padding is written as zeros. Valid
    indices must be unique; ``packed`` must not alias the table. On the
    card, the table and ``packed`` must start on a 16-byte boundary.

    CUDA tensors run the ``fused_update_scatter`` kernel; CPU tensors run
    :func:`fused_update_scatter_plain`."""
    slot_names = tuple(slot_names)
    t32, idx, pk, g = _fused_args(table2d, ch, idx, packed, grads, rule, dim,
                                  slot_names, cap, pf)
    impl = _fused_cuda if _is_cuda(t32) else _fused_plain
    impl(t32, ch, cap, idx, pk, g, rule, dim, slot_names, step, pf)
    return table2d


def fused_update_scatter_plain(table2d: torch.Tensor, ch: int,
                               idx: torch.Tensor, packed: torch.Tensor,
                               grads: torch.Tensor, rule: FusedRule, *,
                               dim: int, slot_names, cap: int,
                               step: float = 0.0, pf: int = 1):
    """The plain PyTorch version of :func:`fused_update_scatter`: the
    tile math (:func:`fused_update_tile`) then the plain row scatter, on
    any device; also in place."""
    slot_names = tuple(slot_names)
    t32, idx, pk, g = _fused_args(table2d, ch, idx, packed, grads, rule, dim,
                                  slot_names, cap, pf)
    _fused_plain(t32, ch, cap, idx, pk, g, rule, dim, slot_names, step, pf)
    return table2d
