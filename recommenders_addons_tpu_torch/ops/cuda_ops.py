"""Hand-written CUDA kernels for the dynamic-embedding hot path — the
port's counterpart of the JAX package's ``ops/pallas_ops.py``.

Two kernels, both CUDA C++ for Hopper (``sm_90a``) under ``csrc/``:

* ``row_gather`` (``csrc/row_gather.cu``) replaces the Pallas
  ``_gather_kernel`` (pallas_ops.py:165) behind :func:`gather_rows_2d`;
* ``row_scatter`` (``csrc/row_scatter.cu``) replaces the Pallas
  ``_scatter_kernel`` (pallas_ops.py:192) behind
  :func:`scatter_rows_set_2d`.

Both are pure indexed data movement, so both are bound by bytes: the
sources say what their design does about that. Tables keep the JAX
package's physical layout, a ``[(C+1)*ch, 128]`` container of 32-bit words
with a trash row block at logical index ``C``; the kernels move the words
through an int32 view, so f16/bf16 pairs whose bits read as NaNs pass
untouched.

Dispatch has one rule: a CUDA tensor goes to the kernel, a CPU tensor to
the plain PyTorch version beside it (``*_plain``), which the CPU tests run
and ``chip_smoke.py`` holds each kernel against on the card. There is no
fallback: a kernel that does not build or launch raises.

Kernels are compiled with ``nvcc`` into ``build/torch_kernels/`` beside the
package, at first use (or all at once, in parallel, by
:func:`build_kernels`), into shared libraries with a plain C interface
that ``ctypes`` loads; the library name carries a hash of its source, so
an edited source is rebuilt. Each kernel counts its launches
(``ROW_GATHER.launches``, ``ROW_SCATTER.launches``), so a run can show that
its path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_LANES = 128
_PKG = Path(__file__).resolve().parent.parent
_BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC")
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
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
        digest = hashlib.sha1(self.source.read_bytes()).hexdigest()[:12]
        return _BUILD_DIR / f"lib{self.name}-{digest}.so"

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
KERNELS = (ROW_GATHER, ROW_SCATTER)


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
    t32 = _words(table2d, "table")
    return t32, vc, nrows, cap, masked and not flat, _index(idx, t32.device)


def _gather_out(out32, table2d, vc, flat):
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


def _gather_cuda(t32, ch, vc, nrows, cap, masked, idx):
    n = idx.shape[0]
    out = torch.empty((n, vc * _LANES), dtype=torch.int32, device=t32.device)
    _check_aligned(t32, out)
    if n:
        ROW_GATHER.launch(t32.device, t32.data_ptr(), nrows, ch,
                          idx.data_ptr(), n, vc, cap, int(masked),
                          out.data_ptr())
    return out


def gather_rows_2d(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                   cap: int | None = None, masked: bool = True,
                   flat: bool = False, vc: int | None = None):
    """Gather logical rows from the PHYSICAL ``[(C+1)*ch, 128]`` layout;
    returns ``[N, vc*128]`` in the table's dtype (``vc`` defaults to
    ``ch``: whole rows).

    ``ch`` is the row stride in 128-word chunks and ``vc`` how many of a
    row's leading chunks to copy (the JAX package reaches ``vc < ch`` by
    premultiplying the index, hashtable.py:657; here the stride is an
    argument). Indices are clamped to ``[0, C+1)``. ``cap`` is the LOGICAL
    capacity (default: every physical row); with ``masked``, rows whose
    index lies outside ``[0, cap)`` are zero, otherwise they carry the
    clamped row's data. ``flat=True`` returns the physical
    ``[N*vc, 128]`` block, unmasked.

    CUDA tensors run the ``row_gather`` kernel; CPU tensors run
    :func:`gather_rows_2d_plain`."""
    t32, vc, nrows, cap, masked, idx = _gather_args(
        table2d, ch, idx, cap, masked, flat, vc)
    impl = _gather_cuda if _is_cuda(t32) else _gather_plain
    return _gather_out(impl(t32, ch, vc, nrows, cap, masked, idx),
                       table2d, vc, flat)


def gather_rows_2d_plain(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                         cap: int | None = None, masked: bool = True,
                         flat: bool = False, vc: int | None = None):
    """The plain PyTorch version of :func:`gather_rows_2d` (advanced
    indexing), on any device."""
    t32, vc, nrows, cap, masked, idx = _gather_args(
        table2d, ch, idx, cap, masked, flat, vc)
    return _gather_out(_gather_plain(t32, ch, vc, nrows, cap, masked, idx),
                       table2d, vc, flat)


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
    t32 = _words(table2d, "table")
    rows32 = _words(rows.to(table2d.dtype).reshape(-1, ch * _LANES)
                    .contiguous(), "rows")
    idx = _index(idx, t32.device)
    if rows32.shape[0] != idx.shape[0]:
        raise ValueError(f"{idx.shape[0]} indices for {rows32.shape[0]} rows")
    return t32, cap, idx, rows32


def _scatter_plain(t32, ch, cap, idx, rows32):
    idx = idx.to(torch.int64)
    safe = torch.where((idx >= 0) & (idx < cap), idx, cap)
    phys = (safe * ch)[:, None] + torch.arange(ch, device=t32.device)
    t32[phys.reshape(-1)] = rows32.reshape(-1, _LANES)


def _scatter_cuda(t32, ch, cap, idx, rows32):
    _check_aligned(t32, rows32)
    n = idx.shape[0]
    if n:
        ROW_SCATTER.launch(t32.device, t32.data_ptr(), cap, ch,
                           idx.data_ptr(), n, rows32.data_ptr())


def scatter_rows_set_2d(table2d: torch.Tensor, ch: int, idx: torch.Tensor,
                        rows: torch.Tensor, cap: int | None = None):
    """Set logical rows of the PHYSICAL ``[(C+1)*ch, 128]`` layout IN
    PLACE and return ``table2d`` itself (the JAX version aliases the table
    to its output). ``rows`` is ``[N, ch*128]``; ``cap`` the logical
    capacity (default: all rows but the trailing trash row block). The
    table MUST carry the trash row: invalid and sentinel indices are
    redirected to it, and its contents are then unspecified. Valid indices
    must be unique.

    CUDA tensors run the ``row_scatter`` kernel; CPU tensors run
    :func:`scatter_rows_set_2d_plain`."""
    t32, cap, idx, rows32 = _scatter_args(table2d, ch, idx, rows, cap)
    impl = _scatter_cuda if _is_cuda(t32) else _scatter_plain
    impl(t32, ch, cap, idx, rows32)
    return table2d


def scatter_rows_set_2d_plain(table2d: torch.Tensor, ch: int,
                              idx: torch.Tensor, rows: torch.Tensor,
                              cap: int | None = None):
    """The plain PyTorch version of :func:`scatter_rows_set_2d` (an
    indexed assignment), on any device; also in place."""
    t32, cap, idx, rows32 = _scatter_args(table2d, ch, idx, rows, cap)
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
