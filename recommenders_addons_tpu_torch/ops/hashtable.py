"""Dynamic-embedding hashtable — the port of the JAX package's
``ops/hashtable.py``: the set-associative, score-evicting bucket table,
in PyTorch, with the row gather and row scatter on the CUDA kernels of
``ops/cuda_ops.py``.

The design and the layout are the JAX package's (see its module
docstring): a key hashes to ONE bucket of ``bucket_size`` slots; a batch
insert ranks its keys within their buckets so that every write goes to a
distinct slot (a match, a free slot, or the lowest-score victim); the
value and any optimizer-slot columns of a key live in one packed row of a
``[(C+1)*ch, 128]`` container, whose last row block (at logical index
``C``) is the trash row that dropped writes land on. The container holds
32-bit words (16- and 8-bit values packed into them), or the value dtype
itself for f64, int64 and bool tables; the row kernels move 32- and
64-bit containers, bool rows move by torch indexing (``_byte_rows``).
Keys are stored as two int32 planes, scores as int32.

Functions keep the JAX names and the state-in -> state-out signatures.
One difference: the row scatter writes ``state.rows`` IN PLACE (the JAX
kernel aliases the table to its output), so the state a write is given
shares its rows tensor with the state it returns. Key and score planes
are written out of place.

Ported: the serving path (probe, value gather, bulk upsert with eviction,
dedup, export), the training plan (``plan_lookup_train`` with its
``plan_lookup`` miss branch and its deferred-dedup hit branch,
``plan_lookup_fast``, the duplicate probes, the packed-row layout
helpers, slot columns, the key/score commits of the fused apply, the
grad combines ``segment_sum_rows`` and ``sorted_combine_batch``), and the
rest of the write surface: commits with ``deltas`` (bp_v2) and
``return_evicted``, ``accum``, ``dedup_sum``, ``scatter_packed``,
``scatter_rows``, ``remove`` and ``clear``; and score eviction
(``export_with_scores``, the radix select ``radix_select_threshold``,
``lowest_k_indices``, ``evict_lowest``). Where the JAX package
branches with ``lax.cond``, the port branches in Python on a value read
back from the device (a host sync); each such read is marked
``# host sync``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops, hashing
from recommenders_addons_tpu_torch.utils.config import resolve_device

_LANES = 128
_INT32_MIN = -(1 << 31)
_INT64_MIN = -(1 << 63)


def torch_dtype(dt) -> torch.dtype:
    """A torch dtype from a torch dtype, a dtype name, or a numpy dtype."""
    if isinstance(dt, torch.dtype):
        return dt
    name = dt if isinstance(dt, str) else np.dtype(dt).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"unknown dtype {dt!r}")
    return out


def dtype_name(dt) -> str:
    """The name the JAX package records for a dtype (``"bfloat16"``)."""
    return str(torch_dtype(dt)).rsplit(".", 1)[-1]


def np_dtype(dt) -> np.dtype:
    """The numpy dtype the host holds ``dt`` as: 16-bit floats as int16
    words (numpy has no bfloat16; the bytes are the same)."""
    dt = torch_dtype(dt)
    if dt in (torch.bfloat16, torch.float16):
        return np.dtype(np.int16)
    return np.dtype(dtype_name(dt))


def host_words(t: torch.Tensor) -> np.ndarray:
    """A CPU copy of ``t`` as numpy, 16-bit floats as their int16 words."""
    t = t.contiguous()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.view(torch.int16)
    return t.cpu().numpy()


def from_words(a: np.ndarray, dt) -> torch.Tensor:
    """The reverse of :func:`host_words`: a CPU tensor of dtype ``dt``."""
    dt = torch_dtype(dt)
    t = torch.from_numpy(np.ascontiguousarray(a))
    if dt in (torch.bfloat16, torch.float16) and t.dtype == torch.int16:
        return t.view(dt)
    return t.to(dt)


def where_or_zero(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` where ``mask``, else zeros of ``x``'s own dtype (a Python 0
    would promote bool rows to int64)."""
    return torch.where(mask, x, x.new_zeros(()))


def _round_up_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _score_max(dtype) -> int:
    return torch.iinfo(dtype).max


def split_key(k64: torch.Tensor):
    """int64 keys -> (lo, hi) int32 planes (the low and high 32 bits)."""
    k = k64.to(torch.int64)
    lo = hashing._wrap32(k & 0xFFFFFFFF)
    hi = (k >> 32).to(torch.int32)  # arithmetic shift: exactly int32 range
    return lo, hi


def _split_int(k: int):
    """:func:`split_key` of one Python int."""
    lo = k & 0xFFFFFFFF
    return (lo - (1 << 32) if lo >= 1 << 31 else lo), k >> 32


def join_key(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(lo, hi) int32 planes -> int64 keys."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) & 0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """Static configuration of one table (hashable). Capacity is rounded
    up to a power of two; dtypes are normalized to torch dtypes."""

    dim: int
    capacity: int = 1024 * 1024
    key_dtype: Any = torch.int64
    value_dtype: Any = torch.float32
    score_dtype: Any = torch.int32
    bucket_size: int = 64

    def __post_init__(self):
        if self.bucket_size & (self.bucket_size - 1):
            raise ValueError("bucket_size must be a power of two")
        cap = _round_up_pow2(max(int(self.capacity), self.bucket_size))
        object.__setattr__(self, "capacity", cap)
        for f in ("key_dtype", "value_dtype", "score_dtype"):
            object.__setattr__(self, f, torch_dtype(getattr(self, f)))

    @property
    def num_buckets(self) -> int:
        return self.capacity // self.bucket_size

    @property
    def empty_key(self) -> int:
        return hashing.empty_key_for(self.key_dtype)


@dataclasses.dataclass
class TableState:
    """One table's storage (see the module docstring for the layout).

    ``rows[:, :dim]`` of the logical view is the embedding; slot ``i`` (by
    ``slot_names`` order) occupies ``[dim*(1+i), dim*(2+i))``; the tail up
    to the 128-word padded width is unused."""

    key_lo: torch.Tensor  # [C] int32 (low 32 bits; EMPTY -> 0)
    key_hi: torch.Tensor  # [C] int32 (high 32 bits; EMPTY -> int32 min)
    rows: torch.Tensor  # [(C+1) * ch, 128] 32-bit container (physical)
    scores: torch.Tensor  # [C] score dtype (eviction priority)
    dim: int = 0
    slot_names: tuple = ()
    slot_inits: tuple = ()  # ((name, fresh-row fill), ...)
    key_dtype_name: str = "int64"
    value_dtype_name: str = "float32"

    @property
    def capacity(self) -> int:
        return self.key_lo.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.key_lo.device

    @property
    def keys(self) -> torch.Tensor:
        """[C] int64 (or key dtype) view of the stored keys."""
        k = join_key(self.key_lo, self.key_hi)
        if self.key_dtype_name != "int64":
            k = k.to(torch_dtype(self.key_dtype_name))
        return k

    @property
    def value_dtype(self) -> torch.dtype:
        return torch_dtype(self.value_dtype_name)

    @property
    def width(self) -> int:
        """Logical packed-row width in VALUE elements."""
        return _packed_width(self.dim, len(self.slot_names),
                             self.value_dtype)

    @property
    def chunks(self) -> int:
        """Physical 128-word container rows per logical row."""
        return self.width // (_LANES * _pack_factor(self.value_dtype))

    @property
    def rows_logical(self) -> torch.Tensor:
        """[C, W] logical view of the physical rows (trash row excluded;
        bitcast for sub-32-bit value dtypes)."""
        return _to_logical_rows(self.rows, self.value_dtype,
                                self.capacity, self.width)

    @property
    def values(self) -> torch.Tensor:
        """[C, dim] view of the embedding columns."""
        return self.rows_logical[..., : self.dim]

    @property
    def slots(self) -> Dict[str, torch.Tensor]:
        """{name: [C, dim]} views of the optimizer slot columns."""
        d = self.dim
        rl = self.rows_logical
        return {
            name: rl[..., d * (1 + i): d * (2 + i)]
            for i, name in enumerate(self.slot_names)
        }

    def slot_init(self, name: str) -> float:
        return dict(self.slot_inits).get(name, 0.0)

    def slot_offset(self, name: str) -> int:
        return self.dim * (1 + self.slot_names.index(name))

    def replace(self, **kw) -> "TableState":
        return dataclasses.replace(self, **kw)


def _container_dtype(value_dtype) -> torch.dtype:
    """Physical storage dtype: a 32-bit container for 16- and 8-bit
    values (bitcast-packed), else the value dtype itself (f32, int32,
    f64, int64, bool), as in the JAX package."""
    dt = torch_dtype(value_dtype)
    if dt.itemsize == 2:
        return torch.float32
    if dt == torch.int8:
        return torch.int32
    return dt


def _pack_factor(value_dtype) -> int:
    """Logical values per physical container element."""
    dt = torch_dtype(value_dtype)
    return _container_dtype(dt).itemsize // dt.itemsize


def _packed_width(dim: int, n_slots: int, value_dtype=torch.float32) -> int:
    pf = _pack_factor(value_dtype)
    w = dim * (1 + n_slots)
    return (w + _LANES * pf - 1) // (_LANES * pf) * (_LANES * pf)


def _to_logical_rows(rows_phys: torch.Tensor, value_dtype, n_rows: int,
                     width: int) -> torch.Tensor:
    """[..., >=n*ch, 128] physical container -> [..., n, W] logical values
    (extra physical rows — the trash row block — are sliced off)."""
    dt = torch_dtype(value_dtype)
    lead = tuple(rows_phys.shape[:-2])
    lanes_rows = n_rows * (width // (_LANES * _pack_factor(dt)))
    rows_phys = rows_phys[..., :lanes_rows, :]
    if rows_phys.dtype != dt:
        rows_phys = rows_phys.view(dt)  # little-endian: low half first
    return rows_phys.reshape(lead + (n_rows, width))


def _to_physical_rows(rows_logical: torch.Tensor, container_dtype,
                      lanes_rows: int, trash_row: bool = False):
    """[..., n, W] logical -> [..., n*ch (+ch), 128] physical container.
    ``trash_row=True`` appends the zeroed trash row block."""
    lead = tuple(rows_logical.shape[:-2])
    x = rows_logical.contiguous()
    if x.dtype != container_dtype:
        x = x.view(container_dtype)
    phys = x.reshape(lead + (lanes_rows, _LANES))
    if trash_row:
        ch = lanes_rows // max(rows_logical.shape[-2], 1)
        phys = torch.cat([phys, phys.new_zeros(lead + (ch, _LANES))], dim=-2)
    return phys


def create(spec: TableSpec, device=None) -> TableState:
    """Fresh empty table on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    e_lo, e_hi = _split_int(spec.empty_key)
    vdt = spec.value_dtype
    ch = _packed_width(spec.dim, 0, vdt) // (_LANES * _pack_factor(vdt))
    return TableState(
        key_lo=torch.full((spec.capacity,), e_lo, dtype=torch.int32,
                          device=dev),
        key_hi=torch.full((spec.capacity,), e_hi, dtype=torch.int32,
                          device=dev),
        rows=torch.zeros(((spec.capacity + 1) * ch, _LANES),  # +1: trash
                         dtype=_container_dtype(vdt), device=dev),
        scores=torch.zeros((spec.capacity,), dtype=spec.score_dtype,
                           device=dev),
        dim=spec.dim,
        key_dtype_name=dtype_name(spec.key_dtype),
        value_dtype_name=dtype_name(vdt),
    )


def _fill_word(value: float, value_dtype, container_dtype) -> torch.Tensor:
    """One container word holding ``value`` in each of its packed lanes."""
    pf = _pack_factor(value_dtype)
    return torch.full((pf,), value, dtype=value_dtype).view(
        container_dtype)[0]


def with_slot(state: TableState, name: str,
              init: float = 0.0) -> TableState:
    """Add an optimizer slot column block (slot names stay sorted, so a
    block's position is its name's rank). Rebuilds ``rows`` into a new,
    wider container; the old one is left as it was."""
    if name in state.slot_names:
        return state
    names = tuple(sorted(state.slot_names + (name,)))
    inits = dict(state.slot_inits)
    inits[name] = float(init)
    d = state.dim
    vdt = state.value_dtype
    cdt = state.rows.dtype
    pf = _pack_factor(vdt)
    cap = state.capacity
    new_w = _packed_width(d, len(names), vdt)
    new_ch = new_w // (_LANES * pf)
    out = torch.zeros(((cap + 1) * new_ch, _LANES), dtype=cdt,
                      device=state.device)  # the trash row stays zero
    if pf > 1 and d % pf == 0:
        # container-word space: column blocks map 1:1 onto word blocks
        d, w_old, w_new = d // pf, state.chunks * _LANES, new_ch * _LANES
        src = state.rows[: cap * state.chunks].reshape(cap, w_old)
        dst = out[: cap * new_ch].view(cap, w_new)
        fill = {n: _fill_word(inits[n], vdt, cdt) for n in names}
    else:
        src = state.rows_logical
        dst = _to_logical_rows(out, vdt, cap, new_w)
        fill = {n: inits[n] for n in names}
    dst[:, :d] = src[:, :d]
    for j, n in enumerate(names):
        new_off = d * (1 + j)
        if n in state.slot_names:
            off = d * (1 + state.slot_names.index(n))
            dst[:, new_off:new_off + d] = src[:, off:off + d]
        else:
            dst[:, new_off:new_off + d] = fill[n]
    return state.replace(rows=out, slot_names=names,
                         slot_inits=tuple(sorted(inits.items())))


# ---------------------------------------------------------------------------
# probing
# ---------------------------------------------------------------------------


def take_elem(vec: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``vec[idx]`` (the JAX package's row-gather reformulation is a TPU
    layout trick; here it is plain indexing). ``idx`` must be in range."""
    return vec[idx.long()]


def _argmax_first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis (0 when none), int32."""
    return mask.to(torch.uint8).argmax(dim=-1).to(torch.int32)


def _set_drop(vec: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """``vec.at[idx].set(vals, mode="drop")`` for ``idx`` in ``[0, C]``
    (``C`` = the drop sentinel), out of place: writes into a ``[C+1]``
    copy and slices. Indices below ``C`` must be unique."""
    buf = torch.cat([vec, vec.new_zeros(1)])
    buf[idx.long()] = vals.to(vec.dtype)
    return buf[:-1]


def _bucket_of(spec: TableSpec, keys: torch.Tensor):
    """Return ([N] bucket id, [N] bucket base slot), int32."""
    b = hashing.bucket_of(keys, spec.num_buckets)
    return b, b * spec.bucket_size


def _bucket_gather(spec: TableSpec, flat: torch.Tensor,
                   bucket: torch.Tensor) -> torch.Tensor:
    """Each key's whole bucket from a flat [C]-shaped column: [N, B]."""
    return flat.view(spec.num_buckets, spec.bucket_size)[bucket.long()]


def find(spec: TableSpec, state: TableState, keys: torch.Tensor):
    """Vectorized probe. Returns ``(slot [N] int32, found [N] bool)``;
    ``slot`` is 0 where not found. EMPTY-sentinel keys are never found."""
    bucket, base = _bucket_of(spec, keys)
    lo, hi = split_key(keys)
    cl = _bucket_gather(spec, state.key_lo, bucket)  # [N, B] int32
    chi = _bucket_gather(spec, state.key_hi, bucket)
    match = (cl == lo[:, None]) & (chi == hi[:, None])
    found = match.any(dim=-1) & (keys != spec.empty_key)
    slot = base + _argmax_first(match)
    return torch.where(found, slot, 0), found


def _byte_rows(rows: torch.Tensor) -> bool:
    """Whether a container holds 1-byte elements (bool tables): a chunk of
    such a row is 128 B, which no 128-word kernel row can hold, so its
    rows move by torch indexing, as the JAX package moves them with XLA
    (its Pallas kernels take 32-bit containers only). Every other
    container goes through the row kernels."""
    return rows.element_size() == 1


def _move_rows_gather(rows: torch.Tensor, ch: int, idx: torch.Tensor,
                      vc: Optional[int] = None,
                      flat: bool = False) -> torch.Tensor:
    """Unmasked row gather of ``vc`` (default ``ch``) leading chunks at
    ``idx`` (clamped to the table): ``[N, vc*128]``, or ``[N*vc, 128]``
    with ``flat``. The row-gather kernel, but for 1-byte containers
    (:func:`_byte_rows`)."""
    if not _byte_rows(rows):
        return cuda_ops.gather_rows_2d(rows, ch, idx, masked=False,
                                       flat=flat, vc=vc)
    vc = ch if vc is None else vc
    safe = idx.to(torch.int64).clamp(0, rows.shape[0] // ch - 1)
    phys = (safe * ch)[:, None] + torch.arange(vc, device=rows.device)
    out = rows[phys.reshape(-1)]
    return out if flat else out.reshape(idx.shape[0], vc * _LANES)


def _move_rows_scatter(rows: torch.Tensor, ch: int, idx: torch.Tensor,
                       new: torch.Tensor, cap: int) -> torch.Tensor:
    """Row scatter of ``new`` ``[N*ch, 128]`` at ``idx`` into the table IN
    PLACE, indices outside ``[0, cap)`` to the trash row. The row-scatter
    kernel, but for 1-byte containers (:func:`_byte_rows`)."""
    if not _byte_rows(rows):
        return cuda_ops.scatter_rows_set_2d(rows, ch, idx, new, cap=cap)
    idx = idx.to(torch.int64)
    safe = torch.where((idx >= 0) & (idx < cap), idx, cap)
    phys = (safe * ch)[:, None] + torch.arange(ch, device=rows.device)
    rows[phys.reshape(-1)] = new.reshape(-1, _LANES).to(rows.dtype)
    return rows


def gather_packed(state: TableState, slot: torch.Tensor,
                  found: torch.Tensor) -> torch.Tensor:
    """Packed logical [N, W] rows at ``slot`` through the row-gather
    kernel. Rows where ``found`` is False carry the trash row (unmasked)."""
    idx = torch.where(found, slot, state.capacity)  # sentinel -> trash row
    n = idx.shape[0]
    phys = _move_rows_gather(state.rows, state.chunks, idx, flat=True)
    return _to_logical_rows(phys, state.value_dtype, n, state.width)


def gather_packed_phys(state: TableState, slot: torch.Tensor,
                       found: torch.Tensor) -> torch.Tensor:
    """Packed rows at ``slot`` in the PHYSICAL container layout
    ``[N*ch, 128]`` (no relayout to the logical view)."""
    idx = torch.where(found, slot, state.capacity)  # sentinel -> trash row
    return _move_rows_gather(state.rows, state.chunks, idx, flat=True)


def packed_is_phys(state: TableState, n: int, packed: torch.Tensor) -> bool:
    """True when a ctx packed block is in the PHYSICAL ``[N*ch, 128]``
    container layout (vs the logical ``[N, W]`` view). Where the two
    coincide (ch == 1, pf == 1) either reading is the same bytes."""
    return (packed.dim() == 2 and packed.dtype == state.rows.dtype
            and packed.shape[0] == n * state.chunks
            and packed.shape[1] == _LANES)


def packed_logical_view(state: TableState, n: int,
                        packed: torch.Tensor) -> torch.Tensor:
    """[N, W] logical view of a ctx packed block in either layout."""
    if packed_is_phys(state, n, packed):
        return _to_logical_rows(packed, state.value_dtype, n, state.width)
    return packed


def packed_value_rows(state: TableState, n: int,
                      packed: torch.Tensor) -> torch.Tensor:
    """[N, dim] value columns of a ctx packed block in either layout (for
    the physical one, a slice of each row's first chunk)."""
    d = state.dim
    if not packed_is_phys(state, n, packed):
        return packed[:, :d]
    pf = _pack_factor(state.value_dtype)
    if d % pf or d // pf > _LANES:
        return packed_logical_view(state, n, packed)[:, :d]
    dc = d // pf
    col = packed.reshape(n, state.chunks, _LANES)[:, 0, :dc]
    if pf == 1:
        return col
    return col.contiguous().view(state.value_dtype)


def reset_inserted_slots(state: TableState, n: int, packed: torch.Tensor,
                         inserted: torch.Tensor) -> torch.Tensor:
    """Set a ctx packed block's SLOT columns to their fresh fills on
    ``inserted`` rows (their gathered data is the trash row or a victim's
    stale state), in either layout; the fused apply then reads slot state
    verbatim. Writes ``packed`` in place (the lookup's own buffer) and
    returns it in its layout."""
    if not state.slot_names:
        return packed
    d = state.dim
    vdt = state.value_dtype
    if packed_is_phys(state, n, packed):
        pf = _pack_factor(vdt)
        dw = d // pf
        view = packed.reshape(n, state.chunks * _LANES)
        fresh = torch.zeros(view.shape[1] - dw, dtype=packed.dtype,
                            device=packed.device)
        for i, nm in enumerate(state.slot_names):
            off = dw * (1 + i) - dw
            fresh[off:off + dw] = _fill_word(state.slot_init(nm), vdt,
                                             packed.dtype)
        view[:, dw:] = torch.where(inserted[:, None], fresh, view[:, dw:])
        return view.reshape(n * state.chunks, _LANES)
    fresh = torch.zeros(state.width - d, dtype=vdt, device=packed.device)
    for i, nm in enumerate(state.slot_names):
        fresh[d * i:d * (i + 1)] = state.slot_init(nm)
    packed[:, d:] = torch.where(inserted[:, None], fresh, packed[:, d:])
    return packed


def phys_packed_ok(state: TableState) -> bool:
    """Whether ``plan_lookup_train`` carries its packed gather in the
    PHYSICAL layout: for 16-bit values whose value columns fit in each
    row's first chunk, the container words feed the bf16 fused apply
    directly (the logical view would cost a 16-bit relayout each way).
    Decided from dtype and shape only, on every device."""
    pf = _pack_factor(state.value_dtype)
    return pf == 2 and state.dim % pf == 0 and state.dim // pf <= _LANES


def _scatter_rows_state(state: TableState, idx: torch.Tensor,
                        packed_rows: torch.Tensor) -> torch.Tensor:
    """Scatter logical [N, W] rows through the row-scatter kernel.
    Writes ``state.rows`` IN PLACE and returns it."""
    n = packed_rows.shape[0]
    phys = _to_physical_rows(packed_rows.to(state.value_dtype),
                             state.rows.dtype, n * state.chunks)
    return _move_rows_scatter(state.rows, state.chunks, idx, phys,
                              state.capacity)


def gather_values(state: TableState, slot: torch.Tensor,
                  found: torch.Tensor) -> torch.Tensor:
    """[N, dim] VALUE rows at ``slot``: the row-gather kernel copies only
    each row's leading value chunks (``vc`` of the row's ``ch``). Rows
    where ``found`` is False carry unspecified data (the trash row);
    callers mask by ``found``."""
    d = state.dim
    pf = _pack_factor(state.value_dtype)
    ch = state.chunks
    dc = d // pf if d % pf == 0 else 0  # container words per value row
    vc = (dc + _LANES - 1) // _LANES  # value chunks
    if dc == 0 or ch % vc:
        return gather_packed(state, slot, found)[:, :d]
    idx = torch.where(found, slot, state.capacity)
    out = _move_rows_gather(state.rows, ch, idx, vc=vc)
    col = out[:, :dc]
    if pf == 1:
        return col
    return col.contiguous().view(state.value_dtype)[:, :d]


def gather(spec: TableSpec, state: TableState, slot: torch.Tensor,
           found: torch.Tensor, default_values) -> torch.Tensor:
    """Value rows at ``slot`` where found else ``default_values``
    ([N, D] or [D])."""
    rows = gather_values(state, slot, found)
    default = torch.as_tensor(default_values, dtype=spec.value_dtype,
                              device=rows.device)
    if default.dim() < 2:
        default = default.expand(rows.shape)
    return torch.where(found[:, None], rows, default)


def lookup(spec: TableSpec, state: TableState, keys: torch.Tensor,
           default_values=0.0):
    """Pure lookup: values for found keys, defaults for missing (the
    inference path). Returns ``(values [N, dim], found [N])``."""
    slot, found = find(spec, state, keys)
    if not isinstance(default_values, torch.Tensor):
        default_values = torch.full((spec.dim,), default_values,
                                    dtype=spec.value_dtype,
                                    device=state.device)
    return gather(spec, state, slot, found, default_values), found


# ---------------------------------------------------------------------------
# fused dedup + probe + write planning (the training lookup)
# ---------------------------------------------------------------------------


def _dup_probe(n: int, cap: int, sidx: torch.Tensor):
    """One scatter of batch positions into slot space, shared by the
    duplicate test and the dedup. Returns ``(pos [N], buf [pad128(C+1)],
    n_distinct)``: ``buf[s]`` is the LAST batch position whose slot is
    ``s`` (-1 where untouched; misses land in the cell at ``cap``), and
    ``n_distinct`` counts the touched live slots.

    The JAX package's ``buf.at[sidx].set(pos)`` lets the last write win on
    XLA's CPU; an indexed store with duplicate indices has no order on
    CUDA, so the port takes the maximum position (``scatter_reduce``
    amax), which is the same choice on every device."""
    pos = torch.arange(n, dtype=torch.int32, device=sidx.device)
    size = (cap + 1 + _LANES - 1) // _LANES * _LANES
    buf = torch.full((size,), -1, dtype=torch.int32,
                     device=sidx.device).scatter_reduce(
        0, sidx.long(), pos, "amax")
    n_distinct = (buf[:cap] != -1).sum()
    return pos, buf, n_distinct


def _first_occurrence(sidx: torch.Tensor, n: int, cap: int) -> torch.Tensor:
    """First batch position holding each value of ``sidx`` (slot indices
    in ``[0, cap]``; ``cap`` = trash sentinel): ``rep [N]``, the position
    of the first occurrence of ``sidx[i]``. One scatter-min into a
    128-padded [C] buffer and a read-back."""
    pos = torch.arange(n, dtype=torch.int32, device=sidx.device)
    size = (cap + 1 + _LANES - 1) // _LANES * _LANES
    first = torch.full((size,), n, dtype=torch.int32,
                       device=sidx.device).scatter_reduce(
        0, sidx.long(), pos, "amin")
    return take_elem(first, sidx)


def plan_lookup_fast(spec: TableSpec, state: TableState, keys: torch.Tensor):
    """:func:`plan_lookup` with fast paths for all-hit batches: each
    key's slot is then already a collision-free identity, so the dedup is
    one scatter of positions into slot space (:func:`_dup_probe`), and a
    dup-free batch skips even its read-back (uniq IS the batch, inverse
    IS the iota). A batch with a miss goes through :func:`plan_lookup`.

    Returns ``(uniq, inverse, (slot, found, inserted, dropped))`` with
    :func:`plan_lookup`'s contract, except that on the fast paths each
    representative keeps its batch position (EMPTY elsewhere). The JAX
    package's two ``lax.cond``s are host ``if``s here."""
    flat = keys.reshape(-1)
    n = flat.shape[0]
    cap = state.capacity
    slot_f, found_f = find(spec, state, flat)
    valid = flat != spec.empty_key
    if not bool((found_f | ~valid).all()):  # host sync: a miss
        uniq, inverse, plan, _ = plan_lookup(spec, state, flat)
        return uniq, inverse, plan
    sidx = torch.where(found_f, slot_f, cap)  # misses/EMPTY -> trash
    pos, buf, n_distinct = _dup_probe(n, cap, sidx)
    zeros = torch.zeros(n, dtype=torch.bool, device=flat.device)
    if bool(n_distinct == found_f.sum()):  # host sync: no duplicate
        return flat, pos, (slot_f, found_f, zeros, zeros)
    rep = take_elem(buf, sidx)
    is_rep = (rep == pos) & found_f
    uniq = torch.where(is_rep, flat, spec.empty_key)
    inverse = torch.where(found_f, rep, pos)
    return uniq, inverse, (slot_f, is_rep, zeros, zeros)


def _unsigned_order(x: torch.Tensor, width: int) -> torch.Tensor:
    """int64 holding unsigned ``width``-bit values -> int64 whose signed
    order is their unsigned order (flip the sign bit of 64-bit values)."""
    return x ^ _INT64_MIN if width == 64 else x


def plan_lookup(spec: TableSpec, state: TableState, keys: torch.Tensor):
    """Dedup + probe + write plan in ONE sort: keys sort by their mixed
    bits rotated so the bucket bits lead, which keeps equal keys adjacent
    (the mix is a bijection) and same-bucket keys contiguous, so the
    within-bucket insert rank is a segmented cumsum.

    Returns ``(uniq [N], inverse [N], (slot, found, inserted, dropped),
    no_dups)``: each unique key sits at its representative's (its first
    occurrence's) batch position, EMPTY elsewhere; ``no_dups`` (a Python
    bool) says the batch held no duplicate valid key, and then ``inverse``
    is the identity."""
    flat = keys.reshape(-1)
    n = flat.shape[0]
    dev = flat.device
    cap = state.capacity
    bsz = spec.bucket_size
    nb = spec.num_buckets.bit_length() - 1
    width = 64 if flat.dtype == torch.int64 else 32
    mask = -1 if width == 64 else 0xFFFFFFFF

    def rotr(x, r):  # rotate right within ``width`` bits
        if r == 0:
            return x
        return ((x << (width - r)) & mask) | hashing._srl(x, r)

    rot = rotr(hashing.mix(flat), nb)
    srt, order = torch.sort(_unsigned_order(rot, width), stable=True)
    rot_s = _unsigned_order(srt, width)
    b_s = (hashing._srl(rot_s, width - nb) if nb else
           torch.zeros_like(rot_s)).to(torch.int32)
    sk = hashing.unmix(rotr(rot_s, width - nb) if nb else rot_s,
                       flat.dtype).to(flat.dtype)
    sk_lo, sk_hi = split_key(sk)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = rot_s[1:] != rot_s[:-1]

    # probe, in sorted order
    e_lo, e_hi = _split_int(spec.empty_key)
    cl = _bucket_gather(spec, state.key_lo, b_s)  # [N, B]
    chi = _bucket_gather(spec, state.key_hi, b_s)
    match = (cl == sk_lo[:, None]) & (chi == sk_hi[:, None])
    valid_s = sk != spec.empty_key
    found_s = match.any(dim=-1) & valid_s
    slot_found_s = b_s * bsz + _argmax_first(match)

    # within-bucket insert rank: segmented exclusive cumsum
    need_s = is_start & valid_s & ~found_s
    ind = need_s.to(torch.int32)
    pre = torch.cumsum(ind, dim=0, dtype=torch.int32) - ind
    is_bstart = torch.ones(n, dtype=torch.bool, device=dev)
    is_bstart[1:] = b_s[1:] != b_s[:-1]
    rank_s = pre - torch.cummax(torch.where(is_bstart, pre, 0),
                                dim=0).values

    # slots claimed by found keys are neither free nor evictable
    claimed = torch.zeros(cap + 1, dtype=torch.bool, device=dev)
    claimed[torch.where(is_start & found_s, slot_found_s, cap).long()] = True
    claimed_b = _bucket_gather(spec, claimed[:cap], b_s)
    empty_b = (cl == e_lo) & (chi == e_hi)
    free_b = empty_b & ~claimed_b
    num_free = free_b.sum(dim=-1, dtype=torch.int32)
    cf = torch.cumsum(free_b.to(torch.int32), dim=-1, dtype=torch.int32)
    kth_free = _argmax_first(cf == (rank_s + 1)[:, None])
    evictable_b = ~empty_b & ~claimed_b
    num_evictable = evictable_b.sum(dim=-1, dtype=torch.int32)
    use_free = rank_s < num_free
    if bool((need_s & ~use_free).any()):  # host sync: a bucket overflows
        sc = _bucket_gather(spec, state.scores, b_s)
        sc = torch.where(evictable_b, sc, _score_max(sc.dtype))
        kth_evict = _kth_lowest_slot(
            sc, (rank_s - num_free).clamp(0, bsz - 1))
    else:
        kth_evict = torch.zeros(n, dtype=torch.int32, device=dev)
    dropped_s = need_s & (rank_s >= num_free + num_evictable)
    inserted_s = need_s & ~dropped_s
    slot_s = torch.where(found_s, slot_found_s,
                         b_s * bsz + torch.where(use_free, kth_free,
                                                 kth_evict))

    # per-unique outputs at the representative's batch position, through
    # one packed word: slot in bits 0-27, the three flags in bits 28-30
    if cap > 1 << 28:
        raise ValueError("plan_lookup packs slots into 28 bits")
    word_s = (slot_s | (found_s.to(torch.int32) << 28)
              | (inserted_s.to(torch.int32) << 29)
              | (dropped_s.to(torch.int32) << 30))
    word = _set_drop(torch.zeros(n, dtype=torch.int32, device=dev),
                     torch.where(is_start, order, n), word_s)
    found = ((word >> 28) & 1).bool()
    inserted = ((word >> 29) & 1).bool()
    dropped = ((word >> 30) & 1).bool()
    slot = torch.where(found | inserted, word & ((1 << 28) - 1), 0)
    uniq = torch.where(found | inserted | dropped, flat, spec.empty_key)
    no_dups = bool((is_start & valid_s).sum() == valid_s.sum())  # host sync
    idx_s = torch.arange(n, dtype=torch.int32, device=dev)
    if no_dups:
        inverse = idx_s
    else:
        start_idx = torch.cummax(torch.where(is_start, idx_s, 0),
                                 dim=0).values
        inverse = torch.empty(n, dtype=torch.int32, device=dev)
        inverse[order] = order[start_idx.long()].to(torch.int32)
    return uniq, inverse, (slot, found, inserted, dropped), no_dups


def plan_lookup_train(spec: TableSpec, state: TableState, keys: torch.Tensor,
                      init_fn, score_const=None, defer_dedup=False):
    """The training lookup's plan: probe, dedup, write plan, packed-row
    gather and value-row blend, branched on the all-hit case.

    Returns ``(uniq, inverse, (slot, found, inserted, dropped), packed,
    no_dups, rows_aligned, new_key_lo, new_key_hi)`` plus ``new_scores``
    when ``score_const`` is given, with the JAX package's contracts:

    * hit batches keep each representative at its batch position (uniq IS
      the batch when ``no_dups``) and gather one packed row PER OCCURRENCE
      (``rows_aligned`` True); a miss batch goes through
      :func:`plan_lookup` and its rows are per representative
      (``rows_aligned == no_dups``);
    * the packed block's value columns hold the blended row (stored row
      for hits, ``init_fn`` row for misses) and inserted rows' slot
      columns hold their fresh fills, so the fused apply reads the block
      verbatim; its layout is physical when :func:`phys_packed_ok`;
    * the returned key planes carry this batch's inserts, and with
      ``score_const`` (a batch-constant score, LRU-style) the returned
      score plane carries this batch's scores. The hit branch then uses
      that score scatter as its duplicate probe: the number of entries
      that newly equal the constant counts the distinct touched slots.

    ``defer_dedup`` (with ``score_const`` only, as in the JAX package):
    the scored hit branch defers the dedup to the apply
    (:func:`sorted_combine_batch`) and keeps the occurrence contract on
    every hit batch: uniq IS the batch, ``found`` marks every occurrence,
    the gather is per occurrence, and ``no_dups`` still comes out, so the
    apply can skip the combine on a dup-free batch.

    ``no_dups`` and ``rows_aligned`` are Python bools. Key and score planes
    are new tensors; ``state`` is not changed."""
    flat = keys.reshape(-1)
    n = flat.shape[0]
    dev = flat.device
    cap = state.capacity
    d = state.dim
    slot_f, found_f = find(spec, state, flat)
    valid = flat != spec.empty_key
    phys = phys_packed_ok(state)
    gather_fn = gather_packed_phys if phys else gather_packed
    scored = score_const is not None
    if scored:
        sc = state.scores.new_full((), int(score_const))
        sc_vec = sc.expand(n)

    if bool((found_f | ~valid).all()):  # host sync: all hit
        sidx = torch.where(found_f, slot_f, cap)  # misses/EMPTY -> trash
        zeros = torch.zeros(n, dtype=torch.bool, device=dev)
        n_found = found_f.sum()
        if scored:
            # the score stamp writes equal values: duplicates cannot race
            pos = torch.arange(n, dtype=torch.int32, device=dev)
            before = (state.scores == sc).sum()
            new_scores = _set_drop(state.scores, sidx, sc_vec)
            no_dups = bool((new_scores == sc).sum() - before == n_found)
            if defer_dedup:
                packed = gather_fn(state, slot_f, found_f)
                return (flat, pos, (slot_f, found_f, zeros, zeros), packed,
                        no_dups, True, state.key_lo, state.key_hi,
                        new_scores)
        else:
            pos, buf, n_distinct = _dup_probe(n, cap, sidx)
            no_dups = bool(n_distinct == n_found)  # host sync
        packed = gather_fn(state, slot_f, found_f)
        if no_dups:
            out = (flat, pos, (slot_f, found_f, zeros, zeros), packed)
        else:
            if scored:
                _, buf, _ = _dup_probe(n, cap, sidx)
            rep = take_elem(buf, sidx)
            is_rep = (rep == pos) & found_f
            uniq = torch.where(is_rep, flat, spec.empty_key)
            inverse = torch.where(found_f, rep, pos)
            out = (uniq, inverse, (slot_f, is_rep, zeros, zeros), packed)
        out = out + (no_dups, True, state.key_lo, state.key_hi)
        return out + (new_scores,) if scored else out

    uniq, inverse, plan, no_dups = plan_lookup(spec, state, flat)
    slot, found, inserted, _ = plan
    if bool(found.any()):  # host sync: an all-insert batch reads no row
        packed = gather_fn(state, slot, found)
    elif phys:
        packed = torch.zeros((n * state.chunks, _LANES),
                             dtype=state.rows.dtype, device=dev)
    else:
        packed = torch.zeros((n, state.width), dtype=state.value_dtype,
                             device=dev)
    init_rows = init_fn(uniq)
    stored = packed_value_rows(state, n, packed)
    rows = torch.where(found[:, None], stored,
                       init_rows.to(state.value_dtype))
    if phys:
        dc = d // _pack_factor(state.value_dtype)
        packed.view(n, state.chunks, _LANES)[:, 0, :dc] = (
            rows.contiguous().view(packed.dtype))
    else:
        packed[:, :d] = rows
    packed = reset_inserted_slots(state, n, packed, inserted)
    k_lo, k_hi = split_key(uniq)
    ins_idx = torch.where(inserted, slot, cap)
    out = (uniq, inverse, plan, packed, no_dups, no_dups,
           _set_drop(state.key_lo, ins_idx, k_lo),
           _set_drop(state.key_hi, ins_idx, k_hi))
    if scored:
        widx = torch.where(found | inserted, slot, cap)
        out = out + (_set_drop(state.scores, widx, sc_vec),)
    return out


# ---------------------------------------------------------------------------
# insertion
# ---------------------------------------------------------------------------


def _kth_lowest_slot(sc_masked: torch.Tensor, k: torch.Tensor):
    """Index (along the last axis) of the k-th lowest entry of
    ``sc_masked`` [N, B], ties broken by position: slot j's rank is the
    number of slots that beat it, summed over the B competitor columns."""
    n, bsz = sc_masked.shape
    lanes = torch.arange(bsz, device=sc_masked.device)[None, :]
    cnt = torch.zeros((n, bsz), dtype=torch.int32, device=sc_masked.device)
    for col_i in range(bsz):
        col = sc_masked[:, col_i:col_i + 1]
        beats = (col < sc_masked) | ((col == sc_masked) & (col_i < lanes))
        cnt += beats.to(torch.int32)
    return _argmax_first(cnt == k[:, None])


def _segment_rank(sort_key: torch.Tensor):
    """Rank of each element within its equal-valued group, in batch order
    (a STABLE sort, as ``jax.lax.sort``)."""
    n = sort_key.shape[0]
    sorted_k, order = torch.sort(sort_key, stable=True)
    idx = torch.arange(n, device=sort_key.device)
    is_start = torch.ones(n, dtype=torch.bool, device=sort_key.device)
    is_start[1:] = sorted_k[1:] != sorted_k[:-1]
    start_idx = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.int32, device=sort_key.device)
    rank[order] = (idx - start_idx).to(torch.int32)
    return rank


def _plan_writes(spec: TableSpec, state: TableState, keys: torch.Tensor):
    """Assign a distinct slot to every valid key: its match, a free slot,
    or a min-score eviction victim in its bucket.

    Returns (slot [N], found [N], inserted [N], dropped [N]). ``dropped``
    marks keys that could not be placed (more than ``bucket_size`` new keys
    of this batch in one bucket). Precondition: ``keys`` deduplicated
    (EMPTY padding allowed)."""
    n = keys.shape[0]
    cap = state.capacity
    valid = keys != spec.empty_key
    bucket_id, base = _bucket_of(spec, keys)
    lo, hi = split_key(keys)
    e_lo, e_hi = _split_int(spec.empty_key)
    cl = _bucket_gather(spec, state.key_lo, bucket_id)  # [N, B] int32
    chi = _bucket_gather(spec, state.key_hi, bucket_id)
    match = (cl == lo[:, None]) & (chi == hi[:, None])
    found = match.any(dim=-1) & valid
    slot_found = base + _argmax_first(match)

    # slots matched by this batch are not free and not evictable
    claimed = torch.zeros(cap + 1, dtype=torch.bool, device=keys.device)
    claimed[torch.where(found, slot_found, cap).long()] = True
    claimed_b = _bucket_gather(spec, claimed[:cap], bucket_id)  # [N, B]

    empty_b = (cl == e_lo) & (chi == e_hi)
    free_b = empty_b & ~claimed_b
    num_free = free_b.sum(dim=-1, dtype=torch.int32)

    need = valid & ~found
    # keys placed elsewhere share one inactive group (still ranked, unused)
    rank = _segment_rank(torch.where(need, bucket_id, spec.num_buckets))

    # k-th free position via cumulative count
    cf = torch.cumsum(free_b.to(torch.int32), dim=-1, dtype=torch.int32)
    kth_free = _argmax_first(cf == (rank + 1)[:, None])

    # eviction: k-th lowest score among occupied, unclaimed slots, ranked
    # only when some bucket overflows (a host sync, fine on this path)
    evictable_b = ~empty_b & ~claimed_b
    num_evictable = evictable_b.sum(dim=-1, dtype=torch.int32)
    use_free = rank < num_free
    if bool((need & ~use_free).any()):
        sc = _bucket_gather(spec, state.scores, bucket_id)
        sc = torch.where(evictable_b, sc, _score_max(sc.dtype))
        evict_rank = (rank - num_free).clamp(0, spec.bucket_size - 1)
        kth_evict = _kth_lowest_slot(sc, evict_rank)
    else:
        kth_evict = torch.zeros(n, dtype=torch.int32, device=keys.device)
    dropped = need & (rank >= num_free + num_evictable)
    inserted = need & ~dropped
    slot_new = base + torch.where(use_free, kth_free, kth_evict)
    return torch.where(found, slot_found, slot_new), found, inserted, dropped


def _pack_rows(state: TableState, n: int, values: Optional[torch.Tensor],
               slot_rows: Optional[Dict[str, torch.Tensor]],
               old_packed: torch.Tensor, found: torch.Tensor,
               inserted: torch.Tensor,
               deltas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The new packed [N, W] rows of a commit:

    * value columns: ``values`` (assign) and/or ``old + deltas`` where
      found (accum; ``values``, else the delta, where not);
    * slot columns: ``slot_rows[name]`` where given, else kept where found
      and reset to their fresh fill where inserted (eviction victims carry
      stale slot state).

    May write ``old_packed`` in place (a commit's own gathered buffer)."""
    d = state.dim
    dt = state.value_dtype
    out = old_packed
    if state.slot_names:
        fresh = torch.zeros((n, state.width), dtype=dt, device=out.device)
        for i, nm in enumerate(state.slot_names):
            fresh[:, d * (1 + i): d * (2 + i)] = state.slot_init(nm)
        out = torch.where(inserted[:, None], fresh, out)
    if deltas is not None:
        old_vals = where_or_zero(found[:, None], old_packed[:, :d])
        acc = old_vals + deltas.to(dt)
        new = deltas if values is None else values
        out[:, :d] = torch.where(found[:, None], acc, new.to(dt))
    elif values is not None:
        out[:, :d] = values.to(dt)
    for nm, rows_nm in (slot_rows or {}).items():
        if nm in state.slot_names:
            off = state.slot_offset(nm)
            out[:, off:off + d] = rows_nm.to(dt)
    return out


def commit(spec: TableSpec, state: TableState, keys: torch.Tensor,
           values: Optional[torch.Tensor] = None,
           deltas: Optional[torch.Tensor] = None,
           slot_rows: Optional[Dict[str, torch.Tensor]] = None,
           scores: Optional[torch.Tensor] = None, *,
           score_mode: str = "assign", return_evicted: bool = False):
    """One planned, conflict-free batch write: keys + packed rows (+scores)
    in ONE row-scatter (plus the [C]-column key/score writes).

    * ``values``: insert-or-assign;
    * ``deltas``: insert-or-accum (bp_v2): added to existing rows, and
      ``values`` (or the delta) written for missing keys;
    * ``slot_rows``: optimizer slot rows of every placed key;
    * ``score_mode``: ``"assign"`` (LRU-style) or ``"add"`` (LFU-style);
    * ``return_evicted``: also return the rows that score eviction
      displaces, ``(state, evicted)`` (see :func:`commit_planned`).

    Precondition: keys deduplicated; EMPTY-sentinel entries are ignored."""
    plan = _plan_writes(spec, state, keys)
    return commit_planned(spec, state, keys, plan, values=values,
                          deltas=deltas, slot_rows=slot_rows, scores=scores,
                          score_mode=score_mode,
                          return_evicted=return_evicted)


def commit_planned(spec: TableSpec, state: TableState, keys: torch.Tensor,
                   plan, values: Optional[torch.Tensor] = None,
                   deltas: Optional[torch.Tensor] = None,
                   slot_rows: Optional[Dict[str, torch.Tensor]] = None,
                   scores: Optional[torch.Tensor] = None, *,
                   score_mode: str = "assign", return_evicted: bool = False):
    """Commit against a precomputed write plan (``_plan_writes``, or the
    training lookup's). The rows are written in place (see the module
    docstring). With ``return_evicted`` returns ``(state, evicted)``:
    ``keys``, ``values``, ``scores`` and ``slots`` of the rows this
    write's inserts displace (EMPTY / zeros elsewhere), read before the
    write, and ``dropped_keys`` / ``dropped_values``, the input rows that
    could not be placed, so a spill tier loses no row."""
    n = keys.shape[0]
    slot, found, inserted, dropped = plan
    write = found | inserted
    idx = torch.where(write, slot, state.capacity)  # sentinel => dropped
    full_cover = (values is not None and deltas is None
                  and not return_evicted
                  and all(nm in (slot_rows or {})
                          for nm in state.slot_names))
    if full_cover:  # the write covers every column: old rows never read
        old_packed = torch.zeros((n, state.width), dtype=state.value_dtype,
                                 device=state.device)
    else:
        old_packed = gather_packed(state, slot, write)

    evicted = None
    if return_evicted:
        d = state.dim
        vdt = state.value_dtype
        old_keys = join_key(take_elem(state.key_lo, slot),
                            take_elem(state.key_hi, slot)).to(keys.dtype)
        displaced = inserted & (old_keys != spec.empty_key)
        new = values if values is not None else deltas
        dv = (where_or_zero(dropped[:, None], new.to(vdt))
              if new is not None
              else torch.zeros((n, d), dtype=vdt, device=state.device))
        evicted = {
            "keys": torch.where(displaced, old_keys, spec.empty_key),
            "values": where_or_zero(displaced[:, None], old_packed[:, :d]),
            "scores": torch.where(displaced, take_elem(state.scores, slot),
                                  0),
            "slots": {nm: where_or_zero(
                displaced[:, None],
                old_packed[:, state.slot_offset(nm):
                           state.slot_offset(nm) + d])
                for nm in state.slot_names},
            "dropped_keys": torch.where(dropped, keys, spec.empty_key),
            "dropped_values": dv,
        }

    new_packed = _pack_rows(state, n, values, slot_rows, old_packed, found,
                            inserted, deltas=deltas)
    new_rows = _scatter_rows_state(state, idx, new_packed)

    k_lo, k_hi = split_key(keys)
    if scores is None:
        scores = torch.ones(n, dtype=spec.score_dtype, device=state.device)
    new_sc = scores.to(spec.score_dtype)
    if score_mode == "add":
        new_sc = new_sc + torch.where(found, take_elem(state.scores, slot), 0)
    new_state = state.replace(
        key_lo=_set_drop(state.key_lo, idx, k_lo),
        key_hi=_set_drop(state.key_hi, idx, k_hi),
        rows=new_rows,
        scores=_set_drop(state.scores, idx, new_sc),
    )
    if return_evicted:
        return new_state, evicted
    return new_state


def commit_keys_scores(spec: TableSpec, state: TableState,
                       keys: torch.Tensor, plan,
                       scores: Optional[torch.Tensor] = None, *,
                       score_mode: str = "assign") -> TableState:
    """The key-plane and score updates of a planned commit, rows left
    alone (the fused apply kernel writes them). The JAX package skips the
    key scatters behind a cond on ``any(inserted)``; here they always run
    (with no insert every index is the dropped sentinel), which spares a
    host sync."""
    slot, found, inserted, _ = plan
    cap = state.capacity
    idx = torch.where(found | inserted, slot, cap)
    if scores is None:
        scores = torch.ones(keys.shape, dtype=spec.score_dtype,
                            device=state.device)
    scores = scores.to(spec.score_dtype)
    if score_mode == "add":
        scores = scores + torch.where(found, take_elem(state.scores, slot), 0)
    k_lo, k_hi = split_key(keys)
    ins_idx = torch.where(inserted, slot, cap)
    return state.replace(key_lo=_set_drop(state.key_lo, ins_idx, k_lo),
                         key_hi=_set_drop(state.key_hi, ins_idx, k_hi),
                         scores=_set_drop(state.scores, idx, scores))


def commit_scores(spec: TableSpec, state: TableState, plan,
                  scores: torch.Tensor, *,
                  score_mode: str = "assign") -> TableState:
    """The score-plane update of a planned commit whose key planes were
    already committed (by ``plan_lookup_train``'s miss branch)."""
    slot, found, inserted, _ = plan
    idx = torch.where(found | inserted, slot, state.capacity)
    scores = scores.to(spec.score_dtype)
    if score_mode == "add":
        scores = scores + torch.where(found, take_elem(state.scores, slot), 0)
    return state.replace(scores=_set_drop(state.scores, idx, scores))


def upsert(spec: TableSpec, state: TableState, keys: torch.Tensor,
           values: torch.Tensor, scores: Optional[torch.Tensor] = None, *,
           score_mode: str = "assign") -> TableState:
    """Insert-or-assign a batch of (deduplicated) keys, evicting the
    lowest-score slot of a full bucket."""
    return commit(spec, state, keys, values=values, scores=scores,
                  score_mode=score_mode)


def accum(spec: TableSpec, state: TableState, keys: torch.Tensor,
          deltas: torch.Tensor, values_for_new: Optional[torch.Tensor] = None,
          scores: Optional[torch.Tensor] = None, *,
          score_mode: str = "assign") -> TableState:
    """bp_v2 delta write: add ``deltas`` to existing rows; insert
    ``values_for_new`` (or the delta itself) for missing keys."""
    return commit(spec, state, keys, values=values_for_new, deltas=deltas,
                  scores=scores, score_mode=score_mode)


def _scores_at(state: TableState, idx: torch.Tensor, slot: torch.Tensor,
               mask: torch.Tensor, scores: Optional[torch.Tensor],
               score_mode: str) -> torch.Tensor:
    """The score plane with ``scores`` written at ``idx`` (``"add"``:
    added to the stored scores where ``mask``)."""
    if scores is None:
        return state.scores
    scores = scores.to(state.scores.dtype)
    if score_mode == "add":
        scores = scores + torch.where(mask, take_elem(state.scores, slot), 0)
    return _set_drop(state.scores, idx, scores)


def scatter_packed(state: TableState, slot: torch.Tensor, mask: torch.Tensor,
                   packed_rows: torch.Tensor,
                   scores: Optional[torch.Tensor] = None, *,
                   score_mode: str = "assign") -> TableState:
    """Conflict-free writeback of logical PACKED [N, W] rows to known
    slots (where ``mask``), through the row scatter (in place)."""
    idx = torch.where(mask, slot, state.capacity)
    new_rows = _scatter_rows_state(state, idx, packed_rows)
    return state.replace(rows=new_rows, scores=_scores_at(
        state, idx, slot, mask, scores, score_mode))


def scatter_rows(spec: TableSpec, state: TableState, slot: torch.Tensor,
                 mask: torch.Tensor, values: Optional[torch.Tensor] = None,
                 scores: Optional[torch.Tensor] = None,
                 slot_rows: Optional[Dict[str, torch.Tensor]] = None, *,
                 score_mode: str = "assign") -> TableState:
    """Writeback of value and slot rows to known slots: the packed rows
    are gathered, their given columns replaced, and scattered back. With
    only ``scores`` given, a score refresh (no row traffic)."""
    if values is None and not slot_rows:
        idx = torch.where(mask, slot, state.capacity)
        return state.replace(scores=_scores_at(state, idx, slot, mask,
                                               scores, score_mode))
    packed = gather_packed(state, slot, mask)
    d = state.dim
    if values is not None:
        packed[:, :d] = values.to(packed.dtype)
    for nm, rows_nm in (slot_rows or {}).items():
        if nm in state.slot_names:
            off = state.slot_offset(nm)
            packed[:, off:off + d] = rows_nm.to(packed.dtype)
    return scatter_packed(state, slot, mask, packed, scores,
                          score_mode=score_mode)


def remove(spec: TableSpec, state: TableState,
           keys: torch.Tensor) -> TableState:
    """Delete keys: their key planes go EMPTY and their scores 0 (the rows
    stay; nothing reads a row whose key is EMPTY). Bucket-local insertion
    means removal never breaks a probe."""
    slot, found = find(spec, state, keys)
    idx = torch.where(found, slot, state.capacity)
    e_lo, e_hi = _split_int(spec.empty_key)
    n = keys.shape[0]
    return state.replace(
        key_lo=_set_drop(state.key_lo, idx, state.key_lo.new_full((n,), e_lo)),
        key_hi=_set_drop(state.key_hi, idx, state.key_hi.new_full((n,), e_hi)),
        scores=_set_drop(state.scores, idx, state.scores.new_zeros(n)))


def clear(spec: TableSpec, state: TableState) -> TableState:
    """Empty the table: EMPTY key planes, zero scores, and the rows
    zeroed IN PLACE (the port's rule for ``rows``)."""
    e_lo, e_hi = _split_int(spec.empty_key)
    cap = state.capacity
    return state.replace(
        key_lo=torch.full((cap,), e_lo, dtype=torch.int32,
                          device=state.device),
        key_hi=torch.full((cap,), e_hi, dtype=torch.int32,
                          device=state.device),
        rows=state.rows.zero_(),
        scores=torch.zeros_like(state.scores))


# ---------------------------------------------------------------------------
# export / stats
# ---------------------------------------------------------------------------


def occupancy_mask(spec: TableSpec, state: TableState) -> torch.Tensor:
    e_lo, e_hi = _split_int(spec.empty_key)
    return ~((state.key_lo == e_lo) & (state.key_hi == e_hi))


def size(spec: TableSpec, state: TableState) -> torch.Tensor:
    """Live-key count (0-d int64 tensor)."""
    return occupancy_mask(spec, state).sum()


def export(spec: TableSpec, state: TableState):
    """Full dump ``(keys [C], values [C, D], mask [C])``; compaction is
    the caller's."""
    return state.keys, state.values, occupancy_mask(spec, state)


def export_with_scores(spec: TableSpec, state: TableState):
    """``(keys [C], values [C, D], scores [C], mask [C])`` (HKV's
    ``export_keys_and_scores``)."""
    return state.keys, state.values, state.scores, occupancy_mask(spec, state)


# ---------------------------------------------------------------------------
# score eviction: an exact radix select, no capacity-wide sort or top-k
# ---------------------------------------------------------------------------


def _score_bits(scores: torch.Tensor) -> int:
    return 64 if scores.dtype == torch.int64 else 32


def to_unsigned_order(sc: torch.Tensor) -> torch.Tensor:
    """The JAX package's order-preserving signed -> unsigned map (flip the
    sign bit), as int64 holding the unsigned bits: int32 scores become
    ``sc + 2**31`` in ``[0, 2**32)``; int64 scores ``sc ^ 2**63``, whose
    signed order is restored by :func:`_unsigned_order` (CUDA has no
    unsigned 64-bit compare)."""
    if sc.dtype == torch.int64:
        return sc ^ _INT64_MIN
    return sc.to(torch.int64) + (1 << 31)


def _dead_order(bits: int) -> int:
    """The largest unsigned ``bits``-wide value, as :func:`to_unsigned_order`
    holds it (all ones)."""
    return -1 if bits == 64 else (1 << 32) - 1


def radix_select_threshold(u: torch.Tensor, mask: torch.Tensor, k,
                           bits: int = 64):
    """Exact k-th-smallest selection over masked unsigned ``bits``-wide
    scores ``u`` [C] (held as :func:`to_unsigned_order` gives them).

    Returns ``(t, count_below)``: the k-th smallest masked value and the
    count of masked entries strictly below it, both 0-d device tensors
    (int64 and int32). ``bits / 8`` byte passes over [C], each a 256-bin
    histogram by ``scatter_add_`` (``torch.bincount`` would read its
    maximum back to size its output, a host sync each pass); integer
    sums are exact, so the cumsum and the bin choice stay on the
    device."""
    dev = u.device
    prefix = torch.zeros((), dtype=torch.int64, device=dev)
    below = torch.zeros((), dtype=torch.int32, device=dev)
    remaining = torch.as_tensor(k, device=dev).to(torch.int32)
    for shift in range(bits - 8, -1, -8):
        if shift + 8 >= bits:
            active = mask
        else:
            active = mask & ((u >> (shift + 8)) == (prefix >> (shift + 8)))
        bins = (u >> shift) & 0xFF
        hist = torch.zeros(256, dtype=torch.int32, device=dev).scatter_add_(
            0, bins, active.to(torch.int32))
        cum = torch.cumsum(hist, 0, dtype=torch.int32)
        b = _argmax_first(cum >= remaining)
        below_bin = torch.where(b > 0, cum[(b - 1).clamp(min=0).long()], 0)
        below = below + below_bin
        remaining = remaining - below_bin
        prefix = prefix | (b.to(torch.int64) << shift)
    return prefix, below


def _victims(scores: torch.Tensor, mask: torch.Tensor, n_victim):
    """[C] bool: the ``n_victim`` lowest-score entries where ``mask``, ties
    broken by slot order (a radix threshold plus a tie-rank cumsum)."""
    bits = _score_bits(scores)
    u = torch.where(mask, to_unsigned_order(scores), _dead_order(bits))
    t, below = radix_select_threshold(u, mask, n_victim, bits)
    strict = mask & (_unsigned_order(u, bits) < _unsigned_order(t, bits))
    eq = mask & (u == t)
    eq_rank = torch.cumsum(eq.to(torch.int32), 0, dtype=torch.int32)
    return (strict | (eq & (eq_rank <= n_victim - below))) & (n_victim > 0)


def lowest_k_indices(scores: torch.Tensor, mask: torch.Tensor,
                     num_evict: int):
    """Slot indices of the ``num_evict`` lowest-score entries where
    ``mask`` (ties broken by slot order), without a capacity-wide sort.

    Returns ``(idx [num_evict] int32, valid [num_evict] bool)``; invalid
    tail entries (fewer than ``num_evict`` live) point at ``len(scores)``
    (the drop sentinel)."""
    cap = scores.shape[0]
    dev = scores.device
    live = mask.sum().to(torch.int32)
    n_victim = live.clamp(max=num_evict)
    victims = _victims(scores, mask, n_victim)
    rank = torch.cumsum(victims.to(torch.int32), 0, dtype=torch.int32) - 1
    idx = _set_drop(
        torch.full((num_evict,), cap, dtype=torch.int32, device=dev),
        torch.where(victims, rank, num_evict),
        torch.arange(cap, dtype=torch.int32, device=dev))
    valid = torch.arange(num_evict, dtype=torch.int32, device=dev) < n_victim
    return idx, valid


def lowest_score_victims(spec: TableSpec, state: TableState,
                         num_evict: int):
    """:func:`lowest_k_indices` over a table's live slots."""
    return lowest_k_indices(state.scores, occupancy_mask(spec, state),
                            num_evict)


def evict_lowest(spec: TableSpec, state: TableState,
                 num_evict: int) -> TableState:
    """Remove the ``num_evict`` lowest-score live keys (their key planes
    go EMPTY, their scores 0; the rows stay, as in :func:`remove`)."""
    idx, valid = lowest_score_victims(spec, state, num_evict)
    idx = torch.where(valid, idx, state.capacity)
    e_lo, e_hi = _split_int(spec.empty_key)
    return state.replace(
        key_lo=_set_drop(state.key_lo, idx,
                         state.key_lo.new_full((num_evict,), e_lo)),
        key_hi=_set_drop(state.key_hi, idx,
                         state.key_hi.new_full((num_evict,), e_hi)),
        scores=_set_drop(state.scores, idx,
                         state.scores.new_zeros(num_evict)))


# ---------------------------------------------------------------------------
# batch utilities
# ---------------------------------------------------------------------------


def dedup_last(keys: torch.Tensor, arrays=(), size: Optional[int] = None):
    """Deterministic last-occurrence-wins dedup for batch writes. Returns
    ``(unique_keys [size], picked)`` where ``picked[i]`` is ``arrays[i]``
    at each unique key's LAST occurrence in ``keys``."""
    flat = keys.reshape(-1)
    n = flat.shape[0]
    uniq, inverse = unique_static(flat, size=size)
    # jax.ops.segment_max: groups with no members read int32 min, then
    # clip; their uniq entry is the EMPTY fill, ignored at commit
    last = torch.full((uniq.shape[0],), _INT32_MIN, dtype=torch.int32,
                      device=flat.device).scatter_reduce(
        0, inverse.long(),
        torch.arange(n, dtype=torch.int32, device=flat.device), "amax")
    safe = last.clamp(0, n - 1).long()
    picked = tuple(a.reshape((n,) + tuple(a.shape[keys.dim():]))[safe]
                   for a in arrays)
    return uniq, picked


def unique_static(keys: torch.Tensor, size: Optional[int] = None, fill=None):
    """Static-shape dedup: ``(unique [size] padded with EMPTY, inverse
    [N])``, unique keys in ascending order. With ``size`` below the number
    of distinct keys the last unique slot holds an unspecified one of the
    surplus keys, as in the JAX version."""
    flat = keys.reshape(-1)
    n = flat.shape[0]
    size = size or n
    if fill is None:
        fill = hashing.empty_key_for(keys.dtype)
    sk, order = torch.sort(flat, stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=flat.device)
    is_start[1:] = sk[1:] != sk[:-1]
    gid = torch.cumsum(is_start.to(torch.int32), dim=0, dtype=torch.int32) - 1
    gid_c = gid.clamp(max=size - 1).long()
    sk_lo, sk_hi = split_key(sk)
    f_lo, f_hi = _split_int(int(fill))
    # every write to one index carries the same key (one group)
    u_lo = torch.full((size,), f_lo, dtype=torch.int32, device=flat.device)
    u_hi = torch.full((size,), f_hi, dtype=torch.int32, device=flat.device)
    u_lo[gid_c] = sk_lo
    u_hi[gid_c] = sk_hi
    uniq = join_key(u_lo, u_hi).to(flat.dtype)
    inverse = torch.empty(n, dtype=torch.int32, device=flat.device)
    inverse[order] = gid_c.to(torch.int32)
    return uniq, inverse.reshape(keys.shape)


def segment_sum_rows(g: torch.Tensor, seg: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``out[t] = sum(g[i] for seg[i] == t)``, rows with ``seg`` outside
    ``[0, num_segments)`` dropped: the grad combine over duplicate ids.
    The JAX package's one-hot matmul per 128-row chunk is a TPU matrix-unit
    device. Here the rows are sorted by segment and summed as differences
    of f64 prefix sums at the segments' ends: no atomics, so the same
    bits on every run (``index_add_``'s atomic adds order a segment's sum
    differently from run to run), and no segment is summed serially
    (an accumulating ``index_put_`` adds each segment's rows in one warp,
    which a zipf batch's hot id turns into thousands of steps). The f64
    prefix keeps each sum within an f32 rounding of the exact one; it is
    taken along the last axis (one parallel scan per column), since a
    scan along the first axis runs each column serially.

    f64 rows have no wider type for that prefix: each segment is summed
    on its own, in batch order (``torch.segment_reduce`` over the sorted
    rows, the same sequence of f64 additions on every device)."""
    seg = seg.reshape(-1).long()
    idx = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    srt, order = torch.sort(idx, stable=True)
    # segment t is sorted rows [bounds[t], bounds[t + 1]) (no host sync,
    # unlike a bincount's)
    bounds = torch.searchsorted(srt, torch.arange(num_segments + 1,
                                                  device=g.device))
    if g.dtype == torch.float64:
        return torch.segment_reduce(g[order], "sum", offsets=bounds, axis=0)
    cols = g[order].to(torch.float64).t().contiguous()  # [D, N]
    cs = torch.cat([cols.new_zeros((cols.shape[0], 1)),
                    cols.cumsum(dim=1)], dim=1)
    sums = cs[:, bounds[1:]] - cs[:, bounds[:-1]]
    return sums.to(g.dtype).t().contiguous()


def sorted_combine_batch(g: torch.Tensor, slot: torch.Tensor,
                         found: torch.Tensor):
    """Duplicate-grad combine for the OCCURRENCE contract (deferred
    dedup): ``(g [N, D], slot [N], found [N])``, one entry per batch
    occurrence -> ``(combined [N, D], rep [N])``. Each touched row's total
    gradient lands at one of its occurrences, its representative, the
    FIRST in batch order (``rep`` marks them); every other position
    holds zeros.

    The JAX package collapses 128-row chunks of the slot-sorted batch with
    one-hot matmuls (a TPU matrix-unit device) and carries groups across
    chunks with a scan. Here: a stable sort by slot makes duplicates
    adjacent, each group's first entry its first occurrence, and
    :func:`segment_sum_rows` adds every found occurrence onto its group's
    first (the same bits on every run)."""
    n = g.shape[0]
    dev = g.device
    sent = torch.iinfo(torch.int32).max
    sidx = torch.where(found, slot.to(torch.int32), sent)
    s_s, order = torch.sort(sidx, stable=True)
    is_start = torch.ones(n, dtype=torch.bool, device=dev)
    is_start[1:] = s_s[1:] != s_s[:-1]
    pos = torch.arange(n, device=dev)
    first = order[torch.cummax(torch.where(is_start, pos, 0), dim=0).values]
    live = s_s != sent
    tgt = torch.empty(n, dtype=torch.int64, device=dev)
    tgt[order] = torch.where(live, first, n)  # not found: dropped
    rep = torch.empty(n, dtype=torch.bool, device=dev)
    rep[order] = is_start & live
    return segment_sum_rows(g, tgt, n), rep


def dedup_sum(keys: torch.Tensor, arrays=(), size: Optional[int] = None):
    """Dedup with the payload rows SUMMED per key (duplicate accum deltas:
    each occurrence's delta is applied), in batch order as
    :func:`segment_sum_rows` adds. Returns ``(unique_keys [size],
    summed)``."""
    flat = keys.reshape(-1)
    n = flat.shape[0]
    uniq, inverse = unique_static(flat, size=size)
    u = uniq.shape[0]
    summed = []
    for a in arrays:
        tail = tuple(a.shape[keys.dim():])
        rows = a.reshape(n, -1)
        summed.append(segment_sum_rows(rows, inverse, u).reshape((u,) + tail))
    return uniq, tuple(summed)
