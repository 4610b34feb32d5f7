"""Sparse / ragged / multi-hot feature representations and their lookups
— the port of the JAX package's ``ops/sparse.py`` (the reference's
``embedding_lookup_sparse`` / ``safe_embedding_lookup_sparse`` and its
ragged lookups).

Every representation has a fixed number of entries:

* a padded-dense ``[B, L]`` id tensor (and optional ``[B, L]`` weights),
  padding marked with the EMPTY sentinel;
* :class:`SparseIds`, COO with a padded nnz (``tf.SparseTensor``);
* :class:`RaggedIds`, ``(values, row_splits)`` with a padded value buffer
  (``tf.RaggedTensor``).

All three normalize to ``(flat_ids, segment_ids, weights)`` and share one
combiner. A training lookup returns a :class:`SparseLookupContext`, whose
:meth:`~SparseLookupContext.row_gradient` takes the gradient of the
COMBINED output back to one gradient per looked-up id, computed from what
the context stores (no autograd graph is kept). Each lookup takes
``sharded=`` (a ``parallel.ShardedVariable`` of ``var``) to route its
rows through the shards; ``apply_sparse_gradients`` then takes it too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashing, segment
from recommenders_addons_tpu_torch.ops.variable import Variable


@dataclasses.dataclass
class SparseIds:
    """COO sparse ids with a fixed nnz; padding entries hold EMPTY.

    ``indices [NNZ, R]`` integer, ``values [NNZ]`` key dtype,
    ``dense_shape`` a tuple of ints."""

    indices: torch.Tensor
    values: torch.Tensor
    dense_shape: tuple

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    def row_ids(self) -> torch.Tensor:
        """All but the last dense dim collapsed into segment (row) ids."""
        shape = self.dense_shape
        rid = torch.zeros((self.nnz,), dtype=torch.int32,
                          device=self.values.device)
        if len(shape) == 1:
            return rid
        mults = np.cumprod([1] + list(shape[1:-1])[::-1])[::-1]
        for d in range(len(shape) - 1):
            rid = rid + self.indices[:, d].to(torch.int32) * int(mults[d])
        return rid

    @property
    def num_rows(self) -> int:
        return int(np.prod(self.dense_shape[:-1]))


@dataclasses.dataclass
class RaggedIds:
    """Ragged ids: ``values [NNZ]`` (entries past ``row_splits[-1]`` are
    padding) and ``row_splits [B+1]`` int32."""

    values: torch.Tensor
    row_splits: torch.Tensor

    @property
    def nnz(self) -> int:
        return self.values.shape[0]

    @property
    def nrows(self) -> int:
        return self.row_splits.shape[0] - 1

    def row_ids(self) -> torch.Tensor:
        # values[i] belongs to row r iff row_splits[r] <= i < row_splits[r+1]
        pos = torch.arange(self.nnz, dtype=torch.int32,
                           device=self.values.device)
        return (torch.searchsorted(self.row_splits.to(torch.int32), pos,
                                   right=True).to(torch.int32) - 1)

    def valid_mask(self) -> torch.Tensor:
        pos = torch.arange(self.nnz, dtype=torch.int32,
                           device=self.values.device)
        return pos < self.row_splits[-1]


@dataclasses.dataclass
class RaggedValues:
    """Ragged embedding rows, the output of
    :func:`embedding_lookup_ragged`: ``values [NNZ, D]`` and
    ``row_splits [B+1]``."""

    values: torch.Tensor
    row_splits: torch.Tensor

    @property
    def nrows(self) -> int:
        return self.row_splits.shape[0] - 1

    def to_padded(self, max_len: int, pad_value: float = 0.0):
        """``[B, max_len, D]`` dense view (longer rows truncated)."""
        b = self.nrows
        d = self.values.shape[-1]
        starts = self.row_splits[:-1].long()
        lens = self.row_splits[1:].long() - starts
        pos = torch.arange(max_len, device=starts.device)[None, :]
        idx = (starts[:, None] + pos).clamp(0, self.values.shape[0] - 1)
        out = self.values[idx.reshape(-1)].reshape(b, max_len, d)
        mask = pos < lens[:, None]
        return torch.where(mask[..., None], out,
                           torch.tensor(pad_value, dtype=out.dtype,
                                        device=out.device))


IdsLike = Union[torch.Tensor, SparseIds, RaggedIds]


def embedding_lookup_ragged(var: Variable, state, ragged_ids: RaggedIds, *,
                            training: bool = True, sharded=None):
    """Ragged-in, ragged-out lookup: each id's row, keeping the row
    splits. Returns ``(RaggedValues, ctx)`` when training (pass the
    gradient of ``out.values`` to ``apply_gradients``), else the
    ``RaggedValues``. Padding entries give zero rows."""
    lookup_obj = sharded if sharded is not None else var
    valid = ragged_ids.valid_mask()
    flat = torch.where(valid, ragged_ids.values, var.empty_key)
    if training:
        emb, ctx = lookup_obj.embedding_lookup(state, flat)
    else:
        emb = lookup_obj.lookup(state, flat)
    emb = torch.where(valid[:, None], emb, 0)
    out = RaggedValues(emb, ragged_ids.row_splits)
    return (out, ctx) if training else out


def ragged_fill_empty_rows(ragged: RaggedIds, default_value) -> tuple:
    """Rows with no VALID entry get one entry holding ``default_value``.

    Returns ``(RaggedIds, empty_row_indicator [B] bool)``. The output has
    ``nnz + nrows`` entries (the most it can need), padded with EMPTY and
    laid out row by row, so ``row_ids`` and the combiners work unchanged."""
    b, nnz = ragged.nrows, ragged.nnz
    dev = ragged.values.device
    empty = hashing.empty_key_for(ragged.values.dtype)
    valid = ragged.valid_mask() & (ragged.values != empty)
    rid = ragged.row_ids()
    counts = segment.segment_sum(valid.to(torch.int32), rid, b)
    is_empty = counts == 0
    # each row: its valid entries, then (if it has none) the fill entry
    new_lens = counts + is_empty.to(torch.int32)
    new_splits = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                            torch.cumsum(new_lens, 0).to(torch.int32)])
    rid_c = rid.clamp(0, b - 1).long()
    pos_in_row = (torch.arange(nnz, dtype=torch.int32, device=dev)
                  - ragged.row_splits[:-1].to(torch.int32)[rid_c])
    # invalid entries and rows that need no fill land on the last cell,
    # which is cut off
    out_pos = torch.where(valid, new_splits[rid_c] + pos_in_row, nnz + b)
    out_vals = torch.full((nnz + b + 1,), empty, dtype=ragged.values.dtype,
                          device=dev)
    out_vals[out_pos.long()] = ragged.values
    fill_pos = torch.where(is_empty, new_splits[:-1], nnz + b)
    out_vals[fill_pos.long()] = torch.tensor(
        default_value, dtype=ragged.values.dtype, device=dev)
    return RaggedIds(out_vals[:nnz + b], new_splits), is_empty


@dataclasses.dataclass
class SparseLookupContext:
    """Training residuals of a combined lookup: the inner row lookup's
    context and what the combiner's backward needs. The combined row of
    segment ``s`` is ``sum_i w[i] * e[i] / denom[s]`` over its entries
    (``denom`` None for ``sum``), replaced by the default row where
    ``row_has[s]`` is False (``safe_embedding_lookup_sparse``)."""

    inner: Any
    segment_ids: torch.Tensor  # [N] int32
    weights: torch.Tensor  # [N], 0 for padding and pruned entries
    num_rows: int
    denom: Optional[torch.Tensor] = None  # [num_rows], never 0
    row_has: Optional[torch.Tensor] = None  # [num_rows] bool

    def row_gradient(self, g_combined: torch.Tensor) -> torch.Tensor:
        """``[N, D]`` gradient per entry from the gradient of the combined
        output: ``w[i] * g[seg[i]] / denom[seg[i]]``, zero for rows that
        took the default and for entries outside ``[0, num_rows)``; the
        order of operations of the JAX package's ``jax.vjp``."""
        g = g_combined.reshape(self.num_rows, -1)
        if self.row_has is not None:
            g = torch.where(self.row_has[:, None], g, 0.0)
        if self.denom is not None:
            g = g / self.denom[:, None]
        seg = self.segment_ids.long()
        inside = (seg >= 0) & (seg < self.num_rows)
        rows = g[seg.clamp(0, self.num_rows - 1)]
        rows = torch.where(inside[:, None], rows, 0.0)
        return rows * self.weights.to(rows.dtype)[:, None]


def apply_sparse_gradients(lookup_obj, state, sctx: SparseLookupContext,
                           g_combined: torch.Tensor, optimizer, step=0,
                           epoch=0):
    """Optimizer step on the rows a combined lookup touched: the gradient
    of the combined output back through the combiner, then the ordinary
    sparse apply."""
    g_rows = sctx.row_gradient(g_combined)
    return lookup_obj.apply_gradients(state, sctx.inner, g_rows, optimizer,
                                      step=step, epoch=epoch)


def _normalize(var: Variable, ids: IdsLike, weights: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int,
                          Tuple[int, ...]]:
    """-> (flat_ids, segment_ids, weights, num_rows, out_batch_shape)."""
    empty = var.empty_key

    def ones(n, dev):
        return torch.ones((n,), dtype=var.value_dtype, device=dev)

    if isinstance(ids, SparseIds):
        flat = ids.values
        seg = ids.row_ids()
        nrows = ids.num_rows
        batch_shape = tuple(ids.dense_shape[:-1])
        w = weights if weights is not None else ones(flat.shape[0],
                                                     flat.device)
    elif isinstance(ids, RaggedIds):
        flat = ids.values
        seg = ids.row_ids()
        nrows = ids.nrows
        batch_shape = (nrows,)
        w = weights if weights is not None else ones(flat.shape[0],
                                                     flat.device)
        w = torch.where(ids.valid_mask(), w, 0.0)
        flat = torch.where(ids.valid_mask(), flat, empty)
    else:
        arr = torch.as_tensor(ids)
        if arr.dim() < 2:
            raise ValueError("padded-dense ids need shape [..., L]")
        batch_shape = tuple(arr.shape[:-1])
        nrows = int(np.prod(batch_shape))
        flat = arr.reshape(-1)
        seg = torch.arange(nrows, dtype=torch.int32,
                           device=flat.device).repeat_interleave(
                               arr.shape[-1])
        w = (weights.reshape(-1) if weights is not None
             else ones(flat.shape[0], flat.device))
    w = torch.where(flat != empty, w, 0.0)
    return flat, seg, w, nrows, batch_shape


def embedding_lookup_sparse(var: Variable, state, sp_ids: IdsLike,
                            sp_weights: Optional[torch.Tensor] = None,
                            combiner: str = "mean", *,
                            training: bool = True, sharded=None):
    """Weighted segment-combined lookup (the reference's
    ``embedding_lookup_sparse``). Returns ``(combined [batch_shape +
    (dim,)], SparseLookupContext)`` when training, else ``combined``."""
    lookup_obj = sharded if sharded is not None else var
    flat, seg, w, nrows, batch_shape = _normalize(var, sp_ids, sp_weights)
    w = w.to(var.value_dtype)
    if training:
        emb, ctx = lookup_obj.embedding_lookup(state, flat)
    else:
        emb = lookup_obj.lookup(state, flat)
    combined, denom = segment.combine_with_denominator(
        emb, seg, nrows, weights=w, combiner=combiner)
    combined = combined.reshape(batch_shape + (var.dim,))
    if not training:
        return combined
    return combined, SparseLookupContext(ctx, seg, w, nrows, denom)


def safe_embedding_lookup_sparse(var: Variable, state, sp_ids: IdsLike,
                                 sp_weights: Optional[torch.Tensor] = None,
                                 combiner: str = "mean",
                                 default_id: Optional[int] = None, *,
                                 training: bool = True, sharded=None):
    """The reference's ``safe_embedding_lookup_sparse``: negative ids and
    non-positive weights are pruned (masked to weight 0 and the EMPTY id,
    which the apply sends to the trash row), and a row left with no entry
    gets ``default_id``'s embedding (its initial row when missing and
    training), or zeros."""
    lookup_obj = sharded if sharded is not None else var
    flat, seg, w, nrows, batch_shape = _normalize(var, sp_ids, sp_weights)
    invalid = (flat < 0) | (w <= 0)
    w = torch.where(invalid, 0.0, w).to(var.value_dtype)
    flat = torch.where(invalid, var.empty_key, flat)
    row_has = segment.segment_sum((w > 0).to(torch.int32), seg, nrows) > 0
    if default_id is not None:
        dflt_ids = torch.full((nrows,), default_id, dtype=var.key_dtype,
                              device=flat.device)
        dflt = (sharded.lookup(state, dflt_ids) if sharded is not None
                else var.lookup(state, dflt_ids,
                                use_init_for_missing=training))
    else:
        dflt = torch.zeros((nrows, var.dim), dtype=var.value_dtype,
                           device=flat.device)
    if training:
        emb, ctx = lookup_obj.embedding_lookup(state, flat)
    else:
        emb = lookup_obj.lookup(state, flat)
    c, denom = segment.combine_with_denominator(emb, seg, nrows, weights=w,
                                                combiner=combiner)
    combined = torch.where(row_has[:, None], c, dflt).reshape(
        batch_shape + (var.dim,))
    if not training:
        return combined
    return combined, SparseLookupContext(ctx, seg, w, nrows, denom, row_has)


# ---------------------------------------------------------------------------
# de.math sparse-tensor helpers
# ---------------------------------------------------------------------------


def sparse_fill_empty_rows(sp: SparseIds, default_value, empty_key=None):
    """``tf.sparse.fill_empty_rows`` with a fixed nnz: rows with no entry
    get one (``default_value``); returns ``(new_sp,
    empty_row_indicator)``. The output has ``nnz + num_rows`` entries,
    padded with EMPTY."""
    if len(sp.dense_shape) != 2:
        raise ValueError("fill_empty_rows expects rank 2")
    b = sp.dense_shape[0]
    dev = sp.values.device
    if empty_key is None:
        empty_key = hashing.empty_key_for(sp.values.dtype)
    valid = sp.values != empty_key
    rid = sp.indices[:, 0].to(torch.int32)
    is_empty = segment.segment_sum(valid.to(torch.int32), rid, b) == 0
    fill_vals = torch.where(
        is_empty, torch.tensor(default_value, dtype=sp.values.dtype,
                               device=dev),
        torch.tensor(empty_key, dtype=sp.values.dtype, device=dev))
    fill_idx = torch.stack(
        [torch.arange(b, device=dev),
         torch.zeros((b,), dtype=torch.int64, device=dev)], dim=1)
    new_indices = torch.cat([sp.indices, fill_idx.to(sp.indices.dtype)])
    new_values = torch.cat([sp.values, fill_vals])
    return SparseIds(new_indices, new_values, sp.dense_shape), is_empty


def sparse_reshape(sp: SparseIds, new_shape) -> SparseIds:
    """``tf.sparse.reshape`` (row-major relabelling of the indices)."""
    old = tuple(sp.dense_shape)
    new_shape = tuple(int(x) for x in new_shape)
    if any(d == -1 for d in new_shape):
        known = int(np.prod([d for d in new_shape if d != -1]))
        infer = int(np.prod(old)) // known
        new_shape = tuple(infer if d == -1 else d for d in new_shape)
    if int(np.prod(old)) != int(np.prod(new_shape)):
        raise ValueError(f"cannot reshape {old} to {new_shape}")
    mult_old = np.cumprod([1] + list(old[::-1]))[::-1][1:]
    lin = torch.zeros((sp.nnz,), dtype=torch.int64,
                      device=sp.indices.device)
    for d in range(len(old)):
        lin = lin + sp.indices[:, d].to(torch.int64) * int(mult_old[d])
    mult_new = np.cumprod([1] + list(new_shape[::-1]))[::-1][1:]
    cols = [torch.div(lin, int(mult_new[d]), rounding_mode="floor")
            % new_shape[d] for d in range(len(new_shape))]
    new_indices = torch.stack(cols, dim=1).to(sp.indices.dtype)
    return SparseIds(new_indices, sp.values, new_shape)


def dense_to_sparse(padded: torch.Tensor, empty_key=None) -> SparseIds:
    """``[B, L]`` padded ids -> COO ``SparseIds`` (nnz = B*L). Padding
    stays in place as EMPTY values (``empty_key`` is accepted for the JAX
    package's signature)."""
    del empty_key
    b, l = padded.shape
    dev = padded.device
    rows = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(l)
    cols = torch.arange(l, dtype=torch.int32, device=dev).repeat(b)
    return SparseIds(torch.stack([rows, cols], dim=1), padded.reshape(-1),
                     (b, l))
