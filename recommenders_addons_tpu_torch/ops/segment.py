"""`de.math` segment reductions — the port of the JAX package's
``ops/segment.py`` (TF semantics: the mean and sqrtn denominators, zero
rows for empty segments, segment ids outside ``[0, num_segments)``
dropped).

Every float sum goes through :func:`hashtable.segment_sum_rows` (a sort
and f64 prefix sums, no atomics and no host sync): the same bits on
every run, on the card as on the CPU. 1-D float data (the weight
denominators) takes it as one ``[N, 1]`` column; float ``index_add_``
on CUDA adds in no fixed order. Integer data (counts) is summed with
``scatter_add_``, which is exact in any order; ``torch.bincount`` would
read its length back to the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from recommenders_addons_tpu_torch.ops import hashtable


def _row_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                     num_segments: int) -> torch.Tensor:
    """``out[t] = sum(data[i] for segment_ids[i] == t)`` for data of any
    trailing shape, ids outside ``[0, num_segments)`` dropped."""
    n = data.shape[0]
    tail = tuple(data.shape[1:])
    if data.is_floating_point():
        out = hashtable.segment_sum_rows(data.reshape(n, -1), segment_ids,
                                         num_segments)
        return out.reshape((num_segments,) + tail)
    seg = segment_ids.reshape(-1).long()
    idx = torch.where((seg >= 0) & (seg < num_segments), seg, num_segments)
    out = torch.zeros((num_segments + 1,) + tail, dtype=data.dtype,
                      device=data.device)
    idx = idx.reshape((n,) + (1,) * len(tail)).expand(data.shape)
    return out.scatter_add_(0, idx, data)[:num_segments]


def segment_sum(data, segment_ids, num_segments: int):
    return _row_segment_sum(data, segment_ids, num_segments)


def sparse_segment_sum(data: torch.Tensor, indices: torch.Tensor,
                       segment_ids: torch.Tensor,
                       num_segments: Optional[int] = None):
    """TF ``sparse.segment_sum``: gather ``data`` rows at ``indices`` then
    segment-sum. ``num_segments`` is required, as in the JAX package
    (static output shapes)."""
    if num_segments is None:
        raise ValueError(
            "num_segments is required (static shapes, as in the JAX "
            "package); the reference's dynamic variant has no analog")
    return _row_segment_sum(data[indices.long()], segment_ids,
                            int(num_segments))


def _counts(segment_ids: torch.Tensor, num_segments: int, dtype):
    ones = torch.ones(segment_ids.shape, dtype=dtype,
                      device=segment_ids.device)
    return _row_segment_sum(ones, segment_ids, num_segments)


def sparse_segment_mean(data, indices, segment_ids, num_segments: int):
    s = sparse_segment_sum(data, indices, segment_ids, num_segments)
    cnt = _counts(segment_ids, num_segments, data.dtype)
    return s / cnt.clamp(min=1.0)[..., None]


def sparse_segment_sqrt_n(data, indices, segment_ids, num_segments: int):
    s = sparse_segment_sum(data, indices, segment_ids, num_segments)
    cnt = _counts(segment_ids, num_segments, data.dtype)
    return s / torch.sqrt(cnt.clamp(min=1.0))[..., None]


def combine_denominator(weights: torch.Tensor, segment_ids: torch.Tensor,
                        num_segments: int, combiner: str):
    """The per-segment divisor of a ``mean`` or ``sqrtn`` combine, 1
    where a segment's weights sum to 0 (its combined row stays zero);
    None for ``sum``."""
    if combiner == "sum":
        return None
    if combiner == "mean":
        denom = _row_segment_sum(weights, segment_ids, num_segments)
    elif combiner == "sqrtn":
        denom = torch.sqrt(_row_segment_sum(weights * weights, segment_ids,
                                            num_segments))
    else:
        raise ValueError(f"combiner must be sum|mean|sqrtn, got {combiner}")
    return torch.where(denom > 0, denom, 1.0)


def weighted_segment_combine(rows: torch.Tensor, segment_ids: torch.Tensor,
                             num_segments: int,
                             weights: Optional[torch.Tensor] = None,
                             combiner: str = "mean"):
    """The combiner core of ``embedding_lookup_sparse``: sum / mean /
    sqrtn of ``rows [N, D]`` with optional ``weights [N]``; empty segments
    give zero rows."""
    return combine_with_denominator(rows, segment_ids, num_segments,
                                    weights, combiner)[0]


def combine_with_denominator(rows: torch.Tensor, segment_ids: torch.Tensor,
                             num_segments: int,
                             weights: Optional[torch.Tensor] = None,
                             combiner: str = "mean"):
    """:func:`weighted_segment_combine` that also returns the
    :func:`combine_denominator` it divided by, for the lookup's backward."""
    if weights is None:
        weights = torch.ones(segment_ids.shape, dtype=rows.dtype,
                             device=rows.device)
    weights = weights.to(rows.dtype)
    denom = combine_denominator(weights, segment_ids, num_segments, combiner)
    ws = _row_segment_sum(rows * weights[:, None], segment_ids,
                          num_segments)
    return (ws if denom is None else ws / denom[:, None]), denom
