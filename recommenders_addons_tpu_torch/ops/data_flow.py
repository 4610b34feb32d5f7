"""`de.data_flow`: ``dynamic_partition`` / ``dynamic_stitch`` — the port
of the JAX package's ``ops/data_flow.py``.

Public reference API (the reference's ``data_flow_ops``); no training or
serving path of the port uses them. Fixed-shape contract, as in the JAX
package: ``dynamic_partition`` returns a dense ``[num_partitions, N, ...]``
stack (each partition's entries first, in their original order, the rest
zeros) with per-partition counts, instead of a ragged list.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from recommenders_addons_tpu_torch.ops import hashtable, segment


def dynamic_partition(data: torch.Tensor, partitions: torch.Tensor,
                      num_partitions: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> ``(parts [P, N, ...], counts [P], scatter_pos [N])``.

    ``parts[p, :counts[p]]`` are the rows of ``data`` with
    ``partitions == p`` in their original order; ``scatter_pos[i]`` is row
    i's flat position ``p * N + rank``, which
    :func:`dynamic_stitch_flat` inverts."""
    n = data.shape[0]
    p = partitions.to(torch.int32)
    # its rank among the rows of its partition, in batch order (a stable
    # sort, as the JAX package's two-argument _segment_rank)
    rank = hashtable._segment_rank(p)
    pos = p * n + rank
    parts = torch.zeros((num_partitions * n,) + tuple(data.shape[1:]),
                        dtype=data.dtype, device=data.device)
    parts[pos.long()] = data
    counts = segment.segment_sum(
        torch.ones((n,), dtype=torch.int32, device=data.device), p,
        num_partitions)
    return (parts.reshape((num_partitions, n) + tuple(data.shape[1:])),
            counts, pos)


def dynamic_stitch_flat(parts: torch.Tensor, scatter_pos: torch.Tensor,
                        n: int) -> torch.Tensor:
    """Inverse of :func:`dynamic_partition` (positions are unique, so no
    duplicate resolution is needed)."""
    del n
    flat = parts.reshape((-1,) + tuple(parts.shape[2:]))
    return flat[scatter_pos.long()]


def dynamic_stitch(indices: Sequence[torch.Tensor],
                   data: Sequence[torch.Tensor],
                   size: Optional[int] = None) -> torch.Tensor:
    """TF ``dynamic_stitch``: ``out[indices[i][j]] = data[i][j]``, the last
    write to an index winning (later lists over earlier ones, and later
    entries within a list). Without ``size`` the output length is read
    from the indices, a host sync (TF's own contract). Each index is
    written once, by its winning entry, so the result is the same on every
    run."""
    if size is None:
        size = max(int(i.max()) for i in indices if i.numel()) + 1
    idx = torch.cat([i.reshape(-1).long() for i in indices])
    vals = torch.cat([d.reshape((-1,) + tuple(data[0].shape[1:]))
                      for d in data])
    m = idx.shape[0]
    srt, order = torch.sort(idx, stable=True)
    last = torch.ones(m, dtype=torch.bool, device=idx.device)
    last[:-1] = srt[1:] != srt[:-1]
    win = order[last]
    out = torch.zeros((int(size),) + tuple(data[0].shape[1:]),
                      dtype=data[0].dtype, device=data[0].device)
    out[idx[win]] = vals[win]
    return out
