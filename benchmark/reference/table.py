"""A plain model of the dynamic table's documented semantics, over the
buckets that the checked steps touch.

A key lives in one bucket of ``bucket_size`` slots (:mod:`.hashing`). A
write of new keys fills the bucket's free slots, then evicts its
lowest-scored keys that this write does not itself touch; keys beyond
what the bucket can take are dropped, the last in
:func:`hashing.order_in_bucket` order. Scores are assigned, not added (the
LRU policy: a touched key takes the step's stamp).

The model keeps, for the modelled buckets only, the resident keys and
their scores. It refuses (``AmbiguousEviction``) to decide an eviction
between keys of equal score, or a drop where the write order is not the
documented one: the benchmark's inputs are built so that neither happens.
"""

from __future__ import annotations

import torch

from benchmark.reference import hashing


class AmbiguousEviction(RuntimeError):
    """An eviction or drop that the documented semantics leave open."""


def _rank_in_group(group: torch.Tensor, order_key: torch.Tensor):
    """Rank of each element within its group, ascending by ``order_key``
    (groups and keys int64; ties in ``order_key`` keep input order)."""
    n = group.shape[0]
    if n == 0:
        return group.clone()
    o1 = torch.sort(order_key, stable=True).indices
    o2 = torch.sort(group[o1], stable=True).indices
    order = o1[o2]
    g = group[order]
    idx = torch.arange(n, device=group.device)
    start = torch.ones(n, dtype=torch.bool, device=group.device)
    start[1:] = g[1:] != g[:-1]
    first = torch.cummax(torch.where(start, idx, 0), dim=0).values
    rank = torch.empty(n, dtype=torch.int64, device=group.device)
    rank[order] = idx - first
    return rank


class BucketTable:
    """Resident keys and scores of the modelled buckets (``buckets``: a
    bool mask over all ``num_buckets``)."""

    def __init__(self, num_buckets: int, bucket_size: int,
                 buckets: torch.Tensor):
        self.num_buckets = num_buckets
        self.bucket_size = bucket_size
        self.modelled = buckets
        dev = buckets.device
        self.keys = torch.empty(0, dtype=torch.int64, device=dev)  # sorted
        self.scores = torch.empty(0, dtype=torch.int64, device=dev)

    def bucket(self, keys: torch.Tensor) -> torch.Tensor:
        return hashing.bucket_of(keys, self.num_buckets)

    def in_model(self, keys: torch.Tensor) -> torch.Tensor:
        return self.modelled[self.bucket(keys)]

    def find(self, keys: torch.Tensor):
        """``(resident [N] bool, score [N])`` of keys of modelled buckets."""
        if self.keys.numel() == 0:
            z = torch.zeros_like(keys)
            return z.bool(), z
        pos = torch.searchsorted(self.keys, keys).clamp(
            max=self.keys.numel() - 1)
        hit = self.keys[pos] == keys
        return hit, torch.where(hit, self.scores[pos], 0)

    def write(self, new: torch.Tensor, score: torch.Tensor,
              touched: torch.Tensor, drop_order: str = "mix"):
        """Insert the unique, non-resident keys ``new`` with ``score``
        ([M] int64), evicting by lowest score among resident keys not in
        ``touched`` (this write's own resident keys). ``drop_order``:
        ``"mix"`` ranks a bucket's new keys by
        :func:`hashing.order_in_bucket`; ``"none"`` refuses any drop.
        Returns which of ``new`` were inserted ([M] bool)."""
        dev = new.device
        nb, bsz = self.num_buckets, self.bucket_size
        if not bool(self.in_model(new).all()):
            raise ValueError("a write to a bucket outside the model")
        b_new = self.bucket(new)
        b_res = self.bucket(self.keys)
        claimed = self._member(self.keys, touched)
        count = torch.bincount(b_res, minlength=nb)
        evictable = torch.bincount(b_res[~claimed], minlength=nb)
        free = bsz - count
        room = free + evictable
        rank = _rank_in_group(b_new, hashing.order_in_bucket(new, nb))
        dropped = rank >= room[b_new]
        if bool(dropped.any()) and drop_order == "none":
            raise AmbiguousEviction("a bucket cannot hold this write")
        inserted = ~dropped
        n_ins = torch.bincount(b_new[inserted], minlength=nb)
        n_evict = (n_ins - free).clamp(min=0)
        cand = (~claimed) & (n_evict[b_res] > 0)
        ci = torch.nonzero(cand).reshape(-1)
        evict_mask = torch.zeros_like(claimed)
        if ci.numel():
            cb, cs = b_res[ci], self.scores[ci]
            r = _rank_in_group(cb, cs)
            ev = r < n_evict[cb]
            # the last evicted and the first kept of a bucket must differ
            last_ev = torch.full((nb,), -(1 << 62), dtype=torch.int64,
                                 device=dev)
            last_ev.scatter_reduce_(0, cb[ev], cs[ev], "amax")
            first_kept = torch.full((nb,), 1 << 62, dtype=torch.int64,
                                    device=dev)
            first_kept.scatter_reduce_(0, cb[~ev], cs[~ev], "amin")
            if bool((last_ev == first_kept).any()):
                raise AmbiguousEviction("an eviction between equal scores")
            evict_mask[ci[ev]] = True
        keep = ~evict_mask
        keys = torch.cat([self.keys[keep], new[inserted]])
        scores = torch.cat([self.scores[keep], score[inserted]])
        order = torch.argsort(keys)
        self.keys, self.scores = keys[order], scores[order]
        return inserted

    def stamp(self, keys: torch.Tensor, score: int) -> None:
        """Assign ``score`` to the resident ``keys``."""
        hit = self._member(self.keys, keys)
        self.scores = torch.where(hit, torch.full_like(self.scores, score),
                                  self.scores)

    @staticmethod
    def _member(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Whether each element of ``a`` is in ``b`` ([len(a)] bool)."""
        if b.numel() == 0 or a.numel() == 0:
            return torch.zeros(a.shape, dtype=torch.bool, device=a.device)
        b = torch.sort(b).values
        pos = torch.searchsorted(b, a).clamp(max=b.numel() - 1)
        return b[pos] == a
