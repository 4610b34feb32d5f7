"""Table observability, the port of the JAX package's ``utils/metrics.py``
(the reference exposes ``Variable.size()`` and ``export_keys_and_scores``;
this is a superset)."""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashtable


@dataclasses.dataclass
class TableStats:
    capacity: int
    live: int
    load_factor: float
    bucket_p50: float
    bucket_p99: float
    bucket_max: int
    full_buckets: int
    score_min: int
    score_max: int

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def table_stats(spec: hashtable.TableSpec,
                state: hashtable.TableState) -> TableStats:
    """Occupancy, bucket skew and score range (on the host: one copy of
    the occupancy mask and the score column)."""
    mask = hashtable.occupancy_mask(spec, state).cpu().numpy()
    scores = state.scores.cpu().numpy()
    per_bucket = mask.reshape(spec.num_buckets, spec.bucket_size).sum(1)
    live = int(mask.sum())
    live_scores = scores[mask] if live else np.zeros((1,), scores.dtype)
    return TableStats(
        capacity=spec.capacity,
        live=live,
        load_factor=live / spec.capacity,
        bucket_p50=float(np.percentile(per_bucket, 50)),
        bucket_p99=float(np.percentile(per_bucket, 99)),
        bucket_max=int(per_bucket.max()),
        full_buckets=int((per_bucket == spec.bucket_size).sum()),
        score_min=int(live_scores.min()),
        score_max=int(live_scores.max()),
    )


def lookup_hit_rate(ctx) -> torch.Tensor:
    """Fraction of the (non-padding) unique keys a training lookup found,
    as a 0-d device tensor (no host sync)."""
    valid = ctx.unique_keys != torch.iinfo(torch.int64).min
    hits = (ctx.found & valid).sum()
    return hits / valid.sum().clamp(min=1)
