"""The traced run's readings: a few steps under ``torch.profiler`` with
the harness's own ranges around the table's two calls, and what the
per-layer metric readers (``benchmark/metrics/``) read from them.

The ranges are installed from here, by wrapping ``Variable``'s
``embedding_lookup`` and ``apply_gradients`` for the traced steps only;
the port's source is not touched. A range's device time is that of the
kernels launched inside it (its host-side entry in ``key_averages``).
The device timeline (busy time, idle gaps, the top operations) comes from
the trace's device events: kernels, copies and fills, not the ranges'
device-side copies.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

LOOKUP_RANGE = "bench.table.lookup"
APPLY_RANGE = "bench.table.apply"
RANGES = (LOOKUP_RANGE, APPLY_RANGE)


@dataclasses.dataclass
class TraceRun:
    """What the per-layer readers get. Times in seconds over the traced
    steps unless a name says otherwise."""

    cfg: dict
    mix: dict
    device_kind: str
    steps: int  # traced steps
    window_s: float  # host clock over the traced steps
    busy_s: float  # union of device operations' intervals
    device_ops: Dict[str, float]  # device seconds by operation name
    range_device_s: Dict[str, float]  # device seconds under each range
    hit_share: List[float]  # the port's lookup_hit_rate, per traced step
    inserted: List[int]  # keys each traced step's lookup inserted
    unique_keys: List[int]  # distinct keys of each traced step's batch
    step_ms_untraced: Optional[float]  # mean step, events, no profiler
    syncs_per_step: Optional[float]
    idle_gaps: List[Tuple[str, float]]

    def kernel_s(self, pattern: str) -> float:
        """Device seconds of the operations whose name holds
        ``pattern``."""
        return sum(s for name, s in self.device_ops.items()
                   if pattern in name)


@contextlib.contextmanager
def table_ranges(counters: dict):
    """Wrap the table's lookup and apply in ``record_function`` ranges,
    and record in ``counters`` each lookup's hit share and inserts (the
    port's own counters, kept on the device)."""
    from torch.profiler import record_function

    from recommenders_addons_tpu_torch.ops.variable import Variable
    from recommenders_addons_tpu_torch.utils.metrics import lookup_hit_rate

    lookup, apply = Variable.embedding_lookup, Variable.apply_gradients

    def wrapped_lookup(self, *a, **kw):
        with record_function(LOOKUP_RANGE):
            emb, ctx = lookup(self, *a, **kw)
        counters["hit"].append(lookup_hit_rate(ctx))
        counters["inserted"].append(
            ctx.inserted.sum() if ctx.inserted is not None
            else torch.zeros((), device=ctx.found.device))
        return emb, ctx

    def wrapped_apply(self, *a, **kw):
        with record_function(APPLY_RANGE):
            return apply(self, *a, **kw)

    Variable.embedding_lookup = wrapped_lookup
    Variable.apply_gradients = wrapped_apply
    try:
        yield
    finally:
        Variable.embedding_lookup = lookup
        Variable.apply_gradients = apply


def _device_intervals(events):
    """Device operations as ``(name, start_us, end_us)``, without the
    ranges' device-side copies."""
    from torch.autograd import DeviceType

    out = []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        if getattr(e, "is_user_annotation", False) or e.name in RANGES:
            continue
        out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def _union(intervals) -> Tuple[float, List[Tuple[float, float]]]:
    """Total covered length and the merged intervals."""
    merged = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def _idle_gaps(events, merged, t_end_us: float, top: int = 10):
    """The device's idle time in the window, summed by what the host was
    doing at each gap's middle: the innermost host operation there, with
    the harness range it sits in."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    if not host:
        return []
    starts = np.array([e.time_range.start for e in host])
    ends = np.array([e.time_range.end for e in host])
    names = [e.name for e in host]
    in_range = np.array([n in RANGES for n in names])
    gaps = []
    prev = 0.0
    for s, e in merged + [[t_end_us, t_end_us]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    totals: Dict[str, float] = {}
    for a, b in gaps:
        mid = (a + b) / 2
        cover = (starts <= mid) & (ends >= mid)
        label = "host outside any operation"
        if cover.any():
            idx = np.nonzero(cover)[0]
            inner = idx[np.argmax(starts[idx])]
            label = names[inner]
            rng = idx[in_range[idx]]
            if rng.size and not in_range[inner]:
                label += " in " + names[rng[np.argmax(starts[rng])]]
        totals[label] = totals.get(label, 0.0) + (b - a) / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:top]


def profile_steps(step_loop):
    """Run ``step_loop()`` (which drives the traced steps and ends with a
    read of the last loss) under the profiler. Returns ``(result,
    window_s, busy_s, device_ops, range_device_s, idle_gaps, counters)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counters = {"hit": [], "inserted": []}
    activities = [ProfilerActivity.CPU]
    if torch.version.cuda is not None:  # a build that can see a card
        activities.append(ProfilerActivity.CUDA)
    torch.cuda.synchronize()
    with table_ranges(counters):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            result = step_loop()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
    events = prof.events()
    dev = _device_intervals(events)
    busy_us, merged = _union(dev)
    ops: Dict[str, float] = {}
    for name, s, e in dev:
        ops[name] = ops.get(name, 0.0) + (e - s) / 1e6
    t_end = max([e.time_range.end for e in events] + [0.0])
    ranges = {r: 0.0 for r in RANGES}
    for e in prof.key_averages():
        if e.key in RANGES and e.device_type == DeviceType.CPU:
            ranges[e.key] += e.device_time_total / 1e6
    gaps = _idle_gaps(events, merged, t_end)
    hits = [float(h) for h in counters["hit"]]
    ins = [int(i) for i in counters["inserted"]]
    return (result, window_s, busy_us / 1e6, ops, ranges, gaps,
            {"hit": hits, "inserted": ins})
