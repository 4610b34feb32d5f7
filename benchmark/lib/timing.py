"""Timing arithmetic (frozen copies of what the port's chip smoke had
sound: step times from CUDA events on the stream, synchronizing calls
counted with torch.cuda's sync debug mode) and the window's batch feed.

Nothing here adds a host sync inside the window: the feed records one
event on the stream before each batch it hands out, and the events are
read once the window has closed.
"""

from __future__ import annotations

import time
import warnings
from typing import List, Optional

import torch


class Feed:
    """Batches ``first, first + 1, ...`` of a pool, handed to
    ``train_loop``, until ``deadline`` (host clock) or ``steps`` batches.
    On a card, one timing event is recorded before each batch."""

    def __init__(self, pool, first: int, deadline: Optional[float] = None,
                 steps: Optional[int] = None, events: bool = True):
        self.pool, self.next = pool, first
        self.deadline, self.steps = deadline, steps
        self.events: List = []
        self.timed = events and torch.cuda.is_available()
        self.served = 0

    def __iter__(self):
        while True:
            if self.steps is not None and self.served >= self.steps:
                return
            if (self.deadline is not None
                    and time.perf_counter() >= self.deadline):
                return
            if self.timed:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events.append(e)
            batch = self.pool[self.next]
            self.next += 1
            self.served += 1
            yield batch

    def close(self) -> None:
        """Mark the end of the last step (after the loop's final read)."""
        if self.timed:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events.append(e)

    def step_ms(self) -> List[float]:
        """Each step's time on the stream: from its batch's event to the
        next one (call after :meth:`close` and a synchronize)."""
        ev = self.events
        return [a.elapsed_time(b) for a, b in zip(ev[:-1], ev[1:])]


def count_syncs(fn):
    """``fn()``'s result and how many synchronizing CUDA operations it ran
    (the sync debug mode warns once per such operation)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n = sum("synchroniz" in str(w.message) for w in caught)
    return out, n


def percentile(values: List[float], q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between
    closest ranks, as numpy's default."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)
