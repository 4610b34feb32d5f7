"""Profiling helpers — the port of the JAX package's
``utils/profiling.py``: ``torch.profiler`` in place of ``jax.profiler``.

``trace(path)`` records the host and the card around a block and writes a
Chrome trace (``chrome://tracing``, Perfetto) under the directory
``path``; ``annotate`` and ``named_scope`` open a named range in it;
``StepTimer`` times steps on the host clock, synchronising the card first.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(path: str):
    """Profile the block (CPU activity, and CUDA activity when a card is
    present) and write ``<path>/trace-<pid>-<ns>.json``. Yields the
    ``torch.profiler.profile``; its ``trace_path`` attribute names the
    file once the block ends."""
    os.makedirs(path, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.trace_path = os.path.join(
            path, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)


# named ranges on the host timeline (and, under a trace, around the card
# work they launch)
annotate = torch.profiler.record_function
named_scope = torch.profiler.record_function


class StepTimer:
    """Wall-clock step timing; ``stop(sync_tensor)`` waits for the card of
    ``sync_tensor`` before it reads the clock."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync_tensor=None):
        if (isinstance(sync_tensor, torch.Tensor)
                and sync_tensor.device.type == "cuda"):
            torch.cuda.synchronize(sync_tensor.device)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean_ms(self) -> float:
        return 1e3 * sum(self.times) / max(len(self.times), 1)
