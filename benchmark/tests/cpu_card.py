"""A stand-in for the card in the CPU tests: the ``torch.cuda`` calls that
a run makes (synchronize, timing events, the sync debug mode, the memory
peak) made harmless, so that a whole run of a small configuration goes
through the port's plain versions on the CPU. No number it gives is a
device number."""

from __future__ import annotations

import contextlib
import time
from unittest import mock

import torch


class _Event:
    def __init__(self, enable_timing: bool = False):
        self.t = None

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def elapsed_time(self, other: "_Event") -> float:
        return (other.t - self.t) * 1e3


@contextlib.contextmanager
def cpu_card():
    with contextlib.ExitStack() as stack:
        for name, value in (("synchronize", lambda *a, **k: None),
                            ("Event", _Event),
                            ("is_available", lambda: True),
                            ("set_sync_debug_mode", lambda *a, **k: None),
                            ("max_memory_allocated", lambda *a, **k: 0),
                            ("reset_peak_memory_stats",
                             lambda *a, **k: None),
                            ("empty_cache", lambda: None)):
            stack.enter_context(mock.patch.object(torch.cuda, name, value))
        yield
