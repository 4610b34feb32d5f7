"""Host-driven training loop — the port of the JAX package's
``train/loop.py`` (``LoopConfig``, ``LoopReport``, ``train_loop``).

PyTorch runs eagerly, so the JAX loop's ``jit`` and buffer donation have
nothing to do here: both arguments are accepted and have no effect (the
port's table state is updated in place anyway). What stays is the
prefetch: ``prefetch`` batches are copied host -> device ahead of the
step that uses them (from pinned memory, without blocking, on CUDA), and
metrics stay on the device until a log boundary reads them.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Iterable, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass
class LoopConfig:
    """Knobs for :func:`train_loop`."""

    steps: int = 1000
    log_every: int = 100  # fetch + report metrics every N steps (0 = never)
    checkpoint_every: int = 0  # call checkpoint_fn every N steps (0 = off)
    prefetch: int = 2  # device batches kept in flight ahead of compute
    donate: bool = True  # no effect here (the JAX loop donates buffers)


@dataclasses.dataclass
class LoopReport:
    """What :func:`train_loop` returns besides the final state."""

    steps: int = 0
    last_metrics: Any = None
    history: list = dataclasses.field(default_factory=list)
    wall_s: float = 0.0
    steps_per_sec: float = 0.0


def _to_device(batch, device: torch.device):
    """A batch (a dict, list or tuple of arrays) on ``device``."""
    if isinstance(batch, dict):
        return {k: _to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_to_device(v, device) for v in batch)
    t = torch.from_numpy(batch) if isinstance(batch, np.ndarray) else batch
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _device_prefetch(batches: Iterable, depth: int, device: torch.device):
    """Stage up to ``depth`` batches on ``device`` ahead of consumption."""
    buf = collections.deque()
    it = iter(batches)
    try:
        while True:
            while len(buf) <= depth:
                buf.append(_to_device(next(it), device))
            yield buf.popleft()
    except StopIteration:
        while buf:
            yield buf.popleft()


def _fetch(metrics):
    if isinstance(metrics, dict):
        return {k: _fetch(v) for k, v in metrics.items()}
    return float(metrics)


def train_loop(step_fn: Callable, state, batches: Iterable,
               config: Optional[LoopConfig] = None, *,
               checkpoint_fn: Optional[Callable] = None,
               on_log: Optional[Callable] = None, jit: bool = True,
               device=None):
    """Run ``step_fn(state, batch) -> (state, metrics)`` for
    ``config.steps`` steps (or until ``batches`` is exhausted), with each
    batch moved to ``device`` (default CUDA) ahead of its step.

    ``metrics`` (a tensor or a dict of tensors) is read back only at
    ``log_every`` boundaries and passed to ``on_log(step, metrics)``;
    ``checkpoint_fn(state, step)`` runs every ``checkpoint_every`` steps
    and after the last. ``jit`` has no effect (see the module docstring).

    Returns ``(final_state, LoopReport)``."""
    del jit
    cfg = config or LoopConfig()
    dev = resolve_device(device)
    report = LoopReport()
    metrics = None
    t0 = time.perf_counter()
    step = 0
    for step, batch in enumerate(_device_prefetch(batches, cfg.prefetch,
                                                  dev), start=1):
        state, metrics = step_fn(state, batch)
        if cfg.log_every and step % cfg.log_every == 0:
            fetched = _fetch(metrics)
            report.history.append((step, fetched))
            report.last_metrics = fetched
            if on_log is not None:
                on_log(step, fetched)
        if (checkpoint_fn is not None and cfg.checkpoint_every
                and step % cfg.checkpoint_every == 0):
            checkpoint_fn(state, step)
        if step >= cfg.steps:
            break
    if metrics is not None:  # the final read waits for the last step
        report.last_metrics = _fetch(metrics)
    report.wall_s = time.perf_counter() - t0
    report.steps = step
    report.steps_per_sec = step / max(report.wall_s, 1e-9)
    if checkpoint_fn is not None and cfg.checkpoint_every and step:
        checkpoint_fn(state, step)
    return state, report
