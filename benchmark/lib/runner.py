"""One run of one cell: set-up (the system, its prefill, the batch pool,
the three checked steps, warm-up), then either the timed window
(``--trace 0``: the end-to-end metrics) or the traced steps (``--trace
1``: the per-layer metrics), then the check that decides ``correct``.

:func:`setup`, :func:`window`, :func:`traced` and :func:`judge` take the
device as an argument, so that the CPU tests can drive a whole run of a
small configuration through the port's plain versions.
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.lib import check, inputs, timing
from benchmark.lib.trainer import Trainer
from benchmark.reference import train as ref_train


@dataclasses.dataclass
class Session:
    cfg: dict
    mix: dict
    seed: int
    device: torch.device
    trainer: Trainer
    plan: inputs.Prefill
    pool: inputs.Pool
    weights: Dict[str, torch.Tensor]
    readings: check.Readings
    next_batch: int
    check_s: float  # time spent reading the program's state for the check
    stages: Dict[str, float] = dataclasses.field(default_factory=dict)


def _loop(session: Session, steps: Optional[int] = None,
          deadline: Optional[float] = None, events: bool = False):
    """Drive the window's call: ``train_loop`` over the trainer's step,
    fed from the pool. Returns ``(feed, report)``."""
    from recommenders_addons_tpu_torch.train.loop import LoopConfig, train_loop

    feed = timing.Feed(session.pool, session.next_batch, deadline=deadline,
                       steps=steps, events=events)
    cfg = LoopConfig(steps=steps if steps is not None else 1 << 40,
                     log_every=0, prefetch=0)
    carry, report = train_loop(session.trainer.step_fn,
                               session.trainer.carry, feed, cfg,
                               device=session.device)
    feed.close()
    session.trainer.carry = carry
    session.next_batch = feed.next
    return feed, report


def setup(cfg, mix, seed: int, device, pool_batches: int,
          plant: Optional[Callable] = None) -> Session:
    """Everything before the window. ``plant(trainer)`` may break the
    system under test (the fault tests)."""
    device = torch.device(device)
    stages, t = {}, time.perf_counter()

    def stage(name):
        nonlocal t
        if device.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t
        t = now

    trainer = Trainer(cfg, device, seed)
    if plant is not None:
        plant(trainer)
    weights = inputs.dense_weights(cfg, seed, device)
    trainer.load_weights(weights)
    stage("model_and_table")
    plan = inputs.prefill(cfg, mix, device)
    trainer.prefill(plan, seed)
    stage("prefill")
    pool = inputs.Pool(cfg, mix, seed, pool_batches, device)
    stage("pool")
    s = Session(cfg=cfg, mix=mix, seed=seed, device=device, trainer=trainer,
                plan=plan, pool=pool, weights=weights, readings=None,
                next_batch=0, check_s=0.0, stages=stages)
    # the checked steps: the window's own call, one step at a time
    shift, nsteps = cfg["feature_shift"], int(mix["check_steps"])
    keys = [inputs.tag(pool[k]["sparse"], shift).reshape(-1)
            for k in range(nsteps)]
    losses = []
    for k in range(nsteps):
        _, report = _loop(s, steps=1)
        losses.append(float(report.last_metrics))
        t0 = time.perf_counter()
        if k == 0:
            keys1 = torch.unique(keys[0])
            f1, v1, a1 = trainer.rows(keys1)
            acc1 = trainer.dense_accumulators()
        s.check_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    keys3 = torch.unique(torch.cat(keys))
    f3, v3, _ = trainer.rows(keys3)
    s.readings = check.Readings(
        losses=losses, dense_acc1=acc1, dense3=trainer.dense_values(),
        keys1=keys1, found1=f1, values1=v1, acc1=a1, keys3=keys3,
        found3=f3, values3=v3, planes3=trainer.planes())
    s.check_s += time.perf_counter() - t0
    stage("checked_steps")
    stages["checked_steps"] -= s.check_s
    warm = int(mix.get("warmup_steps", 0))
    if warm:
        _loop(s, steps=warm)
    stage("warmup")
    return s


def window(session: Session, seconds: float):
    """The timed window: ``train_loop`` until the deadline, the loop's
    final read waiting for the last step. Returns ``(steps, window_s,
    step_ms)``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed, report = _loop(session, deadline=t0 + seconds, events=True)
    torch.cuda.synchronize()
    window_s = time.perf_counter() - t0
    return report.steps, window_s, feed.step_ms()


def traced(session: Session, device_kind: str):
    """The per-layer readings: untraced steps timed by events, traced
    steps, then a few steps with synchronizing calls counted."""
    from benchmark.lib import trace

    tr = session.mix["trace"]
    torch.cuda.synchronize()
    feed, _ = _loop(session, steps=int(tr["timed_steps"]), events=True)
    torch.cuda.synchronize()
    ms = feed.step_ms()
    step_ms = sum(ms) / len(ms) if ms else None
    first = session.next_batch
    n = int(tr["traced_steps"])
    (_, window_s, busy_s, ops, ranges, gaps,
     counters) = trace.profile_steps(lambda: _loop(session, steps=n))
    shift = session.cfg["feature_shift"]
    uniq = [int(torch.unique(inputs.tag(session.pool[k]["sparse"], shift)
                             ).numel()) for k in range(first, first + n)]
    n_sync = int(tr["sync_steps"])
    trainer = session.trainer

    def steps():
        carry = trainer.carry
        for _ in range(n_sync):
            carry, loss = trainer.step_fn(carry, session.pool[
                session.next_batch])
            session.next_batch += 1
        trainer.carry = carry
        return loss

    _, syncs = timing.count_syncs(steps)
    return trace.TraceRun(
        cfg=session.cfg, mix=session.mix, device_kind=device_kind, steps=n, window_s=window_s,
        busy_s=busy_s, device_ops=ops, range_device_s=ranges,
        hit_share=counters["hit"], inserted=counters["inserted"],
        unique_keys=uniq, step_ms_untraced=step_ms,
        syncs_per_step=syncs / n_sync, idle_gaps=gaps)


def release(session: Session) -> None:
    """Free the program's state (the reference runs after it)."""
    session.trainer = None
    session.pool = None
    gc.collect()
    if session.device.type == "cuda":
        torch.cuda.empty_cache()


def check_batches(session: Session) -> List[dict]:
    n = int(session.mix["check_steps"])
    return [inputs.batch(session.cfg, session.mix, session.seed, k,
                         session.device) for k in range(n)]


def judge(session: Session, limits: Dict[str, float]):
    """The reference over the checked steps, against the program's
    readings: ``(correct, checks, numbers)``."""
    ref = ref_train.run(session.cfg, session.mix, session.seed,
                        session.plan, session.weights,
                        check_batches(session))
    numbers = check.compare(session.cfg, ref, session.weights,
                            prog=session.readings)
    ok, checks = check.verdict(numbers, limits)
    return ok, checks, numbers
