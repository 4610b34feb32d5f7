"""Radix-histogram probe: what does one binning pass over bucket ids cost
on the card, beside the sort that ``plan_lookup`` runs and the whole plan
it would serve? The port's counterpart of the JAX package's
``tools/ab_radix_plan.py``, on an NVIDIA Hopper card.

    python -m recommenders_addons_tpu_torch.tools.ab_radix_plan [name-substr ...]

Its variants (only those whose name holds one of the arguments, if any):

* ``sort_pair``: the sort a radix pass would replace, the keys' mixed
  bits rotated so the bucket bits lead, sorted with their positions
  (:func:`sort_pair_step`), fully consumed through position-weighted sums;
* ``pallas_hist``: ``hashing.bucket_of`` then :func:`pallas_hist`, a
  1,024-bin histogram of the low bucket-id bits (``csrc/radix_hist.cu``);
* ``plan_hit`` and ``plan_miss``: ``hashtable.plan_lookup`` on batches
  that all hit, or all miss (keys ``^ ((i+7) << 42)``).

The table is a ``Variable(dim=64, init_capacity=2Mi)`` holding both
batches' ids. Each variant prints ns/key, the slope between adjacently
timed batches of 8,192 and 65,536 keys (10 calls each, median of 7),
timed by ``dma_bench.seconds`` (CUDA events behind a device spin, sized
for the tens of small launches of each call).

``plan_lookup`` reads ``no_dups`` back to the host in every call, and
its eviction test when a bucket overflows: a sync inside the timed run.
The events then include host time, so the plan slopes are not device
time (the JAX tool timed one fused scan of the plans).

:func:`pallas_hist` takes any N (the reference asserts ``N % 8192 ==
0``). A CUDA tensor launches the kernel or raises; a CPU tensor runs
:func:`radix_hist_plain`.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import cuda_ops, hashing, hashtable
from recommenders_addons_tpu_torch.ops import initializers
from recommenders_addons_tpu_torch.ops.variable import Variable
from recommenders_addons_tpu_torch.tools import dma_bench
from recommenders_addons_tpu_torch.utils.config import resolve_device

DIM = 64
CAP = 1 << 21
BATCHES = (1 << 13, 1 << 16)
STEPS = 10
REPS = 7
# the reference's SMEM cap: one radix digit of 1,024 buckets
_HIST_NB = 1024
# the histogram kernel's grid: at most this many clusters of 8 blocks
# (256 blocks, about two an SM), each adding a partial row
HIST_MAX_CLUSTERS = 32
_TICKETS: dict = {}  # (device index, stream) -> the kernel's ticket
_TICKETS_LOCK = threading.Lock()
# a step launches tens of small kernels (the int64 mix alone is a dozen):
# the device spin ahead of a timed run counts this many calls per step,
# so that it outlasts the host's queueing of every launch
_SPIN_CALLS_PER_STEP = 10


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def pair_slope(mk_run, device: torch.device) -> float:
    """Marginal seconds per key from adjacently timed (b0, b1) runs of
    STEPS calls each, median over REPS; ``mk_run(b)`` makes the run of
    batch ``b``."""
    runs = {b: mk_run(b) for b in BATCHES}
    for b in BATCHES:  # warm
        runs[b]()
    b0, b1 = BATCHES
    slopes = []
    for _ in range(REPS):
        ts = {b: dma_bench.seconds(runs[b], device,
                                   STEPS * _SPIN_CALLS_PER_STEP)
              for b in BATCHES}
        slopes.append((ts[b1] - ts[b0]) / (b1 - b0) / STEPS)
    return _median(slopes)


# ---------------------------------------------------------------------------
# the histogram
# ---------------------------------------------------------------------------


def radix_hist_plain(bids: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`pallas_hist`, on any device:
    int32 counts of ``bids & 1023`` (computed in int32)."""
    low = bids.reshape(-1).to(torch.int32) & (_HIST_NB - 1)
    return torch.bincount(low.long(), minlength=_HIST_NB).to(torch.int32)


def _ticket(device: torch.device) -> torch.Tensor:
    """The kernel's ticket for ``device``'s current stream: one int32,
    zeroed once here and left at 0 by every launch. One per stream, so
    two launches running at once on two streams never share one; those
    on one stream run one after the other."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device.index, stream)
    with _TICKETS_LOCK:
        t = _TICKETS.get(key)
        if t is None:
            t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32,
                                            device=device)
    return t


def pallas_hist(bids: torch.Tensor, nb: int, *,
                max_clusters: int = HIST_MAX_CLUSTERS) -> torch.Tensor:
    """``[1024]`` int32 histogram of the low 10 bits of int32 ``bids``
    (the JAX tool's ``pallas_hist``; ``nb`` is ignored there too). On a
    card: one launch of ``csrc/radix_hist.cu``, its grid at most
    ``max_clusters`` clusters, with a scratch row per cluster and the
    stream's ticket."""
    del nb
    b32 = bids.reshape(-1).to(torch.int32).contiguous()
    if not cuda_ops._is_cuda(b32):
        return radix_hist_plain(b32)
    dev = b32.device
    out = torch.empty(_HIST_NB, dtype=torch.int32, device=dev)
    partials = torch.empty(max_clusters * _HIST_NB, dtype=torch.int32,
                           device=dev)
    cuda_ops.RADIX_HIST.launch(dev, b32.data_ptr(), b32.shape[0],
                               out.data_ptr(), partials.data_ptr(),
                               max_clusters, _ticket(dev).data_ptr())
    return out


# ---------------------------------------------------------------------------
# the variants' steps
# ---------------------------------------------------------------------------


def _keys(ids: torch.Tensor, i: int) -> torch.Tensor:
    """Call ``i``'s batch: the ids, reversed on odd calls."""
    return ids if i % 2 == 0 else ids.flip(0)


def sort_pair_step(ids: torch.Tensor, i: int, nb: int):
    """Call ``i`` of ``sort_pair`` on int64 ``ids``: the mixed keys
    rotated right by log2(``nb``) bits (bucket bits lead), sorted in
    unsigned order with their positions. Returns (sorted rotations, int64
    holding the unsigned bits; positions)."""
    m = hashing.mix64(_keys(ids, i))
    r = nb.bit_length() - 1
    rot = ((m << (64 - r)) | hashing._srl(m, r)) if r else m
    srt, order = torch.sort(hashtable._unsigned_order(rot, 64), stable=True)
    return hashtable._unsigned_order(srt, 64), order


def sort_pair_sums(rs: torch.Tensor, order: torch.Tensor):
    """The position-weighted f32 sums that consume a sort's outputs (plain
    sums are permutation invariants, which a compiler may take without
    sorting): (positions, low 32 bits of the rotations)."""
    w = torch.arange(order.shape[0], dtype=torch.float32,
                     device=order.device) * 1e-6
    return ((order.to(torch.float32) * w).sum(),
            ((rs & 0xFFFFFFFF).to(torch.float32) * w).sum())


def plan_step(spec, state, ids: torch.Tensor, i: int, miss: bool):
    """Call ``i`` of ``plan_hit`` / ``plan_miss``: ``plan_lookup`` on the
    batch (keys ``^ ((i+7) << 42)`` for misses). Returns the int64 sums of
    its slots, inverse and inserted flags."""
    keys = _keys(ids, i)
    if miss:
        keys = keys ^ ((i + 7) << 42)
    _, inv, (slot, _, ins, _), _ = hashtable.plan_lookup(spec, state, keys)
    return slot.sum(), inv.sum(), ins.to(torch.int32).sum()


def main(argv=None, *, device=None) -> dict:
    """Run the variants named in ``argv`` (substrings; default
    ``sys.argv[1:]``, empty: all) on ``device`` (default CUDA; raises
    without a card unless given ``device="cpu"``). Prints one line per
    variant and returns ns/key by name."""
    argv = sys.argv[1:] if argv is None else list(argv)
    only = [a.lower() for a in argv]
    dev = resolve_device(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    var = Variable(name="abradix", dim=DIM, init_capacity=CAP,
                   initializer=initializers.normal(0.05), device=dev)
    spec = var.spec
    state = var.init()
    rng = np.random.default_rng(0)
    b0, b1 = BATCHES
    pool = rng.choice(np.arange(1, CAP * 2, dtype=np.int64), size=b0 + b1,
                      replace=False)
    ids_by_b = {b0: torch.from_numpy(pool[:b0]).to(dev),
                b1: torch.from_numpy(pool[b0:]).to(dev)}
    for b in BATCHES:
        state = var.upsert(state, ids_by_b[b],
                           torch.zeros((b, DIM), device=dev))
    nb = spec.num_buckets
    print(f"cap={CAP} dim={DIM} buckets={nb} device={kind}", flush=True)

    def sort_pair(acc, ids, i):
        s_order, s_rot = sort_pair_sums(*sort_pair_step(ids, i, nb))
        return acc + s_order + s_rot

    def hist(acc, ids, i):
        h = pallas_hist(hashing.bucket_of(_keys(ids, i), nb), nb)
        return acc + h.sum().to(torch.float32)

    def plan(miss):
        def step(acc, ids, i):
            s_slot, s_inv, s_ins = plan_step(spec, state, ids, i, miss)
            return (acc + s_slot.to(torch.float32) + s_inv.to(torch.float32)
                    + s_ins.to(torch.float32))
        return step

    def runs_of(step):
        def mk_run(b):
            ids = ids_by_b[b]

            def run():
                acc = torch.zeros((), dtype=torch.float32, device=dev)
                for i in range(STEPS):
                    acc = step(acc, ids, i)
                return acc
            return run
        return mk_run

    variants = [("sort_pair", sort_pair), ("pallas_hist", hist),
                ("plan_hit", plan(False)), ("plan_miss", plan(True))]
    out = {"device": kind, "cap": CAP, "dim": DIM, "buckets": nb,
           "batches": list(BATCHES), "steps": STEPS, "reps": REPS,
           "ns_per_key": {}}
    for name, step in variants:
        if only and not any(s in name for s in only):
            continue
        ns = pair_slope(runs_of(step), dev) * 1e9
        out["ns_per_key"][name] = ns
        print(f"{name:12s} {ns:6.3f} ns/key", flush=True)
    return out


if __name__ == "__main__":
    main()
