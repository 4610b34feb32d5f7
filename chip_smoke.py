#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (recommenders_addons_tpu_torch) on
one NVIDIA card: builds the hand-written CUDA kernels from csrc/, holds
each against its plain PyTorch version at the serving path's shapes,
then serves a DLRM-width dynamic-embedding table through the port's
EmbeddingServer and checks every answer against an independent numpy
reference.

    python3 chip_smoke.py [--seed 0]

Phases (any failure exits non-zero):

1. Kernels against their plain versions, bit-exact on int32 views:
   row_gather on a 4Mi-row table (ch = 1) at N = 65536, on a ragged N
   with sentinel and negative indices (masked and flat), and on a ch = 2
   table with the vc = 1 value stride; row_scatter of 1Mi rows with
   unique indices plus sentinels. Each is timed (CUDA events) beside its
   plain version, one PyTorch library call computing the same function
   (index_select / index_copy_), and its bound: the bytes it must move
   over the card's memory rate.
2. The serving slice: a Variable(dim=64, init_capacity=1<<22) filled with
   26 features x 80,658 feature-tagged ids (the DLRM shared table's
   layout, models/dlrm.py), export_compressed to f16, serve_directory
   (load_compressed into a 4Mi-slot table), 8 EmbeddingClient requests
   of 256 examples x 26 features with zipf(1.2) ids, 4 of them
   concurrent, each held exactly against the numpy reference. Both
   kernels' launch counters must rise in this phase. Then
   FrozenTable.lookup is timed at N = 65536 (CUDA events, then a
   torch.profiler trace for the device's busy share and top kernels), and
   the requests' latency beside the server's table layer alone on the
   same ids.

Output: the card's name and power limit on a line of its own, a
``{"serving": ...}`` line, a ``{"kernels": [...]}`` line, and last
``{"ok": true, "device": {...}}``. Without CUDA, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

C = 1 << 22  # DLRMConfig.table_capacity
DIM = 64  # DLRMConfig.dim
FEATURES = 26  # DLRMConfig.num_sparse
IDS_PER_FEATURE = 80_658  # 26 * 80,658 = 2,097,108 keys: load cap -> 4Mi
FEATURE_SHIFT = 56  # models/dlrm.py tag_keys: top byte = feature id
KEY_MASK = (1 << 56) - 1
VOCAB = 100_000  # synthetic_criteo_batch vocab_per_feature
N_GATHER = 65536
N_SCATTER = 1 << 20
LANES = 128

# device memory rate by card name (NVIDIA data sheets), for the bounds
_MEM_BYTES_PER_S = (("H200", 4.8e12), ("H100 NVL", 3.9e12),
                    ("H100 PCIe", 2.0e12), ("H100", 3.35e12))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _mem_rate(name: str) -> float:
    for sub, rate in _MEM_BYTES_PER_S:
        if sub in name:
            return rate
    raise RuntimeError(f"no memory rate on record for card {name!r}")


def _time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches (CUDA events),
    after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_profile(torch, fn, iters: int = 10):
    """Device busy share of ``iters`` back-to-back calls of ``fn`` (kernel
    time summed from a torch.profiler trace over the host wall time) and
    the five kernels that took the most device time, in ms per call.
    Returns (None, []) when the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    kernels = [(e.key, e.self_device_time_total)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(us for _, us in kernels)
    if busy_us == 0:
        return None, []
    top = sorted(kernels, key=lambda kv: -kv[1])[:5]
    return busy_us / wall_us, [[k[:80], us / iters / 1e3] for k, us in top]


def _same_bits(torch, a, b) -> int:
    """Max |difference| of two 32-bit tensors' int32 words (0 = equal)."""
    a, b = a.view(torch.int32), b.view(torch.int32)
    if a.shape != b.shape:
        raise AssertionError(f"shapes differ: {a.shape} vs {b.shape}")
    ne = a != b
    if not bool(ne.any()):
        return 0
    return int((a[ne].to(torch.int64) - b[ne].to(torch.int64)).abs().max())


def _tag_keys(ids: np.ndarray) -> np.ndarray:
    """[B, F] raw ids -> feature-tagged keys (models/dlrm.py tag_keys)."""
    f = np.arange(ids.shape[-1], dtype=np.int64)
    return (ids.astype(np.int64) & KEY_MASK) | (f << FEATURE_SHIFT)


def kernel_phase(torch, cuda_ops, dev, gen, rate):
    """Phase 1: each kernel against its plain version; timings."""
    i32 = torch.int32
    cap_words = (-(1 << 31), (1 << 31) - 1)
    results = []

    # -- row_gather at the serving shape: C = 4Mi, ch = vc = 1 ------------
    table = torch.randint(*cap_words, ((C + 1), LANES), dtype=i32,
                          device=dev, generator=gen).view(torch.float32)
    idx = torch.randint(0, C, (N_GATHER,), dtype=i32, device=dev,
                        generator=gen)
    idx[::97] = C  # sentinel misses read the trash row
    err = _same_bits(torch,
                     cuda_ops.gather_rows_2d(table, 1, idx, masked=False),
                     cuda_ops.gather_rows_2d_plain(table, 1, idx,
                                                   masked=False))
    # ragged N with sentinel, negative and past-the-end indices
    rag = torch.randint(0, C, (1037,), dtype=i32, device=dev, generator=gen)
    rag[::7], rag[3::11], rag[5::13] = C, -1, C + 9
    for kw in (dict(cap=C, masked=True), dict(cap=C, flat=True)):
        err = max(err, _same_bits(
            torch, cuda_ops.gather_rows_2d(table, 1, rag, **kw),
            cuda_ops.gather_rows_2d_plain(table, 1, rag, **kw)))
    # ch = 2 table (value + slot chunk), whole rows and the vc = 1 stride
    c2 = 1 << 20
    t2 = torch.randint(*cap_words, ((c2 + 1) * 2, LANES), dtype=i32,
                       device=dev, generator=gen).view(torch.float32)
    i2 = torch.randint(0, c2 + 1, (N_GATHER,), dtype=i32, device=dev,
                       generator=gen)
    for vc in (1, 2):
        err = max(err, _same_bits(
            torch, cuda_ops.gather_rows_2d(t2, 2, i2, masked=False, vc=vc),
            cuda_ops.gather_rows_2d_plain(t2, 2, i2, masked=False, vc=vc)))
    del t2, i2
    torch.cuda.synchronize()
    g_ms = _time_ms(torch, lambda: cuda_ops.gather_rows_2d(
        table, 1, idx, masked=False), 50)
    g_plain = _time_ms(torch, lambda: cuda_ops.gather_rows_2d_plain(
        table, 1, idx, masked=False), 20)
    g_lib = _time_ms(torch, lambda: torch.index_select(table, 0, idx), 50)
    rows_read = int(torch.unique(idx).numel())
    g_bytes = rows_read * 512 + N_GATHER * 4 + N_GATHER * 512
    results.append({
        "name": "row_gather", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/row_gather.cu",
        "replaces": "recommenders_addons_tpu/ops/pallas_ops.py:165",
        "replaces_fn": "_gather_kernel via gather_rows_2d",
        "max_abs_err": err, "match": err == 0,
        "ms": g_ms, "kernel_ms": g_ms, "plain_ms": g_plain,
        "library_ms": g_lib, "library_call": "torch.index_select",
        "bound_ms": g_bytes / rate * 1e3, "bound_by": "bytes",
        "bytes": g_bytes, "shape": f"C={C} ch=1 vc=1 N={N_GATHER}",
    })

    # -- row_scatter at the load shape: 1Mi unique rows plus sentinels ----
    sidx = torch.randperm(C, device=dev, generator=gen)[:N_SCATTER].to(i32)
    sidx[::64] = C  # sentinels land on the trash row
    rows = torch.randint(*cap_words, (N_SCATTER, LANES), dtype=i32,
                         device=dev, generator=gen).view(torch.float32)
    a = table.clone()
    cuda_ops.scatter_rows_set_2d(a, 1, sidx, rows, cap=C)
    cuda_ops.scatter_rows_set_2d_plain(table, 1, sidx, rows, cap=C)
    s_err = _same_bits(torch, a[:C], table[:C])  # never the trash row
    del a
    safe = torch.where((sidx >= 0) & (sidx < C), sidx, C).long()
    s_ms = _time_ms(torch, lambda: cuda_ops.scatter_rows_set_2d(
        table, 1, sidx, rows, cap=C), 20)
    s_plain = _time_ms(torch, lambda: cuda_ops.scatter_rows_set_2d_plain(
        table, 1, sidx, rows, cap=C), 10)
    s_lib = _time_ms(torch, lambda: table.index_copy_(0, safe, rows), 20)
    rows_written = int(torch.unique(safe).numel())
    s_bytes = N_SCATTER * 512 + N_SCATTER * 4 + rows_written * 512
    results.append({
        "name": "row_scatter", "route": "cuda",
        "source": "recommenders_addons_tpu_torch/csrc/row_scatter.cu",
        "replaces": "recommenders_addons_tpu/ops/pallas_ops.py:192",
        "replaces_fn": "_scatter_kernel via scatter_rows_set_2d",
        "max_abs_err": s_err, "match": s_err == 0,
        "ms": s_ms, "kernel_ms": s_ms, "plain_ms": s_plain,
        "library_ms": s_lib, "library_call": "torch.Tensor.index_copy_",
        "bound_ms": s_bytes / rate * 1e3, "bound_by": "bytes",
        "bytes": s_bytes, "shape": f"C={C} ch=1 N={N_SCATTER}",
    })
    del table, rows, safe, sidx
    torch.cuda.empty_cache()
    bad = [r["name"] for r in results if not r["match"]]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    return results


def serving_phase(torch, cuda_ops, dev, gen, seed):
    """Phase 2: the port's serving path, end to end, on the card."""
    from recommenders_addons_tpu_torch import dynamic_embedding as de
    from recommenders_addons_tpu_torch.serving import (
        EmbeddingClient,
        serve_directory,
    )

    ids = np.arange(IDS_PER_FEATURE, dtype=np.int64)
    keys_np = _tag_keys(np.broadcast_to(ids[:, None], (IDS_PER_FEATURE,
                                                       FEATURES))).reshape(-1)
    n_keys = keys_np.shape[0]
    keys = torch.from_numpy(keys_np).to(dev)
    values = torch.randn((n_keys, DIM), device=dev, generator=gen)

    var = de.Variable(name="dlrm_shared", dim=DIM, init_capacity=C)
    state = var.init()
    t0 = time.perf_counter()
    for off in range(0, n_keys, 1 << 20):
        state = var.upsert(state, keys[off:off + (1 << 20)],
                           values[off:off + (1 << 20)])
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    if int(var.size(state)) != n_keys:
        raise AssertionError(f"table holds {int(var.size(state))} of "
                             f"{n_keys} keys")

    # independent reference: sorted keys, numpy's own f16 rounding
    order = np.argsort(keys_np, kind="stable")
    ref_keys = keys_np[order]
    ref_vals = values.cpu().numpy()[order].astype(np.float16)
    del values

    def reference(q):
        pos = np.minimum(np.searchsorted(ref_keys, q), n_keys - 1)
        hit = ref_keys[pos] == q
        vals = np.where(hit[:, None], ref_vals[pos].astype(np.float32), 0.0)
        return vals.astype(np.float32), hit

    rng = np.random.default_rng(seed)
    reqs = [_tag_keys(rng.zipf(1.2, size=(256, FEATURES)) % VOCAB
                      ).reshape(-1) for _ in range(8)]

    with tempfile.TemporaryDirectory() as d:
        de.serving.export_compressed(var, state, d, dtype=torch.float16)
        del state
        torch.cuda.empty_cache()

        # -- the main path: counters from 0, serve, answer, read counters --
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        srv = serve_directory(d, port=0)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        answers, lat = {}, {}
        with srv:
            cli = EmbeddingClient(srv.host, srv.port, timeout=120)

            def ask(i):
                t = time.perf_counter()
                answers[i] = cli.lookup("dlrm_shared", reqs[i])
                lat[i] = time.perf_counter() - t

            for i in range(4):
                ask(i)
            threads = [threading.Thread(target=ask, args=(i,))
                       for i in range(4, 8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
                if t.is_alive():
                    raise AssertionError("a concurrent request hung")
            launches = {k.name: k.launches for k in cuda_ops.KERNELS}
            table = srv._entries["dlrm_shared"].table
            if table.spec.capacity != C or table.size() != n_keys:
                raise AssertionError(
                    f"served table: capacity {table.spec.capacity}, "
                    f"{table.size()} keys")

            misses = 0
            for i, q in enumerate(reqs):
                vals, found = answers[i]
                want_vals, want_found = reference(q)
                if vals.shape != (q.shape[0], DIM):
                    raise AssertionError(f"request {i}: shape {vals.shape}")
                if not np.isfinite(vals).all():
                    raise AssertionError(f"request {i}: non-finite values")
                if not np.array_equal(found, want_found):
                    raise AssertionError(f"request {i}: found differs")
                if not np.array_equal(vals.view(np.int32),
                                      want_vals.view(np.int32)):
                    raise AssertionError(f"request {i}: values differ")
                misses += int((~found).sum())
            n_ids = sum(r.shape[0] for r in reqs)
            if not 0 < misses < n_ids:
                raise AssertionError(f"{misses} misses of {n_ids} ids: the "
                                     f"requests should hit and miss")
            if not all(launches.values()):
                raise AssertionError(
                    f"a kernel was not launched on the serving path: "
                    f"{launches}")

            # -- timings after the checked run --------------------------
            q = torch.from_numpy(_tag_keys(
                rng.zipf(1.2, size=(N_GATHER // FEATURES + 1, FEATURES))
                % VOCAB).reshape(-1)[:N_GATHER]).to(dev)
            lookup_ms = _time_ms(torch, lambda: table.lookup(q), 20)
            busy, top = _device_profile(torch, lambda: table.lookup(q))
            seq, ent = [], []
            for i in range(16):
                t = time.perf_counter()
                cli.lookup("dlrm_shared", reqs[i % 8])
                seq.append(time.perf_counter() - t)
                # the server's table layer alone: pad, copy in, probe,
                # gather, copy out (what one request's batch costs it)
                t = time.perf_counter()
                srv._entries["dlrm_shared"].lookup(reqs[i % 8])
                ent.append(time.perf_counter() - t)

    seq_ms = sorted(s * 1e3 for s in seq)
    ent_ms = sorted(s * 1e3 for s in ent)
    return {
        "keys": n_keys, "capacity": C, "dim": DIM, "stored": "float16",
        "fill_upsert_s": fill_s, "load_compressed_s": load_s,
        "requests": len(reqs), "ids_per_request": int(reqs[0].shape[0]),
        "concurrent": 4, "ids": n_ids, "misses": misses,
        "exact": True, "launches": launches,
        "request_ms_p50": seq_ms[len(seq_ms) // 2],
        "request_ms_max": seq_ms[-1], "request_samples": len(seq_ms),
        "table_entry_ms_p50": ent_ms[len(ent_ms) // 2],
        "table_entry_ms_max": ent_ms[-1],
        "checked_request_ms": [lat[i] * 1e3 for i in range(8)],
        "lookup_n": N_GATHER, "lookup_ms": lookup_ms,
        "lookup_keys_per_s": N_GATHER / (lookup_ms / 1e3),
        "lookup_device_busy_share": busy,
        "lookup_top_kernels_ms": top,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    try:
        from recommenders_addons_tpu_torch.ops import cuda_ops
    except ImportError as e:
        print(f"chip_smoke: the port package is not beside this script "
              f"({e})", file=sys.stderr)
        return 1

    card = _card_line()
    name = torch.cuda.get_device_name(0)
    rate = _mem_rate(name)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cuda_ops.build_kernels()  # one nvcc per source, all started together
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    kernels = kernel_phase(torch, cuda_ops, dev, gen, rate)
    serving = serving_phase(torch, cuda_ops, dev, gen, args.seed)
    for k in kernels:
        k["launches"] = serving["launches"][k["name"]]
        k["card"] = card
    if "jax" in sys.modules or "recommenders_addons_tpu" in sys.modules:
        raise AssertionError("the port run imported JAX or the JAX package")

    print(card)
    print(json.dumps({"serving": dict(serving, build_s=build_s,
                                      mem_bytes_per_s=rate, card=card)}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
