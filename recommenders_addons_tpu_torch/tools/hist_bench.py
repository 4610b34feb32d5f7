"""Launch-floor timing of the radix-histogram kernel (``radix_hist``,
``csrc/radix_hist.cu``, kernel 9 of the port) on an NVIDIA card.

    python -m recommenders_addons_tpu_torch.tools.hist_bench \\
        [--baseline DIR] [--clusters C,C,...]

The kernel's bytes bound lies below one launch up to about a million
ids, so its yardstick is the launch floor: an empty kernel (one block of
32 threads) timed the same way in the same run. At 8,192, 65,536 and
4,194,304 bucket ids of random keys (``hashing.bucket_of`` over the
probe's 32Ki buckets) each version is first held bit-exact against
:func:`ab_radix_plan.radix_hist_plain`, then timed as ``dma_bench`` times
a call: ``CALLS`` back-to-back calls, CUDA events behind a device spin,
ms per call; the versions take turns (new, baseline, baseline, new).
The device operations of one call are counted twice: exactly, as the
nodes (kernels, memsets, others) of a CUDA graph captured from it, at
each N; and, at 65,536 ids, from a ``torch.profiler`` trace of 20 calls
after a warm-up (the tracer drops events now and then: reported only).

``--baseline DIR`` adds another tree's ``radix_hist.cu`` from ``DIR`` (a
``csrc/`` directory), with the C interface of the kernel before its
redesign (``bids, n, out, stream``: it zeroes ``out`` itself), built
under ``build/hist_bench/``. ``--clusters`` times the kernel again with
its grid capped at each of these numbers of 8-block clusters (the
wrapper's cap is ``ab_radix_plan.HIST_MAX_CLUSTERS``). Prints the card's
name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import shutil
from pathlib import Path

import torch

from recommenders_addons_tpu_torch.ops import cuda_ops, hashing
from recommenders_addons_tpu_torch.tools import ab_radix_plan, dma_bench
from recommenders_addons_tpu_torch.tools.gather_sweep import _card
from recommenders_addons_tpu_torch.utils.config import resolve_device

SIZES = (1 << 13, 1 << 16, 1 << 22)
CALLS = 200
PROFILED_CALLS = 20
NB = 1 << 15  # the probe's table: Variable(dim=64, init_capacity=2Mi)
_DIR = cuda_ops._BUILD_DIR.parent / "hist_bench"
_FLOOR_SOURCE = """\
// An empty kernel: the launch floor the histogram is measured against.
#include <vector>

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The nodes of a captured CUDA graph, by kind: what one call runs.
extern "C" int graph_nodes(void* graph, size_t* kernels, size_t* memsets,
                           size_t* others) {
  const cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  *kernels = *memsets = *others = 0;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(node, &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    ++*(type == cudaGraphNodeTypeKernel   ? kernels
        : type == cudaGraphNodeTypeMemset ? memsets
                                          : others);
  }
  return 0;
}
"""


def _kernel(name: str, source: Path, argtypes) -> cuda_ops._Kernel:
    k = cuda_ops._Kernel(name, argtypes)
    k.source = source
    return k


def floor_kernel() -> cuda_ops._Kernel:
    """The empty kernel, its source written under ``build/hist_bench/``."""
    src = _DIR / "launch_floor.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(_FLOOR_SOURCE)
    return _kernel("launch_floor", src, [cuda_ops._P])


def baseline_kernel(csrc: Path) -> cuda_ops._Kernel:
    """``csrc/radix_hist.cu`` of another tree, with the interface
    ``(bids, n, out, stream)``."""
    dest = _DIR / "baseline"
    shutil.rmtree(dest, ignore_errors=True)
    dest.mkdir(parents=True)
    shutil.copy(Path(csrc) / "radix_hist.cu", dest / "radix_hist.cu")
    return _kernel("radix_hist", dest / "radix_hist.cu",
                   [cuda_ops._P, cuda_ops._I64, cuda_ops._P, cuda_ops._P])


def profiled_ops_per_call(fn, calls: int = PROFILED_CALLS) -> float:
    """Device operations (kernels, memsets, copies) that ``fn()`` runs,
    from a ``torch.profiler`` trace of ``calls`` calls: the active step
    of a schedule whose first step only warms the tracer up. On the card
    the tracer drops events now and then (an empty kernel has read 0.4 to
    1.05 a call in one process), so this is reported, and
    :func:`graph_ops` is what a check holds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):  # the warm-up step, then the traced one
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA)
    return ops / calls


def graph_ops(fn, dev: torch.device, count_fn) -> dict:
    """The device operations of one call of ``fn()``, exactly: the nodes
    of a CUDA graph captured from it, by kind (``count_fn`` is the floor
    library's ``graph_nodes``). A call made first, on the capture's own
    stream, keeps its allocations and the stream's ticket out of the
    graph."""
    s = torch.cuda.Stream(dev)
    with torch.cuda.stream(s):
        fn()
    s.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(g, stream=s):
        fn()
    kernels, memsets, others = (ctypes.c_size_t() for _ in range(3))
    err = count_fn(ctypes.c_void_p(g.raw_cuda_graph()), ctypes.byref(kernels),
                   ctypes.byref(memsets), ctypes.byref(others))
    if err:
        raise RuntimeError(f"cudaGraphGetNodes failed: CUDA error {err}")
    return {"kernels": kernels.value, "memsets": memsets.value,
            "others": others.value}


def main(argv=None, *, device=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--baseline", type=Path, default=None,
                   help="another tree's csrc/ directory")
    p.add_argument("--clusters", default="",
                   help="grid caps to time the kernel at as well, in "
                        "clusters of 8 blocks, comma-separated (default: "
                        "only ab_radix_plan.HIST_MAX_CLUSTERS)")
    args = p.parse_args(argv)
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("hist_bench times CUDA kernels: it needs a card")
    floor = floor_kernel()
    base = (baseline_kernel(args.baseline) if args.baseline is not None
            else None)
    cuda_ops.build_kernels([k for k in (cuda_ops.RADIX_HIST, floor, base)
                            if k is not None])
    count_fn = ctypes.CDLL(str(floor.library)).graph_nodes
    count_fn.argtypes = [cuda_ops._P] * 4
    count_fn.restype = ctypes.c_int
    card = _card()
    print(card, flush=True)

    def call_base(b):
        out = torch.empty(1024, dtype=torch.int32, device=dev)
        base.launch(dev, b.data_ptr(), b.shape[0], out.data_ptr())
        return out

    versions = {"radix_hist": lambda b: ab_radix_plan.pallas_hist(b, NB)}
    for cap in (int(c) for c in args.clusters.split(",") if c):
        versions[f"radix_hist clusters<={cap}"] = functools.partial(
            ab_radix_plan.pallas_hist, nb=NB, max_clusters=cap)
    if base is not None:
        versions["baseline"] = call_base
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {"card": card, "calls": CALLS, "sizes": list(SIZES), "ms": {},
           "launch_floor_ms": None, "graph_ops_per_call": {},
           "profiled_ops_per_call": {}, "bound_ms": {}}
    rate = dma_bench.mem_rate(torch.cuda.get_device_name(dev))
    floor_ms = []
    for n in SIZES:
        keys = torch.randint(1, 1 << 62, (n,), device=dev, generator=gen)
        bids = hashing.bucket_of(keys, NB)
        want = ab_radix_plan.radix_hist_plain(bids)
        for name, fn in versions.items():
            if not torch.equal(fn(bids), want):
                raise AssertionError(f"{name} disagrees at N={n}")
        order = list(versions) + list(versions)[::-1]
        times = {name: [] for name in versions}
        for name in order:
            fn = versions[name]
            fn(bids)
            torch.cuda.synchronize()
            times[name].append(dma_bench.seconds(
                lambda: [fn(bids) for _ in range(CALLS)], dev, CALLS)
                / CALLS * 1e3)
        for name, ts in times.items():
            out["ms"].setdefault(name, {})[n] = min(ts)
        out["bound_ms"][n] = (n * 4 + 1024 * 4) / rate * 1e3
        floor.launch(dev)
        torch.cuda.synchronize()
        floor_ms.append(dma_bench.seconds(
            lambda: [floor.launch(dev) for _ in range(CALLS)], dev, CALLS)
            / CALLS * 1e3)
        calls = dict(versions, launch_floor=lambda b: floor.launch(dev))
        for name, fn in calls.items():
            out["graph_ops_per_call"].setdefault(name, {})[n] = graph_ops(
                lambda: fn(bids), dev, count_fn)
            if n == SIZES[1]:
                out["profiled_ops_per_call"][name] = profiled_ops_per_call(
                    lambda: fn(bids))
        del keys, bids
    out["launch_floor_ms"] = min(floor_ms)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
