// 1,024-bin histogram of bucket ids for NVIDIA Hopper (sm_90a): the
// radix-partition probe's binning primitive. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel `_hist_kernel` behind `pallas_hist`
// (tools/ab_radix_plan.py:140, kernel at :114, pallas_call at :144), which
// carries one SMEM histogram across its sequential grid.
//
// Computes, for any N (0 included):
//   out[k] = #{ j : (bids[j] & 1023) == k },  k in [0, 1024)
// on int32 ids, so a negative id lands in a high bin as in the reference.
// Integer counts do not depend on the order of the additions, so the
// result is exact.
//
// Bound on this card: bytes, 4 per id read plus the 4 KiB written; below
// one launch up to about a million ids (65,536 ids: 0.08 us), so one
// launch is the floor there, and the byte rate above it.
//
// Design: one launch, no memset, no atomic on `out`. The grid is made of
// thread-block clusters of 8 blocks (the portable size).
//   1. Each block counts its grid-stride share of the ids into a shared
//      int[1024] with shared-memory atomics, reading 16-byte int4 loads
//      (a scalar head up to the first 16-byte boundary, and a tail).
//   2. cluster.sync(); block r of the cluster sums bins [128r, 128r+128)
//      over the 8 blocks' histograms through distributed shared memory.
//   3. One cluster (up to 65,536 ids): those sums are `out`, stored once
//      each. Several (the grid grows with N up to `max_clusters`): each
//      cluster stores its sums as a partial row of the wrapper's
//      `partials` buffer, fences, and its leader takes a ticket from
//      `ticket` with one atomic add. The cluster that draws the last
//      ticket sums the partial rows (block r its 128 bins) into `out` and
//      puts the ticket back to 0.
// The ticket is zeroed once, when the wrapper allocates it, and every
// launch leaves it at 0, so no call needs a memset. Two launches must not
// share a ticket while both run: the wrapper keeps one ticket per CUDA
// stream (tools/ab_radix_plan.py, `_ticket`), and launches on one stream
// run one after the other.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBins = 1024;
constexpr int kThreads = 512;
constexpr int kCluster = 8;                    // blocks a cluster (portable)
constexpr int kSlice = kBins / kCluster;       // bins each block finishes
constexpr int kGroups = kThreads / kSlice;     // thread groups of kSlice
constexpr int kUnroll = 4;                     // int4 loads in flight
// ids one cluster takes before the grid grows by another
constexpr int64_t kIdsPerCluster =
    static_cast<int64_t>(kCluster) * kThreads * 4 * kUnroll;  // 65,536

__device__ __forceinline__ void count(int32_t* hist, int32_t id) {
  atomicAdd(&hist[id & (kBins - 1)], 1);
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 2)
radix_hist_kernel(const int32_t* __restrict__ bids, int64_t n, int head,
                  int32_t* __restrict__ out, int32_t* __restrict__ partials,
                  unsigned int* __restrict__ ticket) {
  __shared__ int32_t hist[kBins];
  __shared__ int32_t part[kGroups][kSlice];
  __shared__ int last_cluster;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t clusters = gridDim.x / kCluster;
  const int64_t cid = blockIdx.x / kCluster;

  for (int k = threadIdx.x; k < kBins; k += kThreads) hist[k] = 0;
  __syncthreads();

  // 1. this block's share: the scalar head and tail, then the int4 body
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t body = (n - head) >> 2;
  const int64_t tail = head + body * 4;
  if (gtid < head) count(hist, bids[gtid]);
  if (gtid < n - tail) count(hist, bids[tail + gtid]);
  const int4* vec = reinterpret_cast<const int4*>(bids + head);
  for (int64_t i = gtid; i < body; i += stride * kUnroll) {
    int4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < body) v[u] = __ldcs(vec + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + u * stride < body) {
        count(hist, v[u].x);
        count(hist, v[u].y);
        count(hist, v[u].z);
        count(hist, v[u].w);
      }
  }
  cluster.sync();

  // 2. block `rank` sums its slice of bins over the cluster's histograms;
  // thread group g reads ranks g and g + kGroups
  const int b = threadIdx.x % kSlice;
  const int g = threadIdx.x / kSlice;
  const int bin = rank * kSlice + b;
  int32_t s = 0;
  for (int r = g; r < kCluster; r += kGroups)
    s += cluster.map_shared_rank(hist, r)[bin];
  part[g][b] = s;
  __syncthreads();
  int32_t v = 0;
  if (threadIdx.x < kSlice)
    for (int q = 0; q < kGroups; ++q) v += part[q][threadIdx.x];

  // 3a. one cluster: these sums are the result
  if (clusters == 1) {
    if (threadIdx.x < kSlice) out[bin] = v;
    cluster.sync();  // keep this histogram until every rank has read it
    return;
  }

  // 3b. several: store the cluster's partial row, then take a ticket
  if (threadIdx.x < kSlice) {
    partials[cid * kBins + bin] = v;
    __threadfence();
  }
  cluster.sync();  // the row is stored; no rank reads a histogram after
  if (rank == 0 && threadIdx.x == 0) {
    __threadfence();
    const unsigned int t = atomicAdd(ticket, 1u);
    const int last = t == static_cast<unsigned int>(clusters - 1);
    if (last) *ticket = 0;  // every cluster has drawn: leave it at 0
    for (int r = 0; r < kCluster; ++r)
      *cluster.map_shared_rank(&last_cluster, r) = last;
  }
  cluster.sync();
  if (!last_cluster) return;
  __threadfence();
  s = 0;
  for (int64_t c = g; c < clusters; c += kGroups)
    s += __ldcg(partials + c * kBins + bin);
  part[g][b] = s;
  __syncthreads();
  if (threadIdx.x < kSlice) {
    v = 0;
    for (int q = 0; q < kGroups; ++q) v += part[q][threadIdx.x];
    out[bin] = v;
  }
}

}  // namespace

// bids: [n] int32 (4-byte aligned); out: [1024] int32; partials:
// [max_clusters, 1024] int32 scratch; ticket: one uint32, 0 on entry and
// left 0 (see the design note). Launches one kernel on `stream` and
// returns the CUDA error (0 on success).
extern "C" int radix_hist(const void* bids, int64_t n, void* out,
                          void* partials, int max_clusters, void* ticket,
                          void* stream) {
  if (n < 0 || max_clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(bids);
  if (addr % sizeof(int32_t))
    return static_cast<int>(cudaErrorMisalignedAddress);
  int64_t head = static_cast<int64_t>((16 - addr % 16) % 16 / 4);
  if (head > n) head = n;
  int64_t clusters = (n + kIdsPerCluster - 1) / kIdsPerCluster;
  if (clusters < 1) clusters = 1;
  if (clusters > max_clusters) clusters = max_clusters;
  radix_hist_kernel<<<static_cast<unsigned>(clusters * kCluster), kThreads,
                      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(bids), n, static_cast<int>(head),
      static_cast<int32_t*>(out), static_cast<int32_t*>(partials),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}
