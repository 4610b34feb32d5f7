// 1,024-bin histogram of bucket ids for NVIDIA Hopper (sm_90a): the
// radix-partition probe's binning primitive. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel `_hist_kernel` behind `pallas_hist`
// (tools/ab_radix_plan.py:140, kernel at :114, pallas_call at :144), which
// carries one SMEM histogram across its sequential grid.
//
// Computes, for any N:
//   out[k] = #{ j : (bids[j] & 1023) == k },  k in [0, 1024)
// on int32 ids, so a negative id lands in a high bin as in the reference.
// Integer counts do not depend on the order of the additions, so the
// result is exact whatever order the atomics land in.
//
// Design. Blocks run in parallel, so nothing carries across them: each
// block zeroes a shared int[1024], adds its grid-stride share of the keys
// with shared-memory atomics, then adds its nonzero bins to `out` with
// global atomics. `out` is zeroed on the launch's stream first.
//
// Bound on this card: bytes, 4 per key read plus the 4 KiB written, far
// below one launch at the sizes the probe runs (65,536 keys: 0.08 us).
// Launch latency is the floor; the per-key slope is the yardstick.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBins = 1024;
constexpr int kThreads = 512;
constexpr int kKeysPerThread = 8;
constexpr int64_t kMaxBlocks = 1056;  // 8 blocks on each of 132 SMs

__global__ void __launch_bounds__(kThreads)
radix_hist_kernel(const int32_t* __restrict__ bids, int64_t n,
                  int32_t* __restrict__ out) {
  __shared__ int32_t hist[kBins];
  for (int k = threadIdx.x; k < kBins; k += blockDim.x) hist[k] = 0;
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       j < n; j += stride)
    atomicAdd(&hist[bids[j] & (kBins - 1)], 1);
  __syncthreads();
  for (int k = threadIdx.x; k < kBins; k += blockDim.x)
    if (hist[k]) atomicAdd(&out[k], hist[k]);
}

}  // namespace

// bids: [n] int32; out: [1024] int32. Zeroes `out` and launches on
// `stream`; returns the CUDA error (0 on success).
extern "C" int radix_hist(const void* bids, int64_t n, void* out,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, kBins * sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads * kKeysPerThread - 1) /
                   (kThreads * kKeysPerThread);
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  radix_hist_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int32_t*>(bids), n, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
