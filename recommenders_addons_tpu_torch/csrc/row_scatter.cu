// In-place row scatter into a dynamic-embedding table's physical
// container, for NVIDIA Hopper (sm_90a). Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel `_scatter_kernel`
// (recommenders_addons_tpu/ops/pallas_ops.py:192, called through
// `scatter_rows_set_2d`, pallas_ops.py:271), whose table is aliased to
// its output: this kernel writes the table in place the same way.
//
// Computes, for each batch row j and chunk c < ch:
//   r = idx[j] if 0 <= idx[j] < cap else cap      (the trash row)
//   table[(r*ch + c), 0:128] = rows[j, c*128 : c*128+128]
// Valid indices must be unique; every invalid or sentinel index lands on
// the trash row at logical index `cap`, so the copy has no branch around
// dropped rows. Several warps may write the trash row at once: its
// contents are unspecified, as on the TPU. Words move as int32.
//
// Bound on this card: bytes, N*ch*512 read in order plus the same
// written at random rows (plus 4 bytes of index per row). One warp per
// 512-byte chunk, each lane one aligned 16-byte int4, so every chunk is
// one coalesced load and one coalesced store; lane 0 reads the index once
// and broadcasts it. Offsets are 64-bit (a 4Mi-row table is 2 GiB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVecPerChunk = 32;  // 128 words = 32 int4 = one per lane
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_scatter_kernel(int4* __restrict__ table, int64_t cap, int ch,
                   const int32_t* __restrict__ idx, int64_t n,
                   const int4* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int64_t total = n * ch;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       w < total; w += stride) {
    const int64_t j = w / ch;
    const int64_t c = w - j * ch;
    int32_t raw = 0;
    if (lane == 0) raw = idx[j];
    raw = __shfl_sync(0xffffffffu, raw, 0);
    const int64_t r = (raw >= 0 && raw < cap) ? raw : cap;
    table[(r * ch + c) * kVecPerChunk + lane] = rows[w * kVecPerChunk + lane];
  }
}

}  // namespace

// table: [(cap+1)*ch*128] int32 (at least), 16-byte aligned; idx: [n]
// int32; rows: [n*ch*128] int32, 16-byte aligned. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int row_scatter(void* table, int64_t cap, int ch, const void* idx,
                           int64_t n, const void* rows, void* stream) {
  const int64_t total = n * ch;
  if (total <= 0) return 0;
  int64_t blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop strides the rest
  row_scatter_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<int4*>(table), cap, ch, static_cast<const int32_t*>(idx), n,
      static_cast<const int4*>(rows));
  return static_cast<int>(cudaGetLastError());
}
