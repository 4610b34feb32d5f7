// Row gather from a dynamic-embedding table's physical container, for
// NVIDIA Hopper (sm_90a). Built by recommenders_addons_tpu_torch/ops/cuda_ops.py
// with nvcc into a shared library with a plain C interface.
//
// Replaces the Pallas TPU kernel `_gather_kernel`
// (recommenders_addons_tpu/ops/pallas_ops.py:165, called through
// `gather_rows_2d`, pallas_ops.py:216).
//
// Computes, for each batch row j and value chunk c < vc:
//   r = clamp(idx[j], 0, nrows - 1)
//   out[j, c*128 : c*128+128] = table[(r*ch + c), 0:128]
// and, when `masked`, zeros instead where idx[j] lies outside [0, cap).
// The table is the [(C+1)*ch, 128] container of 32-bit words (f32, or
// f16/bf16 pairs, moved as int32 so NaN bit patterns pass untouched).
// `ch` is the row stride in chunks and `vc` the chunks copied per row, so
// the serving path fetches only a row's value chunks.
//
// Bound on this card: bytes. The work is pure data movement, N*vc*512
// bytes read at random rows plus the same written in order (plus 4 bytes
// of index per row), with no arithmetic to speak of. The design keeps
// every byte moved useful and wide: one warp per 512-byte chunk, each of
// its 32 lanes moving one aligned 16-byte int4, so a chunk is one fully
// coalesced load and one coalesced store. Lane 0 reads the row's index
// once and broadcasts it with a shuffle. Offsets are 64-bit: a 4Mi-row
// table is 2 GiB, past int32 byte offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kVecPerChunk = 32;  // 128 words = 32 int4 = one per lane
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_kernel(const int4* __restrict__ table, int64_t nrows, int ch,
                  const int32_t* __restrict__ idx, int64_t n, int vc,
                  int64_t cap, int masked, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t total = n * vc;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       w < total; w += stride) {
    const int64_t j = w / vc;
    const int64_t c = w - j * vc;
    int32_t raw = 0;
    if (lane == 0) raw = idx[j];
    raw = __shfl_sync(0xffffffffu, raw, 0);
    int4 v = make_int4(0, 0, 0, 0);
    if (!masked || (raw >= 0 && raw < cap)) {
      const int64_t r = raw < 0 ? 0 : (raw >= nrows ? nrows - 1 : raw);
      v = table[(r * ch + c) * kVecPerChunk + lane];
    }
    out[w * kVecPerChunk + lane] = v;
  }
}

}  // namespace

// table: [nrows*ch*128] int32, 16-byte aligned; idx: [n] int32;
// out: [n*vc*128] int32, 16-byte aligned. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int row_gather(const void* table, int64_t nrows, int ch,
                          const void* idx, int64_t n, int vc, int64_t cap,
                          int masked, void* out, void* stream) {
  const int64_t total = n * vc;
  if (total <= 0) return 0;
  int64_t blocks = (total + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop strides the rest
  row_gather_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(table), nrows, ch,
      static_cast<const int32_t*>(idx), n, vc, cap, masked,
      static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
