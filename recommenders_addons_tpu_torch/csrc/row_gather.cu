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
// of index per row), with no arithmetic to speak of. What keeps a copy
// like this from its bound is latency: a random row's load is a full
// trip to device memory, so the card needs many bytes in flight, and a
// load that must wait for another load first (the row's index) pays the
// trip twice.
//
// Design: a persistent grid (the blocks that fit on the card at once)
// walks the batch's rows x vc chunks in units of kDepth chunks, dealt
// round-robin: warp w takes units w, w + W, w + 2W, ... (W warps), so at
// any time the warps copy neighbouring units and the stores of the whole
// card fill one narrow window of `out` (with each warp writing a span of
// its own instead, every input of the row sweep took 2-5% longer;
// PERF.md). A unit's rows' indices come in one coalesced load, once per
// row (not once per chunk), the next unit's while this one copies; each
// lane then issues its 16-byte load of every one of the unit's kDepth
// chunks (one row's vc chunks, or several rows') before it stores any,
// so a warp holds kDepth x 512 bytes in flight. A chunk's row comes to
// every lane by a shuffle of the lane that loaded its index. Table loads
// go through L1: on the training plan most rows are misses that all read
// the trash row, which then stays in each SM's L1. Stores stream
// (evict-first in L2): on the DLRM step's gather, almost all writes,
// plain stores took 1.3x as long. Offsets are 64-bit: a 4Mi-row table is
// 2 GiB, past int32 byte offsets.

#include "bulk_copy.cuh"

namespace {

constexpr int kVecPerChunk = 32;  // 128 words = 32 int4 = one per lane
constexpr int kWarpsPerBlock = 8;
constexpr int kDepth = 8;         // chunks a lane loads before it stores
constexpr int kBlocksPerSm = 8;   // cap on resident blocks per SM
constexpr unsigned kFull = 0xffffffffu;
static_assert(kDepth <= 32, "a unit's rows' indices are one warp's load");

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_gather_kernel(const int4* __restrict__ table, int64_t nrows, int ch,
                  const int32_t* __restrict__ idx, int64_t n, int vc,
                  int64_t cap, int masked, int4* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  const int64_t items = n * vc;
  // unit u: chunks [u*kDepth, (u+1)*kDepth) in (row, chunk) order; warp
  // w takes units w, w + warps, ..., so the warps copy side by side
  const int64_t step = warps * kDepth;
  const int64_t step_rows = step / vc;
  const int step_c = static_cast<int>(step - step_rows * vc);
  int64_t i0 = w * kDepth;
  int64_t row0 = i0 / vc;
  int c0 = static_cast<int>(i0 - row0 * vc);
  auto load_idx = [&](int64_t r0) {
    return r0 + lane < n ? idx[r0 + lane] : 0;
  };
  int32_t next = i0 < items ? load_idx(row0) : 0;
  for (; i0 < items; i0 += step) {
    const int32_t raw = next;
    int64_t nrow0 = row0 + step_rows;
    int nc0 = c0 + step_c;
    if (nc0 >= vc) {
      nc0 -= vc;
      ++nrow0;
    }
    next = i0 + step < items ? load_idx(nrow0) : 0;
    // this lane's row to read, or -1 for a zero row
    int32_t r = static_cast<int32_t>(
        raw < 0 ? 0 : (raw >= nrows ? nrows - 1 : raw));
    if (masked && !(raw >= 0 && raw < cap)) r = -1;
    int4 v[kDepth];
    int row = 0, c = c0;  // the next chunk to load, from the unit's row0
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      const int32_t rk = __shfl_sync(kFull, r, row & 31);
      v[k] = make_int4(0, 0, 0, 0);
      if (i0 + k < items && rk >= 0) {
        v[k] = __ldg(table + (static_cast<int64_t>(rk) * ch + c) *
                                 kVecPerChunk + lane);
      }
      if (++c == vc) {
        c = 0;
        ++row;
      }
    }
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      if (i0 + k < items) {
        __stcs(out + (i0 + k) * kVecPerChunk + lane, v[k]);
      }
    }
    row0 = nrow0;
    c0 = nc0;
  }
}

}  // namespace

// table: [nrows*ch*128] int32, 16-byte aligned; idx: [n] int32;
// out: [n*vc*128] int32, 16-byte aligned. Launches on `stream` and
// returns the CUDA error (0 on success).
extern "C" int row_gather(const void* table, int64_t nrows, int ch,
                          const void* idx, int64_t n, int vc, int64_t cap,
                          int masked, void* out, void* stream) {
  if (n <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kDepth) * kWarpsPerBlock;
  return bulk::launch_persistent(
      row_gather_kernel, kWarpsPerBlock * 32, 0, kBlocksPerSm,
      (n * vc + per_block - 1) / per_block, stream,
      static_cast<const int4*>(table), nrows, ch,
      static_cast<const int32_t*>(idx), n, vc, cap, masked,
      static_cast<int4*>(out));
}
