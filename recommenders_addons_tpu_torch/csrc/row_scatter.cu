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
// Computes, for each batch row j whose index lies in [0, cap), and each
// chunk c < ch:
//   table[(idx[j]*ch + c), 0:128] = rows[j, c*128 : c*128+128]
// Valid indices must be unique. Words move as int32.
//
// Rows whose index lies outside [0, cap) (the drop sentinel `cap`,
// negatives, past the end) do no work: no load, no store. The TPU kernel
// and the plain version (cuda_ops.py) redirect them to the trash row at
// logical index `cap`, whose contents are unspecified in both packages;
// this kernel leaves that row as it was, as the fused optimizer-scatter
// (fused_update_scatter.cu) has done since it was redesigned. No reader
// of the port uses the trash row's values other than through a select:
// the gathers that read it unmasked (`hashtable.gather_packed` and
// `gather_values` for misses and sentinels, `plan_lookup_train`'s miss
// rows, the writeback's and upsert's old rows, the evicted and demoted
// rows) take those rows only where `found` (or `displaced`, `valid`) is
// false and replace them with `torch.where`, or scatter them back to the
// trash row; `scatter_rows_set` appends a transient trash row and slices
// it off; saves, exports and grow copy rows [0, cap) only.
//
// Bound on this card: bytes. Per valid row ch*512 B read in order and
// the same written at a random row, plus 4 bytes of index per batch row.
// On an f64 step's writeback about 70% of the rows are bound for the
// trash row; storing them all would put tens of thousands of rows onto
// the same 2 KiB, one after another in L2.
//
// Design: a persistent grid (the blocks that fit on the card at once)
// walks the batch in units of kDepth rows, dealt round-robin: warp w
// takes units w, w + W, w + 2W, ... (W warps), so at any time the warps
// read neighbouring rows of `rows`. A unit's indices come in one
// coalesced load (the next unit's while this one copies), and a ballot
// gives its valid rows; popcount of the ballot and its lowest set bit
// walk them in order, so only their chunks are copied, and a unit of
// trash costs one index load. The valid rows' ch chunks are copied
// kDepth at a time: each lane issues its 16-byte load of every one of
// kDepth chunks before it stores any, so a warp holds kDepth x 512 bytes
// in flight; loads and stores stream (evict-first in L2: each row is
// read once and written once). No second launch, prefix sum, atomic or
// host sync. A chunk's place in the table is kept as an int32 chunk index
// (a table of 2^31 chunks would be 1 TiB), byte offsets are 64-bit.

#include "bulk_copy.cuh"

namespace {

constexpr int kVecPerChunk = 32;  // 128 words = 32 int4 = one per lane
constexpr int kWarpsPerBlock = 8;
constexpr int kDepth = 8;         // chunks a lane loads before it stores
constexpr int kBlocksPerSm = 8;   // cap on resident blocks per SM
constexpr unsigned kFull = 0xffffffffu;
static_assert(kDepth <= 32, "a unit's indices are one warp's load");

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
row_scatter_kernel(int4* __restrict__ table, int64_t cap, int ch,
                   const int32_t* __restrict__ idx, int64_t n,
                   const int4* __restrict__ rows) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                    (threadIdx.x >> 5);
  // unit u: rows [u*kDepth, (u+1)*kDepth); warp w takes units w,
  // w + warps, ..., so the warps copy side by side
  const int64_t step = warps * kDepth;
  int64_t base = w * kDepth;
  auto load_idx = [&](int64_t b) {
    return lane < kDepth && b + lane < n ? idx[b + lane] : -1;
  };
  int32_t next = base < n ? load_idx(base) : -1;
  for (; base < n; base += step) {
    const int32_t raw = next;
    next = base + step < n ? load_idx(base + step) : -1;
    unsigned left = __ballot_sync(kFull, raw >= 0 && raw < cap);
    const int items = __popc(left) * ch;
    const int4* __restrict__ src = rows + base * ch * kVecPerChunk + lane;
    int from = __ffs(left) - 1;  // the lane of the next valid row
    left &= left - 1;
    int c = 0;  // and its next chunk
    for (int i0 = 0; i0 < items; i0 += kDepth) {
      int4 v[kDepth];
      int32_t to[kDepth];  // the table chunk each goes to
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        const int32_t r = __shfl_sync(kFull, raw, from & 31);
        if (i0 + k < items) {
          v[k] = __ldcs(src + (from * ch + c) * kVecPerChunk);
          to[k] = r * ch + c;
        }
        if (++c == ch) {
          c = 0;
          from = __ffs(left) - 1;
          left &= left - 1;
        }
      }
#pragma unroll
      for (int k = 0; k < kDepth; ++k) {
        if (i0 + k < items) {
          __stcs(table + static_cast<int64_t>(to[k]) * kVecPerChunk + lane,
                 v[k]);
        }
      }
    }
  }
}

}  // namespace

// table: [(cap+1)*ch*128] int32 (at least), 16-byte aligned; idx: [n]
// int32; rows: [n*ch*128] int32, 16-byte aligned. Launches on `stream` and
// returns the CUDA error (0 on success).
extern "C" int row_scatter(void* table, int64_t cap, int ch, const void* idx,
                           int64_t n, const void* rows, void* stream) {
  if (n <= 0) return 0;
  const int64_t per_block = static_cast<int64_t>(kDepth) * kWarpsPerBlock;
  return bulk::launch_persistent(
      row_scatter_kernel, kWarpsPerBlock * 32, 0, kBlocksPerSm,
      (n + per_block - 1) / per_block, stream,
      static_cast<int4*>(table), cap, ch, static_cast<const int32_t*>(idx),
      n, static_cast<const int4*>(rows));
}
