// Row gather with grouped waits, for NVIDIA Hopper (sm_90a): the row-copy
// micro-benchmark's grouped-wait gather. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel of `make_gather_grouped`
// (tools/dma_bench.py:114, pallas_call at :164).
//
// Computes, for each batch row j (any N), with the index premultiplied:
//   b = int32(idx[j] * ch)
//   out[j*ch : j*ch+ch, :] = table[clamp(b, 0, nphys-ch) : +ch, :]
// (the reference's out-of-range indices are undefined; these clamp).
//
// Design. As dma_gather.cu, a block stages a tile of T = 128 KiB /
// (ch*512) rows in shared memory and one thread issues one
// `cp.async.bulk` copy per row. Here GROUP consecutive copies count
// towards ONE mbarrier, armed once with `mbarrier.arrive.expect_tx` for
// GROUP*ch*512 bytes: the exact counterpart of the TPU kernel's grouped
// semaphore wait, whose byte count is GROUP rows. `ngroups` barriers form
// the ring (indexed g & (ngroups-1), as the reference), so up to
// ngroups*GROUP rows are in flight, at most the whole tile. The group's
// copies are one unrolled body, as in the reference. The tile then goes
// out with coalesced 16-byte stores by the whole block, as in
// dma_gather.cu, so the two gathers differ only in their waits.
//
// Bound on this card: bytes, N*ch*512 read at random rows plus the same
// written in order, plus 4 bytes of index per row.

#include "bulk_copy.cuh"

namespace {

template <int GROUP>
__global__ void __launch_bounds__(bulk::kThreads)
dma_gather_grouped_kernel(const int4* __restrict__ table, int64_t nphys,
                          int ch, const int32_t* __restrict__ idx, int64_t n,
                          int ngroups, int4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bulk::Smem s = bulk::carve(smem, ch);
  const int T = bulk::tile_rows(ch);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = static_cast<int>(n - row0 < T ? n - row0 : T);
  const int groups = (rows + GROUP - 1) / GROUP;
  const uint32_t row_bytes = ch * bulk::kRowBytes;
  const int per_row = ch * (bulk::kRowBytes / 16);
  const int lg = __ffs(ngroups) - 1;

  bulk::load_indices(s.idx, idx, row0, rows);
  if (threadIdx.x == 0) bulk::init_barriers(s.bars, ngroups);
  __syncthreads();

  if (threadIdx.x == 0) {
    for (int g = 0; g < groups; ++g) {
      uint64_t* bar = s.bars + (g & (ngroups - 1));
      if (g >= ngroups) bulk::wait_parity(bar, ((g >> lg) - 1) & 1);
      const int first = g * GROUP;
      const int count = rows - first < GROUP ? rows - first : GROUP;
      bulk::arrive_expect_tx(bar, count * row_bytes);
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        if (u < count) {
          const int j = first + u;
          int64_t b = bulk::premultiply(s.idx[j], ch);
          b = b < 0 ? 0 : (b > nphys - ch ? nphys - ch : b);
          bulk::load_async(s.tile + static_cast<int64_t>(j) * per_row,
                           table + b * (bulk::kRowBytes / 16), row_bytes,
                           bar);
        }
      }
    }
    for (int g = groups > ngroups ? groups - ngroups : 0; g < groups; ++g)
      bulk::wait_parity(s.bars + (g & (ngroups - 1)), (g >> lg) & 1);
  }
  __syncthreads();
  bulk::acquire_all(s.bars, ngroups, groups);
  bulk::write_tile(out, s.tile, s.idx, row0, rows, ch, 0, 0, 1);
}

}  // namespace

// table: [nphys*128] int32 (nphys = word rows, >= ch), 16-byte aligned;
// idx: [n] int32 (row indices; the kernel premultiplies); out:
// [n*ch*128] int32, 16-byte aligned. ngroups a power of two up to 64,
// group a power of two up to 32, group*ch*512 < 2^20. Launches on
// `stream`; returns the CUDA error (0 on success, 1 for an argument the
// kernel does not take).
extern "C" int dma_gather_grouped(const void* table, int64_t nphys, int ch,
                                  const void* idx, int64_t n, int ngroups,
                                  int group, void* out, void* stream) {
  if (n <= 0) return 0;
  if (ngroups < 1 || ngroups > bulk::kMaxBarriers ||
      (ngroups & (ngroups - 1)) || bulk::tile_rows(ch) < 1 ||
      static_cast<int64_t>(group) * ch * bulk::kRowBytes >= (1 << 20))
    return 1;
  int err = 1;
  bulk::pow2_dispatch(group, [&](auto g) {
    err = bulk::launch(dma_gather_grouped_kernel<decltype(g)::value>, n, ch,
                       stream, static_cast<const int4*>(table), nphys, ch,
                       static_cast<const int32_t*>(idx), n, ngroups,
                       static_cast<int4*>(out));
  });
  return err;
}
