// In-place row scatter with grouped waits, for NVIDIA Hopper (sm_90a): the
// row-copy micro-benchmark's grouped-wait scatter. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel of `make_scatter_grouped`
// (tools/dma_bench.py:182, pallas_call at :228), whose table (with its
// trash row) is aliased to its output: this kernel writes the table in
// place.
//
// Computes, for each batch row j (any N), with the index premultiplied:
//   b = int32(idx[j] * ch)
//   table[b : b+ch, :] = rows[j*ch : j*ch+ch, :]
// The sentinel index (the logical capacity) lands on the trash row; rows
// whose b falls outside the table are skipped (undefined in the
// reference). Valid indices must be unique; the trash row's contents are
// unspecified.
//
// Design. As dma_scatter.cu, one `cp.async.bulk` global->shared copy
// brings a tile of T = 128 KiB / (ch*512) batch rows in, counted on one
// mbarrier, and one thread issues one bulk shared->global store per table
// row. Here GROUP consecutive stores form ONE bulk group (one commit), and
// after each commit the thread waits with `cp.async.bulk.wait_group.read
// NGROUPS-1`: the TPU kernel's grouped semaphore waits, NGROUPS groups in
// flight. The group's stores are one unrolled body, as in the reference.
// `wait_group 0` ends the block.
//
// Bound on this card: bytes, N*ch*512 read in order plus the same written
// at random rows, plus 4 bytes of index per row.

#include "bulk_copy.cuh"

namespace {

template <int NGROUPS, int GROUP>
__global__ void __launch_bounds__(bulk::kThreads)
dma_scatter_grouped_kernel(int4* __restrict__ table, int64_t nphys, int ch,
                           const int32_t* __restrict__ idx, int64_t n,
                           const int4* __restrict__ rows_in) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bulk::Smem s = bulk::carve(smem, ch);
  const int T = bulk::tile_rows(ch);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = static_cast<int>(n - row0 < T ? n - row0 : T);
  const uint32_t row_bytes = ch * bulk::kRowBytes;
  const int per_row = ch * (bulk::kRowBytes / 16);

  if (threadIdx.x == 0) {
    bulk::init_barriers(s.bars, 1);
    bulk::arrive_expect_tx(s.bars, rows * row_bytes);
    bulk::load_async(s.tile, rows_in + row0 * per_row, rows * row_bytes,
                     s.bars);
  }
  bulk::load_indices(s.idx, idx, row0, rows);
  __syncthreads();

  if (threadIdx.x == 0) {
    bulk::wait_parity(s.bars, 0);
    for (int first = 0; first < rows; first += GROUP) {
#pragma unroll
      for (int u = 0; u < GROUP; ++u) {
        const int j = first + u;
        if (j < rows) {
          const int64_t b = bulk::premultiply(s.idx[j], ch);
          if (b >= 0 && b <= nphys - ch)
            bulk::store_async(table + b * (bulk::kRowBytes / 16),
                              s.tile + static_cast<int64_t>(j) * per_row,
                              row_bytes);
        }
      }
      bulk::commit_group();
      bulk::wait_group_read<NGROUPS - 1>();
    }
    bulk::wait_all();
  }
}

}  // namespace

// table: [nphys*128] int32 (nphys = word rows, with the trash row),
// 16-byte aligned; idx: [n] int32 (row indices; the kernel premultiplies);
// rows: [n*ch*128] int32, 16-byte aligned. ngroups and group powers of two
// up to 32. Launches on `stream`; returns the CUDA error (0 on success, 1
// for an argument the kernel does not take).
extern "C" int dma_scatter_grouped(void* table, int64_t nphys, int ch,
                                   const void* idx, int64_t n,
                                   const void* rows, int ngroups, int group,
                                   void* stream) {
  if (n <= 0) return 0;
  if (bulk::tile_rows(ch) < 1) return 1;
  int err = 1;
  bulk::pow2_dispatch(ngroups, [&](auto ng) {
    bulk::pow2_dispatch(group, [&](auto g) {
      err = bulk::launch(
          dma_scatter_grouped_kernel<decltype(ng)::value, decltype(g)::value>,
          n, ch, stream, static_cast<int4*>(table), nphys, ch,
          static_cast<const int32_t*>(idx), n,
          static_cast<const int4*>(rows));
    });
  });
  return err;
}
