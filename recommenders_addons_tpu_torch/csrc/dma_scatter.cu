// In-place row scatter with one wait per row, for NVIDIA Hopper (sm_90a):
// the row-copy micro-benchmark's per-row-wait scatter. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel of `make_scatter` (tools/dma_bench.py:251,
// pallas_call at :314), whose table is aliased to its output: this kernel
// writes the table in place.
//
// Computes, for each batch row j (any N):
//   b = int32(idx[j] * ch)                       (wraps as the reference)
//   table[b : b+ch, :] = rows[j*ch : j*ch+ch, :]
// where, with `predicated`, only rows whose (premul ? b : idx[j]) lies in
// [0, cap) are written (cap = logical rows less the trash rows); without
// it, a sentinel index lands on the trash row and rows whose b falls
// outside the table are skipped (undefined in the reference). Valid
// indices must be unique; the trash row's contents are unspecified.
//
// Design. A block takes a tile of T = 128 KiB / (ch*512) batch rows. Its
// `rows` are contiguous, so one `cp.async.bulk` global->shared copy of
// the whole tile brings them in, counted on one mbarrier. Then one thread
// issues one `cp.async.bulk` shared->global store per table row, each
// committed as its own bulk group, and after each commit waits with
// `cp.async.bulk.wait_group.read NBUF-1`: the TPU kernel's ring of NBUF
// semaphores, one per copy in flight. The issue loop is unrolled UNROLL
// times. `wait_group 0` ends the block, so its shared memory outlives
// every store that reads it.
//
// Bound on this card: bytes, N*ch*512 read in order plus the same written
// at random rows, plus 4 bytes of index per row.

#include "bulk_copy.cuh"

namespace {

template <int NBUF, int UNROLL>
__global__ void __launch_bounds__(bulk::kThreads)
dma_scatter_kernel(int4* __restrict__ table, int64_t nphys, int ch,
                   const int32_t* __restrict__ idx, int64_t n,
                   const int4* __restrict__ rows_in, int64_t cap,
                   int predicated, int premul) {
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
#pragma unroll (UNROLL)
    for (int j = 0; j < rows; ++j) {
      const int32_t raw = s.idx[j];
      const int64_t b = bulk::premultiply(raw, ch);
      if (predicated ? !bulk::in_cap(raw, ch, cap, premul)
                     : (b < 0 || b > nphys - ch))
        continue;
      bulk::store_async(table + b * (bulk::kRowBytes / 16),
                        s.tile + static_cast<int64_t>(j) * per_row,
                        row_bytes);
      bulk::commit_group();
      bulk::wait_group_read<NBUF - 1>();
    }
    bulk::wait_all();
  }
}

template <int NBUF, int UNROLL>
int run(void* table, int64_t nphys, int ch, const void* idx, int64_t n,
        const void* rows, int64_t cap, int predicated, int premul,
        void* stream) {
  return bulk::launch(dma_scatter_kernel<NBUF, UNROLL>, n, ch, stream,
                      static_cast<int4*>(table), nphys, ch,
                      static_cast<const int32_t*>(idx), n,
                      static_cast<const int4*>(rows), cap, predicated,
                      premul);
}

}  // namespace

// table: [nphys*128] int32 (nphys = word rows), 16-byte aligned; idx: [n]
// int32; rows: [n*ch*128] int32, 16-byte aligned. nbuf and unroll powers
// of two up to 32. Launches on `stream`; returns the CUDA error (0 on
// success, 1 for an argument the kernel does not take).
extern "C" int dma_scatter(void* table, int64_t nphys, int ch,
                           const void* idx, int64_t n, const void* rows,
                           int64_t cap, int nbuf, int unroll, int predicated,
                           int premul, void* stream) {
  if (n <= 0) return 0;
  if (bulk::tile_rows(ch) < 1) return 1;
  int err = 1;
  bulk::pow2_dispatch(nbuf, [&](auto nb) {
    bulk::pow2_dispatch(unroll, [&](auto u) {
      err = run<decltype(nb)::value, decltype(u)::value>(
          table, nphys, ch, idx, n, rows, cap, predicated, premul, stream);
    });
  });
  return err;
}
