// Row gather with one wait per row, for NVIDIA Hopper (sm_90a): the
// row-copy micro-benchmark's per-row-wait gather. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel of `make_gather` (tools/dma_bench.py:32,
// pallas_call at :96).
//
// Computes, for each batch row j (any N):
//   b = int32(idx[j] * ch)                       (wraps as the reference)
//   out[j*ch : j*ch+ch, :] = table[clamp(b, 0, nphys-ch) : +ch, :]
// and with `predicated`, zeros where (premul ? b : idx[j]) lies outside
// [0, cap) (the reference leaves those rows unwritten). `premul` only
// picks what the predicate tests, as in the reference.
//
// Design. A block stages a tile of T = 128 KiB / (ch*512) rows in shared
// memory. One thread issues one `cp.async.bulk` global->shared copy per
// row (ch*512 bytes), counted in the transaction bytes of a ring of `nbuf`
// mbarriers, one per copy in flight: the TPU kernel's ring of DMA
// semaphores. Before copy j reuses barrier j % nbuf (j & (nbuf-1) with
// `bitand`) it waits for that barrier's previous phase, copy j - nbuf. The
// issue loop is unrolled UNROLL times. A predicated-off row arrives on its
// barrier without bytes, so every barrier's phases stay in step with its
// copies. After the drain, the block writes the tile out with coalesced
// 16-byte stores; that pass also writes the zeros of predicated-off rows,
// which a bulk shared->global store could only do after zeroing their
// slots with ordinary stores and a proxy fence.
//
// Bound on this card: bytes, N*ch*512 read at random rows plus the same
// written in order, plus 4 bytes of index per row.

#include "bulk_copy.cuh"

namespace {

template <int UNROLL, bool BITAND>
__global__ void __launch_bounds__(bulk::kThreads)
dma_gather_kernel(const int4* __restrict__ table, int64_t nphys, int ch,
                  const int32_t* __restrict__ idx, int64_t n, int64_t cap,
                  int nbuf, int predicated, int premul,
                  int4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const bulk::Smem s = bulk::carve(smem, ch);
  const int T = bulk::tile_rows(ch);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = static_cast<int>(n - row0 < T ? n - row0 : T);
  const uint32_t row_bytes = ch * bulk::kRowBytes;
  const int per_row = ch * (bulk::kRowBytes / 16);
  const int lg = __ffs(nbuf) - 1;  // log2(nbuf) when `bitand`

  bulk::load_indices(s.idx, idx, row0, rows);
  if (threadIdx.x == 0) bulk::init_barriers(s.bars, nbuf);
  __syncthreads();

  if (threadIdx.x == 0) {
#pragma unroll (UNROLL)
    for (int j = 0; j < rows; ++j) {
      const int slot = BITAND ? (j & (nbuf - 1)) : (j % nbuf);
      const int phase = BITAND ? (j >> lg) : (j / nbuf);
      uint64_t* bar = s.bars + slot;
      if (j >= nbuf) bulk::wait_parity(bar, (phase - 1) & 1);
      const int32_t raw = s.idx[j];
      if (predicated && !bulk::in_cap(raw, ch, cap, premul)) {
        bulk::arrive(bar);
        continue;
      }
      int64_t b = bulk::premultiply(raw, ch);
      b = b < 0 ? 0 : (b > nphys - ch ? nphys - ch : b);
      bulk::arrive_expect_tx(bar, row_bytes);
      bulk::load_async(s.tile + static_cast<int64_t>(j) * per_row,
                       table + b * (bulk::kRowBytes / 16), row_bytes, bar);
    }
    for (int j = rows > nbuf ? rows - nbuf : 0; j < rows; ++j)
      bulk::wait_parity(s.bars + j % nbuf, (j / nbuf) & 1);
  }
  __syncthreads();
  bulk::acquire_all(s.bars, nbuf, rows);
  bulk::write_tile(out, s.tile, s.idx, row0, rows, ch, cap, predicated,
                   premul);
}

template <int UNROLL, bool BITAND>
int run(const void* table, int64_t nphys, int ch, const void* idx, int64_t n,
        int64_t cap, int nbuf, int predicated, int premul, void* out,
        void* stream) {
  return bulk::launch(dma_gather_kernel<UNROLL, BITAND>, n, ch, stream,
                      static_cast<const int4*>(table), nphys, ch,
                      static_cast<const int32_t*>(idx), n, cap, nbuf,
                      predicated, premul, static_cast<int4*>(out));
}

}  // namespace

// table: [nphys*128] int32 (nphys = word rows, >= ch), 16-byte aligned;
// idx: [n] int32; out: [n*ch*128] int32, 16-byte aligned. 1 <= nbuf <= 64
// (a power of two with `bitand`); unroll a power of two up to 32. Launches
// on `stream`; returns the CUDA error (0 on success, 1 for an argument the
// kernel does not take).
extern "C" int dma_gather(const void* table, int64_t nphys, int ch,
                          const void* idx, int64_t n, int64_t cap, int nbuf,
                          int bitand_, int unroll, int predicated, int premul,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  if (nbuf < 1 || nbuf > bulk::kMaxBarriers ||
      (bitand_ && (nbuf & (nbuf - 1))) || bulk::tile_rows(ch) < 1)
    return 1;
  int err = 1;
  bulk::pow2_dispatch(unroll, [&](auto u) {
    constexpr int U = decltype(u)::value;
    err = bitand_ ? run<U, true>(table, nphys, ch, idx, n, cap, nbuf,
                                 predicated, premul, out, stream)
                  : run<U, false>(table, nphys, ch, idx, n, cap, nbuf,
                                  predicated, premul, out, stream);
  });
  return err;
}
