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
// Design: the persistent, warp-specialised pipeline of
// dma_gather_grouped.cu (bulk_copy.cuh, "Persistent pipelines"): blocks
// that fit on the card (at most kBlocksPerSm per SM) walk their shares of
// the rows (bulk::Share) in stages of R = max(1, kStageBytes / (ch*512))
// rows through a ring of kStages stages; one producer warp issues one
// `cp.async.bulk` copy per row (evict-first), lane l the batch's row l;
// four consumer warps store the stages with 16-byte streaming stores. Here each copy
// counts on its own mbarrier in a ring of `nbuf`, the TPU kernel's ring of
// DMA semaphores, used over the block's whole life: its j-th row (j
// counts the block's rows across stages) takes slot j % nbuf
// (j & (nbuf-1) with `bitand`) in phase j / nbuf, and its lane first
// waits for that slot's previous phase, copy j - nbuf. A batch is
// min(32, nbuf) rows, so no lane waits for a copy of its own batch. A
// predicated-off row arrives on its slot without bytes, so the phases
// stay in step. The issue loop is unrolled UNROLL times.
//
// The ring's phases cannot tell a stage's consumers when its rows are in
// (a slot moves on to later rows while they wait), so the producer does:
// its lanes have seen rows [0, seen) land (the rows they waited for, and
// before refilling a slot every row of the stage it holds), and once a
// stage's rows are all seen, each lane arrives on the stage's "full"
// barrier (32 arrivals: each lane releases what it acquired). Consumers
// wait on it once per stage, write the rows out (zeros for predicated-off
// rows), and arrive on the stage's "empty" barrier.
//
// Bound on this card: bytes, N*ch*512 read at random rows plus the same
// written in order, plus 4 bytes of index per row: 0.0398 ms at
// N = 65,536 rows of 1 KiB over the NVIDIA H100 80GB HBM3's 3.35 TB/s
// (data sheet). Measured times in PERF.md.

#include "bulk_copy.cuh"

namespace {

// The ring's geometry, from the port's tools/gather_sweep.py grid (16-64 KiB
// stages, 2-8 stages, 1-3 blocks per SM) on an NVIDIA H100 80GB HBM3 at
// 700 W: all within ~2% with 2-3 blocks an SM, slower with one (PERF.md).
constexpr int kStageBytes = 32 * 1024;  // rows of one stage (>= one row)
constexpr int kStages = 2;              // slots in the ring
constexpr int kBlocksPerSm = 3;         // cap on resident blocks per SM

template <int UNROLL, bool BITAND>
__global__ void __launch_bounds__(bulk::kPipeThreads)
dma_gather_kernel(const int4* __restrict__ table, int64_t nphys, int ch,
                  const int32_t* __restrict__ idx, int64_t n, int64_t cap,
                  int nbuf, int predicated, int premul, bulk::Ring ring,
                  int4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = ring.stages, R = ring.rows;
  const uint32_t row_bytes = ch * bulk::kRowBytes;
  const int per_row = ch * (bulk::kRowBytes / 16);
  int4* data = reinterpret_cast<int4*>(smem);
  uint64_t* slots = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(S) * R * row_bytes);
  uint64_t* full = slots + nbuf;
  uint64_t* empty = full + S;
  const bulk::Share share(n, R);
  const int nst = share.stages();
  const int total = share.total();
  const int warp = threadIdx.x / bulk::kWarp;
  const int lane = threadIdx.x % bulk::kWarp;

  if (threadIdx.x == 0) {
    bulk::init_barriers(slots, nbuf, 1);
    bulk::init_barriers(full, S, bulk::kWarp);
    bulk::init_barriers(empty, S, bulk::kPipeConsumers);
  }
  __syncthreads();

  if (warp == 0) {
    // Producer. j counts the share's rows; each lane loads its index one
    // batch ahead.
    const int lg = __ffs(nbuf) - 1;  // log2(nbuf) when `bitand`
    const int batch = nbuf < bulk::kWarp ? nbuf : bulk::kWarp;
    int seen = 0;       // rows [0, seen) have landed
    int signalled = 0;  // stages [0, signalled) arrived on `full`
    const auto slot = [&](int j) {
      return slots + (BITAND ? (j & (nbuf - 1)) : (j % nbuf));
    };
    const auto phase = [&](int j) { return BITAND ? (j >> lg) : (j / nbuf); };
    const auto signal = [&]() {
      while (signalled < nst &&
             ((signalled + 1) * R < total ? (signalled + 1) * R : total) <=
                 seen) {
        bulk::arrive(full + signalled % S);
        ++signalled;
      }
    };
    // Wait for rows [seen, upto): none of their slots has moved on.
    const auto see = [&](int upto) {
      for (int j = seen + lane; j < upto; j += bulk::kWarp)
        bulk::wait_parity(slot(j), phase(j) & 1);
      __syncwarp();
      if (upto > seen) seen = upto;
      signal();
    };
    const uint64_t policy = bulk::evict_first_policy();
    int32_t raw = share.index(idx, 0, 0, batch);
    for (int k = 0; k < nst; ++k) {
      const int s = k % S;
      if (k >= S) {  // stage k - S holds the slot: its rows, then its end
        see((k - S + 1) * R);
        bulk::wait_parity(empty + s, ((k / S) - 1) & 1);
      }
      const int rows = share.count(k);
      const int j0 = k * R;
      int4* stage = data + static_cast<size_t>(s) * R * per_row;
#pragma unroll (UNROLL)
      for (int i = 0; i < rows; i += batch) {
        const int32_t ahead = i + batch < rows
                                  ? share.index(idx, k, i + batch, batch)
                                  : share.index(idx, k + 1, 0, batch);
        const int cnt = rows - i < batch ? rows - i : batch;
        if (lane < cnt) {
          const int j = j0 + i + lane;
          uint64_t* bar = slot(j);
          if (j >= nbuf) bulk::wait_parity(bar, (phase(j) - 1) & 1);
          if (predicated && !bulk::in_cap(raw, ch, cap, premul)) {
            bulk::arrive(bar);
          } else {
            int64_t b = bulk::premultiply(raw, ch);
            b = b < 0 ? 0 : (b > nphys - ch ? nphys - ch : b);
            bulk::arrive_expect_tx(bar, row_bytes);
            bulk::load_async(stage + static_cast<size_t>(i + lane) * per_row,
                             table + b * (bulk::kRowBytes / 16), row_bytes,
                             bar, policy);
          }
        }
        __syncwarp();
        // the lanes waited for rows j - nbuf of every row j issued so far
        if (j0 + i + cnt - nbuf > seen) seen = j0 + i + cnt - nbuf;
        signal();
        raw = ahead;
      }
    }
    see(total);
  } else {
    // Consumers: wait for the stage, then write it out as 16-byte stores,
    // zeros for predicated-off rows.
    for (int k = 0; k < nst; ++k) {
      const int s = k % S;
      bulk::wait_parity(full + s, (k / S) & 1);
      const int64_t row0 = share.row0(k);
      bulk::put_stage(
          out + row0 * per_row, data + static_cast<size_t>(s) * R * per_row,
          share.count(k), ch, [&](int i) {
            return predicated && !bulk::in_cap(idx[row0 + i], ch, cap, premul);
          });
      __syncwarp();
      if (lane == 0) bulk::arrive(empty + s);
    }
  }
}

template <int UNROLL, bool BITAND>
int run(const void* table, int64_t nphys, int ch, const void* idx, int64_t n,
        int64_t cap, int nbuf, int predicated, int premul, void* out,
        void* stream) {
  const auto nbars = [nbuf](bulk::Ring r) { return nbuf + 2 * r.stages; };
  const bulk::Ring ring = bulk::make_ring(ch, kStageBytes, kStages, nbars);
  return bulk::launch_persistent(
      dma_gather_kernel<UNROLL, BITAND>, bulk::kPipeThreads,
      bulk::ring_smem(ring, ch, nbars(ring)), kBlocksPerSm,
      (n + ring.rows - 1) / ring.rows, stream,
      static_cast<const int4*>(table), nphys, ch,
      static_cast<const int32_t*>(idx), n, cap, nbuf, predicated, premul,
      ring, static_cast<int4*>(out));
}

}  // namespace

// table: [nphys*128] int32 (nphys = word rows, >= ch), 16-byte aligned;
// idx: [n] int32; out: [n*ch*128] int32, 16-byte aligned. 1 <= ch <= 256,
// 1 <= nbuf <= 64 (a power of two with `bitand`); unroll a power of two up
// to 32. Launches on `stream`; returns the CUDA error (0 on success, 1 for
// an argument the kernel does not take).
extern "C" int dma_gather(const void* table, int64_t nphys, int ch,
                          const void* idx, int64_t n, int64_t cap, int nbuf,
                          int bitand_, int unroll, int predicated, int premul,
                          void* out, void* stream) {
  if (n <= 0) return 0;
  if (ch < 1 || ch > 256 || nbuf < 1 || nbuf > bulk::kMaxBarriers ||
      (bitand_ && (nbuf & (nbuf - 1))))
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
