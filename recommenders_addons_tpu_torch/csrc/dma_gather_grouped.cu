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
// Design: a persistent, warp-specialised pipeline (bulk_copy.cuh,
// "Persistent pipelines"). The grid is the blocks that fit on the card
// (at most kBlocksPerSm per SM); each walks its share of the N rows
// (units dealt round-robin, the last round split evenly: bulk::Share) in
// stages of R = max(1, kStageBytes / (ch*512)) rows through a ring of
// kStages stages in shared memory (fewer where rows are big: at ch = 256
// one 128 KiB row, one stage). One producer warp issues one
// `cp.async.bulk` global->shared copy per row, lane l the batch's row l,
// with an evict-first L2 policy (each row is read once).
// GROUP consecutive rows of a stage count towards ONE mbarrier, which the
// group's first lane arms with `mbarrier.arrive.expect_tx` for the
// group's bytes before the lanes issue its copies: the counterpart of the
// TPU kernel's grouped semaphore wait. Before it arms group g the
// producer waits for group g - ngroups, so `ngroups` groups are in
// flight, at most the ring's rows. Four consumer warps wait for a stage's
// groups, write its rows out with coalesced 16-byte streaming stores
// (four loads in flight per thread) and arrive on the stage's "empty"
// barrier, which the producer waits on before it refills the slot. So
// while one stage is stored the next ones load, in every block on the SM.
// (One bulk shared->global store per stage in place of the consumers'
// stores measured no faster: PERF.md.)
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

// Group barriers per stage.
__host__ __device__ inline int group_bars(bulk::Ring r, int group) {
  return (r.rows + group - 1) / group;
}

template <int GROUP>
__global__ void __launch_bounds__(bulk::kPipeThreads)
dma_gather_grouped_kernel(const int4* __restrict__ table, int64_t nphys,
                          int ch, const int32_t* __restrict__ idx, int64_t n,
                          int ngroups, bulk::Ring ring,
                          int4* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = ring.stages, R = ring.rows;
  const int gps = group_bars(ring, GROUP);
  const uint32_t row_bytes = ch * bulk::kRowBytes;
  const int per_row = ch * (bulk::kRowBytes / 16);
  int4* data = reinterpret_cast<int4*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(S) * R * row_bytes);
  uint64_t* empty = full + S * gps;
  const bulk::Share share(n, R);
  const int nst = share.stages();
  const int warp = threadIdx.x / bulk::kWarp;
  const int lane = threadIdx.x % bulk::kWarp;

  if (threadIdx.x == 0) {
    bulk::init_barriers(full, S * gps, 1);
    bulk::init_barriers(empty, S, bulk::kPipeConsumers);
  }
  __syncthreads();

  if (warp == 0) {
    // Producer. A batch is up to 32 rows: 32 / GROUP groups, lane l row
    // l % GROUP of group l / GROUP, but never more groups than ngroups
    // (a group waits for the one ngroups before it).
    constexpr int kBatchGroups = bulk::kWarp / GROUP;
    const int gb = kBatchGroups < ngroups ? kBatchGroups : ngroups;
    const int batch = gb * GROUP;
    const int sub = lane / GROUP, r = lane % GROUP;
    const uint64_t policy = bulk::evict_first_policy();
    int32_t raw = share.index(idx, 0, 0, batch);
    for (int k = 0; k < nst; ++k) {
      const int s = k % S;
      if (k >= S) bulk::wait_parity(empty + s, ((k / S) - 1) & 1);
      const int rows = share.count(k);
      const int groups = (rows + GROUP - 1) / GROUP;
      int4* stage = data + static_cast<size_t>(s) * R * per_row;
      for (int g0 = 0; g0 < groups; g0 += gb) {
        const int i0 = g0 * GROUP;
        const int32_t ahead = i0 + batch < rows
                                  ? share.index(idx, k, i0 + batch, batch)
                                  : share.index(idx, k + 1, 0, batch);
        const int gl = g0 + sub;
        const bool live = sub < gb && gl < groups;
        uint64_t* bar = full + s * gps + gl;
        if (live && r == 0) {
          // group g = k*gps + gl waits for g - ngroups, unless that
          // group's stage was already released (stage <= k - S)
          const int64_t gw = static_cast<int64_t>(k) * gps + gl - ngroups;
          if (gw >= 0 && gw / gps > k - S) {
            const int64_t kw = gw / gps;
            bulk::wait_parity(full + (kw % S) * gps + gw % gps,
                              (kw / S) & 1);
          }
          const int count = rows - gl * GROUP < GROUP ? rows - gl * GROUP
                                                      : GROUP;
          bulk::arrive_expect_tx(bar, count * row_bytes);
        }
        __syncwarp();
        const int i = gl * GROUP + r;
        if (live && i < rows) {
          int64_t b = bulk::premultiply(raw, ch);
          b = b < 0 ? 0 : (b > nphys - ch ? nphys - ch : b);
          bulk::load_async(stage + static_cast<size_t>(i) * per_row,
                           table + b * (bulk::kRowBytes / 16), row_bytes,
                           bar, policy);
        }
        raw = ahead;
      }
    }
  } else {
    // Consumers: every thread waits for the stage's groups, then the
    // stage goes out as 16-byte stores.
    for (int k = 0; k < nst; ++k) {
      const int s = k % S;
      const int rows = share.count(k);
      for (int g = 0; g < (rows + GROUP - 1) / GROUP; ++g)
        bulk::wait_parity(full + s * gps + g, (k / S) & 1);
      bulk::put_stage(out + share.row0(k) * per_row,
                      data + static_cast<size_t>(s) * R * per_row, rows, ch,
                      [](int) { return false; });
      __syncwarp();
      if (lane == 0) bulk::arrive(empty + s);
    }
  }
}

}  // namespace

// table: [nphys*128] int32 (nphys = word rows, >= ch), 16-byte aligned;
// idx: [n] int32 (row indices; the kernel premultiplies); out:
// [n*ch*128] int32, 16-byte aligned. 1 <= ch <= 256, ngroups a power of
// two up to 64, group a power of two up to 32, group*ch*512 < 2^20.
// Launches on `stream`; returns the CUDA error (0 on success, 1 for an
// argument the kernel does not take).
extern "C" int dma_gather_grouped(const void* table, int64_t nphys, int ch,
                                  const void* idx, int64_t n, int ngroups,
                                  int group, void* out, void* stream) {
  if (n <= 0) return 0;
  if (ch < 1 || ch > 256 || ngroups < 1 || ngroups > bulk::kMaxBarriers ||
      (ngroups & (ngroups - 1)) ||
      static_cast<int64_t>(group) * ch * bulk::kRowBytes >= (1 << 20))
    return 1;
  int err = 1;
  bulk::pow2_dispatch(group, [&](auto g) {
    constexpr int G = decltype(g)::value;
    const auto nbars = [](bulk::Ring r) {
      return r.stages * (group_bars(r, G) + 1);
    };
    const bulk::Ring ring = bulk::make_ring(ch, kStageBytes, kStages, nbars);
    err = bulk::launch_persistent(
        dma_gather_grouped_kernel<G>, bulk::kPipeThreads,
        bulk::ring_smem(ring, ch, nbars(ring)), kBlocksPerSm,
        (n + ring.rows - 1) / ring.rows, stream,
        static_cast<const int4*>(table), nphys, ch,
        static_cast<const int32_t*>(idx), n, ngroups, ring,
        static_cast<int4*>(out));
  });
  return err;
}
