// Hopper (sm_90a) bulk-copy and mbarrier primitives as inline PTX, shared
// by the row-copy micro-benchmark kernels (dma_gather*.cu, dma_scatter*.cu)
// and the fused optimizer-scatter (fused_update_scatter.cu).
//
// A TPU kernel's async copy signalling a DMA semaphore maps onto a
// `cp.async.bulk` copy whose completion is counted in an mbarrier's
// transaction bytes (global -> shared), or onto a bulk async-group that
// `cp.async.bulk.wait_group` waits on (shared -> global). Addresses and
// sizes must be multiples of 16 bytes; one mbarrier phase counts at most
// 2^20 - 1 transaction bytes.

#pragma once

#include <cstdint>
#include <mutex>
#include <type_traits>
#include <vector>

#include <cuda_runtime.h>

namespace bulk {

constexpr int kRowBytes = 512;  // one 128-word chunk of 32-bit words

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Initialise `count` mbarriers expecting `arrivals` arrivals per phase,
// and make the initialisation visible to the async proxy. Called by one
// thread; the caller then syncs the block.
__device__ __forceinline__ void init_barriers(uint64_t* bars, int count,
                                              int arrivals = 1) {
  for (int i = 0; i < count; ++i) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_addr(bars + i)),
                 "r"(arrivals)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once on `bar` and add `bytes` to the transaction count that the
// current phase waits for.
__device__ __forceinline__ void arrive_expect_tx(uint64_t* bar,
                                                 uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Arrive once on `bar` with no transaction bytes: the phase completes at
// once (a predicated-off copy keeps its barrier's phase count in step).
__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void wait_parity(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" ::"r"(addr),
      "r"(parity)
      : "memory");
}

// Copy `bytes` from global `src` to shared `dst`; the copy's bytes count
// towards `bar`'s current phase.
__device__ __forceinline__ void load_async(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// As load_async, with an L2 policy from evict_first_policy(): the row is
// read once, so its lines go first.
__device__ __forceinline__ void load_async(void* dst, const void* src,
                                           uint32_t bytes, uint64_t* bar,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Order this thread's generic-proxy writes to shared memory before later
// bulk copies (async proxy) that read them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// Copy `bytes` from shared `src` to global `dst` in the open bulk group.
__device__ __forceinline__ void store_async(void* dst, const void* src,
                                            uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N bulk groups still read their shared source.
template <int N>
__device__ __forceinline__ void wait_group_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until every bulk group has completed.
__device__ __forceinline__ void wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// What the four row-copy kernels share
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kTileBytes = 128 * 1024;  // a tile of rows staged in shared
constexpr int kMaxBarriers = 64;

// Rows per tile: as many rows of `ch` chunks as fill kTileBytes.
__host__ __device__ inline int tile_rows(int ch) {
  return kTileBytes / (ch * kRowBytes);
}

// Dynamic shared memory of one block: the tile, its indices (16-byte
// padded), then the barriers.
inline size_t smem_bytes(int ch) {
  const size_t t = tile_rows(ch);
  return t * ch * kRowBytes + ((t * 4 + 15) / 16) * 16 + kMaxBarriers * 8;
}

struct Smem {
  int4* tile;
  int32_t* idx;
  uint64_t* bars;
};

__device__ __forceinline__ Smem carve(unsigned char* base, int ch) {
  const int t = tile_rows(ch);
  Smem s;
  s.tile = reinterpret_cast<int4*>(base);
  s.idx = reinterpret_cast<int32_t*>(base + static_cast<size_t>(t) * ch *
                                                kRowBytes);
  s.bars = reinterpret_cast<uint64_t*>(
      reinterpret_cast<unsigned char*>(s.idx) + ((t * 4 + 15) / 16) * 16);
  return s;
}

// The reference premultiplies the row index in int32 (idx * CH), so a
// huge index wraps as it does there.
__device__ __forceinline__ int32_t premultiply(int32_t raw, int ch) {
  return static_cast<int32_t>(static_cast<uint32_t>(raw) *
                              static_cast<uint32_t>(ch));
}

// The reference's predicate: the premultiplied index with `premul`, else
// the row index, must lie in [0, cap).
__device__ __forceinline__ bool in_cap(int32_t raw, int ch, int64_t cap,
                                       int premul) {
  const int64_t v = premul ? premultiply(raw, ch) : raw;
  return v >= 0 && v < cap;
}

// Block-wide: the tile's indices into shared memory.
__device__ __forceinline__ void load_indices(int32_t* s_idx,
                                             const int32_t* idx,
                                             int64_t row0, int rows) {
  for (int j = threadIdx.x; j < rows; j += blockDim.x)
    s_idx[j] = idx[row0 + j];
}

// Block-wide, after the issuing thread drained: each thread waits on the
// last phase of every barrier it used (use u on barrier u % nbars), so the
// tile's bytes are acquired by every thread that reads them.
__device__ __forceinline__ void acquire_all(uint64_t* bars, int nbars,
                                            int uses) {
  for (int b = 0; b < nbars && b < uses; ++b) {
    const int last = b + ((uses - 1 - b) / nbars) * nbars;
    wait_parity(bars + b, (last / nbars) & 1);
  }
}

// Block-wide: the staged tile of `rows` rows goes out to `out` (its rows
// start at `row0`) as coalesced 16-byte stores; with `predicated`, rows
// the predicate drops are written as zeros.
__device__ __forceinline__ void write_tile(int4* out, const int4* tile,
                                           const int32_t* s_idx, int64_t row0,
                                           int rows, int ch, int64_t cap,
                                           int predicated, int premul) {
  const int per_row = ch * (kRowBytes / 16);
  const int total = rows * per_row;
  int4* dst = out + row0 * per_row;
  for (int v = threadIdx.x; v < total; v += blockDim.x) {
    int4 w = tile[v];
    if (predicated && !in_cap(s_idx[v / per_row], ch, cap, premul))
      w = make_int4(0, 0, 0, 0);
    dst[v] = w;
  }
}

// Calls f(std::integral_constant<int, v>{}) for v a power of two up to 32;
// false for any other v.
template <typename F>
inline bool pow2_dispatch(int v, F&& f) {
  switch (v) {
    case 1: f(std::integral_constant<int, 1>{}); return true;
    case 2: f(std::integral_constant<int, 2>{}); return true;
    case 4: f(std::integral_constant<int, 4>{}); return true;
    case 8: f(std::integral_constant<int, 8>{}); return true;
    case 16: f(std::integral_constant<int, 16>{}); return true;
    case 32: f(std::integral_constant<int, 32>{}); return true;
    default: return false;
  }
}

// Opt the kernel in to the block's dynamic shared memory and launch it on
// `stream`, one block per tile; returns the CUDA error (0 on success).
template <typename Kernel, typename... Args>
inline int launch(Kernel kernel, int64_t n, int ch, void* stream,
                  Args... args) {
  const size_t smem = smem_bytes(ch);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + tile_rows(ch) - 1) / tile_rows(ch);
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Persistent pipelines (dma_gather.cu, dma_gather_grouped.cu,
// fused_update_scatter.cu)
// ---------------------------------------------------------------------------
//
// A persistent block walks its share of the rows (Share) in stages of R
// rows through a ring of S stages in shared memory. One producer warp
// issues a stage's bulk copies, its lanes one row each; kPipeConsumers
// consumer warps write the stage out with coalesced 16-byte stores and
// then arrive on the stage's "empty" barrier, which the producer waits on
// before it refills the slot. Stage k uses slot s = k % S for the
// (k / S)-th time, so every per-stage barrier completes one phase per use
// and its parity is (k / S) & 1. Only a block's last stage may be short.

constexpr int kWarp = 32;
constexpr int kPipeConsumers = 4;
constexpr int kPipeThreads = kWarp * (1 + kPipeConsumers);
constexpr int kSmemMax = 232448;  // a block's shared memory on Hopper

struct Ring {
  int stages;  // S, slots in the ring
  int rows;    // R, rows per stage
};

// Dynamic shared memory of a ring beside `nbars` barriers.
inline size_t ring_smem(Ring r, int ch, int nbars) {
  return static_cast<size_t>(r.stages) * r.rows * ch * kRowBytes +
         static_cast<size_t>(nbars) * 8;
}

// The ring for staged rows of `row_bytes` (a multiple of 16): stages of
// max(1, stage_bytes / row_bytes) rows, `stages` of them or as many as
// fit in a block's shared memory beside extra(ring) more bytes (a 128 KiB
// row leaves room for one).
template <typename Extra>
inline Ring make_ring_bytes(int row_bytes, int stage_bytes, int stages,
                            Extra extra) {
  Ring r{stages, stage_bytes / row_bytes > 1 ? stage_bytes / row_bytes : 1};
  while (r.stages > 1 && static_cast<size_t>(r.stages) * r.rows * row_bytes +
                                 extra(r) >
                             kSmemMax)
    --r.stages;
  return r;
}

// The ring for rows of `ch` chunks beside nbars(ring) barriers.
template <typename Bars>
inline Ring make_ring(int ch, int stage_bytes, int stages, Bars nbars) {
  return make_ring_bytes(ch * kRowBytes, stage_bytes, stages, [&](Ring r) {
    return static_cast<size_t>(nbars(r)) * 8;
  });
}

// A block's rows, in stages of R: units of R rows dealt round-robin
// (block b takes units b, b + G, ... of the first q whole rounds, G =
// gridDim.x), so that at any time the blocks write neighbouring units;
// then the rows left after the whole rounds split evenly over the blocks
// as one last, shorter stage each, so that every block finishes at about
// the same time.
struct Share {
  int rows;     // R
  int rounds;   // q, whole rounds of G units
  int64_t tail0;  // the last stage's first row
  int tail;       // and its rows (0: no last stage)

  __device__ __forceinline__ Share(int64_t n, int r) : rows(r) {
    const int64_t round = static_cast<int64_t>(gridDim.x) * r;
    rounds = static_cast<int>(n / round);
    const int64_t whole = rounds * round, left = n - whole;
    tail0 = whole + left * blockIdx.x / gridDim.x;
    tail = static_cast<int>(whole + left * (blockIdx.x + 1) / gridDim.x -
                            tail0);
  }

  __device__ __forceinline__ int stages() const {
    return rounds + (tail > 0);
  }
  __device__ __forceinline__ int total() const {
    return rounds * rows + tail;
  }
  __device__ __forceinline__ int64_t row0(int k) const {
    return k < rounds
               ? (static_cast<int64_t>(k) * gridDim.x + blockIdx.x) * rows
               : tail0;
  }
  __device__ __forceinline__ int count(int k) const {
    return k < rounds ? rows : tail;
  }

  // A producer lane's index in the batch of `batch` rows at row i of
  // stage k (lane l reads row i + l; 0 past the stage or the share),
  // loaded one batch ahead of its use.
  __device__ __forceinline__ int32_t index(const int32_t* __restrict__ idx,
                                           int k, int i, int batch) const {
    const int lane = threadIdx.x % kWarp;
    return lane < batch && k < stages() && i + lane < count(k)
               ? idx[row0(k) + i + lane]
               : 0;
  }
};

// Consumer-wide (the kPipeConsumers warps after the producer): a stage's
// `rows` staged rows of `ch` chunks go out to `dst`, where they are
// contiguous, as coalesced 16-byte streaming stores (evict-first: written
// once, never read back here), each thread loading four words before it
// stores them; a row for which zero_row(i) holds is written as zeros.
template <typename ZeroRow>
__device__ __forceinline__ void put_stage(int4* __restrict__ dst,
                                          const int4* __restrict__ src,
                                          int rows, int ch,
                                          ZeroRow zero_row) {
  constexpr int kThreads = kWarp * kPipeConsumers, kUnroll = 4;
  const int per_row = ch * (kRowBytes / 16);
  const int total = rows * per_row;
  for (int v0 = threadIdx.x - kWarp; v0 < total;
       v0 += kThreads * kUnroll) {
    int4 w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < total) w[u] = src[v];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v >= total) continue;
      if (zero_row(v / per_row)) w[u] = make_int4(0, 0, 0, 0);
      __stcs(dst + v, w[u]);
    }
  }
}

// Blocks of `kernel` at `threads` threads and `smem` bytes resident on
// one SM, times the SMs: queried once per kernel, device and size, then
// cached (0 blocks is an error: the kernel does not fit).
inline int persistent_blocks(const void* kernel, size_t smem, int max_per_sm,
                             int* blocks, int threads) {
  struct Entry {
    const void* kernel;
    int device;
    size_t smem;
    int threads;
    int blocks;
  };
  static std::mutex mu;
  static std::vector<Entry> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  for (const Entry& e : cache) {
    if (e.kernel == kernel && e.device == dev && e.smem == smem &&
        e.threads == threads) {
      *blocks = e.blocks;
      return 0;
    }
  }
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = (per_sm < max_per_sm ? per_sm : max_per_sm) * sms;
  cache.push_back(Entry{kernel, dev, smem, threads, *blocks});
  return 0;
}

// Launch `kernel` persistently on `stream` with blocks of `threads`: the
// resident blocks (at most `max_per_sm` per SM), but no more than `units`
// units of work; returns the CUDA error (0 on success).
template <typename Kernel, typename... Args>
inline int launch_persistent(Kernel kernel, int threads, size_t smem,
                             int max_per_sm, int64_t units, void* stream,
                             Args... args) {
  int blocks = 0;
  const int err = persistent_blocks(reinterpret_cast<const void*>(kernel),
                                    smem, max_per_sm, &blocks, threads);
  if (err) return err;
  const int64_t grid = units < blocks ? units : blocks;
  kernel<<<static_cast<unsigned>(grid), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bulk
