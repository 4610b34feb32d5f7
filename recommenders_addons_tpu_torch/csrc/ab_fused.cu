// Fused-apply cost probe for NVIDIA Hopper (sm_90a): a row-wise Adam
// update fused into an in-place row scatter, with the two knobs the probe
// measures, the sub-chunk that interleaves compute with store issue and
// the number of stores in flight. Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel of `make_fused(mode, sub, nbuf)`
// (tools/ab_kernel_cost.py:56, pallas_call at :122), whose table is
// aliased to its output: this kernel writes the table in place.
//
// Computes, for each batch row j (any N), on a table of rows of W = 256
// f32 words (ch = 2 chunks of 128) and D = 64:
//   b = int32(idx[j] * 2)                          (wraps as the reference)
//   table[b : b+2, :] = new_j                      (as one 1 KiB row)
// where, by mode,
//   adam:     new_j = [rows - lr*m'/(sqrt(v')+1e-7) | m' | v' | 0 ... 0]
//             m' = 0.9*m + 0.1*g,  v' = 0.999*v + 0.001*g*g,
//             t = step + 1,  lr = 0.001*sqrt(1 - 0.999^t)/(1 - 0.9^t)
//             over packed[j] = [rows | m | v | pad] and g[j]
//             (the reference's adam_tile, :41-53);
//   identity: new_j = packed[j], after a read-and-write pass over the
//             staged words (the reference's tile store of the unchanged
//             block);
//   rawcopy:  new_j = packed[j], stored as it was loaded.
// Rows whose b falls outside the table are skipped (undefined in the
// reference); a sentinel index CAP writes the trash row. Valid indices
// must be unique: stores to one row race.
//
// Design. A block takes a tile of T = 128 rows (128 KiB of packed rows,
// 32 KiB of g). One thread bulk-loads both tiles with `cp.async.bulk`
// counted on one mbarrier (the g tile is not loaded in rawcopy). Then, for
// each sub-chunk of min(sub, T) rows, all threads compute the chunk's rows
// in shared memory, make their writes visible to the async proxy
// (`fence.proxy.async.shared::cta`, then a block barrier), and thread 0
// issues one `cp.async.bulk` shared->global store per row, each its own
// bulk group, waiting with `cp.async.bulk.wait_group.read NBUF-1` after
// each commit: the reference's ring of NBUF DMA semaphores. While thread 0
// issues chunk c the other threads compute chunk c+1, whose rows are
// disjoint. `wait_group 0` ends the block, so its shared memory outlives
// every store that reads it. With T = 128, sub = 128 and sub = 1024 both
// make one chunk per tile.
//
// Bound on this card: bytes. Per row 1 KiB of packed row and 256 B of g
// read in order, 4 B of index, 1 KiB written at a random row; the Adam
// math is 12 float operations per column, far below the float32 rate.
// Built with -fmad=false, and the operations are ordered as the
// reference's: (0.001*g)*g, (lr*m)/(...), powf on f32.

#include "bulk_copy.cuh"

namespace {

constexpr int kT = 128;   // rows per tile
constexpr int kW = 256;   // 32-bit words per row
constexpr int kD = 64;    // value columns; m, v and the pad follow
constexpr int kCh = 2;    // 128-word chunks per row
constexpr uint32_t kRowBytes = kW * 4;
constexpr uint32_t kGRowBytes = kD * 4;
constexpr size_t kIdxOffset = static_cast<size_t>(kT) * (kRowBytes +
                                                         kGRowBytes);
constexpr size_t kBarOffset = kIdxOffset + kT * 4;
constexpr size_t kSmemBytes = kBarOffset + 8;

enum Mode { kAdam = 0, kIdentity = 1, kRawcopy = 2 };

// Make this thread's ordinary shared-memory writes visible to later bulk
// copies (the async proxy) that read them.
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int MODE, int NBUF>
__global__ void __launch_bounds__(bulk::kThreads)
ab_fused_kernel(float* __restrict__ table, int64_t nphys,
                const int32_t* __restrict__ idx, int64_t n,
                const float* __restrict__ packed, const float* __restrict__ g,
                float step, int sub) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  float* gt = reinterpret_cast<float*>(smem + static_cast<size_t>(kT) *
                                                  kRowBytes);
  int32_t* s_idx = reinterpret_cast<int32_t*>(smem + kIdxOffset);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + kBarOffset);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kT;
  const int rows = static_cast<int>(n - row0 < kT ? n - row0 : kT);

  if (threadIdx.x == 0) {
    bulk::init_barriers(bar, 1);
    const uint32_t pbytes = rows * kRowBytes;
    const uint32_t gbytes = MODE == kRawcopy ? 0 : rows * kGRowBytes;
    bulk::arrive_expect_tx(bar, pbytes + gbytes);
    bulk::load_async(tile, packed + row0 * kW, pbytes, bar);
    if (MODE != kRawcopy) bulk::load_async(gt, g + row0 * kD, gbytes, bar);
  }
  bulk::load_indices(s_idx, idx, row0, rows);
  __syncthreads();
  bulk::wait_parity(bar, 0);  // every thread: the tiles have landed

  float lr = 0.0f;
  if (MODE == kAdam) {
    const float t = step + 1.0f;
    lr = 0.001f * sqrtf(1.0f - powf(0.999f, t)) / (1.0f - powf(0.9f, t));
  }

  const int chunk = sub < kT ? sub : kT;
  for (int c0 = 0; c0 < rows; c0 += chunk) {
    const int c1 = c0 + chunk < rows ? c0 + chunk : rows;
    if (MODE == kAdam) {
      // one (row, column) per thread: neighbouring threads, neighbouring
      // words, so shared memory serves each warp without bank conflicts
      for (int e = threadIdx.x; e < (c1 - c0) * kD; e += blockDim.x) {
        const int r = c0 + e / kD;
        const int d = e % kD;
        float* p = tile + static_cast<size_t>(r) * kW;
        const float gr = gt[r * kD + d];
        const float m = 0.9f * p[kD + d] + 0.1f * gr;
        const float v = 0.999f * p[2 * kD + d] + (0.001f * gr) * gr;
        p[d] = p[d] - (lr * m) / (sqrtf(v) + 1e-7f);
        p[kD + d] = m;
        p[2 * kD + d] = v;
        p[3 * kD + d] = 0.0f;
      }
    } else if (MODE == kIdentity) {
      int4* t4 = reinterpret_cast<int4*>(tile);
      for (int e = c0 * (kW / 4) + threadIdx.x; e < c1 * (kW / 4);
           e += blockDim.x) {
        int4 w = t4[e];
        // an opaque no-op: the load and the store are both kept
        asm volatile("" : "+r"(w.x), "+r"(w.y), "+r"(w.z), "+r"(w.w));
        t4[e] = w;
      }
    }
    if (MODE != kRawcopy) {
      fence_proxy_async_shared();
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      for (int j = c0; j < c1; ++j) {
        const int64_t b = bulk::premultiply(s_idx[j], kCh);
        if (b < 0 || b > nphys - kCh) continue;
        bulk::store_async(table + b * (bulk::kRowBytes / 4),
                          tile + static_cast<size_t>(j) * kW, kRowBytes);
        bulk::commit_group();
        bulk::wait_group_read<NBUF - 1>();
      }
    }
  }
  if (threadIdx.x == 0) bulk::wait_all();
}

template <int MODE, int NBUF>
int run(void* table, int64_t nphys, const void* idx, int64_t n,
        const void* packed, const void* g, float step, int sub,
        void* stream) {
  auto kernel = ab_fused_kernel<MODE, NBUF>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t tiles = (n + kT - 1) / kT;
  kernel<<<static_cast<unsigned>(tiles), bulk::kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), nphys, static_cast<const int32_t*>(idx), n,
      static_cast<const float*>(packed), static_cast<const float*>(g), step,
      sub);
  return static_cast<int>(cudaGetLastError());
}

template <int NBUF>
int by_mode(int mode, void* table, int64_t nphys, const void* idx,
            int64_t n, const void* packed, const void* g, float step,
            int sub, void* stream) {
  switch (mode) {
    case kAdam:
      return run<kAdam, NBUF>(table, nphys, idx, n, packed, g, step, sub,
                              stream);
    case kIdentity:
      return run<kIdentity, NBUF>(table, nphys, idx, n, packed, g, step,
                                  sub, stream);
    case kRawcopy:
      return run<kRawcopy, NBUF>(table, nphys, idx, n, packed, g, step, sub,
                                 stream);
    default:
      return 1;
  }
}

}  // namespace

// table: [nphys*128] f32 (nphys = 128-word chunks, two per row), 16-byte
// aligned; idx: [n] int32 row indices; packed: [n*256] f32 and g: [n*64]
// f32, 16-byte aligned. mode 0 adam, 1 identity, 2 rawcopy; sub >= 1; nbuf
// 32 or 64. Launches on `stream`; returns the CUDA error (0 on success, 1
// for an argument the kernel does not take).
extern "C" int ab_fused(void* table, int64_t nphys, const void* idx,
                        int64_t n, const void* packed, const void* g,
                        float step, int mode, int sub, int nbuf,
                        void* stream) {
  if (n <= 0) return 0;
  if (sub < 1) return 1;
  if (nbuf == 32)
    return by_mode<32>(mode, table, nphys, idx, n, packed, g, step, sub,
                       stream);
  if (nbuf == 64)
    return by_mode<64>(mode, table, nphys, idx, n, packed, g, step, sub,
                       stream);
  return 1;
}
