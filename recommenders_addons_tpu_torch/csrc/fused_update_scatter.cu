// Fused row-wise optimizer update + row scatter into a dynamic-embedding
// table's physical container, for NVIDIA Hopper (sm_90a). Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces the Pallas TPU kernel `fused_update_scatter_refs`
// (recommenders_addons_tpu/ops/pallas_ops.py:322, pallas_call at :426)
// with the tile math of `optimizer._fused_rows_pf1` (optimizer.py:533) and
// `_fused_rows_pf2` (optimizer.py:577). Like it, the table is written in
// place (the TPU kernel aliases the table to its output).
//
// Computes, for each batch row j whose index r = idx[j] lies in [0, cap):
//   row = packed[j]   // the lookup's [value | slot_0 | ... | pad] row
//   (value, slot_a, slot_b) <- the named optimizer's update of
//       (value, slot_a, slot_b) with grads[j] at `step`, column by column
//   table row r <- value | slots (the others unchanged) | zero padding
// `slot_a`/`slot_b` are the positions of the optimizer's slots among the
// table's sorted slot columns (-1 when it has fewer). The packed row is
// read, never the table, so the in-place write has no read hazard.
//
// Rows whose index lies outside [0, cap) do no work: no load, no math, no
// store. The TPU kernel and the plain version (cuda_ops.py) write their
// updates to the trash row at `cap`, whose contents are unspecified in
// both packages (nothing reads it unmasked); this kernel leaves it as it
// is. On the DLRM step about two thirds of the plan's rows are such rows
// (padding past the unique keys, duplicates' non-representatives).
//
// pf = 1: f32 values; the packed row is W = ch*128 f32 words.
// pf = 2: bf16 values two to a 32-bit word (element 2i in the low half of
// word i, 2i+1 in the high half). Each half unpacks exactly to f32 with
// integer ops (low: bits << 16, high: bits & 0xFFFF0000), the math runs in
// f32 on each plane, and each result is repacked round-to-nearest-even:
// (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16, as XLA's convert does.
//
// The math is the JAX package's (optimizer.py:57-181), operation for
// operation; the library is built without fused multiply-add (-fmad=false
// in cuda_ops.py), so each product and sum rounds as XLA's and PyTorch's
// separate operations do, and powf/sqrtf are the accurate ones (no
// fast-math).
//
// Bound on this card: bytes. Per valid row it reads the packed row
// (ch*512 B) and the grad row (dim*4 B), writes ch*512 B at a random row,
// and it reads 4 B of index per batch row; the arithmetic (tens of flops
// per word) is far below the card's rate.
//
// Design: a persistent, warp-specialised pipeline on the ring of
// bulk_copy.cuh ("Persistent pipelines"). Blocks that fit on the card (at
// most kBlocksPerSm per SM) walk their shares of the batch (bulk::Share)
// in units of one 32-row batch dealt round-robin, so that every block
// gets its share of the valid rows wherever they lie (on the DLRM plan
// their share falls along the batch). A producer warp loads the indices
// of kUnitsAhead units at once, a group ahead; per batch it compacts the
// valid rows (__ballot_sync, __popc) into the open stage of a ring of
// kStages stages of max(1, kStageBytes / staged row) rows, so a stage is
// full of real rows however much of the batch is trash. A full stage is
// committed: lane 0 arms its "full" mbarrier with the stage's bytes, then
// the lanes issue, per row, one `cp.async.bulk` of the packed row's
// occupied words (value and slot columns rounded up to 16 bytes: padding
// is written, never read) and one of the grad row (evict-first), and
// arrive. kConsumers consumer warps take a stage's rows in turn, a group
// of 8-32 lanes a row (a 16-byte vector of the value block each, so a
// 64-wide f32 row takes half a warp): the update runs on 16-byte vectors
// from shared memory and is written back there, the value and slot
// columns leave as one bulk shared->global copy a row and the zero
// padding as 16-byte streaming stores. Then the warp, its copies' reads
// done, arrives on
// the stage's "empty" barrier, which the producer waits on before it
// refills the slot. A stage of 0 rows ends the block. Only the indices
// are read from device memory by the threads themselves (and the grads,
// when a grad row does not start on 16 bytes: dim % 4 != 0, or an
// unaligned tensor). A value block of dim/pf words that is not a multiple
// of 4 takes a scalar path, with streaming stores only. Offsets are
// 64-bit (a 4Mi-row table at ch = 2 is 4 GiB).

#include "bulk_copy.cuh"

namespace {

// The pipeline's geometry, from the port's tools/fused_sweep.py grid
// (16/32 KiB stages, 2-4 stages, 2-3 blocks an SM, 4-16 consumer warps)
// on an NVIDIA H100 80GB HBM3 at 700 W: lowest time summed over its
// three inputs, within 1-2% of the next few; 3 blocks an SM beat 2 and
// 16 consumer warps lose to 8 on registers. Bulk stores of a row beat
// 16-byte streaming stores by ~7% where two thirds of the rows are trash
// and tied on the sum (PERF.md).
constexpr int kStageBytes = 32 * 1024;  // staged rows of one stage (>= 1)
constexpr int kStages = 2;              // slots in the ring
constexpr int kBlocksPerSm = 3;         // cap on resident blocks per SM
constexpr int kConsumers = 8;           // consumer warps per block

constexpr int kUnitRows = bulk::kWarp;  // a unit: one batch of 32 rows
constexpr int kUnitsAhead = 8;  // units whose indices load together
constexpr int kThreads = bulk::kWarp * (1 + kConsumers);

enum Rule { kSgd = 0, kMomentum, kAdagrad, kAdam, kAdamW, kRmsprop, kFtrl };

struct Hparams {
  float h[8];
};

// One column's update. `v` is the value, `a`/`b` the optimizer's slots (in
// the order of its slot_specs), `g` the grad; `lr_t` is Adam's bias-
// corrected rate, computed once per thread.
template <int R>
__device__ __forceinline__ void update(float& v, float& a, float& b, float g,
                                       const Hparams& p, float lr_t) {
  if (R == kSgd) {  // lr
    v = v - p.h[0] * g;
  } else if (R == kMomentum) {  // lr, momentum, nesterov
    const float m = a * p.h[1] + g;
    const float upd = p.h[2] != 0.0f ? g + p.h[1] * m : m;
    v = v - p.h[0] * upd;
    a = m;
  } else if (R == kAdagrad) {  // lr, epsilon
    const float acc = a + g * g;
    v = v - p.h[0] * g / (sqrtf(acc) + p.h[1]);
    a = acc;
  } else if (R == kAdam || R == kAdamW) {
    // lr, beta_1, beta_2, epsilon, 1 - beta_1, 1 - beta_2, lr * decay
    const float m = p.h[1] * a + p.h[4] * g;
    const float s = p.h[2] * b + p.h[5] * g * g;
    float nv = v - lr_t * m / (sqrtf(s) + p.h[3]);
    if (R == kAdamW) nv = nv - p.h[6] * v;
    v = nv;
    a = m;
    b = s;
  } else if (R == kRmsprop) {  // lr, rho, momentum, epsilon, 1 - rho
    const float rms = p.h[1] * a + p.h[4] * g * g;
    const float mom = p.h[2] * b + p.h[0] * g / sqrtf(rms + p.h[3]);
    v = v - mom;
    a = rms;
    b = mom;
  } else if (R == kFtrl) {  // lr, -lr_power, l1, 2 * l2
    const float n_new = a + g * g;
    const float pw_new = p.h[1] == 0.5f ? sqrtf(n_new) : powf(n_new, p.h[1]);
    const float pw_old = p.h[1] == 0.5f ? sqrtf(a) : powf(a, p.h[1]);
    const float sigma = (pw_new - pw_old) / p.h[0];
    const float z = b + g - sigma * v;
    const float quad = pw_new / p.h[0] + p.h[3];
    const float pruned = fminf(fmaxf(z, -p.h[2]), p.h[2]) - z;
    v = fabsf(z) > p.h[2] ? pruned / quad : 0.0f;
    a = n_new;
    b = z;
  }
}

__device__ __forceinline__ uint32_t rne_bf16(float x) {
  const uint32_t b = __float_as_uint(x);
  return b + 0x7FFFu + ((b >> 16) & 1u);
}

// One 32-bit word of the value block and its two slot words, in place;
// `g` holds the word's PF grads.
template <int R, int PF>
__device__ __forceinline__ void update_word(uint32_t& wv, uint32_t& wa,
                                            uint32_t& wb, const float* g,
                                            const Hparams& p, float lr_t) {
  if (PF == 1) {
    float v = __uint_as_float(wv), a = __uint_as_float(wa),
          b = __uint_as_float(wb);
    update<R>(v, a, b, g[0], p, lr_t);
    wv = __float_as_uint(v);
    wa = __float_as_uint(a);
    wb = __float_as_uint(b);
  } else {
    float ve = __uint_as_float(wv << 16), vo = __uint_as_float(wv & 0xFFFF0000u);
    float ae = __uint_as_float(wa << 16), ao = __uint_as_float(wa & 0xFFFF0000u);
    float be = __uint_as_float(wb << 16), bo = __uint_as_float(wb & 0xFFFF0000u);
    update<R>(ve, ae, be, g[0], p, lr_t);
    update<R>(vo, ao, bo, g[1], p, lr_t);
    const auto pack = [](float even, float odd) {
      return (rne_bf16(odd) & 0xFFFF0000u) | (rne_bf16(even) >> 16);
    };
    wv = pack(ve, vo);
    wa = pack(ae, ao);
    wb = pack(be, bo);
  }
}

// What the kernel needs of a row besides the tensors.
struct Row {
  int wc;       // 32-bit words per table row (ch * 128)
  int dim;      // grads per row
  int dw;       // words per column block (dim / pf)
  int used;     // words of the value and slot columns: dw * (1 + n_slots)
  int n_slots;  // the table's slot columns
  int sa, sb;   // the optimizer's slot columns (-1: none)
};

// The staged rows: each is the packed row's first `load_words` words
// (`used` rounded up to 4) then, when `grad_words` > 0, its grad row.
struct Geom {
  bulk::Ring ring;
  int load_words;
  int grad_words;
  __host__ __device__ int slot_words() const { return load_words + grad_words; }
};

// Byte offsets of the block's shared memory: the ring's staged rows, each
// slot's batch row (int64) and table row (int32), each stage's row count,
// the producer's unit of indices, then the "full" and "empty" barriers.
struct Layout {
  size_t meta_j, meta_r, cnt, uidx, bars, total;
  __host__ __device__ Layout(bulk::Ring r, int slot_bytes) {
    const size_t slots = static_cast<size_t>(r.stages) * r.rows;
    meta_j = slots * slot_bytes;
    meta_r = meta_j + slots * 8;
    cnt = meta_r + (slots * 4 + 7) / 8 * 8;
    uidx = cnt + (static_cast<size_t>(r.stages) * 4 + 7) / 8 * 8;
    bars = uidx + kUnitsAhead * kUnitRows * 4;
    total = bars + 2 * static_cast<size_t>(r.stages) * 8;
  }
};

__device__ __forceinline__ uint4 ld4(const float* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st4(float* p, uint4 w) {
  *reinterpret_cast<uint4*>(p) = w;
}

__device__ __forceinline__ void stcs4(float* p, uint4 w) {
  __stcs(reinterpret_cast<int4*>(p),
         make_int4(static_cast<int>(w.x), static_cast<int>(w.y),
                   static_cast<int>(w.z), static_cast<int>(w.w)));
}

// Lanes per row: a group of L lanes takes a row, 32 / L rows a warp at
// once, L the smallest of 8, 16, 32 with a 16-byte vector of the value
// block for each lane (32 on the scalar path).
__device__ __forceinline__ int group_lanes(const Row& w) {
  const int vecs = w.dw / 4;
  return w.dw % 4 || vecs > 16 ? 32 : vecs > 8 ? 16 : 8;
}

// The `sl`-th of `L` lanes writes its share of staged row `row` (shared)
// to table row `dst`; `g` are the row's grads (shared and 16-byte aligned
// when `g_vec`). On the vector path the updated columns go back into
// `row`, which the caller then stores as one bulk copy.
template <int R, int PF>
__device__ __forceinline__ void write_row(float* __restrict__ dst,
                                          float* row, const float* g,
                                          bool g_vec, const Row& w,
                                          const Hparams& p, float lr_t,
                                          int sl, int L) {
  const int oa = w.sa >= 0 ? w.dw * (1 + w.sa) : 0;
  const int ob = w.sb >= 0 ? w.dw * (1 + w.sb) : 0;
  if (w.dw % 4) {  // scalar path: a column block of dw % 4 != 0 words
    for (int c = sl; c < w.dw; c += L) {
      uint32_t v = __float_as_uint(row[c]);
      uint32_t a = w.sa >= 0 ? __float_as_uint(row[oa + c]) : 0u;
      uint32_t b = w.sb >= 0 ? __float_as_uint(row[ob + c]) : 0u;
      float gg[PF];
#pragma unroll
      for (int q = 0; q < PF; ++q) gg[q] = g[PF * c + q];
      update_word<R, PF>(v, a, b, gg, p, lr_t);
      dst[c] = __uint_as_float(v);
      if (w.sa >= 0) dst[oa + c] = __uint_as_float(a);
      if (w.sb >= 0) dst[ob + c] = __uint_as_float(b);
    }
    for (int k = 0; k < w.n_slots; ++k) {
      if (k == w.sa || k == w.sb) continue;
      for (int c = sl; c < w.dw; c += L)
        dst[w.dw * (1 + k) + c] = row[w.dw * (1 + k) + c];
    }
    for (int c = w.used + sl; c < w.wc; c += L) dst[c] = 0.0f;
    return;
  }
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int c = sl * 4; c < w.dw; c += L * 4) {
    uint4 v = ld4(row + c);
    uint4 a = w.sa >= 0 ? ld4(row + oa + c) : zero;
    uint4 b = w.sb >= 0 ? ld4(row + ob + c) : zero;
    float gg[4 * PF];
    if (g_vec) {
#pragma unroll
      for (int q = 0; q < PF; ++q) {
        const float4 g4 = *reinterpret_cast<const float4*>(g + PF * c + 4 * q);
        gg[4 * q] = g4.x;
        gg[4 * q + 1] = g4.y;
        gg[4 * q + 2] = g4.z;
        gg[4 * q + 3] = g4.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4 * PF; ++q) gg[q] = g[PF * c + q];
    }
    update_word<R, PF>(v.x, a.x, b.x, gg, p, lr_t);
    update_word<R, PF>(v.y, a.y, b.y, gg + PF, p, lr_t);
    update_word<R, PF>(v.z, a.z, b.z, gg + 2 * PF, p, lr_t);
    update_word<R, PF>(v.w, a.w, b.w, gg + 3 * PF, p, lr_t);
    st4(row + c, v);
    if (w.sa >= 0) st4(row + oa + c, a);
    if (w.sb >= 0) st4(row + ob + c, b);
  }
  for (int c = w.used + sl * 4; c < w.wc; c += L * 4) stcs4(dst + c, zero);
}

template <int R, int PF>
__global__ void __launch_bounds__(kThreads)
fused_kernel(float* __restrict__ table, int64_t cap,
             const int32_t* __restrict__ idx, int64_t n,
             const float* __restrict__ packed,
             const float* __restrict__ grads, Row w, float step, Hparams p,
             Geom geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int S = geo.ring.stages, RR = geo.ring.rows;
  const int slot_words = geo.slot_words();
  const Layout lay(geo.ring, slot_words * 4);
  float* data = reinterpret_cast<float*>(smem);
  int64_t* meta_j = reinterpret_cast<int64_t*>(smem + lay.meta_j);
  int32_t* meta_r = reinterpret_cast<int32_t*>(smem + lay.meta_r);
  int32_t* cnt = reinterpret_cast<int32_t*>(smem + lay.cnt);
  int32_t* uidx = reinterpret_cast<int32_t*>(smem + lay.uidx);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / bulk::kWarp;
  const int lane = threadIdx.x % bulk::kWarp;

  if (threadIdx.x == 0) {
    bulk::init_barriers(full, S, bulk::kWarp);
    bulk::init_barriers(empty, S, kConsumers);
  }
  __syncthreads();

  if (warp == 0) {
    // Producer. Stage kst takes slot kst % S for the (kst / S)-th time;
    // `fill` rows of it are placed.
    const bulk::Share share(n, kUnitRows);
    const int units = share.stages();
    const uint32_t load_bytes = geo.load_words * 4;
    const uint32_t grad_bytes = geo.grad_words * 4;
    const uint64_t policy = bulk::evict_first_policy();
    int kst = 0, fill = 0;
    const auto open = [&]() {  // wait until stage kst's slot is free
      if (kst >= S) bulk::wait_parity(empty + kst % S, ((kst / S) - 1) & 1);
      fill = 0;
    };
    const auto commit = [&]() {  // arm, issue and release stage kst
      const int s = kst % S;
      __syncwarp();
      if (lane == 0) {
        cnt[s] = fill;
        bulk::arrive_expect_tx(full + s, fill * (load_bytes + grad_bytes));
      }
      __syncwarp();
      for (int i = lane; i < fill; i += bulk::kWarp) {
        const int64_t j = meta_j[s * RR + i];
        float* dst = data + (static_cast<size_t>(s) * RR + i) * slot_words;
        bulk::load_async(dst, packed + j * w.wc, load_bytes, full + s,
                         policy);
        if (grad_bytes)
          bulk::load_async(dst + geo.load_words, grads + j * w.dim,
                           grad_bytes, full + s, policy);
      }
      if (lane != 0) bulk::arrive(full + s);
      ++kst;
    };
    // the indices of kUnitsAhead units: loaded into registers a group
    // ahead, then parked in shared memory (a lane reads back only what it
    // wrote)
    int32_t ahead[kUnitsAhead];
#pragma unroll
    for (int t = 0; t < kUnitsAhead; ++t)
      ahead[t] = share.index(idx, t, 0, bulk::kWarp);
    open();
    for (int k0 = 0; k0 < units; k0 += kUnitsAhead) {
#pragma unroll
      for (int t = 0; t < kUnitsAhead; ++t) {
        uidx[t * bulk::kWarp + lane] = ahead[t];
        ahead[t] = share.index(idx, k0 + kUnitsAhead + t, 0, bulk::kWarp);
      }
      for (int t = 0; t < kUnitsAhead && k0 + t < units; ++t) {
        const int32_t raw = uidx[t * bulk::kWarp + lane];
        const bool valid = lane < share.count(k0 + t) && raw >= 0 && raw < cap;
        const unsigned mask = __ballot_sync(0xffffffffu, valid);
        const int nv = __popc(mask);
        const int pos = __popc(mask & ((1u << lane) - 1u));
        for (int done = 0; done < nv;) {
          if (fill == RR) {
            commit();
            open();
          }
          const int take = nv - done < RR - fill ? nv - done : RR - fill;
          if (valid && pos >= done && pos < done + take) {
            const int slot = (kst % S) * RR + fill + pos - done;
            meta_j[slot] = share.row0(k0 + t) + lane;
            meta_r[slot] = raw;
          }
          fill += take;
          done += take;
        }
      }
    }
    if (fill > 0) {
      commit();
      open();
    }
    commit();  // a stage of 0 rows: the end
  } else {
    // Consumers: a group of L lanes a row, in turn, until the stage of
    // 0 rows.
    float lr_t = 0.0f;
    if (R == kAdam || R == kAdamW) {
      const float t = step + 1.0f;
      lr_t = p.h[0] * sqrtf(1.0f - powf(p.h[2], t)) / (1.0f - powf(p.h[1], t));
    }
    const bool g_staged = geo.grad_words > 0;
    const int L = group_lanes(w), G = bulk::kWarp / L;
    for (int k = 0;; ++k) {
      const int s = k % S;
      bulk::wait_parity(full + s, (k / S) & 1);
      const int rows = cnt[s];
      if (rows == 0) break;
      for (int i0 = (warp - 1) * G; i0 < rows; i0 += kConsumers * G) {
        const int i = i0 + lane / L, m = s * RR + i;
        float* row = data + static_cast<size_t>(m) * slot_words;
        float* dst = i < rows
                         ? table + static_cast<int64_t>(meta_r[m]) * w.wc
                         : nullptr;
        if (i < rows) {
          const float* g =
              g_staged ? row + geo.load_words : grads + meta_j[m] * w.dim;
          write_row<R, PF>(dst, row, g, g_staged, w, p, lr_t, lane % L, L);
        }
        if (w.dw % 4 == 0) {
          bulk::fence_proxy_async();
          __syncwarp();
          if (i < rows && lane % L == 0) {
            bulk::store_async(dst, row, static_cast<uint32_t>(w.used) * 4);
            bulk::commit_group();
          }
        }
      }
      if (lane % L == 0) bulk::wait_group_read<0>();
      __syncwarp();
      if (lane == 0) bulk::arrive(empty + s);
    }
    if (lane % L == 0) bulk::wait_all();
  }
}

template <int R, int PF>
int launch(float* table, int64_t cap, const int32_t* idx, int64_t n,
           const float* packed, const float* grads, const Row& w, float step,
           const Hparams& p, void* stream) {
  // grads are staged when a grad row is whole 16-byte words
  const bool g_bulk =
      w.dim % 4 == 0 && reinterpret_cast<uintptr_t>(grads) % 16 == 0;
  Geom geo;
  geo.load_words = (w.used + 3) / 4 * 4;
  geo.grad_words = g_bulk ? w.dim : 0;
  const int slot_bytes = geo.slot_words() * 4;
  geo.ring = bulk::make_ring_bytes(
      slot_bytes, kStageBytes, kStages, [&](bulk::Ring r) {
        const Layout l(r, slot_bytes);
        return l.total - l.meta_j;
      });
  return bulk::launch_persistent(
      fused_kernel<R, PF>, kThreads, Layout(geo.ring, slot_bytes).total,
      kBlocksPerSm, (n + kUnitRows - 1) / kUnitRows, stream, table, cap, idx,
      n, packed, grads, w, step, p, geo);
}

template <int R>
int launch_rule(int pf, float* table, int64_t cap, const int32_t* idx,
                int64_t n, const float* packed, const float* grads,
                const Row& w, float step, const Hparams& p, void* stream) {
  if (pf == 1)
    return launch<R, 1>(table, cap, idx, n, packed, grads, w, step, p,
                        stream);
  return launch<R, 2>(table, cap, idx, n, packed, grads, w, step, p, stream);
}

}  // namespace

// table: [(cap+1)*ch*128] 32-bit words; idx: [n] int32; packed: [n, ch*128]
// 32-bit words; grads: [n, dim] f32; all contiguous, table and packed
// 16-byte aligned. rule: the Rule enum; h0..h7: its hyper-parameters (see
// `update`). Launches on `stream` and returns the launch's CUDA error (0
// on success, 1 for an argument the kernel does not take).
extern "C" int fused_update_scatter(void* table, int64_t cap, int ch,
                                    const void* idx, int64_t n,
                                    const void* packed, const void* grads,
                                    int dim, int n_slots, int pf, int rule,
                                    int slot_a, int slot_b, float step,
                                    float h0, float h1, float h2, float h3,
                                    float h4, float h5, float h6, float h7,
                                    void* stream) {
  if (n <= 0) return 0;
  if ((pf != 1 && pf != 2) || ch < 1 || dim < pf || dim % pf) return 1;
  const int dw = dim / pf;
  const Row w{ch * 128, dim, dw, dw * (1 + n_slots), n_slots, slot_a, slot_b};
  if (w.used > w.wc || reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(packed) % 16)
    return 1;
  const Hparams p = {{h0, h1, h2, h3, h4, h5, h6, h7}};
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* pk = static_cast<const float*>(packed);
  const auto* g = static_cast<const float*>(grads);
  switch (rule) {
    case kSgd:
      return launch_rule<kSgd>(pf, t, cap, i, n, pk, g, w, step, p, stream);
    case kMomentum:
      return launch_rule<kMomentum>(pf, t, cap, i, n, pk, g, w, step, p,
                                    stream);
    case kAdagrad:
      return launch_rule<kAdagrad>(pf, t, cap, i, n, pk, g, w, step, p,
                                   stream);
    case kAdam:
      return launch_rule<kAdam>(pf, t, cap, i, n, pk, g, w, step, p, stream);
    case kAdamW:
      return launch_rule<kAdamW>(pf, t, cap, i, n, pk, g, w, step, p,
                                 stream);
    case kRmsprop:
      return launch_rule<kRmsprop>(pf, t, cap, i, n, pk, g, w, step, p,
                                   stream);
    case kFtrl:
      return launch_rule<kFtrl>(pf, t, cap, i, n, pk, g, w, step, p, stream);
    default:
      return 1;
  }
}
