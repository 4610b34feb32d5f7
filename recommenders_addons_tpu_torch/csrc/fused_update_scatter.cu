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
// Computes, for each batch row j:
//   r   = idx[j] if 0 <= idx[j] < cap else cap           (the trash row)
//   row = packed[j]   // the lookup's [value | slot_0 | ... | pad] row
//   (value, slot_a, slot_b) <- the named optimizer's update of
//       (value, slot_a, slot_b) with grads[j] at `step`, column by column
//   table row r <- value | slots (the others unchanged) | zero padding
// `slot_a`/`slot_b` are the positions of the optimizer's slots among the
// table's sorted slot columns (-1 when it has fewer). The packed row is
// read, never the table, so the in-place write has no read hazard; rows
// landing on the trash row race there and leave it unspecified, as on the
// TPU.
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
// Bound on this card: bytes. Per row it reads the packed row (ch*512 B),
// the grad row (dim*4 B) and the index, and writes ch*512 B at a random
// row; the arithmetic (tens of flops per word) is far below the card's
// rate. One warp per batch row: lane l walks columns l, l+32, ..., so
// every packed-row load and table-row store is coalesced across the warp;
// lane 0 reads the index once and broadcasts it. Offsets are 64-bit (a
// 4Mi-row table at ch = 2 is 4 GiB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWarpsPerBlock = 8;

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

template <int R, int PF>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_kernel(float* __restrict__ table, int64_t cap, int ch,
             const int32_t* __restrict__ idx, int64_t n,
             const float* __restrict__ packed, const float* __restrict__ grads,
             int dim, int n_slots, int sa, int sb, float step, Hparams p) {
  const int lane = threadIdx.x & 31;
  const int wc = ch * kLanes;  // 32-bit words per row
  const int dw = dim / PF;     // words per column block
  float lr_t = 0.0f;
  if (R == kAdam || R == kAdamW) {
    const float t = step + 1.0f;
    lr_t = p.h[0] * sqrtf(1.0f - powf(p.h[2], t)) / (1.0f - powf(p.h[1], t));
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kWarpsPerBlock;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock +
                   (threadIdx.x >> 5);
       j < n; j += stride) {
    int32_t raw = 0;
    if (lane == 0) raw = idx[j];
    raw = __shfl_sync(0xffffffffu, raw, 0);
    const int64_t r = (raw >= 0 && raw < cap) ? raw : cap;
    const float* src = packed + j * wc;
    const float* g = grads + j * dim;
    float* dst = table + r * wc;
    const int oa = sa >= 0 ? dw * (1 + sa) : 0;
    const int ob = sb >= 0 ? dw * (1 + sb) : 0;
    for (int c = lane; c < dw; c += 32) {
      if (PF == 1) {
        float v = src[c];
        float a = sa >= 0 ? src[oa + c] : 0.0f;
        float b = sb >= 0 ? src[ob + c] : 0.0f;
        update<R>(v, a, b, g[c], p, lr_t);
        dst[c] = v;
        if (sa >= 0) dst[oa + c] = a;
        if (sb >= 0) dst[ob + c] = b;
      } else {
        const uint32_t wv = __float_as_uint(src[c]);
        const uint32_t wa = sa >= 0 ? __float_as_uint(src[oa + c]) : 0u;
        const uint32_t wb = sb >= 0 ? __float_as_uint(src[ob + c]) : 0u;
        float ve = __uint_as_float(wv << 16), vo = __uint_as_float(wv & 0xFFFF0000u);
        float ae = __uint_as_float(wa << 16), ao = __uint_as_float(wa & 0xFFFF0000u);
        float be = __uint_as_float(wb << 16), bo = __uint_as_float(wb & 0xFFFF0000u);
        update<R>(ve, ae, be, g[2 * c], p, lr_t);
        update<R>(vo, ao, bo, g[2 * c + 1], p, lr_t);
        const auto pack = [](float even, float odd) {
          return __uint_as_float((rne_bf16(odd) & 0xFFFF0000u) |
                                 (rne_bf16(even) >> 16));
        };
        dst[c] = pack(ve, vo);
        if (sa >= 0) dst[oa + c] = pack(ae, ao);
        if (sb >= 0) dst[ob + c] = pack(be, bo);
      }
    }
    // the table's other slot columns pass through; padding words are zero
    for (int w = lane; w < wc; w += 32) {
      const int k = w / dw - 1;  // -1: the value block, else a slot
      if (k >= n_slots) {
        dst[w] = 0.0f;
      } else if (k >= 0 && k != sa && k != sb) {
        dst[w] = src[w];
      }
    }
  }
}

template <int R>
cudaError_t launch_rule(int pf, unsigned blocks, cudaStream_t stream,
                        float* table, int64_t cap, int ch, const int32_t* idx,
                        int64_t n, const float* packed, const float* grads,
                        int dim, int n_slots, int sa, int sb, float step,
                        const Hparams& p) {
  if (pf == 1) {
    fused_kernel<R, 1><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        table, cap, ch, idx, n, packed, grads, dim, n_slots, sa, sb, step, p);
  } else if (pf == 2) {
    fused_kernel<R, 2><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        table, cap, ch, idx, n, packed, grads, dim, n_slots, sa, sb, step, p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// table: [(cap+1)*ch*128] 32-bit words; idx: [n] int32; packed: [n, ch*128]
// 32-bit words; grads: [n, dim] f32; all contiguous. rule: the Rule enum;
// h0..h7: its hyper-parameters (see `update`). Launches on `stream` and
// returns the launch's CUDA error (0 on success).
extern "C" int fused_update_scatter(void* table, int64_t cap, int ch,
                                    const void* idx, int64_t n,
                                    const void* packed, const void* grads,
                                    int dim, int n_slots, int pf, int rule,
                                    int slot_a, int slot_b, float step,
                                    float h0, float h1, float h2, float h3,
                                    float h4, float h5, float h6, float h7,
                                    void* stream) {
  if (n <= 0) return 0;
  const Hparams p = {{h0, h1, h2, h3, h4, h5, h6, h7}};
  int64_t blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > (1 << 20)) blocks = 1 << 20;  // the loop strides the rest
  const auto b = static_cast<unsigned>(blocks);
  auto* t = static_cast<float*>(table);
  const auto* i = static_cast<const int32_t*>(idx);
  const auto* pk = static_cast<const float*>(packed);
  const auto* g = static_cast<const float*>(grads);
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (rule) {
    case kSgd:
      err = launch_rule<kSgd>(pf, b, s, t, cap, ch, i, n, pk, g, dim, n_slots,
                              slot_a, slot_b, step, p);
      break;
    case kMomentum:
      err = launch_rule<kMomentum>(pf, b, s, t, cap, ch, i, n, pk, g, dim,
                                   n_slots, slot_a, slot_b, step, p);
      break;
    case kAdagrad:
      err = launch_rule<kAdagrad>(pf, b, s, t, cap, ch, i, n, pk, g, dim,
                                  n_slots, slot_a, slot_b, step, p);
      break;
    case kAdam:
      err = launch_rule<kAdam>(pf, b, s, t, cap, ch, i, n, pk, g, dim,
                               n_slots, slot_a, slot_b, step, p);
      break;
    case kAdamW:
      err = launch_rule<kAdamW>(pf, b, s, t, cap, ch, i, n, pk, g, dim,
                                n_slots, slot_a, slot_b, step, p);
      break;
    case kRmsprop:
      err = launch_rule<kRmsprop>(pf, b, s, t, cap, ch, i, n, pk, g, dim,
                                  n_slots, slot_a, slot_b, step, p);
      break;
    case kFtrl:
      err = launch_rule<kFtrl>(pf, b, s, t, cap, ch, i, n, pk, g, dim,
                               n_slots, slot_a, slot_b, step, p);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
