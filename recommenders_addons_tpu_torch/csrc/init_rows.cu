// Initial rows of the keys a training lookup did not find, written into
// the lookup's packed block in place, for NVIDIA Hopper (sm_90a). Built by
// recommenders_addons_tpu_torch/ops/cuda_ops.py with nvcc into a shared
// library with a plain C interface.
//
// Replaces no Pallas kernel: the JAX package draws these rows with XLA's
// threefry inside its jitted lookup (hashtable.py `plan_lookup_train`,
// initializers.py `materialize_rows`). The port's plain version
// (cuda_ops.py `init_rows_plain`) draws them with int64 torch ops: for
// every position of the batch, two `fold_in`s over [N] and `random_bits`
// over [N, dim], some 540 launches whose rows are then thrown away
// wherever the key was found.
//
// Computes, for the packed block `rows` ([n, w] elements of f32, bf16 or
// f16: the logical view, or the physical one, whose bytes are the same)
// and each position i:
//   if !found[i]: rows[i, 0:d] = init(fold_in(fold_in(base, lo), hi), d)
//   if inserted[i] and `fresh`: rows[i, d:w] = fresh[0:w-d]
// where lo/hi are the 32-bit words of the key uniq[i] (an int32 key
// folds its one word), fold_in(k, x) = threefry2x32(k, (0, x)), column
// j's draw is y0 ^ y1 of threefry2x32(key, (0, j)) (jax.random.bits with
// jax_threefry_partitionable), and init is jax.nn.initializers' uniform
// (`* scale`) or normal (`sqrt2 * erfinv(u) * stddev`) in the table's
// dtype. Found rows are not touched: the row gather put the stored row
// there. `fresh` (the slot columns' fills and the zero padding) is null
// for a table without slot columns, whose inserted rows keep their tail.
//
// Bits: the same as the plain version's for uniform on every dtype. The
// float steps repeat the torch ops one for one, each rounded as torch
// rounds it: a 16-bit op in f32 and once to the dtype (the products of
// two 16-bit values are exact in f32, so that rounding is the only one);
// the library is built without fused multiply-add (-fmad=false), and the
// constants that are rounded to the dtype come from the wrapper, which
// rounds them with torch. Normal also goes through log1pf and sqrtf:
// sqrtf is correctly rounded, log1pf is CUDA's, the function torch's own
// CUDA log1p calls, and may round an ulp apart from torch's CPU log1p.
//
// Bound on this card: the integer arithmetic of threefry (20 rounds of
// add, rotate, xor per draw: ~80 instructions), one draw per value and
// two per key; the bytes (the masks and keys, the rows written where not
// found) take less time at 3.35 TB/s. Every position that was not found
// is drawn, duplicates' non-representatives and EMPTY positions included
// (their key is EMPTY), because the packed block must come out as the
// plain version leaves it.
//
// Design: one warp per unit of 32 positions. Each lane loads its
// position's flags and key and, where not found, folds the key into the
// base key (the per-key key is drawn once, not once per column); a
// ballot then walks the unit's not-found positions in order, each
// broadcast by shuffle, and the lanes draw and store the row's columns
// side by side (lane, lane + 32, ...: coalesced stores). Found positions
// cost their flag load. A second ballot walks the inserted positions and
// the lanes copy `fresh` into their tails. No shared memory, no atomic,
// no second launch, no host read: the base key is read from the device.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// the value dtypes and initializers (cuda_ops.py _INIT_DTYPES, _INIT_KINDS)
constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr int kUniform = 0, kNormal = 1;

// ---------------------------------------------------------------------------
// threefry2x32 (ops/prng.py) and the float steps (ops/initializers.py)
// ---------------------------------------------------------------------------

template <int R0, int R1, int R2, int R3>
__device__ __forceinline__ void rounds4(uint32_t& x0, uint32_t& x1) {
  x0 += x1; x1 = __funnelshift_l(x1, x1, R0) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R1) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R2) ^ x0;
  x0 += x1; x1 = __funnelshift_l(x1, x1, R3) ^ x0;
}

// The threefry2x32 block (20 rounds) of key (k0, k1) on (x0, x1), in place.
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0; x1 += k1;
  rounds4<13, 15, 26, 6>(x0, x1); x0 += k1; x1 += k2 + 1u;
  rounds4<17, 29, 16, 24>(x0, x1); x0 += k2; x1 += k0 + 2u;
  rounds4<13, 15, 26, 6>(x0, x1); x0 += k0; x1 += k1 + 3u;
  rounds4<17, 29, 16, 24>(x0, x1); x0 += k1; x1 += k2 + 4u;
  rounds4<13, 15, 26, 6>(x0, x1); x0 += k2; x1 += k0 + 5u;
}

// fold_in: the key (k0, k1) becomes threefry2x32(key, (0, data)).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// x rounded to the dtype, nearest even, returned in f32 (exact).
template <int kDt>
__device__ __forceinline__ float to_dtype(float x) {
  if constexpr (kDt == kBF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else if constexpr (kDt == kF16) {
    return __half2float(__float2half_rn(x));
  } else {
    return x;
  }
}

// `_uniform`'s variate on [0, 1) in the dtype, as f32 (exact): the draw's
// top mantissa bits under the exponent of 1.0, minus 1. 16-bit types take
// rng_bits = 8 (bf16) or 16 (f16) of the draw.
template <int kDt>
__device__ __forceinline__ float unit(uint32_t r) {
  if constexpr (kDt == kBF16) {
    return __uint_as_float(((((r & 0xFFu) >> 1) | 0x3F80u)) << 16) - 1.0f;
  } else if constexpr (kDt == kF16) {
    const unsigned short h =
        static_cast<unsigned short>(((r & 0xFFFFu) >> 6) | 0x3C00u);
    return __half2float(__ushort_as_half(h)) - 1.0f;
  } else {
    return __uint_as_float((r >> 9) | 0x3F800000u) - 1.0f;
  }
}

// `_erfinv` for 16- and 32-bit floats: XLA's single-precision Giles
// polynomials in w = -log1p(-x*x), f32 constants rounded from the double
// literals as torch rounds the Python floats.
__device__ __forceinline__ float erfinv32(float x) {
  float w = -log1pf(-x * x);
  const bool lt = w < 5.0f;
  w = lt ? w - 2.5f : sqrtf(w) - 3.0f;
#define RA_ERFINV_C(a, b) (lt ? static_cast<float>(a) : static_cast<float>(b))
  float p = RA_ERFINV_C(2.81022636e-08, -0.000200214257);
  p = RA_ERFINV_C(3.43273939e-07, 0.000100950558) + p * w;
  p = RA_ERFINV_C(-3.5233877e-06, 0.00134934322) + p * w;
  p = RA_ERFINV_C(-4.39150654e-06, -0.00367342844) + p * w;
  p = RA_ERFINV_C(0.00021858087, 0.00573950773) + p * w;
  p = RA_ERFINV_C(-0.00125372503, -0.0076224613) + p * w;
  p = RA_ERFINV_C(-0.00417768164, 0.00943887047) + p * w;
  p = RA_ERFINV_C(0.246640727, 1.00167406) + p * w;
  p = RA_ERFINV_C(1.50140941, 2.83297682) + p * w;
#undef RA_ERFINV_C
  return fabsf(x) == 1.0f ? x * __int_as_float(0x7f800000) : p * x;
}

// One value from column j's draw r. Uniform: c0 = scale. Normal: c0 = lo
// (nextafter(-1, 0) in the dtype), c1 = sqrt(2) and c2 = stddev, each
// rounded to the dtype; the uniform's range hi - lo rounds to 2.0 in
// every dtype (the wrapper checks), so `_fma` is `x * 2 + lo`.
template <int kDt, int kKind>
__device__ __forceinline__ float value(uint32_t r, float c0, float c1,
                                       float c2) {
  const float v = unit<kDt>(r);
  if constexpr (kKind == kUniform) {
    return to_dtype<kDt>(v * c0);
  } else {
    float u = to_dtype<kDt>(v * 2.0f + c0);
    u = u < c0 ? c0 : u;  // torch.maximum(u, lo)
    const float z = to_dtype<kDt>(c1 * to_dtype<kDt>(erfinv32(u)));
    return to_dtype<kDt>(z * c2);
  }
}

template <int kDt>
__device__ __forceinline__ void store(void* rows, int64_t i, float x) {
  if constexpr (kDt == kBF16) {
    static_cast<__nv_bfloat16*>(rows)[i] = __float2bfloat16_rn(x);
  } else if constexpr (kDt == kF16) {
    static_cast<__half*>(rows)[i] = __float2half_rn(x);
  } else {
    static_cast<float*>(rows)[i] = x;
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int kDt, int kKind>
__global__ void __launch_bounds__(kThreads)
init_rows_kernel(void* __restrict__ rows, int64_t n, int64_t w, int d,
                 const void* __restrict__ keys, int key64,
                 const bool* __restrict__ found,
                 const bool* __restrict__ inserted,
                 const int64_t* __restrict__ rng, float c0, float c1,
                 float c2, const void* __restrict__ fresh) {
  using Elem = typename std::conditional<kDt == kF32, uint32_t,
                                         uint16_t>::type;
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (kThreads / 32);
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kThreads / 32) +
                        (threadIdx.x >> 5);
  const uint32_t b0 = static_cast<uint32_t>(rng[0]);
  const uint32_t b1 = static_cast<uint32_t>(rng[1]);
  for (int64_t base = first * 32; base < n; base += warps * 32) {
    const int64_t i = base + lane;
    const bool live = i < n;
    const bool miss = live && !found[i];
    const bool ins = live && fresh != nullptr && inserted[i];
    uint32_t k0 = b0, k1 = b1;
    if (miss) {
      if (key64) {
        const uint64_t k = static_cast<const uint64_t*>(keys)[i];
        fold_in(k0, k1, static_cast<uint32_t>(k));
        fold_in(k0, k1, static_cast<uint32_t>(k >> 32));
      } else {
        fold_in(k0, k1, static_cast<const uint32_t*>(keys)[i]);
      }
    }
    for (unsigned m = __ballot_sync(kFull, miss); m; m &= m - 1) {
      const int src = __ffs(m) - 1;
      const uint32_t q0 = __shfl_sync(kFull, k0, src);
      const uint32_t q1 = __shfl_sync(kFull, k1, src);
      const int64_t row = (base + src) * w;
#pragma unroll 2
      for (int j = lane; j < d; j += 32) {
        uint32_t x0 = 0u, x1 = static_cast<uint32_t>(j);
        threefry(q0, q1, x0, x1);
        store<kDt>(rows, row + j, value<kDt, kKind>(x0 ^ x1, c0, c1, c2));
      }
    }
    for (unsigned m = __ballot_sync(kFull, ins); m; m &= m - 1) {
      const int64_t row = (base + __ffs(m) - 1) * w;
      Elem* out = static_cast<Elem*>(rows) + row + d;
      const Elem* src = static_cast<const Elem*>(fresh);
      for (int64_t j = lane; j < w - d; j += 32) out[j] = src[j];
    }
  }
}

template <int kDt, int kKind>
int launch(void* rows, int64_t n, int64_t w, int d, const void* keys,
           int key64, const void* found, const void* inserted,
           const void* rng, float c0, float c1, float c2, const void* fresh,
           void* stream) {
  const int64_t warps = (n + 31) / 32;
  const int64_t blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  init_rows_kernel<kDt, kKind>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          rows, n, w, d, keys, key64, static_cast<const bool*>(found),
          static_cast<const bool*>(inserted),
          static_cast<const int64_t*>(rng), c0, c1, c2, fresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 f32, 1 bf16, 2 f16; kind: 0 uniform, 1 normal; key64: keys are
// int64 (else int32); fresh: w - d elements of the dtype, or null.
extern "C" int init_rows(void* rows, int64_t n, int64_t w, int d, int dtype,
                         const void* keys, int key64, const void* found,
                         const void* inserted, const void* rng, int kind,
                         float c0, float c1, float c2, const void* fresh,
                         void* stream) {
  if (n <= 0) return 0;
  if (kind == kUniform) {
    if (dtype == kF32)
      return launch<kF32, kUniform>(rows, n, w, d, keys, key64, found,
                                    inserted, rng, c0, c1, c2, fresh, stream);
    if (dtype == kBF16)
      return launch<kBF16, kUniform>(rows, n, w, d, keys, key64, found,
                                     inserted, rng, c0, c1, c2, fresh,
                                     stream);
    if (dtype == kF16)
      return launch<kF16, kUniform>(rows, n, w, d, keys, key64, found,
                                    inserted, rng, c0, c1, c2, fresh, stream);
  } else if (kind == kNormal) {
    if (dtype == kF32)
      return launch<kF32, kNormal>(rows, n, w, d, keys, key64, found,
                                   inserted, rng, c0, c1, c2, fresh, stream);
    if (dtype == kBF16)
      return launch<kBF16, kNormal>(rows, n, w, d, keys, key64, found,
                                    inserted, rng, c0, c1, c2, fresh, stream);
    if (dtype == kF16)
      return launch<kF16, kNormal>(rows, n, w, d, keys, key64, found,
                                   inserted, rng, c0, c1, c2, fresh, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
