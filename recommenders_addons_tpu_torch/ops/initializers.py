"""Row initializers — the port of the JAX package's ``ops/initializers.py``.

Each key's initial row is a pure function of ``(seed, key)``: the key is
folded into the table's base threefry key (``ops/prng.py``) and the row
drawn from that per-key key, so it matches the JAX package's row bit for
bit wherever the float transform is exact (``uniform``, every float
dtype, f64 from 64-bit draws), and to a few ulps where it is not
(``normal`` and ``truncated_normal`` go through ``erfinv``: the port
evaluates XLA's expansions of it, Giles' approximations, in single
precision for 16- and 32-bit floats and in double precision, with XLA's
``log1p``, for f64; transcendental calls and operation contraction may
round an ulp apart).

Integer and bool tables take constant initializers only: a random one
raises ``TypeError``, as ``jax.random`` does.

Initializers are objects named after ``jax.nn.initializers``:
``init(keys [..., 2], shape, dtype) -> [..., *shape]``, batched over the
keys' leading dimensions (``jax.vmap`` written out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Union

import torch

from recommenders_addons_tpu_torch.ops import hashing, prng

# float dtype -> (bits, mantissa bits, bits of 1.0)
_FLOAT_BITS = {
    torch.float64: (64, 52, 0x3FF0000000000000),
    torch.float32: (32, 23, 0x3F800000),
    torch.float16: (16, 10, 0x3C00),
    torch.bfloat16: (16, 7, 0x3F80),
}
_SIGNED_OF = {64: torch.int64, 32: torch.int32, 16: torch.int16}
# Giles, "Approximating the erfinv function", single precision: the
# coefficients XLA's ErfInv uses for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
# Giles' double-precision polynomials, the coefficients of XLA's f64
# ErfInv for w < 6.25, w < 16 and w >= 16 (highest degree first; the three
# are evaluated aligned at their first coefficient)
_ERFINV64_LT625 = (
    -3.64441206401782e-21, -1.6850591381820166e-19, 1.28584807152564e-18,
    1.1157877678025181e-17, -1.333171662854621e-16, 2.0972767875968562e-17,
    6.637638134358324e-15, -4.054566272975207e-14, -8.151934197605472e-14,
    2.6335093153082323e-12, -1.2975133253453532e-11, -5.415412054294628e-11,
    1.0512122733215323e-09, -4.112633980346984e-09, -2.9070369957882005e-08,
    4.2347877827932404e-07, -1.3654692000834679e-06, -1.3882523362786469e-05,
    0.00018673420803405714, -0.000740702534166267, -0.006033670871430149,
    0.24015818242558962, 1.6536545626831027)
_ERFINV64_LT16 = (
    2.2137376921775787e-09, 9.075656193888539e-08, -2.7517406297064545e-07,
    1.8239629214389228e-08, 1.5027403968909828e-06, -4.013867526981546e-06,
    2.9234449089955446e-06, 1.2475304481671779e-05, -4.7318229009055734e-05,
    6.828485145957318e-05, 2.4031110387097894e-05, -0.0003550375203628475,
    0.0009532893797373805, -0.0016882755560235047, 0.002491442096107851,
    -0.003751208507569241, 0.005370914553590064, 1.0052589676941592,
    3.0838856104922208)
_ERFINV64_GE16 = (
    -2.7109920616438573e-11, -2.555641816996525e-10, 1.5076572693500548e-09,
    -3.789465440126737e-09, 7.61570120807834e-09, -1.496002662714924e-08,
    2.914795345090108e-08, -6.771199775845234e-08, 2.2900482228026655e-07,
    -9.9298272942317e-07, 4.526062597223154e-06, -1.968177810553167e-05,
    7.599527703001776e-05, -0.00021503011930044477, -0.00013871931833623122,
    1.0103004648645344, 4.849906401408584)
# XLA's log1p for |x| < sqrt(2) - 1: the Cephes rational approximation
# (numerator and denominator, highest degree first)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _uniform(keys: torch.Tensor, shape, dtype, minval: float,
             maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, batched:
    random mantissa bits under the exponent of 1.0, minus 1, scaled."""
    dtype = _float_dtype(dtype)
    nbits, nmant, one = _FLOAT_BITS[dtype]
    if nbits == 64:
        # a logical shift of the int64-held uint64 draw
        mant = hashing._srl(prng.random_bits(keys, shape, 64), 64 - nmant)
        floats = (mant | one).view(dtype) - 1.0
    else:
        rng_bits = 8 if nmant < 8 else nbits
        bits = prng.random_bits(keys, shape) & ((1 << rng_bits) - 1)
        fbits = (bits >> (rng_bits - nmant)) | one
        floats = fbits.to(_SIGNED_OF[nbits]).view(dtype) - 1.0
    # 0-d CPU tensors: constants rounded to ``dtype`` as JAX rounds them,
    # passed to the device kernels by value
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    return torch.maximum(_fma(floats, hi - lo, lo), lo)


def _fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x * y + z`` rounded once, as XLA's CPU code contracts it into a
    fused multiply-add (``y``, ``z`` 0-d). Narrow floats go through f64,
    where their product is exact; f64 adds the product's rounding error
    back (Dekker's product, Knuth's sum), which rounds as one operation
    but for rare halfway cases. A power-of-two ``y`` (``uniform``'s and
    ``normal``'s ranges) makes the product exact: then ``x * y + z``."""
    if abs(math.frexp(float(y))[0]) in (0.0, 0.5):
        return x * y + z
    if x.dtype != torch.float64:
        return (x.double() * y.double() + z.double()).to(x.dtype)

    def split(v):  # Veltkamp: v = hi + lo, each with 26 bits
        c = v * 134217729.0
        hi = c - (c - v)
        return hi, v - hi

    p = x * y
    (xh, xl), (yh, yl) = split(x), split(y)
    err = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl
    s = p + z
    zz = s - p
    return s + (((p - (s - zz)) + (z - zz)) + err)


def _poly(x: torch.Tensor, coeffs) -> torch.Tensor:
    """Horner's rule from the highest degree, as XLA's
    ``EvaluatePolynomial`` runs it."""
    p = torch.zeros_like(x)
    for c in coeffs:
        p = p * x + c
    return p


def _log1p64(x: torch.Tensor) -> torch.Tensor:
    """f64 log1p as XLA's CPU expansion evaluates it: the Cephes rational
    approximation below ``sqrt(2) - 1``, ``log(1 + x)`` above."""
    x2 = x * x
    small = (x * x2) * (_poly(x, _LOG1P_NUM) / _poly(x, _LOG1P_DEN))
    small = x + (-0.5 * x2 + small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


def _erfinv64(x: torch.Tensor) -> torch.Tensor:
    """erfinv in float64 as XLA evaluates it: three ranges of
    ``w = -log1p(-x*x)``, one polynomial each."""
    w = -_log1p64(x * -x)
    lt625 = w < 6.25
    lt16 = w < 16.0

    def coeff(i):
        c = torch.full_like(x, _ERFINV64_LT625[i])
        if i < len(_ERFINV64_LT16):
            c = torch.where(lt625, c, _ERFINV64_LT16[i])
        if i < len(_ERFINV64_GE16):
            c = torch.where(lt16, c, _ERFINV64_GE16[i])
        return c

    w = torch.where(lt625, w - 3.125,
                    torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
    p = coeff(0)
    for i in range(1, len(_ERFINV64_LT625)):
        step = coeff(i) + p * w
        if i < len(_ERFINV64_GE16):
            p = step
        elif i < len(_ERFINV64_LT16):
            p = torch.where(lt16, step, p)
        else:
            p = torch.where(lt625, step, p)
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv as XLA evaluates it: in float64 for f64 inputs, else in
    float32 (16-bit inputs upcast)."""
    if x.dtype == torch.float64:
        return _erfinv64(x)
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, a, b)  # float32 constants, no host copy
        p = c if p is None else c + p * w
    return torch.where(x.abs() == 1, x * float("inf"), p * x)


def _float_dtype(dtype) -> torch.dtype:
    from recommenders_addons_tpu_torch.ops.hashtable import torch_dtype

    dt = torch_dtype(dtype)
    if dt not in _FLOAT_BITS:
        raise TypeError(f"random initializers need a float dtype, got {dt}")
    return dt


@dataclasses.dataclass(frozen=True)
class uniform:  # noqa: N801 - named after jax.nn.initializers.uniform
    """Uniform on ``[0, scale)``."""

    scale: float = 1e-2
    dtype: Any = None

    def __call__(self, keys, shape, dtype=None):
        dt = _float_dtype(dtype or self.dtype or torch.float32)
        return _uniform(keys, shape, dt, 0.0, 1.0) * torch.tensor(
            self.scale, dtype=dt)


def normal_lower_bound(dt: torch.dtype) -> float:
    """nextafter(-1, 0) in ``dt``: JAX's lower bound for ``normal``'s erfinv
    input."""
    return -1.0 + 2.0 ** -(_FLOAT_BITS[dt][1] + 1)


@dataclasses.dataclass(frozen=True)
class normal:  # noqa: N801 - named after jax.nn.initializers.normal
    """Normal with mean 0 and standard deviation ``stddev``."""

    stddev: float = 1e-2
    dtype: Any = None

    def __call__(self, keys, shape, dtype=None):
        dt = _float_dtype(dtype or self.dtype or torch.float32)
        u = _uniform(keys, shape, dt, normal_lower_bound(dt), 1.0)
        z = torch.tensor(math.sqrt(2), dtype=dt) * _erfinv(u).to(dt)
        return z * torch.tensor(self.stddev, dtype=dt)


@dataclasses.dataclass(frozen=True)
class truncated_normal:  # noqa: N801 - jax.nn.initializers.truncated_normal
    """Normal with standard deviation ``stddev`` before truncation to
    ``(lower, upper)`` (in units of ``stddev``): ``sqrt(2) * erfinv(u)``
    for ``u`` uniform on ``[erf(lower/sqrt2), erf(upper/sqrt2))``, clipped
    inside the bounds. The two ``erf`` bounds are torch's, rounded to the
    dtype (XLA folds its own expansion)."""

    stddev: float = 1e-2
    dtype: Any = None
    lower: float = -2.0
    upper: float = 2.0

    def __call__(self, keys, shape, dtype=None):
        dt = _float_dtype(dtype or self.dtype or torch.float32)
        sqrt2 = torch.tensor(math.sqrt(2), dtype=dt)
        lower = torch.tensor(self.lower, dtype=dt)
        upper = torch.tensor(self.upper, dtype=dt)
        a = torch.erf((lower / sqrt2).double()).to(dt)
        b = torch.erf((upper / sqrt2).double()).to(dt)
        u = _uniform(keys, shape, dt, float(a), float(b))
        out = sqrt2 * _erfinv(u).to(dt)
        out = torch.clamp(out, _next_float(lower, up=True),
                          _next_float(upper, up=False))
        return out * torch.tensor(self.stddev, dtype=dt)


def _next_float(x: torch.Tensor, up: bool) -> float:
    """``nextafter(x, +inf if up else -inf)`` of a 0-d float tensor, in its
    own dtype (one step of its bits)."""
    if float(x) == 0:
        tiny = torch.ones(1, dtype=_SIGNED_OF[_FLOAT_BITS[x.dtype][0]])
        return float(tiny.view(x.dtype)[0]) * (1 if up else -1)
    bits = x.reshape(1).view(_SIGNED_OF[_FLOAT_BITS[x.dtype][0]])
    away = (float(x) > 0) == up  # away from zero: one more magnitude step
    return float((bits + (1 if away else -1)).view(x.dtype)[0])


InitializerT = Union[None, float, int, torch.Tensor, uniform, normal,
                     truncated_normal]


def per_key_rngs(base_rng: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Fold each key into ``base_rng``: ``[N, 2]`` per-key threefry keys.
    A 64-bit key folds its low word, then its high word."""
    k = keys.to(torch.int64)
    if keys.dtype == torch.int64:
        lo = k & 0xFFFFFFFF
        hi = (k >> 32) & 0xFFFFFFFF
        return prng.fold_in(prng.fold_in(base_rng, lo), hi)
    return prng.fold_in(base_rng, k)


def materialize_rows(initializer: InitializerT, base_rng: torch.Tensor,
                     keys: torch.Tensor, dim: int, dtype) -> torch.Tensor:
    """[N, dim] initial rows for ``keys``."""
    n = keys.shape[0]
    if initializer is None:
        return torch.zeros((n, dim), dtype=dtype, device=keys.device)
    if callable(initializer):
        return initializer(per_key_rngs(base_rng, keys), (dim,), dtype)
    arr = torch.as_tensor(initializer, dtype=dtype, device=keys.device)
    return arr.expand((n, dim)).clone()


@dataclasses.dataclass(frozen=True, eq=False)
class RowInit:
    """A table's initializer bound to its base threefry key, row width and
    value dtype: ``RowInit(...)(keys)`` is :func:`materialize_rows`. The
    training lookup's miss branch (``hashtable.plan_lookup_train``) calls
    :meth:`init_missing_rows` instead, which draws only the rows of the
    keys it did not find, on the card with the ``init_rows`` kernel
    (``cuda_ops.init_rows``) where that covers the initializer and the
    dtype."""

    initializer: InitializerT
    base_rng: torch.Tensor
    dim: int
    dtype: Any

    def __call__(self, keys: torch.Tensor) -> torch.Tensor:
        return materialize_rows(self.initializer, self.base_rng, keys,
                                self.dim, self.dtype)

    def init_missing_rows(self, state, n: int, packed: torch.Tensor,
                          uniq: torch.Tensor, found: torch.Tensor,
                          inserted: torch.Tensor) -> torch.Tensor:
        """``hashtable.init_missing_rows`` with this initializer: the packed
        block's value columns get the initial row where ``found`` is False,
        inserted rows' slot columns their fresh fills; in place. Uniform
        and normal on f32, bf16 and f16 tables go through
        ``cuda_ops.init_rows``; every other initializer and dtype takes the
        hashtable's own path."""
        from recommenders_addons_tpu_torch.ops import cuda_ops, hashtable

        dt = state.value_dtype
        if (self.dim != state.dim or hashtable.torch_dtype(self.dtype) != dt
                or not cuda_ops.init_rows_covers(self.initializer, dt)):
            return hashtable.init_missing_rows(state, n, packed, uniq, found,
                                               inserted, self)
        cuda_ops.init_rows(hashtable.packed_logical_view(state, n, packed),
                           uniq, found, inserted, self.base_rng,
                           self.initializer, self.dim,
                           hashtable.fresh_tail(state, packed.device))
        return packed


def default_value_of(initializer: InitializerT, dim: int, dtype,
                     device=None) -> torch.Tensor:
    """The static [dim] default row used for INFERENCE-mode misses: zeros
    for ``None`` or a callable initializer, else the broadcast constant."""
    if initializer is None or callable(initializer):
        return torch.zeros((dim,), dtype=dtype, device=device)
    return torch.as_tensor(initializer, dtype=dtype,
                           device=device).expand((dim,))
