"""Row initializers — the port of the JAX package's ``ops/initializers.py``.

Each key's initial row is a pure function of ``(seed, key)``: the key is
folded into the table's base threefry key (``ops/prng.py``) and the row
drawn from that per-key key, so it matches the JAX package's row bit for
bit wherever the float transform is exact (``uniform``), and to float32
rounding where it is not (``normal`` goes through ``erfinv``: the port
evaluates XLA's single-precision polynomial for it, Giles' approximation,
so its rows stay within a few float32 ulps of the JAX package's).

Initializers are objects named after ``jax.nn.initializers``:
``init(keys [..., 2], shape, dtype) -> [..., *shape]``, batched over the
keys' leading dimensions (``jax.vmap`` written out).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Union

import torch

from recommenders_addons_tpu_torch.ops import prng

# float dtype -> (bits, mantissa bits, bits of 1.0)
_FLOAT_BITS = {
    torch.float32: (32, 23, 0x3F800000),
    torch.float16: (16, 10, 0x3C00),
    torch.bfloat16: (16, 7, 0x3F80),
}
_SIGNED_OF = {32: torch.int32, 16: torch.int16}
# Giles, "Approximating the erfinv function", single precision: the
# coefficients XLA's ErfInv uses for w < 5 and for w >= 5
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _uniform(keys: torch.Tensor, shape, dtype, minval: float,
             maxval: float) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``, batched:
    random mantissa bits under the exponent of 1.0, minus 1, scaled."""
    dtype = _float_dtype(dtype)
    nbits, nmant, one = _FLOAT_BITS[dtype]
    rng_bits = 8 if nmant < 8 else nbits
    bits = prng.random_bits(keys, shape) & ((1 << rng_bits) - 1)
    fbits = (bits >> (rng_bits - nmant)) | one
    floats = fbits.to(_SIGNED_OF[nbits]).view(dtype) - 1.0
    # 0-d CPU tensors: constants rounded to ``dtype`` as JAX rounds them,
    # passed to the device kernels by value
    lo = torch.tensor(minval, dtype=dtype)
    hi = torch.tensor(maxval, dtype=dtype)
    return torch.maximum(floats * (hi - lo) + lo, lo)


def _erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv in float32 as XLA evaluates it (16-bit inputs upcast)."""
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


@dataclasses.dataclass(frozen=True)
class normal:  # noqa: N801 - named after jax.nn.initializers.normal
    """Normal with mean 0 and standard deviation ``stddev``."""

    stddev: float = 1e-2
    dtype: Any = None

    def __call__(self, keys, shape, dtype=None):
        dt = _float_dtype(dtype or self.dtype or torch.float32)
        # nextafter(-1, 0) in ``dt``: JAX's lower bound for the erfinv input
        lo = -1.0 + 2.0 ** -(_FLOAT_BITS[dt][1] + 1)
        u = _uniform(keys, shape, dt, lo, 1.0)
        z = torch.tensor(math.sqrt(2), dtype=dt) * _erfinv(u).to(dt)
        return z * torch.tensor(self.stddev, dtype=dt)


InitializerT = Union[None, float, int, torch.Tensor, uniform, normal]


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


def default_value_of(initializer: InitializerT, dim: int, dtype,
                     device=None) -> torch.Tensor:
    """The static [dim] default row used for INFERENCE-mode misses: zeros
    for ``None`` or a callable initializer, else the broadcast constant."""
    if initializer is None or callable(initializer):
        return torch.zeros((dim,), dtype=dtype, device=device)
    return torch.as_tensor(initializer, dtype=dtype,
                           device=device).expand((dim,))
