"""threefry2x32 counter-based random bits in torch integer ops — the port's
counterpart of the ``jax.random`` functions the JAX package's per-key
initializers use (``PRNGKey``, ``fold_in``, ``random_bits``), bit for bit.

A key is an int64 tensor of shape ``[..., 2]`` holding two uint32 words
(JAX's raw ``uint32[2]`` threefry key); leading dimensions batch keys, as
``jax.vmap`` over keys would. All uint32 math runs in int64 with masks,
as in ``ops/hashing.py``: torch has no CPU uint32 shifts.

Layouts follow JAX with ``jax_enable_x64`` on (the JAX package enables it)
and ``jax_threefry_partitionable`` on (the default of the JAX this port
is held against): ``PRNGKey(seed)`` is ``[seed >> 32, seed & 0xFFFFFFFF]``,
and element ``i`` of ``random_bits`` is ``x0 ^ x1`` of
``threefry2x32(key, (0, i))`` for 32-bit draws, ``x0 << 32 | x1`` for
64-bit ones (``jax._src.prng._threefry_random_bits_partitionable``).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor):
    """The threefry2x32 block function (20 rounds) on broadcastable uint32
    values held in int64. Returns ``(y0, y1)``."""
    k0, k1 = k0 & _M32, k1 & _M32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 64-bit seed: ``[2]`` int64."""
    seed = int(seed) & ((1 << 64) - 1)
    return torch.tensor([seed >> 32, seed & _M32], dtype=torch.int64,
                        device=device)


def fold_in(key: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of uint32 ``data`` (any int tensor; its low
    32 bits) into ``key`` ``[..., 2]``, batched over ``data``'s shape:
    returns ``data.shape + [2]`` keys."""
    d = data.to(torch.int64) & _M32
    y0, y1 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, shape, width: int = 32) -> torch.Tensor:
    """``width`` (32 or 64) random bits per element, ``[..., *shape]`` for
    keys ``[..., 2]``: ``jax.random.bits(key, shape, uint32)`` as uint32
    values in int64, or ``uint64`` bits reinterpreted as int64. Element
    ``i`` is one threefry2x32 block at the counter ``(i >> 32, i & M32)``;
    a 32-bit draw folds its two words, a 64-bit one takes the first as
    its high word."""
    if width not in (32, 64):
        raise ValueError(f"random_bits draws 32 or 64 bits, not {width}")
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    lead = tuple(key.shape[:-1])
    k0 = key[..., 0].reshape(lead + (1,))
    k1 = key[..., 1].reshape(lead + (1,))
    count = torch.arange(n, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(k0, k1, count >> 32, count & _M32)
    if width == 32:
        return (y0 ^ y1).reshape(lead + shape)
    # the high word as a signed int32 value, so the product stays in range
    hi = y0 - ((y0 >> 31) << 32)
    return (hi * (1 << 32) + y1).reshape(lead + shape)
