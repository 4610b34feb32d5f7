"""Frozen copy of the per-key initial rows that the port's tables document
(``jax.random`` threefry2x32 bits, ``jax.nn.initializers.uniform``): a
key's row is a pure function of the table's seed and the key.

uint32 math in int64 with masks. Only what the benchmark's tables use is
kept: ``uniform(scale)`` rows of float32.
"""

from __future__ import annotations

import zlib

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function, 20 rounds, on uint32 values held in
    int64 (broadcastable)."""
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


def table_key(name: str):
    """``PRNGKey(crc32(name))`` as two Python ints (a table's base key when
    it is given no seed)."""
    seed = zlib.crc32(name.encode("utf-8"))
    return seed >> 32, seed & _M32


def _fold_in(k0, k1, data: torch.Tensor):
    d = data & _M32
    return threefry2x32(k0, k1, torch.zeros_like(d), d)


def uniform_rows(table_name: str, keys: torch.Tensor, dim: int,
                 scale: float) -> torch.Tensor:
    """``[N, dim]`` float32 initial rows of int64 ``keys``: each key's low
    word, then its high word, folded into the table's base key; ``dim``
    32-bit draws at counters ``(0, i)``, each folded ``x0 ^ x1``; the top 23
    bits under the exponent of 1.0, minus 1, times ``scale``."""
    b0, b1 = table_key(table_name)
    k = keys.to(torch.int64)
    k0, k1 = _fold_in(torch.tensor(b0, device=k.device),
                      torch.tensor(b1, device=k.device), k & _M32)
    k0, k1 = _fold_in(k0, k1, (k >> 32) & _M32)
    count = torch.arange(dim, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k0[:, None], k1[:, None], count >> 32,
                          count & _M32)
    bits = (y0 ^ y1) & _M32
    fbits = (bits >> 9) | 0x3F800000
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    floats = torch.clamp_min(floats, 0.0)
    return floats * torch.tensor(scale, dtype=torch.float32)
