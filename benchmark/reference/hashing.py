"""Frozen copy of the key hash the port's table documents: SplitMix64's
finalizer over int64 keys, a key's bucket from the low mixed bits, and the
order of new keys inside a bucket (the mixed bits above the bucket bits).

All uint64 math runs in int64 with masks: torch has no uint64 shifts.
"""

from __future__ import annotations

import torch


def _signed64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


_C1 = _signed64(0xBF58476D1CE4E5B9)
_C2 = _signed64(0x94D049BB133111EB)


def srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits by ``s`` (1..63)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(keys: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer: the mixed uint64 bits as int64."""
    z = keys.to(torch.int64)
    z = z ^ srl(z, 30)
    z = z * _C1
    z = z ^ srl(z, 27)
    z = z * _C2
    return z ^ srl(z, 31)


def bucket_of(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Bucket index in ``[0, num_buckets)`` (a power of two), int64."""
    return mix64(keys) & (num_buckets - 1)


def order_in_bucket(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """The rank key of new keys inside one bucket: the mixed bits above the
    bucket bits, as a non-negative int64 (a batch's new keys take free
    slots, then victims, in this order; the last ones are dropped when a
    bucket cannot hold them all)."""
    nb = num_buckets.bit_length() - 1
    m = mix64(keys)
    return srl(m, nb) if nb else srl(m, 1)
