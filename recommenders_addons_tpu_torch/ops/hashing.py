"""Key hashing / mixing utilities — bit-exact twins of the JAX package's
``ops/hashing.py`` (SplitMix64 and murmur3 fmix32 finalizers).

PyTorch has no CPU right shift for uint64, so all the math is done in
int64: constants are written as their signed int64 values, multiplication
wraps modulo 2^64, and a logical right shift is an arithmetic shift with
the sign-extended bits masked off (``_srl``). Outputs are int64 tensors
that hold the unsigned results: ``mix64`` returns the uint64 bits
reinterpreted as int64, ``mix32`` the uint32 value in ``[0, 2^32)``.

``hash_strings`` fingerprints string keys on the host, as the JAX
package does: FNV-1a through the native batch hasher
(``native/host_kv.cc``), whose plain version is the numpy
``_fnv1a64_vectorized``.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

# Reserved sentinel marking an empty hashtable slot AND the canonical padding
# id. Inputs equal to this value are never found and never inserted.
EMPTY_KEY = -(1 << 63)
# int32 tables get their own sentinel.
EMPTY_KEY32 = -(1 << 31)

_M32 = 0xFFFFFFFF


def _signed64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


_SPLITMIX_C1 = _signed64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2 = _signed64(0x94D049BB133111EB)
_MURMUR32_C1 = 0x85EBCA6B
_MURMUR32_C2 = 0xC2B2AE35
_SPLITMIX_C1_INV = _signed64(0x96DE1B173F119089)  # C1^-1 mod 2^64
_SPLITMIX_C2_INV = _signed64(0x319642B2D24D8EC3)  # C2^-1 mod 2^64
_MURMUR32_C1_INV = 0xA5CB9243
_MURMUR32_C2_INV = 0x7ED1B41D


def empty_key_for(dtype) -> int:
    if dtype in (torch.int64, "int64"):
        return EMPTY_KEY
    if dtype in (torch.int32, "int32"):
        return EMPTY_KEY32
    raise ValueError(f"unsupported key dtype {dtype}; use int32 or int64")


def _srl(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def mix64(keys: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer: int64 keys -> mixed uint64 bits (as int64)."""
    z = keys.to(torch.int64)
    z = z ^ _srl(z, 30)
    z = z * _SPLITMIX_C1
    z = z ^ _srl(z, 27)
    z = z * _SPLITMIX_C2
    return z ^ _srl(z, 31)


def mix32(keys: torch.Tensor) -> torch.Tensor:
    """Murmur3 fmix32 finalizer: int32 keys (or uint32 values held in
    int64) -> mixed uint32 value in an int64 tensor."""
    z = keys.to(torch.int64) & _M32
    z = z ^ (z >> 16)
    z = (z * _MURMUR32_C1) & _M32
    z = z ^ (z >> 13)
    z = (z * _MURMUR32_C2) & _M32
    return z ^ (z >> 16)


def unmix64(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mix64` (SplitMix64 is a bijection on 64 bits)."""
    z = z.to(torch.int64)
    z = z ^ _srl(z, 31) ^ _srl(z, 62)
    z = z * _SPLITMIX_C2_INV
    z = z ^ _srl(z, 27) ^ _srl(z, 54)
    z = z * _SPLITMIX_C1_INV
    return z ^ _srl(z, 30) ^ _srl(z, 60)


def unmix32(z: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`mix32` (murmur3 fmix32 is a bijection on uint32)."""
    z = z.to(torch.int64) & _M32
    z = z ^ (z >> 16)
    z = (z * _MURMUR32_C2_INV) & _M32
    z = z ^ (z >> 13) ^ (z >> 26)
    z = (z * _MURMUR32_C1_INV) & _M32
    return z ^ (z >> 16)


def _wrap32(u: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32)


def unmix(z: torch.Tensor, key_dtype) -> torch.Tensor:
    """Inverse of :func:`mix` for the given original key dtype."""
    if key_dtype in (torch.int64, "int64"):
        return unmix64(z)
    return _wrap32(unmix32(z))


def mix(keys: torch.Tensor) -> torch.Tensor:
    """Dtype-dispatching mixer (see the module docstring for the output)."""
    if keys.dtype == torch.int64:
        return mix64(keys)
    if keys.dtype == torch.int32:
        return mix32(keys)
    raise ValueError(f"unsupported key dtype {keys.dtype}")


def bucket_of(keys: torch.Tensor, num_buckets: int) -> torch.Tensor:
    """Bucket index in [0, num_buckets) from the LOW mixed bits (int32).

    ``num_buckets`` must be a power of two.
    """
    if num_buckets & (num_buckets - 1):
        raise ValueError("num_buckets must be a power of two")
    return (mix(keys) & (num_buckets - 1)).to(torch.int32)


def shard_of(keys: torch.Tensor, num_shards: int) -> torch.Tensor:
    """Shard index in [0, num_shards) from the HIGH mixed bits (int64
    keys) or a second mix round (int32 keys) — decorrelated from
    :func:`bucket_of`."""
    m = mix(keys)
    hi = _srl(m, 32) if keys.dtype == torch.int64 else mix32(m)
    return (hi % num_shards).to(torch.int32)


def default_partition_fn(keys: torch.Tensor, shard_num: int) -> torch.Tensor:
    """The reference's name for :func:`shard_of`."""
    return shard_of(keys, shard_num)


def shard_of_np(keys: np.ndarray, num_shards: int) -> np.ndarray:
    """:func:`shard_of` of host (numpy) keys, bit for bit the JAX
    package's ``shard_of_np``: the checkpoint restore partitions saved
    keys by owner with it before any copy to a device. Unsigned keys are
    mixed as the signed keys of the same bits."""
    keys = np.asarray(keys)
    signed = {np.dtype(np.uint64): np.int64, np.dtype(np.uint32): np.int32}
    if keys.dtype in signed:
        keys = keys.view(signed[keys.dtype])
    if keys.dtype not in (np.int64, np.int32):
        raise ValueError(f"unsupported key dtype {keys.dtype}")
    return shard_of(torch.from_numpy(np.ascontiguousarray(keys)),
                    num_shards).numpy()


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_SPLITMIX_C1_U = np.uint64(0xBF58476D1CE4E5B9)
_SPLITMIX_C2_U = np.uint64(0x94D049BB133111EB)


def _utf8(strings):
    return [s.encode("utf-8") if isinstance(s, str) else bytes(s)
            for s in strings]


def _fnv1a64_vectorized(strings) -> np.ndarray:
    """FNV-1a64 and the SplitMix64 finalizer over a batch of strings,
    vectorized over the batch one byte column at a time (the JAX
    package's numpy hasher, which its native batch hasher matches bit
    for bit)."""
    bs = _utf8(strings)
    n = len(bs)
    maxlen = max((len(b) for b in bs), default=0)
    mat = np.zeros((n, maxlen), np.uint8)
    lens = np.fromiter((len(b) for b in bs), np.int64, count=n)
    for i, b in enumerate(bs):
        mat[i, :len(b)] = np.frombuffer(b, np.uint8)
    h = np.full((n,), _FNV_OFFSET, np.uint64)
    with np.errstate(over="ignore"):
        for j in range(maxlen):
            hj = (h ^ mat[:, j].astype(np.uint64)) * _FNV_PRIME
            h = np.where(j < lens, hj, h)
        h = h + _GOLDEN
        h = (h ^ (h >> np.uint64(30))) * _SPLITMIX_C1_U
        h = (h ^ (h >> np.uint64(27))) * _SPLITMIX_C2_U
        h = h ^ (h >> np.uint64(31))
    out = h.view(np.int64)
    out[out == EMPTY_KEY] += 1
    return out


def hash_strings(strings, dtype=np.int64, algo: str = "fnv1a") -> np.ndarray:
    """Host-side fingerprints of string keys as int64 numpy ids (a
    feature-pipeline boundary op), bit-identical to the JAX package's
    ``hash_strings``: ``fnv1a`` (default) or ``blake2`` (8-byte BLAKE2b).
    Neither gives the EMPTY sentinel. ``fnv1a`` runs the native batch
    hasher (:func:`_native_hash`), bit for bit the numpy
    ``_fnv1a64_vectorized``."""
    if algo == "blake2":
        out = np.empty(len(strings), dtype=np.uint64)
        for i, b in enumerate(_utf8(strings)):
            out[i] = np.frombuffer(hashlib.blake2b(b, digest_size=8).digest(),
                                   dtype=np.uint64)[0]
        out = out.view(np.int64).copy()
        out[out == EMPTY_KEY] += 1
        return out.astype(dtype)
    if algo != "fnv1a":
        raise ValueError(f"unknown algo {algo}")
    return _native_hash(strings).astype(dtype)


def _native_hash(strings) -> np.ndarray:
    """FNV-1a64 and the SplitMix64 finalizer of each string, in C++
    (``hkv_fnv1a64_batch``, threaded over the batch)."""
    import ctypes

    from recommenders_addons_tpu_torch.native import get_lib
    from recommenders_addons_tpu_torch.utils.config import env_config

    bs = _utf8(strings)
    data = b"".join(bs)
    offsets = np.zeros(len(bs) + 1, np.int64)
    np.cumsum([len(b) for b in bs], out=offsets[1:])
    out = np.empty(len(bs), np.int64)
    buf = ctypes.create_string_buffer(data, len(data) or 1)
    get_lib().hkv_fnv1a64_batch(
        ctypes.cast(buf, ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p), len(bs),
        out.ctypes.data_as(ctypes.c_void_p),
        env_config().host_store_threads)
    return out
