"""The port's key hashing against the JAX package's (ops/hashing.py) and
against numpy uint64 math. Everything here is integer work, so every
comparison is bit-exact (assert_array_equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu.ops import hashing as jh
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu_torch.ops import hashing as th
from recommenders_addons_tpu_torch.ops import hashtable as tht

I64 = np.iinfo(np.int64)
I32 = np.iinfo(np.int32)


def _keys64(seed, n=512):
    rng = np.random.default_rng(seed)
    k = rng.integers(I64.min, I64.max, size=n, dtype=np.int64,
                     endpoint=True)
    edge = np.array([0, 1, -1, I64.min, I64.max, jh.EMPTY_KEY,
                     (1 << 56) | 7, -(1 << 40)], np.int64)
    return np.concatenate([edge, k, rng.integers(-1000, 1000, 64)])


def _keys32(seed, n=512):
    rng = np.random.default_rng(seed)
    k = rng.integers(I32.min, I32.max, size=n, dtype=np.int32,
                     endpoint=True)
    edge = np.array([0, 1, -1, I32.min, I32.max], np.int32)
    return np.concatenate([edge, k])


def _as_int64_bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.uint64 else a.astype(np.int64)


def test_sentinels():
    assert th.EMPTY_KEY == int(jh.EMPTY_KEY)
    assert th.EMPTY_KEY32 == int(jh.EMPTY_KEY32)
    assert th.empty_key_for(torch.int64) == int(jh.empty_key_for(np.int64))
    assert th.empty_key_for(torch.int32) == int(jh.empty_key_for(np.int32))
    with pytest.raises(ValueError):
        th.empty_key_for(torch.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix64_matches_jax_and_numpy(seed):
    k = _keys64(seed)
    got = th.mix64(torch.from_numpy(k)).numpy()
    want_jax = _as_int64_bits(jh.mix64(jnp.asarray(k)))
    want_np = jh._mix64_np(k).view(np.int64)
    np.testing.assert_array_equal(got, want_jax)
    np.testing.assert_array_equal(got, want_np)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mix32_matches_jax_and_numpy(seed):
    k = _keys32(seed)
    got = th.mix32(torch.from_numpy(k)).numpy()
    np.testing.assert_array_equal(got, _as_int64_bits(jh.mix32(jnp.asarray(k))))
    np.testing.assert_array_equal(got, jh._mix32_np(k).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1])
def test_unmix_inverts_and_matches_jax(seed):
    k64, k32 = _keys64(seed), _keys32(seed)
    m64 = th.mix(torch.from_numpy(k64))
    m32 = th.mix(torch.from_numpy(k32))
    np.testing.assert_array_equal(th.unmix(m64, torch.int64).numpy(), k64)
    back32 = th.unmix(m32, torch.int32)
    assert back32.dtype == torch.int32
    np.testing.assert_array_equal(back32.numpy(), k32)
    np.testing.assert_array_equal(
        th.unmix64(m64).numpy(),
        _as_int64_bits(jh.unmix64(jnp.asarray(m64.numpy().view(np.uint64)))))
    np.testing.assert_array_equal(
        th.unmix32(m32).numpy(),
        _as_int64_bits(jh.unmix32(
            jnp.asarray(m32.numpy().astype(np.uint32)))))


@pytest.mark.parametrize("num_buckets", [1, 64, 1 << 16, 1 << 22])
@pytest.mark.parametrize("kind", ["int64", "int32"])
def test_bucket_of_matches_jax(num_buckets, kind):
    k = _keys64(3) if kind == "int64" else _keys32(3)
    got = th.bucket_of(torch.from_numpy(k), num_buckets)
    assert got.dtype == torch.int32
    want = np.asarray(jh.bucket_of(jnp.asarray(k), num_buckets))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bucket_of_rejects_non_pow2():
    with pytest.raises(ValueError):
        th.bucket_of(torch.zeros(3, dtype=torch.int64), 3)


@pytest.mark.parametrize("num_shards", [1, 2, 3, 8, 7])
@pytest.mark.parametrize("kind", ["int64", "int32"])
def test_shard_of_matches_jax(num_shards, kind):
    k = _keys64(4) if kind == "int64" else _keys32(4)
    got = th.shard_of(torch.from_numpy(k), num_shards).numpy()
    want = np.asarray(jh.shard_of(jnp.asarray(k), num_shards))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jh.shard_of_np(k, num_shards))


@pytest.mark.parametrize("kind", ["int64", "int32"])
def test_split_join_key_matches_jax(kind):
    k = _keys64(5) if kind == "int64" else _keys32(5)
    lo, hi = tht.split_key(torch.from_numpy(k))
    jlo, jhi = jht.split_key(jnp.asarray(k).astype(jnp.int64))
    assert lo.dtype == hi.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    joined = tht.join_key(lo, hi)
    np.testing.assert_array_equal(joined.numpy(), k.astype(np.int64))
    np.testing.assert_array_equal(
        joined.numpy(), np.asarray(jht.join_key(jlo, jhi)))


def test_split_int_matches_split_key():
    for k in (0, -1, th.EMPTY_KEY, th.EMPTY_KEY32, (1 << 63) - 1, 12345):
        lo, hi = tht.split_key(torch.tensor([k], dtype=torch.int64))
        assert tht._split_int(k) == (int(lo), int(hi))


def test_native_string_hash_matches_numpy_and_jax():
    """``hash_strings(algo="fnv1a")`` runs the native batch hasher: bit
    for bit its plain version (the numpy ``_fnv1a64_vectorized``) and the
    JAX package's, on empty, multi-byte and long strings, over a batch
    large enough to be split across threads."""
    strings = (["", "a", "hello", "ünïcödé", "x" * 1000, b"\x00\xff"]
               + [f"feature_{i}" for i in range(20_000)])
    got = th.hash_strings(strings)
    np.testing.assert_array_equal(got, th._native_hash(strings))
    np.testing.assert_array_equal(got, th._fnv1a64_vectorized(strings))
    np.testing.assert_array_equal(got, jh.hash_strings(strings))
    assert (got != th.EMPTY_KEY).all()
