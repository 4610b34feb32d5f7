"""The port's hashtable (ops/hashtable.py, ops/variable.py) against the JAX
package's on the same inputs: upsert (dedup, planning, eviction, the row
scatter), find, lookup and gather_values, for f32, f16 and bf16 tables.

The JAX side runs its XLA path on the CPU; the port runs its plain
PyTorch versions. Everything on this path is integer work or a dtype
cast, so every comparison is bit-exact (assert_array_equal, on integer
views of the value bits); rows are compared through ``rows_logical``,
which leaves out the trash row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch.ops import hashtable as tht
from recommenders_addons_tpu_torch.ops import variable as tvar

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float16": (jnp.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _carry(jst):
    """A JAX TableState carried across through convert.py."""
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.table_state_from_numpy(arrays, meta, device="cpu")


def _ibits(a):
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32, 1: np.int8}[a.dtype.itemsize])


def _tbits(t):
    return _ibits(t.view({2: torch.int16, 4: torch.int32,
                          1: torch.int8}[t.element_size()]).numpy())


def _assert_same_state(jst, tst):
    np.testing.assert_array_equal(tst.key_lo.numpy(), np.asarray(jst.key_lo))
    np.testing.assert_array_equal(tst.key_hi.numpy(), np.asarray(jst.key_hi))
    np.testing.assert_array_equal(tst.scores.numpy(), np.asarray(jst.scores))
    np.testing.assert_array_equal(_tbits(tst.rows_logical),
                                  _ibits(jst.rows_logical))


def _vars(name, dim, cap, dt, bucket_size=64, strategy="LRU"):
    jdt, tdt = DTYPES[dt]
    jv = jvar.Variable(name=name, dim=dim, init_capacity=cap,
                       value_dtype=jdt, bucket_size=bucket_size,
                       evict_strategy=getattr(jvar.EvictStrategy, strategy))
    tv = tvar.Variable(name=name, dim=dim, init_capacity=cap,
                       value_dtype=tdt, bucket_size=bucket_size,
                       evict_strategy=getattr(tvar.EvictStrategy, strategy),
                       device="cpu")
    return jv, tv


def _batch(rng, n, hi, dim, dups=True):
    keys = rng.integers(1, hi, size=n).astype(np.int64)
    if not dups:
        keys = np.unique(keys)
    vals = rng.normal(size=(len(keys), dim)).astype(np.float32)
    return keys, vals


def _probe(jv, jst, tv, tst, keys):
    """find / lookup / gather_values on both sides, compared."""
    jspec, tspec = jv.spec, tv.spec
    tkeys = torch.from_numpy(keys)
    jslot, jfound = jht.find(jspec, jst, jnp.asarray(keys))
    tslot, tfound = tht.find(tspec, tst, tkeys)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    f = np.asarray(jfound)
    np.testing.assert_array_equal(
        _tbits(tht.gather_values(tst, tslot, tfound))[f],
        _ibits(jht.gather_values(jst, jslot, jfound))[f])
    jvals, jf2 = jht.lookup(jspec, jst, jnp.asarray(keys), 0.5)
    tvals, tf2 = tht.lookup(tspec, tst, tkeys, 0.5)
    np.testing.assert_array_equal(tf2.numpy(), np.asarray(jf2))
    np.testing.assert_array_equal(_tbits(tvals), _ibits(jvals))
    np.testing.assert_array_equal(
        _tbits(tv.lookup(tst, tkeys)), _ibits(jv.lookup(jst, jnp.asarray(keys))))


@pytest.mark.parametrize("dt", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("dim", [8, 64])
def test_upsert_lookup_match_jax(dt, dim):
    jv, tv = _vars(f"ht_{dt}_{dim}", dim, 1024, dt)
    jst, tst = jv.init(), tv.init()
    _assert_same_state(jst, tst)
    rng = np.random.default_rng(dim)
    for step in (1, 2):
        keys, vals = _batch(rng, 300, 800, dim)  # with duplicate keys
        jst = jv.upsert(jst, jnp.asarray(keys), jnp.asarray(vals), step=step)
        tst = tv.upsert(tst, torch.from_numpy(keys), torch.from_numpy(vals),
                        step=step)
        _assert_same_state(jst, tst)
    assert int(tv.size(tst)) == int(jv.size(jst))
    probe = np.concatenate([keys[:100], [799, 900, 12345, jht.INT64_MAX],
                            [np.iinfo(np.int64).min]]).astype(np.int64)
    _probe(jv, jst, tv, tst, probe)


def test_duplicate_keys_last_write_wins():
    jv, tv = _vars("ht_dups", 8, 256, "float32")
    keys = np.array([5, 9, 5, 77, 9, 5], np.int64)
    vals = np.arange(6 * 8, dtype=np.float32).reshape(6, 8)
    jst = jv.upsert(jv.init(), jnp.asarray(keys), jnp.asarray(vals))
    tst = tv.upsert(tv.init(), torch.from_numpy(keys), torch.from_numpy(vals))
    _assert_same_state(jst, tst)
    got = tv.lookup(tst, torch.tensor([5, 9, 77]))
    np.testing.assert_array_equal(got.numpy(), vals[[5, 4, 3]])


@pytest.mark.parametrize("strategy", ["LRU", "LFU"])
def test_bucket_overflow_evicts_same_victims(strategy):
    """A table small enough that buckets overflow: eviction victims (and
    dropped keys) must match slot for slot."""
    jv, tv = _vars(f"ht_evict_{strategy}", 8, 128, "float32",
                   bucket_size=16, strategy=strategy)
    jst, tst = jv.init(), tv.init()
    rng = np.random.default_rng(5)
    for step in range(1, 5):
        keys, vals = _batch(rng, 150, 10_000, 8)
        jst = jv.upsert(jst, jnp.asarray(keys), jnp.asarray(vals), step=step)
        tst = tv.upsert(tst, torch.from_numpy(keys), torch.from_numpy(vals),
                        step=step)
        _assert_same_state(jst, tst)
    assert int(tv.size(tst)) == 128  # full: later batches evicted
    _probe(jv, jst, tv, tst, keys)


def test_plan_writes_matches_jax_on_overflow():
    spec_j = jht.TableSpec(dim=8, capacity=64, bucket_size=16)
    spec_t = tht.TableSpec(dim=8, capacity=64, bucket_size=16)
    rng = np.random.default_rng(8)
    jst = jht.create(spec_j)
    pre = np.unique(rng.integers(1, 5000, 50)).astype(np.int64)
    jst = jht.upsert(spec_j, jst, jnp.asarray(pre),
                     jnp.zeros((len(pre), 8)),
                     jnp.asarray(rng.integers(0, 9, len(pre)), jnp.int32))
    tst = _carry(jst)
    keys = np.unique(rng.integers(1, 5000, 90)).astype(np.int64)
    keys = np.concatenate([keys, pre[:10], [jht.hashing.EMPTY_KEY]])
    jplan = jht._plan_writes(spec_j, jst, jnp.asarray(keys))
    tplan = tht._plan_writes(spec_t, tst, torch.from_numpy(keys))
    for j, t in zip(jplan, tplan):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert np.asarray(jplan[3]).any()  # some keys dropped


def test_carried_state_with_slots_matches_jax():
    """A table with two slot columns (ch = 2, value chunk vc = 1): upserts
    reset inserted rows' slots to their fresh fill, and gather_values
    reads value chunks at the row stride."""
    spec_j = jht.TableSpec(dim=64, capacity=512)
    spec_t = tht.TableSpec(dim=64, capacity=512)
    jst = jht.with_slot(jht.with_slot(jht.create(spec_j), "m", 0.0), "v", 0.25)
    rng = np.random.default_rng(3)
    keys, vals = _batch(rng, 200, 1000, 64, dups=False)
    jst = jht.upsert(spec_j, jst, jnp.asarray(keys), jnp.asarray(vals))
    tst = _carry(jst)
    assert tst.chunks == 2
    _assert_same_state(jst, tst)
    keys2, vals2 = _batch(rng, 200, 1500, 64, dups=False)
    jst = jht.upsert(spec_j, jst, jnp.asarray(keys2), jnp.asarray(vals2))
    tst = tht.upsert(spec_t, tst, torch.from_numpy(keys2),
                     torch.from_numpy(vals2))
    _assert_same_state(jst, tst)
    probe = np.concatenate([keys, keys2, [7777, 8888]]).astype(np.int64)
    jv = jvar.Variable(name="slots", dim=64, init_capacity=512)
    tv = tvar.Variable(name="slots", dim=64, init_capacity=512, device="cpu")
    _probe(jv, jst, tv, tst, probe)


@pytest.mark.parametrize("size", [None, 40])
def test_unique_static_and_dedup_last_match_jax(size):
    rng = np.random.default_rng(4)
    keys = rng.integers(-20, 20, size=64).astype(np.int64)
    keys[::9] = jht.hashing.EMPTY_KEY
    ju, jinv = jht.unique_static(jnp.asarray(keys), size=size)
    tu, tinv = tht.unique_static(torch.from_numpy(keys), size=size)
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tinv.numpy(), np.asarray(jinv))
    vals = rng.normal(size=(64, 3)).astype(np.float32)
    ju, (jp,) = jht.dedup_last(jnp.asarray(keys), (jnp.asarray(vals),))
    tu, (tp,) = tht.dedup_last(torch.from_numpy(keys),
                               (torch.from_numpy(vals),))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_int32_keys_match_jax():
    spec_j = jht.TableSpec(dim=8, capacity=256, key_dtype=jnp.int32)
    spec_t = tht.TableSpec(dim=8, capacity=256, key_dtype=torch.int32)
    rng = np.random.default_rng(6)
    keys = np.unique(rng.integers(-(1 << 31) + 1, 1 << 31, 100)).astype(
        np.int32)
    vals = rng.normal(size=(len(keys), 8)).astype(np.float32)
    jst = jht.upsert(spec_j, jht.create(spec_j), jnp.asarray(keys),
                     jnp.asarray(vals))
    tst = tht.upsert(spec_t, tht.create(spec_t, "cpu"),
                     torch.from_numpy(keys), torch.from_numpy(vals))
    _assert_same_state(jst, tst)
    np.testing.assert_array_equal(tst.keys.numpy(), np.asarray(jst.keys))
    jk, jvals, jm = jht.export(spec_j, jst)
    tk, tvals, tm = tht.export(spec_t, tst)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))


def test_convert_roundtrip_and_cpu_only_without_cuda():
    spec_j = jht.TableSpec(dim=8, capacity=128, value_dtype=jnp.bfloat16)
    jst = jht.create(spec_j)
    arrays, meta = convert.table_state_to_numpy(_carry(jst))
    for f in convert.ARRAY_FIELDS:
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jst, f)))
    assert meta["value_dtype_name"] == "bfloat16"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tvar.Variable(dim=8).init()
        with pytest.raises(RuntimeError):
            convert.table_state_from_numpy(arrays, meta)
