"""Spill-tier checkpoints, port against the JAX package: tier files that
one package writes and the other reads (the table's rows and the tier's,
key by key), the files of an f32 and a bf16 hybrid table byte-identical
(meta JSON included), a restore given no tier merging the tier's rows
into the table with the warning, ``load_tier``'s split over processes
(by device-shard owner for local stores, by key for a shared one, which
only rank 0 dumps), and ``DECheckpoint``'s ``(table, tier)`` entry.

The JAX side's table work is jitted (``test_torch_spill.jax_jitted``);
tables hold 512 slots, dim 8. Everything compared is moved, never
computed, so every comparison is bit-exact.
"""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import spill as jspill
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.train import checkpoint as jckpt
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.ops import hashing as thash
from recommenders_addons_tpu_torch.ops import spill as tspill
from recommenders_addons_tpu_torch.train import checkpoint as tckpt
from test_torch_spill import (  # noqa: F401 (a fixture)
    _filled_pair,
    assert_planes,
    assert_stores_equal,
    jax_jitted,
)


def _to_jax(tst):
    arrays, meta = convert.table_state_to_numpy(tst)
    return jht.TableState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          **meta)


def _hybrid(name, value_dtype="float32"):
    """Both packages' tables and tiers holding the same rows: the port's
    filled (Adam slots for f32, Adagrad for bf16) and 120 of its rows
    demoted; the JAX table and store carried over as arrays."""
    opt = (None if value_dtype == "float32"
           else (tde.Adagrad(0.1), jde.Adagrad(0.1)))
    tv, jv, ts, _, keys, _ = _filled_pair(name, n=300, seed=5,
                                          value_dtype=value_dtype, opt=opt,
                                          jax_fill=False)
    tt, jt = tspill.SpillTier(tv), jspill.SpillTier(jv)
    ts = tt.demote(ts, 120)
    k, v, sc, sl = tt.store.export_all()
    if value_dtype == "bfloat16":  # the JAX store holds numpy bf16
        import ml_dtypes

        v = v.view(ml_dtypes.bfloat16)
        sl = {n: c.view(ml_dtypes.bfloat16) for n, c in sl.items()}
    jt.store.put(k, v, sc, sl)
    assert_stores_equal(tt.store, jt.store)
    return tv, jv, ts, _to_jax(ts), tt, jt, keys


def _per_key(state):
    """The live rows of either package's table sorted by key: keys,
    scores and the used row words (value and slot columns)."""
    keys = np.asarray(state.keys)
    live = keys != np.iinfo(np.int64).min
    order = np.argsort(keys[live], kind="stable")
    w = state.dim * (1 + len(state.slot_names))
    rows = state.rows_logical[:, :w]
    rows = (rows.contiguous().view(torch.int32).numpy()
            if isinstance(rows, torch.Tensor)
            else np.asarray(rows).view(np.int32))
    return (keys[live][order], np.asarray(state.scores)[live][order],
            rows[live][order])


def assert_per_key(a, b):
    for x, y, what in zip(_per_key(a), _per_key(b),
                          ("keys", "scores", "rows")):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("value_dtype", ["float32", "bfloat16"])
def test_hybrid_checkpoint_files_byte_identical(value_dtype, tmp_path):
    """The same hybrid table saved by both packages with ``tier=``: the
    same names (``tier/<var>_mht_tier_rank0_size1-*``) and bytes, meta
    JSON (``tier_keys_this_rank``) included; bf16 rows as their words."""
    tv, jv, ts, js, tt, jt, _ = _hybrid("ck_" + value_dtype[:2],
                                        value_dtype)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_dynamic_embedding(tv, ts, a, tier=tt, buffer_size=50)
    jckpt.save_dynamic_embedding(jv, js, b, tier=jt)
    names = _files(a)
    assert names == _files(b)
    tier_files = [n for n in names if "/tier/" in n]
    assert tier_files and all("_mht_tier_rank0_size1-" in n
                              for n in tier_files)
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_tier_files_read_across_packages(writer, tmp_path, jax_jitted):
    """One package saves the hybrid table with its tier, the other
    cold-restores both into a fresh table and tier: the table's rows
    (key by key: the restore places them anew) and the tier's store
    equal the saved ones."""
    tv, jv, ts, js, tt, jt, _ = _hybrid("ck_x" + writer)
    d = str(tmp_path)
    if writer == "port":
        tckpt.save_dynamic_embedding(tv, ts, d, tier=tt)
        jt2 = jspill.SpillTier(jv)
        js2 = jckpt.load_dynamic_embedding(
            jv, jde.create_slots(jv, jv.init(), jde.Adam(0.01)), d,
            tier=jt2)
        assert_per_key(ts, js2)
        assert_stores_equal(tt.store, jt2.store)
    else:
        jckpt.save_dynamic_embedding(jv, js, d, tier=jt)
        tt2 = tspill.SpillTier(tv)
        ts2 = tckpt.load_dynamic_embedding(
            tv, tde.create_slots(tv, tv.init(), tde.Adam(0.01)), d,
            tier=tt2)
        assert_per_key(ts2, js)
        assert_stores_equal(tt2.store, jt.store)


def test_restore_without_tier_merges_with_warning(tmp_path, jax_jitted):
    """``tier=None`` with tier files present: both packages warn and
    merge the tier's rows into the table, to the same planes."""
    tv, jv, ts, js, tt, jt, keys = _hybrid("ck_merge")
    d = str(tmp_path)
    tckpt.save_dynamic_embedding(tv, ts, d, tier=tt)
    with pytest.warns(UserWarning, match="spill-tier"):
        ts2 = tckpt.load_dynamic_embedding(tv, tv.init(), d)
    with pytest.warns(UserWarning, match="spill-tier"):
        js2 = jckpt.load_dynamic_embedding(jv, jv.init(), d)
    assert_planes(ts2, js2)
    assert int(tv.size(ts2)) == len(keys)


def test_load_tier_splits_over_processes(tmp_path):
    """``load_tier`` over 2 processes: a local store takes the keys whose
    owner shard (of 8) its process holds, a shared store the keys with
    ``shard_of_np(key, 2) == rank``; each rank's store equals the JAX
    package's, and together they cover every key once. A shared store
    is dumped by rank 0 only."""
    tv = tde.Variable(name="split", dim=4, init_capacity=256, device="cpu")
    jv = jvar.Variable(name="split", dim=4, init_capacity=256)
    keys = np.arange(1, 257, dtype=np.int64)
    vals = np.repeat((keys % 17).astype(np.float32)[:, None], 4, axis=1)
    src = tspill.HostKVStore(4)
    src.put(keys, vals, keys * 3, {"m": vals * 0.5})
    d = str(tmp_path)
    assert tckpt.save_tier(src, tv, d) == 256

    class Shared(tspill.HostKVStore):
        is_shared = True

    class JShared(jspill.HostKVStore):
        is_shared = True

    for shared in (False, True):
        got = []
        for rank in range(2):
            t = (Shared if shared else tspill.HostKVStore)(4)
            j = (JShared if shared else jspill.HostKVStore)(4)
            n = tckpt.load_tier(t, tv, d, proc_size=2, proc_rank=rank,
                                num_shards=8)
            assert n == jckpt.load_tier(j, jv, d, proc_size=2,
                                        proc_rank=rank, num_shards=8)
            assert_stores_equal(t, j)
            got.append(t.export_all()[0])
        mine = np.sort(np.concatenate(got))
        np.testing.assert_array_equal(mine, keys)
        if not shared:
            owner = thash.shard_of_np(got[1], 8) // 4
            assert (owner == 1).all()
    shared_src = Shared(4)
    shared_src.put(keys, vals)
    d2 = str(tmp_path / "shared")
    assert tckpt.save_tier(shared_src, tv, d2, proc_size=2,
                           proc_rank=1) == 0
    assert tckpt.save_tier(shared_src, tv, d2, proc_size=2,
                           proc_rank=0) == 256
    assert len(os.listdir(os.path.join(d2, "tier"))) == 3


def test_decheckpoint_tier_entry(tmp_path, jax_jitted):
    """``DECheckpoint(emb=(var, tier))``: the tier saves and restores
    with its table through the object API, and the JAX package's
    ``DECheckpoint`` restores the same directory to the same table and
    store."""
    tv, jv, ts, js, tt, jt, _ = _hybrid("ck_obj")
    d = str(tmp_path)
    dense = {"w": torch.arange(3.0)}
    tckpt.DECheckpoint(emb=(tv, tt), dense=None).save(
        d, {"emb": ts, "dense": dense}, step=5)
    tt2 = tspill.SpillTier(tv)
    out = tckpt.DECheckpoint(emb=(tv, tt2), dense=None).restore(
        d, {"emb": tv.init(), "dense": dense})
    assert_per_key(out["emb"], ts)
    assert_stores_equal(tt2.store, jt.store)
    jt2 = jspill.SpillTier(jv)
    jout = jckpt.DECheckpoint(emb=(jv, jt2)).restore(
        d, {"emb": jv.init()}, step=5)
    assert_planes(out["emb"], jout["emb"])
    assert_stores_equal(tt2.store, jt2.store)
