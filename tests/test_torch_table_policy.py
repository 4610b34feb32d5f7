"""The port's table policy surface against the JAX package's, on the same
table states: score eviction (``radix_select_threshold``,
``lowest_k_indices``, ``evict_lowest``), the restrict policies, ``grow``,
the exports, the object tables and their creators, the shadow ops, the
table metrics and the environment config.

Each table is filled by the port (its plain versions on the CPU) and
carried to the JAX package as arrays, so both sides start from the same
state; the JAX side runs its XLA path. Key and score planes, victim
indices and rows (moved, never computed) must be bit-exact. Tables are
small (capacity 1,024 = 16 buckets of 64, dim 8), filled past some
buckets' size so that inserts evict and drop.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import restrict as jrestrict
from recommenders_addons_tpu.ops import table_api as jtable
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.utils import config as jconfig
from recommenders_addons_tpu.utils import metrics as jmetrics
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.ops import hashtable as tht
from recommenders_addons_tpu_torch.ops import restrict as trestrict
from recommenders_addons_tpu_torch.ops import table_api as ttable
from recommenders_addons_tpu_torch.utils import config as tconfig
from recommenders_addons_tpu_torch.utils import metrics as tmetrics

DIM = 8
CAP = 1024
N_FILL = 900
EPOCH_BITS = 32  # an int64 EPOCH* score holds the epoch above bit 32


def _to_jax(tst):
    """The JAX ``TableState`` holding the port state ``tst``."""
    arrays, meta = convert.table_state_to_numpy(tst)
    return jht.TableState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          **meta)


def _carry(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.table_state_from_numpy(arrays, meta, device="cpu")


def _assert_same(tst, jst, rows=True):
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert tst.slot_names == tuple(jst.slot_names)
    if rows:  # the trash row (last row block) holds unspecified data
        n = tst.capacity * tst.chunks
        np.testing.assert_array_equal(
            tst.rows[:n].numpy().view(np.int32),
            np.asarray(jst.rows)[:n].view(np.int32))


def _scores(rng, n, sdt):
    """Scores with many ties: int32 in [0, 40); int64 as EPOCH* scores
    (epoch above bit 32, a step below), with a few negative ones."""
    if sdt == "int32":
        return rng.integers(0, 40, size=n).astype(np.int32)
    s = (rng.integers(0, 4, size=n) << EPOCH_BITS) | rng.integers(0, 9, n)
    s[::17] = -rng.integers(1, 1 << 40, size=len(s[::17]))
    return s.astype(np.int64)


STRATEGY = {"int32": "LRU", "int64": "EPOCHLRU"}


def _filled(sdt="int32", strategy=None, value_dtype=torch.float32,
            slots=("m", "v"), seed=0, n=N_FILL, cap=CAP):
    """A port Variable and a table of ``n`` random keys (some buckets
    overflow), random rows and slot rows, and scores with ties; plus the
    same Variable in the JAX package."""
    strategy = strategy or STRATEGY[sdt]
    rng = np.random.default_rng(seed)
    kw = dict(name="tp", dim=DIM, init_capacity=cap,
              evict_strategy=getattr(tde.EvictStrategy, strategy))
    tv = tde.Variable(value_dtype=value_dtype, device="cpu", **kw)
    jv = jvar.Variable(value_dtype=tht.dtype_name(value_dtype),
                       **dict(kw, evict_strategy=getattr(
                           jvar.EvictStrategy, strategy)))
    st = tv.init()
    for i, nm in enumerate(slots):
        st = tht.with_slot(st, nm, 0.1 * i)
    keys = rng.choice(1 << 40, size=n, replace=False).astype(np.int64) + 1
    vals = torch.from_numpy(rng.normal(size=(n, DIM)).astype(np.float32))
    srows = {nm: torch.from_numpy(rng.normal(size=(n, DIM)).astype(
        np.float32)) for nm in slots}
    st = tv.import_batch(st, torch.from_numpy(keys), vals,
                         scores=torch.from_numpy(_scores(rng, n, sdt)),
                         slot_rows=srows or None)
    return tv, jv, st


# ---------------------------------------------------------------------------
# eviction
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jit_lowest(num_evict):
    return jax.jit(lambda s, m: jht.lowest_k_indices(s, m, num_evict))


@pytest.mark.parametrize("sdt", ["int32", "int64"])
def test_radix_select_and_lowest_k_match(sdt):
    """Threshold, count below, victim indices and valid mask bit-exact:
    ties, dead slots (a fifth), negative scores, k from 0 past the live
    count."""
    rng = np.random.default_rng(1)
    sc = _scores(rng, CAP, sdt)
    mask = rng.random(CAP) > 0.2
    live = int(mask.sum())
    ts, tm = torch.from_numpy(sc), torch.from_numpy(mask)
    u_t = tht.to_unsigned_order(ts)
    u_j = jht.to_unsigned_order(jnp.asarray(sc))
    bits = 64 if sdt == "int64" else 32
    jsel = jax.jit(jht.radix_select_threshold)
    for k in (1, 2, 37, live // 2, live):
        jt, jb = jsel(u_j, jnp.asarray(mask), jnp.int32(k))
        tt, tb = tht.radix_select_threshold(u_t, tm, k, bits)
        want_t = np.asarray(jt).astype(np.uint64).view(np.int64)
        assert int(tt) == int(want_t) and int(tb) == int(jb), k
    for k in (0, 37, live, CAP + 5):
        ji, jvalid = _jit_lowest(k)(jnp.asarray(sc), jnp.asarray(mask))
        ti, tvalid = tht.lowest_k_indices(ts, tm, k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    # the victims, in slot order, are numpy's lowest by (score, slot)
    ti, tvalid = tht.lowest_k_indices(ts, tm, 37)
    order = np.lexsort((np.arange(CAP), sc))
    assert list(ti.numpy()) == sorted(
        [i for i in order if mask[i]][:37])


@pytest.mark.parametrize("sdt", ["int32", "int64"])
@pytest.mark.parametrize("num_evict", [0, 123, 5000])
def test_evict_lowest_matches(sdt, num_evict):
    tv, jv, st = _filled(sdt)
    want = jax.jit(jht.evict_lowest, static_argnums=(0, 2))(
        jv.spec, _to_jax(st), num_evict)
    got = tht.evict_lowest(tv.spec, st, num_evict)
    _assert_same(got, want)
    live = int(tv.size(st))
    assert int(tv.size(got)) == max(live - num_evict, 0)


# ---------------------------------------------------------------------------
# restrict policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy,strategy,sdt", [
    ("TimestampRestrictPolicy", "LRU", "int32"),
    ("FrequencyRestrictPolicy", "LFU", "int32"),
    ("TimestampRestrictPolicy", "EPOCHLRU", "int64"),
])
def test_restrict_policies_match(policy, strategy, sdt):
    """Above the trigger the lowest scores go until ``num_reserved``
    remain (the survivors are numpy's top by (score, slot)); at or below
    it, nothing changes."""
    tv, jv, st = _filled(sdt, strategy)
    live = int(tv.size(st))
    tp = getattr(trestrict, policy)(tv)
    jp = getattr(jrestrict, policy)(jv)
    for reserved, trigger in ((500, None), (300, live), (live - 1, None)):
        got = tp.apply_restriction(st, reserved, trigger)
        want = jp.apply_restriction(_to_jax(st), reserved, trigger)
        _assert_same(got, want)
        n = int(tv.size(got))
        if trigger is not None and live <= trigger:
            assert n == live
            continue
        assert n == reserved
        mask = tht.occupancy_mask(tv.spec, st).numpy()
        sc = st.scores.numpy()
        order = [i for i in np.lexsort((np.arange(CAP), sc)) if mask[i]]
        kept = np.flatnonzero(tht.occupancy_mask(tv.spec, got).numpy())
        np.testing.assert_array_equal(np.sort(order[live - reserved:]), kept)
    # the Variable's own hookup
    tv2 = dataclasses.replace(tv, restrict_policy=getattr(trestrict, policy))
    _assert_same(tv2.restrict(st, 400), jp.apply_restriction(
        _to_jax(st), 400))


def test_restrict_apply_update_matches():
    """Score refresh of a set of ids (hits, misses, duplicates) outside a
    training step, LRU and LFU."""
    for strategy in ("LRU", "LFU"):
        tv, jv, st = _filled("int32", strategy)
        keys = tv.export(st)[0][tht.occupancy_mask(tv.spec, st)].numpy()
        ids = np.concatenate([keys[:50], keys[:10], [7, 9]])
        got = trestrict.RestrictPolicy(tv).apply_update(
            st, torch.from_numpy(ids), step=77)
        want = jrestrict.RestrictPolicy(jv).apply_update(
            _to_jax(st), jnp.asarray(ids), step=77)
        _assert_same(got, want)


# ---------------------------------------------------------------------------
# grow and the exports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_grow_matches(value_dtype):
    """Both stream the old table in slot order; 300-slot chunks leave a
    padded last chunk."""
    tv, jv, st = _filled(value_dtype=value_dtype)
    nv, got = tv.grow(st, 4 * CAP, chunk_size=300)
    jnv, want = jv.grow(_to_jax(st), 4 * CAP, chunk_size=300)
    assert nv.spec.capacity == jnv.spec.capacity == 4 * CAP
    assert nv.max_capacity is None and nv.init_capacity == 4 * CAP
    _assert_same(got, want)
    assert int(nv.size(got)) == int(tv.size(st))
    with pytest.raises(ValueError):
        tv.grow(st, CAP // 2)


@pytest.mark.parametrize("value_dtype", [torch.float32, torch.bfloat16])
def test_exports_match(value_dtype):
    tv, jv, st = _filled(value_dtype=value_dtype)
    jst = _to_jax(st)
    parts = list(tv.export_chunked(st, 300))
    jparts = list(jv.export_chunked(jst, 300))
    assert len(parts) == len(jparts)
    for (k, v, s), (jk, jvv, js) in zip(parts, jparts):
        np.testing.assert_array_equal(k.numpy(), jk)
        np.testing.assert_array_equal(v.float().numpy(),
                                      np.asarray(jvv, np.float32))
        np.testing.assert_array_equal(s.numpy(), js)
    k, s, m = tv.export_keys_and_scores(st)
    jk, js, jm = jv.export_keys_and_scores(jst)
    for a, b in ((k, jk), (s, js), (m, jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the chunks in order are the whole export, compacted
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy(),
                                  k[m].numpy())
    with pytest.raises(ValueError):
        next(tv.export_chunked(st, 0))


# ---------------------------------------------------------------------------
# object tables, creators, shadow ops, metrics, config
# ---------------------------------------------------------------------------


def _jit_method(name, statics=()):
    """``jvar.Variable.<name>`` jitted once per Variable and static
    keywords (the object tables call them eagerly, which compiles every
    operation on its own)."""
    orig = getattr(jvar.Variable, name)
    jitted = {}

    def call(self, *args, **kw):
        st = {k: kw.pop(k) for k in statics if k in kw}
        key = (id(self), tuple(sorted(st.items())))
        if key not in jitted:  # the entry keeps ``self`` (and its id)
            jitted[key] = (self, jax.jit(
                lambda *a, **k: orig(self, *a, **k, **st)))
        return jitted[key][1](*args, **kw)

    return call


def test_table_api_surface_matches(monkeypatch):
    """insert / lookup (dynamic defaults) / accum / remove / size / the
    exports, on an HkvHashTable, then a CuckooHashTable that must grow
    instead of losing keys."""
    for name, statics in (("upsert", ("return_evicted",)), ("accum", ()),
                          ("import_batch", ("return_evicted",)),
                          ("remove", ()),
                          ("lookup", ("return_exists",
                                      "use_init_for_missing"))):
        monkeypatch.setattr(jvar.Variable, name, _jit_method(name, statics))
    rng = np.random.default_rng(3)
    kw = dict(dim=DIM, default_value=0.5, name="api")
    tt = ttable.HkvHashTable(init_capacity=256, device="cpu", **kw)
    jt = jtable.HkvHashTable(init_capacity=256, **kw)
    keys = rng.choice(1 << 30, size=200, replace=False).astype(np.int64)
    vals = rng.normal(size=(200, DIM)).astype(np.float32)
    for t in (tt, jt):
        t.insert(keys, vals)
        t.accum(keys[:40], vals[:40], vals[:40] * 2.0)
        t.remove(keys[150:160])
    assert tt.size() == jt.size()
    probe = np.concatenate([keys[:20], keys[150:155], [3, 4]])
    dv = np.full((len(probe), DIM), -1.0, np.float32)
    got, found = tt.lookup(probe, dynamic_default_values=dv,
                           return_exists=True)
    want, jfound = jt.lookup(probe, dynamic_default_values=dv,
                             return_exists=True)
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(tt.export(), jt.export()):
        np.testing.assert_array_equal(a.numpy(), b)
    for split in (0, 100):
        for a, b in zip(tt.export_keys_and_scores(split),
                        jt.export_keys_and_scores(split)):
            np.testing.assert_array_equal(a.numpy(), b)
    tc = ttable.CuckooHashTable(init_size=256, device="cpu", **kw)
    jc = jtable.CuckooHashTable(init_size=256, **kw)
    more = rng.choice(1 << 30, size=300, replace=False).astype(np.int64)
    mvals = rng.normal(size=(300, DIM)).astype(np.float32)
    for t in (tc, jc):  # 300 keys in 4 buckets of 64: the table grows
        t.insert(more, mvals)
    assert tc.size() == jc.size() == 300
    assert tc.var.spec.capacity == jc.var.spec.capacity > 256
    np.testing.assert_array_equal(tc.lookup(more).numpy(), mvals)
    _assert_same(tc.state, jc.state)


def test_kv_creator_mapping_matches():
    for cfg_kw in (dict(init_capacity=512, max_capacity=2048),
                   dict(init_capacity=1 << 20, max_capacity=1 << 22,
                        max_hbm_for_values=4096 * DIM * 4,
                        evict_strategy="LFU")):
        tkw = dict(cfg_kw)
        jkw = dict(cfg_kw)
        if "evict_strategy" in cfg_kw:
            tkw["evict_strategy"] = tde.EvictStrategy.LFU
            jkw["evict_strategy"] = jvar.EvictStrategy.LFU
        tc = ttable.HkvHashTableCreator(ttable.HkvHashTableConfig(**tkw))
        jc = jtable.HkvHashTableCreator(jtable.HkvHashTableConfig(**jkw))
        tvk = tc.get_variable_kwargs(dim=DIM, value_dtype=torch.float32)
        jvk = jc.get_variable_kwargs(dim=DIM, value_dtype=jnp.float32)
        assert {k: getattr(v, "name", v) for k, v in tvk.items()} == {
            k: getattr(v, "name", v) for k, v in jvk.items()}
        tv = tde.Variable(name="kc", dim=DIM, kv_creator=tc, device="cpu")
        jv = jde.Variable(name="kc", dim=DIM, kv_creator=jc)
        assert tv.spec.capacity == jv.spec.capacity
        assert tv.evict_strategy.name == jv.evict_strategy.name
        t = tc.create(dim=DIM, name="kt", device="cpu")
        j = jc.create(dim=DIM, name="kt")
        assert type(t).__name__ == type(j).__name__ == "HkvHashTable"
        assert t.var.spec.capacity == j.var.spec.capacity
    r = ttable.RedisTableCreator(ttable.RedisTableConfig(model_tag="m1"))
    assert r.create(dim=DIM, device="cpu", config=r.config).name == "table"
    assert ttable.RedisTable(dim=DIM, device="cpu", init_size=64,
                             config=ttable.RedisTableConfig()).name == "test"
    two = tde.Variable(dim=DIM, devices=["cpu", "cpu"])
    assert two.num_shards == 2 and two.total_capacity == jde.Variable(
        dim=DIM, devices=["a", "b"]).total_capacity
    assert tde.Variable(dim=DIM, devices=["cpu"]).device == "cpu"


def test_shadow_variable_matches():
    """Train mode: the trainable lookup with the max_norm clip, then the
    apply through the kept context (SGD); inference mode: the plain
    probe. Rows within rtol 1e-6 (the norm sums in another order)."""
    tv, jv, st = _filled(slots=())
    ids = np.concatenate([tv.export(st)[0][
        tht.occupancy_mask(tv.spec, st)].numpy()[:30], [5, 6, 5]])
    ts = tde.ShadowVariable(tv, max_norm=0.5)
    js = jde.ShadowVariable(jv, max_norm=0.5)
    temb = tde.shadow_ops.embedding_lookup(ts, st, torch.from_numpy(ids),
                                           training=True)
    jst = _to_jax(st)
    jemb = jde.shadow_ops.embedding_lookup(js, jst, jnp.asarray(ids),
                                           training=True)
    np.testing.assert_allclose(temb.numpy(), np.asarray(jemb), rtol=1e-6,
                               atol=1e-7)
    assert float(torch.linalg.vector_norm(temb, dim=-1).max()) <= 0.5 + 1e-6
    g = np.random.default_rng(4).normal(size=temb.shape).astype(np.float32)
    got = ts.apply_gradients(st, torch.from_numpy(g), tde.SGD(0.1), step=3)
    want = js.apply_gradients(jst, jnp.asarray(g), jde.SGD(0.1), step=3)
    _assert_same(got, want, rows=False)
    np.testing.assert_allclose(got.rows_logical.numpy(),
                               np.asarray(want.rows_logical), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(
        tde.shadow_ops.embedding_lookup_unique(ts, got, torch.from_numpy(
            ids), training=False).numpy(),
        np.asarray(jv.lookup(want, jnp.asarray(ids))))
    with pytest.raises(ValueError):
        tde.ShadowVariable(tv).apply_gradients(st, g, tde.SGD(0.1))
    sparse, dense = tde.trainable_wrapper_filter([ts, tv, torch.zeros(1)])
    assert len(sparse) == 2 and len(dense) == 1
    assert tde.TrainableWrapper is tde.ShadowVariable


def test_table_metrics_match():
    tv, jv, st = _filled()
    got = tmetrics.table_stats(tv.spec, st).as_dict()
    want = jmetrics.table_stats(jv.spec, _to_jax(st)).as_dict()
    assert got == want
    emb, ctx = tv.embedding_lookup(st, torch.tensor([1, 2, 3] + list(
        tv.export(st)[0][tht.occupancy_mask(tv.spec, st)][:5])))
    assert float(tmetrics.lookup_hit_rate(ctx)) == pytest.approx(5 / 8)


def test_env_config_matches(monkeypatch):
    assert tconfig.env_config() == tconfig.EnvConfig()
    monkeypatch.setenv("TFRA_TPU_CKPT_BUFFER_KEYS", "1234")
    monkeypatch.setenv("TFRA_NUM_WORKER_THREADS_FOR_LOOKUP_TABLE_INSERT", "3")
    monkeypatch.setenv("TFRA_SAVED_KV", "/some/dir")
    monkeypatch.setenv("TF_HASHTABLE_INIT_SIZE", "4096")
    t, j = tconfig.env_config(), jconfig.env_config()
    for f in ("default_init_size", "checkpoint_buffer_keys",
              "host_store_threads", "saved_kv_dir"):
        assert getattr(t, f) == getattr(j, f), f
    assert not hasattr(t, "disable_pallas")
    assert not hasattr(t, "disable_native")


def test_new_port_modules_import_no_jax():
    mods = ("ops.restrict", "ops.table_api", "ops.shadow_ops",
            "ops.warm_start", "utils.metrics", "train.checkpoint",
            "train.saver", "keras.models", "keras.callbacks")
    code = ("import sys\n" + "".join(
        f"import recommenders_addons_tpu_torch.{m}\n" for m in mods)
        + "assert 'jax' not in sys.modules, 'jax'\n"
        "assert not [m for m in sys.modules if m.split('.')[0] == "
        "'recommenders_addons_tpu'], 'the JAX package'\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
