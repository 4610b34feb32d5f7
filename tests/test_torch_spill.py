"""The port's spill tier against the JAX package's, on the same inputs:
the two host stores (numpy and native) through a put / get / delete /
grow churn, ``SpillTier`` (demote, the watermark, promote,
``lookup_through``, the tier-aware apply), ``ShardedSpillTier`` on 4
shards, a bf16 table, the choice of store, and the ``HybridTable``
sequence whose reference behaviour the port keeps (promoted rows the
watermark demotes again, keys then in both tiers).

The JAX side is jitted once per function (``jax_jitted``, a module
fixture; its eager calls compile every operation on its own), the port
runs its plain versions on the CPU. Key planes, scores, stores (keys,
rows, scores, slots), ``SpillStats`` and every row that is only moved
(demoted, promoted, read through) are bit-exact; rows the optimizer
writes within rtol 1e-5 / atol 1e-6, the Adam parity tolerance of
``tests/test_torch_training.py``. Tables hold 512 slots (dim 8) or 1,024
(dim 4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu import parallel as jpar
from recommenders_addons_tpu.native import NativeHostKVStore as JNative
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import spill as jspill
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.parallel import sharded as jsharded
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch import parallel as tpar
from recommenders_addons_tpu_torch.native import NativeHostKVStore as TNative
from recommenders_addons_tpu_torch.ops import spill as tspill

DIM, CAP = 8, 512
RTOL, ATOL = 1e-5, 1e-6
EMPTY = np.iinfo(np.int64).min


# ---------------------------------------------------------------------------
# the JAX side, jitted
# ---------------------------------------------------------------------------


def _jit_method(name, statics=()):
    """``jvar.Variable.<name>`` jitted once per Variable and static
    keywords (the Variable is kept alive by its cache entry)."""
    orig = getattr(jvar.Variable, name)
    jitted = {}

    def call(self, *args, **kw):
        st = {k: kw.pop(k) for k in statics if k in kw}
        key = (id(self), tuple(sorted(st.items())))
        if key not in jitted:
            jitted[key] = (self, jax.jit(
                lambda *a, **k: orig(self, *a, **k, **st)))
        return jitted[key][1](*args, **kw)

    return call


def _jit_apply():
    orig = jvar.Variable.apply_gradients
    jitted = {}

    def call(self, state, ctx, grads, optimizer, step=0, epoch=0,
             return_evicted=False):
        key = (id(self), id(optimizer), return_evicted)
        if key not in jitted:
            jitted[key] = (self, optimizer, jax.jit(
                lambda s, c, g, st, ep: orig(
                    self, s, c, g, optimizer, step=st, epoch=ep,
                    return_evicted=return_evicted)))
        return jitted[key][2](state, ctx, grads, step, epoch)

    return call


def _jit_victims():
    orig = jht.lowest_score_victims
    jitted = {}

    def call(spec, state, k):
        if (spec, k) not in jitted:
            jitted[(spec, k)] = jax.jit(lambda s: orig(spec, s, k))
        return jitted[(spec, k)](state)

    return call


def _jit_smap():
    """``ShardedVariable._smap`` jitted and cached by the function's code
    and closure (the JAX sharded methods build a fresh ``shard_map`` on
    every call, which eager dispatch compiles every time); a closure
    holding anything unhashable is jitted uncached."""
    orig = jsharded.ShardedVariable._smap
    cache = {}

    def call(self, fn, in_specs, out_specs):
        cells = tuple(c.cell_contents for c in (fn.__closure__ or ()))
        key = (fn.__code__, cells, repr(in_specs), repr(out_specs), id(self))
        try:
            hash(key)
        except TypeError:
            return jax.jit(orig(self, fn, in_specs, out_specs))
        if key not in cache:
            cache[key] = (self, jax.jit(orig(self, fn, in_specs, out_specs)))
        return cache[key][1]

    return call


@pytest.fixture(scope="module")
def jax_jitted():
    """The JAX Variable methods and table functions the spill tier calls,
    and the sharded table's shard_maps, jitted for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsharded.ShardedVariable, "_smap", _jit_smap())
        for name, statics in (
                ("lookup", ("return_exists", "use_init_for_missing")),
                ("import_batch", ("return_evicted",)),
                ("upsert", ("return_evicted",)), ("size", ()),
                ("embedding_lookup", ())):
            mp.setattr(jvar.Variable, name, _jit_method(name, statics))
        mp.setattr(jvar.Variable, "apply_gradients", _jit_apply())
        mp.setattr(jht, "lowest_score_victims", _jit_victims())
        mp.setattr(jht, "gather_packed", jax.jit(jht.gather_packed))
        yield


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------


def _bits(a):
    """numpy words of a row array from either package (16-bit floats as
    int16, 32-bit as int32)."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()])
        return a.numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _store_rows(store):
    """A store's export sorted by key: ``{column: words}``."""
    keys, vals, scores, slots = store.export_all()
    keys = np.asarray(keys)
    order = np.argsort(keys, kind="stable")
    out = {"keys": keys[order], "scores": np.asarray(scores)[order],
           "values": _bits(vals)[order]}
    for n, c in slots.items():
        out[f"slot.{n}"] = _bits(c)[order]
    return out


def assert_stores_equal(tstore, jstore, rows_exact=True):
    a, b = _store_rows(tstore), _store_rows(jstore)
    assert set(a) == set(b) and len(tstore) == len(jstore)
    for k in a:
        if rows_exact or k in ("keys", "scores"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(a[k].view(np.float32),
                                       b[k].view(np.float32), rtol=RTOL,
                                       atol=ATOL, err_msg=k)


def assert_planes(tst, jst, rows_exact=True, shard=None):
    """Key planes and scores bit-exact; rows [0, C) bit-exact or within
    the optimizer tolerance."""
    def j(f):
        a = np.asarray(getattr(jst, f))
        return a if shard is None else a[shard]

    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(), j(f),
                                      err_msg=f)
    n = tst.capacity * tst.chunks
    got, want = _bits(tst.rows[:n]), _bits(j("rows")[:n])
    if rows_exact:
        np.testing.assert_array_equal(got, want, err_msg="rows")
    else:
        np.testing.assert_allclose(got.view(np.float32),
                                   want.view(np.float32), rtol=RTOL,
                                   atol=ATOL)


def _stats(tier):
    s = tier.stats
    return (s.demoted, s.promoted, s.served_from_tier)


# ---------------------------------------------------------------------------
# the host stores
# ---------------------------------------------------------------------------


STORES = {
    "numpy": (lambda: tspill.HostKVStore(4, np.float32, 64),
              lambda: jspill.HostKVStore(4, np.float32, 64)),
    "native": (lambda: TNative(4, np.float32, 64),
               lambda: JNative(4, np.float32, 64)),
}


@pytest.mark.parametrize("kind", list(STORES))
def test_host_store_churn_matches_jax(kind):
    """250 random puts (with scores and a slot added midway, so the
    native store repacks), deletes and gets on keys 1..400 from 64
    slots (so both grow): every get and the final export bit-equal to
    the JAX twin's, and the exports in the same order."""
    t, j = (mk() for mk in STORES[kind])
    rng = np.random.default_rng(7)
    for it in range(250):
        op = int(rng.integers(0, 3))
        ks = rng.integers(1, 400, size=int(rng.integers(1, 48))
                          ).astype(np.int64)
        if op == 0:
            vals = rng.normal(size=(len(ks), 4)).astype(np.float32)
            sc = rng.integers(0, 1000, len(ks)).astype(np.int64)
            slots = ({"m": rng.normal(size=(len(ks), 4)).astype(np.float32)}
                     if it > 100 else None)
            for s in (t, j):
                s.put(ks, vals, sc if it % 3 else None, slots)
        elif op == 1:
            for s in (t, j):
                s.delete(ks)
        else:
            got, want = t.get(ks), j.get(ks)
            for a, b in zip(got[:2] + (got[3],), want[:2] + (want[3],)):
                np.testing.assert_array_equal(a, b)
            assert set(got[2]) == set(want[2])
            for n in got[2]:
                np.testing.assert_array_equal(got[2][n], want[2][n])
        assert len(t) == len(j)
    for a, b in zip(t.export_all()[:3], j.export_all()[:3]):
        np.testing.assert_array_equal(a, b)
    assert t.slot_names == j.slot_names == ("m",)


def test_make_host_store_picks_by_dtype(tmp_path, monkeypatch):
    """float32 tables take the native store, 16-bit and integer ones the
    numpy store (bf16 rows as int16 words); a native build that fails
    raises with the compiler's output instead of falling back."""
    assert isinstance(tspill.make_host_store(4, torch.float32), TNative)
    s = tspill.make_host_store(4, torch.bfloat16)
    assert type(s) is tspill.HostKVStore and s.value_dtype == np.int16
    assert tspill.make_host_store(4, "int32").value_dtype == np.int32
    from recommenders_addons_tpu_torch.native import build

    monkeypatch.setattr(build, "_LIB", None)
    monkeypatch.setattr(build, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed to build host_kv.cc"):
        tspill.make_host_store(4, torch.float32)


# ---------------------------------------------------------------------------
# SpillTier
# ---------------------------------------------------------------------------


def _filled_pair(name, n=400, seed=0, value_dtype="float32", opt=None,
                 jax_fill=True):
    """Both packages' Variables (dim 8, 512 slots, LRU) with ``opt``'s
    slots, filled by import_batch with the same keys, rows, slot rows and
    scores (1..49, so the coldest rows tie); ``jax_fill=False`` leaves the
    JAX table empty (None)."""
    kw = dict(name=name, dim=DIM, init_capacity=CAP,
              evict_strategy=tde.EvictStrategy.LRU)
    jv = jvar.Variable(value_dtype=value_dtype,
                       evict_strategy=jde.EvictStrategy.LRU,
                       **{k: v for k, v in kw.items()
                          if k != "evict_strategy"})
    tv = tde.Variable(value_dtype=value_dtype, device="cpu", **kw)
    topt, jopt = opt if opt is not None else (tde.Adam(0.01),
                                              jde.Adam(0.01))
    ts = tde.create_slots(tv, tv.init(), topt)
    rng = np.random.default_rng(seed)
    keys = rng.choice(1 << 40, size=n, replace=False).astype(np.int64) + 1
    vals = rng.normal(size=(n, DIM)).astype(np.float32)
    sc = rng.integers(1, 50, n).astype(np.int32)
    slots = {nm: np.abs(rng.normal(size=(n, DIM))).astype(np.float32)
             for nm in ts.slot_names}
    tdt = tv.value_dtype
    ts = tv.import_batch(ts, torch.from_numpy(keys),
                         torch.from_numpy(vals).to(tdt),
                         scores=torch.from_numpy(sc),
                         slot_rows={k: torch.from_numpy(v).to(tdt)
                                    for k, v in slots.items()})
    if not jax_fill:
        return tv, jv, ts, None, keys, (topt, jopt)
    js = jv.import_batch(jde.create_slots(jv, jv.init(), jopt),
                         jnp.asarray(keys),
                         jnp.asarray(vals).astype(jv.value_dtype),
                         scores=jnp.asarray(sc),
                         slot_rows={k: jnp.asarray(v).astype(jv.value_dtype)
                                    for k, v in slots.items()})
    assert_planes(ts, js)
    return tv, jv, ts, js, keys, (topt, jopt)


def test_spill_tier_matches_jax(jax_jitted):
    """Adam (two slot columns) on one table: demote 100, the watermark
    (0.5 / 0.3: 300 live -> a power-of-two 256 more), promote a mix of
    tier-held, resident, unknown and EMPTY ids (pow2-padded import),
    lookup_through of tier hits, HBM hits and unknown keys, then a
    tier-aware Adam step on a full table whose inserts evict and drop:
    planes, stores and stats equal at every stage."""
    tv, jv, ts, js, keys, (topt, jopt) = _filled_pair("tier")
    tt, jt = tspill.SpillTier(tv), jspill.SpillTier(jv)
    assert isinstance(tt.store, TNative)

    ts, js = tt.demote(ts, 100), jt.demote(js, 100)
    assert_planes(ts, js)
    assert_stores_equal(tt.store, jt.store)
    assert len(tt.store) == 100 and int(tv.size(ts)) == 300

    ts = tt.demote_to_watermark(ts, high=0.5, low=0.3)
    js = jt.demote_to_watermark(js, high=0.5, low=0.3)
    assert_planes(ts, js)
    assert_stores_equal(tt.store, jt.store)
    assert len(tt.store) == 356 and _stats(tt) == _stats(jt)

    tier_keys = np.sort(tt.store.export_all()[0])
    resident = keys[~np.isin(keys, tier_keys)]
    rng = np.random.default_rng(1)
    ids = np.concatenate([rng.choice(tier_keys, 70, replace=False),
                          resident[:20], [9, 10, 11, EMPTY],
                          tier_keys[:5]])  # duplicates
    ts = tt.promote(ts, torch.from_numpy(ids))
    js = jt.promote(js, jnp.asarray(ids))
    assert_planes(ts, js)
    assert_stores_equal(tt.store, jt.store)
    assert _stats(tt) == _stats(jt) and tt.stats.promoted > 0

    probe = np.concatenate([tt.store.export_all()[0][:30], resident[:30],
                            [123456789, 987654321]])
    got = tt.lookup_through(ts, torch.from_numpy(probe))
    want = jt.lookup_through(js, jnp.asarray(probe))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _stats(tt) == _stats(jt) and tt.stats.served_from_tier == 30

    # fill the table, then a batch of fresh ids whose inserts evict (and,
    # past a bucket's 64 slots, drop) into the tier
    more = rng.choice(1 << 40, 600, replace=False).astype(np.int64) + (
        1 << 41)
    ones = np.ones((600, DIM), np.float32)
    ts = tv.upsert(ts, torch.from_numpy(more), torch.from_numpy(ones),
                   step=60)
    js = jv.upsert(js, jnp.asarray(more), jnp.asarray(ones), step=60)
    ids = rng.choice(1 << 40, 256, replace=False).astype(np.int64) + (
        1 << 42)
    g = rng.normal(size=(256, DIM)).astype(np.float32)
    temb, tctx = tv.embedding_lookup(ts, torch.from_numpy(ids), step=61)
    jemb, jctx = jv.embedding_lookup(js, jnp.asarray(ids), step=61)
    ts = tt.apply_gradients(ts, tctx, torch.from_numpy(g), topt, step=61)
    js = jt.apply_gradients(js, jctx, jnp.asarray(g), jopt, step=61)
    assert_planes(ts, js, rows_exact=False)
    assert_stores_equal(tt.store, jt.store, rows_exact=False)
    assert _stats(tt) == _stats(jt)
    assert tt.total_keys(ts) == jt.total_keys(js)


def test_spill_tier_bf16_matches_jax(jax_jitted):
    """A bf16 table with Adagrad: the numpy store holds the rows as int16
    words, bit for bit the JAX store's bf16; demote, promote and
    lookup_through as the JAX package's."""
    opt = (tde.Adagrad(0.1), jde.Adagrad(0.1))
    tv, jv, ts, js, keys, _ = _filled_pair("bf", n=300, seed=2,
                                           value_dtype="bfloat16", opt=opt)
    tt, jt = tspill.SpillTier(tv), jspill.SpillTier(jv)
    assert tt.store.value_dtype == np.int16
    ts, js = tt.demote(ts, 128), jt.demote(js, 128)
    assert_planes(ts, js)
    assert_stores_equal(tt.store, jt.store)
    ids = tt.store.export_all()[0][::2]
    ts, js = tt.promote(ts, ids), jt.promote(js, jnp.asarray(ids))
    assert_planes(ts, js)
    assert_stores_equal(tt.store, jt.store)
    probe = np.concatenate([keys[:40], [5, 6]])
    got = tt.lookup_through(ts, torch.from_numpy(probe))
    want = jt.lookup_through(js, jnp.asarray(probe))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ---------------------------------------------------------------------------
# ShardedSpillTier
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jmesh(n):
    return jpar.create_mesh(num_devices=n)


def _carry_sharded(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.sharded_state_from_numpy(
        arrays, meta, ["cpu"] * arrays["key_lo"].shape[0])


def _assert_sharded(tst, jst, rows_exact=True):
    for i, st in enumerate(tst.shards):
        assert_planes(st, jst, rows_exact=rows_exact, shard=i)


def test_sharded_spill_tier_matches_jax(jax_jitted):
    """ShardedSpillTier on 4 shards of 128 slots with Adam: demote 40 a
    shard, promote, the global watermark, a tier-aware step,
    lookup_through: every shard's planes, the store and the stats equal
    the JAX package's on the conftest's CPU mesh."""
    s = 4
    kw = dict(name="shtier", dim=DIM, init_capacity=CAP, bucket_size=32,
              evict_strategy=tde.EvictStrategy.LRU)
    jsv = jsharded.ShardedVariable(
        var=jvar.Variable(**dict(kw, evict_strategy=jde.EvictStrategy.LRU)),
        mesh=_jmesh(s))
    tsv = tpar.ShardedVariable(tde.Variable(device="cpu", **kw),
                               tpar.create_mesh(devices=["cpu"] * s))
    topt, jopt = tde.Adam(0.05), jde.Adam(0.05)
    rng = np.random.default_rng(3)
    keys = rng.choice(1 << 40, 320, replace=False).astype(np.int64) + 1
    vals = rng.normal(size=(320, DIM)).astype(np.float32)
    js = jsv.create_slots(jsv.init(), jopt)
    js = jsv.upsert(js, jnp.asarray(keys), jnp.asarray(vals), step=2)
    ts = tsv.create_slots(_carry_sharded(js), topt)
    _assert_sharded(ts, js)
    tt, jt = tspill.ShardedSpillTier(tsv), jspill.ShardedSpillTier(jsv)

    ids = keys[:96]
    jemb, jctx = jsv.embedding_lookup(js, jnp.asarray(ids), step=3)
    temb, tctx = tsv.embedding_lookup(ts, torch.from_numpy(ids), step=3)
    g = rng.normal(size=(96, DIM)).astype(np.float32)
    js = jt.apply_gradients(js, jctx, jnp.asarray(g), jopt, step=3)
    ts = tt.apply_gradients(ts, tctx, torch.from_numpy(g), topt, step=3)
    _assert_sharded(ts, js, rows_exact=False)
    ts = _carry_sharded(js)  # moved rows compared bit for bit from here

    ts, js = tt.demote(ts, 40), jt.demote(js, 40)
    _assert_sharded(ts, js)
    assert_stores_equal(tt.store, jt.store)
    assert tt.store.slot_names == ("m", "v")

    back = tt.store.export_all()[0][:50]
    probe = np.concatenate([back, [77, EMPTY]])
    ts, js = tt.promote(ts, probe), jt.promote(js, jnp.asarray(probe))
    _assert_sharded(ts, js)
    assert_stores_equal(tt.store, jt.store)

    ts = tt.demote_to_watermark(ts, high=0.4, low=0.2)
    js = jt.demote_to_watermark(js, high=0.4, low=0.2)
    _assert_sharded(ts, js)
    assert_stores_equal(tt.store, jt.store)
    assert _stats(tt) == _stats(jt) and tt.stats.demoted > 160

    probe = np.concatenate([keys[::7], [31337]])
    got = tt.lookup_through(ts, torch.from_numpy(probe))
    want = jt.lookup_through(js, jnp.asarray(probe))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert _stats(tt) == _stats(jt)
    assert tt.total_keys(ts) == jt.total_keys(js) == 320


# ---------------------------------------------------------------------------
# HybridTable: the reference behaviour
# ---------------------------------------------------------------------------


def _hybrid_run(pkg, var, opt, tensor):
    """4,096 keys (a seeded permutation of 1..4096) upserted in blocks of
    512 into a 1,024-slot LRU table (watermarks 0.95 / 0.80), then 29
    steps of 256 zipf(1.2) ids: ``prepare_batch`` (promote, then the
    watermark), embedding_lookup and the tier's Adagrad apply at step
    t + 1, with unit grads. Returns the prefill's total, the batch keys
    missing from the table after promote alone and after prepare_batch
    (summed over steps), the keys in both tiers (summed over steps), the
    final total_keys and the final key planes."""
    hy = pkg.HybridTable(var)
    rng = np.random.default_rng(0)
    keys = rng.permutation(4096).astype(np.int64) + 1
    vals = rng.normal(size=(4096, 4)).astype(np.float32)
    for b in range(8):
        sl = slice(b * 512, (b + 1) * 512)
        hy.upsert(tensor(keys[sl]), tensor(vals[sl]), step=0)
    prefill = (hy.tier.total_keys(hy.state), int(var.size(hy.state)),
               len(hy.tier.store))

    def hbm(st):
        k = np.asarray(st.keys)
        return set(k[k != EMPTY].tolist())

    after_promote = after_prepare = both = 0
    for t in range(29):
        ids = keys[np.minimum(rng.zipf(1.2, size=256) - 1, 4095)]
        batch = set(ids.tolist())
        hy.state = hy.tier.promote(hy.state, ids)
        after_promote += len(batch - hbm(hy.state))
        hy.state = hy.tier.demote_to_watermark(hy.state, hy.high, hy.low)
        after_prepare += len(batch - hbm(hy.state))
        _, ctx = var.embedding_lookup(hy.state, tensor(ids), step=t + 1)
        g = tensor(np.ones((256, 4), np.float32))
        hy.state = hy.tier.apply_gradients(hy.state, ctx, g, opt,
                                           step=t + 1)
        both += len(hbm(hy.state) & set(hy.tier.store.export_all()[0]
                                        .tolist()))
    return (prefill, after_promote, after_prepare, both,
            hy.tier.total_keys(hy.state), np.asarray(hy.state.keys))


def test_hybrid_table_reference_behaviour(jax_jitted):
    """Both packages give the same counts: after the upsert-only prefill
    total_keys is exactly 4,096 (1,024 on the card, 3,072 in the tier);
    during training, batch keys are missing after promote alone (import
    could not place them) and more after prepare_batch (the watermark
    demotes rows it has just promoted, which came back with their old
    scores); the training lookup inserts those keys fresh while their
    old rows stay in the tier, so keys live in both tiers and
    total_keys ends above 4,096 with no new key used. The port keeps
    this; it does not repair it. The counts are the ones measured with
    the JAX package when the spill tier's port was planned: 5 missing
    after promote, 66 after prepare_batch, 1,068 duplicates, total_keys
    4,156."""
    kw = dict(name="hy", dim=4, init_capacity=1024)
    jv = jvar.Variable(evict_strategy=jde.EvictStrategy.LRU, **kw)
    tv = tde.Variable(evict_strategy=tde.EvictStrategy.LRU, device="cpu",
                      **kw)
    want = _hybrid_run(jde, jv, jde.Adagrad(0.1), jnp.asarray)
    got = _hybrid_run(tde, tv, tde.Adagrad(0.1), torch.from_numpy)
    assert got[:5] == want[:5]
    np.testing.assert_array_equal(got[5], want[5])
    assert got[:5] == ((4096, 1024, 3072), 5, 66, 1068, 4156)
