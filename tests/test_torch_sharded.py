"""The port's sharded tables (``parallel/``) against the JAX package's
``ShardedVariable``, on the conftest's 8-device CPU mesh (4 shards unless
named) and the port's in-process mesh of 4 CPU shards.

Integers are bit-exact: the routing (``_rank_in_owner`` at 4 and 80
shards, ``_k_per_pair``, ``_route``'s buffer, positions, routed mask and
drop count), each shard's key planes and scores, the owners' ``found``
and ``inserted``. f32 rows match within rtol 1e-5 / atol 1e-6 (the JAX
sharded test's tolerance: duplicate grads are summed in another order;
the port's dedup route sums in batch order, JAX's ``.at[].add`` in an
unspecified one). Checkpoint files are byte-identical.

The JAX side is jitted once per function; the port runs its plain
versions on the CPU. Tables hold 4,096 slots or fewer, dim 8.
"""

import dataclasses
import filecmp
import functools
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu import parallel as jpar
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.parallel import sharded as jsharded
from recommenders_addons_tpu.train import checkpoint as jckpt
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch import parallel as tpar
from recommenders_addons_tpu_torch.ops import hashing as thash
from recommenders_addons_tpu_torch.ops import initializers as tinit
from recommenders_addons_tpu_torch.train import checkpoint as tckpt

S, DIM, CAP = 4, 8, 4096
RTOL, ATOL = 1e-5, 1e-6


@functools.lru_cache(maxsize=None)
def _jmesh(n=S):
    return jpar.create_mesh(num_devices=n)


def _tmesh(n=S):
    return tpar.create_mesh(devices=["cpu"] * n)


def _pair(name, mesh_n=S, **kw):
    """Both packages' ShardedVariables over one table description."""
    kw.setdefault("dim", DIM)
    kw.setdefault("init_capacity", CAP)
    jinit_ = kw.pop("jinit", None)
    tinit_ = kw.pop("tinit", None)
    jv = jvar.Variable(name=name, initializer=jinit_, **kw)
    tv = tde.Variable(name=name, initializer=tinit_, device="cpu", **kw)
    return (jsharded.ShardedVariable(var=jv, mesh=_jmesh(mesh_n)),
            tpar.ShardedVariable(tv, _tmesh(mesh_n)))


def _carry(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.sharded_state_from_numpy(
        arrays, meta, ["cpu"] * arrays["key_lo"].shape[0])


def _assert_states(jst, tst, rows=True):
    """Per shard: key planes and scores bit-exact, rows within tolerance."""
    assert len(tst.shards) == np.asarray(jst.key_lo).shape[0]
    for i, st in enumerate(tst.shards):
        for f in ("key_lo", "key_hi", "scores"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(jst, f))[i],
                err_msg=f"shard {i} {f}")
        assert st.slot_names == jst.slot_names
        if rows:
            np.testing.assert_allclose(
                st.rows_logical.numpy(), np.asarray(jst.rows_logical)[i],
                rtol=RTOL, atol=ATOL, err_msg=f"shard {i} rows")


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def test_meshes_default_to_the_card_and_never_run_quietly_elsewhere():
    """A mesh of the default devices is of cards (it raises without one);
    a process-group mesh raises without an initialised group; a table
    over a mesh that is not a parallel mesh raises; ``devices=`` maps to
    ``num_shards`` and each shard's capacity, as in the JAX package."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.create_mesh(4)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.Mesh(["cuda"] * 2, ("ep",))
    with pytest.raises(RuntimeError, match="process group"):
        tpar.GroupMesh()
    tv = tde.Variable(name="m", dim=DIM, init_capacity=CAP, device="cpu")
    with pytest.raises(TypeError):
        tpar.ShardedVariable(tv, object())
    sv = tpar.ShardedVariable(tv, _tmesh())
    jv = jvar.Variable(name="m", dim=DIM, init_capacity=CAP,
                       devices=[0, 1, 2, 3])
    assert sv.var.num_shards == jv.num_shards == S
    assert sv.var.shard_capacity == jv.shard_capacity
    assert sv.var.total_capacity == jv.total_capacity == CAP
    assert tde.Variable(dim=DIM, init_capacity=CAP, devices=["cpu"] * 4,
                        ).spec.capacity == jv.spec.capacity
    assert [int(x) for x in thash.default_partition_fn(
        torch.arange(-5, 5), S)] == thash.shard_of_np(
        np.arange(-5, 5), S).tolist()


@pytest.mark.parametrize("s", [4, 80])
def test_rank_in_owner_and_k_per_pair_are_bit_exact(s):
    """The one-hot cumsum (4 shards) and the sort route (80 shards)."""
    rng = np.random.default_rng(s)
    keys = rng.integers(-2**62, 2**62, size=777, dtype=np.int64)
    keys[::9] = thash.EMPTY_KEY
    owner = thash.shard_of_np(keys, s)
    valid = keys != thash.EMPTY_KEY
    fake_j = types.SimpleNamespace(num_shards=s, capacity_factor=2.0)
    fake_t = types.SimpleNamespace(num_shards=s, capacity_factor=2.0)
    want = jax.jit(lambda o, v: jsharded.ShardedVariable._rank_in_owner(
        fake_j, o, v))(jnp.asarray(owner), jnp.asarray(valid))
    got = tpar.ShardedVariable._rank_in_owner(
        fake_t, torch.from_numpy(owner), torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for u in (0, 1, 7, 8, 100, 777, 4096):
        for wc in (False, True):
            assert (tpar.ShardedVariable._k_per_pair(fake_t, u, wc)
                    == jsharded.ShardedVariable._k_per_pair(fake_j, u, wc))


def test_route_is_bit_exact():
    """``_route`` at K = 8 (an owner overflows) and 32; ``shard_of_np``
    against the JAX package's for int64 and int32 keys."""
    from recommenders_addons_tpu.ops import hashing as jhash

    jsv, tsv = _pair("route")
    rng = np.random.default_rng(1)
    wide = rng.integers(-2**63, 2**63 - 1, size=5000, dtype=np.int64)
    for k in (wide, wide.astype(np.int32)):
        for s in (3, 4, 80):
            np.testing.assert_array_equal(thash.shard_of_np(k, s),
                                          jhash.shard_of_np(k, s))
    keys = rng.integers(1, 1 << 40, size=64, dtype=np.int64)
    keys[:20] = keys[0]  # one owner overflows a K = 8 buffer
    keys[-3:] = thash.EMPTY_KEY
    for k in (8, 32):
        want = jax.jit(lambda x, k=k: jsv._route(x, k))(jnp.asarray(keys))
        got = tsv._route(torch.from_numpy(keys), k)
        for name, g, w in zip(("buf2", "send_pos", "routed", "num_dropped"),
                              got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
    assert int(got[3]) == 0 and int(want[3]) == 0
    assert int(tsv._route(torch.from_numpy(keys), 8)[3]) > 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _jstep(jsv, opt, scored):
    def step(st, ids, g, t):
        emb, ctx = jsv.embedding_lookup(st, ids, step=t if scored else None)
        return emb, ctx, jsv.apply_gradients(st, ctx, g, opt, step=t)
    return jax.jit(step)


def _train_both(name, batches, scored=True, **kw):
    """Lookup + apply steps on both packages (Adagrad; the same step at
    lookup and apply, so the JAX XLA path and the port's fused path stamp
    the same scores). Yields per step both contexts and states."""
    jsv, tsv = _pair(name, jinit=jax.nn.initializers.uniform(0.05),
                     tinit=tinit.uniform(0.05), **kw)
    jo, to = jde.Adagrad(0.1), tde.Adagrad(0.1)
    jst = jsv.create_slots(jsv.init(), jo)
    tst = tsv.create_slots(tsv.init(), to)
    jstep = _jstep(jsv, jo, scored)
    rng = np.random.default_rng(7)
    for t, ids in enumerate(batches):
        g = rng.normal(size=(len(ids), DIM)).astype(np.float32)
        jemb, jctx, jst = jstep(jst, jnp.asarray(ids), jnp.asarray(g),
                                jnp.int32(t))
        temb, tctx = tsv.embedding_lookup(tst, torch.from_numpy(ids),
                                          step=t if scored else None)
        tst = tsv.apply_gradients(tst, tctx, torch.from_numpy(g), to, step=t)
        yield (jsv, jemb, jctx, jst), (tsv, temb, tctx, tst)


def _assert_ctx(jctx, tctx):
    for name in ("send_pos", "routed", "num_dropped"):
        np.testing.assert_array_equal(
            torch.stack(getattr(tctx, name)).numpy(),
            np.asarray(getattr(jctx, name)), err_msg=name)
    assert tctx.deduped == bool(np.asarray(jctx.deduped).any())
    for name in ("unique_keys", "slot", "found", "inserted", "dropped",
                 "inverse", "key_lo", "key_hi"):
        np.testing.assert_array_equal(
            torch.stack([getattr(o, name) for o in tctx.octx]).numpy(),
            np.asarray(getattr(jctx.octx, name)), err_msg=name)


def test_three_training_steps_match_jax():
    """Batches of 96 (24 a block, K = 16) with duplicates within and
    across blocks, misses, then hits; the third refills a fresh key
    range."""
    rng = np.random.default_rng(0)
    batches = [rng.integers(1, 60, size=96).astype(np.int64),
               rng.integers(1, 60, size=96).astype(np.int64),
               rng.integers(1, 2000, size=96).astype(np.int64)]
    for (jsv, jemb, jctx, jst), (tsv, temb, tctx, tst) in _train_both(
            "train3", batches):
        _assert_ctx(jctx, tctx)
        np.testing.assert_allclose(temb.numpy(), np.asarray(jemb),
                                   rtol=RTOL, atol=ATOL)
        _assert_states(jst, tst)
    assert int(tsv.size(tst)) == int(jsv.size(jst))


def test_hot_key_batch_takes_the_dedup_route_in_both():
    """The JAX test's batch: block 0 is one key 16 times (> K = 8), so the
    per-occurrence route overflows and both packages retry through the
    batch-side dedup; nothing drops. Rows also agree with one unsharded
    port table."""
    ids = np.concatenate([np.full(16, 7, np.int64),
                          np.arange(100, 148, dtype=np.int64)])
    last = None
    for (jsv, jemb, jctx, jst), (tsv, temb, tctx, tst) in _train_both(
            "hot", [ids] * 3, scored=False):
        assert tctx.deduped and bool(np.asarray(jctx.deduped).any())
        assert sum(int(x) for x in tctx.num_dropped) == 0
        _assert_ctx(jctx, tctx)
        _assert_states(jst, tst)
        last = tsv, tst
    tsv, tst = last
    single = tde.Variable(name="hot", dim=DIM, init_capacity=CAP,
                          initializer=tinit.uniform(0.05), device="cpu")
    opt = tde.Adagrad(0.1)
    sst = tde.create_slots(single, single.init(), opt)
    rng = np.random.default_rng(7)
    for t in range(3):
        g = rng.normal(size=(len(ids), DIM)).astype(np.float32)
        _, ctx = single.embedding_lookup(sst, torch.from_numpy(ids))
        sst = single.apply_gradients(sst, ctx, torch.from_numpy(g), opt,
                                     step=t)
    probe = torch.from_numpy(np.unique(ids))
    torch.testing.assert_close(tsv.lookup(tst, probe),
                               single.lookup(sst, probe), rtol=RTOL,
                               atol=ATOL)


def test_train_step_matches_the_two_call_api():
    """``train_step`` (lookup, grad, apply in one call) leaves every shard
    bit-equal to ``embedding_lookup`` + ``apply_gradients``; a batch that
    would need padding raises."""
    ids = torch.from_numpy(np.random.default_rng(7).integers(
        1, 4000, size=64, dtype=np.int64))

    def build():
        tv = tde.Variable(name="fused_ts", dim=DIM, init_capacity=1 << 10,
                          initializer=tinit.normal(0.05), device="cpu")
        sv = tpar.ShardedVariable(tv, _tmesh())
        opt = tde.Adam(0.01)
        return sv, opt, sv.create_slots(sv.init(), opt)

    sv1, o1, st1 = build()
    sv2, o2, st2 = build()
    emb, ctx = sv1.embedding_lookup(st1, ids, step=5)
    st1 = sv1.apply_gradients(st1, ctx, emb * 0.1 + 0.01, o1, step=5)
    st2, aux = sv2.train_step(st2, ids, lambda e: (e * 0.1 + 0.01, ()), o2,
                              step=5)
    assert aux == [()] * S
    for a, b in zip(st1.shards, st2.shards):
        for f in ("key_lo", "key_hi", "scores", "rows"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="mesh-divisible"):
        sv2.train_step(st2, ids[:63], lambda e: (e, ()), o2)


def test_inference_lookup_with_an_overflowing_block_matches_jax():
    """Every key of one block belongs to shard 0: the capacity_factor
    exchange overflows, and the worst-case retry must make the lookup
    exact. Odd batch length: the padding is sliced off."""
    jsv, tsv = _pair("infer", jinit=0.5, tinit=0.5)
    rng = np.random.default_rng(3)
    pool = rng.integers(1, 1 << 40, size=4000, dtype=np.int64)
    mid = pool[1000:2500]
    own0 = mid[thash.shard_of_np(mid, S) == 0][:40]
    stored = np.concatenate([own0[:30], pool[:50]])
    vals = rng.normal(size=(len(stored), DIM)).astype(np.float32)
    jst = jax.jit(lambda st, k, v: jsv.upsert(st, k, v, step=1))(
        jsv.init(), jnp.asarray(stored), jnp.asarray(vals))
    tst = tsv.upsert(tsv.init(), torch.from_numpy(stored),
                     torch.from_numpy(vals), step=1)
    _assert_states(jst, tst)
    ids = np.concatenate([own0[:24], pool[:40], pool[3000:3013]])
    want = jax.jit(jsv.lookup)(jst, jnp.asarray(ids))
    syncs = tsv.stats["host_syncs"]
    got = tsv.lookup(tst, torch.from_numpy(ids))
    assert tsv.stats["host_syncs"] == syncs + 1
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[:24], vals[:24])
    np.testing.assert_array_equal(got.numpy()[-13:], 0.5)
    np.testing.assert_array_equal(
        tsv.contains(tst, torch.from_numpy(ids)).numpy(),
        np.asarray(jax.jit(jsv.contains)(jst, jnp.asarray(ids))))


# ---------------------------------------------------------------------------
# layouts and the table-wide ops
# ---------------------------------------------------------------------------


def test_two_axis_mesh_matches_the_one_axis_mesh(tmp_path):
    """``axis=("dp", "ep")`` on a 2 x 4 mesh shards over the flattened
    product (8 shards) and trains bit-equal to the 8-shard 1-D mesh; a
    checkpoint of one restores into the other by the direct path."""
    tv = tde.Variable(name="axis2", dim=4, init_capacity=1 << 12,
                      device="cpu")
    opt = tde.Adam(0.1)
    keys = torch.arange(1, 129)

    def run(mesh, axis):
        sv = tpar.ShardedVariable(tv, mesh, axis=axis)
        st = sv.create_slots(sv.init(), opt)
        for i in range(2):
            emb, ctx = sv.embedding_lookup(st, keys)
            st = sv.apply_gradients(st, ctx, torch.ones_like(emb) * 0.1,
                                    opt, step=i)
        assert int(sv.size(st)) == 128
        return sv, st

    sv1, st1 = run(tpar.Mesh(["cpu"] * 8, ("ep",)), "ep")
    sv2, st2 = run(tpar.Mesh(np.array(["cpu"] * 8, object).reshape(2, 4),
                             ("dp", "ep")), ("dp", "ep"))
    assert sv2.num_shards == 8 and sv2.spec == sv1.spec
    for a, b in zip(st1.shards, st2.shards):
        for f in ("key_lo", "key_hi", "scores", "rows"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="replicate"):
        tpar.ShardedVariable(tv, sv2.mesh, axis="ep")
    tckpt.save_dynamic_embedding(sv2, st2, str(tmp_path))
    back = tckpt.load_dynamic_embedding(
        sv1, sv1.create_slots(sv1.init(), opt), str(tmp_path))
    assert tckpt.LAST_RESTORE_USED_DIRECT
    torch.testing.assert_close(sv1.lookup(back, keys), sv2.lookup(st2, keys),
                               rtol=0, atol=0)


def test_table_wide_ops_match_jax():
    """upsert (duplicates: the last wins), accum (bp_v2 deltas, with and
    without the exists guard), import_batch (scores and Adagrad slot
    rows), apply_restriction, export, remove and clear, each against the
    JAX package's, shard by shard."""
    jsv, tsv = _pair("ops", init_capacity=1 << 10, bp_v2=True)
    rng = np.random.default_rng(5)
    keys = rng.integers(1, 1 << 40, size=300, dtype=np.int64)
    keys[280:] = keys[:20]
    vals = rng.normal(size=(300, DIM)).astype(np.float32)
    jst = jax.jit(lambda s, k, v: jsv.upsert(s, k, v, step=1))(
        jsv.init(), jnp.asarray(keys), jnp.asarray(vals))
    tst = tsv.upsert(tsv.init(), torch.from_numpy(keys),
                     torch.from_numpy(vals), step=1)
    _assert_states(jst, tst)

    mixed = np.concatenate([keys[100:200], rng.integers(
        1 << 41, 1 << 42, size=60, dtype=np.int64), keys[100:110]])
    old = rng.normal(size=(170, DIM)).astype(np.float32)
    new = rng.normal(size=(170, DIM)).astype(np.float32)
    ex = rng.random(170) < 0.7
    for exists in (None, ex):
        jfn = jax.jit(lambda s, k, o, n, e: jsv.accum(s, k, o, n, exists=e,
                                                      step=2))
        jst = jfn(jst, jnp.asarray(mixed), jnp.asarray(old), jnp.asarray(new),
                  None if exists is None else jnp.asarray(exists))
        tst = tsv.accum(tst, torch.from_numpy(mixed), torch.from_numpy(old),
                        torch.from_numpy(new),
                        exists=None if exists is None
                        else torch.from_numpy(exists), step=2)
        _assert_states(jst, tst)

    jo, to = jde.Adagrad(0.1), tde.Adagrad(0.1)
    jst, tst = jsv.create_slots(jst, jo), tsv.create_slots(tst, to)
    imp = np.concatenate([keys[:50], rng.integers(
        1 << 43, 1 << 44, size=90, dtype=np.int64)])
    ivals = rng.normal(size=(140, DIM)).astype(np.float32)
    iacc = rng.random((140, DIM)).astype(np.float32)
    isc = rng.integers(1, 100, size=140).astype(np.int32)
    jst = jax.jit(lambda s, k, v, sc, a: jsv.import_batch(
        s, k, v, scores=sc, slot_rows={"accumulator": a}))(
        jst, jnp.asarray(imp), jnp.asarray(ivals), jnp.asarray(isc),
        jnp.asarray(iacc))
    tst = tsv.import_batch(tst, torch.from_numpy(imp),
                           torch.from_numpy(ivals),
                           scores=torch.from_numpy(isc),
                           slot_rows={"accumulator": torch.from_numpy(iacc)})
    _assert_states(jst, tst)

    jst = jax.jit(lambda s: jsv.apply_restriction(s, 200, trigger=240))(jst)
    tst = tsv.apply_restriction(tst, 200, trigger=240)
    _assert_states(jst, tst)
    (k, v, m), (jk, jv, jm) = tsv.export(tst), jax.jit(jsv.export)(jst)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=RTOL,
                               atol=ATOL)
    for got, want in zip(tsv.export_keys_and_scores(tst),
                         jax.jit(jsv.export_keys_and_scores)(jst)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    jst = jax.jit(jsv.remove)(jst, jnp.asarray(keys[:120]))
    tst = tsv.remove(tst, torch.from_numpy(keys[:120]))
    _assert_states(jst, tst)
    assert int(tsv.size(tst)) == int(jsv.size(jst)) > 0
    tst = tsv.clear(tst)
    assert int(tsv.size(tst)) == 0


def test_layers_and_sparse_lookups_on_a_mesh():
    """``AllToAllEmbedding`` and the three sparse lookups with
    ``sharded=`` train like their one-table counterparts: an id seen
    twice gets twice the gradient, and the combined outputs and trained
    rows agree within the tolerance."""
    mesh = _tmesh()
    layer = tde.keras.layers.AllToAllEmbedding(
        8, mesh=mesh, name="kl_a2a", init_capacity=1 << 10,
        initializer=0.1, device="cpu")
    assert isinstance(layer.params, tpar.ShardedVariable)
    state = layer.init_state()
    ids = torch.tensor([[1, 2], [3, 1]])
    emb, ctx = layer(state, ids, training=True)
    torch.testing.assert_close(emb, torch.full_like(emb, 0.1))
    state = layer.apply_gradients(state, ctx, torch.ones_like(emb),
                                  tde.SGD(0.1), step=0)
    out = layer(state, ids, training=False)
    torch.testing.assert_close(out[0, 0], torch.full((8,), -0.1))
    torch.testing.assert_close(out[0, 1], torch.zeros(8), atol=1e-7, rtol=0)

    tv = tde.Variable(name="sp", dim=DIM, init_capacity=1 << 10,
                      initializer=tinit.uniform(0.05), device="cpu")
    sv = tpar.ShardedVariable(tv, mesh)
    rng = np.random.default_rng(2)
    dense_ids = rng.integers(1, 300, size=(32, 5)).astype(np.int64)
    dense_ids[::4, 3:] = tv.empty_key
    dense_ids[5, 0] = -7
    opt = tde.Adagrad(0.1)
    ragged = tde.RaggedIds(torch.from_numpy(dense_ids[:8].reshape(-1)),
                           torch.arange(0, 41, 5, dtype=torch.int32))
    single_state = tde.create_slots(tv, tv.init(), opt)
    sharded_state = sv.create_slots(sv.init(), opt)
    for fn, kw in ((tde.embedding_lookup_sparse, {"combiner": "mean"}),
                   (tde.safe_embedding_lookup_sparse,
                    {"combiner": "sqrtn", "default_id": 3})):
        a, actx = fn(tv, single_state, torch.from_numpy(dense_ids), **kw)
        b, bctx = fn(tv, sharded_state, torch.from_numpy(dense_ids),
                     sharded=sv, **kw)
        torch.testing.assert_close(b, a, rtol=RTOL, atol=ATOL)
        g = torch.from_numpy(rng.normal(size=tuple(a.shape)).astype(
            np.float32))
        single_state = tde.apply_sparse_gradients(tv, single_state, actx, g,
                                                  opt, step=1)
        sharded_state = tde.apply_sparse_gradients(sv, sharded_state, bctx,
                                                   g, opt, step=1)
        probe = torch.arange(1, 300)
        torch.testing.assert_close(sv.lookup(sharded_state, probe),
                                   tv.lookup(single_state, probe),
                                   rtol=RTOL, atol=ATOL)
    a = tde.embedding_lookup_ragged(tv, single_state, ragged,
                                    training=False)
    b = tde.embedding_lookup_ragged(tv, sharded_state, ragged,
                                    training=False, sharded=sv)
    torch.testing.assert_close(b.values, a.values, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["dlrm", "dcn"])
def test_sharded_models_train_like_jax(family, monkeypatch):
    """The narrow DLRM and DCN with ``mesh=`` (4 shards), 3 steps of 32
    from the JAX package's initial weights (carried by convert.py): losses
    and dense weights within rtol 1e-4 / atol 1e-5 (matrix products sum
    in another order), each shard's key planes and scores bit-exact, rows
    within the same tolerance, predictions too. DLRM stamps ``step + 1``
    at lookup on every owner, so its JAX side runs the fused Pallas apply
    in the interpreter, the path the port always takes; DCN's sharded
    step stamps no step at lookup, as in the JAX package."""
    from recommenders_addons_tpu.models import dcn as jdcn
    from recommenders_addons_tpu.models import dlrm as jdlrm
    from recommenders_addons_tpu.ops import pallas_ops
    from recommenders_addons_tpu_torch.models import dcn as tdcn
    from recommenders_addons_tpu_torch.models import dlrm as tdlrm

    if family == "dlrm":
        monkeypatch.setenv("TFRA_TPU_PALLAS_INTERPRET", "1")
        monkeypatch.setattr(pallas_ops, "_TILE", 128)
        monkeypatch.setattr(pallas_ops, "_SUB", 128)
        jlib, tlib = jdlrm.DLRM, tdlrm.DLRM
        cfg = dict(num_sparse=4, dim=8, bottom_sizes=(16, 8),
                   top_sizes=(16, 1), table_capacity=1024)
        jcfg, tcfg = jdlrm.DLRMConfig(**cfg), tdlrm.DLRMConfig(**cfg)
        from_np, to_np = (convert.dlrm_dense_from_numpy,
                          convert.dlrm_dense_to_numpy)
        state_cls = tdlrm.DLRMState
    else:
        jlib, tlib = jdcn.DCN, tdcn.DCN
        cfg = dict(num_sparse=4, dim=8, num_cross=2, deep_sizes=(16, 8),
                   table_capacity=1024)
        jcfg, tcfg = jdcn.DCNConfig(**cfg), tdcn.DCNConfig(**cfg)
        from_np, to_np = (convert.dcn_dense_from_numpy,
                          convert.dcn_dense_to_numpy)
        state_cls = tdcn.DCNState
    rng = np.random.default_rng(0)
    batches = [jdlrm.synthetic_criteo_batch(rng, 32, num_sparse=4,
                                            vocab_per_feature=300)
               for _ in range(3)]
    jm = jlib(jcfg, mesh=_jmesh())
    jst = jm.init(jax.random.PRNGKey(0))
    dense0 = jax.device_get(jst.dense)
    jst = dataclasses.replace(jst, table=jm.params.create_slots(jst.table,
                                                                jm.opt))
    jstep, jtx = jm.make_train_step()
    jopt = jtx.init(jst.dense)
    jstep = jax.jit(jstep)

    tm = tlib(tcfg, mesh=_tmesh(), device="cpu")
    assert isinstance(tm.params, tpar.ShardedVariable)
    tst = state_cls(table=tde.create_slots(tm.var, tm.params.init(), tm.opt),
                    dense=from_np(dense0, tm.cfg, device="cpu"), step=0)
    tstep, ttx = tm.make_train_step()
    topt = ttx.init(list(tst.dense.parameters()))
    for b in batches:
        jst, jopt, jloss = jstep(jst, jopt, {k: jnp.asarray(v)
                                             for k, v in b.items()})
        tst, topt, tloss = tstep(tst, topt, {k: torch.from_numpy(v)
                                             for k, v in b.items()})
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4,
                                   atol=1e-5)
    got, want = to_np(tst.dense), jax.device_get(jst.dense)
    for name in got:
        for g, w in zip(got[name], want[name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5)
    for i, st in enumerate(tst.table.shards):
        for f in ("key_lo", "key_hi", "scores"):
            np.testing.assert_array_equal(
                getattr(st, f).numpy(), np.asarray(getattr(jst.table, f))[i],
                err_msg=f"shard {i} {f}")
        np.testing.assert_allclose(
            st.rows_logical.numpy(), np.asarray(jst.table.rows_logical)[i],
            rtol=1e-4, atol=1e-5)
    assert int(tm.params.size(tst.table)) == int(jm.params.size(jst.table))
    b = batches[0]
    np.testing.assert_allclose(
        tm.predict(tst, {k: torch.from_numpy(v) for k, v in b.items()}
                   ).numpy(),
        np.asarray(jax.jit(jm.predict)(jst, {k: jnp.asarray(v)
                                            for k, v in b.items()})),
        rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("family", ["movielens_multi_hot", "retrieval",
                                    "seq_and_dense"])
def test_other_families_train_alike_on_a_mesh(family):
    """Each other ``mesh=`` family's ``run_demo`` (3 steps of 64; the
    multi-hot genres through ``safe_embedding_lookup_sparse(sharded=)``)
    on 4 CPU shards gives the one-table run's loss and metric within
    rtol 1e-5."""
    from recommenders_addons_tpu_torch.models import movielens, retrieval
    from recommenders_addons_tpu_torch.models import seq_and_dense

    demo, kw = {
        "movielens_multi_hot": (movielens.run_demo, {"multi_hot": True}),
        "retrieval": (retrieval.run_demo, {}),
        "seq_and_dense": (seq_and_dense.run_demo, {}),
    }[family]
    one = demo(steps=3, batch_size=64, log_every=0, device="cpu", **kw)
    sharded = demo(steps=3, batch_size=64, log_every=0, device="cpu",
                   mesh=_tmesh(), **kw)
    np.testing.assert_allclose(sharded, one, rtol=RTOL)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_sharded_checkpoints_are_the_jax_packages(tmp_path):
    """A 4-shard table with Adagrad slots: the port's shard files
    (``_mht_<i>of4``) are byte-identical to the JAX package's for the same
    state; each package restores the other's by the direct per-shard
    path into the same per-shard planes and rows; the port restores them
    into one table and into 2 shards (re-partitioned on the host) with
    every key's row, slot and score."""
    jsv, tsv = _pair("ck", init_capacity=1 << 10)
    rng = np.random.default_rng(9)
    keys = np.unique(rng.integers(1, 1 << 50, size=400, dtype=np.int64))
    vals = rng.normal(size=(len(keys), DIM)).astype(np.float32)
    acc = rng.random((len(keys), DIM)).astype(np.float32)
    sc = rng.integers(1, 50, size=len(keys)).astype(np.int32)
    jst = jsv.create_slots(jsv.init(), jde.Adagrad(0.1))
    jst = jax.jit(lambda s: jsv.import_batch(
        s, jnp.asarray(keys), jnp.asarray(vals), scores=jnp.asarray(sc),
        slot_rows={"accumulator": jnp.asarray(acc)}))(jst)
    tst = _carry(jst)
    arrays, meta = convert.sharded_state_to_numpy(tst)
    for f in convert.ARRAY_FIELDS:  # the carry's round trip
        np.testing.assert_array_equal(arrays[f], np.asarray(getattr(jst, f)))
    assert meta["slot_names"] == jst.slot_names
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jckpt.save_dynamic_embedding(jsv, jst, str(jdir), global_step=3)
    tckpt.save_dynamic_embedding(tsv, tst, str(tdir), global_step=3)
    sub = os.path.join(tckpt.DE_DIR_NAME + "-3", "ck")
    names = sorted(os.listdir(jdir / sub))
    assert names == sorted(os.listdir(tdir / sub))
    shard_files = [n for n in names if "_mht_" in n]
    assert len(shard_files) == 4 * 4  # keys, values, scores, accumulator
    assert all(f"of4_rank0_size1" in n for n in shard_files)
    match, mismatch, errors = filecmp.cmpfiles(jdir / sub, tdir / sub,
                                               names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)

    t_from_j = tckpt.load_dynamic_embedding(tsv, tsv.init(), str(jdir),
                                            global_step=3)
    assert tckpt.LAST_RESTORE_USED_DIRECT
    jfn = jax.jit(lambda s: jckpt.load_dynamic_embedding(
        jsv, s, str(tdir), global_step=3))
    j_from_t = jfn(jsv.init())
    _assert_states(j_from_t, t_from_j)
    probe = torch.from_numpy(keys)
    want = np.asarray(jax.jit(jsv.lookup)(jst, jnp.asarray(keys)))
    np.testing.assert_array_equal(tsv.lookup(t_from_j, probe).numpy(), want)

    one = tde.Variable(name="ck", dim=DIM, init_capacity=1 << 12,
                       device="cpu")
    st1 = tckpt.load_dynamic_embedding(one, one.init(), str(tdir),
                                       global_step=3, buffer_size=64)
    rows, found = one.lookup(st1, probe, return_exists=True)
    assert bool(found.all())
    np.testing.assert_array_equal(rows.numpy(), vals)
    two = tpar.ShardedVariable(tde.Variable(name="ck", dim=DIM,
                                            init_capacity=1 << 11,
                                            device="cpu"), _tmesh(2))
    st2 = tckpt.load_dynamic_embedding(two, two.init(), str(tdir),
                                       global_step=3, buffer_size=64)
    assert not tckpt.LAST_RESTORE_USED_DIRECT
    assert int(two.size(st2)) == len(keys)
    np.testing.assert_array_equal(two.lookup(st2, probe).numpy(), vals)
    k, s, m = (x.numpy() for x in two.export_keys_and_scores(st2))
    order = np.argsort(k[m])
    np.testing.assert_array_equal(k[m][order], keys)
    np.testing.assert_array_equal(s[m][order], sc)
    accs = torch.stack([st.slots["accumulator"] for st in st2.shards])
    np.testing.assert_array_equal(accs.numpy()[m][order], acc)
