"""The port's optax-style sparse optimizer against the JAX package's.

``tde.OptaxSparseOptimizer`` over the port's ``transforms`` (plain
PyTorch) against ``jde.OptaxSparseOptimizer`` over optax itself, on the
same inputs: the slot layout (names, fills, leaf shapes and dtypes), three
lookup + apply steps on hit, duplicate and evicting batches (key planes,
scores and the per-row step counts bit-exact; rows and moments within
rtol 1e-5 / atol 1e-6: optax's float32 ``pow`` and divisions run under
XLA there), a bf16 table's count column with its rounding, a 4-shard
table, and checkpoints of the adapter's slots read across packages. The
JAX side is jitted; the port runs its plain versions on the CPU. Tables
of 256-1,024 slots, dim 8.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu import parallel as jpar
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.parallel import sharded as jsharded
from recommenders_addons_tpu.train import checkpoint as jckpt
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch import parallel as tpar
from recommenders_addons_tpu_torch import transforms
from recommenders_addons_tpu_torch.ops import initializers as tinit
from recommenders_addons_tpu_torch.ops import optimizer as topt
from recommenders_addons_tpu_torch.train import checkpoint as tckpt

DIM = 8
CAP = 256
RTOL, ATOL = 1e-5, 1e-6

# (optax transform, the port's transform) built alike
TXS = {
    "adam": (lambda: optax.adam(0.05), lambda: transforms.adam(0.05)),
    "adagrad": (lambda: optax.adagrad(0.1), lambda: transforms.adagrad(0.1)),
    "sgd_momentum": (lambda: optax.sgd(0.1, momentum=0.9),
                     lambda: transforms.sgd(0.1, momentum=0.9)),
    "chain_adam": (
        lambda: optax.chain(optax.scale_by_adam(), optax.scale(-0.02)),
        lambda: transforms.chain(transforms.scale_by_adam(),
                                 transforms.scale(-0.02))),
}


def _opts(name):
    jtx, ttx = TXS[name]
    return (jde.DynamicEmbeddingOptimizer(jtx()),
            tde.DynamicEmbeddingOptimizer(ttx()))


def _carry(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.table_state_from_numpy(arrays, meta, device="cpu")


def _to_jax(tst):
    arrays, meta = convert.table_state_to_numpy(tst)
    return jht.TableState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          **meta)


def _words(a):
    """The 16- or 32-bit words of either package's array."""
    if isinstance(a, torch.Tensor):
        a = a.view({2: torch.int16, 4: torch.int32}[a.element_size()])
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _count_slots(opt):
    """The slot names holding scalar leaves (per-row step counts)."""
    return {n for n, s in zip(opt._names, opt._leaf_shapes) if s == ()}


def _assert_tables(tst, jst, counts, rows=True):
    """Key planes and scores bit-exact; count columns bit-exact; value
    and moment columns within tolerance (rows [0, capacity))."""
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f)
    assert sorted(tst.slot_names) == sorted(jst.slots)
    for name in counts:
        np.testing.assert_array_equal(_words(tst.slots[name]),
                                      _words(jst.slots[name]),
                                      err_msg=name)
    if rows:
        np.testing.assert_allclose(tst.values.numpy(),
                                   np.asarray(jst.values), rtol=RTOL,
                                   atol=ATOL, err_msg="values")
        for name in set(tst.slot_names) - set(counts):
            np.testing.assert_allclose(tst.slots[name].numpy(),
                                       np.asarray(jst.slots[name]),
                                       rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("name", list(TXS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slot_layout_matches_jax(name, dtype):
    """Slot names, fills, leaf shapes and leaf dtypes (in order)."""
    jtx, ttx = TXS[name]
    jo = jde.OptaxSparseOptimizer(jtx(), DIM, getattr(jnp, dtype))
    to = tde.OptaxSparseOptimizer(ttx(), DIM, getattr(torch, dtype))
    assert to.slot_specs() == jo.slot_specs()
    assert list(to.slot_specs()) == list(jo.slot_specs())
    assert to._leaf_shapes == [tuple(s) for s in jo._leaf_shapes]
    assert [str(d).replace("torch.", "") for d in to._leaf_dtypes] == [
        np.dtype(d).name for d in jo._leaf_dtypes]
    # the port's flatten orders the state's leaves as jax.tree_util does
    jl = jax.tree_util.tree_leaves(jtx().init(jnp.zeros((DIM,))))
    tl = transforms.tree_leaves(ttx().init(torch.zeros(DIM,
                                                       dtype=torch.float64)))
    assert [np.asarray(x).shape for x in jl] == [tuple(x.shape) for x in tl]
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(x, np.float64).reshape(-1) for x in jl]),
        torch.cat([x.to(torch.float64).reshape(-1) for x in tl]).numpy())
    # sgd without momentum has no slot; a named optimizer passes through
    assert tde.OptaxSparseOptimizer(transforms.sgd(0.1), DIM
                                    ).slot_specs() == {}
    assert isinstance(tde.DynamicEmbeddingOptimizer("adam"), tde.Adam)


def test_tree_flatten_orders_like_jax():
    """NamedTuple fields in order, dict keys sorted, lists and tuples in
    order; unflatten inverts it."""
    tree = {"b": (transforms.TraceState(trace=torch.tensor(1.0)),
                  transforms.EmptyState()),
            "a": [torch.tensor(2.0), {"z": torch.tensor(3.0),
                                      "y": torch.tensor(4.0)}]}
    jtree = {"b": (optax.TraceState(trace=jnp.asarray(1.0)),
                   optax.EmptyState()),
             "a": [jnp.asarray(2.0), {"z": jnp.asarray(3.0),
                                      "y": jnp.asarray(4.0)}]}
    leaves, treedef = transforms.tree_flatten(tree)
    assert [float(x) for x in leaves] == [
        float(x) for x in jax.tree_util.tree_leaves(jtree)]
    back = transforms.tree_unflatten(treedef, leaves)
    assert isinstance(back["b"][0], transforms.TraceState)
    assert back["b"][1] == transforms.EmptyState()
    assert isinstance(back["a"], list) and float(back["a"][1]["y"]) == 4.0


def _batches():
    """Hits after a fill, duplicates among hits, then fresh ids that
    overflow the 256-slot table's buckets (evictions)."""
    rng = np.random.default_rng(3)
    first = rng.choice(np.arange(1, 400), size=160, replace=False)
    return [first.astype(np.int64),
            rng.choice(first, size=200).astype(np.int64),
            rng.integers(1000, 1400, size=200).astype(np.int64)]


def _train_pair(name, value_dtype="float32", batches=None, cap=CAP):
    """Both packages' tables trained by the same steps; yields each
    step's states."""
    jo, to = _opts(name)
    kw = dict(name="ox", dim=DIM, init_capacity=cap,
              value_dtype=value_dtype)
    jv = jvar.Variable(initializer=jax.nn.initializers.uniform(0.05), **kw)
    tv = tde.Variable(initializer=tinit.uniform(0.05), device="cpu", **kw)

    @jax.jit
    def jstep(st, keys, g, step):
        _, ctx = jv.embedding_lookup(st, keys, step=step)
        return jv.apply_gradients(st, ctx, g, jo, step=step)

    jst, tst = jv.init(), tv.init()
    rng = np.random.default_rng(11)
    for step, keys in enumerate(batches or _batches()):
        g = rng.normal(size=(len(keys), DIM)).astype(np.float32)
        jst = jstep(jst, jnp.asarray(keys), jnp.asarray(g), step)
        _, ctx = tv.embedding_lookup(tst, torch.from_numpy(keys), step=step)
        tst = tv.apply_gradients(tst, ctx, torch.from_numpy(g), to,
                                 step=step)
        yield tv, to.resolve(DIM, getattr(torch, value_dtype)), tst, jst


@pytest.mark.parametrize("name", list(TXS))
def test_three_steps_match_jax(name):
    """Hit, duplicate and evicting batches: per step, planes and counts
    bit-exact, rows and moments within tolerance."""
    for tv, opt, tst, jst in _train_pair(name):
        _assert_tables(tst, jst, _count_slots(opt))
    # 160 + up to 200 distinct keys met a 256-slot table
    assert int(tv.size(tst)) <= CAP < 160 + len(np.unique(_batches()[2]))
    counts = _count_slots(opt)
    if name in ("adam", "chain_adam"):
        assert counts == {"optax_0"}
        # a key seen in all three batches has run 2 or 3 updates
        assert set(np.unique(tst.slots["optax_0"].numpy())) <= {0, 1, 2, 3}


def test_bf16_count_column_rounds_as_jax():
    """A bf16 table stores Adam's count in a bf16 column: counts above
    256 round (257 -> 256), so the count stays at 256. Both packages
    start from counts of 250 and run 10 steps on the same keys."""
    keys = np.arange(1, 65, dtype=np.int64)
    jo, to = _opts("adam")
    kw = dict(name="bfc", dim=DIM, init_capacity=CAP,
              value_dtype="bfloat16")
    tv = tde.Variable(initializer=tinit.uniform(0.05), device="cpu", **kw)
    jv = jvar.Variable(initializer=jax.nn.initializers.uniform(0.05), **kw)
    st = tde.create_slots(tv, tv.init(), to)
    rows = torch.full((len(keys), DIM), 0.5)
    st = tv.import_batch(st, torch.from_numpy(keys), rows, slot_rows={
        "optax_0": torch.full((len(keys), DIM), 250.0),
        "optax_1": torch.zeros((len(keys), DIM)),
        "optax_2": torch.zeros((len(keys), DIM))})
    tst, jst = st, _to_jax(st)

    @jax.jit
    def jstep(st, keys, g, step):
        _, ctx = jv.embedding_lookup(st, keys, step=step)
        return jv.apply_gradients(st, ctx, g, jo, step=step)

    rng = np.random.default_rng(5)
    for step in range(10):
        g = rng.normal(size=(len(keys), DIM)).astype(np.float32)
        jst = jstep(jst, jnp.asarray(keys), jnp.asarray(g), step)
        _, ctx = tv.embedding_lookup(tst, torch.from_numpy(keys), step=step)
        tst = tv.apply_gradients(tst, ctx, torch.from_numpy(g), to,
                                 step=step)
    _assert_tables(tst, jst, {"optax_0"}, rows=False)
    found = tst.keys != tv.empty_key
    assert set(tst.slots["optax_0"][found].float().unique().tolist()) == {
        256.0}
    # rows and moments agree to bf16's own rounding
    np.testing.assert_allclose(
        tst.values.float().numpy(), np.asarray(jst.values, np.float32),
        rtol=2e-2, atol=2e-2)


def test_optax_adapter_trains():
    """The JAX test's: Adam(0.05) pulls three rows to 2.0 in 300 steps."""
    tv = tde.Variable(name="optax_var", dim=DIM, init_capacity=1024,
                      initializer=0.0, device="cpu")
    st = tv.init()
    opt = tde.DynamicEmbeddingOptimizer(transforms.adam(0.05))
    ids = torch.tensor([1, 2, 3])
    for t in range(300):
        emb, ctx = tv.embedding_lookup(st, ids)
        st = tv.apply_gradients(st, ctx, emb - 2.0, opt, step=t)
    torch.testing.assert_close(tv.lookup(st, ids),
                               torch.full((3, DIM), 2.0), rtol=0, atol=1e-2)
    assert set(st.slot_names) == {"optax_0", "optax_1", "optax_2"}


def test_optax_state_becomes_slots():
    tv = tde.Variable(name="optax_slots", dim=DIM, init_capacity=256,
                      device="cpu")
    st = tv.init()
    opt = tde.DynamicEmbeddingOptimizer(transforms.adam(0.05))
    _, ctx = tv.embedding_lookup(st, torch.tensor([1]))
    st = tv.apply_gradients(st, ctx, torch.ones((1, DIM)), opt)
    assert len(st.slot_names) >= 2  # count + m + v leaves
    # one resolved adapter per (dim, dtype); a bare transform resolves too
    assert topt.resolve_for(opt, tv) is opt.resolve(DIM, torch.float32)
    assert isinstance(topt.resolve_for(transforms.adagrad(0.1), tv),
                      tde.OptaxSparseOptimizer)


@functools.lru_cache(maxsize=None)
def _jmesh():
    return jpar.create_mesh(num_devices=4)


def test_sharded_adapter_matches_jax():
    """A 4-shard table with the Adam adapter, 3 steps: per shard, planes
    and counts bit-exact, rows and moments within tolerance."""
    kw = dict(name="oxs", dim=DIM, init_capacity=1024)
    jv = jvar.Variable(initializer=jax.nn.initializers.uniform(0.05), **kw)
    tv = tde.Variable(initializer=tinit.uniform(0.05), device="cpu", **kw)
    jsv = jsharded.ShardedVariable(var=jv, mesh=_jmesh())
    tsv = tpar.ShardedVariable(tv, tpar.create_mesh(devices=["cpu"] * 4))
    jo, to = _opts("adam")
    jst = jsv.create_slots(jsv.init(), jo)
    tst = tsv.create_slots(tsv.init(), to)

    @jax.jit
    def jstep(st, ids, g, t):
        _, ctx = jsv.embedding_lookup(st, ids, step=t)
        return jsv.apply_gradients(st, ctx, g, jo, step=t)

    rng = np.random.default_rng(7)
    batches = [rng.integers(1, 60, size=96), rng.integers(1, 60, size=96),
               rng.integers(1, 2000, size=96)]
    for t, ids in enumerate(batches):
        ids = ids.astype(np.int64)
        g = rng.normal(size=(len(ids), DIM)).astype(np.float32)
        jst = jstep(jst, jnp.asarray(ids), jnp.asarray(g), jnp.int32(t))
        _, tctx = tsv.embedding_lookup(tst, torch.from_numpy(ids), step=t)
        tst = tsv.apply_gradients(tst, tctx, torch.from_numpy(g), to,
                                  step=t)
        assert tst.shards[0].slot_names == jst.slot_names
        for i, st in enumerate(tst.shards):
            for f in ("key_lo", "key_hi", "scores"):
                np.testing.assert_array_equal(
                    getattr(st, f).numpy(), np.asarray(getattr(jst, f))[i],
                    err_msg=f"shard {i} {f}")
            rows = st.rows_logical.numpy()
            want = np.asarray(jst.rows_logical)[i]
            count = slice(st.slot_offset("optax_0"),
                          st.slot_offset("optax_0") + DIM)
            np.testing.assert_array_equal(rows[:, count], want[:, count])
            np.testing.assert_allclose(rows, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"shard {i} rows")


def _jit_jax_import(monkeypatch):
    orig = jvar.Variable.import_batch
    cache = {}

    def call(self, state, keys, values, scores=None, slot_rows=None):
        _, f = cache.setdefault(id(self), (self, jax.jit(
            lambda *a: orig(self, *a))))
        return f(state, keys, values, scores, slot_rows)

    monkeypatch.setattr(jvar.Variable, "import_batch", call)


def test_checkpoint_with_adapter_slots_reads_across(tmp_path, monkeypatch):
    """A table trained by the adapter, saved by each package and read by
    the other: key by key bit-equal (keys, values, scores, the three
    slot columns), and the two packages' files byte-identical."""
    import filecmp
    import os

    _jit_jax_import(monkeypatch)
    *_, (tv, _, tst, jst) = _train_pair("adam")
    jv = jvar.Variable(name="ox", dim=DIM, init_capacity=CAP)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_dynamic_embedding(tv, tst, a)
    jckpt.save_dynamic_embedding(jv, _to_jax(tst), b)
    def files(d):
        return sorted(os.path.relpath(os.path.join(r, f), d)
                      for r, _, fs in os.walk(d) for f in fs)

    names = files(a)
    assert names == files(b)
    assert sum("optax_" in n for n in names) == 3
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names, (mismatch, errors)
    t_from_j = tckpt.load_dynamic_embedding(tv, tv.init(), b)
    j_from_t = jckpt.load_dynamic_embedding(jv, jv.init(), a)

    def per_key(st):
        live = (st.keys != tv.empty_key).numpy()
        order = np.argsort(st.keys.numpy()[live], kind="stable")
        cols = {"keys": st.keys.numpy(), "scores": st.scores.numpy(),
                "values": _words(st.values),
                **{nm: _words(c) for nm, c in st.slots.items()}}
        return {k: v[live][order] for k, v in cols.items()}

    want = per_key(tst)
    assert sorted(want) == ["keys", "optax_0", "optax_1", "optax_2",
                            "scores", "values"]
    for got in (per_key(t_from_j), per_key(_carry(j_from_t))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
