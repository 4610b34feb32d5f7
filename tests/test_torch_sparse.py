"""The port's sparse lookup API against the JAX package's, on the same
inputs: ``segment`` / ``de.math``, ``sparse`` (the three id
representations, ``embedding_lookup_sparse``,
``safe_embedding_lookup_sparse`` with and without ``default_id``, the
combiner's gradient, ``apply_sparse_gradients``, the ragged lookups and
helpers), ``data_flow``, ``hash_strings``, ``get_variable`` /
``ModelMode`` / ``GraphKeys``, the ``nn/layers`` modules and the ``de``
namespace.

Batches hold EMPTY padding, negative ids, zero weights and all-empty
rows. Tolerances:

- integers (segment ids, masks, counts, key planes, scores, sizes),
  gathers and id helpers: bit-exact;
- the combiners and the combined output's gradient per row, on the same
  rows: rtol 1e-6 / atol 1e-6 against the JAX functions and
  ``jax.vjp``, on unit-scale data (the JAX package adds in float32, the
  port takes f64 prefix sums, so a sum that cancels differs by a few
  float32 roundings of its terms);
- what a lookup reads from the table after training (combined outputs,
  rows after an Adam apply): rtol 1e-5 / atol 1e-6, the training tests'
  tolerance. ``normal`` initial rows are within 4 float32 ulps of the
  JAX package's (``ops/initializers.py``); uniform ones bit-exact.

The JAX side runs its functions as written; its ``Variable``'s
trainable lookup, apply and lookup are jitted (one compile for every
case) so the file stays fast.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.keras import layers as jkl
from recommenders_addons_tpu.ops import hashing as jhash
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import segment as jseg
from recommenders_addons_tpu.ops import sparse as jsp
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.keras import layers as tkl
from recommenders_addons_tpu_torch.ops import hashing as thash
from recommenders_addons_tpu_torch.ops import segment as tseg

EMPTY = int(jde.EMPTY_KEY)
DIM, CAP, B, L = 8, 1024, 64, 8
RTOL_COMBINE, ATOL_COMBINE = 1e-6, 1e-6
RTOL, ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a)


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# segment / de.math
# ---------------------------------------------------------------------------


def _segment_inputs(seed=0, n=300, ns=37):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, DIM)).astype(np.float32)
    # ids past the last segment are dropped; segment 5 stays empty
    seg = rng.integers(0, ns + 3, size=n).astype(np.int32)
    seg[seg == 5] = 6
    w = rng.uniform(0.1, 2.0, size=n).astype(np.float32)
    w[::17] = 0.0
    idx = rng.integers(0, n, size=n).astype(np.int32)
    return data, seg, w, idx, ns


@pytest.mark.parametrize("case", [
    "segment_sum_rows", "segment_sum_1d", "segment_sum_int",
    "segment_sum_3d", "sparse_segment_sum", "sparse_segment_mean",
    "sparse_segment_sqrt_n"])
def test_segment_reductions_match(case):
    data, seg, w, idx, ns = _segment_inputs()
    sg = np.clip(seg, 0, ns - 1)  # TF's sparse_segment_* want valid ids
    j, t = jde.math, tde.math
    if case == "segment_sum_rows":
        want, got = (j.segment_sum(jnp.asarray(data), jnp.asarray(seg), ns),
                     t.segment_sum(_t(data), _t(seg), ns))
    elif case == "segment_sum_1d":
        want, got = (j.segment_sum(jnp.asarray(w), jnp.asarray(seg), ns),
                     t.segment_sum(_t(w), _t(seg), ns))
    elif case == "segment_sum_int":
        c = (np.arange(seg.shape[0]) % 5).astype(np.int32)
        want, got = (j.segment_sum(jnp.asarray(c), jnp.asarray(seg), ns),
                     t.segment_sum(_t(c), _t(seg), ns))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got.dtype == torch.int32
        return
    elif case == "segment_sum_3d":
        d3 = data.reshape(-1, 2, DIM // 2)
        want, got = (jseg.segment_sum(jnp.asarray(d3), jnp.asarray(seg), ns),
                     tseg.segment_sum(_t(d3), _t(seg), ns))
    else:
        jf, tf = getattr(j, case), getattr(t, case)
        want = jf(jnp.asarray(data), jnp.asarray(idx), jnp.asarray(sg), ns)
        got = tf(_t(data), _t(idx), _t(sg), ns)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want, RTOL_COMBINE, ATOL_COMBINE, case)


def test_segment_sum_drops_negative_ids():
    """Negative segment ids are dropped, as ``jax.ops.segment_sum`` drops
    them. (The JAX package's 2-D row path, ``segment_sum_rows``, wraps
    them onto the last segments instead: its ``.at[].add(mode="drop")``
    normalizes negative indices first.)"""
    data, seg, w, _, ns = _segment_inputs(seed=3)
    seg = seg - 3  # ids -3..-1 now
    for d in (data, w):
        _close(tseg.segment_sum(_t(d), _t(seg), ns),
               jax.ops.segment_sum(jnp.asarray(d), jnp.asarray(seg), ns),
               RTOL_COMBINE, ATOL_COMBINE)


@pytest.mark.parametrize("combiner", ["sum", "mean", "sqrtn"])
@pytest.mark.parametrize("weighted", [False, True])
def test_combine_and_its_gradient_match(combiner, weighted):
    """``weighted_segment_combine`` and ``SparseLookupContext.row_gradient``
    against the JAX combine and its ``jax.vjp`` on the same rows."""
    data, seg, w, _, ns = _segment_inputs(seed=1)
    wj = jnp.asarray(w) if weighted else None
    wt = _t(w) if weighted else None
    want = jseg.weighted_segment_combine(jnp.asarray(data),
                                         jnp.asarray(seg), ns, wj, combiner)
    got = tseg.weighted_segment_combine(_t(data), _t(seg), ns, wt, combiner)
    _close(got, want, RTOL_COMBINE, ATOL_COMBINE, "combine")
    g = np.random.default_rng(2).normal(size=(ns, DIM)).astype(np.float32)
    _, vjp = jax.vjp(lambda e: jseg.weighted_segment_combine(
        e, jnp.asarray(seg), ns, wj, combiner), jnp.asarray(data))
    wfull = _t(w) if weighted else torch.ones(seg.shape[0])
    ctx = tde.SparseLookupContext(
        None, _t(seg), wfull, ns,
        tseg.combine_denominator(wfull, _t(seg), ns, combiner))
    _close(ctx.row_gradient(_t(g)), vjp(jnp.asarray(g))[0], RTOL_COMBINE,
           ATOL_COMBINE, "row gradient")
    with pytest.raises(ValueError):
        tseg.weighted_segment_combine(_t(data), _t(seg), ns, None, "max")


# ---------------------------------------------------------------------------
# sparse lookups, trained
# ---------------------------------------------------------------------------


def _batch(seed=0):
    """[B, L] zipf ids, EMPTY padding (rows 0-2 all empty), 3% negative
    ids, positive weights with 3% zeros and one negative."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, size=(B, L)) % 300 + 1).astype(np.int64)
    lens = rng.integers(0, L + 1, size=B)
    lens[:3] = 0
    for i in range(B):
        ids[i, lens[i]:] = EMPTY
    neg = (rng.random((B, L)) < 0.03) & (ids > 0)
    ids[neg] *= -1
    w = rng.uniform(0.1, 2.0, size=(B, L)).astype(np.float32)
    w[rng.random((B, L)) < 0.03] = 0.0
    w[5, 0] = -1.0
    return ids, w, lens


def _as_kind(kind, ids, w, lens, pkg):
    """The batch as ``pkg``'s padded-dense, SparseIds or RaggedIds input
    (every kind has B * L entries, so the JAX side compiles once)."""
    arr = jnp.asarray if pkg is jde else _t
    if kind == "dense":
        return arr(ids), arr(w)
    if kind == "sparse":
        # rank 3 (rows split in two) and entries out of order
        sp = jsp.dense_to_sparse(jnp.asarray(ids))
        ind = np.asarray(sp.indices)
        ind3 = np.stack([ind[:, 0] // 2, ind[:, 0] % 2, ind[:, 1]], axis=1)
        perm = np.random.default_rng(3).permutation(ind3.shape[0])
        return (pkg.SparseIds(arr(ind3[perm].astype(np.int32)),
                              arr(ids.reshape(-1)[perm]), (B // 2, 2, L)),
                arr(w.reshape(-1)[perm]))
    keep = ids != EMPTY
    vals = ids[keep]
    splits = np.concatenate([[0], np.cumsum(keep.sum(1))]).astype(np.int32)
    pad = B * L - vals.shape[0]  # tail padding: garbage ids, masked
    vals = np.concatenate([vals, np.arange(7, 7 + pad, dtype=np.int64)])
    wv = np.concatenate([w[keep], np.full(pad, 3.0, np.float32)])
    return pkg.RaggedIds(arr(vals), arr(splits)), arr(wv)


@functools.lru_cache(maxsize=None)
def _jax_variable():
    """One JAX Variable for every case, its trainable lookup, apply and
    lookup jitted (the sparse functions call them by attribute), so the
    three id kinds share their compiles; and its Adam."""
    jv = jvar.Variable(name="sp", dim=DIM, init_capacity=CAP,
                       initializer=jax.nn.initializers.normal(0.05))
    opt = jde.Adam(0.05)
    lookup_train = jax.jit(functools.partial(jvar.Variable.embedding_lookup,
                                             jv))
    apply = jax.jit(lambda s, c, g, step: jvar.Variable.apply_gradients(
        jv, s, c, g, opt, step=step))
    lookup = jax.jit(lambda s, k, init: jvar.Variable.lookup(
        jv, s, k, use_init_for_missing=init), static_argnums=2)
    object.__setattr__(jv, "embedding_lookup", lookup_train)
    object.__setattr__(
        jv, "apply_gradients",
        lambda s, c, g, o, step=0, epoch=0: apply(s, c, g, step))
    object.__setattr__(
        jv, "lookup",
        lambda s, k, use_init_for_missing=False: lookup(
            s, k, use_init_for_missing))
    return jv, opt


def _assert_tables(jv, js, tv, ts, what):
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{what}: {f}")
    assert int(tv.size(ts)) == int(jde.raw_table.size(jv.spec, js))
    _close(ts.rows_logical, js.rows_logical, RTOL, ATOL, f"{what}: rows")


@pytest.mark.parametrize("kind", ["dense", "sparse", "ragged"])
def test_sparse_lookups_train_alike(kind):
    """Each lookup (``embedding_lookup_sparse``, ``safe_`` without and
    with ``default_id``) and combiner in turn: the combined output
    (training and inference), the row gradient, then
    ``apply_sparse_gradients`` (Adam): key planes, scores and size
    bit-exact after every step."""
    ids, w, lens = _batch()
    jv, jopt = _jax_variable()
    tv = tde.Variable(name="sp", dim=DIM, init_capacity=CAP,
                      initializer=tde.initializers.normal(0.05),
                      device="cpu")
    topt = tde.Adam(0.05)
    js, ts = jv.init(), tv.init()
    jin, jw = _as_kind(kind, ids, w, lens, jde)
    tin, tw = _as_kind(kind, ids, w, lens, tde)
    rng = np.random.default_rng(4)
    step = 0
    for combiner in ("sum", "mean", "sqrtn"):
        for fn, kw in (("embedding_lookup_sparse", {}),
                       ("safe_embedding_lookup_sparse", {}),
                       ("safe_embedding_lookup_sparse", {"default_id": 7})):
            what = f"{kind} {fn} {combiner} {kw}"
            jf, tf = getattr(jde, fn), getattr(tde, fn)
            jc, jctx = jf(jv, js, jin, jw, combiner=combiner, **kw)
            tc, tctx = tf(tv, ts, tin, tw, combiner=combiner, **kw)
            assert tuple(tc.shape) == tuple(jc.shape), what
            _close(tc, jc, RTOL, ATOL, what)
            _close(tf(tv, ts, tin, tw, combiner=combiner, training=False,
                      **kw),
                   jf(jv, js, jin, jw, combiner=combiner, training=False,
                      **kw), RTOL, ATOL, what + " inference")
            g = rng.normal(size=jc.shape).astype(np.float32)
            _close(tctx.row_gradient(_t(g)),
                   jctx.row_gradient(jnp.asarray(g)), RTOL_COMBINE,
                   ATOL_COMBINE, what + " row gradient")
            js = jde.apply_sparse_gradients(jv, js, jctx, jnp.asarray(g),
                                            jopt, step=step)
            ts = tde.apply_sparse_gradients(tv, ts, tctx, _t(g), topt,
                                            step=step)
            _assert_tables(jv, js, tv, ts, what)
            step += 1
    if kind == "ragged":  # ragged in, ragged out, trained
        jr, jctx = jde.embedding_lookup_ragged(jv, js, jin)
        tr, tctx = tde.embedding_lookup_ragged(tv, ts, tin)
        _close(tr.values, jr.values, RTOL, ATOL, "ragged values")
        np.testing.assert_array_equal(tr.row_splits.numpy(),
                                      np.asarray(jr.row_splits))
        _close(tr.to_padded(L, -1.0), jr.to_padded(L, -1.0), RTOL, ATOL)
        g = rng.normal(size=jr.values.shape).astype(np.float32)
        js = jv.apply_gradients(js, jctx, jnp.asarray(g), jopt, step=step)
        ts = tv.apply_gradients(ts, tctx, _t(g), topt, step=step)
        _assert_tables(jv, js, tv, ts, "ragged lookup")
        _close(tde.embedding_lookup_ragged(tv, ts, tin,
                                           training=False).values,
               jde.embedding_lookup_ragged(jv, js, jin,
                                           training=False).values,
               RTOL, ATOL, "ragged inference")


# ---------------------------------------------------------------------------
# id helpers, data_flow, hashing
# ---------------------------------------------------------------------------


def test_id_helpers_match():
    ids, w, lens = _batch(seed=5)
    jr, _ = _as_kind("ragged", ids, w, lens, jde)
    tr, _ = _as_kind("ragged", ids, w, lens, tde)
    np.testing.assert_array_equal(tr.row_ids().numpy(),
                                  np.asarray(jr.row_ids()))
    np.testing.assert_array_equal(tr.valid_mask().numpy(),
                                  np.asarray(jr.valid_mask()))
    for dv in (0, 42):
        (jo, je), (to, te) = (jde.ragged_fill_empty_rows(jr, dv),
                              tde.ragged_fill_empty_rows(tr, dv))
        for a, b in ((to.values, jo.values), (to.row_splits, jo.row_splits),
                     (te, je)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js, _ = _as_kind("sparse", ids, w, lens, jde)
    ts, _ = _as_kind("sparse", ids, w, lens, tde)
    np.testing.assert_array_equal(ts.row_ids().numpy(),
                                  np.asarray(js.row_ids()))
    assert ts.num_rows == js.num_rows and ts.nnz == js.nnz
    for shape in ((B, L), (-1, 4), (B * L,)):
        a, b = tde.sparse_reshape(ts, shape), jde.sparse_reshape(js, shape)
        assert a.dense_shape == b.dense_shape
        np.testing.assert_array_equal(a.indices.numpy(),
                                      np.asarray(b.indices))
    ts2, js2 = tde.dense_to_sparse(_t(ids)), jde.dense_to_sparse(
        jnp.asarray(ids))
    assert ts2.dense_shape == js2.dense_shape
    np.testing.assert_array_equal(ts2.indices.numpy(),
                                  np.asarray(js2.indices))
    np.testing.assert_array_equal(ts2.values.numpy(), np.asarray(js2.values))
    (jo, je), (to, te) = (jde.sparse_fill_empty_rows(js2, 9),
                          tde.sparse_fill_empty_rows(ts2, 9))
    for a, b in ((to.indices, jo.indices), (to.values, jo.values),
                 (te, je)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_data_flow_matches():
    rng = np.random.default_rng(6)
    data = rng.normal(size=(50, 3)).astype(np.float32)
    part = rng.integers(0, 4, size=50).astype(np.int32)
    jp = jde.data_flow.dynamic_partition(jnp.asarray(data),
                                         jnp.asarray(part), 4)
    tp = tde.data_flow.dynamic_partition(_t(data), _t(part), 4)
    for a, b in zip(tp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        tde.data_flow.dynamic_stitch_flat(tp[0], tp[2], 50).numpy(), data)
    # duplicates across lists and within one: the last write wins
    idx = [np.array([0, 2, 4, 2], np.int32), np.array([1, 4, 5], np.int32)]
    vals = [rng.normal(size=(4, 3)).astype(np.float32),
            rng.normal(size=(3, 3)).astype(np.float32)]
    for size in (None, 8):
        want = jde.data_flow.dynamic_stitch(
            [jnp.asarray(i) for i in idx], [jnp.asarray(v) for v in vals],
            size)
        got = tde.data_flow.dynamic_stitch([_t(i) for i in idx],
                                           [_t(v) for v in vals], size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("algo", ["fnv1a", "blake2"])
def test_hash_strings_match(algo):
    strings = ["", "a", "user:123", "ünïcode ✓", b"raw\x00bytes",
               "x" * 300] + [f"item_{i}" for i in range(200)]
    for dtype in (np.int64, np.int32):
        got = tde.hash_strings(strings, dtype=dtype, algo=algo)
        want = jhash.hash_strings(strings, dtype=dtype, algo=algo)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # the JAX package's numpy path (its native hasher matches it bit for
    # bit) and the EMPTY sentinel never given
    np.testing.assert_array_equal(thash._fnv1a64_vectorized(strings),
                                  jhash._fnv1a64_vectorized(strings))
    assert not (tde.hash_strings(strings, algo=algo) == EMPTY).any()
    with pytest.raises(ValueError):
        tde.hash_strings(strings, algo="md5")


# ---------------------------------------------------------------------------
# scope store, mode, namespace
# ---------------------------------------------------------------------------


def test_get_variable_and_model_mode_match():
    init = tde.initializers.uniform(0.05)
    for pkg, ini in ((jde, jax.nn.initializers.uniform(0.05)), (tde, init)):
        pkg.clear_variable_store()
        a = pkg.get_variable("gv", dim=4, init_capacity=256, initializer=ini)
        assert pkg.get_variable("gv", dim=4, initializer=ini) is a
        assert pkg.get_variable("gv") is a
        with pytest.raises(ValueError, match="different dim"):
            pkg.get_variable("gv", dim=8)
        with pytest.raises(ValueError, match="different initializer"):
            pkg.get_variable("gv", initializer=type(ini)(0.05)
                             if pkg is tde else
                             jax.nn.initializers.uniform(0.05))
        c = pkg.get_variable("gv_c", dim=2, initializer=0.5)
        assert pkg.get_variable("gv_c", initializer=0.5) is c
        with pytest.raises(ValueError, match="different initializer"):
            pkg.get_variable("gv_c", initializer=0.25)
        pkg.clear_variable_store()
        assert pkg.get_variable("gv", dim=4) is not a
        assert a.trainable
        pkg.clear_variable_store()
        assert pkg.get_model_mode() == "train"
        pkg.enable_inference_mode()
        assert pkg.get_model_mode() == pkg.ModelMode.INFERENCE
        pkg.enable_train_mode()
        assert pkg.ModelMode.CURRENT_SETTING == pkg.ModelMode.TRAIN
    for k in ("DYNAMIC_EMBEDDING_VARIABLES",
              "TRAINABLE_DYNAMIC_EMBEDDING_VARIABLES"):
        assert getattr(tde.GraphKeys, k) == getattr(jde.GraphKeys, k)


def test_de_exposes_the_jax_packages_names():
    """Every name the JAX ``de`` takes from ops/sparse.py, segment.py /
    de_math.py, data_flow.py and variable.py, and the serving, hashing
    and lookup-wrapper names."""
    mods = {"recommenders_addons_tpu.ops." + m
            for m in ("sparse", "segment", "de_math", "data_flow",
                      "variable")}
    names = {n for n in dir(jde) if not n.startswith("_")
             and getattr(getattr(jde, n), "__module__", None) in mods}
    names |= {"math", "data_flow", "ragged_embedding_ops", "hash_strings",
              "EMPTY_KEY", "FrozenTable", "export_compressed",
              "load_compressed", "embedding_lookup",
              "embedding_lookup_unique", "embedding_lookup_trainable",
              "patch_on_tf", "patch_on_tf_save_restore", "HkvEvictStrategy"}
    assert len(names) > 35
    missing = sorted(n for n in names if not hasattr(tde, n))
    assert not missing, missing
    for n in dir(jde.math):
        if not n.startswith("_"):
            assert hasattr(tde.math, n), n
    assert tde.EMPTY_KEY == int(jde.EMPTY_KEY)
    assert tde.patch_on_tf() is None and tde.patch_on_tf_save_restore() is None
    assert tde.ragged_embedding_ops.embedding_lookup_ragged is \
        tde.embedding_lookup_ragged


# ---------------------------------------------------------------------------
# nn/layers
# ---------------------------------------------------------------------------


def _layer_pair(cls, name, jinit=None, tinit=None, **kw):
    jl = getattr(jkl, cls)(DIM, name=name, init_capacity=CAP,
                           initializer=jinit, **kw)
    tl = getattr(tkl, cls)(DIM, name=name, init_capacity=CAP,
                           initializer=tinit, device="cpu", **kw)
    return jl, tl


def _filled(jl, tl, n=200, seed=7):
    """Both layers' tables holding the same random rows for ids 1..n (the
    port's upsert, carried across to the JAX state)."""
    vals = np.random.default_rng(seed).normal(size=(n, DIM)).astype(
        np.float32)
    keys = np.arange(1, n + 1, dtype=np.int64)
    ts = tl.var.upsert(tl.init_state(), _t(keys), _t(vals))
    arrays, meta = convert.table_state_to_numpy(ts)
    js = jht.TableState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                        **meta)
    return js, ts


@pytest.mark.parametrize("cls,kw", [
    ("Embedding", {}),
    ("SquashedEmbedding", {"combiner": "mean"}),
    ("SquashedEmbedding", {"combiner": "sum"}),
    ("FieldWiseEmbedding", {"nslots": 3,
                            "slot_map_fn": lambda ids: ids % 3}),
])
def test_embedding_layers_match(cls, kw):
    """Each layer's output (padded-dense ids with EMPTY padding and ids
    the table lacks, and RaggedIds where the layer takes them) against the
    JAX layer's on the same table, and its config."""
    jl, tl = _layer_pair(cls, "kl_" + cls.lower(), **kw)
    js, ts = _filled(jl, tl)
    ids = np.random.default_rng(8).integers(1, 260, size=(16, 6))
    ids[:, 4:] = EMPTY
    _close(tl(ts, _t(ids), training=False),
           jl(js, jnp.asarray(ids), training=False), RTOL_COMBINE,
           ATOL_COMBINE)
    if cls != "SquashedEmbedding":
        rg = (np.array([3, 5, 250, 7, 9, 1], np.int64),
              np.array([0, 2, 2, 5], np.int32))
        jo = jl(js, jde.RaggedIds(*map(jnp.asarray, rg)), training=False)
        to = tl(ts, tde.RaggedIds(*map(_t, rg)), training=False)
        if cls == "Embedding":
            jo, to = jo.values, to.values
        _close(to, jo, RTOL_COMBINE, ATOL_COMBINE)
    # a training call returns the rows and the lookup's context
    out, ctx = tl(ts, _t(ids), training=True)
    assert isinstance(ctx, tde.LookupContext)
    cfg = tl.get_config()
    assert cfg == jl.get_config()
    back = getattr(tkl, cls).from_config(cfg, device="cpu", **{
        k: v for k, v in kw.items() if k != "combiner"})
    assert back.get_config() == cfg


def test_embedding_layer_trains():
    """The JAX package's layer contract (``tests/test_keras_layers.py``):
    an id seen twice gets twice the gradient."""
    layer = tkl.Embedding(8, name="kl_train", init_capacity=1 << 10,
                          initializer=0.1, device="cpu")
    assert tkl.BasicEmbedding is tkl.Embedding
    state = layer.init_state()
    ids = torch.tensor([[1, 2], [3, 1]])
    emb, ctx = layer(state, ids, training=True)
    assert tuple(emb.shape) == (2, 2, 8)
    torch.testing.assert_close(emb, torch.full_like(emb, 0.1))
    state = layer.apply_gradients(state, ctx, torch.ones_like(emb),
                                  tde.SGD(0.1), step=0)
    out = layer(state, ids, training=False)
    torch.testing.assert_close(out[0, 0], torch.full((8,), -0.1))
    torch.testing.assert_close(out[0, 1], torch.zeros(8), atol=1e-7,
                               rtol=0)
    with pytest.raises(ValueError, match="requires a mesh"):
        tkl.AllToAllEmbedding(4, name="kl_a2a")
    with pytest.raises(TypeError):
        tkl.HvdAllToAllEmbedding(4, mesh=object(), name="kl_a2a")


def test_layer_normalization_matches():
    rng = np.random.default_rng(9)
    x = (rng.normal(size=(4, 5, 8)) * 3 + 5).astype(np.float32)
    params = {"gamma": rng.normal(size=8).astype(np.float32),
              "beta": rng.normal(size=8).astype(np.float32)}
    want = jkl.LayerNormalization()(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x))
    ln = convert.layer_norm_from_numpy(params, device="cpu")
    _close(ln(_t(x)), want, RTOL_COMBINE, 1e-6)
    for k, v in convert.layer_norm_to_numpy(ln).items():
        np.testing.assert_array_equal(v, params[k])
    fresh = tkl.LayerNormalization(dim=8, device="cpu")
    y = fresh(_t(x))
    _close(y.mean(-1), np.zeros((4, 5)), 0, 1e-5)
    assert {n for n, _ in fresh.named_parameters()} == {"gamma", "beta"}
