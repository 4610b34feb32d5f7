"""The port's four model families built on the sparse lookup API (DCN,
MovieLens one-hot and multi-hot, two-tower retrieval, seq-and-dense)
against the JAX package's, at narrow widths: three training steps each
from the same dense weights (carried across with ``convert.py``) and the
same batches (the synthetic generators draw the same numpy values).

- Losses and dense weights after 3 steps: rtol 1e-5 / atol 1e-6 (matrix
  products sum in another order).
- Key planes, scores and table sizes: bit-exact, batches of EMPTY-padded
  multi-hot genres and sequences included (the padding and the ids
  ``safe_embedding_lookup_sparse`` prunes go to the trash row and are
  never inserted).
- Table rows and predictions: rtol 1e-5 / atol 1e-6; rows of the Adam
  tables (MovieLens, seq-and-dense) rtol 1e-4 / atol 1e-4: Adam moves a
  fresh row by ``lr * g / (|g| + eps)``, so where a gradient element
  cancels to about ``eps`` (1e-7; one MovieLens step has one at
  -1.3e-7) its rounding moves the row by up to ``lr`` (0.05) times its
  relative error. DCN's initial rows (uniform) are bit-exact; the other
  families' (normal) are within 4 float32 ulps of the JAX package's
  (``ops/initializers.py``).

Scores: MovieLens, retrieval and seq-and-dense stamp no step at lookup,
so both packages stamp the apply's step. DCN stamps ``step + 1`` at
lookup, which the JAX package's CPU (XLA) apply overwrites with the
apply's step; its JAX side runs the fused Pallas apply in the
interpreter (``TFRA_TPU_PALLAS_INTERPRET=1``), the path the port always
takes, as ``tests/test_torch_dlrm.py`` does. Where the optimizer's slot
starts at a non-zero value (Adagrad: DCN, retrieval), both sides create
the slots before the first lookup (PERF.md, ROADMAP.md Queue 3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.models import dcn as jdcn
from recommenders_addons_tpu.models import movielens as jml
from recommenders_addons_tpu.models import retrieval as jrt
from recommenders_addons_tpu.models import seq_and_dense as jsq
from recommenders_addons_tpu.ops import pallas_ops
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.models import dcn as tdcn
from recommenders_addons_tpu_torch.models import movielens as tml
from recommenders_addons_tpu_torch.models import retrieval as trt
from recommenders_addons_tpu_torch.models import seq_and_dense as tsq
from recommenders_addons_tpu_torch.nn import layers as tnl

STEPS = 3
RTOL, ATOL = 1e-5, 1e-6
ADAM_ROWS = dict(rtol=1e-4, atol=1e-4)


def _on(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, what="", rtol=RTOL, atol=ATOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _tables_alike(tv, ts, jst, what, **tol):
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(jst, f)),
                                      err_msg=f"{what}: {f}")
    assert ts.slot_names == jst.slot_names, what
    n = int(tv.size(ts))
    assert n == int(jde.raw_table.size(tv.spec, jst)) and n > 0, what
    _close(ts.rows_logical, jst.rows_logical, f"{what}: rows", **tol)


def _mlps_alike(got, want, what):
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        for k in ("w", "b"):
            _close(g[k], w[k], f"{what} {k}")


@pytest.mark.parametrize("gen", ["movielens", "movielens_multi_hot", "seq",
                                 "interactions"])
def test_synthetic_batches_are_the_jax_packages(gen):
    fns = {"movielens": (tml.synthetic_movielens_batch,
                         jml.synthetic_movielens_batch, {}),
           "movielens_multi_hot": (tml.synthetic_movielens_batch,
                                   jml.synthetic_movielens_batch,
                                   {"multi_hot": True}),
           "seq": (tsq.synthetic_seq_batch, jsq.synthetic_seq_batch, {}),
           "interactions": (trt.synthetic_interactions,
                            jrt.synthetic_interactions, {})}
    t, j, kw = fns[gen]
    a = t(np.random.default_rng(5), 64, **kw)
    b = j(np.random.default_rng(5), 64, **kw)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_dcn_train_steps_match(monkeypatch):
    monkeypatch.setenv("TFRA_TPU_PALLAS_INTERPRET", "1")
    # one grid step of 128 rows takes these 128-key batches
    monkeypatch.setattr(pallas_ops, "_TILE", 128)
    monkeypatch.setattr(pallas_ops, "_SUB", 128)
    narrow = dict(num_sparse=4, dim=8, num_cross=2, deep_sizes=(16, 8),
                  table_capacity=1024)
    rng = np.random.default_rng(0)
    batches = [jdcn.synthetic_criteo_batch(rng, 32, num_sparse=4,
                                           vocab_per_feature=300)
               for _ in range(STEPS)]

    jm = jdcn.DCN(jdcn.DCNConfig(**narrow))
    jst = jm.init(jax.random.PRNGKey(0))
    dense0 = jax.device_get(jst.dense)
    jst = dataclasses.replace(
        jst, table=jde.create_slots(jm.var, jst.table, jm.opt))
    jstep, jtx = jm.make_train_step()
    jopt = jtx.init(jst.dense)
    jstep = jax.jit(jstep)

    tm = tdcn.DCN(tdcn.DCNConfig(**narrow), device="cpu")
    tst = tdcn.DCNState(
        table=tde.create_slots(tm.var, tm.var.init(), tm.opt),
        dense=convert.dcn_dense_from_numpy(dense0, tm.cfg, device="cpu"),
        step=0)
    tstep, ttx = tm.make_train_step()
    topt = ttx.init(list(tst.dense.parameters()))
    for i, b in enumerate(batches):
        jst, jopt, jloss = jstep(jst, jopt, _jnp(b))
        tst, topt, tloss = tstep(tst, topt, _on(b))
        _close(tloss, jloss, f"loss {i}")
    got, want = convert.dcn_dense_to_numpy(tst.dense), jst.dense
    for name in ("cross", "deep", "head"):
        _mlps_alike(got[name], want[name], name)
    _tables_alike(tm.var, tst.table, jst.table, "dcn")
    _close(tm.predict(tst, _on(batches[0])),
           jax.jit(jm.predict)(jst, _jnp(batches[0])), "predict")


@pytest.mark.parametrize("multi_hot", [False, True])
def test_movielens_train_steps_match(multi_hot):
    narrow = dict(dim=8, hidden=(16, 1), user_capacity=1024,
                  movie_capacity=1024, genre_capacity=256,
                  multi_hot_genres=multi_hot)
    rng = np.random.default_rng(1)
    batches = [jml.synthetic_movielens_batch(rng, 32, num_users=300,
                                             num_movies=200,
                                             multi_hot=multi_hot)
               for _ in range(STEPS)]
    jm = jml.MovieLensModel(jml.MovieLensConfig(**narrow))
    jst = jm.init(jax.random.PRNGKey(0))
    tm = tml.MovieLensModel(tml.MovieLensConfig(**narrow), device="cpu")
    tst = tm.init()
    tst.dense = convert.mlp_from_numpy(jax.device_get(jst.dense),
                                       device="cpu")
    jstep, tstep = jax.jit(jm.make_train_step()), tm.make_train_step()
    for i, b in enumerate(batches):
        jst, jloss = jstep(jst, _jnp(b))
        tst, tloss = tstep(tst, _on(b))
        _close(tloss, jloss, f"loss {i}")
    _mlps_alike(convert.mlp_to_numpy(tst.dense), jst.dense, "mlp")
    _tables_alike(tm.user, tst.user, jst.user, "user", **ADAM_ROWS)
    _tables_alike(tm.movie, tst.movie, jst.movie, "movie", **ADAM_ROWS)
    if multi_hot:
        _tables_alike(tm.genre, tst.genre, jst.genre, "genre", **ADAM_ROWS)
        assert int(tm.genre.size(tst.genre)) <= 18  # padding never inserted
    _close(tm.predict(tst, _on(batches[0])),
           jax.jit(jm.predict)(jst, _jnp(batches[0])), "predict")


def test_retrieval_train_steps_match():
    narrow = dict(dim=8, tower_sizes=(16, 8), user_capacity=1024,
                  item_capacity=1024)
    rng = np.random.default_rng(2)
    batches = [jrt.synthetic_interactions(rng, 32, num_users=200,
                                          num_items=128)
               for _ in range(STEPS)]
    jm = jrt.TwoTowerModel(jrt.TwoTowerConfig(**narrow))
    jst = jm.init(jax.random.PRNGKey(0))
    jst = dataclasses.replace(
        jst, user=jde.create_slots(jm.user, jst.user, jm.opt),
        item=jde.create_slots(jm.item, jst.item, jm.opt))
    tm = trt.TwoTowerModel(trt.TwoTowerConfig(**narrow), device="cpu")
    tst = tm.init()
    tst = dataclasses.replace(
        tst, user=tde.create_slots(tm.user, tst.user, tm.opt),
        item=tde.create_slots(tm.item, tst.item, tm.opt),
        dense=nn.ModuleDict({
            k: convert.mlp_from_numpy(v, device="cpu")
            for k, v in jax.device_get(jst.dense).items()}))
    jstep, tstep = jax.jit(jm.make_train_step()), tm.make_train_step()
    for i, b in enumerate(batches):
        jst, jloss = jstep(jst, _jnp(b))
        tst, tloss = tstep(tst, _on(b))
        _close(tloss, jloss, f"loss {i}")
    for k in ("user", "item"):
        _mlps_alike(convert.mlp_to_numpy(tst.dense[k]), jst.dense[k], k)
    _tables_alike(tm.user, tst.user, jst.user, "user")
    _tables_alike(tm.item, tst.item, jst.item, "item")
    users = np.arange(1, 33, dtype=np.int64)
    cands = np.arange(1, 129, dtype=np.int64)
    _close(tm.score(tst, torch.from_numpy(users), torch.from_numpy(cands[:32])),
           jax.jit(jm.score)(jst, jnp.asarray(users),
                             jnp.asarray(cands[:32])),
           "score")
    # top-k: compared where the k-th and (k+1)-th scores are apart (the
    # two packages may order ties differently)
    k = 5
    got = tm.retrieve(tst, torch.from_numpy(users),
                      torch.from_numpy(cands), k=k).numpy()
    want = np.asarray(jax.jit(jm.retrieve, static_argnames="k")(
        jst, jnp.asarray(users), jnp.asarray(cands), k=k))
    scores = np.sort(np.asarray(jax.jit(jm.score)(
        jst, jnp.asarray(np.repeat(users, cands.size)),
        jnp.asarray(np.tile(cands, users.size)))).reshape(users.size, -1),
        axis=1)[:, ::-1]
    apart = np.diff(scores, axis=1).min(axis=1) < -1e-5  # all distinct
    assert apart.sum() > users.size // 2
    np.testing.assert_array_equal(got[apart], want[apart])


def test_seq_and_dense_train_steps_match():
    narrow = dict(dim=8, max_seq_len=6, num_dense=3, hidden=(16, 1),
                  capacity=1024)
    rng = np.random.default_rng(3)
    batches = [jsq.synthetic_seq_batch(rng, 32, max_len=6, vocab=300,
                                       num_dense=3)
               for _ in range(STEPS)]
    jm = jsq.SeqAndDenseModel(jsq.SeqAndDenseConfig(**narrow))
    jst = jm.init(jax.random.PRNGKey(0))
    tm = tsq.SeqAndDenseModel(tsq.SeqAndDenseConfig(**narrow), device="cpu")
    tst = tm.init()
    tst.dense = convert.mlp_from_numpy(jax.device_get(jst.dense),
                                       device="cpu")
    jstep, tstep = jax.jit(jm.make_train_step()), tm.make_train_step()
    for i, b in enumerate(batches):
        jst, jloss = jstep(jst, _jnp(b))
        tst, tloss = tstep(tst, _on(b))
        _close(tloss, jloss, f"loss {i}")
    _mlps_alike(convert.mlp_to_numpy(tst.dense), jst.dense, "mlp")
    _tables_alike(tm.var, tst.table, jst.table, "seq", **ADAM_ROWS)
    _close(tm.predict(tst, _on(batches[0])),
           jax.jit(jm.predict)(jst, _jnp(batches[0])), "predict")


def test_models_raise_without_a_card_or_with_a_mesh():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    for make in (lambda: tdcn.DCN(), lambda: tml.MovieLensModel(),
                 lambda: trt.TwoTowerModel(), lambda: tsq.SeqAndDenseModel(),
                 lambda: tnl.LayerNormalization(dim=8)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    # a mesh that is not a parallel mesh raises; a real one shards the
    # tables (tests/test_torch_sharded.py trains them)
    from recommenders_addons_tpu_torch import parallel as tpar

    for cls in (tdcn.DCN, tml.MovieLensModel, trt.TwoTowerModel,
                tsq.SeqAndDenseModel):
        with pytest.raises(TypeError):
            cls(mesh=object(), device="cpu")
        cls(mesh=tpar.create_mesh(devices=["cpu"] * 2), device="cpu")
