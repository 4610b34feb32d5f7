"""The port's DLRM trainer (models/dlrm.py through train/loop.py) against
the JAX package's, at narrow widths: 4 features, dim 8, towers (16, 8)
and (16, 1), table capacity 1024, batch 32, three steps from the same
weights (carried across with convert.py).

The JAX step runs jitted on the CPU with its fused Pallas apply in the
interpreter (``TFRA_TPU_PALLAS_INTERPRET=1``), which is the path the port
always takes: the lookup's LRU score stamp stands. Losses and tower
weights match within rtol 1e-4 / atol 1e-5 (matrix products sum in
another order); key planes and scores bit-exact; table rows and the
Adagrad accumulator within the same tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.models import dlrm as jdlrm
from recommenders_addons_tpu.ops import pallas_ops
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.models import dlrm as tdlrm
from recommenders_addons_tpu_torch.train import LoopConfig, train_loop

NARROW = dict(num_sparse=4, dim=8, bottom_sizes=(16, 8), top_sizes=(16, 1),
              table_capacity=1024)
BATCH, STEPS, VOCAB = 32, 3, 300


def _batches():
    rng = np.random.default_rng(0)
    return [tdlrm.synthetic_criteo_batch(rng, BATCH, num_sparse=4,
                                         vocab_per_feature=VOCAB)
            for _ in range(STEPS)]


def test_synthetic_batches_are_the_jax_packages():
    a = tdlrm.synthetic_criteo_batch(np.random.default_rng(5), 16)
    b = jdlrm.synthetic_criteo_batch(np.random.default_rng(5), 16)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    logits = np.random.default_rng(6).normal(size=64)
    labels = (np.arange(64) % 3 == 0).astype(np.float32)
    assert tdlrm.batch_auc(logits, labels) == jdlrm.batch_auc(logits, labels)


def _train_both(monkeypatch, jtx=None, ttx=None):
    """Three steps of both packages' DLRM from the same weights and
    batches, with their default tower optimizer or ``jtx`` / ``ttx``;
    returns ``(batches, JAX model, its state, its losses, port model,
    its state, its losses)``."""
    monkeypatch.setenv("TFRA_TPU_PALLAS_INTERPRET", "1")
    # one grid step of 128 rows takes these 128-key batches (see
    # tests/test_torch_training.py: a smaller program to interpret)
    monkeypatch.setattr(pallas_ops, "_TILE", 128)
    monkeypatch.setattr(pallas_ops, "_SUB", 128)
    batches = _batches()

    jm = jdlrm.DLRM(jdlrm.DLRMConfig(**NARROW))
    jst = jm.init(jax.random.PRNGKey(0))
    jst = dataclasses.replace(
        jst, table=jde.create_slots(jm.var, jst.table, jm.opt))
    jstep, jtx = jm.make_train_step(jtx)
    jopt = jtx.init(jst.dense)
    jstep = jax.jit(jstep)
    jloss = []
    for b in batches:
        jst, jopt, loss = jstep(jst, jopt, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        jloss.append(float(loss))

    tm = tdlrm.DLRM(tdlrm.DLRMConfig(**NARROW), device="cpu")
    dense = convert.dlrm_dense_from_numpy(
        jax.device_get(jm.init(jax.random.PRNGKey(0)).dense), tm.cfg,
        device="cpu")
    table = tde.create_slots(tm.var, tm.var.init(), tm.opt)
    tstep, ttx = tm.make_train_step(ttx)
    carry = [tdlrm.DLRMState(table=table, dense=dense, step=0),
             ttx.init(list(dense.parameters()))]

    def step_fn(state, batch):
        state, carry[1], loss = tstep(state, carry[1], batch)
        return state, {"loss": loss}

    tloss = []
    tst, report = train_loop(
        step_fn, carry[0], batches, LoopConfig(steps=STEPS, log_every=1),
        on_log=lambda step, m: tloss.append(m["loss"]), device="cpu")
    assert report.steps == STEPS and tst.step == STEPS
    return batches, jm, jst, jloss, tm, tst, tloss


def test_dlrm_train_steps_match(monkeypatch):
    batches, jm, jst, jloss, tm, tst, tloss = _train_both(monkeypatch)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-5)
    got, want = convert.dlrm_dense_to_numpy(tst.dense), jst.dense
    for name in ("bottom", "top"):
        for g, w in zip(got[name], want[name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], np.asarray(w[k]),
                                           rtol=1e-4, atol=1e-5)
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst.table, f).numpy(),
                                      np.asarray(getattr(jst.table, f)),
                                      err_msg=f)
    assert tst.table.slot_names == ("accumulator",)
    np.testing.assert_allclose(tst.table.rows_logical.numpy(),
                               np.asarray(jst.table.rows_logical),
                               rtol=1e-4, atol=1e-5)
    # the predictions agree too
    b = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    np.testing.assert_allclose(
        tm.predict(tst, b).numpy(),
        np.asarray(jm.predict(jst, {k: jnp.asarray(v)
                                    for k, v in batches[0].items()})),
        rtol=1e-4, atol=1e-5)


def test_dlrm_dense_optimizer_takes_a_transform(monkeypatch):
    """``make_train_step(transforms.adam(...))`` trains the towers as the
    JAX model does with ``optax.adam``: losses within rtol 1e-5, tower
    weights within rtol 1e-4 / atol 1e-5."""
    import optax

    from recommenders_addons_tpu_torch import transforms

    _, _, jst, jloss, _, tst, tloss = _train_both(
        monkeypatch, optax.adam(0.01), transforms.adam(0.01))
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    assert tloss[-1] != tloss[0]
    got, want = convert.dlrm_dense_to_numpy(tst.dense), jst.dense
    for name in ("bottom", "top"):
        for g, w in zip(got[name], want[name]):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k], np.asarray(w[k]),
                                           rtol=1e-4, atol=1e-5)
