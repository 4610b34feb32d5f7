"""The port's KV-native checkpoints against the JAX package's: the same
sidecar files byte for byte, each package restoring the other's
checkpoint (a 4-shard one of a JAX ``ShardedVariable`` into one port
table included), and the port's own surface on them: ``DECheckpoint``
with dense entries on a narrow DLRM, ``keep=`` sweeps,
``latest_checkpoint``, the structure guard, ``warm_start``,
``de_save_model`` / ``de_load_model``, the callbacks and ``DEHvdSaver``.

Tables are filled by the port (its plain versions on the CPU) and
carried to the JAX package as arrays (capacity 1,024, dim 8). Restored
tables are compared key by key (keys, values, scores, slot rows: all
bit-exact), and where both packages restore the same files, plane by
plane.
"""

import filecmp
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.parallel.sharded import ShardedVariable
from recommenders_addons_tpu.train import checkpoint as jckpt
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.keras import callbacks as tcallbacks
from recommenders_addons_tpu_torch.keras import models as tmodels
from recommenders_addons_tpu_torch.models import dlrm
from recommenders_addons_tpu_torch.ops import hashtable as tht
from recommenders_addons_tpu_torch.train import checkpoint as tckpt
from recommenders_addons_tpu_torch.train.saver import DEHvdSaver

DIM = 8
CAP = 1024
N_FILL = 700


def _to_jax(tst):
    arrays, meta = convert.table_state_to_numpy(tst)
    return jht.TableState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          **meta)


def _per_key(state):
    """``{column: numpy}`` of the live rows sorted by key (16-bit values
    as their int16 words); works on either package's state."""
    keys = np.asarray(state.keys)
    mask = np.asarray(state.key_lo != 0) | np.asarray(
        state.key_hi != np.iinfo(np.int32).min)
    order = np.argsort(keys[mask], kind="stable")

    def col(a):
        if isinstance(a, torch.Tensor):
            a = (a.view(torch.int16) if a.dtype == torch.bfloat16
                 else a).numpy()
        else:
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                a = a.view(np.int16)
        return a[mask][order]

    out = {"keys": keys[mask][order], "scores": col(state.scores),
           "values": col(state.values)}
    for nm, c in state.slots.items():
        out[f"slot.{nm}"] = col(c)
    return out


def _assert_per_key(got, want):
    a, b = _per_key(got), _per_key(want)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_planes(tst, jst):
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    n = tst.capacity * tst.chunks
    np.testing.assert_array_equal(tst.rows[:n].numpy().view(np.int32),
                                  np.asarray(jst.rows)[:n].view(np.int32))


CASES = {
    # f32 with Adam's two slot columns; bf16 with Adagrad's accumulator
    "f32-adam": (torch.float32, tde.Adam(0.001)),
    "bf16-adagrad": (torch.bfloat16, tde.Adagrad(0.01)),
}


def _filled(case="f32-adam", name="pt", seed=0):
    value_dtype, opt = CASES[case]
    rng = np.random.default_rng(seed)
    kw = dict(name=name, dim=DIM, init_capacity=CAP)
    tv = tde.Variable(value_dtype=value_dtype, device="cpu", **kw)
    jv = jvar.Variable(value_dtype=tht.dtype_name(value_dtype), **kw)
    st = tde.create_slots(tv, tv.init(), opt)
    keys = rng.choice(1 << 40, size=N_FILL, replace=False).astype(np.int64)
    keys[:3] = (-5, -(1 << 62), 1)  # negative keys round-trip too

    def rows():
        return torch.from_numpy(rng.normal(size=(N_FILL, DIM)).astype(
            np.float32))

    st = tv.import_batch(
        st, torch.from_numpy(keys), rows(),
        scores=torch.from_numpy(rng.integers(0, 50, N_FILL).astype(np.int32)),
        slot_rows={nm: rows() for nm in st.slot_names})
    return tv, jv, st


def _jit_jax_import(monkeypatch):
    """``jvar.Variable.import_batch`` jitted once per Variable (the JAX
    restore calls it eagerly, which compiles every operation on its
    own)."""
    orig = jvar.Variable.import_batch
    cache = {}

    def call(self, state, keys, values, scores=None, slot_rows=None):
        _, f = cache.setdefault(id(self), (self, jax.jit(
            lambda *a: orig(self, *a))))
        return f(state, keys, values, scores, slot_rows)

    monkeypatch.setattr(jvar.Variable, "import_batch", call)


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("case", list(CASES))
def test_checkpoint_files_byte_identical(case, tmp_path):
    """The same table saved by both packages: the same file names and
    bytes, meta JSON included (the port's in 100-row write chunks)."""
    tv, jv, st = _filled(case)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_dynamic_embedding(tv, st, a, global_step=7, buffer_size=100)
    jckpt.save_dynamic_embedding(jv, _to_jax(st), b, global_step=7)
    names = _files(a)
    assert names == _files(b)
    assert len(names) == 3 + len(st.slot_names) + 1
    match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert match == names, (mismatch, errors)


@pytest.mark.parametrize("case", list(CASES))
def test_each_package_restores_the_others(case, tmp_path, monkeypatch):
    """JAX writes, the port reads; the port writes, JAX reads: key by key
    equal to the saved table, and the two restores of one checkpoint
    plane by plane equal."""
    _jit_jax_import(monkeypatch)
    tv, jv, st = _filled(case)
    jst = _to_jax(st)
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    tckpt.save_dynamic_embedding(tv, st, a)
    jckpt.save_dynamic_embedding(jv, jst, b)
    t_from_j = tckpt.load_dynamic_embedding(tv, tv.init(), b,
                                            buffer_size=256)
    j_from_t = jckpt.load_dynamic_embedding(
        jv, jv.init(), a, buffer_size=N_FILL // 2)
    _assert_per_key(t_from_j, st)
    _assert_per_key(j_from_t, jst)
    _assert_planes(t_from_j, j_from_t)
    assert t_from_j.slot_inits == st.slot_inits


def test_elastic_restore_of_a_four_shard_jax_checkpoint(tmp_path):
    """A JAX ``ShardedVariable`` on 4 CPU devices saves 4 shard file sets
    (``_mht_1of4`` ... ``4of4``); one port table restores all of them,
    and a spill-tier dump beside them merges in with a warning."""
    mesh = Mesh(np.array(jax.devices()[:4]), ("ep",))
    jv = jvar.Variable(name="el", dim=DIM, init_capacity=CAP)
    sv = ShardedVariable(var=jv, mesh=mesh, axis="ep")
    keys = np.arange(1, 301, dtype=np.int64) * 7919
    vals = np.stack([keys, -keys] * (DIM // 2), 1).astype(np.float32)
    sst = jax.jit(lambda s, k, v: sv.upsert(s, k, v, step=3))(
        sv.init(), jnp.asarray(keys), jnp.asarray(vals))
    jckpt.save_dynamic_embedding(sv, sst, str(tmp_path))
    vdir = tmp_path / jckpt.DE_DIR_NAME / "el"
    assert len(list(vdir.glob("*-keys"))) == 4
    tv = tde.Variable(name="el", dim=DIM, init_capacity=CAP, device="cpu")
    got = tckpt.load_dynamic_embedding(tv, tv.init(), str(tmp_path),
                                       buffer_size=64)
    assert int(tv.size(got)) == 300
    rows, found = tv.lookup(got, torch.from_numpy(keys), return_exists=True)
    assert bool(found.all())
    np.testing.assert_array_equal(rows.numpy(), vals)
    np.testing.assert_array_equal(tv.export_keys_and_scores(got)[1][
        tht.occupancy_mask(tv.spec, got)].numpy(), 3)
    # rows of a spill tier (here: another table's shard files) merge in
    other = tde.Variable(name="el", dim=DIM, init_capacity=CAP,
                         device="cpu")
    extra = other.upsert(other.init(), torch.tensor([5, 6]),
                         torch.ones(2, DIM))
    tier = str(tmp_path / "tier_src")
    tckpt.save_dynamic_embedding(other, extra, tier)
    shutil.copytree(os.path.join(tier, tckpt.DE_DIR_NAME, "el"),
                    str(vdir / "tier"))
    with pytest.warns(UserWarning, match="spill-tier rows"):
        got = tckpt.load_dynamic_embedding(tv, tv.init(), str(tmp_path))
    assert int(tv.size(got)) == 302
    # given a tier, its rows go to the tier's store instead
    tier = tde.SpillTier(tv, store=tde.HostKVStore(DIM))
    got = tckpt.load_dynamic_embedding(tv, tv.init(), str(tmp_path),
                                       tier=tier)
    assert int(tv.size(got)) == 300
    assert sorted(tier.store.export_all()[0].tolist()) == [5, 6]


def _dlrm_run(seed=0):
    cfg = dlrm.DLRMConfig(num_sparse=4, dim=DIM, bottom_sizes=(16, DIM),
                          top_sizes=(16, 1), table_capacity=CAP)
    model = dlrm.DLRM(cfg, device="cpu")
    state = model.init(seed)
    state.table = tde.create_slots(model.var, state.table, model.opt)
    step, tx = model.make_train_step()
    return model, state, step, tx.init(list(state.dense.parameters()))


def test_decheckpoint_dlrm_roundtrip(tmp_path):
    """A narrow port DLRM trains 2 steps and is saved at steps 1 and 2
    with ``keep=1`` (step 1 swept); a fresh model restores step 2 (the
    latest): table key by key and dense leaves bit-equal, and one more
    step from each gives the same loss and table."""
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(v) for k, v in dlrm.synthetic_criteo_batch(
        rng, 32, num_sparse=4, vocab_per_feature=300).items()}
        for _ in range(3)]
    model, state, step, opt = _dlrm_run()
    ckpt = tde.train.DECheckpoint(table=model.var, dense=None, opt=None)
    d = str(tmp_path)
    for i in (1, 2):
        state, opt, _ = step(state, opt, batches[i - 1])
        ckpt.save(d, {"table": state.table, "dense": state.dense,
                      "opt": opt}, step=i, keep=1)
    assert tckpt.latest_checkpoint(d) == 2
    assert sorted(os.listdir(d)) == [f"{tckpt.DE_DIR_NAME}-2",
                                     "dense-2.npz"]
    model2, fresh, step2, opt2 = _dlrm_run(seed=1)
    out = ckpt.restore(d, {"table": fresh.table, "dense": fresh.dense,
                           "opt": opt2})
    _assert_per_key(out["table"], state.table)
    for a, b in zip(out["dense"].state_dict().values(),
                    state.dense.state_dict().values()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(out["opt"], opt))
    restored = dlrm.DLRMState(table=out["table"], dense=out["dense"],
                              step=state.step)
    s1, _, l1 = step(state, opt, batches[2])
    s2, _, l2 = step2(restored, out["opt"], batches[2])
    assert float(l1) == float(l2)
    _assert_per_key(s2.table, s1.table)
    # the structure guard: a changed dense entry must not load
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(d, {"table": fresh.table, "dense": fresh.dense,
                         "opt": opt2[:-1]})
    with pytest.raises(ValueError, match="structure"):
        ckpt.restore(d, {"table": fresh.table, "dense": fresh.dense,
                         "opt": tuple(opt2)})
    with pytest.raises(FileNotFoundError):
        tckpt.latest_checkpoint(str(tmp_path / "nothing"))


def test_warm_start_keras_models_callbacks_and_saver(tmp_path):
    tv, _, st = _filled(name="old")
    d = str(tmp_path / "ws")
    tckpt.save_dynamic_embedding(tv, st, d, global_step=4)
    new = tde.Variable(name="new", dim=DIM, init_capacity=CAP, device="cpu")
    skip = tde.Variable(name="skip", dim=DIM, init_capacity=CAP,
                        device="cpu")
    empty = skip.init()
    out = tde.warm_start({new: new.init(), skip: empty}, d,
                         vars_to_warm_start=["new"],
                         var_name_to_prev_var_name={"new": "old"})
    _assert_per_key(out[new], st)
    assert out[skip] is empty
    hook = tde.WarmStartHook(d, "ne.*",
                             var_name_to_prev_var_name={"new": "old"})
    _assert_per_key(hook({new: new.init()})[new], st)

    towers = torch.nn.Linear(3, 2)
    m = str(tmp_path / "model")
    tmodels.de_save_model(m, {"t": st, "w": towers}, t=tv, w=None)
    assert os.path.exists(os.path.join(m, "dense.npz"))
    fresh = torch.nn.Linear(3, 2)
    back = tmodels.de_load_model(m, {"t": tv.init(), "w": fresh}, t=tv,
                                 w=None)
    _assert_per_key(back["t"], st)
    assert torch.equal(fresh.weight, towers.weight)
    assert tmodels.de_hvd_save_model is tmodels.de_save_model

    c = str(tmp_path / "cb")
    cb = tcallbacks.DEHvdModelCheckpoint(c, save_freq=2, keep=2, t=tv)
    for s in range(1, 7):
        cb.on_step_end(s, {"t": st})
    assert sorted(os.listdir(c)) == [f"{tckpt.DE_DIR_NAME}-4",
                                     f"{tckpt.DE_DIR_NAME}-6"]
    bc = tcallbacks.DEHvdBroadcastGlobalVariablesCallback(
        local_variables="['stats']")
    assert bc({"t": st}) == {"t": st} and bc.broadcast_done
    # one process holds the one copy: an in-process mesh broadcasts
    # nothing (tests/test_torch_multiprocess.py broadcasts over gloo)
    from recommenders_addons_tpu_torch import parallel as tpar

    assert bc({"t": st}, mesh=tpar.create_mesh(devices=["cpu"] * 2)) == {
        "t": st}

    saver = DEHvdSaver(rank=0, size=1, t=tv)
    s = str(tmp_path / "saver")
    saver.save(s, {"t": st}, global_step=9)
    _assert_per_key(saver.restore(s, {"t": tv.init()})["t"], st)
    tables = [tde.HkvHashTable(dim=DIM, init_capacity=CAP, device="cpu",
                               name="tbl") for _ in range(2)]
    tables[0].insert(np.arange(1, 50), np.ones((49, DIM), np.float32))
    tables[0].save_to_file_system(str(tmp_path / "api"))
    tables[1].load_from_file_system(str(tmp_path / "api"))
    _assert_per_key(tables[1].state, tables[0].state)
