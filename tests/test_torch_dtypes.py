"""The port's 64-bit and bool value dtypes against the JAX package:
the key-by-value dtype matrix of ``tests/test_dtypes_and_utils.py``
(key planes, rows, found flags and looked-up values bit-exact), the
f64, int64 and bool checkpoints (files byte-identical, each package
restoring the other's), f64 training (the exact SGD step, then three
steps of SGD, Adagrad and Adam against the JAX package's XLA path), f64
initial rows, ``convert.py`` on these dtypes, the 64-bit view of the
row kernels' plain versions, and the dtype whitelist.

The JAX side is jitted; its programs are traced one by one and compiled
in threads (XLA compiles outside the interpreter lock).

Tolerances: everything bit-exact, but Adagrad and Adam rows (rtol 1e-12:
their square roots and powers may round apart) and the f64 normal and
truncated-normal rows (4 ulps: XLA's f64 ``log`` and its contraction of
the erfinv polynomial into fused multiply-adds are not reproduced).

The JAX package combines an f64 table's duplicate-id grads in float32
(``segment_sum_rows`` asks its einsum for a float32 result), the port in
float64. The duplicate batch of the training test therefore carries
grads that float32 holds exactly (multiples of 1/64), so both packages
sum the same values exactly; the port's own f64 combine is held against
numpy on arbitrary f64 grads."""

import filecmp
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import initializers as jinit
from recommenders_addons_tpu.train import checkpoint as jckpt
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.ops import hashtable as tht
from recommenders_addons_tpu_torch.ops import initializers as tinit
from recommenders_addons_tpu_torch.ops import prng
from recommenders_addons_tpu_torch.train import checkpoint as tckpt

KEY_DTYPES = ["int64", "int32"]
VALUE_DTYPES = ["float32", "bfloat16", "float16", "float64", "int32",
                "int64", "int8", "bool"]
WIDE = ["float64", "int64", "bool"]


def _bits(a) -> np.ndarray:
    """Host bits of a tensor or JAX array (16-bit floats as int16)."""
    a = tht.host_words(a) if isinstance(a, torch.Tensor) else np.asarray(a)
    return a.view(np.int16) if a.dtype.name in ("bfloat16", "float16") else a


def _compiled(jobs):
    """``{name: (fn, args)}`` -> ``{name: fn jitted for args}``: traced
    in turn, compiled in threads."""
    lowered = {k: jax.jit(fn).lower(*args) for k, (fn, args) in jobs.items()}
    with ThreadPoolExecutor(8) as ex:
        return dict(zip(lowered, ex.map(lambda lo: lo.compile(),
                                        lowered.values())))


def _to_jax(tst):
    arrays, meta = convert.table_state_to_numpy(tst)
    return jht.TableState(**{k: jnp.asarray(v) for k, v in arrays.items()},
                          **meta)


def _same_state(t, j):
    for f in ("key_lo", "key_hi", "rows", "scores"):
        np.testing.assert_array_equal(_bits(getattr(t, f)),
                                      _bits(getattr(j, f)), err_msg=f)
    assert t.slot_names == tuple(j.slot_names)


# ---------------------------------------------------------------------------
# the key x value dtype matrix
# ---------------------------------------------------------------------------


def _matrix_vals() -> np.ndarray:
    return np.tile(np.arange(1, 65, dtype=np.float32)[:, None], (1, 4))


@pytest.fixture(scope="module")
def jax_matrix():
    """Every cell's JAX upsert and lookup of 64 keys (dim 4)."""
    jobs = {}
    for kdt in KEY_DTYPES:
        for vdt in VALUE_DTYPES:
            var = jde.Variable(name=f"dt_{kdt}_{vdt}", dim=4,
                               init_capacity=1 << 9, key_dtype=kdt,
                               value_dtype=jnp.dtype(vdt))

            def f(keys, vals, var=var):
                st = var.upsert(var.init(), keys, vals)
                return (st,) + var.lookup(st, keys, return_exists=True)

            keys = jnp.arange(1, 65, dtype=kdt)
            vals = jnp.asarray(_matrix_vals()).astype(jnp.dtype(vdt))
            jobs[kdt, vdt] = (f, (keys, vals))
    fns = _compiled(jobs)
    return {k: fns[k](*args) for k, (_, args) in jobs.items()}


@pytest.mark.parametrize("kdt", KEY_DTYPES)
@pytest.mark.parametrize("vdt", VALUE_DTYPES)
def test_upsert_lookup_roundtrip(kdt, vdt, jax_matrix):
    var = tde.Variable(name=f"dt_{kdt}_{vdt}", dim=4, init_capacity=1 << 9,
                       key_dtype=kdt, value_dtype=vdt, device="cpu")
    keys = torch.arange(1, 65, dtype=tht.torch_dtype(kdt))
    vals = torch.from_numpy(_matrix_vals()).to(var.value_dtype)
    st = var.upsert(var.init(), keys, vals)
    assert int(var.size(st)) == 64
    got, found = var.lookup(st, keys, return_exists=True)
    assert got.dtype == var.value_dtype and bool(found.all())
    np.testing.assert_array_equal(_bits(got), _bits(vals))
    j_st, j_got, j_found = jax_matrix[kdt, vdt]
    assert st.rows.dtype == tht.torch_dtype(str(j_st.rows.dtype))
    _same_state(st, j_st)
    np.testing.assert_array_equal(_bits(got), _bits(j_got))
    np.testing.assert_array_equal(found.numpy(), np.asarray(j_found))
    st2 = var.remove(st, keys[:32])
    assert int(var.size(st2)) == 32
    got2, found2 = var.lookup(st2, keys, return_exists=True)
    assert not found2[:32].any() and bool(found2[32:].all())
    assert not got2[:32].to(torch.float32).any()  # the default row


def test_dtype_whitelist_raises():
    with pytest.raises(TypeError):
        tde.Variable(name="bad_k", dim=2, key_dtype=torch.float32)
    with pytest.raises(TypeError):
        tde.Variable(name="bad_v", dim=2, value_dtype=torch.complex64)
    var = tde.Variable(name="rnd_i", dim=2, value_dtype="int64",
                       device="cpu", initializer=tinit.normal(0.1))
    with pytest.raises(TypeError):  # a random initializer of ints
        var.lookup(var.init(), torch.tensor([3]), use_init_for_missing=True)


@pytest.mark.parametrize("vdt", WIDE)
def test_constant_initializer_and_missing_rows(vdt):
    """Integer and bool tables take constants (broadcast and cast, as the
    JAX package's ``materialize_rows``); misses read the default row."""
    var = tde.Variable(name=f"c_{vdt}", dim=3, init_capacity=256,
                       value_dtype=vdt, initializer=1.75, device="cpu")
    st = var.upsert(var.init(), torch.tensor([5, 6]),
                    torch.zeros((2, 3)))
    keys = torch.tensor([5, 9])
    for use_init in (False, True):
        got = var.lookup(st, keys, use_init_for_missing=use_init)
        want = np.asarray(jinit.materialize_rows(
            1.75, jax.random.PRNGKey(0), jnp.asarray([9]), 3,
            jnp.dtype(vdt)))
        np.testing.assert_array_equal(got[1].numpy(), want[0])
        assert not got[0].any()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _wide_table(vdt, name):
    var = tde.Variable(name=name, dim=4, init_capacity=1 << 9,
                       value_dtype=vdt, device="cpu")
    keys = torch.arange(1, 33)
    vals = ((torch.arange(1, 33)[:, None] % 3) * torch.ones((1, 4))
            ).to(var.value_dtype)
    return var, var.upsert(var.init(), keys, vals, step=3), keys, vals


@pytest.mark.parametrize("vdt", WIDE)
def test_wide_dtype_checkpoint_roundtrip(tmp_path, vdt, monkeypatch):
    # the JAX restore calls import_batch eagerly, which compiles every
    # operation on its own: one jitted call instead
    orig = jde.Variable.import_batch

    def import_batch(self, state, keys, values, scores=None,
                     slot_rows=None):
        return jax.jit(lambda *a: orig(self, *a))(state, keys, values,
                                                  scores, slot_rows)

    monkeypatch.setattr(jde.Variable, "import_batch", import_batch)
    name = f"dt_ckpt_{vdt}"
    var, st, keys, vals = _wide_table(vdt, name)
    jvar = jde.Variable(name=name, dim=4, init_capacity=1 << 9,
                        value_dtype=jnp.dtype(vdt))
    tdir = tckpt.save_dynamic_embedding(var, st, str(tmp_path / "t"))
    jdir = jckpt.save_dynamic_embedding(jvar, _to_jax(st),
                                        str(tmp_path / "j"))
    files = sorted(f for f in os.listdir(tdir) if not f.endswith(".json"))
    assert files == sorted(f for f in os.listdir(jdir)
                           if not f.endswith(".json"))
    assert files
    for f in files:
        assert filecmp.cmp(os.path.join(tdir, f), os.path.join(jdir, f),
                           shallow=False), f

    # each package restores the other's files, to the same planes
    t_from_j = tckpt.load_dynamic_embedding(var, var.init(),
                                            str(tmp_path / "j"))
    j_from_t = jckpt.load_dynamic_embedding(jvar, jvar.init(),
                                            str(tmp_path / "t"))
    _same_state(t_from_j, j_from_t)
    got, found = var.lookup(t_from_j, keys, return_exists=True)
    assert bool(found.all())
    np.testing.assert_array_equal(got.numpy(), vals.numpy())


@pytest.mark.parametrize("vdt", WIDE)
def test_convert_carries_wide_tables(vdt):
    var, st, keys, vals = _wide_table(vdt, f"cv_{vdt}")
    arrays, meta = convert.table_state_to_numpy(st)
    assert arrays["rows"].dtype == np.dtype(vdt)
    back = convert.table_state_from_numpy(arrays, meta, device="cpu")
    _same_state(back, _to_jax(st))
    got = var.lookup(back, keys)
    np.testing.assert_array_equal(got.numpy(), vals.numpy())


# ---------------------------------------------------------------------------
# f64 training
# ---------------------------------------------------------------------------


def test_float64_training_step_exact():
    var = tde.Variable(name="dt_f64_train", dim=4, init_capacity=1 << 9,
                       value_dtype=torch.float64, initializer=0.125,
                       device="cpu")
    state = var.init()
    emb, ctx = var.embedding_lookup(state, torch.tensor([7, 11, 7]))
    assert emb.dtype == torch.float64
    state = var.apply_gradients(state, ctx, torch.ones_like(emb),
                                tde.SGD(0.5), step=0)
    got = var.lookup(state, torch.tensor([7, 11])).numpy()
    # id 7 twice: 0.125 - 0.5*2 = -0.875; id 11 once: 0.125 - 0.5
    np.testing.assert_allclose(got[0], -0.875, rtol=0, atol=0)
    np.testing.assert_allclose(got[1], -0.375, rtol=0, atol=0)


def test_float64_combine_is_exact_in_order():
    rng = np.random.default_rng(4)
    g = rng.standard_normal((300, 5)) * 10.0 ** rng.integers(-8, 8, (300, 1))
    seg = rng.integers(-2, 40, 300)
    want = np.zeros((40, 5))
    for i in range(300):  # numpy's f64 adds, in batch order
        if 0 <= seg[i] < 40:
            want[seg[i]] += g[i]
    got = tht.segment_sum_rows(torch.from_numpy(g), torch.from_numpy(seg),
                               40)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), want)


def _train_batches():
    """Three batches of 64 ids: all misses (f64 grads), duplicates with
    hits and misses (grads in 1/64 steps), distinct hits and misses (f64
    grads)."""
    rng = np.random.default_rng(7)
    ids = [rng.permutation(np.arange(1, 81))[:64],
           rng.integers(60, 100, 64),
           rng.permutation(np.arange(50, 150))[:64]]
    grads = [rng.standard_normal((64, 8)),
             rng.integers(-64, 64, (64, 8)) / 64.0,
             rng.standard_normal((64, 8))]
    return [(i.astype(np.int64), g) for i, g in zip(ids, grads)]


OPTIMIZERS = {
    "sgd": (lambda m: m.SGD(0.25), 0.0),
    "adagrad": (lambda m: m.Adagrad(0.1), 1e-12),
    "adam": (lambda m: m.Adam(0.05), 1e-12),
}


@pytest.fixture(scope="module")
def jax_f64_training():
    """Each optimizer's three JAX steps (XLA path), one jitted step
    function each."""
    jobs, vars_ = {}, {}
    for name, (make, _) in OPTIMIZERS.items():
        var = jde.Variable(name=f"f64_{name}", dim=8, init_capacity=1 << 10,
                           value_dtype=jnp.float64,
                           initializer=jax.nn.initializers.uniform(0.5))
        opt = make(jde)

        def step(state, ids, grads, t, var=var, opt=opt):
            emb, ctx = var.embedding_lookup(state, ids)
            return var.apply_gradients(state, ctx, grads, opt, step=t)

        st = jde.create_slots(var, var.init(), opt)
        vars_[name] = (var, st)
        ids, g = _train_batches()[0]
        jobs[name] = (step, (st, jnp.asarray(ids), jnp.asarray(g),
                             jnp.asarray(0)))
    steps = _compiled(jobs)
    out = {}
    for name, (var, st) in vars_.items():
        for t, (ids, g) in enumerate(_train_batches()):
            st = steps[name](st, jnp.asarray(ids), jnp.asarray(g),
                             jnp.asarray(t))
        out[name] = st
    return out


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_float64_training_against_jax(name, jax_f64_training):
    make, rtol = OPTIMIZERS[name]
    var = tde.Variable(name=f"f64_{name}", dim=8, init_capacity=1 << 10,
                       value_dtype=torch.float64,
                       initializer=tinit.uniform(0.5), device="cpu")
    opt = make(tde)
    st = tde.create_slots(var, var.init(), opt)
    for t, (ids, g) in enumerate(_train_batches()):
        emb, ctx = var.embedding_lookup(st, torch.from_numpy(ids))
        assert emb.dtype == torch.float64
        st = var.apply_gradients(st, ctx, torch.from_numpy(g), opt, step=t)
    j = jax_f64_training[name]
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    got = st.rows_logical.numpy()
    want = np.asarray(jht._to_logical_rows(j.rows, jnp.float64, j.capacity,
                                           got.shape[1]))
    if rtol:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# f64 initial rows
# ---------------------------------------------------------------------------


def _ulps64(a: np.ndarray, b: np.ndarray) -> int:
    def ordered(x):
        i = x.view(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFFFFFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("kind,ulps", [("uniform", 0), ("normal", 4),
                                       ("truncated_normal", 4)])
def test_float64_initial_rows(kind, ulps):
    keys = (np.arange(-40, 4000, dtype=np.int64) * 7919) ^ (1 << 40)
    args = {"uniform": (0.5,), "normal": (0.3,),
            "truncated_normal": (1.0,)}[kind]
    kw = {"truncated_normal": {"lower": -0.5, "upper": 3.0}}.get(kind, {})
    want = np.asarray(jinit.materialize_rows(
        getattr(jax.nn.initializers, kind)(*args, **kw),
        jax.random.PRNGKey(11), jnp.asarray(keys), 16, jnp.float64))
    got = tinit.materialize_rows(
        getattr(tinit, kind)(*args, **kw), prng.PRNGKey(11),
        torch.from_numpy(keys), 16, torch.float64)
    assert got.dtype == torch.float64
    assert _ulps64(got.numpy(), want) <= ulps


def test_random_bits_64():
    for seed in (0, 2**40 + 7):
        want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), (3, 5),
                                          jnp.uint64)).view(np.int64)
        got = prng.random_bits(prng.PRNGKey(seed), (3, 5), 64)
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the 64-bit view of the row kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dt", [torch.float64, torch.int64])
def test_row_kernels_64bit_view(dt):
    cap, ch = 6, 3
    rng = np.random.default_rng(2)
    bits = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                        size=((cap + 1) * ch, 128), dtype=np.int64)
    table = torch.from_numpy(bits.copy()).view(dt)
    logical = bits.reshape(cap + 1, ch * 128)
    idx = torch.tensor([4, 0, -1, 6, 9, 2], dtype=torch.int32)
    safe = np.clip(idx.numpy(), 0, cap)
    for vc in (1, 2, ch):  # vc < ch: each row's leading chunks
        got = cuda_ops.gather_rows_2d(table, ch, idx, cap=cap, vc=vc)
        assert got.dtype == dt and got.shape == (6, vc * 128)
        want = logical[safe, :vc * 128].copy()
        want[(idx.numpy() < 0) | (idx.numpy() >= cap)] = 0
        np.testing.assert_array_equal(got.view(torch.int64).numpy(), want)
    flat = cuda_ops.gather_rows_2d(table, ch, idx, masked=False, flat=True)
    np.testing.assert_array_equal(flat.view(torch.int64).numpy(),
                                  logical[safe].reshape(-1, 128))

    rows = rng.integers(-99, 99, size=(6, ch * 128), dtype=np.int64)
    out = cuda_ops.scatter_rows_set_2d(table, ch, idx,
                                       torch.from_numpy(rows).view(dt),
                                       cap=cap)
    assert out is table
    now = table.view(torch.int64).numpy().reshape(cap + 1, ch * 128)
    for i, s in enumerate(idx.tolist()):
        if 0 <= s < cap:
            np.testing.assert_array_equal(now[s], rows[i])
    # invalid indices land on the trash row, logical row ``cap``: each
    # of its words is one of theirs (the writes race, so rows may mix)
    untouched = [r for r in range(cap) if r not in idx.tolist()]
    np.testing.assert_array_equal(now[untouched], logical[untouched])
    assert ((now[cap] == rows[[2, 3, 4]]).any(axis=0)).all()
