"""The port's training path against the JAX package's, on the same inputs:
threefry bits and per-key initial rows, the training lookup's plan
(``plan_lookup_train``), and lookup + apply steps for every named
optimizer, f32 and bf16.

The JAX side runs jitted on the CPU, through its XLA path, or through its
fused Pallas apply in the interpreter (``TFRA_TPU_PALLAS_INTERPRET=1``).
The port runs its plain PyTorch versions; it always takes its fused path,
whose plain version is the same tile math. Integer outputs (plans, key
planes, scores) must be bit-exact; f32 values and slots match within
rtol 1e-5 / atol 1e-6 (sums over duplicate ids are taken in another
order); bf16 values within one bf16 ulp; ``normal`` initial rows within
rtol 1e-6 (the port evaluates XLA's erfinv polynomial with torch's log1p).

Tables are small (bucket size 64, capacity <= 1024), so batches overflow
buckets and evict.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import pallas_ops
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu.ops import initializers as jinit
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.ops import cuda_ops
from recommenders_addons_tpu_torch.ops import hashtable as tht
from recommenders_addons_tpu_torch.ops import initializers as tinit
from recommenders_addons_tpu_torch.ops import prng

OPTIMIZERS = ("SGD", "Momentum", "Adagrad", "Adam", "AdamW", "RMSprop",
              "FTRL")
DIM = 8


def _carry(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.table_state_from_numpy(arrays, meta, device="cpu")


def _u32(a):
    return np.asarray(a).astype(np.int64)


def _interpret(monkeypatch):
    """The JAX package's Pallas kernels through the interpreter. The row
    tile (and the fused kernel's sub-chunk) is cut from 1024 (64) to 128
    rows: it only sets how many rows one grid step takes (these batches
    fit one tile either way), and the interpreter's program is then
    several times smaller to compile."""
    monkeypatch.setenv("TFRA_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setattr(pallas_ops, "_TILE", 128)
    monkeypatch.setattr(pallas_ops, "_SUB", 128)


# ---------------------------------------------------------------------------
# threefry and initial rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3141592653, (1 << 40) + 5])
def test_threefry_keys_fold_in_and_bits_are_bit_exact(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(tk.numpy(), _u32(jk))
    data = np.array([0, 1, 7, 2**31, 2**32 - 1, 123456789], np.uint32)
    for d in data:
        np.testing.assert_array_equal(
            prng.fold_in(tk, torch.tensor(int(d))).numpy(),
            _u32(jax.random.fold_in(jk, d)))
    np.testing.assert_array_equal(
        prng.random_bits(tk, (5, 7)).numpy(),
        _u32(jax.random.bits(jk, (5, 7), jnp.uint32)))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_initial_rows_match(dt):
    rng = np.random.default_rng(0)
    keys = rng.integers(-2**63, 2**63 - 1, size=300, dtype=np.int64)
    keys[:4] = [0, 1, -1, 2**40]
    jk, tk = jax.random.PRNGKey(77), prng.PRNGKey(77)
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    np.testing.assert_array_equal(
        tinit.per_key_rngs(tk, torch.from_numpy(keys)).numpy(),
        _u32(jinit.per_key_rngs(jk, jnp.asarray(keys))))
    uni = tinit.materialize_rows(tinit.uniform(0.05), tk,
                                 torch.from_numpy(keys), 16, tdt)
    want = jinit.materialize_rows(jax.nn.initializers.uniform(0.05), jk,
                                  jnp.asarray(keys), 16, jdt)
    np.testing.assert_array_equal(uni.float().numpy(),
                                  np.asarray(want).astype(np.float32))
    nrm = tinit.materialize_rows(tinit.normal(0.05), tk,
                                 torch.from_numpy(keys), 16, tdt)
    want = jinit.materialize_rows(jax.nn.initializers.normal(0.05), jk,
                                  jnp.asarray(keys), 16, jdt)
    np.testing.assert_allclose(nrm.float().numpy(),
                               np.asarray(want).astype(np.float32),
                               rtol=1e-6, atol=0)
    k32 = keys.astype(np.int32)
    np.testing.assert_array_equal(
        tinit.materialize_rows(tinit.uniform(1.0), tk,
                               torch.from_numpy(k32), 8, tdt).float().numpy(),
        np.asarray(jinit.materialize_rows(
            jax.nn.initializers.uniform(1.0), jk, jnp.asarray(k32), 8,
            jdt)).astype(np.float32))


# ---------------------------------------------------------------------------
# the training lookup's plan
# ---------------------------------------------------------------------------


_PLAN_N = 256  # every case's batch length: one JAX compile serves all


@functools.lru_cache(maxsize=None)
def _plan_setup():
    """A 256-slot table (4 buckets) prefilled with 180 keys, both
    packages' Variables, the jitted JAX plans, and the keys of each case."""
    rng = np.random.default_rng(3)
    pre = np.unique(rng.integers(1, 5000, size=180)).astype(np.int64)
    rng.shuffle(pre)
    jv = jvar.Variable(name="plan", dim=DIM, init_capacity=256,
                       initializer=jax.nn.initializers.uniform(0.05))
    tv = tde.Variable(name="plan", dim=DIM, init_capacity=256,
                      initializer=tinit.uniform(0.05), device="cpu")
    jst = jv.upsert(jv.init(), jnp.asarray(pre), jnp.asarray(
        rng.normal(size=(len(pre), DIM)), jnp.float32), step=1)

    def init_fn(u):
        return jinit.materialize_rows(jv.initializer, jv._rng(), u, DIM,
                                      jnp.float32)

    plans = {
        None: jax.jit(lambda st, k: jht.plan_lookup_train(
            jv.spec, st, k, init_fn)),
        5: jax.jit(lambda st, k: jht.plan_lookup_train(
            jv.spec, st, k, init_fn, score_const=jnp.int32(5))),
    }
    fresh = np.arange(9000, 9000 + _PLAN_N, dtype=np.int64)
    batches = {
        "hit": rng.choice(pre, _PLAN_N),  # duplicates included
        "hit_unique": np.resize(pre, _PLAN_N)[:len(pre)],
        "miss": np.concatenate([pre[:_PLAN_N // 2],
                                fresh[:_PLAN_N // 4], pre[:_PLAN_N // 4]]),
        "miss_evict": rng.integers(1, 20000, size=_PLAN_N),
    }
    return pre, jv, tv, jst, plans, batches


def _same_plans(got, want):
    """Two ``plan_lookup_train`` results bit for bit: the plan, the flags,
    the key and score planes and the WHOLE packed block, every row."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(g, tuple):
            _same_plans(g, w)
        elif isinstance(g, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape
            bits = torch.int16 if g.element_size() == 2 else None
            assert torch.equal(g.view(bits) if bits else g,
                               w.view(bits) if bits else w)
        else:
            assert g == w


@pytest.mark.parametrize("case", ["hit", "hit_unique", "miss",
                                  "miss_evict"])
def test_plan_lookup_train_is_bit_exact(case):
    """Against the JAX plan, with the initializer as a plain function and
    as the Variable's ``RowInit`` (the miss branch's init_rows path).
    Between the two forms the whole packed block is compared, on the
    carried f32 table (logical layout) and on a bf16 copy with a slot
    column (physical layout, fresh slot fills)."""
    pre, jv, tv, jst, plans, batches = _plan_setup()
    keys = np.resize(batches[case].astype(np.int64), _PLAN_N)
    if case == "hit_unique":  # dup-free: pad with EMPTY ids
        keys[len(pre):] = jv.empty_key
    tst = _carry(jst)

    def tinit_fn(u):
        return tinit.materialize_rows(tv.initializer, tv._rng(), u, DIM,
                                      torch.float32)

    forms = [tinit_fn, tv.row_init("cpu")]
    tvb = tde.Variable(name="plan", dim=DIM, init_capacity=256,
                       value_dtype=torch.bfloat16,
                       initializer=tinit.uniform(0.05), device="cpu")
    stb = tht.with_slot(tvb.upsert(tvb.init(), torch.from_numpy(pre),
                                   tst.values[:len(pre)].bfloat16(), step=1),
                        "accumulator", 0.1)
    assert tht.phys_packed_ok(stb)

    def tinit_bf16(u):
        return tinit.materialize_rows(tvb.initializer, tvb._rng(), u, DIM,
                                      torch.bfloat16)

    for sc in (None, 5):
        want = plans[sc](jst, jnp.asarray(keys))
        outs = [tht.plan_lookup_train(tv.spec, tst, torch.from_numpy(keys),
                                      f, score_const=sc) for f in forms]
        _same_plans(outs[1], outs[0])
        _same_plans(*(tht.plan_lookup_train(
            tvb.spec, stb, torch.from_numpy(keys), f, score_const=sc)
            for f in (tvb.row_init("cpu"), tinit_bf16)))
        got = outs[1]
        assert len(got) == len(want)
        for name, i in (("uniq", 0), ("inverse", 1), ("key_lo", 6),
                        ("key_hi", 7)) + ((("scores", 8),) if sc else ()):
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]),
                                          err_msg=name)
        for name, g, w in zip(("slot", "found", "inserted", "dropped"),
                              got[2], want[2]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                          err_msg=name)
        assert got[4] == bool(want[4]) and got[5] == bool(want[5])
        # the blended value rows: stored rows and uniform init rows
        rep = np.asarray(want[2][1]) | np.asarray(want[2][2])
        np.testing.assert_array_equal(
            tht.packed_value_rows(tst, len(keys), got[3]).numpy()[rep],
            np.asarray(want[3])[:, :DIM][rep])
    found, inserted, dropped = (np.asarray(w) for w in want[2][1:])
    if case.startswith("hit"):
        assert found.any() and not inserted.any()
        assert want[4] == (case == "hit_unique")
    else:
        assert inserted.any() and not want[4]
    if case == "miss_evict":  # victims replaced, and more than fit dropped
        assert dropped.any()
        victims = np.asarray(jst.keys)[np.asarray(want[2][0])[inserted]]
        assert (victims != jv.empty_key).any()


@pytest.mark.parametrize("kdt", ["int64", "int32"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("init", ["uniform", "normal"])
def test_row_init_blend_matches_the_function_path(init, dt, kdt,
                                                  monkeypatch):
    """The miss branch with the Variable's ``RowInit`` (which goes through
    ``cuda_ops.init_rows``, here its plain version) against the same
    branch with the initializer as a plain function (every position's row
    drawn, then blended): every output and the whole packed block bit for
    bit, on a 256-slot table with an Adagrad slot column, prefilled, and a
    batch of hits, new keys, duplicates, EMPTY ids and evictions."""
    tdt, kt = getattr(torch, dt), getattr(torch, kdt)
    tv = tde.Variable(name=f"blend_{init}", dim=DIM, init_capacity=256,
                      key_dtype=kt, value_dtype=tdt,
                      initializer=getattr(tinit, init)(0.05), device="cpu")
    rng = np.random.default_rng(5)
    info = np.iinfo(np.int64 if kdt == "int64" else np.int32)
    pre = np.unique(rng.integers(info.min + 1, info.max, size=200))
    st = tv.upsert(tv.init(), torch.from_numpy(pre).to(kt),
                   torch.from_numpy(rng.normal(size=(len(pre), DIM))
                                    ).to(tdt), step=1)
    st = tht.with_slot(st, "accumulator", 0.1)
    keys = np.concatenate([pre[:64], pre[:32],  # hits and duplicates
                           rng.integers(info.min + 1, info.max, size=144),
                           np.full(16, tv.empty_key)]).astype(info.dtype)
    keys = torch.from_numpy(rng.permutation(keys)).to(kt)
    calls = []
    plain = cuda_ops.init_rows_plain
    monkeypatch.setattr(cuda_ops, "init_rows_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))

    def init_fn(u):
        return tinit.materialize_rows(tv.initializer, tv._rng(), u, DIM, tdt)

    got = tht.plan_lookup_train(tv.spec, st, keys, tv.row_init("cpu"),
                                score_const=3)
    want = tht.plan_lookup_train(tv.spec, st, keys, init_fn, score_const=3)
    assert calls == [1]
    _same_plans(got, want)
    slot, found, inserted, _ = got[2]
    assert found.any() and not got[4]  # hits, duplicates
    victims = st.keys[slot[inserted].long()]
    assert (victims == tv.empty_key).any() and (victims != tv.empty_key).any()


@pytest.mark.parametrize("what", ["truncated_normal", "constant", "float64"])
def test_row_init_outside_the_kernel_takes_the_function_path(what,
                                                             monkeypatch):
    """Initializers and dtypes the init_rows kernel does not cover draw
    every position's row as before (``hashtable.init_missing_rows``)."""
    init = {"truncated_normal": tinit.truncated_normal(0.05),
            "constant": 0.25, "float64": tinit.uniform(0.05)}[what]
    tdt = torch.float64 if what == "float64" else torch.float32
    tv = tde.Variable(name="outside", dim=DIM, init_capacity=256,
                      value_dtype=tdt, initializer=init, device="cpu")
    monkeypatch.setattr(cuda_ops, "init_rows", None)  # must not be reached
    keys = torch.arange(1, 300, dtype=torch.int64)
    got = tht.plan_lookup_train(tv.spec, tv.init(), keys, tv.row_init("cpu"))
    want = tinit.materialize_rows(init, tv._rng(), got[0], DIM, tdt)
    rows = tht.packed_value_rows(tv.init(), len(keys), got[3])
    assert torch.equal(rows[got[2][2]], want[got[2][2]])


# ---------------------------------------------------------------------------
# lookup + apply, every named optimizer
# ---------------------------------------------------------------------------


def _train_both(name, dt="float32", steps=3, lookup_step_ahead=0,
                unique=False):
    """``steps`` lookup + apply steps on both packages from the same empty
    table; returns both final states. Batches mix hits, misses, duplicates
    (unless ``unique``) and, once the 256 slots fill, evictions."""
    jdt, tdt = jnp.dtype(dt), getattr(torch, dt)
    jo, to = getattr(jde, name)(0.05), getattr(tde, name)(0.05)
    jv = jvar.Variable(name="train", dim=DIM, init_capacity=256,
                       value_dtype=jdt,
                       initializer=jax.nn.initializers.uniform(0.05))
    tv = tde.Variable(name="train", dim=DIM, init_capacity=256,
                      value_dtype=tdt, initializer=tinit.uniform(0.05),
                      device="cpu")
    jst = jde.create_slots(jv, jv.init(), jo)
    tst = tde.create_slots(tv, tv.init(), to)
    ahead = lookup_step_ahead

    def jstep(st, keys, g, step):
        _, ctx = jv.embedding_lookup(st, keys, step=step + ahead)
        return jv.apply_gradients(st, ctx, g, jo, step=step)

    jstep = jax.jit(jstep)
    rng = np.random.default_rng(1)
    for step in range(steps):
        if unique:
            keys = rng.permutation(400)[:96].astype(np.int64) + 1
        else:
            keys = rng.integers(1, 400, size=96).astype(np.int64)
        g = rng.normal(size=(len(keys), DIM)).astype(np.float32)
        jst = jstep(jst, jnp.asarray(keys), jnp.asarray(g, jdt),
                    jnp.int32(step))
        emb, ctx = tv.embedding_lookup(tst, torch.from_numpy(keys),
                                       step=step + ahead)
        assert emb.shape == (len(keys), DIM)
        tst = tv.apply_gradients(tst, ctx, torch.from_numpy(g).to(tdt), to,
                                 step=step)
    return jst, tst


def _assert_trained_alike(jst, tst, rtol=1e-5, atol=1e-6):
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert tst.slot_names == jst.slot_names
    np.testing.assert_allclose(tst.rows_logical.float().numpy(),
                               np.asarray(jst.rows_logical, np.float32),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_steps_match_xla_path(name):
    """Against the JAX package's unfused XLA path; the same step at lookup
    and apply, so both stamp the same scores."""
    _assert_trained_alike(*_train_both(name))


@pytest.mark.parametrize("name", ["Adam"])
def test_optimizer_steps_match_fused_pallas_path(name, monkeypatch):
    """Against the JAX package's fused apply (the Pallas kernel, in the
    interpreter), with the lookup one step ahead of the apply as the DLRM
    trainer and the table-step benchmark call them: the lookup's score
    stamp stands, as on the TPU."""
    _interpret(monkeypatch)
    _assert_trained_alike(*_train_both(name, lookup_step_ahead=1))


def test_bf16_adam_matches_fused_pallas_path_within_one_ulp(monkeypatch):
    """bf16 table, Adam (width 24 -> 256, pf = 2, ch = 1): the kernel's even/odd
    planes, f32 math and round-to-nearest-even repack. Batches hold no
    duplicate id, so both sides apply the same grads."""
    _interpret(monkeypatch)
    jst, tst = _train_both("Adam", dt="bfloat16", lookup_step_ahead=1,
                           unique=True)
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    got = tst.rows_logical.view(torch.int16).numpy().astype(np.int64)
    want = np.asarray(jst.rows_logical).view(np.int16).astype(np.int64)
    # bf16 bit patterns of one sign are ordered like their values
    assert np.abs(got - want).max() <= 1
    assert (got != 0).any()


def test_f16_adagrad_takes_the_unfused_path():
    """f16 tables have no fused kernel: the apply runs the optimizer on
    the looked-up rows and writes back through the row scatter, with the
    slot rows (``commit_planned(slot_rows=)``). f16 math rounds at other
    places in the two frameworks: a few f16 ulps."""
    jst, tst = _train_both("Adagrad", dt="float16")
    _assert_trained_alike(jst, tst, rtol=4e-3, atol=1e-4)


@pytest.mark.parametrize("strategy,sdt", [
    ("LRU", None), ("LFU", None), ("EPOCHLRU", None), ("EPOCHLFU", None),
    ("EPOCHLRU", "int32"), ("EPOCHLFU", "int32")])
def test_scores_match(strategy, sdt):
    """Eviction scores per strategy (epoch fields clamped, not wrapped)."""
    jv = jvar.Variable(name="sc", dim=DIM, init_capacity=256,
                       evict_strategy=getattr(jvar.EvictStrategy, strategy),
                       score_dtype=sdt and jnp.dtype(sdt))
    tv = tde.Variable(name="sc", dim=DIM, init_capacity=256,
                      evict_strategy=getattr(tde.EvictStrategy, strategy),
                      score_dtype=sdt and getattr(torch, sdt), device="cpu")
    keys = np.arange(1, 6, dtype=np.int64)
    counts = np.array([1, 2, 3, 4, 5], np.int32)
    for step, epoch in ((0, 0), (7, 3), ((1 << 20) + 3, (1 << 12) + 1),
                        ((1 << 31) - 1, 1 << 11)):
        want = jv.scores_for(jnp.asarray(keys), jnp.asarray(counts),
                             step=step, epoch=epoch)
        got = tv.scores_for(torch.from_numpy(keys), torch.from_numpy(counts),
                            step=step, epoch=epoch)
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_lookup_with_init_for_missing_matches():
    pre, jv, tv, jst, _, batches = _plan_setup()
    keys = batches["miss"]  # stored rows and per-key initial rows
    want = jax.jit(lambda st, k: jv.lookup(st, k, use_init_for_missing=True))(
        jst, jnp.asarray(keys))
    np.testing.assert_array_equal(
        tv.lookup(_carry(jst), torch.from_numpy(keys),
                  use_init_for_missing=True).numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["bp_v2", "return_evicted", "optax"])
def test_training_api_guards(case):
    """``bp_v2``, ``return_evicted`` and an optax-style optimizer, which
    raised until they were ported, now train alike in both packages (SGD
    on the XLA path, or Adam through optax against the port's
    ``transforms``; the same step at lookup and apply; rows within rtol
    1e-5 / atol 1e-6, evicted keys exact)."""
    kw = {"bp_v2": True} if case == "bp_v2" else {}
    ev = case == "return_evicted"
    if case == "optax":
        import optax

        from recommenders_addons_tpu_torch import transforms

        jopt = jde.DynamicEmbeddingOptimizer(optax.adam(0.05))
        topt = tde.DynamicEmbeddingOptimizer(transforms.adam(0.05))
        assert isinstance(tde.DynamicEmbeddingOptimizer("adam"), tde.Adam)
    else:
        jopt, topt = jde.SGD(0.05), tde.SGD(0.05)
    jv = jvar.Variable(name="g", dim=DIM, init_capacity=256,
                       initializer=jax.nn.initializers.uniform(0.05), **kw)
    tv = tde.Variable(name="g", dim=DIM, init_capacity=256, device="cpu",
                      initializer=tinit.uniform(0.05), **kw)
    jst, tst = jv.init(), tv.init()

    @jax.jit
    def jstep(st, keys, g, step):
        _, jctx = jv.embedding_lookup(st, keys, step=step)
        return jv.apply_gradients(st, jctx, g, jopt, step=step,
                                  return_evicted=ev)

    rng = np.random.default_rng(8)
    for step in range(3):  # 3 x 200 ids into 256 slots: evictions
        keys = rng.integers(1 + 200 * step, 300 + 200 * step, size=200)
        g = rng.normal(size=(200, DIM)).astype(np.float32)
        jout = jstep(jst, jnp.asarray(keys), jnp.asarray(g), jnp.int32(step))
        _, ctx = tv.embedding_lookup(tst, torch.from_numpy(keys), step=step)
        out = tv.apply_gradients(tst, ctx, torch.from_numpy(g), topt,
                                 step=step, return_evicted=ev)
        if ev:
            (jst, jevicted), (tst, evicted) = jout, out
            np.testing.assert_array_equal(evicted["keys"].numpy(),
                                          np.asarray(jevicted["keys"]))
        else:
            jst, tst = jout, out
    assert not ev or (evicted["keys"] != tv.empty_key).any()
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    np.testing.assert_allclose(tst.rows_logical.numpy(),
                               np.asarray(jst.rows_logical), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("field", [None, True, False])
def test_defer_dedup_knob_reads_like_the_reference(field, monkeypatch):
    """With ``TFRA_TPU_DEFER_DEDUP=1`` both packages report the deferred
    path alike (the field wins when set). The reference defers only a
    scored lookup (LRU given ``step``): there both packages defer, with
    the occurrence contract (``found`` marks every occurrence) and equal
    rows; an unscored lookup takes the ordinary path in both and
    agrees."""
    monkeypatch.setenv("TFRA_TPU_DEFER_DEDUP", "1")
    jv = jvar.Variable(name="d", dim=DIM, init_capacity=256,
                       initializer=jax.nn.initializers.uniform(0.05),
                       defer_dedup=field)
    tv = tde.Variable(name="d", dim=DIM, init_capacity=256,
                      initializer=tinit.uniform(0.05), device="cpu",
                      defer_dedup=field)
    on = field is not False
    assert tv.defer_dedup_on == jv.defer_dedup_on == on
    keys = np.array([3, 1, 3, 7], np.int64)
    jst = jv.upsert(jv.init(), jnp.asarray(keys), jnp.ones((4, DIM)))
    want, jctx = jv.embedding_lookup(jst, jnp.asarray(keys), step=1)
    assert jctx.deferred == on
    got, ctx = tv.embedding_lookup(_carry(jst), torch.from_numpy(keys),
                                   step=1)
    assert ctx.deferred == on
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ctx.found.numpy(), np.asarray(jctx.found))
    assert bool(ctx.found.all()) == on  # the occurrence contract
    want, jctx = jv.embedding_lookup(jv.init(), jnp.asarray(keys))
    assert not jctx.deferred
    got, ctx = tv.embedding_lookup(tv.init(), torch.from_numpy(keys))
    assert not ctx.deferred
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
