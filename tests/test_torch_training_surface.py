"""The rest of the port's training surface against the JAX package's, on
the same inputs: deferred dedup (``sorted_combine_batch`` and deferred
Adam steps), bp_v2 deltas, evicted-row capture on the fused and unfused
paths, the direct KV API (``import_batch``, ``accum``, ``remove``,
``clear``), ``scatter_packed`` / ``scatter_rows``, ``plan_lookup_fast``,
``_first_occurrence``, ``dedup_sum`` and CUSTOMIZED scores.

The JAX side runs jitted on the CPU through its XLA path; the port runs
its plain PyTorch versions (and takes its fused apply wherever it fuses
on a card). Where the JAX package's XLA path stamps the apply's step as
the score, the tests pass the same step to lookup and apply. Integers
(plans, key planes, scores, representative masks, evicted keys) and rows
that are only moved (gathered, scattered, captured) must be bit-exact;
optimizer and grad-combine math within rtol 1e-5 / atol 1e-6, the Adam
parity tolerance of ``tests/test_torch_training.py`` (sums over
duplicates are taken in another order).

Tables are small (capacity 256 = 4 buckets of 64, dim 8), so batches
overflow buckets, evict and drop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recommenders_addons_tpu import dynamic_embedding as jde
from recommenders_addons_tpu.ops import hashtable as jht
from recommenders_addons_tpu.ops import optimizer as jopt
from recommenders_addons_tpu.ops import variable as jvar
from recommenders_addons_tpu_torch import convert
from recommenders_addons_tpu_torch import dynamic_embedding as tde
from recommenders_addons_tpu_torch.ops import hashtable as tht
from recommenders_addons_tpu_torch.ops import initializers as tinit

DIM = 8
CAP = 256
RTOL, ATOL = 1e-5, 1e-6


def _carry(jst):
    arrays = {f: np.asarray(getattr(jst, f)) for f in convert.ARRAY_FIELDS}
    meta = {f: getattr(jst, f) for f in convert.META_FIELDS}
    return convert.table_state_from_numpy(arrays, meta, device="cpu")


def _vars(name="s", **kw):
    jv = jvar.Variable(name=name, dim=DIM, init_capacity=CAP,
                       initializer=jax.nn.initializers.uniform(0.05), **kw)
    tv = tde.Variable(name=name, dim=DIM, init_capacity=CAP,
                      initializer=tinit.uniform(0.05), device="cpu", **kw)
    return jv, tv


def _assert_states_alike(jst, tst, exact=False):
    for f in ("key_lo", "key_hi", "scores"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert tst.slot_names == jst.slot_names
    got = tst.rows_logical.numpy()
    want = np.asarray(jst.rows_logical)
    if exact:
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _assert_evicted_alike(got, want, computed_drops=False):
    """Evicted dicts: every entry bit-exact (captured rows are moved, not
    computed), but the dropped values of an unfused apply
    (``computed_drops``), which are its optimizer's new rows: within
    rtol 1e-5 / atol 1e-6."""
    assert set(got) == set(want)
    assert set(got["slots"]) == set(want["slots"])
    for k in ("keys", "scores", "dropped_keys"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(got["values"].numpy().view(np.int32),
                                  np.asarray(want["values"]).view(np.int32))
    if computed_drops:
        np.testing.assert_allclose(got["dropped_values"].numpy(),
                                   np.asarray(want["dropped_values"]),
                                   rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_array_equal(
            got["dropped_values"].numpy().view(np.int32),
            np.asarray(want["dropped_values"]).view(np.int32))
    for nm, v in want["slots"].items():
        np.testing.assert_array_equal(got["slots"][nm].numpy().view(np.int32),
                                      np.asarray(v).view(np.int32),
                                      err_msg=nm)


# ---------------------------------------------------------------------------
# grad combines and plans
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jit_combine():
    return jax.jit(jht.sorted_combine_batch)


@pytest.mark.parametrize("n", [300, 256])
def test_sorted_combine_batch_matches(n):
    """Representative masks bit-exact, combined grads within rtol 1e-5 /
    atol 1e-6 (f32 sums in another order). N = 300 is ragged (not a
    multiple of the JAX package's 128-row chunk); both hold a group of
    150 occurrences that straddles two chunk boundaries in sorted order,
    singletons, pairs and not-found occurrences."""
    rng = np.random.default_rng(n)
    slot = rng.integers(0, 40, size=n).astype(np.int32)
    slot[rng.permutation(n)[:150]] = 7  # one long group
    found = rng.random(n) > 0.1
    g = rng.normal(size=(n, DIM)).astype(np.float32)
    want_c, want_r = _jit_combine()(jnp.asarray(g), jnp.asarray(slot),
                                    jnp.asarray(found))
    got_c, got_r = tht.sorted_combine_batch(
        torch.from_numpy(g), torch.from_numpy(slot), torch.from_numpy(found))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))
    # the representative is each slot's first found occurrence
    first = {}
    for i in range(n):
        if found[i]:
            first.setdefault(int(slot[i]), i)
    assert sorted(first.values()) == list(np.flatnonzero(got_r.numpy()))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=RTOL,
                               atol=ATOL)


def test_first_occurrence_and_dedup_sum_match():
    rng = np.random.default_rng(5)
    sidx = rng.integers(0, 65, size=200).astype(np.int32)  # 64 = sentinel
    want = jax.jit(lambda s: jht._first_occurrence(s, 200, 64))(
        jnp.asarray(sidx))
    np.testing.assert_array_equal(
        tht._first_occurrence(torch.from_numpy(sidx), 200, 64).numpy(),
        np.asarray(want))
    keys = rng.integers(1, 30, size=200).astype(np.int64)
    vals = rng.normal(size=(200, DIM)).astype(np.float32)
    ju, (js,) = jht.dedup_sum(jnp.asarray(keys), (jnp.asarray(vals),))
    tu, (ts,) = tht.dedup_sum(torch.from_numpy(keys),
                              (torch.from_numpy(vals),))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=RTOL,
                               atol=ATOL)


@functools.lru_cache(maxsize=None)
def _fast_setup():
    """A 256-slot table prefilled with 180 keys and its jitted
    ``plan_lookup_fast``."""
    rng = np.random.default_rng(3)
    pre = np.unique(rng.integers(1, 5000, size=180)).astype(np.int64)
    rng.shuffle(pre)
    jv, tv = _vars("fast")
    jst = jv.upsert(jv.init(), jnp.asarray(pre), jnp.asarray(
        rng.normal(size=(len(pre), DIM)), jnp.float32), step=1)
    plan = jax.jit(lambda st, k: jht.plan_lookup_fast(jv.spec, st, k))
    return pre, jv, tv, jst, plan


@pytest.mark.parametrize("case", ["hit_unique", "hit_dups", "miss"])
def test_plan_lookup_fast_matches(case):
    """All-hit dup-free, all-hit with duplicates and miss batches: every
    output bit-exact, and the contract of ``plan_lookup``."""
    pre, jv, tv, jst, plan = _fast_setup()
    rng = np.random.default_rng(len(case))
    n = 256
    keys = {"hit_unique": np.resize(pre, n),
            "hit_dups": rng.choice(pre, n),
            "miss": np.concatenate([pre[:128], np.arange(9000, 9128)])}[case]
    keys = keys.astype(np.int64)
    if case == "hit_unique":
        keys[len(pre):] = jv.empty_key
    want = plan(jst, jnp.asarray(keys))
    got = tht.plan_lookup_fast(tv.spec, _carry(jst), torch.from_numpy(keys))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    uniq, inverse = got[0].numpy(), got[1].numpy()
    found, inserted = got[2][1].numpy(), got[2][2].numpy()
    valid = keys != jv.empty_key
    # every occurrence maps to a position holding its own key
    np.testing.assert_array_equal(uniq[inverse[valid]], keys[valid])
    if case == "miss":
        assert inserted.any()
    else:
        assert not inserted.any()
        assert (found.sum() == len(np.unique(keys[valid])))
    if case == "hit_unique":
        np.testing.assert_array_equal(inverse, np.arange(n))


# ---------------------------------------------------------------------------
# training steps: deferred dedup, bp_v2, evicted rows
# ---------------------------------------------------------------------------


def _batches(case, rng, steps=3, n=96):
    """``steps`` key batches of one kind: ``dup_free`` (a miss batch,
    then hits, no id twice in a batch), ``hit_dups`` (a miss batch, then
    all-hit batches with duplicates), ``miss_dups`` (fresh ids with
    duplicates every step), ``mixed`` (hits, misses, duplicates,
    evictions)."""
    base = rng.permutation(np.arange(1, 400))[:n].astype(np.int64)
    if case == "dup_free":
        return [base] + [rng.permutation(base) for _ in range(steps - 1)]
    if case == "hit_dups":
        return [base] + [rng.choice(base, n) for _ in range(steps - 1)]
    if case == "miss_dups":
        return [rng.integers(1000 * (s + 1), 1000 * (s + 1) + 60, size=n)
                .astype(np.int64) for s in range(steps)]
    return [rng.integers(1, 400, size=n).astype(np.int64)
            for _ in range(steps)]


def _train(jv, tv, opt, batches, seed=1, tst=None, ctxs=None):
    """Lookup + apply on both packages, the same step at lookup and apply;
    returns both states (the port's from ``tst`` when given)."""
    jo, to = getattr(jde, opt)(0.05), getattr(tde, opt)(0.05)
    jst = jde.create_slots(jv, jv.init(), jo)
    tst = tde.create_slots(tv, tv.init(), to) if tst is None else tst

    def jstep(st, keys, g, step):
        _, ctx = jv.embedding_lookup(st, keys, step=step)
        return jv.apply_gradients(st, ctx, g, jo, step=step)

    jstep = jax.jit(jstep)
    rng = np.random.default_rng(seed)
    for step, keys in enumerate(batches):
        g = rng.normal(size=(len(keys), DIM)).astype(np.float32)
        jst = jstep(jst, jnp.asarray(keys), jnp.asarray(g), jnp.int32(step))
        emb, ctx = tv.embedding_lookup(tst, torch.from_numpy(keys),
                                       step=step)
        if ctxs is not None:
            ctxs.append(ctx)
        tst = tv.apply_gradients(tst, ctx, torch.from_numpy(g), to,
                                 step=step)
    return jst, tst


@pytest.mark.parametrize("case", ["dup_free", "hit_dups", "miss_dups"])
def test_deferred_adam_steps_match(case):
    """3 deferred Adam steps (``defer_dedup=True``, scored lookups) on the
    port's fused path against the JAX package's deferred XLA path, and
    against the port's own eager dedup: key and score planes bit-exact,
    rows within rtol 1e-5 / atol 1e-6."""
    batches = _batches(case, np.random.default_rng(11))
    jv, tv = _vars("defer", defer_dedup=True)
    ctxs = []
    jst, tst = _train(jv, tv, "Adam", batches, ctxs=ctxs)
    _assert_states_alike(jst, tst)
    assert all(c.deferred for c in ctxs)
    last = ctxs[-1]
    if case == "dup_free":
        assert last.no_dups and bool(last.found.all())
    elif case == "hit_dups":  # the occurrence contract: every hit found
        assert not last.no_dups and last.rows_aligned
        assert bool(last.found.all())
    else:
        assert not last.no_dups and not last.rows_aligned
    _, tv_eager = _vars("defer", defer_dedup=False)
    _, t_eager = _train(jv, tv_eager, "Adam", batches)
    for f in ("key_lo", "key_hi", "scores"):
        assert torch.equal(getattr(t_eager, f), getattr(tst, f)), f
    np.testing.assert_allclose(tst.rows_logical.numpy(),
                               t_eager.rows_logical.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_reduce_gradient_refuses_a_deferred_context():
    jv, tv = _vars("defer", defer_dedup=True)
    st = tv.init()
    _, ctx = tv.embedding_lookup(st, torch.tensor([3, 1, 3]), step=1)
    assert ctx.deferred
    with pytest.raises(ValueError):
        tv.reduce_gradient(ctx, torch.zeros(3, DIM))


@pytest.mark.parametrize("opt", ["Adam", "SGD"])
def test_bp_v2_steps_match(opt):
    """3 bp_v2 steps (writeback adds ``new - looked-up`` to the stored
    row) on hits, misses, duplicates and evictions: the port's unfused
    path against the JAX package's."""
    batches = _batches("mixed", np.random.default_rng(2))
    jv, tv = _vars("bp", bp_v2=True)
    jst, tst = _train(jv, tv, opt, batches)
    _assert_states_alike(jst, tst)


@functools.lru_cache(maxsize=None)
def _full_table(bp_v2):
    """Both packages' Adam tables filled to capacity (256 keys, distinct
    scores), and a fresh batch that evicts: 320 new keys, more than one
    bucket's 64 in some bucket, so some are dropped."""
    jv, tv = _vars("ev", bp_v2=bp_v2)
    jo = jde.Adam(0.05)
    rng = np.random.default_rng(7)
    jst = jde.create_slots(jv, jv.init(), jo)
    step = 0
    upsert = jax.jit(jv.upsert)
    while int(jv.size(jst)) < CAP:
        keys = rng.integers(1, 1 << 40, size=128).astype(np.int64)
        jst = upsert(jst, jnp.asarray(keys), jnp.asarray(
            rng.normal(size=(128, DIM)), jnp.float32), jnp.int32(step))
        step += 1
    # slot columns hold data too, so captured slots are checked
    jst = jst.replace(rows=jnp.asarray(
        rng.normal(size=jst.rows.shape).astype(np.float32)))
    fresh = rng.integers(1 << 41, 1 << 42, size=320).astype(np.int64)
    g = rng.normal(size=(320, DIM)).astype(np.float32)
    return jv, tv, jst, fresh, g, step


@pytest.mark.parametrize("path", ["fused", "unfused"])
def test_return_evicted_matches(path):
    """A full table takes a fresh batch that evicts and drops. ``fused``:
    the port's fused apply captures the victims before its kernel writes
    (JAX: ``_capture_evicted`` on the same context); ``unfused``: a bp_v2
    table, whose writeback commit captures them. Evicted dicts bit-exact;
    the evicted keys are exactly the keys that left the table, with the
    rows, slots and scores they had; the dropped keys are the fresh keys
    not placed."""
    jv, tv, jst, fresh, g, step = _full_table(path == "unfused")
    jo, to = jde.Adam(0.05), tde.Adam(0.05)
    tst = _carry(jst)
    before = {int(k): i for i, k in enumerate(np.asarray(jst.keys))}
    rows_before = np.asarray(jst.rows_logical)
    scores_before = np.asarray(jst.scores)
    _, jctx = jax.jit(lambda st, k: jv.embedding_lookup(st, k, step=step))(
        jst, jnp.asarray(fresh))
    if path == "fused":
        want_ev = jax.jit(lambda st, c: jopt._capture_evicted(jv, st, c))(
            jst, jctx)
        jst2 = jax.jit(lambda st, c: jv.apply_gradients(
            st, c, jnp.asarray(g), jo, step=step))(jst, jctx)
    else:
        jst2, want_ev = jax.jit(lambda st, c: jv.apply_gradients(
            st, c, jnp.asarray(g), jo, step=step, return_evicted=True))(
            jst, jctx)
    _, ctx = tv.embedding_lookup(tst, torch.from_numpy(fresh), step=step)
    tst2, ev = tv.apply_gradients(tst, ctx, torch.from_numpy(g), to,
                                  step=step, return_evicted=True)
    _assert_evicted_alike(ev, want_ev, computed_drops=path == "unfused")
    _assert_states_alike(jst2, tst2)
    # against the tables themselves
    after = set(tst2.keys[tht.occupancy_mask(tv.spec, tst2)].tolist())
    gone = set(before) - after
    ev_keys = ev["keys"].numpy()
    hit = ev_keys != tv.empty_key
    assert gone and set(ev_keys[hit].tolist()) == gone
    for i in np.flatnonzero(hit):
        s = before[int(ev_keys[i])]
        np.testing.assert_array_equal(ev["values"][i].numpy(),
                                      rows_before[s, :DIM])
        np.testing.assert_array_equal(ev["slots"]["m"][i].numpy(),
                                      rows_before[s, DIM:2 * DIM])
        assert int(ev["scores"][i]) == scores_before[s]
    dk = ev["dropped_keys"].numpy()
    placed = set(fresh.tolist()) & after
    assert set(dk[dk != tv.empty_key].tolist()) == set(fresh.tolist()) - placed
    assert (dk != tv.empty_key).any()


# ---------------------------------------------------------------------------
# the direct KV API
# ---------------------------------------------------------------------------


def test_kv_ops_match():
    """``import_batch`` (5% duplicate keys, scores, Adam slot rows: last
    occurrence wins), ``accum`` (duplicates sum, the ``exists`` guard),
    ``remove`` of half the keys, ``clear``: each against the JAX package
    (integers and moved rows bit-exact, accumulated rows within rtol 1e-5
    / atol 1e-6) and against a numpy reference."""
    jv, tv = _vars("kv")
    jo = jde.Adam(0.05)
    rng = np.random.default_rng(9)
    n = 200
    keys = rng.permutation(np.arange(1, 10_000))[:n].astype(np.int64)
    keys[rng.permutation(n)[:10]] = keys[rng.permutation(n)[:10]]  # dups
    vals = rng.normal(size=(n, DIM)).astype(np.float32)
    sc = rng.integers(1, 1000, size=n).astype(np.int32)
    m = rng.normal(size=(n, DIM)).astype(np.float32)
    v = rng.random(size=(n, DIM)).astype(np.float32)
    jst = jde.create_slots(jv, jv.init(), jo)
    tst = _carry(jst)
    jst = jax.jit(jv.import_batch)(
        jst, jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(sc),
        {"m": jnp.asarray(m), "v": jnp.asarray(v)})
    tst = tv.import_batch(tst, torch.from_numpy(keys),
                          torch.from_numpy(vals), torch.from_numpy(sc),
                          {"m": torch.from_numpy(m), "v": torch.from_numpy(v)})
    _assert_states_alike(jst, tst, exact=True)
    last = {int(k): i for i, k in enumerate(keys)}  # last occurrence wins
    got_vals, found = tv.lookup(tst, torch.from_numpy(np.array(list(last))),
                                return_exists=True)
    placed = found.numpy()
    assert placed.sum() == int(tv.size(tst))
    np.testing.assert_array_equal(
        got_vals.numpy()[placed], vals[list(last.values())][placed])

    # accum: duplicates sum, misses insert their last new value
    ak = np.concatenate([keys[:60], keys[:20], np.arange(20_000, 20_030)])
    old = rng.normal(size=(len(ak), DIM)).astype(np.float32)
    new = rng.normal(size=(len(ak), DIM)).astype(np.float32)
    exists = np.concatenate([np.ones(80, bool), np.zeros(30, bool)])
    stored = {int(k): got_vals.numpy()[i]
              for i, k in enumerate(last) if placed[i]}
    # a stale guard: a stored key, once in ``ak``, said absent: skipped
    stale = next(i for i in range(20, 60) if int(ak[i]) in stored
                 and (ak == ak[i]).sum() == 1)
    exists[stale] = False
    for ex in (None, exists):
        jargs = (jnp.asarray(ak), jnp.asarray(old), jnp.asarray(new))
        targs = (torch.from_numpy(ak), torch.from_numpy(old),
                 torch.from_numpy(new))
        j2 = jax.jit(functools.partial(jv.accum, step=3))(
            jst, *jargs, exists=None if ex is None else jnp.asarray(ex))
        t2 = tv.accum(_carry(jst), *targs, exists=None if ex is None
                      else torch.from_numpy(ex), step=3)
        _assert_states_alike(j2, t2)
    t_vals = tv.lookup(t2, torch.from_numpy(ak)).numpy()
    for i, k in enumerate(ak.tolist()):
        if i == stale:
            np.testing.assert_array_equal(t_vals[i], stored[k])
        elif k in stored:  # per-key sums of the deltas
            want = stored[k] + sum(new[j] - old[j] for j in range(len(ak))
                                   if int(ak[j]) == k)
            np.testing.assert_allclose(t_vals[i], want, rtol=RTOL, atol=1e-5)
        elif i >= 80:  # inserted with its (last) new value
            np.testing.assert_array_equal(t_vals[i], new[i])
    tst = t2

    # remove half, then clear
    rm = np.array(list(last))[::2]
    jst = jax.jit(jv.remove)(j2, jnp.asarray(rm))
    tst = tv.remove(tst, torch.from_numpy(rm))
    _assert_states_alike(jst, tst)
    live = set(tst.keys[tht.occupancy_mask(tv.spec, tst)].tolist())
    assert not live & set(rm.tolist())
    assert int(tv.size(tst)) == len(live) > 0
    rows = tst.rows
    tst = tv.clear(tst)
    _assert_states_alike(jv.clear(jst), tst, exact=True)
    assert int(tv.size(tst)) == 0 and tst.rows is rows  # zeroed in place


@pytest.mark.parametrize("mode", ["assign", "add"])
def test_scatter_packed_and_scatter_rows_match(mode):
    """Writes to known slots, both score modes: bit-exact."""
    pre, jv, tv, jst, _ = _fast_setup()
    rng = np.random.default_rng(len(mode))
    jst = jde.create_slots(jv, jst, jde.Momentum(0.05))
    keys = pre[:64]
    slot, found = jht.find(jv.spec, jst, jnp.asarray(keys))
    mask = np.asarray(found).copy()
    mask[::5] = False
    sc = rng.integers(1, 100, size=64).astype(np.int32)
    packed = rng.normal(size=(64, jst.width)).astype(np.float32)
    vals = rng.normal(size=(64, DIM)).astype(np.float32)
    mom = rng.normal(size=(64, DIM)).astype(np.float32)
    targs = (torch.from_numpy(np.asarray(slot)), torch.from_numpy(mask))
    jargs = (slot, jnp.asarray(mask))
    tst = _carry(jst)
    _assert_states_alike(
        jht.scatter_packed(jst, *jargs, jnp.asarray(packed),
                           jnp.asarray(sc), score_mode=mode),
        tht.scatter_packed(tst, *targs, torch.from_numpy(packed),
                           torch.from_numpy(sc), score_mode=mode),
        exact=True)
    tst = _carry(jst)
    for kw_j, kw_t in (
            (dict(values=jnp.asarray(vals), slot_rows={"momentum":
                                                       jnp.asarray(mom)}),
             dict(values=torch.from_numpy(vals), slot_rows={
                 "momentum": torch.from_numpy(mom)})),
            (dict(), dict())):  # a score refresh only
        _assert_states_alike(
            jht.scatter_rows(jv.spec, jst, *jargs, scores=jnp.asarray(sc),
                             score_mode=mode, **kw_j),
            tht.scatter_rows(tv.spec, _carry(jst), *targs,
                             scores=torch.from_numpy(sc), score_mode=mode,
                             **kw_t),
            exact=True)


def test_customized_scores_match():
    """CUSTOMIZED eviction through ``gen_scores_fn`` (the JAX one takes
    and returns jax arrays, the port's torch tensors): scores and the
    evictions they order, bit-exact."""
    jv, tv = _vars("cust", evict_strategy=jvar.EvictStrategy.CUSTOMIZED)
    jv = jvar.Variable(name="cust", dim=DIM, init_capacity=CAP,
                       evict_strategy=jvar.EvictStrategy.CUSTOMIZED,
                       gen_scores_fn=lambda k: (k * 7) % 1000)
    tv = tde.Variable(name="cust", dim=DIM, init_capacity=CAP, device="cpu",
                      evict_strategy=tde.HkvEvictStrategy.CUSTOMIZED,
                      gen_scores_fn=lambda k: (k * 7) % 1000)
    rng = np.random.default_rng(4)
    jst, tst = jv.init(), tv.init()
    upsert = jax.jit(jv.upsert)
    for _ in range(3):  # 384 keys into 256 slots: evictions by score
        keys = rng.integers(1, 1 << 30, size=128).astype(np.int64)
        vals = rng.normal(size=(128, DIM)).astype(np.float32)
        jst = upsert(jst, jnp.asarray(keys), jnp.asarray(vals))
        tst = tv.upsert(tst, torch.from_numpy(keys), torch.from_numpy(vals))
    _assert_states_alike(jst, tst, exact=True)
    sc, mode = tv.scores_for(torch.from_numpy(keys))
    assert mode == "assign"
    np.testing.assert_array_equal(sc.numpy(), (keys * 7) % 1000)
    bare = tde.Variable(name="c", dim=DIM, device="cpu",
                        evict_strategy=tde.EvictStrategy.CUSTOMIZED)
    with pytest.raises(ValueError):
        bare.scores_for(torch.arange(3))


def test_de_exports():
    assert tde.HkvEvictStrategy is tde.EvictStrategy
    u, inv = tde.unique_static(torch.tensor([5, 3, 5]))
    assert u.tolist()[:2] == [3, 5] and inv.tolist() == [1, 0, 1]
    for name in ("sorted_combine_batch", "plan_lookup_fast", "accum",
                 "dedup_sum", "scatter_packed", "scatter_rows", "remove",
                 "clear", "commit_planned"):
        assert callable(getattr(tde.raw_table, name))
