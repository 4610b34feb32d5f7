"""The port's DLRM-DCNv2 (``models/dlrm_dcnv2.py``) and its low-rank cross
network (``nn/cross.py``) against the plain reference
``tests/plain_dlrm_dcnv2.py``, on the CPU at a small size.

The model runs three training steps on bags of sizes [3, 1, 5, 2] (ids
repeated inside a bag and across bags) over a table of 4 buckets of 64
slots, prefilled past its capacity, so that the steps' new keys evict
prefilled ones. Prefilled scores lie below every step's stamp, so every
touched key stays resident and the reference's table of rows by key
needs no eviction model. New keys' initial rows come from the
benchmark's frozen copy of the table's documented initializer
(``benchmark/reference/threefry.py``), not from the port.

Tolerances: the port sums each bag, and each key's gradient over its
positions, through float64 prefix sums (``hashtable.segment_sum_rows``),
the reference by a direct float64 sum; both round to float32 once and
may differ in the last bit where the float64 results straddle a
rounding boundary. Downstream of that the float32 products are the same
on both sides, so losses, gradients, weights and rows agree to rtol 1e-5
/ atol 1e-6 (a few float32 ulps carried through three steps).
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import plain_dlrm_dcnv2 as plain
from benchmark.reference import threefry
from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models import dlrm_dcnv2
from recommenders_addons_tpu_torch.models.dlrm import OptaxAdagrad
from recommenders_addons_tpu_torch.nn.cross import LowRankCrossNet
from recommenders_addons_tpu_torch.ops import hashtable, sparse

SIZES = (3, 1, 5, 2)
CFG = dlrm_dcnv2.DLRMDCNv2Config(
    num_dense=3, multi_hot_sizes=SIZES, dim=8, bottom_sizes=(6, 8),
    top_sizes=(12, 1), cross_layers=3, cross_rank=16, table_capacity=256,
    learning_rate=0.05, sparse_lr=0.05)
BATCH, STEPS = 16, 3
PREFILL_IDS = 80  # ids 0..79 of each feature, 320 keys for 256 slots
RTOL, ATOL = 1e-5, 1e-6


def _init_rows(keys):
    return threefry.uniform_rows("dlrm_dcnv2_embeddings", keys, CFG.dim,
                                 0.05)


def _batches(gen):
    """Ids of each feature from its 8 most popular ids and 4 ids that no
    prefill wrote (80-83), drawn with repeats."""
    out = []
    for _ in range(STEPS):
        pick = torch.randint(0, 12, (BATCH, sum(SIZES)), generator=gen)
        ids = torch.where(pick < 8, pick, pick - 8 + PREFILL_IDS)
        out.append({
            "sparse": ids.to(torch.int32),
            "dense": torch.rand((BATCH, CFG.num_dense), generator=gen),
            "label": (torch.rand((BATCH,), generator=gen) < 0.5).float()})
    return out


class _Recording(OptaxAdagrad):
    """The dense optimizer, keeping the gradients it is given."""

    def __init__(self, learning_rate):
        super().__init__(learning_rate)
        self.grads = []

    def apply(self, params, grads, state):
        self.grads.append([g.detach().clone() for g in grads])
        return super().apply(params, grads, state)


def _setup(seed=0):
    """The model with its prefilled table and random biases, the
    reference's copy of both, and the batches."""
    gen = torch.Generator().manual_seed(seed)
    model = dlrm_dcnv2.DLRMDCNv2(CFG, device="cpu")
    state = model.init(seed)
    table = de.create_slots(model.var, state.table, model.opt)
    nf = len(SIZES)
    ids = torch.arange(PREFILL_IDS, dtype=torch.int64)
    keys = torch.cat([ids | (f << 56) for f in range(nf)])
    scores = torch.cat([-(ids * nf + f) - 1 for f in range(nf)])
    order = torch.argsort(scores)  # least popular written first
    keys, scores = keys[order], scores[order]
    values = (torch.rand((keys.numel(), CFG.dim), generator=gen) * 2 - 1
              ) * 0.05
    accs = torch.rand((keys.numel(), CFG.dim), generator=gen) * 0.1 + 0.1
    # chunks of one bucket's size: each bucket keeps its highest scores
    for lo in range(0, keys.numel(), 64):
        table = model.var.import_batch(
            table, keys[lo:lo + 64], values[lo:lo + 64],
            scores=scores[lo:lo + 64],
            slot_rows={"accumulator": accs[lo:lo + 64]})
    _, found = hashtable.find(model.var.spec, table, keys)
    held = {k: (values[i], accs[i])
            for i, k in enumerate(keys.tolist()) if found[i]}
    with torch.no_grad():
        for name, p in state.dense.named_parameters():
            if ".b." in name:
                p.copy_(torch.randn(p.shape, generator=gen) * 0.1)
    state = dataclasses.replace(state, table=table)
    weights = {n: p.detach().clone()
               for n, p in state.dense.named_parameters()}
    ref = plain.Reference(sizes=SIZES, weights=weights, table=held,
                          init_rows=_init_rows,
                          dense_lr=CFG.learning_rate,
                          table_lr=CFG.sparse_lr)
    return model, state, ref, keys, _batches(gen)


def _rows(model, state, keys):
    slot, found = hashtable.find(model.var.spec, state.table, keys)
    s = slot.long()
    return (found, state.table.values[s],
            state.table.slots["accumulator"][s])


def _train_and_compare():
    """Three steps of the port and of the reference: the names of the
    quantities that disagree, and the final states."""
    model, state, ref, prefilled, batches = _setup()
    rec = _Recording(CFG.learning_rate)
    step, tx = model.make_train_step(rec)
    opt_state = tx.init(list(state.dense.parameters()))
    held_before = int(_rows(model, state, prefilled)[0].sum())
    bad = []

    def close(name, got, want):
        if not torch.allclose(torch.as_tensor(got).double(),
                              torch.as_tensor(want).double(),
                              rtol=RTOL, atol=ATOL):
            bad.append(name)

    for t, batch in enumerate(batches):
        state, opt_state, loss = step(state, opt_state, batch)
        want, dgrads = ref.step(batch)
        close(f"loss.{t}", loss, want)
        if t == 0:
            names = [n for n, _ in state.dense.named_parameters()]
            assert sorted(names) == sorted(dgrads)
            for n, g in zip(names, rec.grads[0]):
                close(f"grad.{n}", g, dgrads[n])
    for n, p in state.dense.named_parameters():
        close(f"weight.{n}", p, ref.weights[n])
    touched = torch.unique(torch.cat([
        plain.tag(b["sparse"], SIZES).reshape(-1) for b in batches]))
    found, rows, accs = _rows(model, state, touched)
    assert bool(found.all()), "a touched key left the table"
    want = [ref.table[k] for k in touched.tolist()]
    close("table.rows", rows, torch.stack([w[0] for w in want]))
    close("table.accumulators", accs, torch.stack([w[1] for w in want]))
    evicted = held_before - int(_rows(model, state, prefilled)[0].sum())
    return bad, evicted, model, state, ref, batches


@pytest.mark.parametrize("rank", [5, 20])
@pytest.mark.parametrize("layers", [1, 3])
def test_low_rank_cross_net_against_the_plain_formula(layers, rank):
    """Forward, input gradient and weight gradients of a cross network of
    width 12 (rank below and above it) against the formula in float64.
    Tolerances: float32 against float64 over sums of at most 20 terms a
    product and three layers."""
    gen = torch.Generator().manual_seed(10 * layers + rank)
    net = LowRankCrossNet(12, layers, rank, generator=gen)
    shapes = {n: tuple(p.shape) for n, p in net.named_parameters()}
    assert shapes == {
        **{f"v.{i}": (12, rank) for i in range(layers)},
        **{f"w.{i}": (rank, 12) for i in range(layers)},
        **{f"b.{i}": (12,) for i in range(layers)}}
    with torch.no_grad():
        for b in net.b:
            b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
    x0 = torch.randn((7, 12), generator=gen).requires_grad_(True)
    up = torch.randn((7, 12), generator=gen)
    names = [n for n, _ in net.named_parameters()]
    out = net(x0)
    got = torch.autograd.grad(out, [x0] + list(net.parameters()), up)

    x64 = x0.detach().double().requires_grad_(True)
    p64 = {n: p.detach().double().requires_grad_(True)
           for n, p in net.named_parameters()}
    want = plain.cross(x64, [p64[f"v.{i}"] for i in range(layers)],
                       [p64[f"w.{i}"] for i in range(layers)],
                       [p64[f"b.{i}"] for i in range(layers)])
    grads = torch.autograd.grad(want, [x64] + [p64[n] for n in names],
                                up.double())
    assert torch.allclose(out.double(), want, rtol=1e-5, atol=1e-6)
    for g, w in zip(got, grads):
        assert torch.allclose(g.double(), w, rtol=1e-5, atol=1e-5)


def test_three_steps_match_the_plain_reference():
    bad, evicted, *_ = _train_and_compare()
    assert bad == []
    assert evicted > 0, "the steps' new keys evicted no prefilled key"


def test_predict_matches_the_reference_forward():
    """After the three steps, on the third step's batch (every key held).
    Tolerance as the steps'."""
    _, _, model, state, ref, batches = _train_and_compare()
    got = model.predict(state, batches[-1])
    want = ref.predict(batches[-1])
    assert torch.allclose(got, want, rtol=RTOL, atol=ATOL)


def _mean_pooled(monkeypatch):
    def lookup(*args, **kw):
        return sparse.embedding_lookup_sparse(*args, **dict(kw,
                                                            combiner="mean"))

    monkeypatch.setattr(dlrm_dcnv2, "embedding_lookup_sparse", lookup)


def _cross_on_x_l(monkeypatch):
    def forward(self, x0):
        x = x0
        for v, w, b in zip(self.v, self.w, self.b):
            x = x * ((x @ v) @ w + b) + x
        return x

    monkeypatch.setattr(LowRankCrossNet, "forward", forward)


@pytest.mark.parametrize("mutation", [_mean_pooled, _cross_on_x_l])
def test_a_broken_copy_fails_the_comparison(mutation, monkeypatch):
    mutation(monkeypatch)
    bad, *_ = _train_and_compare()
    assert any(n.startswith("loss.") for n in bad), bad
    assert any(n.startswith("weight.cross.") for n in bad), bad


def test_a_profiled_step_shows_the_three_spans():
    model, state, _, _, batches = _setup()
    step, tx = model.make_train_step()
    opt_state = tx.init(list(state.dense.parameters()))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, opt_state, batches[0])
    names = {e.name for e in prof.events()}
    assert {sparse.COMBINE_RANGE, sparse.ROW_GRADIENT_RANGE,
            dlrm_dcnv2.CROSS_RANGE} <= names


def test_bags_are_example_major_and_tagged_by_feature():
    model = dlrm_dcnv2.DLRMDCNv2(CFG, device="cpu")
    ids = torch.arange(2 * 11, dtype=torch.int32).reshape(2, 11)
    bags = model.bags(ids)
    assert bags.row_splits.tolist() == [0, 3, 4, 9, 11, 14, 15, 20, 22]
    assert torch.equal(bags.values, plain.tag(ids, SIZES).reshape(-1))
    with pytest.raises(ValueError):
        model.bags(ids[:, :10])
    with pytest.raises(ValueError):
        dlrm_dcnv2.DLRMDCNv2Config(dim=64)
