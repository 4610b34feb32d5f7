"""Bags of ids (``multi_hot_sizes``, sum-pooled): the one-hot cells read
exactly as before bags were added, sizes of 1 are no bags, the reference's
pooled step against a brute-force loop over examples, and a whole bagged
run on the CPU through the port's pooled sparse API, correct when sound
and incorrect under each planted fault."""

import json
from pathlib import Path

import pytest
import torch

from benchmark import run, systems
from benchmark.lib import check, faults, inputs, manifest
from benchmark.reference import dense as ref_dense
from benchmark.reference import train as ref_train
from benchmark.tests import digests, pooled_dlrm
from benchmark.tests.cpu_card import cpu_card
from benchmark.tests.small import cut, small

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]
PARENT = json.loads((Path(__file__).parent / "parent_readings.json")
                    .read_text())
# MLPerf Training's DLRM-DCNv2 (github.com/mlcommons/training,
# recommendation_v2/torchrec_dlrm): --multi_hot_sizes
MLPERF_SIZES = [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12,
                100, 27, 10, 3, 1, 1]
SEED = 2 ** 32 + 29


def _bagged(cell, sizes=MLPERF_SIZES):
    """The small cut of ``cell``'s configuration and mix, with bags."""
    c = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, c["config"])
    cfg["multi_hot_sizes"], cfg["pooling"] = list(sizes), "sum"
    return (c,) + cut(cfg, manifest.traffic(c["traffic"]))


@pytest.mark.parametrize("seed", digests.SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_one_hot_cells_read_as_before_bags(cell, seed):
    """Pool, keys and every reference reading, bit for bit as the harness
    gave them before bags (``parent_readings.json``)."""
    assert digests.readings(cell, seed) == PARENT[cell][str(seed)]


@pytest.mark.parametrize("cell", CELLS)
def test_sizes_of_one_are_no_bags(cell, monkeypatch):
    ones = digests.readings(cell, SEED)
    _, _, cfg, mix = small(cell)
    cfg["multi_hot_sizes"] = [1] * cfg["num_sparse"]
    monkeypatch.setattr(digests, "small",
                        lambda name: (None, None, cfg, mix))
    assert digests.readings(cell, SEED) == ones


def test_bag_schema():
    _, cfg, mix = _bagged(CELLS[0])
    assert inputs.bag_sizes(cfg) == [3, 2, 1, 2]
    assert inputs.column_features(cfg).tolist() == [0, 0, 0, 1, 1, 2, 3, 3]
    assert inputs.column_features({"num_sparse": 3}).tolist() == [0, 1, 2]
    for bad in ({"pooling": "mean"}, {"multi_hot_sizes": [1, 2]},
                {"multi_hot_sizes": [1, 0, 1, 1]}):
        with pytest.raises(ValueError):
            inputs.bag_sizes(dict(cfg, **bad))


@pytest.mark.parametrize("cell", CELLS)
def test_bagged_batches_lie_in_each_columns_vocabulary(cell):
    _, cfg, mix = _bagged(cell, [3, 1, 2, 5])
    cols = inputs.column_features(cfg)
    cards = torch.tensor(inputs.cardinalities(cfg))[cols]
    pool = inputs.Pool(cfg, mix, SEED, 2, "cpu")
    assert pool.sparse.shape == (2, mix["batch"], 11)
    one = inputs.batch(cfg, mix, SEED, 1, "cpu")
    assert torch.equal(pool[1]["sparse"], one["sparse"])
    ids = one["sparse"].long()
    assert bool((ids >= 0).all()) and bool((ids < cards).all())
    keys = inputs.tag(one["sparse"], cfg["feature_shift"], cols)
    assert torch.equal(keys >> cfg["feature_shift"],
                       cols.expand(mix["batch"], -1))


@pytest.mark.parametrize("cell", CELLS)
def test_a_bag_is_its_drawn_id_then_that_ids_row_of_a_fixed_table(cell):
    """MLPerf's ``Multihot``: each bag's first id is the one-hot draw,
    the rest a function of (feature, id, column) alone."""
    _, cfg, mix = _bagged(cell, [3, 1, 2, 5])
    one_hot = dict(cfg)
    del one_hot["multi_hot_sizes"]
    first = [0, 3, 4, 6]
    for seed in (SEED, SEED + 1):
        ids = inputs.batch(cfg, mix, seed, 0, "cpu")["sparse"]
        drawn = inputs.batch(one_hot, mix, seed, 0, "cpu")["sparse"]
        assert torch.equal(ids[:, first], drawn)
    cols = inputs.column_features(cfg)
    pool = inputs.Pool(cfg, mix, SEED, 6, "cpu").sparse.reshape(-1, 11)
    again = inputs.Pool(cfg, mix, SEED + 7, 6, "cpu").sparse.reshape(-1, 11)
    both = torch.cat([pool, again]).long()
    for f, at in enumerate(first):
        width = int((cols == f).sum())
        rows = {}
        for bag in both[:, at:at + width].tolist():
            assert rows.setdefault(bag[0], bag) == bag
        assert len(rows) > 1


def test_the_rest_of_a_bag_is_uniform_whatever_draws_its_first_id():
    """Under zipfian ids the head's id fills about ``1/card`` of a wide
    bag's other columns, not the zipfian share it has in the first, so
    the bags hold as few repeated keys as MLPerf's; and the table behind
    them is uniform over the vocabulary."""
    _, cfg, mix = _bagged(CELLS[0], [1, 1, 1, 100])
    assert mix["ids"]["distribution"] == "zipfian"
    mix["batch"] = 256
    card = inputs.cardinalities(cfg)[3]
    ids = inputs.batch(cfg, mix, SEED, 0, "cpu")["sparse"][:, 3:].long()
    assert float((ids[:, 0] == 0).double().mean()) > 0.1
    assert float((ids[:, 1:] == 0).double().mean()) < 5.0 / card
    first = torch.zeros((card, 4), dtype=torch.int64)
    first[:, 3] = torch.arange(card)
    table = inputs.bags(cfg, first)[:, 4:]
    assert torch.equal(inputs.bags(cfg, first)[:, 3], first[:, 3])
    counts = torch.bincount(table.reshape(-1), minlength=card).double()
    expected = table.numel() / card
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    # chi-square with card - 1 = 599 degrees of freedom: mean 599, sd 34.6
    assert chi2 < 599 + 5 * 34.6


def test_reference_step_against_a_loop_over_examples():
    """Loss and each key's gradient of the reference's pooled step against
    a float64 loop that sums each example's bags by hand. Tolerances: the
    reference runs in float32 (eps 1.2e-7) over a few dozen terms."""
    _, cfg, mix = _bagged(CELLS[0], [3, 2, 1, 5])
    mix["batch"] = 12
    w = inputs.dense_weights(cfg, SEED, "cpu")
    batch = inputs.batch(cfg, mix, SEED, 0, "cpu")
    keys = inputs.tag(batch["sparse"], cfg["feature_shift"],
                      inputs.column_features(cfg)).reshape(-1)
    u, inv = torch.unique(keys, return_inverse=True)
    v = torch.randn((u.numel(), cfg["dim"]),
                    generator=torch.Generator().manual_seed(3)) * 0.05
    loss, dgrads, g = ref_train.forward_backward(cfg, w, batch, v, inv)

    v64 = v.double().requires_grad_(True)
    w64 = {k: t.double().requires_grad_(True) for k, t in w.items()}
    sizes, b = inputs.bag_sizes(cfg), mix["batch"]
    pos = inv.reshape(b, -1).tolist()
    total = 0.0
    for i in range(b):
        bags, c = [], 0
        for n in sizes:
            row = v64[pos[i][c]]
            for j in range(1, n):
                row = row + v64[pos[i][c + j]]
            bags.append(row)
            c += n
        logit = ref_dense.logits(cfg, w64, batch["dense"][i:i + 1].double(),
                                 torch.stack(bags)[None])
        total = total + ref_dense.sigmoid_bce(
            logit, batch["label"][i:i + 1].double())
    want = total / b
    grads = torch.autograd.grad(want, [v64] + [w64[k] for k in sorted(w)])
    assert abs(float(loss) - float(want.detach())) <= 1e-6 * abs(
        float(want.detach()))
    scale = float(grads[0].abs().max())
    assert float((g.double() - grads[0]).abs().max()) <= 1e-5 * scale
    for k, gk in zip(sorted(w), grads[1:]):
        assert torch.allclose(dgrads[k].double(), gk, rtol=1e-4,
                              atol=1e-5 * float(gk.abs().max()))


def _bagged_run(cell, plant, monkeypatch):
    c, cfg, mix = _bagged(cell)
    monkeypatch.setattr(systems, "load", lambda family: pooled_dlrm)
    limits = check.limits_for(cell, manifest.ROOT)
    holder = {}

    def plant_and_keep(trainer):
        holder["t"] = trainer
        plant(trainer)

    try:
        with cpu_card():
            return run.run_cell(MAN, c, cfg, mix, limits, SEED, 0.2, 0,
                                torch.device("cpu"), "cpu",
                                plant=plant_and_keep, t_start=0.0)
    finally:
        restore = getattr(holder.get("t"), "restore", None)
        if restore:
            restore()


@pytest.mark.parametrize("cell", CELLS)
def test_bagged_run_through_the_pooled_api_is_correct(cell, monkeypatch):
    result = _bagged_run(cell, lambda t: None, monkeypatch)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_bagged_run_under_a_fault_is_incorrect(cell, fault, monkeypatch):
    result = _bagged_run(cell, faults.FAULTS[fault], monkeypatch)
    assert result["correct"] is False, result["checks"]
    if fault == "evict_highest":
        assert result["checks"]["keys_wrong"]["value"] > 0
