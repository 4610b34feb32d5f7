"""The general generator: batches and prefill reproduce by seed, every id
lies in the capped vocabulary, and each mix's ids follow its stated
distribution."""

import math

import pytest
import torch

from benchmark.lib import inputs, manifest
from benchmark.tests.small import small

SEED = 2 ** 33 + 5
CELLS = [w["name"] for w in manifest.load()["workloads"]]


def _mix(cell):
    _, _, cfg, mix = small(cell)
    return cfg, mix


@pytest.mark.parametrize("cell", CELLS)
def test_batches_reproduce_by_seed(cell):
    cfg, mix = _mix(cell)
    a = inputs.batch(cfg, mix, SEED, 3, "cpu")
    b = inputs.batch(cfg, mix, SEED, 3, "cpu")
    c = inputs.batch(cfg, mix, SEED + 1, 3, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k])
    assert not torch.equal(a["sparse"], c["sparse"])


@pytest.mark.parametrize("cell", CELLS)
def test_every_id_is_in_the_vocabulary(cell):
    cfg, mix = _mix(cell)
    cards = torch.tensor(inputs.cardinalities(cfg))
    for k in range(4):
        one = inputs.batch(cfg, mix, SEED, k, "cpu")
        ids = one["sparse"].long()
        assert bool((ids >= 0).all()) and bool((ids < cards).all())
        assert set(one["label"].unique().tolist()) <= {0.0, 1.0}
        d = one["dense"]
        assert bool((d >= 0).all()) and bool((d < 1).all())


def test_zipfian_ids_follow_ycsb():
    """YCSB's generator at theta 0.99: rank 0 and 1 exactly as the zeta
    function gives them, the head near a discrete Zipf's."""
    n, theta, draws = 1000, 0.99, 400_000
    u = torch.rand((draws, 1), dtype=torch.float64,
                   generator=torch.Generator().manual_seed(7))
    ranks = inputs._zipfian(u, torch.tensor([n]), theta)[:, 0]
    assert int(ranks.min()) == 0 and int(ranks.max()) <= n - 1
    zeta = sum(i ** -theta for i in range(1, n + 1))
    freq = torch.bincount(ranks, minlength=n).double() / draws
    for r in (0, 1):
        p = (r + 1) ** -theta / zeta
        assert abs(float(freq[r]) - p) < 4 * math.sqrt(p / draws)
    head = float(freq[:10].sum())
    assert abs(head - sum(i ** -theta for i in range(1, 11)) / zeta) < 0.02


def test_uniform_ids_as_dlrm_draws_them():
    u = torch.tensor([[0.0], [0.2499], [0.5], [0.99999]], dtype=torch.float64)
    got = inputs._uniform(u, torch.tensor([5]))[:, 0].tolist()
    assert got == [0, 1, 2, 4]  # round(u * 4), halves to even


def test_mixes_differ_in_their_ids_only():
    cfg, z = _mix("dlrm-criteo-tb.zipf-warm")
    _, u = _mix("dlrm-criteo-tb.uniform-warm")
    a = inputs.batch(cfg, z, SEED, 0, "cpu")
    b = inputs.batch(cfg, u, SEED, 0, "cpu")
    assert torch.equal(a["dense"], b["dense"])
    assert torch.equal(a["label"], b["label"])
    big = a["sparse"][:, 0].long()  # a feature of 600 ids
    assert float((big < 10).float().mean()) > 0.3  # zipfian's head
    assert float((b["sparse"][:, 0] < 10).float().mean()) < 0.1


def test_pool_serves_in_order_and_repeats_past_its_end():
    cfg, mix = _mix("dlrm-criteo-tb.zipf-warm")
    pool = inputs.Pool(cfg, mix, SEED, 3, "cpu")
    one = inputs.batch(cfg, mix, SEED, 1, "cpu")
    for k in (1, 4):
        for key in one:
            assert torch.equal(pool[k][key], one[key])


@pytest.mark.parametrize("cell", CELLS)
def test_prefill_order_scores_and_size(cell):
    cfg, mix = _mix(cell)
    plan = inputs.prefill(cfg, mix, "cpu")
    n = sum(inputs.cardinalities(cfg))
    assert plan.keys.numel() == n == torch.unique(plan.keys).numel()
    assert bool((plan.scores[1:] > plan.scores[:-1]).all())
    assert bool((plan.scores < 0).all())
    # the most popular id of every feature is written last
    last = plan.keys[-cfg["num_sparse"]:] & ((1 << 56) - 1)
    assert bool((last == 0).all())
    v1, a1 = plan.rows(SEED, 0, cfg["dim"])
    v2, a2 = plan.rows_at(SEED, torch.arange(plan.span(0)[1]), cfg["dim"])
    assert torch.equal(v1, v2) and torch.equal(a1, a2)
    assert bool((a1 >= 0.1).all()) and bool((v1.abs() <= 0.05).all())
