"""A whole run (the harness's look for a card skipped, the port's plain
versions on the CPU, a small configuration) with the timed path broken
underneath: ``correct`` comes out false for each fault a training cell can
have on one card."""

import pytest
import torch

from benchmark import run
from benchmark.lib import check, faults, manifest
from benchmark.tests.cpu_card import cpu_card
from benchmark.tests.small import small

SEED = 2 ** 32 + 3
CELLS = [w["name"] for w in manifest.load()["workloads"]]


FAULTS = {k: v for k, v in faults.FAULTS.items() if k != "evict_highest"}


def _run(cell, plant):
    man, c, cfg, mix = small(cell)
    limits = check.limits_for(c["name"], manifest.ROOT)
    holder = {}

    def plant_and_keep(trainer):
        holder["t"] = trainer
        plant(trainer)

    try:
        with cpu_card():
            return run.run_cell(man, c, cfg, mix, limits, SEED, 0.2, 0,
                                torch.device("cpu"), "cpu",
                                plant=plant_and_keep, t_start=0.0)
    finally:
        restore = getattr(holder.get("t"), "restore", None)
        if restore:
            restore()


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault):
    result = _run(cell, FAULTS[fault])
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_eviction_fault_shows_in_keys_wrong(cell):
    result = _run(cell, faults.evict_highest)
    assert result["correct"] is False
    assert result["checks"]["keys_wrong"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(cell):
    result = _run(cell, lambda t: None)
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"train_examples_per_s",
                                      "step_ms_p95", "setup_s"}
    assert list(result)[-1] == "checks"
