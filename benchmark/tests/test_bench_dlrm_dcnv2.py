"""The ``dlrm-dcnv2-mlperf`` cell: a whole run of its small cut on the CPU
(the harness's look for a card skipped, the port's plain versions) is
correct when sound and incorrect under each planted fault, and the
family's FLOP count at MLPerf's published widths by hand."""

import pytest
import torch

from benchmark import run
from benchmark.lib import check, faults, manifest
from benchmark.roofline import counts
from benchmark.tests.cpu_card import cpu_card
from benchmark.tests.small import small

CELL = "dlrm-dcnv2-mlperf.zipf-warm-bags"
SEED = 2 ** 33 + 21


def _run(plant):
    man, c, cfg, mix = small(CELL)
    limits = check.limits_for(CELL, manifest.ROOT)
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


def test_sound_run_is_correct():
    result = _run(lambda t: None)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"train_examples_per_s",
                                      "step_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_makes_the_run_incorrect(fault):
    result = _run(faults.FAULTS[fault])
    assert result["correct"] is False, result["checks"]
    if fault == "evict_highest":
        assert result["checks"]["keys_wrong"]["value"] > 0


def test_flops_at_the_published_widths_by_hand():
    cfg = manifest.config(manifest.load(), "dlrm-dcnv2-mlperf")
    bottom = 13 * 512 + 512 * 256 + 256 * 128
    cross = 3 * 2 * 3456 * 512
    top = 3456 * 1024 + 1024 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1
    want = 4 * 13 * 512 + 6 * (bottom - 13 * 512) + 6 * cross + 6 * top
    assert counts.train_flops_per_example(cfg) == want == 96_169_472
    # about 0.788 TFLOP a step of 8,192 examples
    assert abs(want * 8192 / 1e12 - 0.788) < 0.001
