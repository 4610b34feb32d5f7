"""The reference against the port on the CPU at a small size (every cell,
the port's plain versions), the reference's frozen copies against the
port's documented functions, and the control: the reference itself in
TF32 put in the program's place fails the cell's limits."""

import sys

import pytest
import torch

from benchmark.lib import check, runner
from benchmark.reference import hashing, threefry
from benchmark.reference import train as ref_train
from benchmark.tests.small import small
from benchmark.lib import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]
SEED = 2 ** 31 + 11


def _session(cell, seed=SEED, plant=None):
    _, _, cfg, mix = small(cell)
    s = runner.setup(cfg, mix, seed, "cpu", 8, plant=plant)
    runner.release(s)
    return s


@pytest.mark.parametrize("cell", CELLS)
def test_port_matches_reference_on_cpu(cell):
    s = _session(cell)
    ok, checks, numbers = runner.judge(s, check.limits_for(
        cell, manifest.ROOT))
    assert ok, checks
    assert numbers["keys_wrong"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    """The reference in TF32 (operands rounded to TF32 on the CPU) in the
    program's place."""
    s = _session(cell)
    b = runner.check_batches(s)
    ref = ref_train.run(s.cfg, s.mix, s.seed, s.plan, s.weights, b)
    ctl = ref_train.run(s.cfg, s.mix, s.seed, s.plan, s.weights, b,
                        precision="tf32")
    numbers = check.compare(s.cfg, ref, s.weights, other=ctl)
    ok, _ = check.verdict(numbers, check.limits_for(cell, manifest.ROOT))
    assert not ok, numbers


def test_frozen_hash_and_rows_match_the_port():
    from recommenders_addons_tpu_torch.ops import hashing as port_hash
    from recommenders_addons_tpu_torch.ops import initializers, prng

    keys = torch.tensor([0, 1, 12345, -(1 << 62), (25 << 56) | 77,
                         (3 << 56) | 10_000_007], dtype=torch.int64)
    assert torch.equal(hashing.mix64(keys), port_hash.mix64(keys))
    assert torch.equal(hashing.bucket_of(keys, 1 << 20),
                       port_hash.bucket_of(keys, 1 << 20).long())
    for name in ("dlrm_embeddings", "some_other_table"):
        import zlib

        base = prng.PRNGKey(zlib.crc32(name.encode()))
        want = initializers.materialize_rows(
            initializers.uniform(scale=0.05), base, keys, 64, torch.float32)
        got = threefry.uniform_rows(name, keys, 64, 0.05)
        assert torch.equal(got, want)


def test_reference_imports_nothing_of_the_port():
    import subprocess

    code = ("import sys; import benchmark.reference.train, "
            "benchmark.reference.table; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('recommenders_addons_tpu_torch', 'recommenders_addons_tpu', "
            "'jax', 'jaxlib', 'flax')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(manifest.ROOT),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits_on_card(cuda, cell):
    """The control in the cuBLAS TF32 mode, at the small size."""
    _, _, cfg, mix = small(cell)
    s = runner.setup(cfg, mix, SEED, cuda, 8)
    runner.release(s)
    b = runner.check_batches(s)
    ref = ref_train.run(s.cfg, s.mix, s.seed, s.plan, s.weights, b)
    ctl = ref_train.run(s.cfg, s.mix, s.seed, s.plan, s.weights, b,
                        precision="tf32")
    numbers = check.compare(s.cfg, ref, s.weights, other=ctl)
    ok, _ = check.verdict(numbers, check.limits_for(cell, manifest.ROOT))
    assert not ok, numbers
