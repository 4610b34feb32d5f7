"""The run's refusals: modules of JAX or of the JAX package, found by
their whole top-level name; no card; a checkout without the port."""

import shutil
import subprocess
import sys
import types

from benchmark import run
from benchmark.lib import manifest


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert run.loaded_forbidden() == []
    for name in ("recommenders_addons_tpu_torch",
                 "recommenders_addons_tpu_torch.ops", "jaxtyping",
                 "flaxish"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy",
                        types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "recommenders_addons_tpu.ops",
                        types.ModuleType("recommenders_addons_tpu.ops"))
    assert run.loaded_forbidden() == ["jax", "recommenders_addons_tpu"]


def test_the_harness_loads_no_jax():
    code = ("import sys; sys.argv = ['x']; import benchmark.run, "
            "benchmark.lib.runner, benchmark.lib.trace, benchmark.calibrate;"
            " from benchmark.run import loaded_forbidden; "
            "import recommenders_addons_tpu_torch.models.dlrm, "
            "recommenders_addons_tpu_torch.models.dcn; "
            "print(loaded_forbidden()); "
            "sys.exit(1 if loaded_forbidden() else 0)")
    r = subprocess.run([sys.executable, "-c", code],
                       cwd=str(manifest.ROOT), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_result_without_the_port_or_a_card(tmp_path):
    shutil.copy(manifest.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(manifest.ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "dlrm-criteo-tb.zipf-warm", "--seed", "4294967311", "--seconds",
         "1", "--trace", "0"], cwd=str(tmp_path), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout
