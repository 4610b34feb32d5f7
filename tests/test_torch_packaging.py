"""The port's own wheel (``packaging/torch/``): built from a copy of the
package and that directory (so the build writes nothing into the
checkout), installed with ``pip --no-deps --target``, then imported in a
fresh interpreter whose ``HOME`` and ``XDG_CACHE_HOME`` lie in the test's
directory: no JAX module loads, a CPU table round-trips, the CUDA and C++
sources shipped, and the native host store's library is built under the
cache directory, never beside the installed package."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, sys
from pathlib import Path
import torch
import recommenders_addons_tpu_torch as rat
from recommenders_addons_tpu_torch import dynamic_embedding as de, native
from recommenders_addons_tpu_torch.ops import cuda_ops

pkg = Path(rat.__file__).resolve().parent
var = de.Variable(name="w", dim=4, init_capacity=256, device="cpu")
keys = torch.arange(1, 41)
st = var.upsert(var.init(), keys, keys[:, None].float().expand(40, 4))
got, found = var.lookup(st, torch.tensor([3, 999]), return_exists=True)
native.get_lib()
print(json.dumps({
    "pkg": str(pkg),
    "jax": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "optax", "recommenders_addons_tpu")),
    "roundtrip": got.tolist(), "found": found.tolist(),
    "sources": sorted(p.name for p in (pkg / "csrc").iterdir())
               + sorted(p.name for p in (pkg / "native").glob("*.cc")),
    "kernels_dir": str(cuda_ops._BUILD_DIR),
    "native_lib": str(native.build.library_path()),
    "native_built": native.build.library_path().is_file(),
}))
"""


def test_wheel_builds_installs_and_builds_into_the_cache(tmp_path):
    src = tmp_path / "src"
    shutil.copytree(os.path.join(ROOT, "recommenders_addons_tpu_torch"),
                    src / "recommenders_addons_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(ROOT, "packaging", "torch"),
                    src / "packaging" / "torch")
    dist = tmp_path / "dist"
    subprocess.run([sys.executable, "-m", "build", "--wheel",
                    "--no-isolation", "-o", str(dist)],
                   cwd=src / "packaging" / "torch", check=True,
                   capture_output=True, timeout=300)
    (wheel,) = dist.glob("recommenders_addons_tpu_torch-*.whl")
    site = tmp_path / "site"
    subprocess.run([sys.executable, "-m", "pip", "install", "--no-deps",
                    "--no-index", "--target", str(site), str(wheel)],
                   check=True, capture_output=True, timeout=300)
    meta = next(site.glob("recommenders_addons_tpu_torch-*.dist-info"))
    requires = [ln for ln in (meta / "METADATA").read_text().splitlines()
                if ln.startswith("Requires-Dist:")]
    assert requires == ["Requires-Dist: torch", "Requires-Dist: numpy"]
    assert not (site / "recommenders_addons_tpu").exists()

    cache = tmp_path / "cache"
    env = dict(os.environ, PYTHONPATH=str(site), HOME=str(tmp_path / "home"),
               XDG_CACHE_HOME=str(cache))
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["pkg"] == str(site / "recommenders_addons_tpu_torch")
    assert got["jax"] == []
    assert got["roundtrip"] == [[3.0] * 4, [0.0] * 4]
    assert got["found"] == [True, False]
    shipped = set(got["sources"])
    want = {f for f in os.listdir(os.path.join(
        ROOT, "recommenders_addons_tpu_torch", "csrc"))
        if f.endswith((".cu", ".cuh"))} | {"host_kv.cc"}
    assert want <= shipped and "bulk_copy.cuh" in shipped
    tool_dir = cache / "recommenders_addons_tpu_torch"
    assert got["kernels_dir"] == str(tool_dir / "torch_kernels")
    assert got["native_built"]
    assert got["native_lib"].startswith(str(tool_dir / "torch_native"))
    assert not list(site.rglob("*.so"))
    assert not (site / "build").exists()
