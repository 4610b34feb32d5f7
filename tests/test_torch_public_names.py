"""Every public name of the JAX package's namespaces (the root, ``de``,
``utils``, ``serving``, ``train``, ``models``, ``data``) exists in the port, its
own submodules included, except the names that wait for a queued module
of the port (``WAITING``).

The names are read in a fresh interpreter that imports only the two
packages' namespaces: importing any submodule binds it as an attribute
of its parent, so in a process that ran other tests a namespace shows
whatever those tests imported."""

import json
import os
import subprocess
import sys

import pytest

NAMESPACES = ["", "dynamic_embedding", "utils", "serving", "train", "models",
              "data"]

WAITING = {}

_SCRIPT = """
import importlib, json, sys, types
out = {}
for ns in sys.argv[1:]:
    suffix = "." + ns if ns else ""
    jmod = importlib.import_module("recommenders_addons_tpu" + suffix)
    tmod = importlib.import_module("recommenders_addons_tpu_torch" + suffix)
    names = []
    for name in dir(jmod):
        v = getattr(jmod, name)
        if name.startswith("_") or (
                isinstance(v, types.ModuleType)
                and not v.__name__.startswith("recommenders_addons_tpu.")):
            continue  # private, or an imported library (jax, numpy, ...)
        names.append([name, hasattr(tmod, name)])
    out[ns] = names
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def names():
    """``{namespace: [[JAX public name, present in the port], ...]}``."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, *NAMESPACES],
                          capture_output=True, text=True, cwd=root, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("ns", NAMESPACES)
def test_public_names_exist_in_the_port(ns, names):
    waiting = WAITING.get(ns, set())
    missing = [n for n, here in names[ns] if not here and n not in waiting]
    ported = [n for n, here in names[ns] if here and n in waiting]
    assert names[ns], f"no public names read from {ns or 'the root'}"
    assert not missing, f"missing from the port's {ns or 'root'}: {missing}"
    assert not ported, f"ported now, drop from WAITING: {ported}"
