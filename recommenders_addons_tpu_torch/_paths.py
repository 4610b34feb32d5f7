"""Where the port builds what it compiles at run time (the CUDA kernels,
the native host library, the tools' kernel variants).

A source checkout (the package beside ``packaging/torch/``) builds under
``build/<name>/`` at the checkout's root, as it always has. An installed
copy builds under the user's cache directory, ``$XDG_CACHE_HOME`` (else
``~/.cache``) ``/recommenders_addons_tpu_torch/<name>/``, never into
``site-packages``.
"""

from __future__ import annotations

import os
from pathlib import Path

_PKG = Path(__file__).resolve().parent


def build_dir(name: str) -> Path:
    """The directory that run-time builds named ``name`` go to."""
    if (_PKG.parent / "packaging" / "torch" / "pyproject.toml").is_file():
        return _PKG.parent / "build" / name
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "recommenders_addons_tpu_torch" / name
