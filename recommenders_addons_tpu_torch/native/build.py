"""Compile-and-cache loader for the port's native host library (ctypes,
no pybind11): ``host_kv.cc`` built with ``g++`` into
``build/torch_native/`` at a source checkout's root (an installed copy:
the user's cache directory, ``_paths.build_dir``) at first use.

The library's name hashes its source and the Python version, so an edit
rebuilds it and two interpreters never share one. A build that fails
raises with the compiler's output: nothing falls back to numpy silently
(``ops/spill.make_host_store`` takes the numpy store only for value
dtypes the native payload does not hold).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

from recommenders_addons_tpu_torch._paths import build_dir

_SRC = Path(__file__).resolve().parent / "host_kv.cc"
_BUILD_DIR = build_dir("torch_native")
_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
          "-pthread")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha1(_SRC.read_bytes()).hexdigest()[:12]
    tag = f"cpy{sys.version_info.major}{sys.version_info.minor}"
    return _BUILD_DIR / f"_host_kv-{h}-{tag}.so"


def _compile(so: Path) -> None:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run {cmd[0]} to build "
                           f"{_SRC.name}: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed to build {_SRC.name}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    i64, p = c.c_int64, c.c_void_p
    lib.hkv_create.restype = p
    lib.hkv_create.argtypes = [i64, i64]
    lib.hkv_destroy.argtypes = [p]
    lib.hkv_size.restype = i64
    lib.hkv_size.argtypes = [p]
    lib.hkv_capacity.restype = i64
    lib.hkv_capacity.argtypes = [p]
    lib.hkv_put.argtypes = [p, i64, p, p, p]
    lib.hkv_get.argtypes = [p, i64, p, p, p, p, c.c_int]
    lib.hkv_erase.argtypes = [p, i64, p]
    lib.hkv_export.restype = i64
    lib.hkv_export.argtypes = [p, p, p, p]
    lib.hkv_write_gathered.restype = i64
    lib.hkv_write_gathered.argtypes = [c.c_char_p, p, i64, p, i64, i64]
    lib.hkv_fnv1a64_batch.restype = i64
    lib.hkv_fnv1a64_batch.argtypes = [p, p, i64, p, c.c_int]
    return lib


def get_lib() -> ctypes.CDLL:
    """The compiled library, built on the first call; raises when the
    build fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            so = library_path()
            if not so.exists():
                _compile(so)
            _LIB = _bind(ctypes.CDLL(str(so)))
    return _LIB
