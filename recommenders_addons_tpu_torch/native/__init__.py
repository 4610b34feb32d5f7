"""Native (C++) host runtime of the port, loaded through ctypes: the
spill tier's host KV store, the checkpoint's buffered row writer and the
batch FNV-1a string hasher, all in ``host_kv.cc`` (the port's own copy of
the JAX package's source), compiled with ``g++`` at first use
(``native/build.py``). These run on the host CPU; no CUDA is involved.
"""

from recommenders_addons_tpu_torch.native.build import get_lib  # noqa: F401
from recommenders_addons_tpu_torch.native.host_store import (  # noqa: F401
    NativeHostKVStore,
)
