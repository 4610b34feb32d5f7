"""Environment-variable configuration and device selection.

``env_config()`` reads the JAX package's ``utils/config.py`` variables:
``default_init_size`` (reference ``TF_HASHTABLE_INIT_SIZE``,
cuckoo_hashtable_op.cc:199), ``checkpoint_buffer_keys``
(``TFRA_TPU_CKPT_BUFFER_KEYS``), ``host_store_threads``
(``TFRA_NUM_WORKER_THREADS_FOR_LOOKUP_TABLE_INSERT``) and ``saved_kv_dir``
(reference ``TFRA_SAVED_KV``, cuckoo_hashtable_ops.py:440). The JAX
package's two debugging switches that swap its native and Pallas paths
for plain ones have no counterpart: a kernel here never gives way to its
plain version on the card. ``resolve_device`` is the port's one rule for
where tensors live: CUDA unless the caller names another device, and an
error, never a silent CPU run, when there is no card.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch


def _int_env(name: str, default: int) -> int:
    v = os.environ.get(name)
    try:
        return int(v) if v else default
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    # default table capacity when none given (reference
    # TF_HASHTABLE_INIT_SIZE default 8192; ours defaults bigger since
    # capacity == max under eviction)
    default_init_size: int = 1024 * 1024
    # checkpoint IO buffer in keys (reference buffer_size default 4Mi)
    checkpoint_buffer_keys: int = 4 * 1024 * 1024
    # host-store worker threads for batched gets (reference
    # TFRA_NUM_WORKER_THREADS_FOR_LOOKUP_TABLE_INSERT)
    host_store_threads: int = 8
    # checkpoint sidecar dir override (reference TFRA_SAVED_KV)
    saved_kv_dir: Optional[str] = None


def env_config() -> EnvConfig:
    return EnvConfig(
        default_init_size=_int_env(
            "TF_HASHTABLE_INIT_SIZE",
            _int_env("TFRA_TPU_INIT_SIZE", 1024 * 1024),
        ),
        checkpoint_buffer_keys=_int_env(
            "TFRA_TPU_CKPT_BUFFER_KEYS", 4 * 1024 * 1024),
        host_store_threads=_int_env(
            "TFRA_NUM_WORKER_THREADS_FOR_LOOKUP_TABLE_INSERT", 8),
        saved_kv_dir=os.environ.get("TFRA_SAVED_KV"),
    )


def resolve_device(device=None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises when
    CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
