"""Environment-variable configuration and device selection.

``env_config().default_init_size`` mirrors the JAX package's
``utils/config.py`` (reference ``TF_HASHTABLE_INIT_SIZE``,
cuckoo_hashtable_op.cc:199). ``resolve_device`` is the port's one rule for
where tensors live: CUDA unless the caller names another device, and an
error, never a silent CPU run, when there is no card.
"""

from __future__ import annotations

import dataclasses
import os

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


def env_config() -> EnvConfig:
    return EnvConfig(
        default_init_size=_int_env(
            "TF_HASHTABLE_INIT_SIZE",
            _int_env("TFRA_TPU_INIT_SIZE", 1024 * 1024),
        ),
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
