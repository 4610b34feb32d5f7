"""Row initializers — the serving subset of the JAX package's
``ops/initializers.py``: the static default row for inference misses.

The per-key random rows of training (``materialize_rows``, threefry
``fold_in``) are still to port.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

InitializerT = Union[None, float, int, torch.Tensor, Callable]


def default_value_of(initializer: InitializerT, dim: int, dtype,
                     device=None) -> torch.Tensor:
    """The static [dim] default row used for INFERENCE-mode misses: zeros
    for ``None`` or a callable initializer, else the broadcast constant."""
    if initializer is None or callable(initializer):
        return torch.zeros((dim,), dtype=dtype, device=device)
    return torch.as_tensor(initializer, dtype=dtype,
                           device=device).expand((dim,))
