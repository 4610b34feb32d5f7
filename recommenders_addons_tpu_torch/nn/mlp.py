"""Dense MLP tower — the port of the JAX package's ``nn/mlp.py``
(``init_mlp`` / ``apply_mlp``) as an ``nn.Module``.

Weights keep the JAX layout, ``w`` as ``[in, out]`` for ``x @ w``, so a
tower carries across as plain arrays (``convert.dlrm_dense_*``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import math

import torch
from torch import nn


class MLP(nn.Module):
    """``sizes = [in, h1, ..., out]``: ReLU between layers, none after the
    last. Initial weights are He-normal (``normal * sqrt(2 / fan_in)``)
    from ``generator``, biases zero."""

    def __init__(self, sizes: Sequence[int], dtype=torch.float32,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
            w = torch.randn((fan_in, fan_out), generator=generator,
                            dtype=dtype, device=device)
            self.w.append(nn.Parameter(w * math.sqrt(2.0 / fan_in)))
            self.b.append(nn.Parameter(torch.zeros(fan_out, dtype=dtype,
                                                   device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.w) - 1
        for i, (w, b) in enumerate(zip(self.w, self.b)):
            x = x @ w + b
            if i < last:
                x = torch.relu(x)
        return x
