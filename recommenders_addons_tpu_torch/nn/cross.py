"""Low-rank cross network of DCN-v2 (Wang et al., "DCN V2", WWW 2021;
TorchRec's ``LowRankCrossNet``, ``torchrec/modules/crossnet.py``): each
layer

    x_{l+1} = x_0 * ((x_l @ v_l) @ w_l + b_l) + x_l

with ``v_l`` ``[in, rank]`` (TorchRec's ``V_kernels``, transposed) and
``w_l`` ``[rank, in]`` (its ``W_kernels``, transposed), in the port's
``[in, out]`` layout for ``x @ w``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn


class LowRankCrossNet(nn.Module):
    """``num_layers`` low-rank cross layers over ``in_features``:
    ``x_0 [B, in] -> x_L [B, in]``. Parameters ``v.<l>``, ``w.<l>`` and
    ``b.<l>``; the kernels drawn Xavier-normal (TorchRec's
    ``xavier_normal_``, ``normal * sqrt(2 / (in + rank))``) from
    ``generator``, biases zero."""

    def __init__(self, in_features: int, num_layers: int, low_rank: int,
                 dtype=torch.float32, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        std = math.sqrt(2.0 / (in_features + low_rank))
        self.v = nn.ParameterList()
        self.w = nn.ParameterList()
        self.b = nn.ParameterList()
        for _ in range(num_layers):
            for plist, shape in ((self.v, (in_features, low_rank)),
                                 (self.w, (low_rank, in_features))):
                k = torch.randn(shape, generator=generator, dtype=dtype,
                                device=device)
                plist.append(nn.Parameter(k * std))
            self.b.append(nn.Parameter(torch.zeros(in_features, dtype=dtype,
                                                   device=device)))

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        x = x0
        for v, w, b in zip(self.v, self.w, self.b):
            x = x0 * ((x @ v) @ w + b) + x
        return x
