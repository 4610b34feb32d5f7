"""Helpers the port's model families share."""

from __future__ import annotations

import torch


def on_device(batch, device):
    """A batch of numpy arrays as tensors on ``device``."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


@torch.no_grad()
def sgd_(params, grads, lr: float) -> None:
    """Plain SGD in place: ``p <- p - lr * g``."""
    for p, g in zip(params, grads):
        p.sub_(lr * g)
