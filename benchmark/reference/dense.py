"""What the model families' plain forward passes share
(``benchmark/reference/models/<family>.py``), on a dict of float32
weights by name: ``x @ w`` with ``w`` as ``[in, out]``, towers, the loss.
Every product goes through :func:`matmul` or :func:`bmm`, so that the
control can run the same equations in TF32.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

# the precision of the matrix products: "f32" (TF32 off) or "tf32"
_PRECISION = ["f32"]


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties away
    from zero, as the tensor cores convert); the gradient passes through
    unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return x + (bits.view(torch.float32) - x).detach()


@contextlib.contextmanager
def precision(mode: str):
    """Run the products in ``mode``: on a card TF32 is the cuBLAS mode; on
    the CPU the operands are rounded to TF32 before an f32 product."""
    if mode not in ("f32", "tf32"):
        raise ValueError(mode)
    old = (_PRECISION[0], torch.backends.cuda.matmul.allow_tf32)
    _PRECISION[0] = mode
    torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
    try:
        yield
    finally:
        _PRECISION[0] = old[0]
        torch.backends.cuda.matmul.allow_tf32 = old[1]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _PRECISION[0] == "tf32" and a.device.type == "cpu":
        return _round_tf32(a) @ _round_tf32(b)
    return a @ b


def bmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _PRECISION[0] == "tf32" and a.device.type == "cpu":
        return torch.bmm(_round_tf32(a), _round_tf32(b))
    return torch.bmm(a, b)


def tower(w: Dict[str, torch.Tensor], prefix: str, n: int,
          x: torch.Tensor) -> torch.Tensor:
    """``n`` layers ``x @ w + b``, ReLU between them, none after."""
    for i in range(n):
        x = matmul(x, w[f"{prefix}.w.{i}"]) + w[f"{prefix}.b.{i}"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def tower_shapes(prefix: str, sizes):
    out = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"{prefix}.w.{i}"] = (a, b)
        out[f"{prefix}.b.{i}"] = (b,)
    return out


def shapes(cfg) -> Dict[str, tuple]:
    from benchmark.reference import models

    return models.load(cfg["family"]).shapes(cfg)


def logits(cfg, w, x_dense, emb) -> torch.Tensor:
    from benchmark.reference import models

    return models.load(cfg["family"]).logits(cfg, w, x_dense, emb)


def sigmoid_bce(logits_: torch.Tensor, labels: torch.Tensor):
    """Mean binary cross-entropy on logits, in the stable form."""
    per = (torch.relu(logits_) - logits_ * labels
           + torch.log1p(torch.exp(-logits_.abs())))
    return per.mean()
