"""bp_v2 delta-update training (the reference's demo/dynamic_embedding/bpv2).

Instead of overwriting trained rows, writebacks ACCUMULATE the delta
(new - as-looked-up), which tolerates concurrent writers. With one writer
the two modes agree: this trains the same model both ways and compares.

    python -m recommenders_addons_tpu_torch.examples.bpv2_train [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.utils.config import resolve_device


def train(bp_v2: bool, steps: int = 40, batch: int = 256, dim: int = 8,
          device=None):
    dev = resolve_device(device)
    var = de.Variable(
        name=f"bpv2_{bp_v2}", dim=dim, init_capacity=1 << 12,
        initializer=de.initializers.normal(0.05), bp_v2=bp_v2,
        seed=42,  # same per-key init rows for both variants
        device=dev)
    opt = de.Adagrad(0.05)
    state = de.create_slots(var, var.init(), opt)

    rng = np.random.default_rng(0)
    losses = []
    for t in range(steps):
        ids_np = rng.integers(0, 2048, batch, dtype=np.int64)
        ids = torch.from_numpy(ids_np).to(dev)
        labels = torch.from_numpy(
            (ids_np % 7).astype(np.float32) * 0.1).to(dev)
        emb, ctx = var.embedding_lookup(state, ids)
        emb = emb.detach().requires_grad_(True)
        loss = ((emb.sum(-1) - labels) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [emb])
        state = var.apply_gradients(state, ctx, g, opt, step=t)
        losses.append(float(loss.detach()))
    return var, state, losses


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    var_a, st_a, loss_a = train(bp_v2=False, device=dev)
    var_b, st_b, loss_b = train(bp_v2=True, device=dev)
    print(f"assign-mode  loss: {loss_a[0]:.4f} -> {loss_a[-1]:.4f}")
    print(f"bp_v2 (delta) loss: {loss_b[0]:.4f} -> {loss_b[-1]:.4f}")
    probe = torch.arange(0, 64, dtype=torch.int64, device=dev)
    va = var_a.lookup(st_a, probe).cpu().numpy()
    vb = var_b.lookup(st_b, probe).cpu().numpy()
    print("single-writer rows agree:",
          bool(np.allclose(va, vb, rtol=1e-5)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
