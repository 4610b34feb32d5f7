"""Growing-vocabulary training with restrict policies (the reference's
amazon-video-games-keras-eager demo): new ids keep streaming in, and a
RestrictPolicy periodically caps the live-key count, evicting the stalest
(timestamp) or rarest (frequency) features with their optimizer state.

    python -m recommenders_addons_tpu_torch.examples.restrict_growth \\
        [--policy timestamp|frequency] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.utils.config import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--policy", choices=("timestamp", "frequency"),
                   default="timestamp")
    p.add_argument("--num-reserved", type=int, default=4096)
    p.add_argument("--trigger", type=int, default=6144)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    policy_cls = {
        "timestamp": de.TimestampRestrictPolicy,
        "frequency": de.FrequencyRestrictPolicy,
    }[a.policy]
    var = de.Variable(
        name="amazon_items", dim=a.dim, init_capacity=1 << 14,
        initializer=de.initializers.normal(0.05),
        restrict_policy=policy_cls,
        evict_strategy=(de.EvictStrategy.LRU if a.policy == "timestamp"
                        else de.EvictStrategy.LFU),
        device=dev)
    opt = de.Adam(0.01)
    state = de.create_slots(var, var.init(), opt)

    rng = np.random.default_rng(0)
    for t in range(a.steps):
        # the id stream DRIFTS: new products keep appearing
        lo = t * a.batch_size // 2
        ids = torch.from_numpy(rng.integers(
            lo, lo + 4 * a.batch_size, a.batch_size, dtype=np.int64)).to(dev)
        labels = torch.from_numpy(
            rng.standard_normal(a.batch_size).astype(np.float32)).to(dev)
        emb, ctx = var.embedding_lookup(state, ids)
        emb = emb.detach().requires_grad_(True)
        loss = ((emb.sum(axis=-1) - labels) ** 2).mean()
        (g,) = torch.autograd.grad(loss, [emb])
        state = var.apply_gradients(state, ctx, g, opt, step=t)
        if (t + 1) % 20 == 0:
            before = int(var.size(state))
            state = var.restrict(state, num_reserved=a.num_reserved,
                                 trigger=a.trigger)
            after = int(var.size(state))
            print(f"step {t + 1}: loss={float(loss.detach()):.4f} "
                  f"size {before} -> {after} "
                  f"(policy={a.policy}, reserved={a.num_reserved})",
                  flush=True)
    final = int(var.size(state))
    print(f"final live keys: {final} (cap honored: "
          f"{final <= max(a.trigger, a.num_reserved)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
