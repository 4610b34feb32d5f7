"""A table larger than the card: a device tier plus a host-DRAM spill tier
(the reference's Redis / HKV-hybrid role). Streams more distinct keys than
the device table holds, then checkpoints BOTH tiers and cold-restores:
demoted rows survive (``train.save_dynamic_embedding(tier=)``).

    python -m recommenders_addons_tpu_torch.examples.terabyte_hybrid \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.train import (
    load_dynamic_embedding,
    save_dynamic_embedding,
)
from recommenders_addons_tpu_torch.utils.config import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    def make_var():
        return de.Variable(name="hybrid_demo", dim=32,
                           init_capacity=1 << 14,
                           evict_strategy=de.EvictStrategy.LRU, device=dev)

    var = make_var()
    hy = de.HybridTable(var)
    rng = np.random.default_rng(0)
    ones = torch.ones((2048, 32), device=dev)
    for t in range(50):
        ids = torch.from_numpy(
            rng.integers(1, 1 << 20, size=2048).astype(np.int64)).to(dev)
        hy.prepare_batch(ids)
        hy.upsert(ids, ones, step=t)
    total = hy.tier.total_keys(hy.state)
    print(f"device live: {int(var.size(hy.state))}, "
          f"host tier: {len(hy.tier.store)}, "
          f"total: {total} (device capacity {var.spec.capacity})")

    # checkpoint both tiers, cold-restore, prove nothing was lost
    with tempfile.TemporaryDirectory(prefix="hybrid_ckpt_") as ckpt:
        save_dynamic_embedding(var, hy.state, ckpt, tier=hy)
        var2 = make_var()
        hy2 = de.HybridTable(var2)
        hy2.state = load_dynamic_embedding(var2, hy2.state, ckpt, tier=hy2)
        total2 = hy2.tier.total_keys(hy2.state)
    print(f"restored: device {int(var2.size(hy2.state))} + "
          f"tier {len(hy2.tier.store)} = {total2}")
    if total2 != total:
        raise AssertionError((total2, total))
    print("every row survived the cold restore")
    return 0


if __name__ == "__main__":
    sys.exit(main())
