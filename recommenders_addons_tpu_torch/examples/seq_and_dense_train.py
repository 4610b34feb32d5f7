"""Sequence + dense-feature ranking model (the reference's seq_and_dense
demo): a shared dynamic-embedding table feeds both the user's
recent-item sequence (mean-pooled over the valid prefix) and the
dense-side categorical features, concatenated with dense floats into an
MLP.

    python -m recommenders_addons_tpu_torch.examples.seq_and_dense_train \\
        [--steps 200] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from recommenders_addons_tpu_torch.models import seq_and_dense


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    train_mse, eval_mse = seq_and_dense.run_demo(
        steps=a.steps, batch_size=a.batch_size, log_every=25,
        device=a.device)
    print(f"final: train_mse={train_mse:.4f} eval_mse={eval_mse:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
