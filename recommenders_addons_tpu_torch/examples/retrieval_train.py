"""Two-tower retrieval (the reference's MovieLens two-tower demo).

    python -m recommenders_addons_tpu_torch.examples.retrieval_train \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

from recommenders_addons_tpu_torch.models import retrieval


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    loss, recall = retrieval.run_demo(log_every=50, device=a.device)
    print(f"final: loss={loss:.4f} group-recall@10={recall:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
