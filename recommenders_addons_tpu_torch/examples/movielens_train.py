"""MovieLens rating model (the reference's movielens-1m-keras demo).

Real data: pass ``--data <ratings.dat or u.data>`` (ml-1m ``::`` or
ml-100k tab format), streamed through ``data.MovieLensRatingsReader`` and
``data.prefetch`` with buffered shuffling. Without ``--data``, a
synthetic latent-factor generator with the same schema runs.

    python -m recommenders_addons_tpu_torch.examples.movielens_train \\
        [--steps 300] [--multi-hot] [--data ratings.dat] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from recommenders_addons_tpu_torch.data import MovieLensRatingsReader, prefetch
from recommenders_addons_tpu_torch.models.movielens import (
    MovieLensModel,
    run_demo,
)
from recommenders_addons_tpu_torch.utils.config import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--multi-hot", action="store_true")
    p.add_argument("--data", type=str, default=None,
                   help="MovieLens ratings file (ml-1m ratings.dat or "
                        "ml-100k u.data); omitted -> synthetic generator")
    p.add_argument("--eval-batches", type=int, default=8,
                   help="held-out batches for the final MSE (--data only)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    if not a.data:
        train_mse, eval_mse = run_demo(
            steps=a.steps, batch_size=a.batch_size, multi_hot=a.multi_hot,
            log_every=50, device=dev)
        print(f"final: train_mse={train_mse:.4f} eval_mse={eval_mse:.4f}")
        return 0

    model = MovieLensModel(device=dev)
    state = model.init(0)
    step_fn = model.make_train_step()
    reader = MovieLensRatingsReader(
        a.data, batch_size=a.batch_size, repeat=True)
    batches = iter(prefetch(reader, depth=2, device=dev))

    loss = None
    for t in range(a.steps):
        state, loss = step_fn(state, next(batches))
        if t % 50 == 0:
            print(f"step {t}: train_mse={float(loss):.4f}", flush=True)

    # held-out eval: further unseen batches from the shuffled stream
    errs = []
    for _ in range(a.eval_batches):
        b = next(batches)
        pred = model.predict(state, b)
        errs.append(((pred - b["rating"]) ** 2).cpu().numpy())
    eval_mse = float(np.mean(np.concatenate(errs)))
    print(f"final: train_mse={float(loss):.4f} "
          f"eval_mse ({a.data}, {a.eval_batches * a.batch_size} held-out): "
          f"{eval_mse:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
