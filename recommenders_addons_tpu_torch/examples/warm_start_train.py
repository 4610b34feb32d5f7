"""Warm-starting a new model from a previous run's tables (the
reference's movielens-100k-estimator-with-warmup demo).

Phase 1 trains a MovieLens model and checkpoints it. Phase 2 builds a
FRESH model whose user table has a different name, warm-starts it from
the phase-1 checkpoint through a name map (``de.warm_start``), and shows
the loaded rows give it a head start: its eval MSE is the trained
model's, not a cold one's.

    python -m recommenders_addons_tpu_torch.examples.warm_start_train \\
        [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile

import numpy as np

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.common import on_device
from recommenders_addons_tpu_torch.models.movielens import (
    MovieLensModel,
    synthetic_movielens_batch,
)
from recommenders_addons_tpu_torch.utils.config import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=150)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    def eval_mse(model, state, rng):
        b = on_device(synthetic_movielens_batch(rng, 2048), dev)
        pred = model.predict(state, b)
        return float(((pred - b["rating"]) ** 2).mean())

    # ---- phase 1: train and checkpoint --------------------------------
    model = MovieLensModel(device=dev)
    state = model.init(0)
    step_fn = model.make_train_step()
    rng = np.random.default_rng(0)
    for _ in range(a.steps):
        batch = on_device(synthetic_movielens_batch(rng, a.batch_size), dev)
        state, _loss = step_fn(state, batch)
    trained = eval_mse(model, state, np.random.default_rng(7))
    print(f"phase 1 trained eval_mse={trained:.4f}")

    with tempfile.TemporaryDirectory() as d:
        ckpt = de.train.DECheckpoint(
            user=model.user, movie=model.movie, dense=None)
        ckpt.save(d, state={"user": state.user, "movie": state.movie,
                            "dense": state.dense}, step=a.steps)

        # ---- phase 2: fresh model, renamed table, warm start ----------
        model2 = MovieLensModel(device=dev)
        # a new table name, the old weights (Variable is a frozen
        # dataclass)
        model2.user = dataclasses.replace(model2.user, name="ml_user_v2")
        state2 = model2.init(1)
        cold = eval_mse(model2, state2, np.random.default_rng(7))

        warmed = de.warm_start(
            {model2.user: state2.user, model2.movie: state2.movie},
            ckpt_to_initialize_from=d,
            vars_to_warm_start=["ml_user_v2", "ml_movie"],
            var_name_to_prev_var_name={"ml_user_v2": "ml_user"},
        )
        state2 = dataclasses.replace(
            state2,
            user=warmed[model2.user], movie=warmed[model2.movie],
            dense=state.dense,  # carry the dense tower too
        )
        warm = eval_mse(model2, state2, np.random.default_rng(7))
        print(f"phase 2 cold eval_mse={cold:.4f} -> warm-started "
              f"eval_mse={warm:.4f}")
        if not warm < cold:
            raise AssertionError((warm, cold))
    return 0


if __name__ == "__main__":
    sys.exit(main())
