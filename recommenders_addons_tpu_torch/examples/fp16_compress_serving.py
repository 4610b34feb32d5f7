"""Train -> fp16-compressed export -> serve (the reference's
movielens-100k-estimator-with-fp16-compress demo).

Trains a small MovieLens rating model, exports the live embedding rows
compressed to float16 (``de.export_compressed``: half the bytes on disk
and over the wire), loads the export back as a serving table, and answers
a few lookups through the HTTP serving runner.

    python -m recommenders_addons_tpu_torch.examples.fp16_compress_serving \\
        [--steps 120] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.common import on_device
from recommenders_addons_tpu_torch.models.movielens import (
    MovieLensModel,
    synthetic_movielens_batch,
)
from recommenders_addons_tpu_torch.serving import (
    EmbeddingClient,
    EmbeddingServer,
)
from recommenders_addons_tpu_torch.utils.config import resolve_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)

    model = MovieLensModel(device=dev)
    state = model.init(0)
    step_fn = model.make_train_step()
    rng = np.random.default_rng(0)
    for t in range(a.steps):
        batch = on_device(synthetic_movielens_batch(rng, a.batch_size), dev)
        state, loss = step_fn(state, batch)
        if t % 40 == 0:
            print(f"step {t}: mse={float(loss):.4f}")

    with tempfile.TemporaryDirectory() as d:
        prefix = de.export_compressed(model.user, state.user, d,
                                      dtype=torch.float16)
        nbytes = os.path.getsize(prefix + "-values")
        table = de.load_compressed(prefix, device=dev)
        print(f"exported {table.size()} rows as fp16 "
              f"({nbytes / 1024:.0f} KiB on disk)")

        with EmbeddingServer({"user": table}, port=0) as srv:
            cli = EmbeddingClient(srv.host, srv.port)
            ids = rng.integers(0, 200, size=8)
            vals, found = cli.lookup("user", ids.tolist())
            print(f"served lookup: {int(np.sum(found))}/8 found, "
                  f"dim={np.asarray(vals).shape[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
