"""DLRM CTR training (Criteo schema: 13 dense, 26 categorical features).

Real data: pass ``--data <criteo.tsv>`` (label, 13 dense, 26 categorical,
tab-separated) and batches stream through ``data.CriteoTSVReader`` and
``data.prefetch`` (host-side string fingerprinting, placement on the
card from a side stream). Without ``--data``, a synthetic power-law
generator with the same schema runs.

``--shard`` splits the table over a mesh of the visible cards (one
logical shard on the CPU).

    python -m recommenders_addons_tpu_torch.examples.dlrm_train \\
        [--data day.tsv] [--steps 300] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from recommenders_addons_tpu_torch.data import CriteoTSVReader, prefetch
from recommenders_addons_tpu_torch.models import dlrm as D
from recommenders_addons_tpu_torch.train import LoopConfig, train_loop
from recommenders_addons_tpu_torch.utils.config import resolve_device


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--dim", type=int, default=64)
    p.add_argument("--shard", action="store_true")
    p.add_argument("--data", type=str, default=None,
                   help="Criteo TSV file (label \\t 13 dense \\t 26 cat); "
                        "omitted -> synthetic generator")
    p.add_argument("--eval-batches", type=int, default=4,
                   help="held-out batches for the final AUC")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    dev = resolve_device(a.device)
    mesh = None
    if a.shard:
        from recommenders_addons_tpu_torch.parallel import create_mesh

        mesh = create_mesh(devices=None if dev.type == "cuda" else [dev])
    cfg = D.DLRMConfig(dim=a.dim)
    model = D.DLRM(cfg, mesh=mesh, device=dev)
    state = model.init(0)
    train_step, tx = model.make_train_step()
    opt_state = tx.init(list(state.dense.parameters()))
    rng = np.random.default_rng(0)

    if a.data:
        reader = CriteoTSVReader(a.data, batch_size=a.batch_size,
                                 repeat=True)
        batches = iter(prefetch(reader, depth=2, device=dev))

        def next_batch(_):
            return next(batches)
    else:
        def next_batch(r):
            return D.synthetic_criteo_batch(r, a.batch_size)

    def step(carry, batch):
        st, os_ = carry
        st, os_, loss = train_step(st, os_, batch)
        return (st, os_), {"loss": loss}

    def batch_stream():
        for _ in range(a.steps):
            yield next_batch(rng)

    (state, opt_state), report = train_loop(
        step, (state, opt_state), batch_stream(),
        LoopConfig(steps=a.steps, log_every=50, prefetch=2),
        on_log=lambda s, m: print(
            f"step {s}: loss={m['loss']:.4f}", flush=True),
        device=dev)
    print(f"{report.steps} steps in {report.wall_s:.1f}s "
          f"({report.steps_per_sec * a.batch_size:,.0f} examples/s)",
          flush=True)

    # held-out eval: further unseen batches from the same stream
    logits_all, labels_all = [], []
    for _ in range(a.eval_batches):
        b = next_batch(rng)
        logits = model.predict(state, {k: torch.as_tensor(v).to(dev)
                                       for k, v in b.items()})
        logits_all.append(_host(logits))
        labels_all.append(_host(b["label"]))
    auc = D.batch_auc(np.concatenate(logits_all),
                      np.concatenate(labels_all))
    src = a.data or "synthetic"
    print(f"AUC ({src}, {a.eval_batches * a.batch_size} held-out): "
          f"{auc:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
