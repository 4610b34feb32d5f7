"""Sequence + dense features model — the port of the JAX package's
``models/seq_and_dense.py`` (the reference's ``seq_and_dense`` demo):
variable-length id sequences pooled into a fixed-width feature next to
dense inputs.

Sequences arrive padded to a fixed length with the EMPTY id; the pool is
a masked mean, so padding adds nothing, and the apply sends the padding's
rows to the trash row. The table trains with the row-wise ``Adam`` (the
fused optimizer-scatter kernel), the MLP with plain SGD.

With ``mesh=`` the table is a ``parallel.ShardedVariable``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.common import on_device, sgd_
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class SeqAndDenseConfig:
    dim: int = 32
    max_seq_len: int = 20
    num_dense: int = 8
    hidden: Tuple[int, ...] = (64, 32, 1)
    capacity: int = 1 << 16
    lr: float = 0.02


@dataclasses.dataclass
class SeqAndDenseState:
    table: Any
    dense: MLP  # updated in place by the train step
    step: int


class SeqAndDenseModel:
    def __init__(self, cfg: SeqAndDenseConfig = SeqAndDenseConfig(),
                 mesh=None, device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        var = de.Variable(
            name="seq_emb", dim=cfg.dim, init_capacity=cfg.capacity,
            initializer=de.initializers.normal(0.05), device=self.device)
        if mesh is not None:
            self.params = ShardedVariable(var, mesh)
            self.var = self.params.var
        else:
            self.params = self.var = var
        self.opt = de.Adam(cfg.lr)

    def init(self, seed: int = 0) -> SeqAndDenseState:
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dense = MLP((cfg.dim + cfg.num_dense,) + cfg.hidden,
                    device=self.device, generator=gen)
        return SeqAndDenseState(table=self.params.init(), dense=dense, step=0)

    def _pool(self, emb, seq):
        """Masked mean over the sequence axis (``[B, L, D] -> [B, D]``)."""
        mask = (seq != self.var.empty_key)[..., None].to(emb.dtype)
        return (emb * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1.0)

    def make_train_step(self):
        """``train_step(state, batch) -> (state, loss)``; the table rows
        and the MLP are updated in place."""

        def train_step(state: SeqAndDenseState, batch):
            emb, ctx = self.params.embedding_lookup(state.table,
                                                   batch["seq"])
            emb = emb.detach().requires_grad_(True)
            params = list(state.dense.parameters())
            x = torch.cat([self._pool(emb, batch["seq"]), batch["dense"]],
                          dim=-1)
            pred = state.dense(x)[:, 0]
            loss = ((pred - batch["label"]) ** 2).mean()
            grads = torch.autograd.grad(loss, params + [emb])
            table = self.params.apply_gradients(
                state.table, ctx, grads[-1], self.opt, step=state.step)
            sgd_(params, grads[:-1], 0.02)
            return (SeqAndDenseState(table=table, dense=state.dense,
                                     step=state.step + 1),
                    loss.detach())

        return train_step

    @torch.no_grad()
    def predict(self, state: SeqAndDenseState, batch):
        emb = self.params.lookup(state.table, batch["seq"])
        x = torch.cat([self._pool(emb, batch["seq"]), batch["dense"]],
                      dim=-1)
        return state.dense(x)[:, 0]


def synthetic_seq_batch(rng: np.random.Generator, batch_size: int,
                        max_len: int = 20, vocab: int = 5000,
                        num_dense: int = 8):
    """Variable-length sequences (padded with EMPTY) and dense features;
    the label depends on the mean of per-id latent factors and the dense
    sum (numpy arrays; the same draws as the JAX package's)."""
    lens = rng.integers(1, max_len + 1, size=batch_size)
    seq = np.full((batch_size, max_len), int(de.EMPTY_KEY), np.int64)
    factor_sum = np.zeros(batch_size, np.float32)
    for i, n in enumerate(lens):
        ids = rng.integers(1, vocab + 1, size=n)
        seq[i, :n] = ids
        factor_sum[i] = np.sin(ids * 0.37).mean()
    dense = rng.normal(size=(batch_size, num_dense)).astype(np.float32)
    label = 2.0 * factor_sum + 0.5 * dense[:, :2].sum(-1)
    return {"seq": seq, "dense": dense, "label": label.astype(np.float32)}


def run_demo(steps: int = 200, batch_size: int = 256, seed: int = 0,
             mesh=None, log_every: int = 0, device=None):
    """Train and return ``(train_mse, eval_mse)``."""
    dev = resolve_device(device)
    cfg = SeqAndDenseConfig()
    model = SeqAndDenseModel(cfg, mesh=mesh, device=dev)
    state = model.init(seed)
    step_fn = model.make_train_step()
    rng = np.random.default_rng(seed)
    loss = None
    for t in range(steps):
        b = on_device(synthetic_seq_batch(rng, batch_size,
                                          cfg.max_seq_len), dev)
        state, loss = step_fn(state, b)
        if log_every and t % log_every == 0:
            print(f"step {t}: mse={float(loss):.4f}")
    eval_b = on_device(synthetic_seq_batch(rng, 1024, cfg.max_seq_len),
                       dev)
    pred = model.predict(state, eval_b)
    eval_mse = float(((pred - eval_b["label"]) ** 2).mean())
    return float(loss), eval_mse
