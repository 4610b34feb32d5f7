"""DCN-v2 (Deep & Cross Network) on a dynamic-embedding table — the port
of the JAX package's ``models/dcn.py``.

Full-rank cross layers ``x_{l+1} = x_0 * (x_l W_l + b_l) + x_l`` beside a
deep MLP tower (the "stacked" DCN-v2 topology, Wang et al. 2021), over
the same embedding side as DLRM (``models/dlrm.py``): one shared dynamic
table for all categorical features, keys tagged with the feature id, one
lookup a step, the row-wise ``Adagrad`` through the fused
optimizer-scatter kernel. The towers train with Adagrad in optax's form.

With ``mesh=`` the table is a ``parallel.ShardedVariable``; its step
passes no ``step`` at lookup, as the JAX package's sharded DCN.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.common import on_device
from recommenders_addons_tpu_torch.models.dlrm import (
    OptaxAdagrad,
    batch_auc,
    dense_optimizer_for,
    optax_sigmoid_bce,
    synthetic_criteo_batch,
    tag_keys,
)
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    num_dense: int = 13
    num_sparse: int = 26
    dim: int = 32
    num_cross: int = 3
    deep_sizes: Tuple[int, ...] = (256, 128)
    table_capacity: int = 1 << 22
    value_dtype: Any = torch.float32
    learning_rate: float = 0.01
    sparse_lr: float = 0.01

    @property
    def input_dim(self) -> int:
        return self.num_dense + self.num_sparse * self.dim


class DCNDense(nn.Module):
    """The cross layers, the deep tower and the head:
    ``(x_dense [B, num_dense], emb [B, F, D]) -> logits [B]``. Cross
    weights are ``[I, I]`` for ``x @ w``, drawn ``normal * 0.5 / sqrt(I)``
    (early crosses stay near the identity), biases zero."""

    def __init__(self, cfg: DCNConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        i, dt = cfg.input_dim, cfg.value_dtype
        self.cross_w = nn.ParameterList()
        self.cross_b = nn.ParameterList()
        for _ in range(cfg.num_cross):
            w = torch.randn((i, i), generator=generator, dtype=dt,
                            device=device)
            self.cross_w.append(nn.Parameter(w * (0.5 / math.sqrt(i))))
            self.cross_b.append(nn.Parameter(torch.zeros(i, dtype=dt,
                                                         device=device)))
        self.deep = MLP((i,) + tuple(cfg.deep_sizes), dt, device, generator)
        self.head = MLP((i + cfg.deep_sizes[-1], 1), dt, device, generator)

    def forward(self, x_dense: torch.Tensor, emb: torch.Tensor):
        b = x_dense.shape[0]
        x0 = torch.cat([x_dense, emb.reshape(b, -1)], dim=-1)  # [B, I]
        x = x0
        for w, bias in zip(self.cross_w, self.cross_b):
            x = x0 * (x @ w + bias) + x  # the DCN-v2 cross
        deep = self.deep(x0)
        return self.head(torch.cat([x, deep], dim=-1))[:, 0]


@dataclasses.dataclass
class DCNState:
    table: Any  # the table's TableState
    dense: DCNDense  # updated in place by the train step
    step: int


class DCN:
    def __init__(self, cfg: DCNConfig = DCNConfig(), mesh=None,
                 axis: str = "ep", device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        var = de.Variable(
            name="dcn_embeddings",
            dim=cfg.dim,
            init_capacity=cfg.table_capacity,
            value_dtype=cfg.value_dtype,
            initializer=de.initializers.uniform(scale=0.05),
            evict_strategy=de.EvictStrategy.LRU,
            device=self.device,
        )
        if mesh is not None:
            self.params = ShardedVariable(var, mesh, axis=axis)
            self.var = self.params.var
        else:
            self.params = self.var = var
        self.opt = de.Adagrad(cfg.sparse_lr)

    def init(self, seed: int = 0) -> DCNState:
        """Fresh state: an empty table and dense weights drawn from
        ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dense = DCNDense(self.cfg, self.device, gen)
        return DCNState(table=self.params.init(), dense=dense, step=0)

    def loss_fn(self, dense, emb_flat, x_dense, labels):
        b = x_dense.shape[0]
        emb = emb_flat.reshape(b, self.cfg.num_sparse, self.cfg.dim)
        logits = dense(x_dense, emb)
        loss = optax_sigmoid_bce(logits, labels.to(logits.dtype)).mean()
        return loss, logits

    def make_train_step(self, dense_optimizer=None):
        """``(train_step, tx)``: ``train_step(state, opt_state, batch) ->
        (state, opt_state, loss)`` with ``opt_state = tx.init(params)``.
        ``dense_optimizer``: ``OptaxAdagrad`` (the default) or a
        ``transforms.GradientTransformation``. The table rows and the
        dense weights are updated in place."""
        tx = dense_optimizer_for(dense_optimizer, self.cfg.learning_rate)

        def train_step(state: DCNState, opt_state, batch):
            keys = tag_keys(batch["sparse"]).reshape(-1)
            # the step at lookup: the LRU score stamp doubles as the
            # duplicate probe (Variable.embedding_lookup); the sharded
            # step passes none, as the JAX package's does
            kw = {"step": state.step + 1} if self.mesh is None else {}
            emb_flat, ctx = self.params.embedding_lookup(state.table, keys,
                                                         **kw)
            emb = emb_flat.detach().requires_grad_(True)
            params = list(state.dense.parameters())
            loss, _ = self.loss_fn(state.dense, emb, batch["dense"],
                                   batch["label"])
            grads = torch.autograd.grad(loss, params + [emb])
            table = self.params.apply_gradients(
                state.table, ctx, grads[-1], self.opt, step=state.step)
            opt_state = tx.apply(params, grads[:-1], opt_state)
            return (DCNState(table=table, dense=state.dense,
                             step=state.step + 1),
                    opt_state, loss.detach())

        return train_step, tx

    @torch.no_grad()
    def predict(self, state: DCNState, batch):
        keys = tag_keys(batch["sparse"]).reshape(-1)
        emb_flat = self.params.lookup(state.table, keys)
        b = batch["dense"].shape[0]
        emb = emb_flat.reshape(b, self.cfg.num_sparse, self.cfg.dim)
        return state.dense(batch["dense"], emb)


def run_demo(steps: int = 100, batch_size: int = 512, dim: int = 16,
             log_every: int = 25, device=None):
    """Train a small DCN on the synthetic Criteo generator; returns
    ``(final train loss, held-out AUC)``."""
    dev = resolve_device(device)
    cfg = DCNConfig(dim=dim, table_capacity=1 << 16, deep_sizes=(64, 32),
                    num_cross=2)
    model = DCN(cfg, device=dev)
    state = model.init(0)
    state = dataclasses.replace(
        state, table=de.create_slots(model.var, state.table, model.opt))
    train_step, tx = model.make_train_step(OptaxAdagrad(0.05))
    opt_state = tx.init(list(state.dense.parameters()))
    rng = np.random.default_rng(0)
    loss = None
    for t in range(steps):
        batch = on_device(synthetic_criteo_batch(rng, batch_size), dev)
        state, opt_state, loss = train_step(state, opt_state, batch)
        if log_every and t % log_every == 0:
            print(f"step {t}: loss={float(loss):.4f}", flush=True)
    logits, labels = [], []
    for _ in range(4):
        b = synthetic_criteo_batch(rng, batch_size)
        logits.append(
            model.predict(state, on_device(b, dev)).cpu().numpy())
        labels.append(b["label"])
    auc = batch_auc(np.concatenate(logits), np.concatenate(labels))
    return float(loss), auc
