"""Two-tower retrieval on dynamic-embedding tables — the port of the JAX
package's ``models/retrieval.py`` (the reference's two-tower retrieval
demo).

The user and item ids index two dynamic tables, so unseen users and items
join the vocabulary on first touch; the towers (MLPs, empty by default:
matrix factorization) map the rows to unit vectors whose dot products
score the pairs, trained with an in-batch softmax (positives on the
diagonal). Both tables train with the row-wise ``Adagrad`` (the fused
optimizer-scatter kernel), the towers with plain SGD.

With ``mesh=`` both tables are ``parallel.ShardedVariable``s.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch
from torch import nn

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.common import on_device, sgd_
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    dim: int = 64
    # () = matrix factorization (the dot product of the id embeddings),
    # the JAX package's default for vocabularies learned from scratch
    tower_sizes: Tuple[int, ...] = ()
    user_capacity: int = 1 << 17
    item_capacity: int = 1 << 15
    lr: float = 0.05
    temperature: float = 0.2


@dataclasses.dataclass
class TwoTowerState:
    user: Any
    item: Any
    dense: nn.ModuleDict  # "user", "item" towers, updated in place
    step: int


class TwoTowerModel:
    """User tower x item tower -> dot-product scores; in-batch softmax."""

    def __init__(self, cfg: TwoTowerConfig = TwoTowerConfig(), mesh=None,
                 device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        init = de.initializers.normal(0.05)

        def make(name, cap):
            var = de.Variable(name=name, dim=cfg.dim, init_capacity=cap,
                              initializer=init, device=self.device)
            return ShardedVariable(var, mesh) if mesh is not None else var

        self.user = make("tt_user", cfg.user_capacity)
        self.item = make("tt_item", cfg.item_capacity)
        self.opt = de.Adagrad(cfg.lr)

    def init(self, seed: int = 0) -> TwoTowerState:
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        sizes = (cfg.dim,) + cfg.tower_sizes
        dense = nn.ModuleDict({
            "user": MLP(sizes, device=self.device, generator=gen),
            "item": MLP(sizes, device=self.device, generator=gen)})
        return TwoTowerState(user=self.user.init(), item=self.item.init(),
                             dense=dense, step=0)

    @staticmethod
    def _towers(dense, u_emb, i_emb):
        u = dense["user"](u_emb)
        v = dense["item"](i_emb)
        u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-9)
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-9)
        return u, v

    def make_train_step(self):
        """``train_step(state, batch) -> (state, loss)``; the table rows
        and the towers are updated in place."""
        cfg = self.cfg

        def train_step(state: TwoTowerState, batch):
            u_emb, u_ctx = self.user.embedding_lookup(state.user,
                                                      batch["user"])
            i_emb, i_ctx = self.item.embedding_lookup(state.item,
                                                      batch["item"])
            u_emb = u_emb.detach().requires_grad_(True)
            i_emb = i_emb.detach().requires_grad_(True)
            params = list(state.dense.parameters())
            u, v = self._towers(state.dense, u_emb, i_emb)
            logits = (u @ v.T) / cfg.temperature
            loss = -torch.log_softmax(logits, dim=-1).diagonal().mean()
            grads = torch.autograd.grad(loss, params + [u_emb, i_emb])
            user = self.user.apply_gradients(state.user, u_ctx, grads[-2],
                                             self.opt, step=state.step)
            item = self.item.apply_gradients(state.item, i_ctx, grads[-1],
                                             self.opt, step=state.step)
            sgd_(params, grads[:-2], 0.05)
            return (TwoTowerState(user=user, item=item, dense=state.dense,
                                  step=state.step + 1),
                    loss.detach())

        return train_step

    @torch.no_grad()
    def score(self, state: TwoTowerState, user_ids, item_ids):
        """Dot-product scores of (user, item) pairs."""
        u, v = self._towers(state.dense,
                            self.user.lookup(state.user, user_ids),
                            self.item.lookup(state.item, item_ids))
        return (u * v).sum(dim=-1)

    @torch.no_grad()
    def retrieve(self, state: TwoTowerState, user_ids, candidate_ids,
                 k: int = 10):
        """Top-k candidates per user, by brute force over the candidates
        (as the reference's demos do). Among equal scores the order may
        differ from the JAX package's ``top_k``."""
        u, v = self._towers(state.dense,
                            self.user.lookup(state.user, user_ids),
                            self.item.lookup(state.item, candidate_ids))
        top = torch.topk(u @ v.T, k, dim=-1).indices
        return candidate_ids[top]


def synthetic_interactions(rng: np.random.Generator, batch_size: int,
                           num_users: int = 5000, num_items: int = 2000,
                           num_groups: int = 8):
    """Clustered user-item interactions: users and items belong to latent
    groups, and a user interacts mostly within its group (numpy arrays;
    the same draws as the JAX package's)."""
    users = rng.integers(1, num_users + 1, size=batch_size).astype(np.int64)
    ugroup = users % num_groups
    in_group = rng.random(batch_size) < 0.9
    items = np.where(
        in_group,
        ugroup + num_groups * rng.integers(0, num_items // num_groups,
                                           size=batch_size),
        rng.integers(0, num_items, size=batch_size),
    ).astype(np.int64) + 1
    return {"user": users, "item": items}


def run_demo(steps: int = 300, batch_size: int = 256, seed: int = 0,
             mesh=None, log_every: int = 0, num_users: int = 500,
             num_items: int = 512, device=None):
    """Train, then return ``(loss, recall)``: the share of each of 64
    users' top-10 retrievals that fall in the user's group."""
    dev = resolve_device(device)
    model = TwoTowerModel(mesh=mesh, device=dev)
    state = model.init(seed)
    step_fn = model.make_train_step()
    rng = np.random.default_rng(seed)
    loss = None
    for t in range(steps):
        batch = on_device(synthetic_interactions(
            rng, batch_size, num_users=num_users, num_items=num_items), dev)
        state, loss = step_fn(state, batch)
        if log_every and t % log_every == 0:
            print(f"step {t}: loss={float(loss):.4f}")
    users = rng.integers(1, num_users + 1, size=64).astype(np.int64)
    cands = np.arange(1, min(num_items, 512) + 1, dtype=np.int64)
    top = model.retrieve(state, torch.from_numpy(users).to(dev),
                         torch.from_numpy(cands).to(dev), k=10)
    ug = (users % 8)[:, None]
    ig = (top.cpu().numpy() - 1) % 8
    return float(loss), float((ig == ug).mean())
