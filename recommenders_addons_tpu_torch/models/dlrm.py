"""DLRM (Criteo CTR) on a dynamic-embedding table — the port of the JAX
package's ``models/dlrm.py``, the flagship training workload.

One shared dynamic table holds all 26 categorical features, keys tagged
with the feature id in the top byte (:func:`tag_keys`); the bottom and
top towers are dense MLPs (an ``nn.Module``, :class:`DenseTowers`); the
table trains with the row-wise ``Adagrad`` through the fused
optimizer-scatter kernel, the towers with Adagrad in optax's form
(:class:`OptaxAdagrad`) or any ``transforms.GradientTransformation``
(:class:`DenseTransform`). A training step is one call of the function
:meth:`DLRM.make_train_step` returns.

With ``mesh=`` the table is a ``parallel.ShardedVariable`` over the
mesh's shards (all-to-all routed lookup and apply) and the towers stay
as they are, on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.ops import transforms
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    num_dense: int = 13
    num_sparse: int = 26
    dim: int = 64
    bottom_sizes: Tuple[int, ...] = (512, 256, 64)
    top_sizes: Tuple[int, ...] = (512, 256, 1)
    table_capacity: int = 1 << 22
    value_dtype: Any = torch.float32
    learning_rate: float = 0.01
    sparse_lr: float = 0.01

    @property
    def interact_dim(self) -> int:
        n = self.num_sparse + 1
        return n * (n - 1) // 2

    @property
    def bottom_out_sizes(self) -> Tuple[int, ...]:
        """Bottom sizes with the output forced to ``dim`` (the interaction
        needs the dense vector as wide as an embedding)."""
        return tuple(self.bottom_sizes[:-1]) + (self.dim,)


class DenseTowers(nn.Module):
    """The bottom MLP, the pairwise dot-product interaction and the top
    MLP: ``(x_dense [B, num_dense], emb [B, F, D]) -> logits [B]``."""

    def __init__(self, cfg: DLRMConfig, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt = cfg.value_dtype
        self.bottom = MLP((cfg.num_dense,) + cfg.bottom_out_sizes, dt,
                          device, generator)
        self.top = MLP((cfg.dim + cfg.interact_dim,) + cfg.top_sizes, dt,
                       device, generator)
        iu, ju = np.triu_indices(cfg.num_sparse + 1, k=1)
        self.register_buffer("iu", torch.from_numpy(iu).to(device))
        self.register_buffer("ju", torch.from_numpy(ju).to(device))

    def forward(self, x_dense: torch.Tensor, emb: torch.Tensor):
        bottom = self.bottom(x_dense)  # [B, D]
        z = torch.cat([bottom[:, None, :], emb], dim=1)  # [B, F+1, D]
        inter = torch.bmm(z, z.transpose(1, 2))
        top_in = torch.cat([bottom, inter[:, self.iu, self.ju]], dim=-1)
        return self.top(top_in)[:, 0]


@dataclasses.dataclass
class DLRMState:
    table: Any  # the table's TableState
    dense: DenseTowers  # updated in place by the train step
    step: int


FEATURE_SHIFT = 56
KEY_MASK = (1 << 56) - 1


def tag_keys(ids: torch.Tensor) -> torch.Tensor:
    """[B, F] raw ids -> feature-tagged global keys (top byte = feature)."""
    f = torch.arange(ids.shape[-1], dtype=torch.int64, device=ids.device)
    return (ids.to(torch.int64) & KEY_MASK) | (f << FEATURE_SHIFT)


def optax_sigmoid_bce(logits, labels):
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


class OptaxAdagrad:
    """Dense Adagrad with optax's semantics (``optax.adagrad``): the
    accumulator starts at ``initial_accumulator_value``, and the update is
    ``-lr * g * rsqrt(acc + eps)`` (eps inside the root; 0 where the
    accumulator is 0), unlike ``torch.optim.Adagrad``, which starts at 0
    and adds eps outside the root."""

    def __init__(self, learning_rate: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        self.learning_rate = learning_rate
        self.initial_accumulator_value = initial_accumulator_value
        self.eps = eps

    def init(self, params):
        return [torch.full_like(p, self.initial_accumulator_value)
                for p in params]

    @torch.no_grad()
    def apply(self, params, grads, state):
        """Update ``params`` in place; returns the new accumulators."""
        new_state = []
        for p, g, acc in zip(params, grads, state):
            acc = g * g + acc
            inv = torch.where(acc > 0, torch.rsqrt(acc + self.eps), 0.0)
            p.add_(-self.learning_rate * (inv * g))
            new_state.append(acc)
        return new_state


class DenseTransform:
    """A ``transforms.GradientTransformation`` (the port's optax-shaped
    transforms) as a model's dense optimizer: ``init(params)`` and
    ``apply(params, grads, state)``, which adds the updates to the params
    in place (optax's ``apply_updates``) and returns the new state."""

    def __init__(self, tx: transforms.GradientTransformation):
        self.tx = tx

    def init(self, params):
        return self.tx.init([p.detach() for p in params])

    @torch.no_grad()
    def apply(self, params, grads, state):
        updates, state = self.tx.update(list(grads), state,
                                        [p.detach() for p in params])
        for p, u in zip(params, updates):
            p.add_(u)
        return state


def dense_optimizer_for(dense_optimizer, learning_rate: float):
    """The models' dense optimizer: ``OptaxAdagrad(learning_rate)`` by
    default, a transform wrapped in :class:`DenseTransform`, or anything
    with ``init`` / ``apply`` as it is."""
    if dense_optimizer is None:
        return OptaxAdagrad(learning_rate)
    if isinstance(dense_optimizer, transforms.GradientTransformation):
        return DenseTransform(dense_optimizer)
    return dense_optimizer


class DLRM:
    def __init__(self, cfg: DLRMConfig = DLRMConfig(), mesh=None,
                 axis: str = "ep", device=None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        var = de.Variable(
            name="dlrm_embeddings",
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

    def init(self, seed: int = 0) -> DLRMState:
        """Fresh state: an empty table and towers drawn from ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dense = DenseTowers(self.cfg, self.device, gen)
        return DLRMState(table=self.params.init(), dense=dense, step=0)

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
        tower weights are updated in place."""
        tx = dense_optimizer_for(dense_optimizer, self.cfg.learning_rate)

        def train_step(state: DLRMState, opt_state, batch):
            keys = tag_keys(batch["sparse"]).reshape(-1)
            # the step at lookup (both paths): the LRU score stamp
            # doubles as the duplicate probe (Variable.embedding_lookup;
            # the sharded path stamps it on each owner)
            emb_flat, ctx = self.params.embedding_lookup(
                state.table, keys, step=state.step + 1)
            emb = emb_flat.detach().requires_grad_(True)
            params = list(state.dense.parameters())
            loss, _ = self.loss_fn(state.dense, emb, batch["dense"],
                                   batch["label"])
            grads = torch.autograd.grad(loss, params + [emb])
            table = self.params.apply_gradients(
                state.table, ctx, grads[-1], self.opt, step=state.step)
            opt_state = tx.apply(params, grads[:-1], opt_state)
            return (DLRMState(table=table, dense=state.dense,
                              step=state.step + 1),
                    opt_state, loss.detach())

        return train_step, tx

    @torch.no_grad()
    def predict(self, state: DLRMState, batch):
        keys = tag_keys(batch["sparse"]).reshape(-1)
        emb_flat = self.params.lookup(state.table, keys)
        b = batch["dense"].shape[0]
        emb = emb_flat.reshape(b, self.cfg.num_sparse, self.cfg.dim)
        return state.dense(batch["dense"], emb)


def batch_auc(logits: np.ndarray, labels: np.ndarray) -> float:
    """Mann-Whitney AUC on a batch (host-side metric)."""
    order = np.argsort(logits)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(logits) + 1)
    pos = labels > 0.5
    n_pos, n_neg = pos.sum(), (~pos).sum()
    if n_pos == 0 or n_neg == 0:
        return 0.5
    return float(
        (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def synthetic_criteo_batch(rng: np.random.Generator, batch_size: int,
                           num_dense=13, num_sparse=26,
                           vocab_per_feature=100_000):
    """Synthetic Criteo-like batch with a learnable signal: the label
    depends on a linear function of the dense features and a few 'lucky'
    categorical ids (numpy arrays; the same draws as the JAX package's)."""
    dense = rng.normal(size=(batch_size, num_dense)).astype(np.float32)
    ids = (rng.zipf(1.2, size=(batch_size, num_sparse))
           % vocab_per_feature).astype(np.int64)
    signal = dense[:, :3].sum(-1) * 0.5 + ((ids[:, :4] % 7) == 0).sum(-1) - 1.0
    prob = 1.0 / (1.0 + np.exp(-signal))
    label = (rng.random(batch_size) < prob).astype(np.float32)
    return {"dense": dense, "sparse": ids, "label": label}
