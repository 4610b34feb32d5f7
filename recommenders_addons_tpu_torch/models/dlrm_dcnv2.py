"""DLRM-DCNv2, the model of MLPerf Training's recommendation benchmark
(github.com/mlcommons/training, ``recommendation_v2/torchrec_dlrm``;
TorchRec's ``DLRM_DCN``), on a dynamic-embedding table.

Each example has ``num_dense`` dense features and, for each sparse
feature ``f``, a bag of ``multi_hot_sizes[f]`` ids, the batch's
``sparse`` being ``[B, sum(multi_hot_sizes)]`` with the columns grouped by
feature in feature order. One shared dynamic table holds every feature's
rows, keys tagged with the feature in the top byte (as ``models/dlrm.py``);
each bag is looked up and summed by ``embedding_lookup_sparse(combiner=
"sum")`` and the table trains through ``apply_sparse_gradients`` with the
row-wise ``Adagrad``. The dense side (:class:`DCNv2Dense`):

* ``DenseArch``: an MLP over the dense features, ReLU after every layer,
  the last included;
* ``InteractionDCNArch``: ``x_0 = cat([dense_out, pooled_1 ..
  pooled_F])``, then a low-rank cross network (``nn/cross.py``);
* ``OverArch``: an MLP, ReLU between its layers and none after the last,
  to one logit;

trained on the mean sigmoid cross-entropy with Adagrad in optax's form
(``models/dlrm.py``'s :class:`OptaxAdagrad`). A training step is one call
of the function :meth:`DLRMDCNv2.make_train_step` returns.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from recommenders_addons_tpu_torch import dynamic_embedding as de
from recommenders_addons_tpu_torch.models.dlrm import (
    FEATURE_SHIFT,
    KEY_MASK,
    dense_optimizer_for,
    optax_sigmoid_bce,
)
from recommenders_addons_tpu_torch.nn.cross import LowRankCrossNet
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.ops.sparse import (
    RaggedIds,
    apply_sparse_gradients,
    embedding_lookup_sparse,
)
from recommenders_addons_tpu_torch.utils.config import resolve_device

# MLPerf Training's --multi_hot_sizes: 214 ids an example
MLPERF_MULTI_HOT_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1,
                          1, 1, 12, 100, 27, 10, 3, 1, 1)
CROSS_RANGE = "DLRMDCNv2.cross"


@dataclasses.dataclass(frozen=True)
class DLRMDCNv2Config:
    """MLPerf Training's published settings by default (its global batch
    of 65,536 is the caller's)."""

    num_dense: int = 13
    multi_hot_sizes: Tuple[int, ...] = MLPERF_MULTI_HOT_SIZES
    dim: int = 128
    bottom_sizes: Tuple[int, ...] = (512, 256, 128)
    top_sizes: Tuple[int, ...] = (1024, 1024, 512, 256, 1)
    cross_layers: int = 3
    cross_rank: int = 512
    table_capacity: int = 1 << 22
    learning_rate: float = 0.005
    sparse_lr: float = 0.005
    value_dtype: Any = torch.float32

    def __post_init__(self):
        if self.bottom_sizes[-1] != self.dim:
            raise ValueError(f"the dense arch ends at {self.bottom_sizes[-1]}"
                             f", not at the embedding width {self.dim}")
        if min(self.multi_hot_sizes) < 1:
            raise ValueError("every bag holds at least one id")

    @property
    def num_sparse(self) -> int:
        return len(self.multi_hot_sizes)

    @property
    def ids_per_example(self) -> int:
        return sum(self.multi_hot_sizes)

    @property
    def cross_width(self) -> int:
        return (self.num_sparse + 1) * self.dim


class DCNv2Dense(nn.Module):
    """``bottom``, ``cross`` and ``top``: ``(x_dense [B, num_dense],
    pooled [B, F, D]) -> logits [B]``."""

    def __init__(self, cfg: DLRMDCNv2Config, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dt, width = cfg.value_dtype, cfg.cross_width
        self.bottom = MLP((cfg.num_dense,) + tuple(cfg.bottom_sizes), dt,
                          device, generator)
        self.cross = LowRankCrossNet(width, cfg.cross_layers, cfg.cross_rank,
                                     dt, device, generator)
        self.top = MLP((width,) + tuple(cfg.top_sizes), dt, device,
                       generator)

    def forward(self, x_dense: torch.Tensor, pooled: torch.Tensor):
        b = x_dense.shape[0]
        dense_out = torch.relu(self.bottom(x_dense))
        x0 = torch.cat([dense_out, pooled.reshape(b, -1)], dim=1)
        with torch.profiler.record_function(CROSS_RANGE):
            x = self.cross(x0)
        return self.top(x)[:, 0]


@dataclasses.dataclass
class DLRMDCNv2State:
    table: Any  # the table's TableState
    dense: DCNv2Dense  # updated in place by the train step
    step: int


class DLRMDCNv2:
    def __init__(self, cfg: DLRMDCNv2Config = DLRMDCNv2Config(),
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = self.var = de.Variable(
            name="dlrm_dcnv2_embeddings",
            dim=cfg.dim,
            init_capacity=cfg.table_capacity,
            value_dtype=cfg.value_dtype,
            initializer=de.initializers.uniform(scale=0.05),
            evict_strategy=de.EvictStrategy.LRU,
            device=self.device,
        )
        self.opt = de.Adagrad(cfg.sparse_lr)
        sizes = torch.tensor(cfg.multi_hot_sizes)
        # each column's feature, and where each feature's bag starts
        self._features = torch.repeat_interleave(
            torch.arange(cfg.num_sparse), sizes).to(self.device)
        self._starts = (torch.cumsum(sizes, 0) - sizes).to(self.device)

    def init(self, seed: int = 0) -> DLRMDCNv2State:
        """Fresh state: an empty table and dense weights drawn from
        ``seed``."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        dense = DCNv2Dense(self.cfg, self.device, gen)
        return DLRMDCNv2State(table=self.var.init(), dense=dense, step=0)

    def bags(self, ids: torch.Tensor) -> RaggedIds:
        """``[B, N]`` raw ids -> ``B * F`` bags, example-major, as one
        :class:`RaggedIds` of feature-tagged keys."""
        b, n = ids.shape
        if n != self.cfg.ids_per_example:
            raise ValueError(f"{n} ids an example, the configuration's bags "
                             f"hold {self.cfg.ids_per_example}")
        keys = ((ids.to(torch.int64) & KEY_MASK)
                | (self._features << FEATURE_SHIFT))
        rows = torch.arange(b, device=ids.device)[:, None] * n
        splits = torch.cat([(rows + self._starts).reshape(-1),
                            rows.new_full((1,), b * n)])
        return RaggedIds(keys.reshape(-1), splits.to(torch.int32))

    def loss_fn(self, dense, pooled, x_dense, labels):
        b = x_dense.shape[0]
        logits = dense(x_dense, pooled.reshape(b, self.cfg.num_sparse,
                                               self.cfg.dim))
        loss = optax_sigmoid_bce(logits, labels.to(logits.dtype)).mean()
        return loss, logits

    def make_train_step(self, dense_optimizer=None):
        """``(train_step, tx)``: ``train_step(state, opt_state, batch) ->
        (state, opt_state, loss)`` with ``opt_state = tx.init(params)``.
        ``dense_optimizer``: ``OptaxAdagrad`` (the default) or a
        ``transforms.GradientTransformation``. The table rows and the
        dense weights are updated in place."""
        tx = dense_optimizer_for(dense_optimizer, self.cfg.learning_rate)

        def train_step(state: DLRMDCNv2State, opt_state, batch):
            pooled, sctx = embedding_lookup_sparse(
                self.var, state.table, self.bags(batch["sparse"]),
                combiner="sum")
            pooled = pooled.detach().requires_grad_(True)
            params = list(state.dense.parameters())
            loss, _ = self.loss_fn(state.dense, pooled, batch["dense"],
                                   batch["label"])
            grads = torch.autograd.grad(loss, params + [pooled])
            # the lookup stamps no score: the apply stamps the step
            table = apply_sparse_gradients(
                self.var, state.table, sctx, grads[-1], self.opt,
                step=state.step + 1)
            opt_state = tx.apply(params, grads[:-1], opt_state)
            return (DLRMDCNv2State(table=table, dense=state.dense,
                                   step=state.step + 1),
                    opt_state, loss.detach())

        return train_step, tx

    @torch.no_grad()
    def predict(self, state: DLRMDCNv2State, batch):
        pooled = embedding_lookup_sparse(
            self.var, state.table, self.bags(batch["sparse"]),
            combiner="sum", training=False)
        return state.dense(batch["dense"], pooled)
