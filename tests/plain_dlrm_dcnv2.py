"""A plain reference of DLRM-DCNv2 training, for the CPU tests of the
port's ``models/dlrm_dcnv2.py``: MLPerf Training's model
(github.com/mlcommons/training, ``recommendation_v2/torchrec_dlrm``;
TorchRec's ``DLRM_DCN`` in ``torchrec/models/dlrm.py`` and
``LowRankCrossNet`` in ``torchrec/modules/crossnet.py``) written out in
plain float32 PyTorch, TF32 off, on a dict of dense weights by name and a
dict of table rows by key. It imports neither JAX nor any module of the
port; the initial row of a key the table does not hold is the caller's
(``init_rows``). Where it departs from TorchRec, the line says so.

The equations, weights ``[in, out]`` for ``x @ w``:

* ``dense_out = relu(... relu(x_dense @ bottom.w.0 + bottom.b.0) ...)``,
  a ReLU after every layer, the last included (``DenseArch``);
* ``x_0 = cat([dense_out, pooled_1, .., pooled_F])``, the dense output
  first (``InteractionDCNArch``);
* ``x_{l+1} = x_0 * ((x_l @ cross.v.l) @ cross.w.l + cross.b.l) + x_l``
  (``LowRankCrossNet``);
* ``logit = top(x_L)``, ReLU between the layers and none after the last
  (``OverArch``); the loss the mean sigmoid cross-entropy.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import torch

# float32 products, never TF32 (cuBLAS on a card may otherwise use it)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FEATURE_SHIFT = 56


def tag(ids: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``[B, N]`` raw ids -> int64 keys, each column's feature (its bag's
    index in ``sizes``) in the top byte."""
    features = torch.repeat_interleave(torch.arange(len(sizes)),
                                       torch.tensor(list(sizes)))
    return ids.to(torch.int64) | (features << FEATURE_SHIFT)


def pool(emb: torch.Tensor, sizes: Sequence[int]) -> torch.Tensor:
    """``[B, N, D]`` rows -> ``[B, F, D]``, each bag summed in float64 and
    rounded to float32 once (TorchRec's sum pooling accumulates in
    float32, in an order of its kernel's choosing)."""
    features = torch.repeat_interleave(torch.arange(len(sizes)),
                                       torch.tensor(list(sizes)))
    out = torch.zeros((emb.shape[0], len(sizes), emb.shape[2]),
                      dtype=torch.float64)
    return out.index_add_(1, features, emb.double()).to(emb.dtype)


def mlp(w: Dict[str, torch.Tensor], prefix: str, x: torch.Tensor,
        relu_last: bool) -> torch.Tensor:
    n = sum(1 for k in w if k.startswith(prefix + ".w."))
    for i in range(n):
        x = x @ w[f"{prefix}.w.{i}"] + w[f"{prefix}.b.{i}"]
        if i < n - 1 or relu_last:
            x = torch.relu(x)
    return x


def cross(x0: torch.Tensor, vs: List[torch.Tensor], ws: List[torch.Tensor],
          bs: List[torch.Tensor]) -> torch.Tensor:
    x = x0
    for v, w, b in zip(vs, ws, bs):
        x = x0 * ((x @ v) @ w + b) + x
    return x


def logits(w: Dict[str, torch.Tensor], x_dense: torch.Tensor,
           pooled: torch.Tensor) -> torch.Tensor:
    """``(x_dense [B, num_dense], pooled [B, F, D]) -> [B]``."""
    b = x_dense.shape[0]
    dense_out = mlp(w, "bottom", x_dense, relu_last=True)
    x0 = torch.cat([dense_out, pooled.reshape(b, -1)], dim=1)
    n = sum(1 for k in w if k.startswith("cross.v."))
    x = cross(x0, [w[f"cross.v.{i}"] for i in range(n)],
              [w[f"cross.w.{i}"] for i in range(n)],
              [w[f"cross.b.{i}"] for i in range(n)])
    return mlp(w, "top", x, relu_last=False).reshape(b)


def bce(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits (``BCEWithLogitsLoss``), in
    the stable form."""
    per = (torch.relu(logit) - logit * label
           + torch.log1p(torch.exp(-logit.abs())))
    return per.mean()


@dataclasses.dataclass
class Reference:
    """Training state: dense weights and their accumulators, and the table
    as ``{key: (row [D], accumulator [D])}``.

    Optimizers, each departing from MLPerf's (FBGEMM's row-wise Adagrad on
    the tables, ``torch.optim.Adagrad`` on the dense weights):

    * the table: Adagrad with an accumulator per element, ``acc += g*g;
      row -= lr * g / (sqrt(acc) + eps)``, ``g`` a key's gradient summed
      over its positions in float64 and rounded once; a new key's
      accumulator starts at ``table_acc0``;
    * the dense weights: Adagrad in optax's form, ``acc = g*g + acc; p -=
      lr * g * rsqrt(acc + eps)`` (0 where ``acc`` is 0), ``acc`` from
      ``dense_acc0``."""

    sizes: Sequence[int]
    weights: Dict[str, torch.Tensor]
    table: Dict[int, tuple]
    init_rows: Callable[[torch.Tensor], torch.Tensor]
    dense_lr: float
    table_lr: float
    dense_acc0: float = 0.1
    table_acc0: float = 0.1
    eps: float = 1e-7

    def __post_init__(self):
        self.weights = {k: v.detach().clone() for k, v in self.weights.items()}
        self.dense_acc = {k: torch.full_like(v, self.dense_acc0)
                          for k, v in self.weights.items()}

    def rows(self, keys: torch.Tensor):
        """``(rows [U, D], accumulators [U, D])`` of unique ``keys``: held
        rows, else the initial row and accumulator."""
        init = self.init_rows(keys)
        rows, accs = [], []
        for i, k in enumerate(keys.tolist()):
            row, acc = self.table.get(k, (init[i],
                                          torch.full_like(init[i],
                                                          self.table_acc0)))
            rows.append(row)
            accs.append(acc)
        return torch.stack(rows), torch.stack(accs)

    def predict(self, batch) -> torch.Tensor:
        keys = tag(batch["sparse"], self.sizes)
        uniq, inv = torch.unique(keys, return_inverse=True)
        v, _ = self.rows(uniq)
        return logits(self.weights, batch["dense"], pool(v[inv], self.sizes))

    def step(self, batch):
        """One training step: ``(loss, {leaf: gradient})``."""
        keys = tag(batch["sparse"], self.sizes)
        uniq, inv = torch.unique(keys, return_inverse=True)
        v, acc = self.rows(uniq)
        names = sorted(self.weights)
        leaves = {k: self.weights[k].clone().requires_grad_(True)
                  for k in names}
        emb = v[inv].detach().requires_grad_(True)  # [B, N, D]
        loss = bce(logits(leaves, batch["dense"], pool(emb, self.sizes)),
                   batch["label"])
        grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [emb])
        g = torch.zeros(v.shape, dtype=torch.float64).index_add_(
            0, inv.reshape(-1), grads[-1].reshape(-1, v.shape[1]).double()
        ).to(v.dtype)
        new_acc = acc + g * g
        new_v = v - self.table_lr * g / (torch.sqrt(new_acc) + self.eps)
        for i, k in enumerate(uniq.tolist()):
            self.table[k] = (new_v[i], new_acc[i])
        dgrads = dict(zip(names, grads[:-1]))
        with torch.no_grad():
            for k in names:
                a = dgrads[k] * dgrads[k] + self.dense_acc[k]
                inv_s = torch.where(a > 0, torch.rsqrt(a + self.eps), 0.0)
                self.weights[k] = self.weights[k] + (
                    -self.dense_lr * (inv_s * dgrads[k]))
                self.dense_acc[k] = a
        return loss.detach(), dgrads
