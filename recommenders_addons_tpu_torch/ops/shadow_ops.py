"""`de.shadow_ops` — the reference's eager trainability layer
(python/ops/shadow_embedding_ops.py:61-457), the port of the JAX
package's ``ops/shadow_ops.py``.

The reference re-looks-up rows into a buffer variable on every read so
that TF's autodiff sees them. Here a "shadow" is a thin stateful wrapper
over ``Variable.embedding_lookup`` that keeps the last ``LookupContext``
(what the reference's ids / exists buffers carry), so reference call
sites translate one to one::

    shadow = de.shadow_ops.ShadowVariable(var)
    emb = de.shadow_ops.embedding_lookup(shadow, state, ids)
    ...
    state = shadow.apply_gradients(state, grads, optimizer, step)
"""

from __future__ import annotations

from typing import Optional

import torch

from recommenders_addons_tpu_torch.ops.variable import (
    LookupContext,
    ModelMode,
    Variable,
    get_model_mode,
)


class ShadowVariable:
    """Trainable-lookup handle for one ``Variable`` (the reference's
    ShadowVariable, shadow_embedding_ops.py:61-236): the variable and the
    residuals of its most recent lookup. Not safe across concurrent
    steps: make one per step in flight."""

    def __init__(self, params, name: Optional[str] = None,
                 max_norm=None, trainable: bool = True, **_compat):
        self.params = params
        self.name = name or f"shadow_{getattr(params, 'name', 'de')}"
        self.max_norm = max_norm
        self.trainable = trainable
        self.ctx: Optional[LookupContext] = None

    @property
    def var(self) -> Variable:
        return getattr(self.params, "var", self.params)

    def lookup(self, state, ids, training: Optional[bool] = None):
        """Rows of ``ids``: a trainable lookup in TRAIN mode (its context
        kept for :meth:`apply_gradients`), a plain probe otherwise; with
        ``max_norm`` each row is scaled down to that L2 norm."""
        if training is None:
            training = get_model_mode() == ModelMode.TRAIN
        if not training:
            return self.params.lookup(state, ids)
        emb, ctx = self.params.embedding_lookup(state, ids)
        self.ctx = ctx
        if self.max_norm is not None:
            norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            emb = emb * torch.clamp(self.max_norm / (norm + 1e-12), max=1.0)
        return emb

    def apply_gradients(self, state, grads, optimizer, step=0, epoch=0):
        if self.ctx is None:
            raise ValueError("no lookup recorded; call lookup() first")
        return self.params.apply_gradients(state, self.ctx, grads, optimizer,
                                           step=step, epoch=epoch)


def embedding_lookup(shadow: ShadowVariable, state, ids, training=None):
    """The reference's shadow_ops.embedding_lookup
    (shadow_embedding_ops.py:239-281)."""
    return shadow.lookup(state, ids, training=training)


def embedding_lookup_unique(shadow: ShadowVariable, state, ids,
                            training=None):
    """The reference's shadow_ops.embedding_lookup_unique
    (shadow_embedding_ops.py:284-356): every trainable lookup dedups, so
    it is the same call."""
    return shadow.lookup(state, ids, training=training)


# the reference's TF variable-machinery names (embedding_weights.py,
# distributed_embedding_variable.py): there is no resource-variable
# buffer to wrap, so they name the one handle
TrainableWrapper = ShadowVariable
DEResourceVariable = ShadowVariable
HvdVariable = ShadowVariable
DistributedVariableWrapper = ShadowVariable


class EmbeddingWeights:
    """The reference's abstract base (embedding_weights.py:50-95)."""

    @staticmethod
    def verify_embedding_weights(weights, ids=None):
        if not isinstance(weights, (ShadowVariable, Variable)) and not (
                hasattr(weights, "embedding_lookup")):
            raise TypeError(f"not an embedding weight: {type(weights)}")

    def embedding_lookup(self, *a, **k):
        raise NotImplementedError


def trainable_wrapper_filter(variables):
    """Split a list into (dynamic-embedding handles, dense others) (the
    reference's dynamic_embedding_ops.py:462-475)."""
    sparse, dense = [], []
    for v in variables:
        if isinstance(v, (ShadowVariable, Variable)) or hasattr(
                v, "embedding_lookup"):
            sparse.append(v)
        else:
            dense.append(v)
    return sparse, dense
