"""Embedding layers — the port of the JAX package's ``nn/layers.py`` (the
reference's Keras layer set and its dynamic layer normalization).

Each embedding layer is an ``nn.Module`` that holds its ``Variable``; the
table's storage stays an explicit ``TableState`` that the caller threads
through ``layer(state, ids, training)`` and
``layer.apply_gradients(state, ctx, grads, optimizer)``, as in the JAX
package. With ``mesh=`` the table is a ``parallel.ShardedVariable``
(``layer.params``) over the mesh's shards, and its state a
``ShardedState``. A training call returns the rows and the lookup's
context; the gradient the apply takes is the one with respect to the
looked-up rows (``ctx.rows``), as ``Variable.apply_gradients`` takes it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from recommenders_addons_tpu_torch.ops import hashtable, segment
from recommenders_addons_tpu_torch.ops import sparse as sparse_ops
from recommenders_addons_tpu_torch.ops.variable import EvictStrategy, Variable
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import resolve_device


class Embedding(nn.Module):
    """Dynamic-embedding layer (the reference's ``Embedding`` /
    ``BasicEmbedding``): a training call is the deduplicating trainable
    lookup, whose misses take their initial rows and are inserted by the
    optimizer's writeback."""

    def __init__(self, embedding_size: int, key_dtype=torch.int64,
                 value_dtype=torch.float32, combiner: str = "sum",
                 initializer=None, name: str = "DynamicEmbeddingLayer",
                 init_capacity: int = 1024 * 1024, evict_strategy=None,
                 bp_v2: bool = False, mesh=None, mesh_axis: str = "ep",
                 capacity_factor: float = 2.0, device=None, **kwargs):
        super().__init__()
        del kwargs
        self.embedding_size = embedding_size
        self.combiner = combiner
        self.name = name
        var = Variable(
            name=name, key_dtype=key_dtype, value_dtype=value_dtype,
            dim=embedding_size, init_capacity=init_capacity,
            initializer=initializer, bp_v2=bp_v2,
            evict_strategy=evict_strategy or EvictStrategy.LRU,
            device=device)
        if mesh is not None:
            self.params = ShardedVariable(var, mesh, axis=mesh_axis,
                                          capacity_factor=capacity_factor)
            self.var = self.params.var
        else:
            self.params = self.var = var

    @property
    def dim(self) -> int:
        return self.embedding_size

    def get_config(self) -> dict:
        """The JAX package's serialized form (dtype and strategy names)."""
        var = self.var
        return {
            "embedding_size": self.embedding_size,
            "combiner": self.combiner,
            "name": self.name,
            "key_dtype": hashtable.dtype_name(var.key_dtype),
            "value_dtype": hashtable.dtype_name(var.value_dtype),
            "init_capacity": var.init_capacity,
            "bp_v2": var.bp_v2,
            "evict_strategy": var.evict_strategy.name,
        }

    @classmethod
    def from_config(cls, config: dict, mesh=None, device=None, **kwargs):
        """The layer :meth:`get_config` describes; ``kwargs`` adds what
        the config leaves out (``FieldWiseEmbedding``'s ``nslots`` and
        ``slot_map_fn``)."""
        cfg = dict(config, **kwargs)
        cfg["evict_strategy"] = EvictStrategy[cfg["evict_strategy"]]
        cfg["key_dtype"] = hashtable.torch_dtype(cfg["key_dtype"])
        cfg["value_dtype"] = hashtable.torch_dtype(cfg["value_dtype"])
        return cls(mesh=mesh, device=device, **cfg)

    def init_state(self):
        return self.params.init()

    def forward(self, state, ids, training: bool = True):
        if isinstance(ids, sparse_ops.RaggedIds):
            # ragged in, ragged out, keeping the row splits
            return sparse_ops.embedding_lookup_ragged(
                self.var, state, ids, training=training,
                sharded=self.params if self.params is not self.var
                else None)
        if training:
            return self.params.embedding_lookup(state, ids)
        return self.params.lookup(state, ids)

    def apply_gradients(self, state, ctx, grads, optimizer, step=0,
                        epoch=0):
        return self.params.apply_gradients(state, ctx, grads, optimizer,
                                           step=step, epoch=epoch)


BasicEmbedding = Embedding  # the reference's alias


class SquashedEmbedding(Embedding):
    """Pools the hot axis: ``[batch, L]`` ids -> ``[batch, dim]`` by the
    combiner (``mean`` or ``sum``) over the non-EMPTY ids."""

    def forward(self, state, ids, training: bool = True):
        out = super().forward(state, ids, training)
        emb, ctx = out if training else (out, None)
        valid = (ids != self.var.empty_key)[..., None].to(emb.dtype)
        emb = emb * valid
        if self.combiner == "mean":
            pooled = emb.sum(dim=-2) / valid.sum(dim=-2).clamp(min=1.0)
        else:  # sum
            pooled = emb.sum(dim=-2)
        return (pooled, ctx) if training else pooled


class FieldWiseEmbedding(Embedding):
    """Sums ids into ``nslots`` buckets by ``slot_map_fn`` (tensor in,
    tensor out) -> ``[batch, nslots, dim]``."""

    def __init__(self, embedding_size, nslots: int, slot_map_fn: Callable,
                 **kwargs):
        super().__init__(embedding_size, **kwargs)
        self.nslots = nslots
        self.slot_map_fn = slot_map_fn

    def forward(self, state, ids, training: bool = True):
        if isinstance(ids, sparse_ops.RaggedIds):
            # each value into its (row, slot) bucket; invalid entries park
            # in one extra segment, which is cut off
            b = ids.nrows
            out = Embedding.forward(self, state, ids, training)
            rv, ctx = out if training else (out, None)
            vals = ids.values
            valid = ids.valid_mask() & (vals != self.var.empty_key)
            slots = self.slot_map_fn(vals).to(torch.int32)
            seg = ids.row_ids() * self.nslots + slots
            seg = torch.where(valid, seg, b * self.nslots)
            emb = rv.values * valid[:, None].to(rv.values.dtype)
            pooled = segment.segment_sum(emb, seg, b * self.nslots + 1)
            pooled = pooled[:-1].reshape(b, self.nslots, self.embedding_size)
            return (pooled, ctx) if training else pooled
        if ids.dim() != 2:
            raise ValueError(
                "FieldWiseEmbedding expects [batch, n_ids] or RaggedIds")
        b, l = ids.shape
        out = Embedding.forward(self, state, ids, training)
        emb, ctx = out if training else (out, None)
        slots = self.slot_map_fn(ids).to(torch.int32)
        valid = (ids != self.var.empty_key)[..., None].to(emb.dtype)
        emb = emb * valid
        row = torch.arange(b, dtype=torch.int32,
                           device=ids.device).repeat_interleave(l)
        seg = row * self.nslots + slots.reshape(-1)
        pooled = segment.segment_sum(emb.reshape(b * l, -1), seg,
                                     b * self.nslots)
        pooled = pooled.reshape(b, self.nslots, self.embedding_size)
        return (pooled, ctx) if training else pooled


class AllToAllEmbedding(Embedding):
    """The reference's ``HvdAllToAllEmbedding``: a mesh-sharded layer, the
    Horovod process group replaced by a mesh (``mesh`` is required; a
    ``parallel.GroupMesh`` for one shard a process)."""

    def __init__(self, embedding_size, mesh=None, **kwargs):
        if mesh is None:
            raise ValueError("AllToAllEmbedding requires a mesh")
        super().__init__(embedding_size, mesh=mesh, **kwargs)


HvdAllToAllEmbedding = AllToAllEmbedding  # the reference's name


class LayerNormalization(nn.Module):
    """Layer normalization over ``axis`` with a learned ``gamma`` (ones)
    and ``beta`` (zeros) of width ``dim`` (the reference's dynamic layer
    normalization). ``dim`` may be given later, through
    :meth:`init_params`. The parameters go on ``device`` (default CUDA)."""

    def __init__(self, axis: int = -1, epsilon: float = 1e-3,
                 dim=None, dtype=torch.float32, device=None):
        super().__init__()
        self.axis = axis
        self.epsilon = epsilon
        self.gamma = self.beta = None
        if dim is not None:
            self.init_params(dim, dtype, device)

    def init_params(self, dim: int, dtype=torch.float32, device=None):
        """(Re)create ``gamma`` and ``beta`` on ``device`` (default CUDA);
        returns them as the JAX package's ``{"gamma", "beta"}`` dict."""
        dev = resolve_device(device)
        self.gamma = nn.Parameter(torch.ones((dim,), dtype=dtype, device=dev))
        self.beta = nn.Parameter(torch.zeros((dim,), dtype=dtype, device=dev))
        return {"gamma": self.gamma, "beta": self.beta}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=self.axis, keepdim=True)
        var = x.var(dim=self.axis, keepdim=True, unbiased=False)
        norm = (x - mean) * torch.rsqrt(var + self.epsilon)
        return norm * self.gamma + self.beta
