"""`de.Variable` — the user-facing dynamic-embedding table, serving subset
of the JAX package's ``ops/variable.py``.

A ``Variable`` is a static description (hashable); all storage lives in
an explicit ``TableState`` the caller threads through its calls, on the
Variable's ``device`` (default CUDA). This slice carries the inference
surface: ``init``, ``lookup``, ``upsert`` (with LRU/LFU scores), ``size``
and ``export``. The training surface (``embedding_lookup``,
``apply_gradients``, optimizers) is still to port.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import torch

from recommenders_addons_tpu_torch.ops import hashtable, initializers
from recommenders_addons_tpu_torch.utils.config import (
    env_config,
    resolve_device,
)

TableSpec = hashtable.TableSpec
TableState = hashtable.TableState


class EvictStrategy(enum.Enum):
    """Parity with ``de.HkvEvictStrategy``
    (reference dynamic_embedding_creator.py:140-146)."""

    LRU = 0
    LFU = 1
    EPOCHLRU = 2
    EPOCHLFU = 3
    CUSTOMIZED = 4


@dataclasses.dataclass(frozen=True, eq=False)
class Variable:
    """Static description of one dynamic-embedding table."""

    name: str = "DynamicEmbedding"
    key_dtype: Any = torch.int64
    value_dtype: Any = torch.float32
    dim: int = 1
    # None -> utils.config.env_config().default_init_size
    init_capacity: Optional[int] = None
    max_capacity: Optional[int] = None
    bucket_size: int = 64
    initializer: initializers.InitializerT = None
    evict_strategy: EvictStrategy = EvictStrategy.LRU
    # None -> int32, int64 for the EPOCH* strategies (as the JAX package)
    score_dtype: Any = None
    device: Any = None  # None -> CUDA

    # every value dtype whose container is 32-bit, which the row kernels
    # move (the JAX package's 64-bit and bool tables take XLA paths)
    _KEY_DTYPES = ("int32", "int64")
    _VALUE_DTYPES = ("float32", "bfloat16", "float16", "int8", "int32")

    def __post_init__(self):
        if self.init_capacity is None:
            object.__setattr__(self, "init_capacity",
                               env_config().default_init_size)
        kdt = hashtable.dtype_name(self.key_dtype)
        vdt = hashtable.dtype_name(self.value_dtype)
        if kdt not in self._KEY_DTYPES:
            raise TypeError(f"key dtype {kdt} not supported "
                            f"(one of {self._KEY_DTYPES})")
        if vdt not in self._VALUE_DTYPES:
            raise TypeError(f"value dtype {vdt} not supported "
                            f"(one of {self._VALUE_DTYPES})")
        object.__setattr__(self, "key_dtype", hashtable.torch_dtype(kdt))
        object.__setattr__(self, "value_dtype", hashtable.torch_dtype(vdt))

    @property
    def spec(self) -> TableSpec:
        cap = self.max_capacity or self.init_capacity
        sdt = self.score_dtype
        if sdt is None:
            sdt = (torch.int64
                   if self.evict_strategy in (EvictStrategy.EPOCHLRU,
                                              EvictStrategy.EPOCHLFU)
                   else torch.int32)
        return TableSpec(
            dim=self.dim,
            capacity=max(cap, self.bucket_size),
            key_dtype=self.key_dtype,
            value_dtype=self.value_dtype,
            score_dtype=sdt,
            bucket_size=self.bucket_size,
        )

    def init(self) -> TableState:
        """Empty state on the Variable's device (raises without CUDA
        unless the Variable was made with ``device="cpu"``)."""
        return hashtable.create(self.spec, resolve_device(self.device))

    def scores_for(self, keys: torch.Tensor,
                   counts: Optional[torch.Tensor] = None, step: int = 0):
        """(scores [N], score_mode) per the evict strategy: LRU stamps
        ``step`` (assign), LFU adds ``counts`` (default 1)."""
        n = keys.shape[0]
        sdt = self.spec.score_dtype
        if self.evict_strategy == EvictStrategy.LRU:
            return torch.full((n,), step, dtype=sdt,
                              device=keys.device), "assign"
        if self.evict_strategy == EvictStrategy.LFU:
            c = (torch.ones((n,), dtype=sdt, device=keys.device)
                 if counts is None else counts.to(sdt))
            return c, "add"
        raise NotImplementedError(
            f"{self.evict_strategy} scores are not ported yet")

    def lookup(self, state: TableState, ids, *,
               return_exists: bool = False):
        """Pure lookup; missing ids -> the static default row."""
        flat = self._flat_kv(ids, device=state.device)
        slot, found = hashtable.find(self.spec, state, flat)
        default = initializers.default_value_of(
            self.initializer, self.dim, self.value_dtype, state.device)
        vals = hashtable.gather(self.spec, state, slot, found, default)
        shape = tuple(torch.as_tensor(ids).shape)
        vals = vals.reshape(shape + (self.dim,))
        if return_exists:
            return vals, found.reshape(shape)
        return vals

    def _flat_kv(self, keys, values=None, device=None):
        keys = torch.as_tensor(keys).to(device=device,
                                        dtype=self.key_dtype).reshape(-1)
        if values is None:
            return keys
        values = torch.as_tensor(values).to(
            device=device, dtype=self.value_dtype).reshape(-1, self.dim)
        return keys, values

    def upsert(self, state: TableState, keys, values,
               step: int = 0) -> TableState:
        """Insert-or-assign; duplicate keys resolve last-write-wins. The
        rows are written in place (hashtable module docstring)."""
        keys, values = self._flat_kv(keys, values, device=state.device)
        uniq, (uvals,) = hashtable.dedup_last(keys, (values,))
        scores, mode = self.scores_for(uniq, step=step)
        return hashtable.commit(self.spec, state, uniq, values=uvals,
                                scores=scores, score_mode=mode)

    def size(self, state: TableState) -> torch.Tensor:
        return hashtable.size(self.spec, state)

    def export(self, state: TableState):
        return hashtable.export(self.spec, state)
