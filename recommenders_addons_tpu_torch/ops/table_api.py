"""Object-style table wrappers and backend creators, the port of the JAX
package's ``ops/table_api.py`` (reference python/ops/{cuckoo_hashtable_ops,
hkv_hashtable_ops,redis_table_ops,dynamic_embedding_creator}.py).

There is one engine, the set-associative score-evicting table of
ops/hashtable.py, so the reference's three table classes are views of it:

* ``CuckooHashTable``: never loses a key; with ``auto_grow`` it doubles
  when its load factor crosses ``grow_threshold`` or an insert would
  evict or drop (the reference's libcuckoo resize-on-insert);
* ``HkvHashTable``: capacity-bounded, with evict-strategy scores;
* ``RedisTable``: the JAX package's plain subclass; the network KV role
  is the host-DRAM spill tier (ops/spill.py, ``serving.kv`` for a shared
  one); config fields are accepted and mapped.

A wrapper holds its ``TableState`` and exposes the reference's
mutate-in-place methods; host-side results (exports) are CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from recommenders_addons_tpu_torch.ops import hashtable
from recommenders_addons_tpu_torch.ops.variable import EvictStrategy, Variable


class BaseHashTable:
    """Stateful front over the functional table (the reference's
    ``LookupInterface``: insert / find / accum / remove / clear / size /
    export / save / load)."""

    def __init__(
        self,
        key_dtype=torch.int64,
        value_dtype=torch.float32,
        default_value=0.0,
        dim: Optional[int] = None,
        name: str = "hashtable",
        init_size: int = 1 << 20,
        capacity: Optional[int] = None,
        evict_strategy: EvictStrategy = EvictStrategy.LRU,
        gen_scores_fn: Optional[Callable] = None,
        checkpoint: bool = True,
        device=None,
        **_compat,
    ):
        value_dtype = hashtable.torch_dtype(value_dtype)
        default_value = torch.as_tensor(default_value, dtype=value_dtype)
        if dim is None:
            dim = default_value.numel() if default_value.dim() else 1
        self.var = Variable(
            name=name, key_dtype=key_dtype, value_dtype=value_dtype, dim=dim,
            init_capacity=capacity or init_size,
            initializer=default_value.reshape(-1).expand(dim).clone(),
            evict_strategy=evict_strategy, gen_scores_fn=gen_scores_fn,
            device=device)
        self.checkpoint = checkpoint
        self.state = self.var.init()
        self._step = 0

    @property
    def key_dtype(self):
        return self.var.key_dtype

    @property
    def value_dtype(self):
        return self.var.value_dtype

    @property
    def name(self):
        return self.var.name

    @property
    def dim(self):
        return self.var.dim

    def size(self) -> int:
        return int(self.var.size(self.state))

    def insert(self, keys, values) -> None:
        """Insert-or-assign (the reference's HashTableInsertOp)."""
        self.state = self.var.upsert(self.state, keys, values,
                                     step=self._bump())

    upsert = insert

    def accum(self, keys, old_values, new_values, exists=None) -> None:
        self.state = self.var.accum(self.state, keys, old_values, new_values,
                                    exists, step=self._bump())

    def lookup(self, keys, dynamic_default_values=None, return_exists=False):
        """find / find_with_exists (the reference's HashTableFindOp)."""
        keys = torch.as_tensor(keys).to(self.state.device,
                                        self.var.key_dtype)
        vals, found = self.var.lookup(self.state, keys, return_exists=True)
        if dynamic_default_values is not None:
            dv = torch.as_tensor(dynamic_default_values).to(
                self.state.device, self.var.value_dtype).reshape(
                tuple(keys.shape) + (self.var.dim,))
            vals = torch.where(found[..., None], vals, dv)
        if return_exists:
            return vals, found
        return vals

    def remove(self, keys) -> None:
        self.state = self.var.remove(self.state, keys)

    def clear(self) -> None:
        self.state = self.var.clear(self.state)

    def export(self):
        """The live ``(keys, values)``, compacted, as CPU tensors."""
        k, v, m = self.var.export(self.state)
        return k[m].cpu(), v[m].cpu()

    def export_keys_and_scores(self, split_size: int = 0):
        """The live ``(keys, scores)``. ``split_size > 0`` streams them to
        the host in chunks of that many slots (the reference's
        hkv_hashtable_ops.py:420-434) instead of all at once."""
        if split_size and split_size > 0:
            parts = list(self.var.export_chunked(self.state, split_size))
            if not parts:
                return (torch.empty((0,), dtype=self.var.key_dtype),
                        torch.empty((0,), dtype=self.var.spec.score_dtype))
            return (torch.cat([p[0] for p in parts]),
                    torch.cat([p[2] for p in parts]))
        k, s, m = self.var.export_keys_and_scores(self.state)
        return k[m].cpu(), s[m].cpu()

    def save_to_file_system(self, dirpath: str, proc_size=1, proc_rank=0,
                            buffer_size=4 * 1024 * 1024, **_):
        from recommenders_addons_tpu_torch.train import checkpoint as ckpt

        return ckpt.save_dynamic_embedding(
            self.var, self.state, dirpath, proc_size=proc_size,
            proc_rank=proc_rank, buffer_size=buffer_size)

    def load_from_file_system(self, dirpath: str, buffer_size=4 * 1024 * 1024,
                              **_):
        from recommenders_addons_tpu_torch.train import checkpoint as ckpt

        self.state = ckpt.load_dynamic_embedding(
            self.var, self.state, dirpath, buffer_size=buffer_size)

    def grow(self, new_capacity: int, chunk_size: int = 1 << 16) -> None:
        """Rebuild into a larger table keeping rows, slots and scores
        (``Variable.grow``)."""
        self.var, self.state = self.var.grow(self.state, new_capacity,
                                             chunk_size=chunk_size)

    def _bump(self) -> int:
        self._step += 1
        return self._step


class CuckooHashTable(BaseHashTable):
    """The reference's ``de.CuckooHashTable`` (cuckoo_hashtable_ops.py:
    64-572), which grows on insert and never evicts: with ``auto_grow``
    the table doubles when its load factor crosses ``grow_threshold``
    (checked every capacity/16 inserted keys) or when an insert would
    evict or drop a key, and the displaced and dropped rows are put back
    into the grown table. ``auto_grow=False``: HKV-style bounded."""

    def __init__(self, *args, auto_grow: bool = True,
                 grow_threshold: float = 0.85, **kw):
        super().__init__(*args, **kw)
        self.auto_grow = auto_grow
        self.grow_threshold = float(grow_threshold)
        self._since_check = 0

    def insert(self, keys, values) -> None:
        if not self.auto_grow:
            return super().insert(keys, values)
        self.state, ev = self.var.upsert(self.state, keys, values,
                                         step=self._bump(),
                                         return_evicted=True)
        empty = self.var.empty_key
        ev_m = ev["keys"] != empty
        dr_m = ev["dropped_keys"] != empty
        lost = bool(ev_m.any() or dr_m.any())  # host sync

        self._since_check += torch.as_tensor(keys).numel()
        cap = self.var.spec.capacity
        if lost or self._since_check >= max(cap // 16, 1):
            self._since_check = 0
            if lost or self.size() >= self.grow_threshold * cap:
                self.grow(max(cap * 2, 2 * self.var.bucket_size))

        if lost:
            if bool(ev_m.any()):  # displaced rows keep values/slots/scores
                self.state = self.var.import_batch(
                    self.state, ev["keys"][ev_m], ev["values"][ev_m],
                    scores=ev["scores"][ev_m],
                    slot_rows={n: c[ev_m] for n, c in ev["slots"].items()}
                    or None)
            if bool(dr_m.any()):  # dropped inputs go into the grown table
                self.state = self.var.upsert(
                    self.state, ev["dropped_keys"][dr_m],
                    ev["dropped_values"][dr_m], step=self._step)

    upsert = insert


class HkvHashTable(BaseHashTable):
    """The reference's ``de.HkvHashTable`` (hkv_hashtable_ops.py):
    capacity-bounded with score eviction."""

    def __init__(self, *args, init_capacity=1 << 20, max_capacity=None,
                 **kwargs):
        kwargs.setdefault("capacity", max_capacity or init_capacity)
        super().__init__(*args, **kwargs)


class RedisTable(BaseHashTable):
    """The reference's ``de.RedisTable`` (redis_table_ops.py:589); named
    after its config's ``model_tag``."""

    def __init__(self, *args, config=None, **kwargs):
        if config is not None:
            kwargs.setdefault("name", getattr(config, "model_tag", "redis"))
        super().__init__(*args, **kwargs)


# ---------------------------------------------------------------------------
# configs and creators (reference dynamic_embedding_creator.py)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CuckooHashTableConfig:
    """Reference creator.py:80-86 (an empty marker config)."""


@dataclasses.dataclass
class HkvHashTableConfig:
    """Reference creator.py:149-169."""

    init_capacity: int = 1024 * 1024
    max_capacity: int = 1024 * 1024
    max_hbm_for_values: int = 1024 * 1024 * 1024
    evict_strategy: EvictStrategy = EvictStrategy.LRU
    step_per_epoch: int = 0
    gen_scores_fn: Optional[Callable] = None
    reserved_key_start_bit: int = 0


@dataclasses.dataclass
class RedisTableConfig:
    """Reference creator.py:185-243 (its JSON config fields accepted)."""

    redis_config_abs_dir: Optional[str] = None
    redis_config_abs_dir_env: Optional[str] = None
    model_tag: str = "test"


class KVCreator:
    """Backend factory (reference creator.py:36-77): a config and a saver,
    which build a table or a Variable's keyword arguments."""

    table_cls = CuckooHashTable

    def __init__(self, config=None, saver=None):
        self.config = config
        self.saver = saver

    @staticmethod
    def _hbm_capacity_bound(cfg, dim, value_dtype) -> Optional[int]:
        """``max_hbm_for_values`` as a key-capacity bound (the reference
        caps HKV's device value bytes, lookup_table_op_hkv.h:428-513)."""
        if not isinstance(cfg, HkvHashTableConfig) or not dim:
            return None
        if not cfg.max_hbm_for_values:
            return None
        row_bytes = int(dim) * hashtable.torch_dtype(value_dtype).itemsize
        return max(int(cfg.max_hbm_for_values) // row_bytes, 1)

    def create(self, key_dtype=torch.int64, value_dtype=torch.float32,
               default_value=0.0, name="table", dim=None, **kwargs):
        cfg = self.config
        if isinstance(cfg, HkvHashTableConfig):
            cap = cfg.max_capacity
            bound = self._hbm_capacity_bound(cfg, dim, value_dtype)
            if bound is not None:
                cap = min(cap, bound)
            kwargs.setdefault("capacity", cap)
            kwargs.setdefault("evict_strategy", cfg.evict_strategy)
            if cfg.gen_scores_fn is not None:
                kwargs.setdefault("gen_scores_fn", cfg.gen_scores_fn)
                kwargs.setdefault("evict_strategy", EvictStrategy.CUSTOMIZED)
        return self.table_cls(key_dtype=key_dtype, value_dtype=value_dtype,
                              default_value=default_value, name=name,
                              dim=dim, **kwargs)

    def get_variable_kwargs(self, dim=None,
                            value_dtype=torch.float32) -> Dict[str, Any]:
        """The backend config as ``Variable`` keyword arguments (for
        ``Variable(kv_creator=...)``)."""
        cfg = self.config
        out: Dict[str, Any] = {}
        if isinstance(cfg, HkvHashTableConfig):
            out["init_capacity"] = cfg.init_capacity
            out["max_capacity"] = cfg.max_capacity
            bound = self._hbm_capacity_bound(cfg, dim, value_dtype)
            if bound is not None:
                out["max_capacity"] = min(cfg.max_capacity, bound)
                out["init_capacity"] = min(cfg.init_capacity, bound)
            out["evict_strategy"] = cfg.evict_strategy
            if cfg.gen_scores_fn is not None:
                out["gen_scores_fn"] = cfg.gen_scores_fn
        return out


class CuckooHashTableCreator(KVCreator):
    table_cls = CuckooHashTable


class HkvHashTableCreator(KVCreator):
    table_cls = HkvHashTable


class RedisTableCreator(KVCreator):
    table_cls = RedisTable


@dataclasses.dataclass
class FileSystemSaver:
    """Reference creator.py:365-516: table payloads go to sidecar KV
    files, which is this package's checkpoint path (train/checkpoint.py);
    the class records the multi-process layout. ``save`` and ``load`` take
    a ``Variable`` or a ``parallel.ShardedVariable`` (one file set for
    each shard this process holds)."""

    proc_size: int = 1
    proc_rank: int = 0
    save_path: Optional[str] = None
    buffer_size: int = 4 * 1024 * 1024

    def save(self, var_or_sharded, state, directory=None, global_step=None):
        from recommenders_addons_tpu_torch.train import checkpoint as ckpt

        return ckpt.save_dynamic_embedding(
            var_or_sharded, state, directory or self.save_path,
            global_step=global_step,
            proc_size=self.proc_size, proc_rank=self.proc_rank,
            buffer_size=self.buffer_size)

    def load(self, var_or_sharded, state, directory=None, global_step=None):
        from recommenders_addons_tpu_torch.train import checkpoint as ckpt

        return ckpt.load_dynamic_embedding(
            var_or_sharded, state, directory or self.save_path,
            global_step=global_step,
            buffer_size=self.buffer_size)


class DynamicEmbeddingSaver(FileSystemSaver):
    """Alias (reference creator.py:365)."""
