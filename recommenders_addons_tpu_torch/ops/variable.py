"""`de.Variable` — the user-facing dynamic-embedding table, the port of
the JAX package's ``ops/variable.py``.

A ``Variable`` is a static description (hashable); all storage lives in
an explicit ``TableState`` the caller threads through its calls, on the
Variable's ``device`` (default CUDA). Inference: ``init``, ``lookup``,
``upsert`` (LRU/LFU/EPOCH*/CUSTOMIZED scores), ``size``, ``export``.
Training::

    emb, ctx = var.embedding_lookup(state, ids, step=step)
    ... loss = f(emb); emb_grad = d loss / d emb ...
    state = var.apply_gradients(state, ctx, emb_grad, optimizer, step=step)

with ``bp_v2`` deltas, deferred dedup (``defer_dedup=True``, or
``TFRA_TPU_DEFER_DEDUP=1`` when it is None, on a lookup given a score)
and ``return_evicted``. The direct KV API: ``accum``, ``import_batch``,
``remove`` and ``clear``. The table lifecycle: ``export_keys_and_scores``,
``export_chunked``, ``grow``, and the restrict policy (``restrict_policy``,
``policy``, ``restrict``; ops/restrict.py); ``kv_creator`` maps a backend
config (ops/table_api.py) onto the fields. ``num_shards`` (or
``devices=[...]``) sizes ``spec`` as one shard of a
``parallel.ShardedVariable``. Also the reference's scope
store (``get_variable``), ``ModelMode`` and ``GraphKeys``.
"""

from __future__ import annotations

import dataclasses
import enum
import os
import threading
import zlib
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashtable, initializers, prng
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


class ModelMode:
    """The reference's ``ModelMode`` (train or inference), one setting for
    the process."""

    CURRENT_SETTING = "train"
    TRAIN = "train"
    INFERENCE = "inference"


def enable_train_mode():
    ModelMode.CURRENT_SETTING = ModelMode.TRAIN


def enable_inference_mode():
    ModelMode.CURRENT_SETTING = ModelMode.INFERENCE


def get_model_mode() -> str:
    return ModelMode.CURRENT_SETTING


@dataclasses.dataclass
class LookupContext:
    """Residuals of a training lookup, consumed by ``apply_gradients``
    (the JAX package's ``LookupContext``, as tensors; ``no_dups`` and
    ``rows_aligned`` are Python bools, read back once by the lookup)."""

    unique_keys: torch.Tensor  # [U] deduplicated ids (EMPTY padded)
    slot: torch.Tensor  # [U] int32 physical slot at lookup time
    found: torch.Tensor  # [U] bool
    rows: torch.Tensor  # [U, D] values as seen (init rows for misses)
    inverse: torch.Tensor  # [N] int32: occurrence -> its unique position
    # [U, W] (or physical [U*ch, 128]) packed rows: the lookup's own
    # buffer; ``rows`` and the returned ``emb`` are views of it
    packed: Optional[torch.Tensor] = None
    # the write plan, computed at lookup time
    inserted: Optional[torch.Tensor] = None
    dropped: Optional[torch.Tensor] = None
    # True: uniq IS the batch and inverse IS the identity
    no_dups: Optional[bool] = None
    # True: rows[i] is occurrence i's own row (no expansion gather)
    rows_aligned: Optional[bool] = None
    # key planes with this batch's inserts committed, and the score plane
    # with its LRU-style scores committed (None: the apply commits them)
    key_lo: Optional[torch.Tensor] = None
    key_hi: Optional[torch.Tensor] = None
    scores: Optional[torch.Tensor] = None
    ids_shape: tuple = ()
    deferred: bool = False


def _device_scalar(v, dev) -> torch.Tensor:
    """A step or epoch as a 0-d tensor on ``dev``. A Python int is filled
    there as int64 (``torch.as_tensor``'s dtype for it) rather than copied
    from the host, which would be a host sync."""
    if isinstance(v, int):
        return torch.full((), v, dtype=torch.int64, device=dev)
    return torch.as_tensor(v, device=dev)


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
    # the reference's flag for the Keras-style layers; the table trains
    # through apply_gradients either way, as in the JAX package
    trainable: bool = True
    evict_strategy: EvictStrategy = EvictStrategy.LRU
    # None -> int32, int64 for the EPOCH* strategies (as the JAX package)
    score_dtype: Any = None
    device: Any = None  # None -> CUDA
    # per-key init seed; None -> zlib.crc32(name), as the JAX package
    seed: Optional[int] = None
    # writeback accumulates deltas (new - looked-up rows) instead of
    # assigning: concurrent trainers' updates add up
    bp_v2: bool = False
    # keys -> scores for the CUSTOMIZED strategy (torch tensors in and out)
    gen_scores_fn: Optional[Callable] = None
    defer_dedup: Optional[bool] = None
    restrict_policy: Any = None  # a policy class, bound lazily (policy)
    # shards of a ShardedVariable (parallel/sharded.py): ``spec`` is one
    # shard's, with capacity ``max(capacity // num_shards, bucket_size)``
    num_shards: int = 1
    # the reference's signature: ``devices`` maps to ``num_shards`` (and
    # its first entry to ``device``). ``kv_creator`` contributes backend
    # config (capacity, evict strategy) through
    # KVCreator.get_variable_kwargs
    devices: Any = None
    kv_creator: Any = None

    # the JAX package's whitelist. 32- and 64-bit containers move through
    # the row kernels, bool rows by torch indexing (hashtable._byte_rows)
    _KEY_DTYPES = ("int32", "int64")
    _VALUE_DTYPES = ("float32", "bfloat16", "float16", "float64", "int8",
                     "int32", "int64", "bool")

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
        if self.devices:
            object.__setattr__(self, "num_shards", len(self.devices))
            if self.device is None:
                object.__setattr__(self, "device", self.devices[0])
        kc = self.kv_creator
        if kc is not None and hasattr(kc, "get_variable_kwargs"):
            for k, v in kc.get_variable_kwargs(
                    dim=self.dim, value_dtype=self.value_dtype).items():
                object.__setattr__(self, k, v)

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
            capacity=max(cap // max(self.num_shards, 1), self.bucket_size),
            key_dtype=self.key_dtype,
            value_dtype=self.value_dtype,
            score_dtype=sdt,
            bucket_size=self.bucket_size,
        )

    @property
    def shard_capacity(self) -> int:
        return self.spec.capacity

    @property
    def total_capacity(self) -> int:
        return self.spec.capacity * self.num_shards

    @property
    def empty_key(self) -> int:
        return self.spec.empty_key

    def _rng(self, device=None) -> torch.Tensor:
        """The table's base threefry key, ``PRNGKey(seed)``."""
        seed = self.seed
        if seed is None:
            seed = zlib.crc32(self.name.encode("utf-8"))
        return prng.PRNGKey(seed, device=device)

    def init(self) -> TableState:
        """Empty state on the Variable's device (raises without CUDA
        unless the Variable was made with ``device="cpu"``)."""
        return hashtable.create(self.spec, resolve_device(self.device))

    def scores_for(self, keys: torch.Tensor,
                   counts: Optional[torch.Tensor] = None, step=0, epoch=0):
        """(scores [N], score_mode) per the evict strategy: LRU stamps
        ``step`` (assign), LFU adds ``counts`` (default 1); the EPOCH*
        strategies put the epoch above the step (bit 32 of int64 scores,
        bit 20 of int32 ones), each clamped to its field, never wrapped;
        CUSTOMIZED assigns ``gen_scores_fn(keys)``."""
        n = keys.shape[0]
        dev = keys.device
        sdt = self.spec.score_dtype
        step = _device_scalar(step, dev).to(sdt)
        epoch = _device_scalar(epoch, dev).to(sdt)
        eshift = 32 if sdt == torch.int64 else 20
        emax = (1 << ((63 if sdt == torch.int64 else 31) - eshift)) - 1
        c = (torch.ones((n,), dtype=sdt, device=dev) if counts is None
             else counts.to(sdt))
        if self.evict_strategy == EvictStrategy.LRU:
            return step.expand(n).clone(), "assign"
        if self.evict_strategy == EvictStrategy.LFU:
            return c, "add"
        efield = epoch.clamp(max=emax) << eshift
        if self.evict_strategy == EvictStrategy.EPOCHLRU:
            s = efield | step.clamp(max=(1 << eshift) - 1)
            return s.expand(n).clone(), "assign"
        if self.evict_strategy == EvictStrategy.EPOCHLFU:
            return efield + c, "add"
        if self.evict_strategy == EvictStrategy.CUSTOMIZED:
            if self.gen_scores_fn is None:
                raise ValueError(
                    "CUSTOMIZED evict strategy needs gen_scores_fn "
                    "(parity: HkvHashTableConfig.gen_scores_fn)")
            return self.gen_scores_fn(keys).to(sdt), "assign"
        raise ValueError(self.evict_strategy)

    def lookup(self, state: TableState, ids, *,
               return_exists: bool = False,
               use_init_for_missing: bool = False):
        """Pure lookup; missing ids -> the static default row (or their
        per-key initial rows)."""
        flat = self._flat_kv(ids, device=state.device)
        slot, found = hashtable.find(self.spec, state, flat)
        if use_init_for_missing:
            default = initializers.materialize_rows(
                self.initializer, self._rng(state.device), flat, self.dim,
                self.value_dtype)
        else:
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

    # -- training ------------------------------------------------------

    def lookup_score_const(self, step, epoch):
        """The batch-constant score a training lookup commits, or None to
        leave scoring to the apply: LRU given ``step``; EPOCHLRU given
        both ``step`` and ``epoch`` (assuming epoch 0 would make fresh
        rows look older than rows of later epochs)."""
        if step is None:
            return None
        if self.evict_strategy == EvictStrategy.EPOCHLRU and epoch is None:
            return None
        if self.evict_strategy not in (EvictStrategy.LRU,
                                       EvictStrategy.EPOCHLRU):
            return None
        sc, _ = self.scores_for(torch.zeros((1,), dtype=self.key_dtype),
                                step=step,
                                epoch=0 if epoch is None else epoch)
        return sc[0]

    @property
    def defer_dedup_on(self) -> bool:
        """``defer_dedup``, or when it is None the ``TFRA_TPU_DEFER_DEDUP``
        knob (``1``: on), as the JAX package reads them."""
        if self.defer_dedup is not None:
            return bool(self.defer_dedup)
        return os.environ.get("TFRA_TPU_DEFER_DEDUP", "0") == "1"

    def embedding_lookup(self, state: TableState, ids, *, step=None,
                         epoch=None):
        """Trainable lookup with built-in dedup. Returns ``(emb
        [ids.shape + (dim,)], LookupContext)``; pass the gradient of the
        loss with respect to ``emb`` to :meth:`apply_gradients`.

        Pass the training ``step`` (and ``epoch`` for EPOCHLRU) here and
        the batch's scores are committed at lookup time, where the score
        scatter doubles as the duplicate probe; the fused apply then
        leaves scores alone. Such a scored lookup defers the dedup to the
        apply when :attr:`defer_dedup_on` (``ctx.deferred``: ``found``
        marks every occurrence of a hit batch). ``emb`` is a view of the
        lookup's packed rows (``ctx.packed``), which the apply reads."""
        score_const = self.lookup_score_const(step, epoch)
        defer = self.defer_dedup_on and score_const is not None
        ids = torch.as_tensor(ids)
        flat = self._flat_kv(ids, device=state.device)
        n = flat.shape[0]
        base = self._rng(state.device)
        out = hashtable.plan_lookup_train(
            self.spec, state, flat,
            lambda u: initializers.materialize_rows(
                self.initializer, base, u, self.dim, self.value_dtype),
            score_const=score_const, defer_dedup=defer)
        (uniq, inverse, (slot, found, inserted, dropped), packed, no_dups,
         rows_aligned, new_lo, new_hi) = out[:8]
        rows = hashtable.packed_value_rows(state, n, packed)
        ctx = LookupContext(
            unique_keys=uniq, slot=slot, found=found, rows=rows,
            inverse=inverse, packed=packed, inserted=inserted,
            dropped=dropped, no_dups=no_dups, rows_aligned=rows_aligned,
            key_lo=new_lo, key_hi=new_hi,
            scores=out[8] if score_const is not None else None,
            ids_shape=tuple(ids.shape), deferred=defer)
        emb = rows if rows_aligned else rows[inverse.long()]
        return emb.reshape(tuple(ids.shape) + (self.dim,)), ctx

    def reduce_gradient(self, ctx: LookupContext, emb_grad: torch.Tensor):
        """Gradient of the whole ``emb`` -> per-unique-row grads (duplicate
        ids summed)."""
        if ctx.deferred:
            raise ValueError(
                "this LookupContext deferred duplicate handling to the "
                "apply (ctx.found marks every occurrence): use "
                "reduce_gradient_deferred (or apply_gradients, which "
                "calls it) so duplicates are combined AND the write mask "
                "is narrowed to one representative per row")
        u = ctx.unique_keys.shape[0]
        g = emb_grad.reshape(-1, self.dim)
        inv = ctx.inverse.reshape(-1)
        no_dups = ctx.no_dups
        if no_dups is None and g.shape[0] == u:
            no_dups = bool((inv == torch.arange(u, device=inv.device)).all())
        if g.shape[0] == u and no_dups:
            return g
        return hashtable.segment_sum_rows(g, inv, u)

    def reduce_gradient_deferred(self, ctx: LookupContext,
                                 emb_grad: torch.Tensor):
        """Grad combine of a deferred-dedup context (``ctx.deferred``).
        Returns ``(grads [N, D], found [N])``: duplicate occurrences' grads
        summed onto one representative each and ``found`` narrowed to the
        representatives, so the write touches every row once. Three cases,
        by the plan's own bools: a dup-free batch passes through; an
        all-hit batch with duplicates takes :func:`sorted_combine_batch`;
        a miss batch with duplicates came out of ``plan_lookup`` with the
        representative/inverse contract built, and keeps the inverse
        combine."""
        g = emb_grad.reshape(-1, self.dim)
        if ctx.no_dups:
            return g, ctx.found
        if ctx.rows_aligned:
            return hashtable.sorted_combine_batch(g, ctx.slot, ctx.found)
        n = ctx.found.shape[0]
        return (hashtable.segment_sum_rows(g, ctx.inverse.reshape(-1), n),
                ctx.found)

    def writeback(self, state: TableState, ctx: LookupContext,
                  new_rows: torch.Tensor,
                  slot_rows: Optional[Dict[str, torch.Tensor]] = None,
                  step=0, epoch=0, return_evicted: bool = False):
        """Write trained rows (and optimizer slot rows) back through the
        lookup's write plan; the rows are written in place. ``bp_v2``:
        delta-accumulate (the stored row plus ``new_rows - ctx.rows``)
        instead of assigning. ``return_evicted``: also return the rows the
        write's inserts displace, ``(state, evicted)``. A deferred context
        must be narrowed first (``reduce_gradient_deferred``), as
        ``apply_gradients`` does."""
        # ``ctx.rows`` is a view of the lookup's packed rows: take the
        # deltas before anything is written
        deltas = new_rows - ctx.rows if self.bp_v2 else None
        scores, mode = self.scores_for(ctx.unique_keys, step=step,
                                       epoch=epoch)
        kw = dict(values=new_rows, deltas=deltas, slot_rows=slot_rows,
                  scores=scores, score_mode=mode,
                  return_evicted=return_evicted)
        if ctx.inserted is None:
            return hashtable.commit(self.spec, state, ctx.unique_keys, **kw)
        plan = (ctx.slot, ctx.found, ctx.inserted, ctx.dropped)
        return hashtable.commit_planned(self.spec, state, ctx.unique_keys,
                                        plan, **kw)

    def apply_gradients(self, state: TableState, ctx: LookupContext, grads,
                        optimizer, step=0, epoch=0,
                        return_evicted: bool = False):
        """Sparse optimizer step on the touched rows (ops/optimizer.py).
        ``grads`` is the gradient with respect to ``emb`` (reduced over
        duplicates here). ``return_evicted``: ``(state, evicted)``."""
        from recommenders_addons_tpu_torch.ops import optimizer as opt_lib

        return opt_lib.apply_gradients(
            self, state, ctx, grads, optimizer, step=step, epoch=epoch,
            return_evicted=return_evicted)

    # -- direct KV ops ---------------------------------------------------

    def upsert(self, state: TableState, keys, values, step=0, epoch=0,
               return_evicted: bool = False):
        """Insert-or-assign; duplicate keys resolve last-write-wins. The
        rows are written in place (hashtable module docstring)."""
        keys, values = self._flat_kv(keys, values, device=state.device)
        uniq, (uvals,) = hashtable.dedup_last(keys, (values,))
        scores, mode = self.scores_for(uniq, step=step, epoch=epoch)
        return hashtable.commit(self.spec, state, uniq, values=uvals,
                                scores=scores, score_mode=mode,
                                return_evicted=return_evicted)

    def accum(self, state: TableState, keys, old_values, new_values,
              exists=None, step=0, epoch=0) -> TableState:
        """Writes ``new - old`` deltas for existing keys and ``new`` values
        for missing ones. Duplicate keys: the deltas SUM per key, and a
        missing key inserts its last occurrence's ``new`` value.
        ``exists`` (as captured at lookup): a key is written only if its
        presence in the table still matches, so a key evicted or inserted
        by another writer in between is skipped, never corrupted."""
        keys, old_values = self._flat_kv(keys, old_values,
                                         device=state.device)
        _, new_values = self._flat_kv(keys, new_values, device=state.device)
        uniq, (udelta,) = hashtable.dedup_sum(keys,
                                              (new_values - old_values,))
        if exists is not None:
            ex = torch.as_tensor(exists).to(state.device).reshape(-1).to(
                torch.int32)
            _, (unew, uex) = hashtable.dedup_last(keys, (new_values, ex))
            _, found = hashtable.find(self.spec, state, uniq)
            uniq = torch.where(found == (uex != 0), uniq, self.empty_key)
        else:
            _, (unew,) = hashtable.dedup_last(keys, (new_values,))
        scores, mode = self.scores_for(uniq, step=step, epoch=epoch)
        return hashtable.accum(self.spec, state, uniq, deltas=udelta,
                               values_for_new=unew, scores=scores,
                               score_mode=mode)

    def import_batch(self, state: TableState, keys, values, scores=None,
                     slot_rows: Optional[Dict[str, torch.Tensor]] = None,
                     return_evicted: bool = False):
        """Bulk restore of (key, value, score, slot-row) tuples, the
        checkpoint-load path; duplicate keys keep their last occurrence.
        Scores are assigned as given (default 1)."""
        keys, values = self._flat_kv(keys, values, device=state.device)
        sdt = self.spec.score_dtype
        if scores is None:
            scores = torch.ones(keys.shape, dtype=sdt, device=state.device)
        scores = torch.as_tensor(scores).to(device=state.device,
                                            dtype=sdt).reshape(-1)
        names = tuple(sorted((slot_rows or {}).keys()))
        cols = tuple(self._flat_kv(keys, slot_rows[nm],
                                   device=state.device)[1] for nm in names)
        uniq, picked = hashtable.dedup_last(keys, (values, scores) + cols)
        return hashtable.commit(
            self.spec, state, uniq, values=picked[0],
            slot_rows=dict(zip(names, picked[2:])) or None,
            scores=picked[1], score_mode="assign",
            return_evicted=return_evicted)

    def remove(self, state: TableState, keys) -> TableState:
        return hashtable.remove(self.spec, state,
                                self._flat_kv(keys, device=state.device))

    def clear(self, state: TableState) -> TableState:
        """Empty the table (its rows zeroed in place)."""
        return hashtable.clear(self.spec, state)

    def size(self, state: TableState) -> torch.Tensor:
        return hashtable.size(self.spec, state)

    def export(self, state: TableState):
        return hashtable.export(self.spec, state)

    def export_keys_and_scores(self, state: TableState):
        k, _, s, m = hashtable.export_with_scores(self.spec, state)
        return k, s, m

    def export_chunked(self, state: TableState, split_size: int):
        """Stream the live ``(keys [n], values [n, D], scores [n])`` to the
        host in chunks of at most ``split_size`` table slots, in slot
        order (the reference's ``export_keys_and_scores(split_size)``,
        hkv_hashtable_ops.py:420-434). Each chunk is compacted on the
        table's device and copied to the host as CPU tensors (bf16 has no
        numpy dtype); chunks with no live key are skipped. One host sync
        a chunk (its live count)."""
        if not (isinstance(split_size, int) and split_size > 0):
            raise ValueError("split_size must be a positive integer")
        spec = self.spec
        cap = state.capacity
        ch = state.chunks
        for off in range(0, cap, split_size):
            n = min(split_size, cap - off)
            keys = hashtable.join_key(state.key_lo[off:off + n],
                                      state.key_hi[off:off + n])
            live = torch.nonzero(keys != spec.empty_key).reshape(-1)
            if not live.numel():  # host sync
                continue
            vals = hashtable._to_logical_rows(
                state.rows[off * ch:(off + n) * ch], state.value_dtype, n,
                state.width)[live, :self.dim]
            yield (keys[live].to(self.key_dtype).cpu(), vals.cpu(),
                   state.scores[off:off + n][live].cpu())

    def grow(self, state: TableState, new_capacity: int,
             chunk_size: int = 1 << 16):
        """Rebuild into a larger table, keeping every live row's value,
        optimizer slots and score. Streams the old table in
        ``chunk_size``-slot slices, in slot order, through
        :meth:`import_batch` (the row-scatter kernel), as the JAX package
        does; the last slice is padded with EMPTY keys to ``chunk_size``
        as there. Returns ``(new_var, new_state)``: the returned Variable
        has the new capacity; use it from then on."""
        if new_capacity < state.capacity:
            raise ValueError(
                f"grow target {new_capacity} < current {state.capacity}")
        new_var = dataclasses.replace(self, init_capacity=int(new_capacity),
                                      max_capacity=None)
        new_state = hashtable.create(new_var.spec, state.device)
        for name in state.slot_names:
            new_state = hashtable.with_slot(new_state, name,
                                            state.slot_init(name))
        d, ch = self.dim, state.chunks
        e_lo, e_hi = hashtable._split_int(self.empty_key)
        for off in range(0, state.capacity, chunk_size):
            n = min(chunk_size, state.capacity - off)
            pad = chunk_size - n
            lo, hi = state.key_lo[off:off + n], state.key_hi[off:off + n]
            phys = state.rows[off * ch:(off + n) * ch]
            scores = state.scores[off:off + n]
            if pad:
                lo = torch.cat([lo, lo.new_full((pad,), e_lo)])
                hi = torch.cat([hi, hi.new_full((pad,), e_hi)])
                phys = torch.cat([phys, phys.new_zeros((pad * ch,
                                                        phys.shape[1]))])
                scores = torch.cat([scores, scores.new_zeros(pad)])
            logical = hashtable._to_logical_rows(phys, state.value_dtype,
                                                 chunk_size, state.width)
            slot_rows = {nm: logical[:, state.slot_offset(nm):
                                     state.slot_offset(nm) + d]
                         for nm in state.slot_names} or None
            new_state = new_var.import_batch(
                new_state, hashtable.join_key(lo, hi).to(self.key_dtype),
                logical[:, :d], scores=scores, slot_rows=slot_rows)
        return new_var, new_state

    # -- restrict policy (reference Variable(restrict_policy=...),
    #    dynamic_embedding_variable.py:604-611) -------------------------

    @property
    def policy(self):
        """The configured restrict policy (a class), bound to this
        Variable; None when there is none."""
        if self.restrict_policy is None:
            return None
        return self.restrict_policy(self)

    def restrict(self, state: TableState, num_reserved: int,
                 trigger=None) -> TableState:
        """Cap the live-key count through the configured policy (by
        default :class:`~ops.restrict.TimestampRestrictPolicy`)."""
        p = self.policy
        if p is None:
            from recommenders_addons_tpu_torch.ops.restrict import (
                TimestampRestrictPolicy,
            )

            p = TimestampRestrictPolicy(self)
        return p.apply_restriction(state, num_reserved, trigger)


# ---------------------------------------------------------------------------
# get_variable's scope store (the reference's variable scope dedup)
# ---------------------------------------------------------------------------

_STORE: Dict[str, Variable] = {}
_STORE_LOCK = threading.Lock()


def _same_initializer(a, b) -> bool:
    """Initializer equality for get_variable's conflict check: the same
    object, or equal constants (None, scalars, arrays, tensors); two
    callables only when they are the same object, as in the JAX
    package."""
    if a is b:
        return True
    if a is None or b is None:
        return False
    if callable(a) or callable(b):
        return False
    return bool(np.array_equal(torch.as_tensor(a).cpu().numpy(),
                               torch.as_tensor(b).cpu().numpy()))


def get_variable(name: str = "DynamicEmbedding", **kwargs) -> Variable:
    """Create or reuse a ``Variable`` by name. Asking again for a name
    with a conflicting keyword (a different ``initializer`` included)
    raises."""
    with _STORE_LOCK:
        if name in _STORE:
            existing = _STORE[name]
            for k, v in kwargs.items():
                if k == "initializer":
                    if not _same_initializer(existing.initializer, v):
                        raise ValueError(
                            f"get_variable('{name}') exists with a "
                            "different initializer")
                elif getattr(existing, k, None) != v:
                    raise ValueError(
                        f"get_variable('{name}') exists with different {k}")
            return existing
        var = Variable(name=name, **kwargs)
        _STORE[name] = var
        return var


def clear_variable_store():
    with _STORE_LOCK:
        _STORE.clear()


class GraphKeys:
    """The reference's collection names (a TF1 concept), kept for its
    API."""

    DYNAMIC_EMBEDDING_VARIABLES = "dynamic_embedding_variables"
    TRAINABLE_DYNAMIC_EMBEDDING_VARIABLES = (
        "trainable_dynamic_embedding_variables")
