"""Host-DRAM spill tier: cold rows evicted from the card live in host
memory, the port of the JAX package's ``ops/spill.py``.

The role of the reference's Redis backend (a KV tier that trainers and
servers share) and of HKV's host-memory vector storage: the device table
is capacity-bounded and hot, everything else lives in a large host tier.
The tier is touched only at step boundaries, in batches:

  * ``demote``: evict the k coldest device rows into the host store (key,
    value, score and optimizer slots move together, so a demoted row
    resumes training where it left off when promoted back): a radix
    select of the victims, one ``row_gather`` of their packed rows, one
    copy to the host;
  * ``promote``: before a step, move the batch's keys that the device
    table misses and the tier holds back into the table
    (``import_batch``, one ``row_scatter``), absorbing the rows that
    import displaces;
  * ``lookup_through``: a serving read that falls back to the tier for
    misses without changing the device state.

The stores: ``HostKVStore`` (vectorised numpy open addressing with
tombstones, the JAX package's, any value dtype) and the native
``NativeHostKVStore`` (C++, float32 payloads). ``make_host_store`` takes
the native one for float32 tables, and a failed native build raises.
Host arrays hold 16-bit float rows as their int16 words
(``hashtable.host_words``), which are viewed back on the way to the
card, so a bf16 tier's files are the JAX package's byte for byte.

The JAX package pads each promote and demote batch to a power of two so
XLA compiles a bounded number of executables; the padding (EMPTY keys,
which every table op ignores) is kept here as it is, and so is the
power-of-two evict count of ``demote_to_watermark``, which decides which
rows stay on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashing, hashtable
from recommenders_addons_tpu_torch.ops.variable import Variable
from recommenders_addons_tpu_torch.parallel.sharded import (
    ShardedState,
    ShardedVariable,
)

_EMPTY = np.int64(hashing.EMPTY_KEY)


def _pow2(n: int) -> int:
    return max(8, 1 << (int(n) - 1).bit_length())


def _pad_kv_pow2(keys, values, scores=None, slots=None):
    """Pad a host-side ``(keys, values[, scores, slots])`` batch to the
    next power-of-two length with EMPTY keys and zero rows (the JAX
    package's bound on its compile count; EMPTY rows are ignored by every
    table op)."""
    n = len(keys)
    m = _pow2(n)
    if m == n:
        return keys, values, scores, slots
    pk = np.full((m,), _EMPTY, np.int64)
    pk[:n] = keys
    pv = np.zeros((m,) + values.shape[1:], values.dtype)
    pv[:n] = values
    ps = None
    if scores is not None:
        ps = np.zeros((m,), np.asarray(scores).dtype)
        ps[:n] = scores
    psl = None
    if slots is not None:
        psl = {}
        for nm, c in slots.items():
            pc = np.zeros((m,) + c.shape[1:], c.dtype)
            pc[:n] = c
            psl[nm] = pc
    return pk, pv, ps, psl


class HostKVStore:
    """Vectorised numpy KV store: int64 keys -> (value row, score, slots).

    Open addressing with linear probing; grows by doubling. Every
    operation is batched (argsort/unique vectorisation), no per-key
    Python loop. ``value_dtype`` is a numpy dtype (16-bit float tables'
    rows as int16 words)."""

    def __init__(self, dim: int, value_dtype=np.float32,
                 initial_capacity: int = 1 << 16):
        self.dim = dim
        self.value_dtype = np.dtype(value_dtype)
        cap = 1 << int(np.ceil(np.log2(max(initial_capacity, 8))))
        self._alloc(cap)
        self.slot_names: Tuple[str, ...] = ()

    def _alloc(self, cap: int):
        self.capacity = cap
        self.keys = np.full((cap,), _EMPTY, np.int64)
        self.values = np.zeros((cap, self.dim), self.value_dtype)
        self.scores = np.zeros((cap,), np.int64)
        self.slots: Dict[str, np.ndarray] = {}
        # tombstones: deleted slots that still extend probe chains (see
        # delete), reclaimed by insert, swept by a periodic compaction
        self.tomb = np.zeros((cap,), bool)
        self.tombs = 0
        self.count = 0

    def _ensure_slots(self, names):
        for n in names:
            if n not in self.slots:
                self.slots[n] = np.zeros((self.capacity, self.dim),
                                         self.value_dtype)
        self.slot_names = tuple(sorted(self.slots))

    def _probe(self, keys: np.ndarray, for_insert: bool) -> np.ndarray:
        """Vectorised linear probing: the slot of each key (-1 = miss or
        full). Tombstoned slots extend probe chains but never match; an
        insert reclaims the FIRST tombstone on its path unless the key
        turns out to live further along."""
        cap = self.capacity
        mask = cap - 1
        h = (keys.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)) >> 32
        pos = (h.astype(np.int64)) & mask
        out = np.full(keys.shape, -1, np.int64)
        reuse = np.full(keys.shape, -1, np.int64) if for_insert else None
        active = keys != _EMPTY
        # bounded probe: at most capacity steps, usually a handful
        for _ in range(cap):
            if not active.any():
                break
            cur = self.keys[pos]
            dead = self.tomb[pos]
            hit = active & (cur == keys) & ~dead
            out[hit] = pos[hit]
            free = active & (cur == _EMPTY)
            if for_insert:
                out[free] = pos[free]
                first_tomb = active & dead & (reuse < 0)
                reuse[first_tomb] = pos[first_tomb]
            active = active & ~hit & ~free
            pos = (pos + 1) & mask
        if for_insert:
            # a MISS with a tombstone on its path reclaims the tombstone
            # (hits overwrite in place; the key must not exist twice)
            safe = np.maximum(out, 0)
            is_hit = (out >= 0) & (self.keys[safe] == keys) & ~self.tomb[safe]
            out = np.where((reuse >= 0) & ~is_hit, reuse, out)
        return out

    def _grow(self):
        old = (self.keys, self.values, self.scores, dict(self.slots))
        live = (old[0] != _EMPTY) & ~self.tomb
        self._alloc(self.capacity * 2)
        self._ensure_slots(old[3].keys())
        self.put(old[0][live], old[1][live], old[2][live],
                 {n: c[live] for n, c in old[3].items()})

    def put(self, keys: np.ndarray, values: np.ndarray,
            scores: Optional[np.ndarray] = None,
            slots: Optional[Dict[str, np.ndarray]] = None):
        keys = np.asarray(keys, np.int64).reshape(-1)
        valid = keys != _EMPTY
        keys, values = keys[valid], np.asarray(values)[valid]
        if scores is not None:
            scores = np.asarray(scores).reshape(-1)[valid]
        slots = {n: np.asarray(c)[valid] for n, c in (slots or {}).items()}
        if len(keys) == 0:
            return
        # dedup (last wins)
        _, idx = np.unique(keys[::-1], return_index=True)
        sel = len(keys) - 1 - idx
        keys, values = keys[sel], values[sel]
        scores = scores[sel] if scores is not None else None
        slots = {n: c[sel] for n, c in slots.items()}
        self._ensure_slots(slots.keys())
        while self.count + self.tombs + len(keys) > self.capacity * 0.7:
            self._grow()  # also sweeps tombstones (rebuild)
        # vectorised probe races: two batch keys can claim one empty
        # slot. Commit, detect the losers, re-probe them (each round the
        # winners hold their slots, so the losers advance; at least one
        # key lands a round)
        pending = np.ones(len(keys), bool)
        while pending.any():
            sel = np.nonzero(pending)[0]
            pos = self._probe(keys[sel], for_insert=True)
            assert (pos >= 0).all(), "host store probe failed"
            avail = (self.keys[pos] == _EMPTY) | self.tomb[pos]
            was_tomb = self.tomb[pos] & avail
            self.keys[pos] = keys[sel]
            won = self.keys[pos] == keys[sel]
            self.count += int((avail & won).sum())
            self.tombs -= int((was_tomb & won).sum())
            wsel = sel[won]
            wpos = pos[won]
            self.tomb[wpos] = False
            self.values[wpos] = values[wsel].astype(self.value_dtype)
            if scores is not None:
                self.scores[wpos] = scores[wsel]
            for n, c in slots.items():
                self.slots[n][wpos] = c[wsel].astype(self.value_dtype)
            pending[wsel] = False

    def get(self, keys: np.ndarray):
        """``(values, scores, slots, found)`` of a key batch; zeros where
        not found."""
        keys = np.asarray(keys, np.int64).reshape(-1)
        pos = self._probe(keys, for_insert=False)
        found = pos >= 0
        safe = np.where(found, pos, 0)
        zero = self.value_dtype.type(0)
        vals = np.where(found[:, None], self.values[safe], zero)
        scores = np.where(found, self.scores[safe], 0)
        slots = {n: np.where(found[:, None], c[safe], zero)
                 for n, c in self.slots.items()}
        return vals, scores, slots, found

    def export_all(self):
        """Every live row: ``(keys, values, scores, slots)``, the tier's
        side of a checkpoint."""
        live = (self.keys != _EMPTY) & ~self.tomb
        return (self.keys[live].copy(), self.values[live].copy(),
                self.scores[live].copy(),
                {n: c[live].copy() for n, c in self.slots.items()})

    def delete(self, keys: np.ndarray):
        """Tombstone deletion, O(batch) a call: deleted slots extend probe
        chains until an insert reclaims them or tombstones pass a quarter
        of the capacity, when one compaction sweep rebuilds."""
        keys = np.unique(np.asarray(keys, np.int64).reshape(-1))
        pos = self._probe(keys, for_insert=False)
        hit = pos >= 0
        if hit.any():
            self.tomb[pos[hit]] = True
            n = int(hit.sum())
            self.count -= n
            self.tombs += n
            if self.tombs > self.capacity // 4:
                self._rehash_cluster()

    def _rehash_cluster(self):
        """Compaction sweep: rebuild without tombstones."""
        live = (self.keys != _EMPTY) & ~self.tomb
        k = self.keys[live].copy()
        v = self.values[live].copy()
        s = self.scores[live].copy()
        sl = {n: c[live].copy() for n, c in self.slots.items()}
        self._alloc(self.capacity)
        self._ensure_slots(sl.keys())
        self.put(k, v, s, sl)

    def __len__(self):
        return self.count


@dataclasses.dataclass
class SpillStats:
    demoted: int = 0
    promoted: int = 0
    served_from_tier: int = 0


def _host_ids(ids) -> np.ndarray:
    """Ids (a tensor anywhere, numpy or a list) as flat int64 numpy."""
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids, np.int64).reshape(-1)


def absorb_evicted_dict(store, stats: SpillStats, ev, dim: int) -> np.ndarray:
    """Absorb a ``return_evicted`` dict into a host store: the displaced
    resident rows (with scores and optimizer slots) and the input rows
    that could not be placed (they go on living in the tier). Returns the
    keys not placed, so an import knows what never reached the card."""
    keys = _host_ids(ev["keys"])
    store.put(keys, hashtable.host_words(ev["values"]).reshape(-1, dim),
              ev["scores"].reshape(-1).cpu().numpy(),
              {n: hashtable.host_words(c).reshape(-1, dim)
               for n, c in ev["slots"].items()})
    stats.demoted += int((keys != _EMPTY).sum())
    dropped = (_host_ids(ev["dropped_keys"]) if "dropped_keys" in ev
               else np.empty(0, np.int64))
    if len(dropped) and (dropped != _EMPTY).any():
        store.put(dropped, hashtable.host_words(
            ev["dropped_values"]).reshape(-1, dim))
        stats.demoted += int((dropped != _EMPTY).sum())
    return dropped[dropped != _EMPTY]


def make_host_store(dim: int, value_dtype=torch.float32,
                    initial_capacity: int = 1 << 16):
    """The native C++ store for float32 rows (its build raising when it
    fails), the numpy ``HostKVStore`` for every other value dtype."""
    vdt = hashtable.np_dtype(value_dtype)
    if vdt == np.float32:
        from recommenders_addons_tpu_torch.native import NativeHostKVStore

        return NativeHostKVStore(dim, vdt, initial_capacity)
    return HostKVStore(dim, vdt, initial_capacity)


def _victim_rows(spec, st: hashtable.TableState, k: int):
    """The ``k`` coldest rows of one table: ``(state with their key and
    score planes cleared, keys, packed rows, scores)`` on its device, the
    rows through one ``row_gather`` (EMPTY keys and zero rows where fewer
    than ``k`` are live)."""
    victims, valid = hashtable.lowest_score_victims(spec, st, k)
    safe = torch.where(valid, victims, 0)
    vkeys = torch.where(valid, hashtable.join_key(
        hashtable.take_elem(st.key_lo, safe),
        hashtable.take_elem(st.key_hi, safe)), spec.empty_key)
    vscores = torch.where(valid, hashtable.take_elem(st.scores, safe), 0)
    packed = hashtable.gather_packed(st, victims, valid)
    packed = hashtable.where_or_zero(valid[:, None], packed)
    idx = torch.where(valid, victims, st.capacity)
    e_lo, e_hi = hashtable._split_int(spec.empty_key)
    new = st.replace(
        key_lo=hashtable._set_drop(st.key_lo, idx,
                                   st.key_lo.new_full((k,), e_lo)),
        key_hi=hashtable._set_drop(st.key_hi, idx,
                                   st.key_hi.new_full((k,), e_hi)),
        scores=hashtable._set_drop(st.scores, idx, st.scores.new_zeros(k)))
    return new, vkeys, packed, vscores


def _with_tier_fill(vals: torch.Tensor, resident: np.ndarray, flat, store,
                    stats: SpillStats, dim: int, default_value):
    """``vals`` ([N, dim] on its device) with the non-resident rows taken
    from the store where it holds them, else ``default_value``: one copy
    to the host and one back."""
    tvals, _, _, thit = store.get(flat[~resident])
    stats.served_from_tier += int(thit.sum())
    out = vals.reshape(-1, dim).cpu().clone()
    fill = torch.where(torch.from_numpy(thit)[:, None],
                       hashtable.from_words(tvals, out.dtype),
                       torch.tensor(default_value, dtype=out.dtype))
    out[torch.from_numpy(~resident)] = fill
    return out.to(vals.device)


class SpillTier:
    """Card <-> host-DRAM movement around one ``Variable``'s state.

    ``store`` may be any object of ``HostKVStore``'s surface: a
    ``serving.kv.RemoteKVStore`` shares one tier across processes (the
    reference's Redis contract)."""

    def __init__(self, var: Variable, initial_capacity: int = 1 << 16,
                 store=None):
        self.var = var
        self.store = store if store is not None else make_host_store(
            var.dim, var.value_dtype, initial_capacity)
        self.stats = SpillStats()

    # -- demote ------------------------------------------------------------

    def demote(self, state: hashtable.TableState,
               num_evict: int) -> hashtable.TableState:
        """Evict the ``num_evict`` coldest rows into the host tier: a radix
        select of the victims (``evict_lowest``'s), one row gather, one
        copy of the victim rows to the host."""
        d = state.dim
        new, vkeys, packed, vscores = _victim_rows(self.var.spec, state,
                                                   num_evict)
        h_keys = vkeys.cpu().numpy()
        h_packed = hashtable.host_words(packed)
        self.store.put(
            h_keys, h_packed[:, :d], vscores.cpu().numpy(),
            {n: h_packed[:, state.slot_offset(n):state.slot_offset(n) + d]
             for n in state.slot_names})
        self.stats.demoted += int((h_keys != _EMPTY).sum())
        return new

    def demote_to_watermark(self, state, high: float = 0.95,
                            low: float = 0.80) -> hashtable.TableState:
        """If occupancy is above ``high``, demote down to ``low``. The
        evict count rounds UP to a power of two (the extra rows land in
        the tier), as the JAX package's does."""
        cap = state.capacity
        live = int(self.var.size(state))
        if live > int(high * cap):
            return self.demote(state, min(_pow2(live - int(low * cap)), cap))
        return state

    # -- promote -----------------------------------------------------------

    def promote(self, state: hashtable.TableState,
                ids) -> hashtable.TableState:
        """Move the batch's keys that the card misses and the tier holds
        back into the table (call before the training step)."""
        var = self.var
        ids = np.unique(_host_ids(ids))
        ids = ids[ids != _EMPTY]
        if len(self.store) == 0 or len(ids) == 0:
            return state
        n = len(ids)
        ids_p = np.full((_pow2(n),), _EMPTY, np.int64)
        ids_p[:n] = ids
        _, found = var.lookup(state, torch.from_numpy(ids_p),
                              return_exists=True)
        missing = ids[~found.cpu().numpy()[:n]]
        if len(missing) == 0:
            return state
        vals, scores, slots, hit = self.store.get(missing)
        hit_keys = missing[hit]
        if len(hit_keys) == 0:
            return state
        state = self._ensure_state_slots(state, slots.keys())
        pk, pv, ps, psl = _pad_kv_pow2(
            hit_keys, vals[hit], scores[hit],
            {n_: c[hit] for n_, c in slots.items()} or None)
        vdt = var.value_dtype
        state, ev = var.import_batch(
            state, torch.from_numpy(pk), hashtable.from_words(pv, vdt),
            scores=torch.from_numpy(ps),
            slot_rows={n_: hashtable.from_words(c, vdt)
                       for n_, c in psl.items()} if psl else None,
            return_evicted=True)
        not_placed = set(absorb_evicted_dict(self.store, self.stats, ev,
                                             var.dim).tolist())
        placed = np.asarray(
            [k for k in hit_keys.tolist() if k not in not_placed], np.int64)
        self.store.delete(placed)
        self.stats.promoted += len(placed)
        return state

    def _ensure_state_slots(self, state, names):
        for n in names:
            if n not in state.slot_names:
                state = hashtable.with_slot(state, n, state.slot_init(n))
        return state

    # -- training and serving ----------------------------------------------

    def apply_gradients(self, state, ctx, grads, optimizer, step=0,
                        epoch=0) -> hashtable.TableState:
        """Sparse apply that absorbs the rows its inserts displace into
        the tier: training through a spill tier never loses a row."""
        state, ev = self.var.apply_gradients(
            state, ctx, grads, optimizer, step=step, epoch=epoch,
            return_evicted=True)
        absorb_evicted_dict(self.store, self.stats, ev, self.var.dim)
        return state

    def lookup_through(self, state: hashtable.TableState, ids,
                       default_value: float = 0.0) -> torch.Tensor:
        """Read-through serving lookup: the card's row, else the tier's,
        else ``default_value``. Changes no state."""
        var = self.var
        ids_t = torch.as_tensor(ids)
        vals, found = var.lookup(state, ids_t, return_exists=True)
        found_h = found.cpu().numpy().reshape(-1)
        if found_h.all() or len(self.store) == 0:
            return vals
        out = _with_tier_fill(vals, found_h, _host_ids(ids_t), self.store,
                              self.stats, var.dim, default_value)
        return out.reshape(vals.shape)

    def total_keys(self, state) -> int:
        return int(self.var.size(state)) + len(self.store)


class ShardedSpillTier:
    """Card <-> host-DRAM movement around a ``ShardedVariable``'s state,
    the terabyte-table configuration at its sharded scale. One host store
    serves the shards this process holds; each shard selects and gathers
    its own victims, and promotions re-enter through the
    owner-partitioned ``import_host_arrays``."""

    def __init__(self, svar: ShardedVariable,
                 initial_capacity: int = 1 << 16, store=None):
        if not isinstance(svar, ShardedVariable):
            raise TypeError("ShardedSpillTier needs a ShardedVariable")
        self.svar = svar
        self.var = svar.var
        self.store = store if store is not None else make_host_store(
            self.var.dim, self.var.value_dtype, initial_capacity)
        self.stats = SpillStats()

    # -- demote ------------------------------------------------------------

    def demote(self, state: ShardedState,
               num_evict_per_shard: int) -> ShardedState:
        """Evict the coldest ``num_evict_per_shard`` rows of every shard
        into the host tier (keys, values, scores and optimizer slots move
        together), the victims taken in shard order."""
        var = self.var
        k = int(num_evict_per_shard)
        outs = [_victim_rows(var.spec, st, k) for st in state.shards]
        h_keys = np.concatenate([o[1].cpu().numpy() for o in outs])
        h_packed = np.concatenate([hashtable.host_words(o[2])
                                   for o in outs])
        h_scores = np.concatenate([o[3].cpu().numpy() for o in outs])
        d = var.dim
        self.store.put(
            h_keys, h_packed[:, :d], h_scores,
            {n: h_packed[:, d * (1 + i):d * (2 + i)]
             for i, n in enumerate(state.slot_names)})
        self.stats.demoted += int((h_keys != _EMPTY).sum())
        return state.replace(o[0] for o in outs)

    def demote_to_watermark(self, state, high: float = 0.95,
                            low: float = 0.80) -> ShardedState:
        """If the occupancy over every shard is above ``high``, demote
        each shard down to ``low`` (the per-shard count rounds up to a
        power of two, as the one-table tier's)."""
        svar = self.svar
        total_cap = svar.var.spec.capacity * svar.num_shards
        live = int(svar.size(state))
        if live > int(high * total_cap):
            per_shard = max((live - int(low * total_cap))
                            // svar.num_shards, 1)
            return self.demote(
                state, min(_pow2(per_shard), svar.var.spec.capacity))
        return state

    # -- promote -----------------------------------------------------------

    def promote(self, state: ShardedState, ids) -> ShardedState:
        """Move the batch's tier-held keys that the card misses back into
        their owner shards (owner-partitioned host import, exact for any
        skew)."""
        svar = self.svar
        vdt = self.var.value_dtype
        ids = np.unique(_host_ids(ids))
        ids = ids[ids != _EMPTY]
        if len(self.store) == 0 or len(ids) == 0:
            return state
        n = len(ids)
        ids_p = np.full((_pow2(n),), _EMPTY, np.int64)
        ids_p[:n] = ids
        resident = svar.contains(state, torch.from_numpy(ids_p)).cpu(
            ).numpy()[:n]
        missing = ids[~resident]
        if len(missing) == 0:
            return state
        vals, scores, slots, hit = self.store.get(missing)
        hit_keys = missing[hit]
        if len(hit_keys) == 0:
            return state
        state = svar.ensure_slot_columns(
            state, {n_: float(dict(state.slot_inits).get(n_, 0.0))
                    for n_ in slots})
        pk, pv, ps, psl = _pad_kv_pow2(
            hit_keys, vals[hit], scores[hit],
            {n_: c[hit] for n_, c in slots.items()} or None)
        state, evs = svar.import_host_arrays(
            state, pk, hashtable.from_words(pv, vdt), scores=ps,
            slot_rows={n_: hashtable.from_words(c, vdt)
                       for n_, c in psl.items()} if psl else None,
            return_evicted=True)
        # residents the import displaces land back in the store; keys it
        # could not place stay there (not deleted)
        not_placed = set()
        for ev in evs:
            not_placed.update(absorb_evicted_dict(
                self.store, self.stats, ev, self.var.dim).tolist())
        placed = np.asarray(
            [k for k in hit_keys.tolist() if k not in not_placed], np.int64)
        self.store.delete(placed)
        self.stats.promoted += len(placed)
        return state

    def apply_gradients(self, state, ctx, grads, optimizer, step=0,
                        epoch=0) -> ShardedState:
        """Sharded sparse apply that absorbs the rows its inserts displace
        into the tier."""
        state, ev = self.svar.apply_gradients(
            state, ctx, grads, optimizer, step=step, epoch=epoch,
            return_evicted=True)
        absorb_evicted_dict(self.store, self.stats, ev, self.var.dim)
        return state

    def lookup_through(self, state, ids,
                       default_value: float = 0.0) -> torch.Tensor:
        """Serving read-through: the card's row, else the tier's, else
        ``default_value``; no state change."""
        svar = self.svar
        ids_t = torch.as_tensor(ids).reshape(-1)
        vals = svar.lookup(state, ids_t)
        resident = svar.contains(state, ids_t).cpu().numpy()
        if resident.all() or len(self.store) == 0:
            return vals
        return _with_tier_fill(vals, resident, _host_ids(ids_t), self.store,
                               self.stats, self.var.dim, default_value)

    def total_keys(self, state) -> int:
        return int(self.svar.size(state)) + len(self.store)


def make_spill_tier(var_or_sharded, initial_capacity: int = 1 << 16,
                    store=None):
    """A ``SpillTier`` for a Variable, a ``ShardedSpillTier`` for a
    sharded one. ``store``: a shared backend (e.g.
    ``serving.kv.RemoteKVStore``)."""
    if isinstance(var_or_sharded, ShardedVariable):
        return ShardedSpillTier(var_or_sharded, initial_capacity, store)
    return SpillTier(var_or_sharded, initial_capacity, store)


class HybridTable:
    """A capacity-bounded card table plus an unbounded host tier, with
    promote-before-step and demote-on-watermark (the "terabyte table",
    SURVEY.md §7 step 8). Takes a ``Variable`` or a ``ShardedVariable``.

    As in the JAX package, ``prepare_batch`` demotes after it promotes,
    and the promoted rows carry their old scores back, so the watermark
    may demote rows it has just promoted; a batch key can then be
    inserted fresh by the training lookup while its old row stays in the
    tier, and ``total_keys`` counts it twice."""

    def __init__(self, var, high: float = 0.95, low: float = 0.80):
        self.var = var.var if isinstance(var, ShardedVariable) else var
        self._owner = var
        self.tier = make_spill_tier(var)
        self.state = var.init()
        self.high, self.low = high, low

    def prepare_batch(self, ids):
        """Promote this batch's tier rows, then demote over the
        watermark."""
        self.state = self.tier.promote(self.state, ids)
        self.state = self.tier.demote_to_watermark(self.state, self.high,
                                                   self.low)
        return self.state

    def upsert(self, keys, values, step=0):
        """Insert-or-assign; rows that bucket eviction displaces go to the
        host tier instead of being lost."""
        self.state, evicted = self._owner.upsert(
            self.state, keys, values, step=step, return_evicted=True)
        self.absorb_evicted(evicted)
        return self.state

    def absorb_evicted(self, evicted):
        absorb_evicted_dict(self.tier.store, self.tier.stats, evicted,
                            self.var.dim)
