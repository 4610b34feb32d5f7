"""KV-native checkpoints for dynamic-embedding tables, the port of the JAX
package's ``train/checkpoint.py``: the same sidecar files, byte for byte,
so each package restores the other's checkpoints.

Layout (the reference's ``<var>_mht_<i+1>of<n>_rank<r>_size<s>`` names)::

    <directory>/TFRADynamicEmbedding[-<global_step>]/
        <var_name>/
            meta_rank<r>.json
            <var_name>_mht_<i+1>of<n>_rank<r>_size<s>-keys     raw LE binary
            ...-values, -scores, -slots.<slot_name>

Save finds the live slots on the table's device, gathers their value and
slot columns there in one row gather (``row_gather`` on a card), copies
only the live rows to the host and writes them in ``buffer_size``-row
chunks to a temporary file renamed into place. The rows are in ascending
slot order and the dtypes and meta JSON are the JAX package's, so the
files are the ones it writes for the same table (16-bit values as their
raw words: numpy has no bfloat16). Restore reads every shard file set it
finds, whatever ``<n>`` and rank layout, in ``buffer_size``-row chunks
through ``Variable.import_batch`` (``row_scatter`` on a card): a one-table
port restores a checkpoint a sharded JAX table wrote.

A ``parallel.ShardedVariable`` saves one file set for each shard this
process holds (``<var>_mht_<i+1>of<S>_rank<r>_size<s>``, each shard's
rows in its slot order, as the JAX package writes them). Its restore
takes the direct path when the files' shard count is the table's (each
file streams into its own shard through ``import_local``, no routing;
``LAST_RESTORE_USED_DIRECT``), and otherwise partitions the rows by
owner on the host (``import_host_arrays``).

A spill tier's rows (``tier=``: a ``SpillTier``, ``ShardedSpillTier``,
``HybridTable`` or a bare host store) are written beside the table's as
``tier/<var>_mht_tier_rank<r>_size<s>-{keys,values,scores,slots.<n>}``
(``save_tier``), and a restore given a tier reads them into its store
(``load_tier``); given none, it merges them into the table with the JAX
package's warning. Every file is written through the native buffered row
writer (``native/host_kv.cc``, ``hkv_write_gathered``).

``DECheckpoint`` keeps tables as sidecar files and dense entries
(``nn.Module``s by their ``state_dict``, tensors, and dicts, lists and
tuples of them) in ``dense[-<step>].npz`` with a structure string of the
port's own: dense files are not read across packages (``convert.py``
carries dense weights).
"""

from __future__ import annotations

import glob
import json
import os
import re
import shutil
import warnings
from typing import Any, Dict, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashing, hashtable
from recommenders_addons_tpu_torch.ops.variable import Variable
from recommenders_addons_tpu_torch.parallel.sharded import ShardedVariable
from recommenders_addons_tpu_torch.utils.config import env_config

DE_DIR_NAME = "TFRADynamicEmbedding"


def _resolve_buffer(buffer_size: Optional[int]) -> int:
    """None -> ``TFRA_TPU_CKPT_BUFFER_KEYS`` (utils.config)."""
    if buffer_size is not None:
        return buffer_size
    return env_config().checkpoint_buffer_keys


def _resolve_dir(directory: Optional[str]) -> str:
    """None -> the ``TFRA_SAVED_KV`` override."""
    if directory is not None:
        return directory
    d = env_config().saved_kv_dir
    if d is None:
        raise ValueError(
            "no checkpoint directory given and TFRA_SAVED_KV is unset")
    return d


_SHARD_RE = re.compile(r"_mht_(\d+)of(\d+)_rank(\d+)_size(\d+)-keys$")


def _var_of(table) -> Variable:
    """The Variable of a table entry (a ``Variable`` or a
    ``ShardedVariable``)."""
    if isinstance(table, ShardedVariable):
        return table.var
    if not isinstance(table, Variable):
        raise TypeError(f"not a table: {type(table).__name__}")
    return table


def _de_dir(directory: str, global_step: Optional[int]) -> str:
    name = DE_DIR_NAME if global_step is None else (
        f"{DE_DIR_NAME}-{int(global_step)}")
    return os.path.join(directory, name)


def _atomic_write(path: str, write_fn):
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write_fn(f)
    os.replace(tmp, path)


def _native_dump(path: str, arr: np.ndarray, sel: np.ndarray,
                 buffer_rows: int) -> bool:
    """Write ``arr[sel]`` through the native buffered row writer
    (``hkv_write_gathered``, the reference's streaming SaveToFileSystem
    role) to a temporary file renamed into place, staging at most
    ``buffer_rows`` rows (and no more than it writes: the writer
    allocates its whole buffer). False when the write fails (the numpy
    path then tries); the library's build raises."""
    import ctypes

    from recommenders_addons_tpu_torch.native import get_lib

    lib = get_lib()
    arr = np.ascontiguousarray(arr)
    sel = np.ascontiguousarray(sel, np.int64)
    row_bytes = arr.dtype.itemsize * int(np.prod(arr.shape[1:] or (1,)))
    tmp = path + ".tmp"
    n = lib.hkv_write_gathered(
        tmp.encode(), arr.ctypes.data_as(ctypes.c_void_p), row_bytes,
        sel.ctypes.data_as(ctypes.c_void_p), len(sel),
        max(min(int(buffer_rows), len(sel)), 1))
    if n != len(sel):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, path)
    return True


def _dump_rows(path: str, arr: np.ndarray, buffer_size: int):
    """Write ``arr``'s rows in ``buffer_size``-row chunks, atomically:
    the native writer, numpy when its write fails."""
    if _native_dump(path, arr, np.arange(len(arr)), buffer_size):
        return

    def w(f):
        for off in range(0, len(arr), buffer_size):
            f.write(np.ascontiguousarray(arr[off:off + buffer_size]).tobytes())

    _atomic_write(path, w)


def _tier_store(tier_or_store):
    """The host store of a SpillTier / ShardedSpillTier / HybridTable, or
    the store itself."""
    if hasattr(tier_or_store, "export_all"):
        return tier_or_store
    if hasattr(tier_or_store, "tier"):  # HybridTable
        return tier_or_store.tier.store
    return tier_or_store.store


def _process() -> tuple:
    """``(rank, world size)`` of an initialised ``torch.distributed``
    group, else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def save_tier(tier, var: Variable, vdir: str, proc_size: int = 1,
              proc_rank: int = 0, buffer_size: Optional[int] = None) -> int:
    """Dump a spill tier's rows (keys, values, scores, optimizer slots)
    as sidecar files under ``<vdir>/tier/``, so a cold restore serves
    every key. A shared store (``is_shared``: one network tier for every
    process) is dumped by rank 0 only. Returns the rows written."""
    buffer_size = _resolve_buffer(buffer_size)
    store = _tier_store(tier)
    if proc_rank != 0 and getattr(store, "is_shared", False):
        return 0
    keys, values, scores, slots = store.export_all()
    keys = np.asarray(keys, hashtable.np_dtype(var.key_dtype)).reshape(-1)
    vdt = hashtable.np_dtype(var.value_dtype)
    tdir = os.path.join(vdir, "tier")
    os.makedirs(tdir, exist_ok=True)
    prefix = os.path.join(
        tdir, f"{var.name}_mht_tier_rank{proc_rank}_size{proc_size}")
    _dump_rows(prefix + "-keys", keys, buffer_size)
    _dump_rows(prefix + "-values",
               np.asarray(values, vdt).reshape(-1, var.dim), buffer_size)
    _dump_rows(prefix + "-scores", np.asarray(scores).astype(
        hashtable.np_dtype(var.spec.score_dtype)), buffer_size)
    for name in sorted(slots):
        _dump_rows(prefix + f"-slots.{name}",
                   np.asarray(slots[name], vdt).reshape(-1, var.dim),
                   buffer_size)
    return len(keys)


def load_tier(tier, var: Variable, vdir: str,
              proc_size: Optional[int] = None,
              proc_rank: Optional[int] = None,
              num_shards: Optional[int] = None,
              buffer_size: Optional[int] = None) -> int:
    """Read a checkpoint's tier files (any saved rank layout), streamed
    in ``buffer_size``-row chunks, into a tier's store. Over several
    processes (rank and world from ``torch.distributed`` when it is
    initialised) each takes its part: a shared store the keys with
    ``shard_of_np(key, proc_size) == rank``; a local store, given the
    sharded table's ``num_shards``, the keys whose owner shard this
    process holds (shards are placed on processes in contiguous blocks),
    which is where demote would have put them. Returns the rows this
    process loaded."""
    tdir = os.path.join(vdir, "tier")
    if not os.path.isdir(tdir):
        return 0
    rank, world = _process()
    proc_size = world if proc_size is None else proc_size
    proc_rank = rank if proc_rank is None else proc_rank
    store = _tier_store(tier)
    shared = getattr(store, "is_shared", False)
    buffer_size = _resolve_buffer(buffer_size)
    loaded = 0
    for k, v, sc, sl in _iter_shard_chunks(tdir, var, buffer_size):
        keys = k.numpy().astype(np.int64)
        values, scores = hashtable.host_words(v), sc.numpy()
        slots = {n: hashtable.host_words(c) for n, c in sl.items()}
        if proc_size > 1:
            if not shared and num_shards and num_shards % proc_size == 0:
                spp = num_shards // proc_size  # device shards a process
                mine = (hashing.shard_of_np(keys, num_shards)
                        // spp) == proc_rank
            else:
                mine = hashing.shard_of_np(keys, proc_size) == proc_rank
            keys, values, scores = keys[mine], values[mine], scores[mine]
            slots = {n: c[mine] for n, c in slots.items()}
        store.put(keys, values, scores, slots or None)
        loaded += len(keys)
    return loaded


def _live_rows(var: Variable, state: hashtable.TableState):
    """The live slots' ``(keys, values, scores, {slot: rows})`` as numpy,
    in ascending slot order, compacted on the table's device: the value
    and slot columns in one row gather (``gather_values`` without slots,
    ``gather_packed`` with them), then one copy of the live rows."""
    mask = hashtable.occupancy_mask(var.spec, state)
    idx = torch.nonzero(mask).reshape(-1).to(torch.int32)  # host sync
    ones = torch.ones(idx.shape, dtype=torch.bool, device=idx.device)
    d = state.dim
    if state.slot_names:
        packed = hashtable.gather_packed(state, idx, ones)
        cols = hashtable.host_words(
            packed[:, :d * (1 + len(state.slot_names))])
    else:
        cols = hashtable.host_words(hashtable.gather_values(state, idx, ones))
    keys = state.keys[idx.long()].cpu().numpy()
    scores = state.scores[idx.long()].cpu().numpy()
    slots = {nm: cols[:, state.slot_offset(nm):state.slot_offset(nm) + d]
             for nm in state.slot_names}
    return keys, cols[:, :d], scores, slots


def _host_shards(table, state):
    """``(shard index, shard count, TableState)`` of every shard this
    process holds (one, ``0 of 1``, for a one-table Variable): each
    process saves only its own shards."""
    if not isinstance(table, ShardedVariable):
        yield 0, 1, state
        return
    for sid, st in zip(state.shard_ids, state.shards):
        yield sid, state.num_shards, st


def save_dynamic_embedding(var_or_sharded, state,
                           directory: Optional[str] = None,
                           global_step: Optional[int] = None,
                           proc_size: int = 1, proc_rank: int = 0,
                           buffer_size: Optional[int] = None,
                           tier=None) -> str:
    """Write one table's keys, values, scores and optimizer slots as
    sidecar files (a set for each shard this process holds, tagged with
    ``proc_rank`` / ``proc_size``) and its ``meta_rank<r>.json``.
    ``directory=None`` falls back to ``TFRA_SAVED_KV``, ``buffer_size=None``
    to ``TFRA_TPU_CKPT_BUFFER_KEYS``. ``tier``: a spill tier (or a bare
    host store) whose rows are written beside the table's
    (:func:`save_tier`), so a hybrid table's checkpoint loses nothing.
    Returns the table's directory."""
    directory = _resolve_dir(directory)
    buffer_size = _resolve_buffer(buffer_size)
    var = _var_of(var_or_sharded)
    vdir = os.path.join(_de_dir(directory, global_step), var.name)
    os.makedirs(vdir, exist_ok=True)

    slot_names = sorted(state.slot_names)
    total_live = 0
    for i, n, st in _host_shards(var_or_sharded, state):
        keys, values, scores, slots = _live_rows(var, st)
        total_live += len(keys)
        prefix = os.path.join(
            vdir,
            f"{var.name}_mht_{i + 1}of{n}_rank{proc_rank}_size{proc_size}")
        _dump_rows(prefix + "-keys", keys, buffer_size)
        _dump_rows(prefix + "-values", values, buffer_size)
        _dump_rows(prefix + "-scores", scores, buffer_size)
        for s in slot_names:
            _dump_rows(prefix + f"-slots.{s}", slots[s], buffer_size)

    tier_rows = 0
    if tier is not None:
        tier_rows = save_tier(tier, var, vdir, proc_size=proc_size,
                              proc_rank=proc_rank, buffer_size=buffer_size)

    meta = {
        "name": var.name,
        "dim": var.dim,
        "key_dtype": hashtable.dtype_name(var.key_dtype),
        "value_dtype": hashtable.dtype_name(var.value_dtype),
        "score_dtype": hashtable.dtype_name(var.spec.score_dtype),
        "slot_names": slot_names,
        "slot_inits": dict(state.slot_inits),
        "num_shards": (var_or_sharded.num_shards if isinstance(
            var_or_sharded, ShardedVariable) else 1),
        "live_keys_this_rank": int(total_live),
        "tier_keys_this_rank": tier_rows,
        "proc_rank": proc_rank,
        "proc_size": proc_size,
    }
    _atomic_write(os.path.join(vdir, f"meta_rank{proc_rank}.json"),
                  lambda f: f.write(json.dumps(meta, indent=1).encode()))
    return vdir


def _scan_shard_files(vdir: str, var: Variable):
    """Inventory the shard file sets without reading row data:
    ``(prefixes, slot_names, rows_per_prefix)``; ``slot_names`` is the slot
    set every prefix has (a slot some lack restarts cold)."""
    key_files = sorted(glob.glob(os.path.join(vdir, "*-keys")))
    if not key_files:
        raise FileNotFoundError(f"no KV shard files under {vdir}")
    kdt = hashtable.np_dtype(var.key_dtype)
    prefixes = [kf[: -len("-keys")] for kf in key_files]
    rows = [os.path.getsize(kf) // kdt.itemsize for kf in key_files]
    slot_sets = [{sf.rsplit("-slots.", 1)[1]
                  for sf in glob.glob(p + "-slots.*")} for p in prefixes]
    common = set.intersection(*slot_sets) if slot_sets else set()
    return prefixes, sorted(common), rows


class _ShardReader:
    """Lockstep chunked reader over one shard prefix's files (keys,
    values, scores and slots, ``m`` rows at a time), as CPU tensors."""

    def __init__(self, prefix: str, var: Variable, slot_names):
        self.var = var
        self.kdt = hashtable.np_dtype(var.key_dtype)
        self.vdt = hashtable.np_dtype(var.value_dtype)
        self.sdt = hashtable.np_dtype(var.spec.score_dtype)
        self.remaining = os.path.getsize(prefix + "-keys") // (
            self.kdt.itemsize)
        self._kf = open(prefix + "-keys", "rb")
        self._vf = open(prefix + "-values", "rb")
        sc_path = prefix + "-scores"
        self._sf = open(sc_path, "rb") if os.path.exists(sc_path) else None
        self._slfs = {nm: open(prefix + f"-slots.{nm}", "rb")
                      for nm in slot_names}

    def read(self, m: int):
        """The next ``min(m, remaining)`` rows: ``(keys, values, scores,
        slots)``."""
        var = self.var
        d = var.dim
        m = min(m, self.remaining)
        self.remaining -= m
        k = hashtable.from_words(
            np.fromfile(self._kf, dtype=self.kdt, count=m), var.key_dtype)
        v = hashtable.from_words(
            np.fromfile(self._vf, dtype=self.vdt, count=m * d).reshape(m, d),
            var.value_dtype)
        sc = (np.fromfile(self._sf, dtype=self.sdt, count=m)
              if self._sf is not None else np.ones((m,), self.sdt))
        sl = {nm: hashtable.from_words(
                  np.fromfile(f, dtype=self.vdt, count=m * d).reshape(m, d),
                  var.value_dtype)
              for nm, f in self._slfs.items()}
        return k, v, torch.from_numpy(sc), sl

    def close(self):
        for f in ([self._kf, self._vf] + ([self._sf] if self._sf else [])
                  + list(self._slfs.values())):
            f.close()


def _iter_shard_chunks(vdir: str, var: Variable, chunk_rows: int):
    """Yield ``(keys [m], values [m, D], scores [m], slots {name: [m, D]})``
    across every shard file set, at most ``chunk_rows`` rows a chunk."""
    prefixes, slot_names, _ = _scan_shard_files(vdir, var)
    for p in prefixes:
        r = _ShardReader(p, var, slot_names)
        try:
            while r.remaining:
                yield r.read(chunk_rows)
        finally:
            r.close()


def _ensure_restore_slots(table, state, vdir, slot_names):
    """Add the checkpoint's slot columns (fills from the saved meta)."""
    if not slot_names:
        return state
    slot_inits: Dict[str, float] = {}
    for mf in glob.glob(os.path.join(vdir, "meta_rank*.json")):
        with open(mf) as f:
            slot_inits.update(json.load(f).get("slot_inits", {}))
    specs = {n: float(slot_inits.get(n, 0.0)) for n in slot_names}
    if isinstance(table, ShardedVariable):
        return table.ensure_slot_columns(state, specs)
    for n, fill in specs.items():
        state = hashtable.with_slot(state, n, fill)
    return state


def _import_streamed(table, state, vdir, buffer_size):
    """Chunked import of every shard file set under ``vdir``: a sharded
    table partitions each chunk by owner on the host."""
    var = _var_of(table)
    for keys, values, scores, slots in _iter_shard_chunks(vdir, var,
                                                          buffer_size):
        if isinstance(table, ShardedVariable):
            state = table.import_host_arrays(
                state, keys, values, scores=scores, slot_rows=slots or None,
                buffer_size=buffer_size)
        else:
            state = var.import_batch(state, keys, values, scores=scores,
                                     slot_rows=slots or None)
    return state


def _direct_shard_layout(prefixes, num_shards: int):
    """Shard index -> file prefix when the saved files are exactly one set
    for each of ``num_shards`` shards (the restore can then stream each
    file into its own shard); None when any file deviates."""
    by_idx = {}
    for p in prefixes:
        m = _SHARD_RE.search(p + "-keys")
        if not m:
            return None
        i, n = int(m.group(1)) - 1, int(m.group(2))
        if n != num_shards or i in by_idx:
            return None
        by_idx[i] = p
    if set(by_idx) != set(range(num_shards)):
        return None
    return by_idx


# whether the last load_dynamic_embedding took the direct (shard count
# matched, no re-partitioning) per-shard path
LAST_RESTORE_USED_DIRECT = False


def _import_direct_sharded(sv: ShardedVariable, state, by_idx, slot_names,
                           chunk_rows: int):
    """Shard-count-matched restore: each saved shard file streams into
    its own shard through ``import_local`` (no host re-sort, no routing;
    every key of file ``i`` has ``shard_of(key, S) == i``, since the file
    was written from shard ``i``'s rows). Only the shards this process
    holds read their files."""
    var = sv.var
    s, d = sv.num_shards, var.dim
    sdt = var.spec.score_dtype
    readers = {i: _ShardReader(by_idx[i], var, slot_names)
               for i in state.shard_ids}
    m_chunk = max(1, chunk_rows // s)
    try:
        while any(r.remaining for r in readers.values()):
            m = min(m_chunk, max(r.remaining for r in readers.values()))
            k_blk = torch.full((s, m), var.empty_key, dtype=var.key_dtype)
            v_blk = torch.zeros((s, m, d), dtype=var.value_dtype)
            s_blk = torch.zeros((s, m), dtype=sdt)
            sl_blk = {nm: torch.zeros((s, m, d), dtype=var.value_dtype)
                      for nm in slot_names}
            for i, r in readers.items():
                k, v, sc, sl = r.read(m)
                w = len(k)
                k_blk[i, :w] = k
                v_blk[i, :w] = v
                s_blk[i, :w] = sc
                for nm, c in sl.items():
                    sl_blk[nm][i, :w] = c
            state = sv.import_local(state, k_blk, v_blk, scores=s_blk,
                                    slot_rows=sl_blk or None)
    finally:
        for r in readers.values():
            r.close()
    return state


def load_dynamic_embedding(var_or_sharded, state,
                           directory: Optional[str] = None,
                           global_step: Optional[int] = None,
                           buffer_size: Optional[int] = None,
                           tier=None):
    """Restore a table's rows from sidecar files into ``state``, streamed
    in ``buffer_size``-row chunks. Elastic: every saved shard file set is
    read, whatever the saved shard count and rank layout; a sharded table
    whose shard count matches the files' takes the direct per-shard path.
    ``tier``: the checkpoint's spill-tier rows (``tier/``) are read into
    its store (:func:`load_tier`); with ``tier=None`` they are merged into
    the table, with the JAX package's warning that rows beyond its
    capacity are dropped."""
    global LAST_RESTORE_USED_DIRECT
    directory = _resolve_dir(directory)
    buffer_size = _resolve_buffer(buffer_size)
    var = _var_of(var_or_sharded)
    vdir = os.path.join(_de_dir(directory, global_step), var.name)
    prefixes, slot_names, rows_per = _scan_shard_files(vdir, var)

    merge_tier = False
    tdir = os.path.join(vdir, "tier")
    if tier is not None:
        load_tier(tier, var, vdir,
                  num_shards=(var_or_sharded.num_shards if isinstance(
                      var_or_sharded, ShardedVariable) else 1),
                  buffer_size=buffer_size)
    elif os.path.isdir(tdir):
        _, t_slots, t_rows_per = _scan_shard_files(tdir, var)
        if sum(t_rows_per):
            warnings.warn(
                f"checkpoint for '{var.name}' carries {sum(t_rows_per)} "
                "spill-tier rows but no tier was passed to "
                "load_dynamic_embedding; merging them into the HBM table "
                "— rows beyond its capacity will be dropped")
            merge_tier = True
            slot_names = sorted(set(slot_names) | set(t_slots))

    state = _ensure_restore_slots(var_or_sharded, state, vdir, slot_names)
    LAST_RESTORE_USED_DIRECT = False
    if sum(rows_per) > 0:
        by_idx = None
        if isinstance(var_or_sharded, ShardedVariable):
            by_idx = _direct_shard_layout(prefixes,
                                          var_or_sharded.num_shards)
        if by_idx is not None:
            state = _import_direct_sharded(var_or_sharded, state, by_idx,
                                           slot_names, buffer_size)
            LAST_RESTORE_USED_DIRECT = True
        else:
            state = _import_streamed(var_or_sharded, state, vdir, buffer_size)
    if merge_tier:
        state = _import_streamed(var_or_sharded, state, tdir, buffer_size)
    return state


def latest_checkpoint(directory: str) -> Optional[int]:
    """The largest global step among ``TFRADynamicEmbedding-<step>`` dirs
    (None if only the unstepped dir exists; raises if there is none)."""
    steps = []
    bare = False
    for d in glob.glob(os.path.join(directory, DE_DIR_NAME + "*")):
        base = os.path.basename(d)
        if base == DE_DIR_NAME:
            bare = True
        else:
            m = re.match(re.escape(DE_DIR_NAME) + r"-(\d+)$", base)
            if m:
                steps.append(int(m.group(1)))
    if steps:
        return max(steps)
    if bare:
        return None
    raise FileNotFoundError(f"no {DE_DIR_NAME}* under {directory}")


# ---------------------------------------------------------------------------
# dense entries: modules, tensors and nested containers of tensors
# ---------------------------------------------------------------------------


def _flatten(obj):
    """``(structure string, [tensor leaves])`` of a dense entry: an
    ``nn.Module`` (its ``state_dict``), a tensor, or a dict (keys sorted),
    list or tuple of them."""
    if isinstance(obj, torch.nn.Module):
        sd = obj.state_dict()
        return "Module(" + ",".join(sd) + ")", list(sd.values())
    if isinstance(obj, torch.Tensor):
        return "*", [obj]
    if isinstance(obj, dict):
        parts, leaves = [], []
        for k in sorted(obj):
            s, lv = _flatten(obj[k])
            parts.append(f"{k!r}:{s}")
            leaves += lv
        return "{" + ",".join(parts) + "}", leaves
    if isinstance(obj, (list, tuple)):
        parts, leaves = [], []
        for v in obj:
            s, lv = _flatten(v)
            parts.append(s)
            leaves += lv
        br = "[]" if isinstance(obj, list) else "()"
        return br[0] + ",".join(parts) + br[1], leaves
    raise TypeError(f"DECheckpoint: a dense entry holds modules, tensors "
                    f"and dicts, lists and tuples of them, not "
                    f"{type(obj).__name__}")


def _unflatten(obj, leaves):
    """``obj`` with its tensor leaves taken, in order, from the iterator
    ``leaves``: a module's loaded in place, tensors made anew on the
    current leaf's device and dtype."""
    if isinstance(obj, torch.nn.Module):
        sd = obj.state_dict()
        obj.load_state_dict({k: _leaf_like(v, next(leaves))
                             for k, v in sd.items()})
        return obj
    if isinstance(obj, torch.Tensor):
        return _leaf_like(obj, next(leaves))
    if isinstance(obj, dict):
        new = {k: _unflatten(obj[k], leaves) for k in sorted(obj)}
        return type(obj)((k, new[k]) for k in obj)
    out = [_unflatten(v, leaves) for v in obj]
    return out if isinstance(obj, list) else tuple(out)


def _leaf_like(cur: torch.Tensor, saved: np.ndarray) -> torch.Tensor:
    return hashtable.from_words(np.array(saved), cur.dtype).to(cur.device)


class DECheckpoint:
    """Object-based checkpoint of a mixed training state: tables as KV
    sidecar files, dense entries in one ``.npz`` (the reference's
    ``de.train.DECheckpoint``, train/checkpoint.py:117-406)::

        ckpt = DECheckpoint(table=var, dense=model.dense, opt=None)
        ckpt.save(dir, state={"table": st, "dense": towers, "opt": o},
                  step=100)
        restored = ckpt.restore(dir, state={...})   # the same keys

    A Variable or ShardedVariable entry is a table; a ``(table, tier)``
    pair a table with its spill tier, checkpointed and restored with it;
    anything else a dense entry, whose object is unused
    (the state holds it)."""

    def __init__(self, **objects):
        self._objects = objects

    @staticmethod
    def _split_entry(v):
        """``(table or None, tier or None)`` of a checkpoint entry."""
        if isinstance(v, (Variable, ShardedVariable)):
            return v, None
        if (isinstance(v, tuple) and len(v) == 2
                and isinstance(v[0], (Variable, ShardedVariable))):
            return v[0], v[1]
        return None, None

    def _is_table(self, v) -> bool:
        return self._split_entry(v)[0] is not None

    def save(self, directory: str, state: Dict[str, Any],
             step: Optional[int] = None, proc_size: int = 1,
             proc_rank: int = 0, keep: Optional[int] = None) -> str:
        os.makedirs(directory, exist_ok=True)
        flat = {}
        for name, obj in self._objects.items():
            if self._is_table(obj):
                table, tier = self._split_entry(obj)
                save_dynamic_embedding(
                    table, state[name], directory, global_step=step,
                    proc_size=proc_size, proc_rank=proc_rank, tier=tier)
            else:
                structure, leaves = _flatten(state[name])
                flat[f"{name}::treedef"] = np.asarray(structure)
                for i, leaf in enumerate(leaves):
                    flat[f"{name}::{i}"] = hashtable.host_words(leaf.detach())
        if proc_rank == 0 and flat:
            suffix = "" if step is None else f"-{int(step)}"
            path = os.path.join(directory, f"dense{suffix}.npz")
            tmp = path + ".tmp.npz"
            np.savez(tmp, **flat)
            os.replace(tmp, path)
        if keep is not None and proc_rank == 0:
            self._sweep(directory, keep)
        return directory

    def restore(self, directory: str, state: Dict[str, Any],
                step: Optional[int] = "latest") -> Dict[str, Any]:
        """The state with every entry restored: tables into the given
        table states, modules loaded in place, tensors made anew. Raises
        when a dense entry's structure or leaf count changed since the
        save."""
        if step == "latest":
            step = latest_checkpoint(directory)
        out = dict(state)
        suffix = "" if step is None else f"-{int(step)}"
        dense_path = os.path.join(directory, f"dense{suffix}.npz")
        dense = np.load(dense_path) if os.path.exists(dense_path) else None
        try:
            self._restore_entries(directory, state, step, dense, out)
        finally:
            if dense is not None:
                dense.close()
        return out

    def _restore_entries(self, directory, state, step, dense, out):
        for name, obj in self._objects.items():
            if self._is_table(obj):
                table, tier = self._split_entry(obj)
                out[name] = load_dynamic_embedding(
                    table, state[name], directory, global_step=step,
                    tier=tier)
            elif dense is not None:
                structure, leaves = _flatten(state[name])
                td_key = f"{name}::treedef"
                if td_key in dense.files:
                    saved = str(dense[td_key])
                    if saved != structure:
                        raise ValueError(
                            f"DECheckpoint.restore: dense entry '{name}' "
                            f"structure changed since save.\n"
                            f"  saved:   {saved}\n  current: {structure}")
                n_saved = sum(1 for k in dense.files
                              if k.startswith(f"{name}::") and k != td_key)
                if n_saved and n_saved != len(leaves):
                    raise ValueError(
                        f"DECheckpoint.restore: dense entry '{name}' has "
                        f"{len(leaves)} leaves but the checkpoint saved "
                        f"{n_saved}")
                saved_leaves = iter(
                    dense[f"{name}::{i}"] if f"{name}::{i}" in dense.files
                    else hashtable.host_words(leaf.detach())
                    for i, leaf in enumerate(leaves))
                out[name] = _unflatten(state[name], saved_leaves)

    def _sweep(self, directory: str, keep: int):
        """Delete stale ``TFRADynamicEmbedding-<step>`` dirs and their
        ``dense-<step>.npz``, keeping the newest ``keep``."""
        steps = sorted(
            int(m.group(1))
            for d in glob.glob(os.path.join(directory, DE_DIR_NAME + "-*"))
            if (m := re.match(re.escape(DE_DIR_NAME) + r"-(\d+)$",
                              os.path.basename(d))))
        for s in steps[:-keep] if keep else steps:
            shutil.rmtree(os.path.join(directory, f"{DE_DIR_NAME}-{s}"),
                          ignore_errors=True)
            for f in glob.glob(os.path.join(directory, f"dense-{s}.npz")):
                os.remove(f)
