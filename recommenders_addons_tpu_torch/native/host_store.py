"""ctypes wrapper for the native host KV store (the same batched surface
as ``ops/spill.HostKVStore``), the port of the JAX package's
``native/host_store.py``.

Payload layout: one float32 row of width ``dim * (1 + n_slots)`` per key,
``[value | slot_0 | slot_1 | ...]`` with the slot names in sorted order.
A new slot name repacks the store (once per optimizer)."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np

from recommenders_addons_tpu_torch.native.build import get_lib

_EMPTY = np.int64(np.iinfo(np.int64).min)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


class NativeHostKVStore:
    """int64 keys -> (value row, score, slot rows), backed by C++."""

    def __init__(self, dim: int, value_dtype=np.float32,
                 initial_capacity: int = 1 << 16,
                 num_threads: Optional[int] = None):
        if np.dtype(value_dtype) != np.float32:
            raise TypeError("the native store holds float32 payloads only")
        if num_threads is None:
            from recommenders_addons_tpu_torch.utils.config import env_config

            num_threads = env_config().host_store_threads
        self.dim = dim
        self.value_dtype = np.dtype(np.float32)
        self.num_threads = num_threads
        self.slot_names: Tuple[str, ...] = ()
        self._lib = get_lib()
        self._h = self._lib.hkv_create(dim, initial_capacity)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and getattr(self, "_lib", None) is not None:
            self._lib.hkv_destroy(h)
            self._h = None

    # -- layout ---------------------------------------------------------

    @property
    def _width(self) -> int:
        return self.dim * (1 + len(self.slot_names))

    def _repack_for_slots(self, new_names: Tuple[str, ...]):
        """Export everything and rebuild with the wider payload."""
        old_names = self.slot_names
        keys, payload, scores = self._export_raw()
        self.slot_names = new_names
        cap = max(int(self._lib.hkv_capacity(self._h)), 8)
        self._lib.hkv_destroy(self._h)
        self._h = self._lib.hkv_create(self._width, cap)
        if len(keys) == 0:
            return
        new_payload = np.zeros((len(keys), self._width), np.float32)
        new_payload[:, :self.dim] = payload[:, :self.dim]
        for j, name in enumerate(old_names):
            k = new_names.index(name)
            new_payload[:, (1 + k) * self.dim:(2 + k) * self.dim] = (
                payload[:, (1 + j) * self.dim:(2 + j) * self.dim])
        self._put_raw(keys, new_payload, scores)

    def _ensure_slots(self, names):
        want = tuple(sorted(set(self.slot_names) | set(names)))
        if want != self.slot_names:
            self._repack_for_slots(want)

    # -- raw ops --------------------------------------------------------

    def _put_raw(self, keys, payload, scores):
        keys = np.ascontiguousarray(keys, np.int64)
        payload = np.ascontiguousarray(payload, np.float32)
        scores = np.ascontiguousarray(scores, np.int64)
        self._lib.hkv_put(self._h, len(keys), _ptr(keys), _ptr(payload),
                          _ptr(scores))

    def _export_raw(self):
        n = int(self._lib.hkv_size(self._h))
        keys = np.empty((n,), np.int64)
        payload = np.empty((n, self._width), np.float32)
        scores = np.empty((n,), np.int64)
        if n:
            self._lib.hkv_export(self._h, _ptr(keys), _ptr(payload),
                                 _ptr(scores))
        return keys, payload, scores

    # -- HostKVStore surface --------------------------------------------

    def put(self, keys, values, scores=None,
            slots: Optional[Dict[str, np.ndarray]] = None):
        keys = np.asarray(keys, np.int64).reshape(-1)
        valid = keys != _EMPTY
        if not valid.any():
            return
        keys = keys[valid]
        values = np.asarray(values, np.float32).reshape(-1, self.dim)[valid]
        scores_a = (np.asarray(scores, np.int64).reshape(-1)[valid]
                    if scores is not None
                    else np.zeros((len(keys),), np.int64))
        slots = {n: np.asarray(c, np.float32).reshape(-1, self.dim)[valid]
                 for n, c in (slots or {}).items()}
        self._ensure_slots(slots.keys())
        payload = np.zeros((len(keys), self._width), np.float32)
        omitted = [n for n in self.slot_names if n not in slots]
        if omitted or scores is None:
            # read-modify-write: overwriting a key keeps the slot columns
            # and score this call does not give (as the numpy store,
            # which updates its columns independently)
            old_payload = np.empty((len(keys), self._width), np.float32)
            old_scores = np.empty((len(keys),), np.int64)
            found = np.empty((len(keys),), np.uint8)
            self._lib.hkv_get(self._h, len(keys), _ptr(keys),
                              _ptr(old_payload), _ptr(old_scores),
                              _ptr(found), self.num_threads)
            hit = found.astype(bool)
            if omitted:
                payload[hit] = old_payload[hit]
            if scores is None:
                scores_a[hit] = old_scores[hit]
        payload[:, :self.dim] = values
        for j, name in enumerate(self.slot_names):
            if name in slots:
                payload[:, (1 + j) * self.dim:(2 + j) * self.dim] = (
                    slots[name])
        self._put_raw(keys, payload, scores_a)

    def get(self, keys):
        """``(values, scores, {slot: rows}, found)`` of a key batch;
        zeros where not found."""
        keys = np.ascontiguousarray(np.asarray(keys, np.int64).reshape(-1))
        n = len(keys)
        payload = np.empty((n, self._width), np.float32)
        scores = np.empty((n,), np.int64)
        found = np.empty((n,), np.uint8)
        self._lib.hkv_get(self._h, n, _ptr(keys), _ptr(payload),
                          _ptr(scores), _ptr(found), self.num_threads)
        slots = {name: payload[:, (1 + j) * self.dim:(2 + j) * self.dim]
                 for j, name in enumerate(self.slot_names)}
        return payload[:, :self.dim], scores, slots, found.astype(bool)

    def export_all(self):
        """Every live row: ``(keys, values, scores, slots)``, the tier's
        side of a checkpoint."""
        keys, payload, scores = self._export_raw()
        slots = {name: payload[:, (1 + j) * self.dim:
                               (2 + j) * self.dim].copy()
                 for j, name in enumerate(self.slot_names)}
        return keys, payload[:, :self.dim].copy(), scores, slots

    def delete(self, keys):
        keys = np.ascontiguousarray(np.asarray(keys, np.int64).reshape(-1))
        self._lib.hkv_erase(self._h, len(keys), _ptr(keys))

    @property
    def count(self) -> int:
        return int(self._lib.hkv_size(self._h))

    @property
    def capacity(self) -> int:
        return int(self._lib.hkv_capacity(self._h))

    def __len__(self):
        return self.count
