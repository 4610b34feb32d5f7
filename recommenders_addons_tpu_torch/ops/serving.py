"""Inference serving: frozen, compressed lookup tables — the port of the
JAX package's ``ops/serving.py``.

``freeze()`` strips the slot columns and casts values (bf16 by default);
``export_compressed`` / ``load_compressed`` round-trip a table through the
same sidecar files the JAX package writes, byte for byte:
``<name>_serving-keys`` (raw keys), ``<name>_serving-values`` (raw
compressed values, row-major ``[count, dim]``) and
``<name>_serving-meta.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Optional

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops import hashtable
from recommenders_addons_tpu_torch.ops.variable import Variable
from recommenders_addons_tpu_torch.utils.config import resolve_device


@dataclasses.dataclass(frozen=True, eq=False)
class FrozenTable:
    """Immutable serving view of a trained table: probe + value gather
    only. ``spec.value_dtype`` is the compressed dtype; lookups return
    ``out_dtype`` after upcasting."""

    spec: hashtable.TableSpec
    state: hashtable.TableState
    out_dtype: Any = torch.float32
    default_value: float = 0.0

    def lookup(self, ids, return_exists: bool = False):
        ids = torch.as_tensor(ids)
        flat = ids.to(device=self.state.device,
                      dtype=self.spec.key_dtype).reshape(-1)
        vals, found = hashtable.lookup(self.spec, self.state, flat,
                                       self.default_value)
        vals = vals.to(self.out_dtype).reshape(tuple(ids.shape)
                                               + (self.spec.dim,))
        if return_exists:
            return vals, found.reshape(ids.shape)
        return vals

    def size(self) -> int:
        return int(hashtable.size(self.spec, self.state))


def freeze(var: Variable, state: hashtable.TableState,
           dtype=torch.bfloat16, out_dtype=torch.float32,
           default_value: float = 0.0) -> FrozenTable:
    """Strip optimizer slots, cast values to ``dtype`` (bf16/f16/f32)."""
    dtype = hashtable.torch_dtype(dtype)
    spec = dataclasses.replace(var.spec, value_dtype=dtype)
    w = state.dim
    pad_w = hashtable._packed_width(w, 0, dtype)
    values = torch.nn.functional.pad(state.values.to(dtype), (0, pad_w - w))
    lanes_rows = state.capacity * (
        pad_w // (hashtable._LANES * hashtable._pack_factor(dtype)))
    phys = hashtable._to_physical_rows(
        values, hashtable._container_dtype(dtype), lanes_rows,
        trash_row=True)
    frozen_state = hashtable.TableState(
        key_lo=state.key_lo,
        key_hi=state.key_hi,
        rows=phys,
        scores=state.scores,
        dim=w,
        key_dtype_name=state.key_dtype_name,
        value_dtype_name=hashtable.dtype_name(dtype),
    )
    return FrozenTable(spec=spec, state=frozen_state, out_dtype=out_dtype,
                       default_value=default_value)


def _tofile(t: torch.Tensor, path: str) -> None:
    """Raw bytes of ``t`` (any dtype, bf16 included), row-major."""
    t.contiguous().reshape(-1).view(torch.uint8).numpy().tofile(path)


def export_compressed(var: Variable, state: hashtable.TableState,
                      directory: str, dtype=torch.float16) -> str:
    """Write live (key, compressed-value) pairs, in slot order, with a
    serving meta file. Returns the file prefix."""
    os.makedirs(directory, exist_ok=True)
    dtype = hashtable.torch_dtype(dtype)
    k, v, m = hashtable.export(var.spec, state)
    live_k, live_v = k[m].cpu(), v[m].to(dtype).cpu()
    prefix = os.path.join(directory, f"{var.name}_serving")
    _tofile(live_k, prefix + "-keys")
    _tofile(live_v, prefix + "-values")
    with open(prefix + "-meta.json", "w") as f:
        json.dump({
            "name": var.name,
            "dim": var.dim,
            "count": int(live_k.shape[0]),
            "key_dtype": hashtable.dtype_name(var.key_dtype),
            "value_dtype": hashtable.dtype_name(dtype),
        }, f)
    return prefix


def _fromfile(path: str, dtype: torch.dtype) -> torch.Tensor:
    return torch.from_numpy(np.fromfile(path, dtype=np.uint8)).view(dtype)


def load_compressed(prefix: str, capacity: Optional[int] = None,
                    out_dtype=torch.float32, device=None) -> FrozenTable:
    """Build a FrozenTable on ``device`` (default CUDA) from an
    export_compressed prefix; capacity defaults to twice the key count."""
    dev = resolve_device(device)
    with open(prefix + "-meta.json") as f:
        meta = json.load(f)
    key_dtype = hashtable.torch_dtype(meta["key_dtype"])
    value_dtype = hashtable.torch_dtype(meta["value_dtype"])
    keys = _fromfile(prefix + "-keys", key_dtype)
    vals = _fromfile(prefix + "-values", value_dtype).reshape(-1, meta["dim"])
    cap = capacity or max(2 * len(keys), 8)
    var = Variable(name=meta["name"], dim=meta["dim"], init_capacity=cap,
                   key_dtype=key_dtype, value_dtype=value_dtype, device=dev)
    state = var.init()
    # bulk insert in chunks (values kept in the compressed dtype)
    chunk = 1 << 20
    for off in range(0, len(keys), chunk):
        state = var.upsert(state, keys[off:off + chunk].to(dev),
                           vals[off:off + chunk].to(dev))
    return FrozenTable(spec=var.spec, state=state, out_dtype=out_dtype)
