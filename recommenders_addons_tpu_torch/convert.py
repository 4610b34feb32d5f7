"""Carry state between the JAX package and the port.

Both packages keep the same table layout (key planes, the physical rows
container with its trash row, scores), so carrying a table across, its
optimizer slot columns included (``slot_names``/``slot_inits`` in the
metadata), is a copy of four arrays plus the state's metadata. DLRM's
dense towers carry across as the JAX package's parameter tree of
``{"w": [in, out], "b": [out]}`` layers. The arrays are numpy, as
``jax.device_get`` gives them; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch.ops.hashtable import TableState
from recommenders_addons_tpu_torch.models.dlrm import DenseTowers, DLRMConfig
from recommenders_addons_tpu_torch.utils.config import resolve_device

ARRAY_FIELDS = ("key_lo", "key_hi", "rows", "scores")
META_FIELDS = ("dim", "slot_names", "slot_inits", "key_dtype_name",
               "value_dtype_name")


def table_state_from_numpy(arrays: Dict[str, np.ndarray], meta: Dict,
                           device=None) -> TableState:
    """A port ``TableState`` on ``device`` (default CUDA) from the numpy
    arrays ``key_lo``, ``key_hi``, ``rows`` and ``scores`` and the metadata
    fields ``dim``, ``slot_names``, ``slot_inits``, ``key_dtype_name`` and
    ``value_dtype_name`` of a JAX ``TableState``."""
    dev = resolve_device(device)
    tensors = {f: torch.from_numpy(np.array(arrays[f], copy=True)).to(dev)
               for f in ARRAY_FIELDS}
    return TableState(
        **tensors,
        dim=int(meta["dim"]),
        slot_names=tuple(meta["slot_names"]),
        slot_inits=tuple((str(n), float(v)) for n, v in meta["slot_inits"]),
        key_dtype_name=str(meta["key_dtype_name"]),
        value_dtype_name=str(meta["value_dtype_name"]),
    )


def table_state_to_numpy(state: TableState) -> Tuple[Dict, Dict]:
    """The reverse of :func:`table_state_from_numpy`: ``(arrays, meta)``."""
    arrays = {f: getattr(state, f).cpu().numpy() for f in ARRAY_FIELDS}
    meta = {f: getattr(state, f) for f in META_FIELDS}
    return arrays, meta


def dlrm_dense_from_numpy(arrays: Dict, cfg: DLRMConfig,
                          device=None) -> DenseTowers:
    """DLRM ``DenseTowers`` on ``device`` (default CUDA) holding the
    weights of a JAX ``DLRMState.dense`` tree ``{"bottom": [layers],
    "top": [layers]}``, each layer ``{"w": [in, out], "b": [out]}``."""
    dev = resolve_device(device)
    towers = DenseTowers(cfg, dev)
    with torch.no_grad():
        for name in ("bottom", "top"):
            mlp = getattr(towers, name)
            layers = arrays[name]
            if len(layers) != len(mlp.w):
                raise ValueError(f"{name}: {len(layers)} layers for "
                                 f"{len(mlp.w)}")
            for layer, w, b in zip(layers, mlp.w, mlp.b):
                w.copy_(torch.from_numpy(np.array(layer["w"], copy=True)))
                b.copy_(torch.from_numpy(np.array(layer["b"], copy=True)))
    return towers


def dlrm_dense_to_numpy(towers: DenseTowers) -> Dict:
    """The reverse of :func:`dlrm_dense_from_numpy`."""
    return {name: [{"w": w.detach().cpu().numpy(),
                    "b": b.detach().cpu().numpy()}
                   for w, b in zip(getattr(towers, name).w,
                                   getattr(towers, name).b)]
            for name in ("bottom", "top")}
