"""Carry state between the JAX package and the port.

Both packages keep the same table layout (key planes, the physical rows
container with its trash row, scores), so carrying a table across, its
optimizer slot columns included (``slot_names``/``slot_inits`` in the
metadata), is a copy of four arrays plus the state's metadata. Dense
weights carry across from the JAX package's parameter trees: an MLP is a
list of ``{"w": [in, out], "b": [out]}`` layers (``nn/mlp.py``), DLRM's
towers ``{"bottom", "top"}``, DCN's ``{"cross", "deep", "head"}`` and a
layer normalization ``{"gamma", "beta"}``. A sharded table's arrays
carry a leading shard axis (``sharded_state_from_numpy``). The arrays
are numpy, as
``jax.device_get`` gives them; nothing here imports JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch.models.dcn import DCNConfig, DCNDense
from recommenders_addons_tpu_torch.models.dlrm import DenseTowers, DLRMConfig
from recommenders_addons_tpu_torch.nn.layers import LayerNormalization
from recommenders_addons_tpu_torch.nn.mlp import MLP
from recommenders_addons_tpu_torch.ops.hashtable import TableState
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
    tensors = {f: _tensor(arrays[f], dev) for f in ARRAY_FIELDS}
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


def sharded_state_from_numpy(arrays: Dict[str, np.ndarray], meta: Dict,
                             devices: Sequence,
                             shard_ids: Optional[Sequence[int]] = None):
    """A port ``ShardedState`` from a JAX sharded ``TableState``: its four
    arrays with a leading shard axis ``[S, ...]`` as numpy (what
    ``jax.device_get`` gives) and its metadata. Shard ``shard_ids[j]``
    (default: all S) goes to ``devices[j]``."""
    from recommenders_addons_tpu_torch.parallel.sharded import ShardedState

    s = int(np.shape(arrays["key_lo"])[0])
    ids = list(range(s)) if shard_ids is None else list(shard_ids)
    shards = [table_state_from_numpy(
        {f: np.asarray(arrays[f])[i] for f in ARRAY_FIELDS}, meta,
        device=dev) for i, dev in zip(ids, devices)]
    return ShardedState(shards=shards, shard_ids=tuple(ids), num_shards=s)


def sharded_state_to_numpy(state) -> Tuple[Dict, Dict]:
    """The reverse of :func:`sharded_state_from_numpy`: ``(arrays [S,
    ...], meta)`` of the shards the state holds."""
    per = [table_state_to_numpy(st) for st in state.shards]
    arrays = {f: np.stack([a[f] for a, _ in per]) for f in ARRAY_FIELDS}
    return arrays, per[0][1]


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _load_layers_(w_list, b_list, layers: Sequence[Dict], what: str):
    if len(layers) != len(w_list):
        raise ValueError(f"{what}: {len(layers)} layers for {len(w_list)}")
    with torch.no_grad():
        for layer, w, b in zip(layers, w_list, b_list):
            w.copy_(torch.from_numpy(np.asarray(layer["w"])))
            b.copy_(torch.from_numpy(np.asarray(layer["b"])))


def _layers_to_numpy(w_list, b_list) -> List[Dict]:
    return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
            for w, b in zip(w_list, b_list)]


def mlp_from_numpy(layers: Sequence[Dict], device=None) -> MLP:
    """An ``MLP`` on ``device`` (default CUDA) holding a JAX MLP, a list of
    ``{"w": [in, out], "b": [out]}`` layers (an empty list: the identity
    tower)."""
    sizes = []
    if layers:
        sizes = ([np.shape(layers[0]["w"])[0]]
                 + [np.shape(layer["w"])[1] for layer in layers])
    mlp = MLP(sizes, device=resolve_device(device))
    _load_layers_(mlp.w, mlp.b, layers, "mlp")
    return mlp


def mlp_to_numpy(mlp: MLP) -> List[Dict]:
    """The reverse of :func:`mlp_from_numpy`."""
    return _layers_to_numpy(mlp.w, mlp.b)


def dlrm_dense_from_numpy(arrays: Dict, cfg: DLRMConfig,
                          device=None) -> DenseTowers:
    """DLRM ``DenseTowers`` on ``device`` (default CUDA) holding the
    weights of a JAX ``DLRMState.dense`` tree ``{"bottom": [layers],
    "top": [layers]}``, each layer ``{"w": [in, out], "b": [out]}``."""
    towers = DenseTowers(cfg, resolve_device(device))
    for name in ("bottom", "top"):
        mlp = getattr(towers, name)
        _load_layers_(mlp.w, mlp.b, arrays[name], name)
    return towers


def dlrm_dense_to_numpy(towers: DenseTowers) -> Dict:
    """The reverse of :func:`dlrm_dense_from_numpy`."""
    return {name: mlp_to_numpy(getattr(towers, name))
            for name in ("bottom", "top")}


def dcn_dense_from_numpy(arrays: Dict, cfg: DCNConfig,
                         device=None) -> DCNDense:
    """DCN's ``DCNDense`` on ``device`` (default CUDA) holding the weights
    of a JAX ``DCNState.dense`` tree ``{"cross": [layers], "deep":
    [layers], "head": [layers]}``, cross layers ``{"w": [I, I], "b":
    [I]}``."""
    dense = DCNDense(cfg, resolve_device(device))
    _load_layers_(dense.cross_w, dense.cross_b, arrays["cross"], "cross")
    for name in ("deep", "head"):
        mlp = getattr(dense, name)
        _load_layers_(mlp.w, mlp.b, arrays[name], name)
    return dense


def dcn_dense_to_numpy(dense: DCNDense) -> Dict:
    """The reverse of :func:`dcn_dense_from_numpy`."""
    return {"cross": _layers_to_numpy(dense.cross_w, dense.cross_b),
            "deep": mlp_to_numpy(dense.deep),
            "head": mlp_to_numpy(dense.head)}


def layer_norm_from_numpy(params: Dict, axis: int = -1,
                          epsilon: float = 1e-3,
                          device=None) -> LayerNormalization:
    """A ``LayerNormalization`` on ``device`` (default CUDA) holding a JAX
    layer normalization's ``{"gamma": [D], "beta": [D]}``."""
    dev = resolve_device(device)
    ln = LayerNormalization(axis, epsilon)
    ln.gamma = torch.nn.Parameter(_tensor(params["gamma"], dev))
    ln.beta = torch.nn.Parameter(_tensor(params["beta"], dev))
    return ln


def layer_norm_to_numpy(ln: LayerNormalization) -> Dict:
    """The reverse of :func:`layer_norm_from_numpy`."""
    return {"gamma": ln.gamma.detach().cpu().numpy(),
            "beta": ln.beta.detach().cpu().numpy()}
