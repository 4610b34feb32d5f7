"""`de.keras.models.de_save_model` (reference python/keras/models.py:
36-189): a "model" is its table Variables and dense entries plus their
state; every rank writes its table shards into
``<dir>/variables/TFRADynamicEmbedding/`` and rank 0 the dense entries
into ``<dir>/dense.npz``."""

from __future__ import annotations

import os
from typing import Any, Dict

from recommenders_addons_tpu_torch.train.checkpoint import (
    DECheckpoint,
    load_dynamic_embedding,
    save_dynamic_embedding,
)


def de_save_model(directory: str, state: Dict[str, Any],
                  proc_size: int = 1, proc_rank: int = 0,
                  **objects) -> str:
    """Save a mixed state under the reference's layout: tables under
    ``<dir>/variables/`` (all ranks), dense entries in ``<dir>/dense.npz``
    (rank 0)."""
    vdir = os.path.join(directory, "variables")
    os.makedirs(vdir, exist_ok=True)
    ckpt = DECheckpoint(**objects)
    for name, obj in objects.items():
        if ckpt._is_table(obj):
            save_dynamic_embedding(obj, state[name], vdir,
                                   proc_size=proc_size, proc_rank=proc_rank)
    dense_objs = {n: o for n, o in objects.items() if not ckpt._is_table(o)}
    if dense_objs and proc_rank == 0:
        DECheckpoint(**dense_objs).save(
            directory, {n: state[n] for n in dense_objs},
            proc_size=proc_size, proc_rank=proc_rank)
    return directory


def de_load_model(directory: str, state: Dict[str, Any], **objects):
    """The state restored from :func:`de_save_model`'s layout."""
    vdir = os.path.join(directory, "variables")
    ckpt = DECheckpoint(**objects)
    out = dict(state)
    for name, obj in objects.items():
        if ckpt._is_table(obj):
            out[name] = load_dynamic_embedding(obj, state[name], vdir)
    dense_objs = {n: o for n, o in objects.items() if not ckpt._is_table(o)}
    if dense_objs:
        out.update(DECheckpoint(**dense_objs).restore(
            directory, {n: out[n] for n in dense_objs}, step=None))
    return out


de_hvd_save_model = de_save_model  # the reference's alias (models.py:186)
