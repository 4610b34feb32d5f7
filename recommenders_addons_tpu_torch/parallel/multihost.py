"""Multi-process helpers — the port of the JAX package's
``parallel/multihost.py`` on ``torch.distributed``.

The reference's multi-process story is Horovod: broadcast the initial
state, allreduce dense grads, save per rank. Here one process group
carries the table's exchange (``parallel.GroupMesh``: one shard a rank,
``all_to_all_single`` over NCCL on cards or gloo on CPU tensors) and
every rank writes its own rank-tagged checkpoint shards. Without an
initialised group the helpers degrade to one process, as the JAX
package's do on one host.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from recommenders_addons_tpu_torch.parallel.mesh import (
    DEFAULT_AXIS,
    GroupMesh,
    Mesh,
    create_mesh,
)


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` with environment fallbacks
    (``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE``, as the
    JAX version falls back to ``JAX_COORDINATOR_*``). ``backend`` defaults
    to NCCL (it needs the cards; pass ``"gloo"`` for CPU processes, with
    ``device="cpu"`` to ``global_mesh``). A no-op when a group exists, or when
    nothing names one (one process). Returns whether a group is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None:
        return False
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if backend is None:
        backend = "nccl"
    kw = {}
    if world_size is not None:
        kw["world_size"] = world_size
    if rank is not None:
        kw["rank"] = rank
    dist.init_process_group(backend, init_method=init_method, **kw)
    return True


def global_mesh(axis: str = DEFAULT_AXIS, device=None, devices=None):
    """The table-sharding and data-parallel axis over every process: a
    ``GroupMesh`` (one shard a rank, on ``device``) when a process group
    is up, else an in-process ``Mesh`` over ``devices`` (default: the
    visible cards; ``device`` is then unused)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return GroupMesh(device=device, axis_name=axis)
    return create_mesh(axis_name=axis, devices=devices)


def process_rank_size():
    """``(rank, world size)`` of this process; ``(0, 1)`` without a
    group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_batch(mesh, batch, axis: str = DEFAULT_AXIS):
    """Place this process's slice of the batch (a dict of arrays) for a
    sharded step: on a ``GroupMesh`` each rank passes its own slice, moved
    to its device (slices may differ in length: each sharded call agrees
    on the longest, one ``all_reduce``); on a ``Mesh`` the whole batch
    goes to the first shard's device (the sharded calls split it into
    blocks)."""
    del axis
    if isinstance(mesh, Mesh):
        dev = mesh.devices.reshape(-1)[0]
    else:
        dev = mesh.device
    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def save_checkpoint(ckpt, directory: str, state, step=None, keep=None):
    """Every process writes its shards, rank 0 the dense entries
    (``train.DECheckpoint`` is rank-aware; this adds the rank and size of
    the live group)."""
    rank, size = process_rank_size()
    return ckpt.save(directory, state, step=step, proc_size=size,
                     proc_rank=rank, keep=keep)
