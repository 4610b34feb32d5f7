"""Device meshes and the exchanges a sharded table routes through — the
port of the JAX package's ``parallel/mesh.py``, with the two exchanges
that take the place of ``shard_map``'s ``all_to_all`` and ``psum``.

A mesh names the shards of a table. Two kinds:

* :class:`Mesh` — named axes over an array of ``torch.device``s, all held
  by this process (the global view of ``shard_map``). Repeats are allowed
  (``[cuda:0] * 4``): that is how one card holds S logical shards, as the
  JAX package's tests split the CPU into 8 devices. Its exchange is
  :class:`LocalExchange`;
* :class:`GroupMesh` — one shard per rank of an initialised
  ``torch.distributed`` process group (NCCL on cards, gloo on CPU
  tensors). Its exchange is :class:`GroupExchange`.

An exchange works on lists of per-shard tensors, one entry for each
shard this process holds (all S of a ``Mesh``, one of a ``GroupMesh``):
``all_to_all`` takes each source's ``[S*K, ...]`` buffer, K rows bound
for each destination in destination order, and gives each destination
its ``[S*K, ...]`` buffer, K rows from each source in source order;
``psum`` sums one scalar a shard and reads the total back (a host sync).
Each ``all_to_all`` runs inside a ``torch.profiler.record_function``
range named :data:`EXCHANGE_RANGE`, so a profiler trace splits the
exchange's share of a step out (the range costs a few microseconds of
host time when no profiler is on).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from recommenders_addons_tpu_torch.utils.config import resolve_device

DEFAULT_AXIS = "ep"  # embedding-parallel == data-parallel axis
EXCHANGE_RANGE = "ShardedVariable.all_to_all"


def _device_array(devices) -> np.ndarray:
    """An object array of resolved ``torch.device``s, any nesting."""
    given = np.asarray(devices, dtype=object)
    arr = np.empty(given.shape, dtype=object)
    for idx in np.ndindex(given.shape):
        arr[idx] = resolve_device(given[idx])
    return arr


class Mesh:
    """Named axes over an array of devices held by this process
    (``torch.device``s or their names; each is resolved, so a CUDA entry
    raises without a card)."""

    group = None

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = _device_array(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(
                f"{self.devices.ndim}-D devices for axes {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def _check_axes(self, axes: Tuple[str, ...]):
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in mesh {self.axis_names}")
        rest = [a for a in self.axis_names if a not in axes]
        if any(self.shape[a] > 1 for a in rest):
            raise ValueError(
                f"a table shards over every axis of the mesh of more than "
                f"one device; {rest} would replicate it")

    def shard_devices(self, axes: Tuple[str, ...]) -> List[
            Tuple[int, torch.device]]:
        """``(shard index, device)`` of every shard over ``axes``: the
        flattened product axis in row-major order of ``axes``, as
        ``PartitionSpec(axes)`` lays shards out."""
        self._check_axes(axes)
        order = [self.axis_names.index(a) for a in axes]
        order += [i for i in range(len(self.axis_names)) if i not in order]
        flat = np.transpose(self.devices, order).reshape(-1)
        return list(enumerate(flat))

    def exchange(self, axes: Tuple[str, ...]) -> "LocalExchange":
        return LocalExchange([d for _, d in self.shard_devices(axes)])

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"


class GroupMesh:
    """One shard per rank of a ``torch.distributed`` process group (the
    default group unless one is given), held on ``device`` (default: the
    card ``cuda:<rank % cards>``, raising without one; a gloo group's
    shards need ``device="cpu"``). Raises when the group is not
    initialised: a sharded table never quietly runs in one process."""

    def __init__(self, group=None, device=None,
                 axis_name: str = DEFAULT_AXIS):
        import torch.distributed as dist

        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                "GroupMesh needs an initialised torch.distributed process "
                "group (parallel.multihost.initialize)")
        self.group = group if group is not None else dist.group.WORLD
        self.rank = dist.get_rank(self.group)
        self.world_size = dist.get_world_size(self.group)
        if device is None:
            resolve_device(None)  # raises without a card
            device = torch.device("cuda",
                                  self.rank % torch.cuda.device_count())
        self.device = resolve_device(device)
        self.axis_names = (axis_name,)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.world_size}

    def shard_devices(self, axes: Tuple[str, ...]):
        if tuple(axes) != self.axis_names:
            raise ValueError(f"axes {axes} on a group mesh of "
                             f"{self.axis_names}")
        return [(self.rank, self.device)]

    def exchange(self, axes: Tuple[str, ...]) -> "GroupExchange":
        self.shard_devices(axes)
        return GroupExchange(self.group, self.world_size)

    def __repr__(self):
        return (f"GroupMesh(rank {self.rank} of {self.world_size}, "
                f"{self.device})")


class LocalExchange:
    """``all_to_all`` and ``psum`` among the shards of one process: each
    destination concatenates its block of every source's buffer on its
    own device (one copy; ``.to`` is a no-op when the shards share a
    card)."""

    def __init__(self, devices: List[torch.device]):
        self.devices = devices
        self.num_shards = len(devices)

    def all_to_all(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        k = bufs[0].shape[0] // self.num_shards
        with torch.profiler.record_function(EXCHANGE_RANGE):
            return [torch.cat([b[d * k:(d + 1) * k].to(dev) for b in bufs])
                    for d, dev in enumerate(self.devices)]

    def agree_len(self, n: int, device) -> int:
        """The block length every shard routes with: in process the
        blocks are equal, so ``n``."""
        return n

    def psum(self, vals: List[torch.Tensor]) -> int:
        """The sum of one scalar a shard (one host sync)."""
        dev = self.devices[0]
        return int(torch.stack([v.to(dev, torch.int64).reshape(())
                                for v in vals]).sum())

    def gather_host(self, vals: List[torch.Tensor]) -> List[int]:
        """Every shard's scalar read back in one host sync."""
        dev = self.devices[0]
        return torch.stack([v.to(dev, torch.int64).reshape(())
                            for v in vals]).tolist()

    def sum_tensor(self, t: torch.Tensor) -> torch.Tensor:
        return t


class GroupExchange:
    """``all_to_all`` and ``psum`` over a process group, one shard a rank
    (``dist.all_to_all_single`` and ``dist.all_reduce``). Boolean buffers
    travel as uint8."""

    def __init__(self, group, world_size: int):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("the process group is not initialised")
        self.group = group
        self.num_shards = world_size

    def all_to_all(self, bufs: List[torch.Tensor]) -> List[torch.Tensor]:
        import torch.distributed as dist

        (buf,) = bufs
        is_bool = buf.dtype == torch.bool
        with torch.profiler.record_function(EXCHANGE_RANGE):
            src = (buf.to(torch.uint8) if is_bool else buf).contiguous()
            out = torch.empty_like(src)
            dist.all_to_all_single(out, src, group=self.group)
        return [out.bool() if is_bool else out]

    def psum(self, vals: List[torch.Tensor]) -> int:
        t = self.sum_tensor(vals[0].to(torch.int64).reshape(1).clone())
        return int(t[0])

    def gather_host(self, vals: List[torch.Tensor]) -> List[int]:
        return [int(vals[0])]

    def agree_len(self, n: int, device) -> int:
        """The longest rank's block length (one ``all_reduce``, a host
        sync): ranks may pass slices of different lengths, and every rank
        must size its buffers and take its branches alike."""
        import torch.distributed as dist

        t = torch.tensor([n], dtype=torch.int64, device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return int(t[0])

    def sum_tensor(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        t = t.clone()
        dist.all_reduce(t, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        import torch.distributed as dist

        t = t.contiguous().clone()
        dist.broadcast(t, src=src, group=self.group)
        return t


def create_mesh(num_devices: Optional[int] = None,
                axis_name: str = DEFAULT_AXIS,
                devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over ``devices`` (default: the visible cards), or their
    first ``num_devices``. Repeat a device to hold several logical shards
    on it (``devices=["cuda:0"] * 4``, or ``["cpu"] * 4``). Without a card
    the default raises."""
    if devices is None:
        resolve_device(None)  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if num_devices is not None:
        devices = list(devices)[:num_devices]
    return Mesh(list(devices), (axis_name,))
