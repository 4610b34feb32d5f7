"""Training-loop callbacks (reference python/keras/callbacks.py:38-196):

* ``DEHvdBroadcastGlobalVariablesCallback`` — over a process-group mesh
  (``parallel.GroupMesh``) every dense tensor is broadcast from
  ``root_rank``; with no mesh or an in-process one (one process holds the
  one copy of the dense state) there is nothing to broadcast;
* ``DEHvdModelCheckpoint`` — a periodic :class:`DECheckpoint` save.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from recommenders_addons_tpu_torch.ops.hashtable import TableState
from recommenders_addons_tpu_torch.parallel.sharded import ShardedState
from recommenders_addons_tpu_torch.train.checkpoint import DECheckpoint


class DEHvdBroadcastGlobalVariablesCallback:
    """Reference keras/callbacks.py:38-106. Call once after building the
    state: ``__call__(state, mesh=None)`` returns the state, its dense
    tensors (modules' parameters and buffers in place, tensors anew, in
    dicts, lists and tuples) broadcast from ``root_rank`` when ``mesh`` is
    a process-group mesh. Tables are worker-local and never broadcast;
    ``local_variables`` (key-path substrings such as ``"['stats']"``)
    name dense entries the broadcast must leave alone."""

    def __init__(self, root_rank: int = 0, device: str = "",
                 local_variables=None):
        self.root_rank = root_rank
        self.broadcast_done = False
        self._local_paths: set = set()
        if local_variables:
            if isinstance(local_variables, str):
                local_variables = [local_variables]
            for p in local_variables:
                self.register_local_var(p)

    def register_local_var(self, path_substr: str):
        """Exclude the leaves whose key path contains ``path_substr``."""
        if not isinstance(path_substr, str):
            raise ValueError(
                "register_local_var takes a key-path substring (e.g. "
                f"\"['worker_stats']\"); got {type(path_substr).__name__}")
        self._local_paths.add(path_substr)

    def __call__(self, state, mesh=None):
        if getattr(mesh, "group", None) is not None:
            state = self._broadcast(state, mesh.exchange(mesh.axis_names),
                                    "")
        self.broadcast_done = True
        return state

    def _local(self, path: str) -> bool:
        return any(p in path for p in self._local_paths)

    def _broadcast(self, obj, x, path: str):
        if isinstance(obj, (TableState, ShardedState)) or self._local(path):
            return obj
        if isinstance(obj, torch.nn.Module):
            with torch.no_grad():
                for name, t in obj.state_dict(keep_vars=True).items():
                    if not self._local(f"{path}.{name}"):
                        t.copy_(x.broadcast(t, self.root_rank))
            return obj
        if isinstance(obj, torch.Tensor):
            return x.broadcast(obj, self.root_rank)
        if isinstance(obj, dict):
            return type(obj)((k, self._broadcast(v, x, f"{path}[{k!r}]"))
                             for k, v in obj.items())
        if isinstance(obj, (list, tuple)):
            out = [self._broadcast(v, x, f"{path}[{i}]")
                   for i, v in enumerate(obj)]
            return out if isinstance(obj, list) else tuple(out)
        return obj


class DEHvdModelCheckpoint:
    """Reference keras/callbacks.py:109-196: every ``save_freq`` steps
    (or epochs), rank 0 writes the dense state and every rank its table
    shards::

        cb = DEHvdModelCheckpoint(directory, table=var)
        cb.on_step_end(step, {"table": state, ...})
    """

    def __init__(self, filepath: str, save_freq: int = 1000,
                 proc_size: int = 1, proc_rank: int = 0,
                 keep: Optional[int] = None, **objects):
        self.filepath = filepath
        self.save_freq = max(int(save_freq), 1)
        self.proc_size = proc_size
        self.proc_rank = proc_rank
        self.keep = keep
        self._ckpt = DECheckpoint(**objects)

    def on_step_end(self, step: int, state: Dict[str, Any]):
        if step % self.save_freq == 0 and step > 0:
            self._ckpt.save(self.filepath, state, step=step,
                            proc_size=self.proc_size,
                            proc_rank=self.proc_rank, keep=self.keep)

    on_epoch_end = on_step_end
