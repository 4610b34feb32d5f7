"""Training-loop callbacks (reference python/keras/callbacks.py:38-196):

* ``DEHvdBroadcastGlobalVariablesCallback`` — with no mesh (one process)
  there is nothing to broadcast, as in the JAX package; a mesh waits for
  the port of sharding and raises;
* ``DEHvdModelCheckpoint`` — a periodic :class:`DECheckpoint` save.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from recommenders_addons_tpu_torch.train.checkpoint import DECheckpoint


class DEHvdBroadcastGlobalVariablesCallback:
    """Reference keras/callbacks.py:38-106. Call once after building the
    state: ``__call__(state, mesh=None)`` returns the state. Tables are
    worker-local and never broadcast; ``local_variables`` (key-path
    substrings) name dense entries the broadcast must leave alone."""

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
        if mesh is not None:
            raise NotImplementedError(
                "broadcasting over a mesh waits for the port of parallel/")
        self.broadcast_done = True
        return state


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
