"""`DEHvdSaver` — the reference's TF1-Saver-style checkpointing
(python/train/saver.py:33-128), as a thin front over
:class:`~recommenders_addons_tpu_torch.train.checkpoint.DECheckpoint`:
every process writes rank-tagged shard files to the shared directory and
reads them back on its own, so no rank-0 choreography is needed."""

from __future__ import annotations

from typing import Any, Dict, Optional

from recommenders_addons_tpu_torch.train.checkpoint import DECheckpoint


class DEHvdSaver:
    def __init__(self, rank: int = 0, size: int = 1, **objects):
        self.rank = rank
        self.size = size
        self._ckpt = DECheckpoint(**objects)

    def save(self, directory: str, state: Dict[str, Any],
             global_step: Optional[int] = None, keep: Optional[int] = None):
        return self._ckpt.save(directory, state, step=global_step,
                               proc_size=self.size, proc_rank=self.rank,
                               keep=keep)

    def restore(self, directory: str, state: Dict[str, Any],
                global_step="latest"):
        return self._ckpt.restore(directory, state, step=global_step)
