"""Warm-starting tables from an earlier run's checkpoint, the port of the
JAX package's ``ops/warm_start.py`` (reference
python/ops/warm_start_util.py:69-198): a variable reads another
variable's KV sidecar files (under another name and any shard layout)
through the elastic restore."""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Union

from recommenders_addons_tpu_torch.ops import hashtable
from recommenders_addons_tpu_torch.train import checkpoint as ckpt_lib


def warm_start(
    vars_and_states: Dict[object, hashtable.TableState],
    ckpt_to_initialize_from: str,
    vars_to_warm_start: Union[str, Sequence[str]] = ".*",
    var_name_to_prev_var_name: Optional[Dict[str, str]] = None,
    global_step: Optional[int] = "latest",
) -> Dict[object, hashtable.TableState]:
    """Load the rows of the matching variables from a checkpoint
    directory. ``vars_to_warm_start`` is a regex (or a list of regexes or
    names) matched against variable names; ``var_name_to_prev_var_name``
    maps a variable's name to the one it had in the checkpoint. Returns
    ``{var: new_state}`` for every entry (warm-started or passed
    through)."""
    name_map = var_name_to_prev_var_name or {}
    patterns = ([vars_to_warm_start] if isinstance(vars_to_warm_start, str)
                else list(vars_to_warm_start))
    if global_step == "latest":
        global_step = ckpt_lib.latest_checkpoint(ckpt_to_initialize_from)
    out = {}
    for var, state in vars_and_states.items():
        if not any(re.match(p + r"$", var.name) or p == var.name
                   for p in patterns):
            out[var] = state
            continue
        prev = name_map.get(var.name, var.name)
        loader = var if prev == var.name else dataclasses.replace(
            var, name=prev)  # read the old name's files
        out[var] = ckpt_lib.load_dynamic_embedding(
            loader, state, ckpt_to_initialize_from, global_step=global_step)
    return out


class WarmStartHook:
    """The reference's SessionRunHook (warm_start_util.py:151-198): call
    once before training."""

    def __init__(self, ckpt_dir: str, vars_to_warm_start=".*", **kwargs):
        self.ckpt_dir = ckpt_dir
        self.vars_to_warm_start = vars_to_warm_start
        self.kwargs = kwargs

    def __call__(self, vars_and_states):
        return warm_start(vars_and_states, self.ckpt_dir,
                          self.vars_to_warm_start, **self.kwargs)
