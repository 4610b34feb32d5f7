"""Restrict policies — size-capping feature eviction, the port of the JAX
package's ``ops/restrict.py`` (reference python/ops/restrict_policies.py).

The table keeps an eviction score per slot (``TableState.scores``), kept
up by every commit (LRU: the step, LFU: a count), so a policy is:

* ``apply_update(state, ids, step, epoch)``: refresh the scores of
  ``ids`` outside a training step (``find`` + ``scatter_rows``);
* ``apply_restriction(state, num_reserved, trigger)``: when the live
  count exceeds ``trigger``, remove the lowest-score live keys until
  ``num_reserved`` remain, chosen by an exact radix threshold
  (``hashtable.radix_select_threshold``) with ties broken by slot order.
  The JAX package's ``lax.cond`` on the live count is a host ``if`` here:
  one host sync a call. An evicted key's slot columns go with it (they
  are reset on the next insert into that slot).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from recommenders_addons_tpu_torch.ops import hashtable
from recommenders_addons_tpu_torch.ops.variable import EvictStrategy, Variable


class RestrictPolicy:
    """Base policy (reference restrict_policies.py:36-115)."""

    def __init__(self, var: Variable):
        self.var = var

    def apply_update(self, state: hashtable.TableState, ids, step=0,
                     epoch=0) -> hashtable.TableState:
        """Bump the scores of ``ids`` (of those in the table) as a commit
        would; rows are left alone."""
        var = self.var
        ids = var._flat_kv(ids, device=state.device)
        uniq, _ = hashtable.unique_static(ids)
        slot, found = hashtable.find(var.spec, state, uniq)
        scores, mode = var.scores_for(uniq, step=step, epoch=epoch)
        return hashtable.scatter_rows(var.spec, state, slot, found,
                                      scores=scores, score_mode=mode)

    def apply_restriction(self, state: hashtable.TableState,
                          num_reserved: int,
                          trigger: Optional[int] = None
                          ) -> hashtable.TableState:
        """Cap the table at ``num_reserved`` live keys when it holds more
        than ``trigger`` (default ``num_reserved``). One host sync (the
        live count)."""
        var = self.var
        trigger = trigger if trigger is not None else num_reserved
        if state.capacity - int(num_reserved) <= 0:
            return state
        live = int(hashtable.size(var.spec, state))  # host sync
        if live <= trigger:
            return state
        return _evict_to_target(var.spec, state, int(num_reserved))

    def create_status(self, state):
        """The reference builds a status table; the scores are the
        status here."""
        return state


def _evict_to_target(spec, state, num_reserved: int):
    """Remove the lowest-score live keys until ``num_reserved`` remain:
    one [C] victim mask (radix threshold plus tie rank), applied
    elementwise."""
    mask = hashtable.occupancy_mask(spec, state)
    live = mask.sum().to(torch.int32)
    n_victim = (live - num_reserved).clamp(min=0)
    victims = hashtable._victims(state.scores, mask, n_victim)
    e_lo, e_hi = hashtable._split_int(spec.empty_key)
    return state.replace(
        key_lo=torch.where(victims, e_lo, state.key_lo),
        key_hi=torch.where(victims, e_hi, state.key_hi),
        scores=torch.where(victims, 0, state.scores))


class TimestampRestrictPolicy(RestrictPolicy):
    """Evict the least recently seen keys (reference
    restrict_policies.py:118-233): scores must be time-ordered, so a
    Variable of another strategy is viewed as LRU."""

    def __init__(self, var: Variable):
        if var.evict_strategy not in (EvictStrategy.LRU,
                                      EvictStrategy.EPOCHLRU,
                                      EvictStrategy.CUSTOMIZED):
            var = dataclasses.replace(var, evict_strategy=EvictStrategy.LRU)
        super().__init__(var)


class FrequencyRestrictPolicy(RestrictPolicy):
    """Evict the least frequently seen keys (reference
    restrict_policies.py:236-358): scores are occurrence counts."""

    def __init__(self, var: Variable):
        if var.evict_strategy not in (EvictStrategy.LFU,
                                      EvictStrategy.EPOCHLFU):
            var = dataclasses.replace(var, evict_strategy=EvictStrategy.LFU)
        super().__init__(var)
