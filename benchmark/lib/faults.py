"""Faults planted in the system under test, for the tests and the
calibration that show ``correct`` coming out false: each is a function
``plant(trainer)`` given to ``runner.setup``. A fault that patches a
module sets ``trainer.restore``, which undoes it."""

from __future__ import annotations

import torch


def stale_step(trainer):
    """A step that returns its state unchanged (its loss still read)."""
    step = trainer.train_step

    def broken(state, opt_state, batch):
        saved = [p.detach().clone() for p in state.dense.parameters()]
        rows = state.table.rows.clone()
        _, _, loss = step(state, opt_state, batch)
        with torch.no_grad():
            for p, s in zip(state.dense.parameters(), saved):
                p.copy_(s)
        state.table.rows.copy_(rows)
        return state, opt_state, loss

    trainer.train_step = broken


def half_batch(trainer):
    """Half of each batch left out, the mean taken over the rest."""
    step = trainer.train_step

    def broken(state, opt_state, batch):
        half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
        return step(state, opt_state, half)

    trainer.train_step = broken


def altered_row(trainer):
    """The lookup's first row altered where it is produced."""
    var = trainer.model.var
    lookup = var.embedding_lookup

    def broken(state, ids, **kw):
        emb, ctx = lookup(state, ids, **kw)
        ctx.rows[0] += 0.5
        return emb, ctx

    object.__setattr__(var, "embedding_lookup", broken)


def evict_highest(trainer):
    """The eviction turned round: a full bucket's new key displaces its
    highest-scored key instead of its lowest."""
    from recommenders_addons_tpu_torch.ops import hashtable

    kth = hashtable._kth_lowest_slot

    def broken(sc, k):
        big = torch.iinfo(sc.dtype).max
        return kth(torch.where(sc == big, big, -sc - 1), k)

    hashtable._kth_lowest_slot = broken
    trainer.restore = lambda: setattr(hashtable, "_kth_lowest_slot", kth)


FAULTS = {"stale_step": stale_step, "half_batch": half_batch,
          "altered_row": altered_row, "evict_highest": evict_highest}
