"""How a run decides ``correct``: what the program's first steps produced,
read from its state at set-up, against the reference's same steps
(``benchmark/reference/train.py``), once the window has closed.

The numbers compared (each with a limit in ``benchmark/limits/<cell>.json``):

* ``loss_gap``: the largest relative gap of a step's loss (steps 1-3);
* ``grad_gap``: the worst leaf's gap between the program's and the
  reference's norm of the first gradient as the optimizer got it, worked
  out from the state after step 1 (a dense leaf from its optax
  accumulator, ``g*g = acc - initial``; the table's written rows from
  their change, ``g = (before - after) * (sqrt(acc) + eps) / lr``);
* ``change_gap``: the worst leaf's gap between the norms of the change
  after three steps (the table's leaf: the rows of the touched keys that
  the reference keeps), leaving out leaves whose reference gradient is
  under a thousandth of the median leaf's;
* ``keys_wrong``: keys of the touched buckets whose residency or score
  after step 3 differs from the reference's (exact: limit 0).

A leaf's gap is taken against the larger of its own reference norm and the
median leaf's.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
from pathlib import Path
from typing import Dict, List, Optional

import torch

NAMES = ("loss_gap", "grad_gap", "change_gap", "keys_wrong")


@dataclasses.dataclass
class Readings:
    """The program's outputs, in the reference's terms."""

    losses: List[float]
    dense_acc1: Dict[str, torch.Tensor]
    dense3: Dict[str, torch.Tensor]
    keys1: torch.Tensor
    found1: torch.Tensor
    values1: torch.Tensor
    acc1: torch.Tensor
    keys3: torch.Tensor
    found3: torch.Tensor
    values3: torch.Tensor
    # ``(spec, state)``: the key planes and scores after step 3, as a
    # table state that only finds keys (its rows are not kept)
    planes3: tuple


def _at(keys: torch.Tensor, table_keys: torch.Tensor, *cols):
    """Rows of ``cols`` (indexed like the sorted ``table_keys``) at
    ``keys``; ``keys`` must all be in ``table_keys``."""
    pos = torch.searchsorted(table_keys, keys)
    return tuple(c[pos] for c in cols)


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_norms(cfg, ref, dense_acc1, dense3, written1, values1, acc1,
               resident3, values3, weights):
    """``(grad norms, change norms)`` by leaf, the table's rows being
    those the reference wrote at step 1 / keeps after step 3 (``ref``
    gives the rows before)."""
    dacc0 = float(cfg["dense_optimizer"]["initial_accumulator_value"])
    topt = cfg["table_optimizer"]
    grads, changes = {}, {}
    for name, acc in dense_acc1.items():
        g2 = (acc - torch.full_like(acc, dacc0)).clamp_min(0.0)
        grads[name] = float(torch.sqrt(g2.double().sum()))
    for name, p3 in dense3.items():
        changes[name] = _norm(p3 - weights[name])
    m = written1
    g = (ref.base1[m] - values1[m]) * (torch.sqrt(acc1[m])
                                       + float(topt["epsilon"]))
    grads["table"] = _norm(g / float(topt["learning_rate"]))
    r = resident3
    changes["table"] = _norm(values3[r] - ref.base3[r])
    return grads, changes


def _worst_gap(prog: Dict[str, float], ref: Dict[str, float],
               leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves
               if max(ref[k], med) > 0)


def compare(cfg, ref, weights, prog: Optional[Readings] = None,
            other=None) -> Dict[str, float]:
    """The numbers of :data:`NAMES` for the program's readings ``prog``
    (or, for the control and planted faults, another reference run
    ``other`` in the program's place) against the reference ``ref``."""
    rg, rc = leaf_norms(cfg, ref, ref.dense_acc1, ref.dense3, ref.written1,
                        ref.values1, ref.acc1, ref.resident3, ref.values3,
                        weights)
    if other is not None:
        losses = other.losses
        v1, a1 = _at(ref.keys1, other.keys1, other.values1, other.acc1)
        (v3,) = _at(ref.keys3, other.keys3, other.values3)
        pg, pc = leaf_norms(cfg, ref, other.dense_acc1, other.dense3,
                            ref.written1, v1, a1, ref.resident3, v3,
                            weights)
        res, sc = _at(ref.candidates, other.candidates, other.cand_resident,
                      other.cand_scores)
    else:
        losses = prog.losses
        v1, a1, f1 = _at(ref.keys1, prog.keys1, prog.values1, prog.acc1,
                           prog.found1)
        # a key the program does not hold reads as unmoved
        v1 = torch.where(f1[:, None], v1, ref.base1)
        v3, f3 = _at(ref.keys3, prog.keys3, prog.values3, prog.found3)
        v3 = torch.where(f3[:, None], v3, ref.base3)
        pg, pc = leaf_norms(cfg, ref, prog.dense_acc1, prog.dense3,
                            ref.written1, v1, a1, ref.resident3, v3,
                            weights)
        res, sc = resident_in(prog.planes3, ref.candidates)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref.losses))
    leaves = sorted(rg)
    med_g = statistics.median(rg[k] for k in leaves)
    moved = [k for k in leaves if rg[k] >= 1e-3 * med_g]
    wrong = (res != ref.cand_resident) | (res & (sc != ref.cand_scores))
    return {"loss_gap": loss_gap,
            "grad_gap": _worst_gap(pg, rg, leaves),
            "change_gap": _worst_gap(pc, rc, moved),
            "keys_wrong": float(wrong.sum())}


def resident_in(planes, keys: torch.Tensor, block: int = 1 << 21):
    """``(found [N], score [N])`` of ``keys`` in the program's key planes
    after step 3, probed with the program's own ``find``."""
    from recommenders_addons_tpu_torch.ops import hashtable

    spec, state = planes
    found, score = [], []
    for lo in range(0, keys.shape[0], block):
        k = keys[lo:lo + block]
        slot, f = hashtable.find(spec, state, k)
        found.append(f)
        score.append(torch.where(f, state.scores[slot.long()].to(
            torch.int64), 0))
    if not found:
        z = torch.zeros_like(keys)
        return z.bool(), z
    return torch.cat(found), torch.cat(score)


# ------------------------------------------------------------- limits


def limits_for(cell: str, root: Path) -> Dict[str, float]:
    path = root / "benchmark" / "limits" / f"{cell}.json"
    data = json.loads(path.read_text())
    return {k: float(data[k]["limit"]) for k in NAMES}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """``(correct, {name: {"value", "limit"}})``: correct when every
    number is within its limit (a number that is not finite fails)."""
    out, ok = {}, True
    for k in NAMES:
        v = float(numbers[k])
        good = v == v and v <= limits[k]
        ok = ok and good
        out[k] = {"value": v, "limit": limits[k]}
    return ok, out
