"""The reference's first training steps: plain PyTorch over the same
inputs the program gets (prefill, weights, batches), following the
configuration's documented semantics:

* the lookup: a resident key's stored row, else its initial row
  (:mod:`.threefry`), with the accumulator's initial fill;
* the write plan of the table model (:mod:`.table`): hits and the new keys
  the buckets can hold are written, the rest dropped; evictions by score;
  every touched key stamped with the step (``1, 2, 3``);
* the loss: mean binary cross-entropy of the family's logits
  (:mod:`.models`), whose ``[B, F, D]`` input is each feature's bag of
  looked-up rows summed (:func:`pool_bags`; without bags, the rows
  themselves);
* the row-wise Adagrad on each written key, its gradient summed over the
  key's occurrences (in float64, rounded once);
* Adagrad in optax's form on every dense leaf.

``precision="tf32"`` runs the products in TF32 (the control). ``fault``
plants a fault in this reference so that it can stand in for a broken
program: ``"half_batch"`` (the loss and its gradients over the first half
of each batch only) or ``"altered_row"`` (the first unique key's looked-up
row moved by +1 in every column, as if the lookup had returned a wrong
row).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from benchmark.lib import inputs
from benchmark.reference import dense as ref_dense
from benchmark.reference import hashing, threefry
from benchmark.reference.table import BucketTable, _rank_in_group


@dataclasses.dataclass
class Steps:
    """What the checked steps produced, and what the reference knows of
    their inputs (``keys1``/``keys3``, ``base1``/``base3``)."""

    losses: List[float]
    # dense leaves: optax accumulators after step 1, values after step 3
    dense_acc1: Dict[str, torch.Tensor]
    dense3: Dict[str, torch.Tensor]
    keys1: torch.Tensor  # sorted unique keys of step 1
    written1: torch.Tensor  # [U1] bool: written by step 1
    base1: torch.Tensor  # [U1, D] rows before step 1 (stored or initial)
    values1: torch.Tensor  # [U1, D] after step 1
    acc1: torch.Tensor  # [U1, D]
    keys3: torch.Tensor  # sorted unique keys of steps 1-3
    resident3: torch.Tensor  # [U3] bool after step 3
    base3: torch.Tensor  # [U3, D] rows before each key's first touch
    values3: torch.Tensor  # [U3, D] after step 3
    candidates: torch.Tensor  # sorted keys of the modelled buckets
    cand_resident: torch.Tensor  # [C] bool after step 3
    cand_scores: torch.Tensor  # [C] int64 (0 where not resident)


def segment_sum(g: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """``out[t] = sum(g[i] for seg[i] == t)`` in float64, rounded to
    float32 once; the same additions on every run."""
    order = torch.sort(seg, stable=True).indices
    srt = seg[order]
    bounds = torch.searchsorted(srt, torch.arange(n + 1, device=g.device))
    sums = torch.segment_reduce(g[order].double(), "sum", offsets=bounds,
                                axis=0)
    return sums.to(torch.float32)


def pool_bags(emb: torch.Tensor, features: torch.Tensor,
              nf: int) -> torch.Tensor:
    """``[B, N, D]`` rows, column ``j`` of feature ``features[j]`` ->
    ``[B, nf, D]``: each feature's columns summed in float64, rounded to
    float32 once (``emb`` itself where every bag holds one id). Summed in
    float32, a 100-id bag would carry up to 99 roundings, which a program
    that sums more exactly would be charged for."""
    if emb.shape[1] == nf:
        return emb
    out = torch.zeros((emb.shape[0], nf, emb.shape[2]), dtype=torch.float64,
                      device=emb.device)
    return out.index_add_(1, features, emb.double()).to(emb.dtype)


def forward_backward(cfg, w: Dict[str, torch.Tensor], batch: dict,
                     v: torch.Tensor, inv: torch.Tensor,
                     rows: Optional[int] = None):
    """One step's loss over the first ``rows`` examples (default all) and
    its gradients, from ``v [U, D]``, the rows of the batch's unique keys
    that each position ``inv`` points at: ``(loss, {leaf: gradient},
    g [U, D])``, ``g`` each key's gradient summed over its positions
    (:func:`segment_sum`)."""
    names = sorted(w)
    b, dim = batch["dense"].shape[0], cfg["dim"]
    rows = b if rows is None else rows
    leaves = {k: w[k].clone().requires_grad_(True) for k in names}
    emb = v[inv].reshape(b, -1, dim).detach().requires_grad_(True)
    pooled = pool_bags(emb, inputs.column_features(cfg, emb.device),
                       cfg["num_sparse"])
    logit = ref_dense.logits(cfg, leaves, batch["dense"][:rows],
                             pooled[:rows])
    loss = ref_dense.sigmoid_bce(logit, batch["label"][:rows])
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [emb])
    g = segment_sum(grads[-1].reshape(-1, dim), inv, v.shape[0])
    return loss.detach(), dict(zip(names, grads[:-1])), g


def prefill_resident(table: BucketTable, keys: torch.Tensor,
                     scores: torch.Tensor, positions: torch.Tensor,
                     chunk: int) -> None:
    """The modelled buckets after the prefill's chunked writes. Written in
    ascending score order, chunk after chunk, each bucket keeps its
    ``bucket_size`` highest scores: exact when no chunk brings a bucket
    more keys than it holds (checked here; otherwise the chunks are
    written one by one through the model)."""
    if keys.numel() and bool((scores[1:] <= scores[:-1]).any()):
        raise ValueError("prefill scores must rise along the write order")
    nb, bsz = table.num_buckets, table.bucket_size
    b = table.bucket(keys)
    per = torch.bincount((positions // chunk) * nb + b)
    if per.numel() == 0 or int(per.max()) <= bsz:
        rank = _rank_in_group(b, -scores)
        keep = rank < bsz
        order = torch.argsort(keys[keep])
        table.keys = keys[keep][order]
        table.scores = scores[keep][order]
        return
    empty = torch.empty(0, dtype=torch.int64, device=keys.device)
    chunk_of = positions // chunk
    for c in torch.unique(chunk_of).tolist():
        sel = chunk_of == c
        table.write(keys[sel], scores[sel], empty, drop_order="none")


def run(cfg, mix, seed: int, prefill, weights: Dict[str, torch.Tensor],
        batches: List[dict], precision: str = "f32",
        fault: Optional[str] = None) -> Steps:
    dev = prefill.keys.device
    shift, dim = cfg["feature_shift"], cfg["dim"]
    bsz = cfg["bucket_size"]
    nb = cfg["table_slots"] // bsz
    topt, dopt = cfg["table_optimizer"], cfg["dense_optimizer"]
    acc0 = float(topt["initial_accumulator_value"])
    cols = inputs.column_features(cfg, dev)
    step_keys = [inputs.tag(batch["sparse"], shift, cols).reshape(-1)
                 for batch in batches]
    keys3 = torch.unique(torch.cat(step_keys))
    modelled = torch.zeros(nb, dtype=torch.bool, device=dev)
    modelled[hashing.bucket_of(keys3, nb)] = True
    table = BucketTable(nb, bsz, modelled)

    sel = torch.nonzero(modelled[hashing.bucket_of(prefill.keys, nb)]
                        ).reshape(-1)
    pkeys, pscores = prefill.keys[sel], prefill.scores[sel]
    prefill_resident(table, pkeys, pscores, sel, prefill.chunk)

    # the stored rows of every key the steps touch, from the prefill
    u3 = keys3.shape[0]
    store_v = torch.zeros((u3, dim), device=dev)
    store_a = torch.zeros((u3, dim), device=dev)
    psort, porder = torch.sort(pkeys)
    at = torch.searchsorted(psort, keys3).clamp(max=max(psort.numel() - 1,
                                                        0))
    in_prefill = (psort[at] == keys3) if psort.numel() else (
        torch.zeros_like(keys3, dtype=torch.bool))
    idx = torch.nonzero(in_prefill).reshape(-1)
    if idx.numel():
        v, a = prefill.rows_at(seed, sel[porder[at[idx]]], dim)
        store_v[idx], store_a[idx] = v, a
    base3 = torch.zeros((u3, dim), device=dev)
    touched3 = torch.zeros(u3, dtype=torch.bool, device=dev)

    w = {k: t.detach().clone() for k, t in weights.items()}
    dacc = {k: torch.full_like(t, float(dopt["initial_accumulator_value"]))
            for k, t in w.items()}
    names = sorted(w)
    losses = []
    out1 = None
    scale = float(cfg["initializer_scale"])
    with ref_dense.precision(precision):
        for t, (batch, keys) in enumerate(zip(batches, step_keys), start=1):
            u, inv = torch.unique(keys, return_inverse=True)
            ui = torch.searchsorted(keys3, u)
            hit, _ = table.find(u)
            new = u[~hit]
            ins_new = table.write(new, torch.full_like(new, t), u[hit])
            table.stamp(u[hit], t)
            inserted = torch.zeros_like(hit)
            inserted[~hit] = ins_new
            written = hit | inserted
            init = threefry.uniform_rows(cfg["table_name"], u, dim, scale)
            v = torch.where(hit[:, None], store_v[ui], init)
            a = torch.where(hit[:, None], store_a[ui],
                            torch.full_like(init, acc0))
            first = ~touched3[ui]
            base3[ui[first]] = v[first]
            touched3[ui] = True
            if t == 1:
                base1 = v.clone()
            if fault == "altered_row":
                v = v.clone()
                v[0] += 1.0
            b = batch["dense"].shape[0]
            rows = b // 2 if fault == "half_batch" else b
            loss, dgrads, g = forward_backward(cfg, w, batch, v, inv, rows)
            losses.append(float(loss))
            na = a + g * g
            nv = v - float(topt["learning_rate"]) * g / (
                torch.sqrt(na) + float(topt["epsilon"]))
            store_v[ui[written]] = nv[written]
            store_a[ui[written]] = na[written]
            with torch.no_grad():
                lr, eps = float(dopt["learning_rate"]), float(dopt["epsilon"])
                for k in names:
                    gk = dgrads[k]
                    acc = gk * gk + dacc[k]
                    inv_s = torch.where(acc > 0, torch.rsqrt(acc + eps), 0.0)
                    w[k] = w[k] + (-lr * (inv_s * gk))
                    dacc[k] = acc
            if t == 1:
                out1 = dict(keys1=u, written1=written, base1=base1,
                            values1=nv, acc1=na,
                            dense_acc1={k: dacc[k].clone() for k in names})
    resident3, _ = table.find(keys3)
    cands = torch.unique(torch.cat([pkeys, keys3]))
    c_res, c_sc = table.find(cands)
    return Steps(losses=losses, dense3=w, keys3=keys3, resident3=resident3,
                 base3=base3, values3=store_v,
                 candidates=cands, cand_resident=c_res,
                 cand_scores=torch.where(c_res, c_sc, 0), **out1)
