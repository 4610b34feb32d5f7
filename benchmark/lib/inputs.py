"""Every input of a run, made on the device from ``--seed``: the table's
prefill (keys, scores, rows and optimizer slots), the dense weights, and
the batches. One general generator reads a traffic mix's parameters; the
program and the reference are handed the same inputs.

Keys: feature ``f``'s raw id ``i`` is the key ``f << feature_shift | i``
(the port's feature tagging). The vocabulary is ids ``0 .. card_f - 1``
per feature, ``card_f`` the configuration's cardinality capped at its
``max_ind_range``; every id a batch carries lies in it, as the capped ids
of the configuration's source do. Popularity follows the id: id 0 is a
feature's most frequent.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from typing import Dict, List

import torch

from benchmark.reference import dense as ref_dense

_M64 = (1 << 64) - 1


def splitmix(*words) -> int:
    """A 63-bit seed from Python ints and strings (SplitMix64 over each;
    a string enters as the first 8 bytes of its SHA-256)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        if isinstance(w, str):
            w = int.from_bytes(hashlib.sha256(w.encode("utf-8")).digest()[:8],
                               "little")
        h = (h ^ (int(w) & _M64)) & _M64
        h = (h + 0x9E3779B97F4A7C15) & _M64
        z = h
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _M64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _M64
        h = z ^ (z >> 31)
    return h & ((1 << 63) - 1)


def generator(device, *words) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(splitmix(*words))


def cardinalities(cfg) -> List[int]:
    cap = cfg["max_ind_range"]
    return [min(int(c), cap) for c in cfg["num_embeddings_per_feature"]]


def tag(ids: torch.Tensor, shift: int) -> torch.Tensor:
    """``[..., F]`` raw ids -> int64 keys, the feature in the top bits."""
    f = torch.arange(ids.shape[-1], dtype=torch.int64, device=ids.device)
    return ids.to(torch.int64) | (f << shift)


# ------------------------------------------------------------- prefill


@dataclasses.dataclass
class Prefill:
    """The keys a run writes into the table before training, in write
    order, with their scores (strictly increasing along that order), and
    the chunking of the write. Rows come from :meth:`rows`."""

    keys: torch.Tensor  # [K] int64
    scores: torch.Tensor  # [K] int64
    chunk: int
    value_scale: float
    acc_low: float
    acc_span: float

    @property
    def n_chunks(self) -> int:
        return -(-self.keys.shape[0] // self.chunk)

    def span(self, c: int):
        lo = c * self.chunk
        return lo, min(lo + self.chunk, self.keys.shape[0])

    def rows(self, seed: int, c: int, dim: int):
        """Chunk ``c``'s ``(values [n, dim], slot [n, dim])`` float32:
        values uniform in ``[-value_scale, value_scale)``, the Adagrad
        accumulator uniform in ``[acc_low, acc_low + acc_span)``."""
        lo, hi = self.span(c)
        dev = self.keys.device
        u = torch.rand((hi - lo, 2 * dim), generator=generator(
            dev, seed, "prefill", c), device=dev)
        values = (u[:, :dim] * 2.0 - 1.0) * self.value_scale
        acc = u[:, dim:] * self.acc_span + self.acc_low
        return values, acc

    def rows_at(self, seed: int, positions: torch.Tensor, dim: int):
        """Rows of the keys at write positions ``positions`` (any order)."""
        n = positions.shape[0]
        dev = self.keys.device
        values = torch.empty((n, dim), dtype=torch.float32, device=dev)
        acc = torch.empty((n, dim), dtype=torch.float32, device=dev)
        chunk_of = positions // self.chunk
        for c in torch.unique(chunk_of).tolist():
            sel = torch.nonzero(chunk_of == c).reshape(-1)
            v, a = self.rows(seed, c, dim)
            off = positions[sel] - c * self.chunk
            values[sel] = v[off]
            acc[sel] = a[off]
        return values, acc


def prefill(cfg, mix, device) -> Prefill:
    """The vocabulary, scored by popularity (id-major, so every feature's
    frequent ids outrank every feature's rare ones). Written least-popular
    first, so that where a bucket cannot hold all its keys it keeps its
    most popular."""
    p = mix["prefill"]
    cards = cardinalities(cfg)
    shift = cfg["feature_shift"]
    nf = len(cards)
    keys, scores = [], []
    for f, card in enumerate(cards):
        ids = torch.arange(card, dtype=torch.int64, device=device)
        keys.append(ids | (f << shift))
        scores.append(-(ids * nf + f) - 1)
    keys = torch.cat(keys)
    scores = torch.cat(scores)
    order = torch.argsort(scores)
    return Prefill(keys=keys[order], scores=scores[order],
                   chunk=int(p["chunk"]),
                   value_scale=float(p["value_scale"]),
                   acc_low=float(p["acc_low"]),
                   acc_span=float(p["acc_span"]))


# ------------------------------------------------------------ weights


def dense_weights(cfg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every dense leaf by name: matrices normal with standard deviation
    ``1/sqrt(fan_in)``, biases zero."""
    out = {}
    for name, shape in sorted(ref_dense.shapes(cfg).items()):
        if len(shape) == 2:
            w = torch.randn(shape, generator=generator(device, seed, "w",
                                                       name), device=device)
            out[name] = w * (1.0 / math.sqrt(shape[0]))
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------------ batches


@functools.lru_cache(maxsize=4)
def _zeta(n: tuple, theta: float, device: str) -> torch.Tensor:
    """``sum(i ** -theta for i in 1..n_f)`` for each feature, float64."""
    return torch.stack([
        torch.pow(torch.arange(1, c + 1, dtype=torch.float64,
                               device=device), -theta).sum() for c in n])


def _zipfian(u: torch.Tensor, n: torch.Tensor, theta: float):
    """YCSB's ``ZipfianGenerator.nextLong`` (Gray et al., SIGMOD 1994) for
    each column: ``u`` uniform ``[B, F]`` float64, ``n`` the items of each
    column ``[F]``; ranks ``0 .. n - 1``, rank 0 the most frequent."""
    zetan = _zeta(tuple(n.tolist()), theta, str(u.device)).to(u.device)
    zeta2 = 1.0 + 0.5 ** theta
    nf = n.to(torch.float64)
    alpha = 1.0 / (1.0 - theta)
    eta = (1.0 - torch.pow(2.0 / nf, 1.0 - theta)) / (1.0 - zeta2 / zetan)
    uz = u * zetan
    far = torch.floor(nf * torch.pow(eta * u - eta + 1.0, alpha))
    rank = torch.where(uz < 1.0, 0.0,
                       torch.where(uz < zeta2, 1.0, far))
    return torch.minimum(rank, nf - 1.0).to(torch.int64)


def _uniform(u: torch.Tensor, n: torch.Tensor):
    """The dlrm repository's random ids (``dlrm_data_pytorch.py``):
    ``round(u * (n - 1))`` for ``u`` uniform ``[0, 1)``."""
    return torch.round(u * (n.to(torch.float64) - 1.0)).to(torch.int64)


def batch(cfg, mix, seed: int, k: int, device):
    """Batch ``k``: ``{"dense" [B, num_dense] f32, "sparse" [B, F] int32,
    "label" [B] f32}``. Each feature's ids from the mix's ``ids``
    distribution over its capped cardinality (``zipfian`` with ``theta``,
    or ``uniform``); dense features uniform on ``[0, 1)``; labels 1 with
    probability ``label_rate``."""
    b, nf = mix["batch"], cfg["num_sparse"]
    g = generator(device, seed, "batch", k)
    cards = torch.tensor(cardinalities(cfg), dtype=torch.int64,
                         device=device)
    u = torch.rand((b, nf), dtype=torch.float64, generator=g, device=device)
    ids = mix["ids"]
    if ids["distribution"] == "zipfian":
        sparse = _zipfian(u, cards, float(ids["theta"]))
    elif ids["distribution"] == "uniform":
        sparse = _uniform(u, cards)
    else:
        raise ValueError(f"unknown id distribution {ids['distribution']!r}")
    dense = torch.rand((b, cfg["num_dense"]), generator=g, device=device)
    label = (torch.rand((b,), generator=g, device=device)
             < mix["label_rate"]).to(torch.float32)
    return {"dense": dense, "sparse": sparse.to(torch.int32),
            "label": label}


class Pool:
    """``n`` batches made at set-up, served in order; batch ``k`` past the
    last is batch ``k % n`` again (the traffic file sizes ``n`` beyond the
    steps a window takes now, so only a faster program repeats)."""

    def __init__(self, cfg, mix, seed: int, n: int, device):
        b, nf = mix["batch"], cfg["num_sparse"]
        self.n = n
        self.dense = torch.empty((n, b, cfg["num_dense"]), device=device)
        self.sparse = torch.empty((n, b, nf), dtype=torch.int32,
                                  device=device)
        self.label = torch.empty((n, b), device=device)
        for k in range(n):
            one = batch(cfg, mix, seed, k, device)
            self.dense[k], self.sparse[k] = one["dense"], one["sparse"]
            self.label[k] = one["label"]

    def __getitem__(self, k: int):
        i = k % self.n
        return {"dense": self.dense[i], "sparse": self.sparse[i],
                "label": self.label[i]}
