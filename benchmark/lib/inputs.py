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

Bags: a batch's ``sparse`` has one column per id of an example, grouped
by feature in feature order (:func:`column_features`): one column a
feature, or ``multi_hot_sizes[f]`` columns where the configuration gives
them (:func:`bag_sizes`). A bag is made as MLPerf's DLRM-DCNv2 reference
makes it from the one-hot id (``torchrec_dlrm/multi_hot.py``,
``--multi_hot_distribution_type uniform``): its first id is the one drawn,
the others are a fixed table's row for that id, uniform over the
feature's vocabulary (:func:`bags`).
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
from typing import Dict, List

import torch

from benchmark.reference import dense as ref_dense
from benchmark.reference import hashing

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


def bag_sizes(cfg) -> List[int]:
    """Ids per example of each sparse feature: the configuration's
    ``multi_hot_sizes``, else one each. Bags are pooled by their
    ``pooling``, of which ``"sum"`` (the default) is the only one taken."""
    pooling = cfg.get("pooling", "sum")
    if pooling != "sum":
        raise ValueError(f"pooling {pooling!r}: only 'sum' is taken")
    nf = cfg["num_sparse"]
    sizes = [int(s) for s in cfg.get("multi_hot_sizes", [1] * nf)]
    if len(sizes) != nf or min(sizes) < 1:
        raise ValueError(f"multi_hot_sizes {sizes}: one count of at least "
                         f"1 for each of the {nf} sparse features")
    return sizes


def column_features(cfg, device=None) -> torch.Tensor:
    """``[N]`` int64: the feature of each column of a batch's ``sparse``
    (``arange(F)`` without bags)."""
    sizes = bag_sizes(cfg)
    return torch.repeat_interleave(torch.arange(len(sizes)),
                                   torch.tensor(sizes)).to(device)


def tag(ids: torch.Tensor, shift: int, features: torch.Tensor
        ) -> torch.Tensor:
    """``[..., N]`` raw ids -> int64 keys, each column's feature
    (``features [N]``, :func:`column_features`) in the top bits."""
    return ids.to(torch.int64) | (features.to(ids.device) << shift)


def bags(cfg, first: torch.Tensor, tables=None) -> torch.Tensor:
    """``[B, F]`` drawn ids -> ``[B, N]`` bags (``first`` itself without
    bags). A bag's first column is its feature's drawn id ``i``; its column
    ``j >= 1`` holds row ``i``, column ``j`` of a fixed table uniform over
    the feature's capped vocabulary, as MLPerf's ``Multihot`` makes it
    (``np.random.randint(0, rows, (rows, size - 1))`` at seed 0). The table
    is not held: an entry is SplitMix64 of ``i`` salted by ``(f, j)``,
    modulo the cardinality, the same for every run and seed. ``tables``:
    :func:`bag_tables` made once on ``first``'s device."""
    if tables is None:
        tables = bag_tables(cfg, first.device)
    if tables is None:
        return first
    cols, salt, cards = tables
    ids = first.to(torch.int64)[:, cols]
    table = hashing.srl(hashing.mix64(ids ^ salt), 1) % cards
    return torch.where(salt == 0, ids, table)


def bag_tables(cfg, device):
    """What :func:`bags` indexes with, on ``device``: ``(columns' features
    [N], salts [N], cardinalities [N])``, or None without bags."""
    sizes = bag_sizes(cfg)
    if max(sizes) == 1:
        return None
    cols = column_features(cfg, device)
    salt = torch.tensor([splitmix("bag", f, j) if j else 0
                         for f, n in enumerate(sizes) for j in range(n)],
                        dtype=torch.int64, device=device)
    cards = torch.tensor(cardinalities(cfg), dtype=torch.int64,
                         device=device)[cols]
    return cols, salt, cards


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


def _zipfian(u: torch.Tensor, n: torch.Tensor, theta: float,
             zetan: torch.Tensor):
    """YCSB's ``ZipfianGenerator.nextLong`` (Gray et al., SIGMOD 1994) for
    each column: ``u`` uniform ``[B, F]`` float64, ``n`` the items of each
    column ``[F]``, ``zetan`` their :func:`_zeta`; ranks ``0 .. n - 1``,
    rank 0 the most frequent."""
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


class Draw:
    """Batch ``k`` of a run, for any ``k``: ``{"dense" [B, num_dense] f32,
    "sparse" [B, N] int32, "label" [B] f32}``, ``N`` the columns of
    :func:`column_features`. Each feature's id drawn independently, from
    the mix's ``ids`` distribution over its capped cardinality
    (``zipfian`` with ``theta``, or ``uniform``), and made into its bag by
    :func:`bags`; dense features uniform on ``[0, 1)``; labels 1 with
    probability ``label_rate``. What every batch shares is made once, so
    that drawing a batch waits for nothing on the host."""

    def __init__(self, cfg, mix, seed: int, device):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.device = torch.device(device)
        cards = cardinalities(cfg)
        self.cards = torch.tensor(cards, dtype=torch.int64,
                                  device=self.device)
        ids = mix["ids"]
        self.zetan = None
        if ids["distribution"] == "zipfian":
            self.zetan = _zeta(tuple(cards), float(ids["theta"]),
                               str(self.device)).to(self.device)
        elif ids["distribution"] != "uniform":
            raise ValueError(f"unknown id distribution "
                             f"{ids['distribution']!r}")
        self.bags = bag_tables(cfg, self.device)

    def __call__(self, k: int):
        b, dev = self.mix["batch"], self.device
        g = generator(dev, self.seed, "batch", k)
        u = torch.rand((b, self.cards.numel()), dtype=torch.float64,
                       generator=g, device=dev)
        if self.zetan is not None:
            first = _zipfian(u, self.cards, float(self.mix["ids"]["theta"]),
                             self.zetan)
        else:
            first = _uniform(u, self.cards)
        sparse = bags(self.cfg, first, self.bags)
        dense = torch.rand((b, self.cfg["num_dense"]), generator=g,
                           device=dev)
        label = (torch.rand((b,), generator=g, device=dev)
                 < self.mix["label_rate"]).to(torch.float32)
        return {"dense": dense, "sparse": sparse.to(torch.int32),
                "label": label}


def batch(cfg, mix, seed: int, k: int, device):
    """Batch ``k`` of a run (:class:`Draw`)."""
    return Draw(cfg, mix, seed, device)(k)


class Pool:
    """Batches ``0 .. n - 1`` of a run, made at set-up and served in
    order. Batch ``k`` past the last is drawn when it is asked for, never
    served again: a repeated batch would find its missed keys inserted by
    its first pass and skip the lookup's miss branch. The traffic file
    sizes ``n`` beyond the steps a window takes, so that the window draws
    nothing."""

    def __init__(self, cfg, mix, seed: int, n: int, device):
        b, cols = mix["batch"], sum(bag_sizes(cfg))
        self.n = n
        self.draw = Draw(cfg, mix, seed, device)
        self.dense = torch.empty((n, b, cfg["num_dense"]), device=device)
        self.sparse = torch.empty((n, b, cols), dtype=torch.int32,
                                  device=device)
        self.label = torch.empty((n, b), device=device)
        for k in range(n):
            one = self.draw(k)
            self.dense[k], self.sparse[k] = one["dense"], one["sparse"]
            self.label[k] = one["label"]

    def __getitem__(self, k: int):
        if k >= self.n:
            return self.draw(k)
        return {"dense": self.dense[k], "sparse": self.sparse[k],
                "label": self.label[k]}
