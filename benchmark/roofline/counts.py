"""Operations and bytes that a training step needs, from the model's
shapes and the step's keys: the algorithm's needs for these inputs, not
what an implementation happens to move.

* Dense FLOPs per example: every weight matrix's product forward
  (``2 * in * out``), its weight gradient (the same) and its input
  gradient (the same, unless its input is the raw dense features), and for
  DLRM the pair dot products (``2 * pairs * dim`` forward, twice that
  backward). Elementwise work is not counted.
* The lookup's row gather: each unique key that hits reads its stored
  row's used words (value and optimizer slot) and writes them once, plus
  its 4-byte index.
* The fused Adagrad apply: each written row (a hit or an insert) reads its
  looked-up value and accumulator and its gradient, writes its value and
  accumulator, plus its 4-byte index.
"""

from __future__ import annotations

from benchmark.reference import models


def train_flops_per_example(cfg) -> int:
    family = models.load(cfg["family"])
    total = family.extra_train_flops(cfg)
    for name, shape in family.shapes(cfg).items():
        if len(shape) == 2:
            mac = shape[0] * shape[1]
            total += 4 * mac if name in family.RAW_INPUT else 6 * mac
    return total


def row_words(cfg) -> int:
    """Used 4-byte words of a stored row: the value and the Adagrad
    accumulator."""
    return 2 * cfg["dim"]


def gather_bytes(cfg, hits: float) -> float:
    return hits * (2 * 4 * row_words(cfg) + 4)


def apply_bytes(cfg, written: float) -> float:
    return written * (2 * 4 * row_words(cfg) + 4 * cfg["dim"] + 4)
