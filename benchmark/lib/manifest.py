"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix (``benchmark/traffic/<mix>.json``) and its correctness limits
(``benchmark/limits/<cell>.json``). Everything of one configuration, mix
or metric sits in files of its own, found by name.

Sparse features in a configuration: ``num_sparse`` features, each with
one id per example, unless the file gives ``multi_hot_sizes``, one count
per feature: the ids per example of that feature's bag. A bag is pooled
by ``pooling``, whose only value taken is ``"sum"`` (also the default);
any other raises. A batch then has ``sum(multi_hot_sizes)`` id columns,
grouped by feature in feature order. Each bag is made from one id drawn
by the mix's ``ids`` distribution over the feature's capped vocabulary,
as MLPerf's DLRM-DCNv2 reference makes its multi-hot Criteo 1TB: the
drawn id first, then that id's row of a fixed table uniform over the
vocabulary. The schema is read by ``lib/inputs.py`` (``bag_sizes``,
``column_features``, ``bags``)."""

from __future__ import annotations

import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return json.loads((root / "benchmark" / "traffic" / f"{name}.json")
                      .read_text())


def metrics_for(manifest: dict, section: str, cell_name: str):
    """The metrics of ``section`` that ``cell_name`` reports."""
    return [m for m in manifest[section]
            if "workloads" not in m or cell_name in m["workloads"]]
