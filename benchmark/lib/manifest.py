"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix (``benchmark/traffic/<mix>.json``) and its correctness limits
(``benchmark/limits/<cell>.json``). Everything of one configuration, mix
or metric sits in files of its own, found by name."""

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
