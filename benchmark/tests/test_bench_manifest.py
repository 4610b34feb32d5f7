"""BENCHMARK.json against the benchmark's contract, and every file it
names found where the harness looks for it."""

import json
import re

import pytest

from benchmark.lib import manifest
from benchmark import metrics as metric_readers

MAN = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert isinstance(MAN["run_seconds"], int)
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


def test_run_seconds_fits_the_full_check():
    # 24 cells: 2 + 14 x 24 runs of run_seconds + 60, 180 s a cell to
    # compile, 1200 s spare, within 43,200 s
    runs = 2 + 14 * 24
    assert runs * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_one_line_texts(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    for e in MAN[section]:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                assert "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_entries_have_exactly_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_its_metrics_move():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in moved or cell in moved["workloads"]
    for cell in cells:
        assert manifest.metrics_for(MAN, "per_layer", cell)
        assert len(manifest.metrics_for(MAN, "end_to_end", cell)) >= 2


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_each_pair_once_and_each_config_used():
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_files_of_each_cell_exist(cell):
    from benchmark.lib import check

    w = manifest.cell(MAN, cell)
    cfg = manifest.config(MAN, w["config"])
    assert cfg["name"] == w["config"]
    mix = manifest.traffic(w["traffic"])
    assert mix["name"] == w["traffic"]
    limits = check.limits_for(cell, manifest.ROOT)
    assert set(limits) == set(check.NAMES)
    assert limits["keys_wrong"] == 0


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    assert callable(metric_readers.load(metric).read)


def test_roofline_and_mfu_names():
    for m in MAN["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert any("mfu" in m["name"] for m in MAN["per_layer"])
