"""BENCHMARK.json loads, every cell's files are found by name, and the
manifest keeps the benchmark's rules."""

import json
import re

import pytest

from portbench import harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["command"] == ["python3", "portbench/run.py"] and M["paths"] == ["portbench"]
    assert 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) < 64 * 1024


def test_names_units_and_sources():
    metrics = M["end_to_end"] + M["per_layer"]
    names = [x["name"] for x in metrics + M["workloads"] + M["configs"]]
    assert len(set(x["name"] for x in metrics)) == len(metrics)
    assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


@pytest.mark.parametrize("workload", [w["name"] for w in M["workloads"]])
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.chips in (1, 4)
    assert callable(cell.family.build) and callable(cell.reference.logits) and callable(cell.runner.run)
    assert cell.limits, "a cell's correctness limits are in limits/<workload>.json"
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e, (m["name"], "moves an end-to-end metric the cell reports")


@pytest.mark.parametrize("metric", [m["name"] for m in M["end_to_end"] + M["per_layer"]])
def test_metric_readers_declare_what_the_manifest_says(metric):
    reader = harness.metric_reader(metric)
    entry = next(m for m in M["end_to_end"] + M["per_layer"] if m["name"] == metric)
    assert callable(reader.read) and reader.SOURCE == entry["source"]
    if "layer" in entry:
        assert (reader.LAYER, reader.MOVES) == (entry["layer"], entry["moves"])


def test_configs_reduce_no_width():
    for c in M["configs"]:
        cfg = harness.read_json(harness.ROOT / c["file"])
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank")) and key in cfg["reduced"] and key in cfg["published"]


def test_check_fits_its_time_with_24_cells():
    total = (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
