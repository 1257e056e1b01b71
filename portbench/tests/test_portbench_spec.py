"""BENCHMARK.json against the contract's form, and every file a cell needs
found by name."""

import json
import os
import re

import pytest

from portbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= 1


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    texts = [entry[k] for k in ("why", "layer") if k in entry]
    if "file" in entry:  # a configuration's source is a line of text
        texts.append(entry["source"])
    for text in texts:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_metric_keys():
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = {e["name"]: e for e in BENCH["end_to_end"]}[m["moves"]]
        for cell in m["workloads"]:
            assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    spec = harness.cell_spec(BENCH, cell)
    assert os.path.exists(os.path.join(harness.BENCH_DIR, "drivers",
                                       spec["traffic"]["driver"] + ".py"))
    with open(os.path.join(harness.BENCH_DIR, "limits", cell + ".json")) as f:
        assert json.load(f)
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"].startswith("portbench/configs/")
    settings = harness.load_json(os.path.join(harness.ROOT, config["file"]))
    assert settings["reduced"] == config["reduced"]
    assert settings["scene"] in ("shell", "island")
    assert config["name"] in {w["config"] for w in BENCH["workloads"]}
