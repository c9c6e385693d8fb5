"""BENCHMARK.json against the benchmark's contract, and every name it
uses resolved to its files."""
from __future__ import annotations

import json
import re

import pytest

from benchhelp import ROOT, run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= SPEC["run_seconds"] <= 51
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["command"]) <= 32
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in SPEC["paths"])


def _entries():
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            yield kind, e


@pytest.mark.parametrize("kind,entry", list(_entries()),
                         ids=lambda x: x if isinstance(x, str) else x["name"])
def test_names_units_and_keys(kind, entry):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[kind]
    assert set(entry) <= allowed
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", ()):
        assert NAME.match(key)
    for key in TEXT_KEYS:
        if key in entry:
            text = entry[key]
            assert 1 <= len(text) <= 200 and "\n" not in text
            assert "\t" not in text
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
    if "better" in entry:
        assert entry["better"] in ("lower", "higher")
    if kind == "end_to_end":
        assert entry["source"] in ("host_clock", "device_trace")
        cap = 0.25
        assert 0.01 <= entry["bound"] <= cap
    if kind == "per_layer":
        assert entry["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
        assert entry["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    if kind == "workloads":
        assert entry["chips"] in (1, 4)


def test_names_unique_and_used():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = run.Cell(cell)
    assert c.driver_path.is_file() and c.generator_path.is_file()
    assert hasattr(c.driver(), "Driver")
    assert hasattr(c.generator(), "generate")
    e2e = [m["name"] for m in c.metrics("end_to_end")]
    per_layer = [m["name"] for m in c.metrics("per_layer")]
    assert "setup_s" in e2e and len(e2e) >= 2 and per_layer
    for name in e2e + per_layer:
        assert hasattr(c.reader(name), "read")
    reported = set(e2e)
    for m in c.metrics("per_layer"):
        assert m["moves"] in reported
    assert set(c.workload["limits"]) and all(
        v >= 0 for v in c.workload["limits"].values())


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"]
    for key in config["reduced"]:
        assert key in data and key in data["source_values"]
    assert "assumed" in data


def test_four_chip_cells_within_share():
    four = sum(1 for w in SPEC["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_dotted_metric_reader():
    c = run.Cell("suite.lpt512")
    metrics = ROOT / "benchmark" / "metrics"
    assert c.metric_path("stage_ms.voids") == metrics / "stage_ms.voids.py"
    assert c.metric_path("busy_ms.suite") == metrics / "busy_ms.py"
    assert c.metric_path("busy_ms.any_new_part") == metrics / "busy_ms.py"
    assert c.metric_path("suite_s") == metrics / "suite_s.py"
