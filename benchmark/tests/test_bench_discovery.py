"""A new configuration, traffic mix, cell and metric are added as new
files and new BENCHMARK.json entries only: a copy of the benchmark with
them added runs the new cell, and no file that was there is touched."""
from __future__ import annotations

import hashlib
import json
import shutil

import torch

from benchhelp import ROOT, run

DRIVER = '''
import torch


class Driver:
    def __init__(self, config, traffic, workload, inputs, device, seed=0):
        self.x = inputs["x"]
        self.scale = float(config["scale"])
        self.out = None

    def unit(self):
        return self.x * self.scale

    def keep(self, out):
        self.out = out

    def facts(self):
        return {"n": self.x.numel()}

    def counters(self):
        return {}

    def release(self):
        pass

    def check(self, limits):
        gap = float((self.out - 2.0 * self.x).abs().max())
        return [("gap", gap, limits["gap"])], 0
'''

GENERATOR = '''
import torch


def generate(params, seed, device):
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    return {"x": torch.rand(int(params["n"]), generator=g, device=device)}
'''

METRIC = '''
def read(ctx):
    return float(ctx.facts["n"]) / ctx.n_units
'''


def _digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest()
        for p in sorted((root / "benchmark").rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_only(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = _digest(tmp_path)
    b = tmp_path / "benchmark"
    (b / "configs" / "dummy_cfg.json").write_text(
        json.dumps({"name": "dummy_cfg", "scale": 2.0, "assumed": [],
                    "source_values": {}}))
    (b / "drivers" / "dummy_cfg.py").write_text(DRIVER)
    (b / "traffic" / "dummy_gen.py").write_text(GENERATOR)
    (b / "traffic" / "dummy_mix.json").write_text(
        json.dumps({"generator": "dummy_gen", "n": 1000}))
    (b / "workloads" / "dummy.cell.json").write_text(
        json.dumps({"trace_units": 2, "limits": {"gap": 0.0}}))
    (b / "metrics" / "dummy_per_unit.py").write_text(METRIC)
    spec["configs"].append({"name": "dummy_cfg", "source": "a test",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy.cell", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "dummy_per_unit", "unit": "1",
                              "better": "lower", "source": "program_counter",
                              "layer": "test", "moves": "setup_s",
                              "workloads": ["dummy.cell"]})
    for m in spec["end_to_end"]:
        if m["name"] == "setup_s":
            assert "workloads" not in m
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digest(tmp_path)
    assert all(after[k] == v for k, v in before.items())

    harness = run._load(b / "run.py", "bench_run_copy")
    assert harness.ROOT == tmp_path
    cell = harness.Cell("dummy.cell")
    res, _ = harness.measure(cell, 7, 0.05, False, torch, device="cpu")
    assert res["correct"] and res["attempted"] >= 1
    assert set(res["metrics"]) == {"setup_s"}
    res, _ = harness.measure(cell, 7, 0.05, True, torch, device="cpu")
    assert res["correct"] and res["metrics"]["dummy_per_unit"]["value"] == 500
    assert list(res)[-1] == "checks"
