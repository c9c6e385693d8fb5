"""Each cell run for a second on the card: exit 0, `correct` true, every
metric of the cell reported. Skips without a card; run on the card with
python -m pytest -m cuda benchmark/tests/test_bench_card.py."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchhelp import ROOT, run

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("trace", (0, 1))
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_on_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "1", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    kind = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in run.Cell(cell).metrics(kind)}
    assert set(res["metrics"]) == want
