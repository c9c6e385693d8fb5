"""Without a CUDA card a run fails and prints no result, and so it does
in a directory that holds only the benchmark's own files."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest
import torch

from benchhelp import ROOT


def _run(cwd):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "suite.lpt512",
         "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")


def test_no_card(no_card):
    out = _run(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_benchmark_files_alone(tmp_path):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in spec["paths"]:
        shutil.copytree(ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
