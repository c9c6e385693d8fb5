"""Shared pieces of the benchmark's own tests: cells cut to a size that
the CPU runs in seconds. Every other setting is the cell's."""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run  # noqa: E402

SEED = 2 ** 31 + 12345


def tiny_cell(name: str):
    """The cell with 32^3 particles; the suite's maps at 512^2 and 8 lens
    planes, the PM at 4 steps."""
    c = run.Cell(name)
    c.traffic = dict(c.traffic, n_side=32)
    if c.entry["config"] == "z0_suite":
        c.config = dict(c.config, ngrid=16, map_npix=512, nplanes=8)
    else:
        c.config = dict(c.config, nsteps=4)
    return c

