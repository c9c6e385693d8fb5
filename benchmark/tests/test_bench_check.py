"""The check on the CPU at a size a test run holds: each driver agrees
with its plain reference; the reference one precision below (the
control) in the program's place comes out not correct; and a run with
the program broken underneath comes out not correct, once for each fault
the cell can have (one card, so no exchange between cards to leave out).
"""
from __future__ import annotations

import pytest
import torch

from benchhelp import SEED, tiny_cell, run

CELLS = ("suite.lpt512", "pm.gr512", "suite.lpt1024")


@pytest.mark.parametrize("name", CELLS)
def test_program_agrees_with_reference(name):
    cell = tiny_cell(name)
    res, checks = run.measure(cell, SEED, 0.01, False, torch, device="cpu")
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = tiny_cell(name)
    inputs = cell.generator().generate(cell.traffic, SEED, "cpu")
    drv = cell.driver().Driver(cell.config, cell.traffic, cell.workload,
                               inputs, "cpu", SEED)
    drv.keep(drv.control_unit())
    checks, _ = drv.check(cell.workload["limits"])
    assert any(not v <= lim for _, v, lim in checks), checks


def _suite_half(monkeypatch):
    """The matter stage sees half the particles, the mean over the rest."""
    from astrild_tpu_torch.ops import power

    orig = power.auto_power_fast

    def half(pos, *a, **k):
        n = pos[0].shape[0] // 2
        return orig(tuple(c[:n] for c in pos), *a, **k)
    monkeypatch.setattr(power, "auto_power_fast", half)


def _suite_altered(monkeypatch):
    """One P(k) value altered where it is produced."""
    from astrild_tpu_torch.ops import power

    orig = power.auto_power_fast

    def altered(*a, **k):
        res, grid = orig(*a, **k)
        p = res.power.clone()
        p[3] *= 1.01
        return res._replace(power=p), grid
    monkeypatch.setattr(power, "auto_power_fast", altered)


def _suite_void_altered(monkeypatch):
    """The void radii altered where they are produced, by 1%."""
    from astrild_tpu_torch.ops import voids

    orig = voids.find_tunnels

    def altered(*a, **k):
        cat = orig(*a, **k)
        return cat._replace(radius=cat.radius * 1.01)
    monkeypatch.setattr(voids, "find_tunnels", altered)


def _pm_unchanged(monkeypatch):
    """The time loop returns its state unchanged."""
    from astrild_tpu_torch.ops import nbody

    monkeypatch.setattr(nbody, "_pm_loop",
                        lambda comps, mom, *a, **k: (comps, mom))


def _pm_half(monkeypatch):
    """The force paints see half the particles at twice the mass."""
    from astrild_tpu_torch.ops import nbody

    orig = nbody.paint

    def half(comps, ngrid, boxsize, weights=None, **k):
        n = comps[0].shape[0] // 2
        w = torch.full((n,), 2.0, dtype=comps[0].dtype,
                       device=comps[0].device)
        return orig(tuple(c[:n] for c in comps), ngrid, boxsize, weights=w,
                    **k)
    monkeypatch.setattr(nbody, "paint", half)


def _pm_altered(monkeypatch):
    """One particle's final position altered where it is produced, by a
    tenth of the box."""
    from astrild_tpu_torch.ops import nbody

    orig = nbody._pm_loop

    def altered(comps, mom, *a, **k):
        comps, mom = orig(comps, mom, *a, **k)
        comps[0][7] = torch.remainder(comps[0][7] + 50.0, 500.0)
        return comps, mom
    monkeypatch.setattr(nbody, "_pm_loop", altered)


FAULTS = [(cell, fault) for cell in ("suite.lpt512", "suite.lpt1024")
          for fault in (_suite_half, _suite_altered,
                        _suite_void_altered)] + [
    ("pm.gr512", _pm_unchanged), ("pm.gr512", _pm_half),
    ("pm.gr512", _pm_altered)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n}-{f.__name__[1:]}" for n, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    cell = tiny_cell(name)
    res, checks = run.measure(cell, SEED, 0.01, False, torch, device="cpu")
    assert not res["correct"], checks
    assert res["failed"] >= 1 or any(not v <= lim for _, v, lim in checks)


@pytest.mark.parametrize("rad,ref,want", [
    ([5.0, 3.0, 0.0], [3.0, 5.0, 0.0], 0),
    ([5.0, 3.0, 0.0], [5.0, 4.0, 3.0], 1),
    ([5.0, 3.0, 2.0], [5.0, 3.0 * (1 + 2e-5), 2.0], 2),
    ([5.0, 3.0, 2.0], [5.0, 3.0 * (1 + 5e-6), 2.0], 0),
    ([0.0, 0.0], [0.0, 0.0], 0),
], ids=["order", "one_more", "one_moved", "within_rtol", "none"])
def test_radii_mismatch(rad, ref, want):
    drv = run.Cell("suite.lpt512").driver()
    assert drv.radii_mismatch(torch.tensor(rad), torch.tensor(ref)) == want
