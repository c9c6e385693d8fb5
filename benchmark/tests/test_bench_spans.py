"""The readers of the program's spans and counters against values worked
out by hand on a Chrome-trace event list built here, and through a whole
traced run on the CPU."""
from __future__ import annotations

import pytest
import torch

from benchhelp import SEED, run, tiny_cell
from benchmark.trace import Trace

SUITE = run.Cell("suite.lpt512")
PM = run.Cell("pm.gr512")


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev(name, "user_annotation", ts, dur)


def _launch(corr, t, k0, k1):
    """A kernel launched at host time t that ran from k0 to k1."""
    return [_ev("cudaLaunchKernel", "cuda_runtime", t, 2, corr=corr),
            _ev(f"kernel_{corr}(int)", "kernel", k0, k1 - k0, corr=corr)]


def _suite_events(with_device=True):
    """Two passes in a window of 1000 us. Pass A: a kernel in the root
    alone, one in each power.* span, the distance transform, two kernels
    in voids.accept with 50 us idle between them and a stream sync. Pass
    B: a matter kernel, an accept kernel and a sync. The harness's own
    device sync at 950, a kernel after the window."""
    events = [
        _span("bench.window", 0, 1000),
        _span("suite.pass", 10, 440),
        _span("suite.matter", 20, 80),
        _span("power.keys", 25, 15),
        _span("power.deposit", 40, 20),
        _span("power.fft_bin", 60, 35),
        _span("suite.voids", 200, 240),
        _span("peaks.find", 210, 20),
        _span("voids.distance", 230, 70),
        _span("voids.candidates", 300, 20),
        _span("voids.accept", 320, 110),
        _span("suite.pass", 500, 400),
        _span("suite.matter", 510, 50),
        _span("suite.voids", 600, 250),
        _span("voids.accept", 700, 100),
        _ev("cudaStreamSynchronize", "cuda_runtime", 360, 30, corr=50),
        _ev("cudaStreamSynchronize", "cuda_runtime", 740, 5, corr=51),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 950, 10, corr=52),
    ]
    if with_device:
        for corr, t, k0, k1 in ((1, 12, 12, 22), (2, 30, 30, 50),
                                (3, 45, 50, 70), (4, 70, 70, 100),
                                (5, 240, 240, 340), (6, 330, 340, 350),
                                (7, 390, 400, 410), (8, 520, 520, 540),
                                (9, 710, 710, 730), (10, 990, 2000, 2010)):
            events += _launch(corr, t, k0, k1)
    return events


def _ctx(events, n_units=2, launches=None):
    return run.Context(trace=Trace(events), n_units=n_units,
                       launches=launches or {})


def _read(cell, name, ctx):
    return cell.reader(name).read(ctx)


# device us of the kernels a span launched, over 2 passes, in ms
SUITE_WANT = {
    "suite_ms.matter": (20 + 20 + 30 + 20) / 2e3,
    "suite_ms.voids": (100 + 10 + 10 + 20) / 2e3,
    "matter_ms.keys": 20 / 2e3,
    "matter_ms.deposit": 20 / 2e3,
    "matter_ms.fft_bin": 30 / 2e3,
    "void_ms.peaks": 0.0,
    "void_ms.distance": 100 / 2e3,
    "void_ms.candidates": 0.0,
    "void_ms.accept": (10 + 10 + 20) / 2e3,
    # idle inside suite.matter: 22-30, 510-520, 540-560
    "idle_ms.matter": (8 + 10 + 20) / 2e3,
    # idle inside suite.voids: 200-240, 350-400, 410-440, 600-710, 730-850
    "idle_ms.voids": (40 + 50 + 30 + 110 + 120) / 2e3,
    "self_ms.suite": 10 / 2e3,
    "host_syncs.suite": 1.0,
    "launches.k1": 1.0,
    "suite_ms.bispectrum": None,
    "suite_ms.lensing": None,
    "idle_ms.bispectrum": None,
    "idle_ms.lensing": None,
}


@pytest.mark.parametrize("name", sorted(SUITE_WANT))
def test_suite_reader(name):
    ctx = _ctx(_suite_events(), launches={"deposit_sorted": 2})
    want = SUITE_WANT[name]
    got = _read(SUITE, name, ctx)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want, abs=1e-12)


def test_suite_metrics_of_the_cell_have_readers():
    new = {m["name"] for m in SUITE.metrics("per_layer")
           if m["name"].split(".")[0] in ("suite_ms", "matter_ms", "void_ms",
                                          "idle_ms", "self_ms", "host_syncs",
                                          "launches")}
    assert new == set(SUITE_WANT)


def test_parts_and_idle_add_up():
    ctx = _ctx(_suite_events())
    parts = sum(_read(SUITE, f"void_ms.{p}", ctx)
                for p in ("peaks", "distance", "candidates", "accept"))
    assert parts == pytest.approx(_read(SUITE, "suite_ms.voids", ctx))
    # every idle us of the window: inside a stage, or outside the stages
    window_idle = 1000 - 10 - 70 - 110 - 10 - 20 - 20
    inside = sum(_read(SUITE, f"idle_ms.{s}", ctx) or 0.0
                 for s in ("matter", "bispectrum", "lensing", "voids"))
    # idle outside the stages: 0-12, 100-200, 440-510, 560-600, 850-1000
    outside = (12 + 100 + 70 + 40 + 150) / 2e3
    assert 2 * (inside + outside) * 1e3 == pytest.approx(window_idle)


@pytest.mark.parametrize("name", sorted(SUITE_WANT))
def test_suite_reader_without_a_card(name):
    """A trace without device events (taken on the CPU) reads nothing but
    the launch counter."""
    ctx = _ctx(_suite_events(with_device=False), launches={})
    got = _read(SUITE, name, ctx)
    assert got == (0.0 if name == "launches.k1" else None)


@pytest.mark.parametrize("name", sorted(SUITE_WANT))
def test_suite_reader_without_the_spans(name):
    """A program without the spans (the parent of this benchmark's span
    metrics) leaves every span metric out."""
    events = [e for e in _suite_events()
              if e["cat"] != "user_annotation"
              or e["name"] == "bench.window"]
    got = _read(SUITE, name, _ctx(events, launches={"deposit_sorted": 2}))
    assert got == (1.0 if name == "launches.k1" else None)


def _pm_events():
    """One simulation of one step in a window of 500 us: a copy in the
    root alone, a force evaluation, kick, drift, force, kick, and a
    stream sync in the paint."""
    events = [
        _span("bench.window", 0, 500),
        _span("pm.evolve", 5, 480),
        _span("pm.paint", 20, 20), _span("pm.poisson", 40, 20),
        _span("pm.gather", 60, 20),
        _span("pm.kick", 100, 10), _span("pm.drift", 120, 10),
        _span("pm.paint", 140, 20), _span("pm.poisson", 160, 20),
        _span("pm.gather", 180, 20),
        _span("pm.kick", 210, 10),
        _ev("cudaStreamSynchronize", "cuda_runtime", 25, 5, corr=60),
        _ev("cudaDeviceSynchronize", "cuda_runtime", 490, 5, corr=61),
    ]
    for corr, t, k0, k1 in ((1, 8, 8, 18), (2, 22, 22, 30),
                            (3, 101, 101, 104), (4, 121, 121, 127),
                            (5, 211, 211, 214), (6, 185, 190, 200)):
        events += _launch(corr, t, k0, k1)
    return events


PM_WANT = {
    "self_ms.pm": 10 / 1e3,
    "pm_ms.kick_drift": (3 + 6 + 3) / 1e3,
    "host_syncs.pm": 1.0,
    "launches.k2": 2.0,
}


@pytest.mark.parametrize("name", sorted(PM_WANT))
def test_pm_reader(name):
    ctx = _ctx(_pm_events(), n_units=1, launches={"paint_windowed": 2})
    assert _read(PM, name, ctx) == pytest.approx(PM_WANT[name], abs=1e-12)


def test_pm_partition_adds_up():
    """paint + poisson + gather a force evaluation, kick_drift a step and
    the self time make up the busy time."""
    ctx = _ctx(_pm_events(), n_units=1)
    forces = sum(ctx.trace.span_device_seconds(s)
                 for s in ("pm.paint", "pm.poisson", "pm.gather")) * 1e3
    total = forces + _read(PM, "pm_ms.kick_drift", ctx) + \
        _read(PM, "self_ms.pm", ctx)
    assert total == pytest.approx(ctx.trace.busy_s * 1e3)


def test_no_trace_reads_nothing():
    ctx = run.Context(n_units=3, launches={"deposit_sorted": 3})
    for cell, names in ((SUITE, SUITE_WANT), (PM, PM_WANT)):
        for name in names:
            assert _read(cell, name, ctx) is None


@pytest.mark.parametrize("name", ("suite.lpt512", "pm.gr512"))
def test_readers_in_a_traced_run_on_the_cpu(name, monkeypatch):
    """A traced run of a tiny cell: the harness's trace holds one root
    span a unit and the program's spans inside it; without device events
    the span metrics are left out and the launch counter reads 0."""
    torch.set_num_threads(4)
    cell = tiny_cell(name)
    if cell.entry["config"] == "z0_suite":
        cell.config = dict(cell.config, map_npix=128)
    traces = []
    profile = run._profile

    def keep(*a):
        traces.append(profile(*a))
        return traces[-1]
    monkeypatch.setattr(run, "_profile", keep)
    res, checks = run.measure(cell, SEED, 0.01, True, torch, device="cpu")
    assert res["correct"], checks
    trace = traces[-1]
    n = int(cell.workload["trace_units"])
    if name == "pm.gr512":
        nsteps = int(cell.config["nsteps"])
        want = {"pm.evolve": n, "pm.paint": n * (nsteps + 1),
                "pm.drift": n * nsteps, "pm.kick": 2 * n * nsteps}
        launch = "launches.k2"
    else:
        want = {s: n for s in ("suite.pass", "suite.matter",
                               "suite.bispectrum", "suite.lensing",
                               "suite.voids", "power.keys", "power.deposit",
                               "power.fft_bin", "peaks.find",
                               "voids.distance", "voids.candidates",
                               "voids.accept")}
        launch = "launches.k1"
    assert {s: trace.span_count(s) for s in want} == want
    reported = {m for m in res["metrics"]
                if m.split(".")[0] in ("suite_ms", "matter_ms", "void_ms",
                                       "idle_ms", "self_ms", "host_syncs",
                                       "launches")
                or m == "pm_ms.kick_drift"}
    assert reported == {launch}
    assert res["metrics"][launch]["value"] == 0.0
