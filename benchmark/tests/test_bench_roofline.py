"""The frozen byte counts and peaks, and the trace reader."""
from __future__ import annotations

import pytest

from benchhelp import ROOT  # noqa: F401  (puts the checkout on sys.path)
from benchmark.metrics import roofline
from benchmark.trace import Trace, kernel_name


def test_k1_bound_at_the_suite_shape():
    # 2^27 keys onto 2^27 fine cells (512^3 particles, ngrid 256, ff 2)
    b = roofline.k1_bytes(1 << 27, (2 * 256) ** 3)
    assert b == 1073741824
    assert roofline.bound_seconds(b) * 1e3 == pytest.approx(0.3205, abs=5e-4)


def test_k2_bound_at_the_pm_shape():
    # 2^27 particles onto a 512^3 CIC mesh
    b = roofline.k2_bytes(1 << 27, 512 ** 3)
    assert b == 2147483648
    assert roofline.bound_seconds(b) * 1e3 == pytest.approx(0.6410, abs=5e-4)


def test_peaks():
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
    assert roofline.PEAK_F32_FLOPS == 67e12
    assert roofline.share_pct(1.0, 0.0, 1) is None
    assert roofline.share_pct(1.0, 4.0, 2) == 50.0


def test_kernel_name():
    assert kernel_name("void deposit_hist<256>(int const*, long)") == \
        "deposit_hist"
    assert kernel_name("paint_windowed_deposit(Geometry, float const*)") == \
        "paint_windowed_deposit"
    assert kernel_name("void (anonymous namespace)::deposit_partition<false,"
                       " true, true>(int const*, float const*, long)") == \
        "deposit_partition"
    assert kernel_name("(anonymous namespace)::paint_windowed_scatter(int "
                       "const*, long, int*, int*)") == "paint_windowed_scatter"
    assert kernel_name("void at::native::vectorized_elementwise_kernel"
                       "<4, at::native::Foo<float> >(int, Foo)") == \
        "vectorized_elementwise_kernel"


def _ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_trace_reading():
    events = [
        _ev("bench.window", "user_annotation", 0, 1000),
        _ev("pm.paint", "user_annotation", 10, 100),
        _ev("cudaLaunchKernel", "cuda_runtime", 20, 5, corr=1),
        _ev("cudaLaunchKernel", "cuda_runtime", 200, 5, corr=2),
        _ev("void paint_windowed_deposit<2>(G)", "kernel", 100, 50, corr=1),
        _ev("elementwise", "kernel", 300, 100, corr=2),
        # a launch with no runtime record, inside the span's device side
        _ev("pm.paint", "gpu_user_annotation", 500, 100),
        _ev("paint_windowed_bin(G)", "kernel", 520, 30, corr=9),
        _ev("outside", "kernel", 2000, 10, corr=3),
    ]
    t = Trace(events)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(180e-6)
    assert t.span_count("pm.paint") == 1
    assert t.span_device_seconds("pm.paint") == pytest.approx(80e-6)
    secs, n = t.kernel_seconds(("paint_windowed_deposit",
                                "paint_windowed_bin"))
    assert (secs, n) == (pytest.approx(80e-6), 2)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["elementwise", pytest.approx(100e-6)]
    assert bd["idle_gaps"][0][1] == pytest.approx(450e-6)
    assert len(bd["idle_gaps"]) <= 10
