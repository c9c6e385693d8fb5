"""The port's observability layer (astrild_tpu_torch.utils.observability)
against the JAX package's on the CPU: StageTimes' JSON, stage timing and
its sync argument, the torch.profiler trace file, check_finite's message,
and enable_nan_checks' torch form (autograd's anomaly mode with NaN
checks, which looks at the backward pass only)."""
import glob
import json
import logging
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from astrild_tpu.utils import observability as JOBS  # noqa: E402

from astrild_tpu_torch.core import Catalog, Grid3D  # noqa: E402
from astrild_tpu_torch.utils import observability as OBS  # noqa: E402


def test_stage_times_json_matches_jax():
    a, b = OBS.StageTimes(), JOBS.StageTimes()
    for name, dt in (("read", 0.123456789), ("paint", 2.0), ("read", 1e-5),
                     ("fft", 1.23456e-4)):
        a.add(name, dt)
        b.add(name, dt)
    assert a.as_json() == b.as_json()
    assert a.times == b.times
    assert list(json.loads(a.as_json())) == ["read", "paint", "fft"]


@pytest.mark.parametrize("how", ["none", "sync", "holder"])
def test_stage_times_a_block(how):
    col = OBS.StageTimes()
    t = torch.ones(64, 64)
    kw = {"sync": (t, {"g": Grid3D(t, 1.0)})} if how == "sync" else {}
    t0 = time.perf_counter()
    with OBS.stage("demo", collector=col, log=False, **kw) as holder:
        time.sleep(0.02)
        out = (t @ t).sum()
        if how == "holder":
            holder["sync"] = {"out": out, "n": 3, "none": None}
    wall = time.perf_counter() - t0
    assert 0.02 <= col.times["demo"] <= wall
    with OBS.stage("demo", collector=col, log=False):
        pass
    assert col.times["demo"] >= 0.02  # accumulates
    json.loads(col.as_json())


def test_stage_logs_through_the_port_logger(caplog):
    logger = OBS.get_logger()
    assert logger.name == "astrild_tpu_torch" and logger is OBS.get_logger()
    assert len(logger.handlers) == 1
    logger.propagate = True
    try:
        with caplog.at_level(logging.INFO, logger="astrild_tpu_torch"):
            with OBS.stage("logged", collector=OBS.StageTimes()):
                pass
    finally:
        logger.propagate = False
    assert any("stage logged:" in r.getMessage() for r in caplog.records)


def test_trace_writes_a_chrome_trace(tmp_path):
    with OBS.trace(str(tmp_path / "tr")) as log_dir:
        x = torch.randn(256, 256)
        (x @ x).sum()
    files = glob.glob(f"{log_dir}/*.pt.trace.json")
    assert len(files) == 1
    events = json.load(open(files[0]))["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


def test_check_finite_matches_jax_message():
    ok = {"a": torch.ones(3), "b": (np.ones(2), 1.0)}
    assert OBS.check_finite(ok, name="ok") is ok
    bad_t = {"z": torch.tensor([1.0, float("nan"), float("inf")]),
             "a": (torch.ones(2), torch.zeros(2, 2))}
    bad_j = {"z": jnp.array([1.0, np.nan, np.inf]),
             "a": (jnp.ones(2), jnp.zeros((2, 2)))}
    with pytest.raises(ValueError) as got:
        OBS.check_finite(bad_t, name="bad")
    with pytest.raises(ValueError) as want:
        JOBS.check_finite(bad_j, name="bad")
    assert str(got.value) == str(want.value)
    assert "leaf 2 has 2 non-finite values (shape (3,))" in str(got.value)
    # the containers flatten in the JAX package's order
    cat = Catalog({"y": torch.ones(2), "x": torch.tensor([0.0, np.nan])})
    with pytest.raises(ValueError, match="leaf 0 has 1 non-finite"):
        OBS.check_finite(cat)


def test_enable_nan_checks_turns_on_anomaly_mode():
    try:
        OBS.enable_nan_checks(True)
        assert torch.is_anomaly_enabled()
        assert torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([0.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x * 0.0).div(x).sum().backward()
    finally:
        OBS.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_log_compile_cache_is_not_ported():
    assert "log_compile_cache" in JOBS.__all__
    assert not hasattr(OBS, "log_compile_cache")
