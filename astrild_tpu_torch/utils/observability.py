"""Observability: structured logging, stage timers, torch.profiler hooks.

Port of astrild_tpu/utils/observability.py: a structured logger, a `stage`
context manager that wall-clocks pipeline stages (synchronizing the CUDA
devices of the tensors it is given, so timings are honest under
asynchronous launches), a `torch.profiler` trace context, and the
fault-detection pair `enable_nan_checks` / `check_finite`.

The JAX package's `log_compile_cache` (JAX's persistent compilation
cache) has no twin: the port's kernels are built once per source hash
(`_ext.py`).
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import sys
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from .._device import as_host
from ..core.checkpoint import _flatten

__all__ = ["get_logger", "stage", "StageTimes", "trace",
           "enable_nan_checks", "check_finite"]

_LOGGER_NAME = "astrild_tpu_torch"


def get_logger(level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class StageTimes:
    """Accumulates per-stage wall-clock times; printable as one JSON line."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    def add(self, name: str, dt: float):
        self.times[name] = self.times.get(name, 0.0) + dt

    def as_json(self) -> str:
        return json.dumps({k: round(v, 4) for k, v in self.times.items()})


_GLOBAL_STAGES = StageTimes()


def _synchronize(tree) -> None:
    """Wait for the CUDA devices that hold the tensors of `tree` (a
    tensor or a nested dict / tuple / list / container of them); CPU
    tensors and other leaves need nothing."""
    devices = {x.device for x in _flatten(tree)
               if isinstance(x, torch.Tensor) and x.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def stage(name: str, sync=None, collector: Optional[StageTimes] = None,
          log: bool = True):
    """Wall-clock a pipeline stage.

    sync: optional tensor (or nested structure of tensors) whose CUDA
    devices are synchronized before the clock stops; the yielded dict
    takes it as holder["sync"] for outputs made inside the block (required
    for honest numbers: CUDA launches return before the work is done).
    """
    logger = get_logger()
    t0 = time.perf_counter()
    holder = {}
    try:
        yield holder
    finally:
        _synchronize(holder["sync"] if "sync" in holder else sync)
        dt = time.perf_counter() - t0
        (collector or _GLOBAL_STAGES).add(name, dt)
        if log:
            logger.info("stage %s: %.3f s", name, dt)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """torch.profiler trace context: CPU activity, and the CUDA kernels
    when a card is there, written on exit as a Chrome trace
    (`<worker>.<ms>.pt.trace.json`, readable by TensorBoard and
    chrome://tracing) under log_dir (by default a folder in the temporary
    directory). Yields log_dir."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(),
                               "astrild_tpu_torch_trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def enable_nan_checks(enable: bool = True):
    """Debug mode: raise where autograd's backward pass produces NaN
    (`torch.autograd.set_detect_anomaly(enable, check_nan=True)`).

    The JAX package's twin sets `jax_debug_nans`, which checks every
    jitted operation's forward output; torch has no such switch, so this
    checks the backward pass only. `check_finite` checks forward results.
    """
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


def check_finite(tree, name: str = "result"):
    """Raise ValueError when any leaf holds non-finite values (a host
    copy of each tensor leaf; the leaves in the JAX package's pytree
    order, so the message names the same leaf)."""
    for i, leaf in enumerate(_flatten(tree)):
        arr = as_host(leaf)
        if not np.all(np.isfinite(arr)):
            bad = int(np.sum(~np.isfinite(arr)))
            raise ValueError(
                f"{name}: leaf {i} has {bad} non-finite values "
                f"(shape {arr.shape})")
    return tree
