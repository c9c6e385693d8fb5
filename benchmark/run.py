"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Everything a cell needs is found by name:

  BENCHMARK.json               the cell (config, traffic) and its metrics
  benchmark/configs/<c>.json   the configuration (the entry `file`)
  benchmark/drivers/<c>.py     how the program runs one unit of work, and
                               the check against the plain reference
  benchmark/traffic/<t>.json   the traffic mix: a generator and its data
  benchmark/traffic/<g>.py     the generator
  benchmark/workloads/<w>.json the cell's settings and check limits
  benchmark/metrics/<m>.py     one reader per metric: read(ctx) -> number
                               or None; a metric <q>.<part> with no file
                               of its own is read by metrics/<q>.py

A run: make the inputs on the card from the seed, build the program and
run one unit untimed (set-up ends there), then run whole units back to
back until `--seconds` have passed; the window ends when its last unit
ends. With `--trace 1` it times the stages of a few units one by one and
profiles a few more (a short steady sub-window) instead. Then it frees
the program, checks the outputs against the plain reference and prints
one JSON line. Without a CUDA card it fails and prints nothing.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "benchmark"
FORBIDDEN = ("jax", "jaxlib", "flax", "astrild_tpu")


def _process_age() -> float:
    """Seconds since this process started (from /proc), or since this
    module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def _load(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A cell of BENCHMARK.json with every file it names, resolved."""

    def __init__(self, name: str, spec: dict | None = None):
        self.spec = spec if spec is not None else _json(ROOT /
                                                        "BENCHMARK.json")
        cells = {w["name"]: w for w in self.spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in self.spec["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(ROOT / self.config_entry["file"])
        self.traffic = _json(BENCH / "traffic" / f"{self.entry['traffic']}.json")
        self.workload = _json(BENCH / "workloads" / f"{name}.json")
        self.driver_path = BENCH / "drivers" / f"{self.entry['config']}.py"
        self.generator_path = (BENCH / "traffic"
                               / f"{self.traffic['generator']}.py")

    def metrics(self, kind: str) -> list[dict]:
        """The end_to_end or per_layer entries this cell reports."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or self.name in m["workloads"]]

    def metric_path(self, name: str) -> Path:
        own = BENCH / "metrics" / f"{name}.py"
        if own.is_file() or "." not in name:
            return own
        return BENCH / "metrics" / f"{name.split('.', 1)[0]}.py"

    def driver(self):
        return _load(self.driver_path, f"bench_driver_{self.entry['config']}")

    def generator(self):
        return _load(self.generator_path,
                     f"bench_traffic_{self.traffic['generator']}")

    def reader(self, name: str):
        return _load(self.metric_path(name),
                     "bench_metric_" + name.replace(".", "_"))


class Context:
    """What the metric readers read."""

    def __init__(self, **kw):
        self.trace = None
        self.stage_s = {}
        self.launches = {}
        self.latencies = []
        self.__dict__.update(kw)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def _forbidden_modules() -> list[str]:
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def measure(cell: Cell, seed: int, seconds: float, trace: bool, torch,
            device="cuda"):
    """Run the cell once; returns (result dict, checks)."""
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    t_start = _process_age()
    inputs = cell.generator().generate(cell.traffic, seed, device)
    sync()
    t_inputs = _process_age()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    drv = cell.driver().Driver(cell.config, cell.traffic, cell.workload,
                               inputs, device, seed)
    t_build = _process_age()
    warm = drv.unit()
    sync()
    del warm
    if trace:
        _profile(torch, lambda: torch.ones(1, device=device) + 1, sync)
    setup_s = _process_age()
    print(f"# setup_s {setup_s:.2f}: start {t_start:.2f}, inputs "
          f"{t_inputs - t_start:.2f}, program {t_build - t_inputs:.2f}, "
          f"warm unit {setup_s - t_build:.2f}", file=sys.stderr)
    ctx = Context(cell=cell.name, config=cell.config, workload=cell.workload,
                  facts=drv.facts(), setup_s=setup_s)
    if not trace:
        t_start = time.perf_counter()
        while True:
            t0 = time.perf_counter()
            out = drv.unit()
            sync()
            t1 = time.perf_counter()
            drv.keep(out)
            del out
            ctx.latencies.append(t1 - t0)
            if t1 - t_start >= seconds:
                break
        ctx.window_s = t1 - t_start
        ctx.n_units = len(ctx.latencies)
    else:
        wl = cell.workload
        if hasattr(drv, "staged_unit"):
            for _ in range(int(wl.get("staged_units", 0))):
                for k, v in drv.staged_unit(sync).items():
                    ctx.stage_s.setdefault(k, []).append(v)
        before = drv.counters()
        n = int(wl["trace_units"])

        def window():
            for _ in range(n):
                out = drv.unit()
                drv.keep(out)
                del out
        ctx.trace = _profile(torch, window, sync)
        after = drv.counters()
        ctx.launches = {k: after.get(k, 0) - before.get(k, 0) for k in after}
        ctx.n_units = n
        ctx.window_s = ctx.trace.window_s
    peak = (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell.metrics(kind):
        value = cell.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    drv.release()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = drv.check(cell.workload["limits"])
    correct = all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": ctx.n_units,
              "failed": int(failed), "metrics": metrics}
    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(0)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = ctx.trace.busy_s
        dev["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["device"] = dev
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks


def _profile(torch, fn, sync):
    """Run fn under torch.profiler inside the span the trace reader takes
    as its window; returns the parsed trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.trace import WINDOW_SPAN, Trace

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            fn()
            sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return Trace.from_file(path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    cell = Cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"# card: {_power_limit()}", file=sys.stderr)
    result, checks = measure(cell, args.seed, args.seconds, bool(args.trace),
                             torch)
    bad = _forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures the "
              f"PyTorch port only", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
