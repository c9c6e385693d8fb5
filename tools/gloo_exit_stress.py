#!/usr/bin/env python3
"""Start gloo worlds of the port over and over and sort how their ranks end.

    python3 tools/gloo_exit_stress.py [--worlds 240] [--parallel 6]
        [--sizes 3,4] [--worker rings|pending] [--root DIR] [--out FILE]

Each world runs the real worker script of
tests/test_torch_distributed_rings.py (`_WORKER`, with the file's own
`_inputs()`; `--worker pending`: a short worker that leaves an
all_reduce it does not wait for at exit, see `_PENDING`), one process a
rank on the host CPU, started as the tests
start it: by `run_ranks` of tests/torch_gloo.py, or, in a checkout whose
harness has none, as its `run_world` did (OMP_NUM_THREADS=1, PYTHONPATH
the checkout, a port from `free_port()`). The worlds alternate between
the sizes given; `--parallel` of them run at once (6 matches
`pytest -n 6`). The worker, its inputs and the harness
are read from the checkout at --root (default: the one holding this
script), so the same command measures another checkout. The worker and
its inputs are pulled out of the test file by its syntax tree; neither
this script nor the workers import JAX.

Every rank runs with PYTHONFAULTHANDLER=1 and torch's C++ stack traces
on fatal signals, so an abort prints the Python and C++ frames it came
from, and its last exit handler prints how many gloo threads are still
alive as the interpreter's own teardown begins (counted as
`ranks_with_gloo_threads_at_finalize`): a gloo worker thread that frees a
tensor's Python object after that point aborts the rank. A rank fails when its exit code is not 0, when its output holds
`terminate called`, or when it did not print WORKER_OK. Each failing
world gets one signature:

  port_in_use    a rank could not bind or reach the store's port
                 (EADDRINUSE: another socket took the port between its
                 probe and rank 0's bind)
  timeout        the world did not end within --timeout seconds
  abort_at_exit  every rank printed WORKER_OK, and a rank then died
                 (nonzero code or `terminate called`)
  other          anything else

The script prints one JSON line with the counts and writes every failing
world's output to --out (default build/gloo_exit_stress.json); it
exits 1 if a world failed. A world is never retried.
"""
from __future__ import annotations

import argparse
import ast
import collections
import functools
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
RINGS = "tests/test_torch_distributed_rings.py"
# top-level names of the test file the worker and its inputs need
_NAMES = ("BOX", "COLL_SHAPE", "_WORKER", "_padded_catalog", "_inputs")
# run first by every rank: print the frames of a fatal signal, and, as
# the last exit handler (atexit runs them last in, first out), the gloo
# threads still alive when the interpreter's own teardown begins
_PROLOGUE = textwrap.dedent('''
    import atexit as _atexit
    import os as _os
    import torch as _torch
    _torch._C._set_print_stack_traces_on_fatal_signal(True)

    def _gloo_threads_left():
        names = [open("/proc/self/task/%s/comm" % t).read()
                 for t in _os.listdir("/proc/self/task")]
        print("GLOO_THREADS_AT_FINALIZE", sum("gloo" in n for n in names),
              flush=True)

    _atexit.register(_gloo_threads_left)
''')
# --worker pending: the rings worker's last collective leaves the gloo
# worker thread a few microseconds between the caller's wait and the
# work's release; this worker widens that window to an all_reduce of
# 16 MiB it does not wait for, whose tensor only the work holds
_PENDING = textwrap.dedent('''
    import sys
    rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from astrild_tpu_torch.parallel import make_mesh, multihost
    from astrild_tpu_torch.parallel.mesh import psum

    multihost.initialize("127.0.0.1:" + port, world, rank, device="cpu")
    mesh = make_mesh(world, 1, 1, device="cpu")
    assert psum(torch.ones(4), mesh, "sim").tolist() == [world] * 4
    dist.all_reduce(torch.ones(1 << 22), async_op=True)
    print("WORKER_OK", rank)
''')


def _worker_and_inputs(root: Path):
    """(`_WORKER`, `_inputs()`) of the rings test at `root`, without
    importing the file (it imports JAX)."""
    tree = ast.parse((root / RINGS).read_text())
    keep = []
    for node in tree.body:
        targets = ([t.id for t in node.targets if isinstance(t, ast.Name)]
                   if isinstance(node, ast.Assign) else
                   [getattr(node, "name", None)])
        if any(t in _NAMES for t in targets):
            keep.append(node)
    ns = {"np": np, "textwrap": textwrap}
    exec(compile(ast.Module(keep, []), str(root / RINGS), "exec"), ns)
    return ns["_WORKER"], ns["_inputs"]()


def _harness(root: Path):
    """tests/torch_gloo.py of the checkout at `root`, loaded from its
    file."""
    spec = importlib.util.spec_from_file_location(
        "torch_gloo", root / "tests" / "torch_gloo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _threads_left(out: str) -> int:
    for line in out.splitlines():
        if line.startswith("GLOO_THREADS_AT_FINALIZE"):
            return int(line.split()[1])
    return 0


def _failed(code: int, out: str) -> bool:
    return code != 0 or "terminate called" in out or "WORKER_OK" not in out


def _signature(codes, outs, timed_out) -> str | None:
    if not any(_failed(c, o) for c, o in zip(codes, outs)):
        return None
    text = "\n".join(outs)
    if "EADDRINUSE" in text or "address already in use" in text.lower():
        return "port_in_use"
    if timed_out:
        return "timeout"
    if all("WORKER_OK" in o for o in outs):
        return "abort_at_exit"
    return "other"


def _run_ranks_free_port(harness, script: Path, nranks: int, work: Path,
                         timeout: float, env: dict):
    """A world started as a harness without `run_ranks` starts it: on a
    port from `free_port()`, probed free and let go before the ranks
    start."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": str(harness.REPO), **env}
    port = harness.free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(nranks), port, str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nranks)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            try:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worlds", type=int, default=240)
    ap.add_argument("--parallel", type=int, default=6)
    ap.add_argument("--sizes", default="3,4")
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--worker", choices=("rings", "pending"),
                    default="rings")
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "gloo_exit_stress.json")
    args = ap.parse_args(argv)
    root = args.root.resolve()
    sizes = [int(s) for s in args.sizes.split(",")]
    worker, inputs = _worker_and_inputs(root)
    if args.worker == "pending":
        worker = _PENDING
    harness = _harness(root)
    run = getattr(harness, "run_ranks", None) or functools.partial(
        _run_ranks_free_port, harness)
    env = {"PYTHONFAULTHANDLER": "1"}

    counts = collections.Counter()
    failures = []
    lock = threading.Lock()
    t0 = time.monotonic()
    with tempfile.TemporaryDirectory(prefix="gloo_stress_") as tmp:
        tmp = Path(tmp)
        script = tmp / "worker.py"
        script.write_text(_PROLOGUE + worker)

        def one(i: int) -> None:
            n = sizes[i % len(sizes)]
            work = tmp / f"w{i}"
            work.mkdir()
            np.savez(work / "inputs.npz", **inputs)
            t = time.monotonic()
            ranks = run(script, n, work, args.timeout, env=env)
            timed_out = time.monotonic() - t >= args.timeout
            codes, outs = [c for c, _ in ranks], [o for _, o in ranks]
            sig = _signature(codes, outs, timed_out)
            with lock:
                counts["worlds"] += 1
                counts[f"worlds_of_{n}"] += 1
                counts["ranks"] += n
                counts["ranks_with_gloo_threads_at_finalize"] += sum(
                    _threads_left(o) > 0 for o in outs)
                if sig is not None:
                    counts[sig] += 1
                    counts["ranks_failed"] += sum(
                        _failed(c, o) for c, o in zip(codes, outs))
                    failures.append({
                        "world": i, "size": n, "signature": sig,
                        "codes": codes,
                        "outputs": outs})
            for f in work.iterdir():
                f.unlink()
            work.rmdir()

        with ThreadPoolExecutor(args.parallel) as pool:
            list(pool.map(one, range(args.worlds)))
    counts["seconds"] = round(time.monotonic() - t0, 1)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(
        {"root": str(root), "counts": counts, "failures": failures},
        indent=1))
    print(json.dumps(dict(counts)))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
