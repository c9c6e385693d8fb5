"""Gloo worlds of real processes for the port's distributed tests.

`run_world` starts a worker script as one process a rank on the host CPU
(gloo), each given (rank, world size, port, work directory) on its
command line; every rank must print WORKER_OK. `replicated` reads an
output that every rank must hold alike, bit for bit.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy.testing as npt

REPO = Path(__file__).resolve().parents[1]


def free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_world(script: Path, nranks: int, work: Path, timeout: float):
    """Run `script` as a gloo world of `nranks` processes; every rank must
    print WORKER_OK. No process outlives the call."""
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p])}
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(nranks), port, str(work)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(nranks)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    if any(p.returncode for p in procs) or not all(
            "WORKER_OK" in o for o in outs):
        raise AssertionError("\n---\n".join(o[-3000:] for o in outs))


def replicated(outs, key):
    """A replicated output: every rank holds the same array, bit for
    bit."""
    for o in outs[1:]:
        npt.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]
