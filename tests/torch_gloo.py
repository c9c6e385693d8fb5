"""Gloo worlds of real processes for the port's distributed tests.

`run_world` starts a worker script as one process a rank on the host CPU
(gloo), each given (rank, world size, port, work directory) on its
command line; every rank must print WORKER_OK and exit 0. `run_ranks`
starts the same world and returns each rank's exit code and output.
`replicated` reads an output that every rank must hold alike, bit for
bit.

The world's port is held from before the ranks start until they have
ended (`held_port`): a port probed free and then let go may be taken by
another socket before rank 0's store binds it, and the world's ranks
then fail, or reach another world's store.
"""
import os
import socket
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy.testing as npt

REPO = Path(__file__).resolve().parents[1]


@contextmanager
def held_port():
    """A port on 127.0.0.1 that no other socket can take while the block
    runs, except a listener that also sets SO_REUSEADDR, as the store of
    torch.distributed's TCP rendezvous does. The port is held by a socket
    bound with SO_REUSEADDR that never listens: the kernel hands it to no
    other bind and to no connect, and rank 0's store listens on it."""
    with socket.socket() as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", 0))
        yield str(s.getsockname()[1])


def run_ranks(script: Path, nranks: int, work: Path, timeout: float,
              env=None):
    """Run `script` as a gloo world of `nranks` processes; returns each
    rank's (exit code, output). A rank still running after `timeout`
    seconds is killed (code -9). No process outlives the call, and the
    world is not retried."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONFAULTHANDLER": "1",
           "PYTHONPATH": os.pathsep.join(
               [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")]
                              if p]), **(env or {})}
    with held_port() as port:
        procs = [subprocess.Popen(
            [sys.executable, str(script), str(r), str(nranks), port,
             str(work)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for r in range(nranks)]
        outs = []
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                try:
                    outs.append(p.communicate(timeout=max(
                        deadline - time.monotonic(), 1))[0])
                except subprocess.TimeoutExpired:
                    p.kill()
                    outs.append(p.communicate()[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def run_world(script: Path, nranks: int, work: Path, timeout: float):
    """Run `script` as a gloo world of `nranks` processes; every rank must
    print WORKER_OK and exit 0. The failure names each rank's exit code (a
    negative code is the signal that ended it) beside its output's tail.
    No process outlives the call."""
    ranks = run_ranks(script, nranks, work, timeout)
    if any(c != 0 or "terminate called" in o or "WORKER_OK" not in o
           for c, o in ranks):
        raise AssertionError("a rank of the gloo world failed; exit codes "
                             f"{[c for c, _ in ranks]}\n" + "\n---\n".join(
                                 f"rank {r}, exit code {c}:\n{o[-3000:]}"
                                 for r, (c, o) in enumerate(ranks)))


def replicated(outs, key):
    """A replicated output: every rank holds the same array, bit for
    bit."""
    for o in outs[1:]:
        npt.assert_array_equal(o[key], outs[0][key])
    return outs[0][key]
