"""Device milliseconds a pass of the voids stage's part `voids.accept`
(`ops/voids.py`, `find_tunnels`): the greedy acceptance with its host
sync, and the compaction."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "voids.accept", "suite.pass")
