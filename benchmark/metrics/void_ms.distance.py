"""Device milliseconds a pass of the voids stage's part `voids.distance`
(`ops/voids.py`, `_tunnel_candidates`): the blocked distance transform
from every pixel to the nearest peak."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "voids.distance", "suite.pass")
