"""Device milliseconds a pass of the voids stage's part
`voids.candidates` (`ops/voids.py`, `_tunnel_candidates`): the distance
transform's local maxima and their top-k cut."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "voids.candidates", "suite.pass")
