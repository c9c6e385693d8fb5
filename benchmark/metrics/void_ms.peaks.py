"""Device milliseconds a pass of the voids stage's part `peaks.find`
(`ops/peaks.py`, `find_peaks`): the peak catalog: local maxima, the
top-k cut."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "peaks.find", "suite.pass")
