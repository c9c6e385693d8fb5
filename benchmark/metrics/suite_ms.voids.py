"""Device milliseconds a pass of the work the suite's voids stage
launches: the program's span `suite.voids` (`suite.py`) in the traced
window."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "suite.voids", "suite.pass")
