"""Device milliseconds a pass of the work the suite's lensing stage
launches: the program's span `suite.lensing` (`suite.py`) in the traced
window."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "suite.lensing", "suite.pass")
