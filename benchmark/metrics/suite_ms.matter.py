"""Device milliseconds a pass of the work the suite's matter stage
launches: the program's span `suite.matter` (`suite.py`) in the traced
window."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "suite.matter", "suite.pass")
