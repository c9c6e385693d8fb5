"""Device milliseconds a pass of the work the suite's bispectrum stage
launches: the program's span `suite.bispectrum` (`suite.py`) in the
traced window."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "suite.bispectrum", "suite.pass")
