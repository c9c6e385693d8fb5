"""Milliseconds a pass in which the host was inside the suite's lensing
stage (the program's span `suite.lensing`) and the card ran nothing: the
card's idle time put down to the stage that left it idle."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.idle_ms(ctx.trace, "suite.lensing", "suite.pass")
