"""Milliseconds a pass in which the host was inside the suite's matter
stage (the program's span `suite.matter`) and the card ran nothing: the
card's idle time put down to the stage that left it idle."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.idle_ms(ctx.trace, "suite.matter", "suite.pass")
