"""Device milliseconds a pass of the matter stage's part `power.deposit`
(`ops/power.py`, `_auto_power_fast_impl`): the deposit, whichever runs
(K1, K4 or the scatter)."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "power.deposit", "suite.pass")
