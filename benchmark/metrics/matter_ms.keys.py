"""Device milliseconds a pass of the matter stage's part `power.keys`
(`ops/power.py`, `_auto_power_fast_impl`): the fine-grid NGP keys
(`_fast_keys`)."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "power.keys", "suite.pass")
