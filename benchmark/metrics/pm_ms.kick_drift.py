"""Device milliseconds a KDK step of the program's spans `pm.kick` (two
a step) and `pm.drift` (one a step) in `ops/nbody.py`, from the trace
of the traced window."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = ctx.trace.span_count("pm.drift")
    kick = ctx.trace.span_device_seconds("pm.kick")
    drift = ctx.trace.span_device_seconds("pm.drift")
    if not steps or kick is None or drift is None or not ctx.trace.device:
        return None
    return 1e3 * (kick + drift) / steps
