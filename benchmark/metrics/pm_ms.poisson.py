"""Device milliseconds per force evaluation in the program's span
`pm.poisson` (`ops/nbody.py`), from the trace of the traced window."""
SPAN = "pm.poisson"


def read(ctx):
    if ctx.trace is None:
        return None
    secs = ctx.trace.span_device_seconds(SPAN)
    n = ctx.trace.span_count(SPAN)
    return 1e3 * secs / n if secs and n else None
