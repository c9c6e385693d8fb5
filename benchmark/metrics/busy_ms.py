"""Device-busy milliseconds per unit of work: the seconds of the traced
window in which a kernel, copy or memset ran on the card, over the units
in it. Steadier than the host-clock end-to-end metric it moves, whose
spread comes from the host (the device time repeats to ~0.1% between
runs). It reads every `busy_ms.<part>` (`busy_ms.suite`, `busy_ms.pm`):
the parts differ only by the end-to-end metric they move."""


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0.0 or not ctx.n_units:
        return None
    return 1e3 * ctx.trace.busy_s / ctx.n_units
