"""Share of the traced window in which no kernel, copy or memset ran on
the card, in percent. It reads every `idle_pct.<part>` (`idle_pct.suite`,
`idle_pct.pm`): the parts differ only by the end-to-end metric they
move."""


def read(ctx):
    if (ctx.trace is None or ctx.trace.window_s <= 0.0
            or ctx.trace.busy_s <= 0.0):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
