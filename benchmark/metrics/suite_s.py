"""The whole window over the number of whole units in it (seconds a
unit); each unit ends when its outputs are on the card (a device sync)
and the window ends with the last one."""


def read(ctx):
    if ctx.trace is not None:
        return None
    return ctx.window_s / ctx.n_units
