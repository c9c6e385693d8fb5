"""K2 (`csrc/paint_windowed.cu`) calls a simulation of the PM: the
program's launch counter `paint_cuda.LAUNCHES["paint_windowed"]` over
the traced window, over the units in it."""


def read(ctx):
    if ctx.trace is None or not ctx.n_units:
        return None
    return ctx.launches.get("paint_windowed", 0) / ctx.n_units
