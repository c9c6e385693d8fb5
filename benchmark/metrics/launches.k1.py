"""K1 (`csrc/deposit_sorted.cu`) calls a pass of the suite: the
program's launch counter `paint_cuda.LAUNCHES["deposit_sorted"]` over
the traced window, over the units in it."""


def read(ctx):
    if ctx.trace is None or not ctx.n_units:
        return None
    return ctx.launches.get("deposit_sorted", 0) / ctx.n_units
