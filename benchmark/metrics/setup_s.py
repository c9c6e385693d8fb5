"""Seconds from the start of the process to the first timed unit:
imports, the card's context, the inputs made from the seed, the
program's set-up and one untimed unit (which builds its kernels on a
checkout's first run)."""


def read(ctx):
    return ctx.setup_s
