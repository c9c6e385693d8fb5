"""Device milliseconds a unit launched inside the program's root span
(`suite.pass` a pass, `pm.evolve` a simulation) but inside none of the
spans nested in it: the root's self time. It reads both parts,
`self_ms.suite` and `self_ms.pm`: the window holds the one root its
cell runs."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    root = spans.root_of(ctx.trace)
    return spans.self_ms(ctx.trace, root) if root else None
