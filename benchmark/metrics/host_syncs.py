"""Blocking CUDA runtime calls a unit (`cudaStreamSynchronize`,
`cudaDeviceSynchronize`, `cudaEventSynchronize`, synchronous
`cudaMemcpy`) made inside the program's root span, from the trace of
the traced window. It reads both parts, `host_syncs.suite` and
`host_syncs.pm`: the window holds the one root its cell runs."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    root = spans.root_of(ctx.trace)
    return spans.host_syncs(ctx.trace, root) if root else None
