"""K1's share of its byte roofline in the suite's matter stage: the
frozen bound of one call (roofline.k1_bytes at the pass's keys and fine
cells) over the device time of K1's kernels per call, from the trace.
Calls are the program's launch counter `paint_cuda.LAUNCHES
["deposit_sorted"]` over the traced window. A redesign that renames these
kernels leaves the metric empty until the list follows it."""
from benchmark.metrics import roofline

KERNELS = ("deposit_hist", "deposit_plan", "deposit_partition",
           "deposit_bounds", "deposit_zero", "deposit_accumulate")


def read(ctx):
    if ctx.trace is None:
        return None
    secs, _ = ctx.trace.kernel_seconds(KERNELS)
    bound = roofline.bound_seconds(roofline.k1_bytes(ctx.facts["k1_keys"],
                                                     ctx.facts["k1_cells"]))
    return roofline.share_pct(bound, secs,
                              ctx.launches.get("deposit_sorted", 0))
