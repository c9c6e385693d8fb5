"""K2's share of its byte roofline in the PM's force paints: the frozen
bound of one CIC paint (roofline.k2_bytes at the particles and mesh
cells) over the device time of K2's kernels per call, from the trace.
Calls are the program's launch counter `paint_cuda.LAUNCHES
["paint_windowed"]` over the traced window. A redesign that renames these
kernels leaves the metric empty until the list follows it."""
from benchmark.metrics import roofline

KERNELS = ("paint_windowed_bin", "paint_windowed_scan",
           "paint_windowed_scatter", "paint_windowed_deposit")


def read(ctx):
    if ctx.trace is None:
        return None
    secs, _ = ctx.trace.kernel_seconds(KERNELS)
    bound = roofline.bound_seconds(roofline.k2_bytes(
        ctx.facts["k2_particles"], ctx.facts["k2_cells"]))
    return roofline.share_pct(bound, secs,
                              ctx.launches.get("paint_windowed", 0))
