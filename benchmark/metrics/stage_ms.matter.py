"""Milliseconds of the suite's matter stage, `run.stages["matter"]`, on the
harness's own host clock with a device sync before and after, averaged
over the traced run's stage-by-stage passes."""
STAGE = "matter"


def read(ctx):
    xs = ctx.stage_s.get(STAGE)
    return 1e3 * sum(xs) / len(xs) if xs else None
