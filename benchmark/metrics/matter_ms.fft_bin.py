"""Device milliseconds a pass of the matter stage's part `power.fft_bin`
(`ops/power.py`, `_auto_power_fast_impl`): the folded FFT, the NGP
deconvolution and the shells (`_fold_fft_bin`)."""
from benchmark.metrics import spans


def read(ctx):
    if ctx.trace is None:
        return None
    return spans.span_ms(ctx.trace, "power.fft_bin", "suite.pass")
