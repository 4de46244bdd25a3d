"""The whole step's share of the card's bf16 peak over the profiled slice:
the FLOPs the model's equations need for every token the slice's rounds
computed (each at its own context; prefill chunks' tokens included where
the rounds carry them), over the slice's wall time times 989 TFLOP/s
(percent)."""

from essbench.roofline import counts as K

SOURCE = "device_trace"


def read(run, ctx):
    t = run.trace
    if t is None or t["busy_s"] <= 0 or not run.slice_work:
        return None
    f = K.work_flops(run.slice_work, ctx.conf)
    return 100.0 * f / (t["window_s"] * K.PEAK_BF16_FLOPS) if f else None
