"""The tier row gathers' share of their roofline in the profiled slice:
the rows the slice read from the pinned host tier (ServeReport's tier
rows, difference over the slice) once over the host link at its peak, or
written once into device memory, whichever is longer, over the gather
kernels' device time (percent)."""

from essbench.roofline import counts as K
from essbench.trace import GATHER_NAMES, kernel_s

SOURCE = "device_trace"


def read(run, ctx):
    t = kernel_s(run.trace, GATHER_NAMES)
    rows = run.slice_counters.get("h2d_rows", 0)
    if t <= 0 or rows <= 0:
        return None
    dev, host = K.tier_gather(rows, run.counters["host_bytes_per_row"])
    return 100.0 * K.bound_s(dev, 0.0, host) / t
