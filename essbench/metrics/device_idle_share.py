"""Share of the profiled slice's wall time in which no device activity
ran: one minus the union of the kernels' and copies' intervals over the
slice (percent)."""

SOURCE = "device_trace"


def read(run, ctx):
    t = run.trace
    if t is None or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
