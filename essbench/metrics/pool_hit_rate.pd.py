"""Share of the selected rows the decode rounds found in the device pool:
ServeReport hit rows over hit rows plus rows read from the host tier,
differences over the window (percent)."""

SOURCE = "program_counter"


def read(run, ctx):
    h, m = run.counters.get("hit_rows", 0), run.counters.get("h2d_rows", 0)
    return 100.0 * h / (h + m) if h + m else None
