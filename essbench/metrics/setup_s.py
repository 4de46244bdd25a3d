"""Seconds from the process's start to the window's first timed token:
imports, the kernels' build or load, the weights, the prefill and
packing the cell needs, the serving objects, warm-up and graph captures
(host clock)."""

SOURCE = "host_clock"


def read(run, ctx):
    return run.t_window - ctx.t_start
