"""95th percentile of the time to first token of every request due in the
window, from the instant it was due to its first token's delivery; one
still waiting at the window's end counts with its wait so far (host
clock)."""

from essbench.harness import percentile

SOURCE = "host_clock"


def read(run, ctx):
    p = percentile(run.ttft_s, 95)
    return None if p is None else 1e3 * p
