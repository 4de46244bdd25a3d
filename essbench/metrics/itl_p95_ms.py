"""95th percentile of every inter-token gap in the window, over all
requests: the difference of the delivery stamps of a request's tokens
``i`` and ``i + 1``, both delivered inside the window (host clock)."""

from essbench.harness import percentile

SOURCE = "host_clock"


def gaps_s(tokens) -> list[float]:
    last: dict = {}
    out = []
    for rid, index, t in sorted(tokens, key=lambda e: (e[0], e[1])):
        prev = last.get(rid)
        if prev is not None and prev[0] == index - 1:
            out.append(t - prev[1])
        last[rid] = (index, t)
    return out


def read(run, ctx):
    p = percentile(gaps_s(run.tokens), 95)
    return None if p is None else 1e3 * p
