"""Output tokens the decode rounds emitted in the window, per second of it
(host clock; the window ends at a round's end)."""

SOURCE = "host_clock"


def read(run, ctx):
    n = run.counters.get("decode_tokens", 0)
    return n / run.window_s if run.window_s > 0 and n else None
