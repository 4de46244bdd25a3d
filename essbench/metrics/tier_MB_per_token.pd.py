"""Megabytes read from the pinned host tier per decoded token: the
ServeReport's tier rows times the tier's bytes a row, over its decode
tokens, differences over the window."""

SOURCE = "program_counter"


def read(run, ctx):
    n = run.counters.get("decode_tokens", 0)
    if not n:
        return None
    rows = run.counters["h2d_rows"]
    return rows * run.counters["host_bytes_per_row"] / n / 1e6
