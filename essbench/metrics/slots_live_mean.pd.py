"""Mean live slots a decode round: the ServeReport's decode tokens over its
rounds, both as differences over the window (the scheduler's batch)."""

SOURCE = "program_counter"


def read(run, ctx):
    r = run.counters.get("rounds", 0)
    return run.counters["decode_tokens"] / r if r else None
