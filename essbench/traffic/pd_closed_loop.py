"""A PD decode worker under a closed loop of copies of prefilled contexts.

Set-up: one ``PrefillWorker`` prefills ``contexts`` distinct prompts and
packs each into a ``MigrationPacket``.  Their lengths are the midpoints of
``contexts`` equal strata of ``prompt_len``; the tokens are the seed's.

Window: one ``DecodeWorker`` (graph rounds) with ``concurrency`` slots,
every slot busy: whenever a request ends, the next one is installed before
the next round.  Request ``j`` is a copy of context ``j % contexts`` with a
fresh rid; its output length comes from the stratified set of
``new_tokens`` (each block of ``concurrency`` requests holds the same
values, shuffled); every ``greedy_every``-th block of
``contexts`` requests is greedy, the rest sample at ``temperature`` with a
seed of their own, so the copies of one context diverge.  The greedy
requests the window finished are what the check compares.

Every seed runs the same schedule (lengths and their order, from
``ORDER_SEED``); the seed draws the tokens, the weights and the sampling
seeds, so runs differ only in the data, not in the amount of work.

Parameters: ``contexts``, ``prompt_len`` [lo, hi], ``concurrency``,
``new_tokens`` [lo, hi], ``temperature``, ``greedy_every``,
``prefill_slots``, ``prefill_chunk``, ``max_seq``, ``warm_rounds``,
``slice_rounds``, ``slice_after``, ``sample`` (greedy requests compared).
"""

from __future__ import annotations

import dataclasses
import gc
import time

import numpy as np

from essbench.harness import Run

# the schedule's own seed: the same sizes in the same order for every run
ORDER_SEED = 20252


def stratified(lo: int, hi: int, n: int) -> np.ndarray:
    """``n`` values spread evenly over ``[lo, hi]``: each stratum's
    midpoint."""
    return np.floor(lo + (hi - lo + 1) * (np.arange(n) + 0.5) / n
                    ).astype(np.int64)


def plan(p: dict, seed_rng: np.random.Generator, n_requests: int,
         vocab: int) -> dict:
    """The cell's traffic: prompt lengths and tokens, and for each
    request its context, output length, greedy or not, sampling seed."""
    C, B = p["contexts"], p["concurrency"]
    order = np.random.default_rng(ORDER_SEED)
    lens = order.permutation(stratified(*p["prompt_len"], C))
    prompts = [seed_rng.integers(0, vocab, int(n), dtype=np.int64)
               for n in lens]
    blocks = -(-n_requests // B)
    new = np.concatenate([order.permutation(
        stratified(*p["new_tokens"], B)) for _ in range(blocks)])[:n_requests]
    j = np.arange(n_requests)
    greedy = (j // C) % p["greedy_every"] == 0
    seeds = seed_rng.integers(0, 2**31 - 1, n_requests)
    return {"lens": lens, "prompts": prompts, "ctx": j % C, "new": new,
            "greedy": greedy, "seeds": seeds}


def run(ctx) -> Run:
    import torch

    from repro_torch.cluster.workers import DecodeWorker, PrefillWorker
    from repro_torch.serving.scheduler import Request

    p, cfg, dev = ctx.params, ctx.cfg, ctx.device
    compiled = dev.type == "cuda"
    spans = ctx.spans
    n_req = p.get("requests", 8 * p["concurrency"] + 64)
    tr = plan(p, ctx.rng(1), n_req, cfg.vocab_size)
    C = p["contexts"]

    # -- set-up: prefill the contexts and pack them ----------------------
    prompts = {i: torch.as_tensor(tr["prompts"][i])[None]
               for i in range(C)}
    pw = PrefillWorker(ctx.weights, cfg, num_slots=p["prefill_slots"],
                       max_seq=p["max_seq"], prefill_chunk=p["prefill_chunk"],
                       prompt_fn=lambda req: prompts[req.rid],
                       compiled=compiled, device=dev)
    for i in range(C):
        pw.submit(Request(rid=i, prompt_len=int(tr["lens"][i]),
                          max_new_tokens=int(p["new_tokens"][1])))
    packets = {}
    while len(packets) < C:
        _, pk = pw.step()
        packets.update({q.rid: q for q in pk})
    del pw
    gc.collect()
    dw = DecodeWorker(ctx.weights, cfg, num_slots=p["concurrency"],
                      max_seq=p["max_seq"], compiled=compiled, device=dev)
    sess = dw.session
    rep = sess.report

    run = Run()
    greedy_rids: dict[int, int] = {}          # rid -> context
    nxt = [0]

    def install() -> None:
        j = nxt[0]
        nxt[0] += 1
        if j >= n_req:
            raise RuntimeError(f"the plan's {n_req} requests ran out")
        pk = packets[int(tr["ctx"][j])]
        g = bool(tr["greedy"][j])
        req = Request(rid=C + j, prompt_len=pk.prompt_len,
                      max_new_tokens=int(tr["new"][j]),
                      temperature=0.0 if g else float(p["temperature"]),
                      seed=int(tr["seeds"][j]))
        if g:
            greedy_rids[req.rid] = int(tr["ctx"][j])
        with spans("install"):
            dw.install(dataclasses.replace(pk, rid=req.rid, req=req,
                                           submit_time=None))

    outputs: dict[int, list] = {}
    done: set[int] = set()

    def step(record: bool) -> int:
        """One round; returns the requests it ended."""
        with spans("step_round"):
            evs = dw.step()
        ended = 0
        with spans("bookkeeping"):
            for ev in evs:
                if ev.finish_reason is not None:
                    ended += 1
                    done.add(ev.rid)
                    if ev.finish_reason not in ("length", "stop"):
                        run.failed += record
                    continue
                outputs.setdefault(ev.rid, []).append(ev.token)
                if record:
                    run.tokens.append((ev.rid, ev.index, ev.t))
            for _ in range(ended):
                install()
        return ended

    def contexts() -> list[int]:
        return [s.len + 1 for s in sess.sched.slots
                if s.active and s.phase == "decode"]

    for _ in range(p["concurrency"]):
        install()
    for _ in range(p["warm_rounds"]):
        step(False)
    ctx.sync()
    captures = sess.programs.captures
    keys = ("decode_tokens", "rounds", "hit_rows", "h2d_rows")

    def snap() -> dict:
        return {k: getattr(rep, k) for k in keys}

    # -- the window --------------------------------------------------------
    live_at_start = {s.rid for s in sess.sched.slots if s.active}
    c0 = snap()
    installed0 = nxt[0]
    run.t_window = t0 = time.perf_counter()
    r = 0
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and r == p["slice_after"]:
            from essbench.trace import Slice
            sl = Slice(dev, ctx.sync)
            s0 = snap()
            with sl:
                for _ in range(p["slice_rounds"]):
                    run.slice_work.append((contexts(), []))
                    step(True)
            run.trace = sl
            run.slice_counters = {k: v - s0[k] for k, v in snap().items()}
            r += p["slice_rounds"]
            continue
        step(True)
        r += 1
    ctx.sync()
    run.window_s = time.perf_counter() - t0
    run.counters = {k: v - c0[k] for k, v in snap().items()}
    run.counters["host_bytes_per_row"] = rep.host_bytes_per_row
    run.notes.update(rounds=r, installs=nxt[0] - installed0,
                     captures_in_window=sess.programs.captures - captures)
    if sess.programs.captures != captures:
        raise RuntimeError("a round variant was captured inside the window")
    run.attempted = len(live_at_start) + nxt[0] - installed0
    run.memory_peak = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0

    # -- what the check compares: greedy requests the window finished ----
    fin = sorted((rid for rid in greedy_rids if rid in done),
                 key=lambda rid: (-len(outputs[rid]), rid))
    chosen = (fin[:1] + [fin[1:][i] for i in ctx.rng(2).permutation(
        max(0, len(fin) - 1))])[:p["sample"]]
    run.samples = [(tr["prompts"][greedy_rids[rid]], outputs[rid])
                   for rid in chosen]
    run.notes.update(greedy_finished=len(fin), compared_rids=chosen)
    del dw, sess, packets
    return run
