"""Chat requests arriving on a schedule into one colocated ``EssEngine``.

Requests arrive in an open loop at ``rate`` a second: the gaps are the
quantiles of an exponential distribution of that mean, shuffled.  Prompt
lengths are log-uniform over ``prompt_len`` and output lengths uniform
over ``new_tokens``, each as a stratified set, shuffled.  Every seed runs
the same schedule (instants, sizes and their order, from
``SCHEDULE_SEED``): an open loop's tail follows which sizes meet a burst,
and a seed that reordered them would change the work, not only the data.
The seed draws the tokens and the weights.  Every request is greedy.  Before each round the driver
submits every request that has come due; a request's time to first token
runs from when it was due.

Set-up warms the decode round's graph and every prefill bucket a prompt
can end in (one short request per power of two up to the chunk).

Parameters: ``slots``, ``max_seq``, ``prefill_chunk``, ``rate``,
``prompt_len`` [lo, hi], ``new_tokens`` [lo, hi], ``slice_rounds``,
``slice_after``, ``sample`` (requests compared).
"""

from __future__ import annotations

import time

import numpy as np

from essbench.harness import Run

# the schedule's own seed: the same instants and sizes in every run
SCHEDULE_SEED = 20251


def plan(p: dict, seed_rng: np.random.Generator, n: int, vocab: int
         ) -> dict:
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / p["rate"]
    order = np.random.default_rng(SCHEDULE_SEED)
    gaps = order.permutation(gaps)
    lo, hi = p["prompt_len"]
    plen = np.floor(np.exp(np.log(lo) + (np.log(hi + 1) - np.log(lo)) * q)
                    ).astype(np.int64)
    nlo, nhi = p["new_tokens"]
    new = np.floor(nlo + (nhi - nlo + 1) * q).astype(np.int64)
    plen, new = order.permutation(plen), order.permutation(new)
    prompts = [seed_rng.integers(0, vocab, int(m), dtype=np.int64)
               for m in plen]
    return {"due": np.cumsum(gaps) - gaps[0], "prompts": prompts,
            "new": new}


def run(ctx) -> Run:
    import torch

    from repro_torch.serving.api import EssEngine, SamplingParams

    p, cfg, dev = ctx.params, ctx.cfg, ctx.device
    spans = ctx.spans
    compiled = dev.type == "cuda"
    n = int(np.ceil(p["rate"] * ctx.seconds * 1.25)) + 16
    tr = plan(p, ctx.rng(1), n, cfg.vocab_size)
    eng = EssEngine(ctx.weights, cfg, num_slots=p["slots"],
                    max_seq=p["max_seq"], prefill_chunk=p["prefill_chunk"],
                    compiled=compiled, device=dev)
    sess = eng.session
    rep = sess.report

    # -- set-up: the graph and every last-chunk bucket ---------------------
    warm = ctx.rng(3)
    C = p["prefill_chunk"]
    b = 1
    while b <= C:
        eng.submit(warm.integers(0, cfg.vocab_size, C + b).tolist(),
                   SamplingParams(max_tokens=4))
        b *= 2
    while eng.has_work():
        eng.step()
    ctx.sync()
    captures = sess.programs.captures

    run = Run()
    rid_of: dict[int, int] = {}
    outputs: dict[int, list] = {}
    first_t: dict[int, float] = {}
    ended: dict[int, str] = {}
    keys = ("decode_tokens", "rounds", "prefill_tokens")

    def snap() -> dict:
        return {k: getattr(rep, k) for k in keys}

    def work() -> tuple[list, list]:
        """The round's decode contexts and its prefill chunk, as the
        session will run them (the oldest admitting slot's next chunk)."""
        dec = [s.len + 1 for s in sess.sched.slots
               if s.active and s.phase == "decode"]
        chunks = []
        if sess._prefill:
            task = next(iter(sess._prefill.values()))
            ck = min(C, task.req.prompt_len - task.cursor)
            chunks.append((task.cursor, ck))
            if task.cursor + ck >= task.req.prompt_len:
                dec.append(task.req.prompt_len + 1)
        elif sess.sched.queue:
            r0 = sess.sched.queue[0]
            ck = min(C, r0.prompt_len)
            chunks.append((0, ck))
            if ck >= r0.prompt_len:
                dec.append(r0.prompt_len + 1)
        return dec, chunks

    def step(record: bool) -> None:
        with spans("step_round"):
            evs = eng.step()
        with spans("bookkeeping"):
            for ev in evs:
                if ev.finish_reason is not None:
                    ended[ev.rid] = ev.finish_reason
                    continue
                outputs.setdefault(ev.rid, []).append(ev.token)
                if ev.index == 0:
                    first_t[ev.rid] = ev.t
                if record:
                    run.tokens.append((ev.rid, ev.index, ev.t))

    # -- the window ----------------------------------------------------------
    c0 = snap()
    run.t_window = t0 = time.perf_counter()
    nxt, r, late = 0, 0, 0.0
    while True:
        now = time.perf_counter()
        if now - t0 >= ctx.seconds:
            break
        with spans("submit"):
            while nxt < n and t0 + tr["due"][nxt] <= now:
                late = max(late, now - (t0 + tr["due"][nxt]))
                rid = eng.submit(tr["prompts"][nxt].tolist(),
                                 SamplingParams(max_tokens=int(tr["new"][nxt])))
                rid_of[rid] = nxt
                run.due[rid] = t0 + tr["due"][nxt]
                nxt += 1
        if nxt >= n:
            raise RuntimeError(f"the plan's {n} requests ran out")
        if not eng.has_work():
            time.sleep(max(0.0, min(t0 + tr["due"][nxt], t0 + ctx.seconds)
                           - time.perf_counter()))
            continue
        if ctx.trace and r == p["slice_after"]:
            from essbench.trace import Slice
            sl = Slice(dev, ctx.sync)
            with sl:
                for _ in range(p["slice_rounds"]):
                    run.slice_work.append(work())
                    step(True)
            run.trace = sl
            r += p["slice_rounds"]
            continue
        step(True)
        r += 1
    ctx.sync()
    t_end = time.perf_counter()
    run.window_s = t_end - t0
    run.counters = {k: v - c0[k] for k, v in snap().items()}
    if sess.programs.captures != captures:
        raise RuntimeError("a round variant was captured inside the window")
    # time to first token of every request due in the window; one still
    # waiting counts with its wait so far
    run.ttft_s = [first_t.get(rid, t_end) - d for rid, d in run.due.items()]
    run.ttft_rounds = [rep.ttft_rounds[rid] for rid in run.due
                       if rid in rep.ttft_rounds]
    run.attempted = len(run.due)
    run.failed = sum(1 for rid in run.due
                     if ended.get(rid, "length") not in ("length", "stop"))
    run.notes.update(rounds=r, submitted=nxt, waiting_at_end=len(
        sess.sched.queue), generator_late_s=late)
    run.memory_peak = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0

    # -- what the check compares: requests the window finished -------------
    fin = sorted((rid for rid in run.due if rid in ended),
                 key=lambda rid: (-len(outputs[rid]) - len(
                     tr["prompts"][rid_of[rid]]), rid))
    chosen = (fin[:1] + [fin[1:][i] for i in ctx.rng(2).permutation(
        max(0, len(fin) - 1))])[:p["sample"]]
    run.samples = [(tr["prompts"][rid_of[rid]], outputs[rid])
                   for rid in chosen]
    run.notes.update(finished=len(fin), compared_rids=chosen)
    del eng, sess
    return run
