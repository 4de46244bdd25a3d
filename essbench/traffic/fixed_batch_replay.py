"""A fixed batch through the generic (monolithic) path, replayed.

Set-up: ``batch`` prompts of ``prompt_len`` tokens (the seed's tokens)
through ``generic_prefill`` in groups of ``prefill_group``, the first
token of each taken greedily from the prefill's last position, the caches
padded to ``prompt_len + new_tokens`` and joined into one batch.  One
``generic_decode`` step plus an on-device argmax is captured as a CUDA
graph (two eager steps first).

Window: the graph replayed round after round, every row greedy; one
generation is ``new_tokens`` rounds, after which the batch starts again
from its prompts' caches (``lens`` rewound, the first token fed again): a
fixed set of long-context requests replayed.  A round's tokens are
delivered when the host sees it end.  The last whole generation's tokens
of ``sample`` rows, one drawn from the seed in each of ``sample`` equal
blocks of the batch, are what the check compares.

Parameters: ``batch``, ``prompt_len``, ``new_tokens``, ``prefill_group``,
``slice_rounds``, ``slice_after``, ``sample``.
"""

from __future__ import annotations

import time

import numpy as np

from essbench.harness import Run


def run(ctx) -> Run:
    import torch

    from repro_torch.models import layers as L
    from repro_torch.serving import engine as E

    p, cfg, dev = ctx.params, ctx.cfg, ctx.device
    spans = ctx.spans
    B, S, new, G = (p["batch"], p["prompt_len"], p["new_tokens"],
                    p["prefill_group"])
    max_seq = S + new
    prompts = ctx.rng(1).integers(0, cfg.vocab_size, (B, S), dtype=np.int64)
    toks = torch.as_tensor(prompts, device=dev)
    pos = torch.arange(S, device=dev)[None].expand(G, S)

    # -- set-up: prefill in groups, one batch cache ---------------------------
    caches, first = None, torch.empty((B, 1), dtype=torch.int64, device=dev)
    for g0 in range(0, B, G):
        pf = E.generic_prefill(ctx.weights, cfg, toks[g0:g0 + G], pos,
                               device=dev, want_logits=False)
        w = ctx.weights.get("unembed", ctx.weights["embed"])
        first[g0:g0 + G, 0] = L.unembed(w, pf.hidden[:, -1]).argmax(-1)
        key = next(k for k in pf.caches if k != "lens")
        planes = pf.caches[key]
        if caches is None:
            caches = {key: type(planes)(*(
                torch.zeros((a.shape[0], B, max_seq) + tuple(a.shape[3:]),
                            dtype=a.dtype, device=dev) for a in planes)),
                "lens": torch.full((B,), S, dtype=torch.int64, device=dev)}
        for dst, src in zip(caches[key], planes):
            dst[:, g0:g0 + G, :S].copy_(src)
        del pf, planes
    x = first.clone()
    lens = caches["lens"]

    def step():
        out = E.generic_decode(ctx.weights, cfg, x, lens[:, None], caches,
                               device=dev)
        x.copy_(out.logits[:, -1].argmax(-1, keepdim=True))

    def rewind():
        lens.fill_(S)
        x.copy_(first)

    for _ in range(2):
        step()
    graph = None
    if dev.type == "cuda":
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="relaxed")
            try:
                step()
            finally:
                graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        replay = graph.replay
    else:
        replay = step
    rewind()
    gen = torch.empty((new + 1, B), dtype=torch.int64, device=dev)
    gen[0].copy_(first[:, 0])
    ctx.sync()

    run = Run()
    last_gen = None
    n_gen = [0]

    def round_(i: int, record: bool) -> None:
        with spans("generic_decode"):
            replay()
        with spans("bookkeeping"):
            gen[i].copy_(x[:, 0])
        with spans("sync"):
            ctx.sync()
        t = time.perf_counter()
        if record:
            base = n_gen[0] * B
            run.tokens.extend((base + b, i, t) for b in range(B))

    # -- the window ----------------------------------------------------------
    run.t_window = t0 = time.perf_counter()
    run.tokens.extend((b, 0, t0) for b in range(B))
    i, r = 1, 0
    while time.perf_counter() - t0 < ctx.seconds:
        if ctx.trace and r == p["slice_after"] and i + p["slice_rounds"] <= new:
            from essbench.trace import Slice
            sl = Slice(dev, ctx.sync)
            with sl:
                for _ in range(p["slice_rounds"]):
                    run.slice_work.append(([S + i] * B, []))
                    round_(i, True)
                    i += 1
            run.trace = sl
            r += p["slice_rounds"]
            continue
        if ctx.trace and r == p["slice_after"]:
            p = {**p, "slice_after": p["slice_after"] + 1}
        round_(i, True)
        i += 1
        r += 1
        if i > new:
            last_gen = gen.cpu().numpy().T.copy()
            n_gen[0] += 1
            with spans("bookkeeping"):
                rewind()
                i = 1
            t = time.perf_counter()
            run.tokens.extend((n_gen[0] * B + b, 0, t) for b in range(B))
    ctx.sync()
    run.window_s = time.perf_counter() - t0
    run.counters = {"rounds": r, "decode_tokens": r * B}
    run.attempted = (n_gen[0] + (i > 1)) * B
    run.notes.update(rounds=r, generations=n_gen[0])
    run.memory_peak = torch.cuda.max_memory_allocated() \
        if dev.type == "cuda" else 0
    if last_gen is None:                  # a window shorter than a generation
        last_gen = gen[:i].cpu().numpy().T.copy()
    # one row drawn from each of ``sample`` equal blocks of the batch
    blocks = np.array_split(np.arange(B), p["sample"])
    g = ctx.rng(2)
    rows = [int(g.choice(b)) for b in blocks if len(b)]
    run.samples = [(prompts[b], last_gen[b].tolist()) for b in sorted(rows)]
    run.notes.update(compared_rows=sorted(int(b) for b in rows))
    del graph, caches
    return run
