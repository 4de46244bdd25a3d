"""Serve synthetic prompts through the ESS path.

Builds random weights from ``--seed`` on the device and synthetic prompts
from the same seed with numpy, then serves them through the public
:class:`repro_torch.serving.api.EssEngine` (``generate``) over the
continuous-batching :class:`repro_torch.serving.engine.ServeSession`
(one decode slot per request, the decode round replayed as a CUDA graph
on the card and run eagerly on the CPU), or, with ``--fixed-batch``, as
one fixed batch through :func:`repro_torch.serving.engine.generate_batch`
(with its LRU-warmup replay).  Prints
tokens/s, ms per decode round, the pool hit rate, the miss rows and bytes
per round and the host tier's bytes.  ``--layers`` cuts the depth (widths
stay) and drops the MTP modules unless ``--mtp-depth`` asks for them;
``--host-cache-dtype`` stores the tier as bf16 (the param dtype), int8 or
fp8 with one f16 scale per row.  The session takes the reference
launcher's knobs: ``--mtp-depth`` (MTP speculative rounds), ``--tbo``
(Two-Batch Overlap: each step's slots in two halves on two streams),
``--temperature`` / ``--top-k`` / ``--top-p`` (sampled requests, seeded
per request), ``--stop-token``, ``--slots``, ``--max-seq`` and ``--eager``
(the rounds run eagerly instead of as CUDA graphs).  The layers' overlap
mode is the config's ``ess.overlap``: pass ``run(args, cfg=...)`` a config
with ``overlap="dba"`` (the reference's launcher has no flag for it).

  python -m repro_torch.launch.serve --device cuda \\
      --arch deepseek-v32-exp-ess --layers 4 --requests 4 \\
      --prompt-len 8192 --new-tokens 32 --prefill-chunk 256
  python -m repro_torch.launch.serve --device cpu   # smoke config
  python -m repro_torch.launch.serve --device cpu --host-cache-dtype int8
  python -m repro_torch.launch.serve --device cpu --fixed-batch
  python -m repro_torch.launch.serve --device cpu --mtp-depth 1 \\
      --temperature 0.8 --top-k 16
  python -m repro_torch.launch.serve --device cpu --tbo
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import cut_depth, get_config
from repro_torch.models.params import init_params
from repro_torch.cache import latent_cache as LC
from repro_torch.serving.api import EssEngine, SamplingParams
from repro_torch.serving.engine import generate_batch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v32-exp-ess-smoke")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut num_layers to this depth (MTP kept only "
                         "with --mtp-depth)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--host-cache-dtype", default="bf16",
                    choices=["bf16", "int8", "fp8"],
                    help="host tier storage: bf16, or int8 / fp8 (e4m3) "
                         "with a per-row f16 scale")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--fixed-batch", action="store_true",
                    help="serve the prompts as one fixed batch "
                         "(generate_batch, greedy, Q = 1) instead of the "
                         "session")
    ap.add_argument("--slots", type=int, default=None,
                    help="decode slots of the session (default: one per "
                         "request)")
    ap.add_argument("--max-seq", type=int, default=None,
                    help="per-slot cache length (default: prompt + new)")
    ap.add_argument("--mtp-depth", type=int, default=0,
                    help="MTP draft depth of the session's speculative "
                         "rounds (0: Q = 1 rounds)")
    ap.add_argument("--tbo", action="store_true",
                    help="Two-Batch Overlap: each decode / verify step "
                         "steps its slots in two halves")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="> 0 samples every request (0: greedy)")
    ap.add_argument("--top-k", type=int, default=None)
    ap.add_argument("--top-p", type=float, default=None)
    ap.add_argument("--stop-token", type=int, default=None,
                    help="end a stream early at this token id")
    ap.add_argument("--eager", action="store_true",
                    help="run the session's rounds eagerly, not as CUDA "
                         "graphs")
    return ap


def config_from_args(args):
    """The architecture config that ``args`` select (depth cut, tier)."""
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = cut_depth(cfg, args.layers, keep_mtp=args.mtp_depth > 0)
    if args.mtp_depth > cfg.mtp_depth:
        cfg = dataclasses.replace(cfg, mtp_depth=args.mtp_depth)
    return dataclasses.replace(cfg, ess=dataclasses.replace(
        cfg.ess, host_cache_dtype=args.host_cache_dtype))


def run(args, params=None, cfg=None) -> dict:
    """Serve once; returns the result and its metrics.  ``params`` reuses
    weights already on the device (they must match ``args``' config and
    seed); without them the weights are drawn from ``--seed``.  ``cfg``
    replaces :func:`config_from_args`' config (e.g. another overlap
    mode)."""
    dev = resolve_device(args.device)
    cfg = config_from_args(args) if cfg is None else cfg
    if args.fixed_batch and (args.mtp_depth or args.temperature > 0
                             or args.tbo):
        raise ValueError("--fixed-batch serves greedy Q = 1 rounds: "
                         "--mtp-depth, --temperature and --tbo need the "
                         "session")
    max_seq = args.max_seq or args.prompt_len + args.new_tokens
    t0 = time.perf_counter()
    if params is None:
        params = init_params(cfg, args.seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           (args.requests, args.prompt_len), dtype=np.int64)
    if not args.fixed_batch:
        return _run_session(args, cfg, params, prompts, max_seq, dev,
                            init_s)
    res = generate_batch(params, cfg, prompts, args.new_tokens, max_seq,
                         prefill_chunk=args.prefill_chunk, device=dev)
    rounds = len(res.round_s)
    decode_s = float(sum(res.round_s))
    hits, misses = int(res.hits.sum()), int(res.misses.sum())
    return {
        "cfg": cfg, "params": params, "result": res, "init_s": init_s,
        "prefill_s": res.prefill_s,
        "prefill_tok_s": args.requests * args.prompt_len / res.prefill_s,
        "decode_rounds": rounds,
        "decode_ms_per_round": 1e3 * decode_s / max(rounds, 1),
        "decode_tok_s": args.requests * rounds / decode_s if rounds else 0.0,
        "pool_hit_rate": hits / max(hits + misses, 1),
        "miss_rows_per_round": misses / max(rounds, 1),
        "overflow_rows": int(res.overflow.sum()),
        "evicted": res.evicted,
        "tier_bytes": res.tier_bytes,
        "miss_bytes_per_round": float(res.miss_bytes.sum()) / max(rounds, 1),
    }


def _run_session(args, cfg, params, prompts, max_seq, dev, init_s) -> dict:
    engine = EssEngine(
        params, cfg, num_slots=args.slots or args.requests, max_seq=max_seq,
        prompt_fn=lambda req: prompts[req.rid][None],
        prefill_chunk=args.prefill_chunk, mtp_depth=args.mtp_depth,
        tbo=args.tbo, compiled=dev.type == "cuda" and not args.eager,
        device=dev)
    sp = SamplingParams(
        max_tokens=args.new_tokens, temperature=args.temperature,
        top_k=args.top_k, top_p=args.top_p,
        stop_token_ids=() if args.stop_token is None
        else (args.stop_token,))
    outs = engine.generate([args.prompt_len] * args.requests, sp,
                           max_rounds=1 << 30)
    session = engine.session
    rep = session.report
    rep.finished_rids = [r.rid for r in session.sched.finished]
    rep.admissions_blocked = session.sched.blocked_admissions
    steady = rep.rounds - rep.fill_rounds
    return {
        "cfg": cfg, "params": params, "engine": engine, "outputs": outs,
        "session": session, "report": rep, "metrics": engine.metrics(),
        "init_s": init_s, "decode_rounds": rep.rounds,
        "decode_ms_per_round": 1e3 / rep.rounds_per_s if steady else 0.0,
        "decode_tok_s": rep.tokens_per_s,
        "pool_hit_rate": rep.pool_hit_rate,
        "miss_rows_per_round": rep.h2d_rows / max(rep.rounds, 1),
        "tier_bytes": LC.tier_nbytes(session.caches),
        "miss_bytes_per_round": rep.h2d_bytes / max(rep.rounds, 1),
    }


def report(out: dict) -> str:
    if "session" in out:
        rep = out["report"]
        return (f"session: {len(rep.finished_rids)} requests, "
                f"{rep.prefill_tokens} prompt tokens in "
                f"{rep.prefill_chunks} chunks, {rep.decode_tokens} decode "
                f"tokens in {rep.rounds} rounds ({rep.fill_rounds} fill); "
                f"{out['decode_tok_s']:.1f} tok/s over {rep.wall_s:.2f} s, "
                f"decode {out['decode_ms_per_round']:.2f} ms/round "
                f"(steady rounds); {rep.spec_rounds} speculative rounds, "
                f"accept rate {rep.accept_rate:.2f}; pool hit rate "
                f"{out['pool_hit_rate']:.4f}, "
                f"{out['miss_rows_per_round']:.1f} miss rows/round; "
                f"{out['cfg'].ess.host_cache_dtype} host tier "
                f"{out['tier_bytes']} bytes, "
                f"{out['miss_bytes_per_round']:.1f} miss bytes/round")
    return (f"prefill {out['prefill_tok_s']:.1f} tok/s "
            f"({out['prefill_s']:.2f} s incl. warmup); decode "
            f"{out['decode_ms_per_round']:.2f} ms/round, "
            f"{out['decode_tok_s']:.1f} tok/s over {out['decode_rounds']} "
            f"rounds; pool hit rate {out['pool_hit_rate']:.4f}, "
            f"{out['miss_rows_per_round']:.1f} miss rows/round "
            f"(all layers and slots), {out['overflow_rows']} overflow, "
            f"{out['evicted']} evicted; {out['cfg'].ess.host_cache_dtype} "
            f"host tier {out['tier_bytes']} bytes, "
            f"{out['miss_bytes_per_round']:.1f} miss bytes/round")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    out = run(args)
    print(report(out))
    toks = out["result"].tokens.tolist() if "result" in out else \
        [out["session"].outputs[b] for b in range(args.requests)]
    for b, t in enumerate(toks):
        print(f"  req{b}: {t[:8]}{'...' if len(t) > 8 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
