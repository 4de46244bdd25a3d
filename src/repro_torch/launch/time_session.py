"""Time the serve session's decode rounds on the card, for comparing two
trees.

  PYTHONPATH=src python src/repro_torch/launch/time_session.py [--eager]

Runs the continuous-batching ``ServeSession`` of ``chip_smoke.py``'s
session A: deepseek-v32-exp-ess at its published widths cut to 4 layers
(3 dense + 1 MoE), random weights from seed 0, a bf16 host tier, no
warmup, 8 greedy requests of ragged prompts through 4 slots, 256-token
prefill chunks, its decode rounds replayed as CUDA graphs (``--eager``:
also the same run eagerly).  Uses only what every tree of the port since
the serve session has (``ServeSession(params, cfg, ...)``, ``run``,
``decode_round``, ``prefill_round``), so the same script times an older
checkout (``PYTHONPATH=<checkout>/src``).  Each decode round is timed on
the host clock (it ends in the round's one host fetch); rounds that
capture a graph are left out.  Prints the card's name and power limit,
then one JSON object per mode.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

PROMPTS = (8192, 3000, 6144, 8192, 1000, 4500, 8192, 2048)
NEW = (32, 16, 32, 24, 32, 16, 32, 32)
SLOTS, MAX_SEQ, CHUNK = 4, 8224, 256
ARGS = ["--arch", "deepseek-v32-exp-ess", "--layers", "4", "--requests",
        "4", "--prompt-len", "8192", "--new-tokens", "32",
        "--prefill-chunk", str(CHUNK), "--seed", "0", "--device", "cuda"]


def run(params, cfg, compiled: bool) -> dict:
    from repro_torch.serving import engine as E
    from repro_torch.serving.scheduler import Request
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in PROMPTS]
    reqs = [Request(rid=i, prompt_len=p, max_new_tokens=b)
            for i, (p, b) in enumerate(zip(PROMPTS, NEW))]
    sess = E.ServeSession(params, cfg, num_slots=SLOTS, max_seq=MAX_SEQ,
                          prompt_fn=lambda r: prompts[r.rid],
                          do_warmup=False, prefill_chunk=CHUNK,
                          compiled=compiled, device=torch.device("cuda"))
    decode_ms, prefill_s = [], [0.0]
    prefill, decode = sess.prefill_round, sess.decode_round

    def timed_prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran = prefill()
        torch.cuda.synchronize()
        prefill_s[0] += time.perf_counter() - t0
        return ran

    def timed_decode():
        k = sess.report.rounds
        caps = sess.programs.captures if compiled else 0
        t0 = time.perf_counter()
        done = decode()
        wall = time.perf_counter() - t0
        if sess.report.rounds > k and (
                not compiled or sess.programs.captures == caps):
            decode_ms.append(1e3 * wall)
        return done

    sess.prefill_round, sess.decode_round = timed_prefill, timed_decode
    rep = sess.run(reqs, max_rounds=10000)
    dm = sorted(decode_ms)
    return {"mode": "graph" if compiled else "eager",
            "decode_ms_mean": sum(dm) / len(dm),
            "decode_ms_median": dm[len(dm) // 2], "decode_ms_min": dm[0],
            "rounds_timed": len(dm), "rounds": rep.rounds,
            "prefill_tok_s": rep.prefill_tokens / prefill_s[0],
            "tokens": sum(len(v) for v in sess.outputs.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--eager", action="store_true",
                    help="also run the session eagerly")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_session: no CUDA device")
    from repro_torch.launch import serve
    from repro_torch.models.params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    cfg = serve.config_from_args(serve.build_parser().parse_args(ARGS))
    params = init_params(cfg, 0, torch.device("cuda"))
    for compiled in (True, False) if args.eager else (True,):
        print(json.dumps(run(params, cfg, compiled)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
