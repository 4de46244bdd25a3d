"""The knee of an open-loop cell: the highest arrival rate it sustains.

    python essbench/sweep.py --workload v32-chat-2k --rates 3,4,5,6 \\
        --seconds 30 --seed 7 [--out chiprun_out/sweep.jsonl]

One process, one set of weights; for each rate the cell's traffic driver
runs its window at that rate on a fresh engine (no check).  Each line
gives the rate, the requests due and finished, those still waiting for a
slot or a first token at the end, the time to first token (median and
95th percentile, and the 95th percentile of the first and the last third
of the arrivals) and the 95th percentile inter-token gap.  A rate is
sustained where the backlog at the end stays small and the last third's
TTFT tail does not run away from the first third's.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path[0] = str(Path(__file__).resolve().parent.parent)

from essbench import entry  # noqa: E402

entry.prepare()



def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    from essbench import harness as H
    from essbench import spec as S
    from essbench import weights as W
    from essbench.trace import Spans
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    specs = S.Specs()
    dev = torch.device("cuda", 0)
    wl = specs.json("workloads", args.workload)
    conf = specs.json("configs", wl["config"])
    cfg = S.arch_config(conf)
    weights = W.draw(cfg, args.seed, dev)
    driver = specs.module("traffic", wl["traffic"])
    itl = specs.module("metrics", "itl_p95_ms")
    out = open(args.out, "a") if args.out else None
    for rate in (float(r) for r in args.rates.split(",")):
        ctx = H.Ctx(cell=args.workload, cfg=cfg, conf=conf,
                    params={**wl["params"], "rate": rate, "sample": 0},
                    seed=args.seed, seconds=args.seconds, trace=False,
                    device=dev, weights=weights, spans=Spans(False),
                    t_start=time.perf_counter())
        run = driver.run(ctx)
        H.free_device()
        tt = np.asarray(run.ttft_s)
        third = max(1, len(tt) // 3)
        rec = {"rate": rate, "due": run.attempted,
               "finished": run.notes.get("finished"),
               "waiting_at_end": run.notes.get("waiting_at_end"),
               "no_first_token": len(set(run.due) - {
                   r for r, i, _ in run.tokens if i == 0}),
               "ttft_p50_ms": 1e3 * float(np.median(tt)),
               "ttft_p95_ms": 1e3 * H.percentile(tt, 95),
               "ttft_p95_first_third_ms": 1e3 * H.percentile(tt[:third], 95),
               "ttft_p95_last_third_ms": 1e3 * H.percentile(tt[-third:], 95),
               "itl_p95_ms": itl.read(run, ctx),
               "decode_tokens": run.counters.get("decode_tokens"),
               "rounds": run.notes.get("rounds"),
               "window_s": run.window_s,
               "generator_late_s": float(run.notes.get("generator_late_s",
                                                       0.0))}
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
