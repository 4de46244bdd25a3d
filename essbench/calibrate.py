"""Readings a cell's limit is set from: the program's and the control's.

    python essbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --seconds 15 [--control] [--out chiprun_out/calib.jsonl]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(set-up, the window, the program's state freed), then the reference over
the sample of served tokens.  Each seed gives the program's reading, the
widest gap by which a served token's logit lies below the float32
reference's best.  With ``--control`` the reference also runs the same
positions in float8 e4m3 (weights per output channel, activations per
row, latent and indexer caches per row: one precision below the bf16 the
configuration states) and reads the gap of the token that precision puts
first: the control's reading, judged by the comparison that judges the
program (``control_correct``, which has to come out false).  One JSON
line a seed; the benchmark's own runs never run the control.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from essbench import harness as H
    from essbench import spec as S
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    specs = S.Specs()
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        res = H.run_cell(specs, args.workload, seed, args.seconds, False,
                         device=dev, t_start=t0,
                         quant="fp8" if args.control else None)
        rec = {"workload": args.workload, "seed": seed,
               "correct": res["correct"], **res["readings"],
               "metrics": {k: v["value"] for k, v in res["metrics"].items()},
               "notes": {k: v for k, v in res["run"].notes.items()
                         if k != "compared_rids"},
               "seconds": time.perf_counter() - t0}
        line = json.dumps(rec, default=str)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del res
        H.free_device()
    if H.forbidden_modules():
        print(f"calibrate: loaded {H.forbidden_modules()}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
