"""Time the page kernels alone on the card, for comparing two trees.

  PYTHONPATH=src python src/repro_torch/launch/time_pages.py [--iters 20]

Uses only what every tree of the port since the page kernels were first
ported has: ``gather_pages(cache, ids, rows)`` and
``gather_pages_dequant(q, scales, ids, rows)``, so the same script times
an older checkout (``PYTHONPATH=<checkout>/src``).  The shapes are the
serve cell's: 4 layers of a pinned tier of 516 pages of 64 rows x 576,
one slot's 129 pages (the graft) and an 8192-token prompt's 128 (the
pack), bf16 and int8 + f16 scales (bf16 out), device out.  Each time is
the mean of ``--iters`` back-to-back calls by CUDA events after two
warm-up calls, beside a pinned -> device copy of the same bytes.  Prints
the card's name and power limit, then one JSON object.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch


def mean_ms(fn, iters: int) -> float:
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_pages: no CUDA device")
    from repro_torch.kernels.gather_cache import ops as gops
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(card)
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(0)
    L, NP, R, D = 4, 516, 64, 576
    tier = torch.randn((L, NP * R, D), generator=g).bfloat16().pin_memory()
    x = torch.randn((L, NP * R, D), generator=g)
    scale = (x.abs().amax(-1, keepdim=True) / 127).half()
    q = torch.round(x / scale.float().clamp_min(1e-8)).clamp(-127, 127)
    q, scale = q.to(torch.int8).pin_memory(), scale.pin_memory()
    del x
    out = {"card": card}
    for tag, n in (("graft", 129), ("pack", 128)):
        ids = torch.arange(129, 129 + n, device=dev)
        rows = L * n * R
        dst = torch.empty((rows, D), dtype=torch.bfloat16, device=dev)
        qdst = torch.empty((rows, D), dtype=torch.int8, device=dev)
        sdst = torch.empty((rows, 1), dtype=torch.float16, device=dev)

        def copy_q():
            qdst.copy_(q.view(-1, D)[:rows], non_blocking=True)
            sdst.copy_(scale.view(-1, 1)[:rows], non_blocking=True)
        out[tag] = {
            "gather_pages_ms": mean_ms(
                lambda: gops.gather_pages(tier, ids, R), args.iters),
            "copy_ms": mean_ms(lambda: dst.copy_(
                tier.view(-1, D)[:rows], non_blocking=True), args.iters),
            "gather_pages_dequant_ms": mean_ms(
                lambda: gops.gather_pages_dequant(q, scale, ids, R),
                args.iters),
            "copy_int8_ms": mean_ms(copy_q, args.iters),
            "bytes_bf16": rows * D * 2,
            "bytes_int8": rows * (D + 2)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
