#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

  python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without a result line):

1. build  — compile the CUDA kernels of ``src/repro_torch/kernels`` from
   the checkout (one nvcc per source, in parallel);
2. card   — print ``nvidia-smi`` name and power limit;
3. kernels — call each kernel's wrapper at the shapes the serve path gives
   it, hold it against its plain PyTorch version, time kernel, plain
   version and, where one exists, a single PyTorch call computing the same
   function, and compute the card's lower bound for the work;
4. small  — the smoke config in fp32 on the card against the plain CPU path
   (prefill + teacher-forced decode), a reference on a small input;
5. serve  — ``deepseek-v32-exp-ess`` at full width, cut to 4 layers (3
   dense + 1 MoE) and no MTP, 4 requests x 8192-token prompts x 32 new
   tokens with random weights from a seed; every kernel's launch count is
   read after this run and must be above 0, as must the decode misses
   (host-tier reads over UVA) and the pool evictions.

The last two lines are the ``kernels`` JSON object and the result object.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and bf16 / fp32-TC ops/s
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 495e12}

PREFILL_CHUNK = 256
SERVE_ARGS = ["--arch", "deepseek-v32-exp-ess", "--layers", "4",
              "--requests", "4", "--prompt-len", "8192", "--new-tokens", "32",
              "--prefill-chunk", str(PREFILL_CHUNK), "--seed", "0",
              "--device", "cuda"]


def require(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def timed_ms(torch, fn, iters=20, warmup=3):
    """Mean device time of ``fn`` by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
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


def wall_ms(torch, fn, iters=5, warmup=1):
    """Mean wall time of ``fn`` (host work included), synchronized."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_S * 1e3
    to = ops / PEAK_OPS_S[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_kernels(torch, dev):
    """Phase 3: every kernel against its plain version at the serve path's
    shapes.  Returns the per-kernel records (launches filled in later)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_cache import ops as gops
    from repro_torch.kernels.gather_cache import ref as gref
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.kernels.indexer import ref as iref
    from repro_torch.kernels.sparse_mla import ops as sops
    from repro_torch.kernels.sparse_mla import ref as sref
    from repro_torch.models.mla import mla_scale

    cfg = get_config("deepseek-v32-exp-ess")
    g = torch.Generator(device=dev).manual_seed(1234)
    B, S, R = 4, 8224, cfg.ess.host_page_rows
    D, rank, H = cfg.mla.latent_dim, cfg.mla.kv_lora_rank, cfg.num_heads
    Hi, Di, K = cfg.dsa.index_heads, cfg.dsa.index_dim, cfg.dsa.index_topk
    M = int(cfg.ess.max_miss_ratio * K)                     # 256 per slot
    NP = B * -(-S // R)
    scale = mla_scale(cfg)
    lens = torch.tensor([8193, 8200, 8207, 8224], device=dev)
    records = {}

    def randn(shape, dt=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    # -- gather_rows: one layer of the pinned paged tier, decode misses ----
    host = randn((NP * R, D)).cpu().pin_memory()
    for m_per_slot in (M, K):                   # decode envelope, warmup
        ids = torch.randint(0, NP * R, (B * m_per_slot,), generator=g,
                            device=dev)
        ids[::7] = -1
        got = gops.gather_rows(host, ids)
        want = gref.gather_rows_ref(host, ids.cpu())
        torch.cuda.synchronize()
        require(torch.equal(got.cpu(), want),
                f"gather_rows differs at M={m_per_slot}")
    ids = torch.randint(0, NP * R, (B * M,), generator=g, device=dev)
    ids[::7] = -1
    nrows = B * M
    row_b = D * 2
    dst = torch.empty((nrows, D), dtype=torch.bfloat16, device=dev)
    # rows read (ids >= 0) + every row written + the ids
    nb, _ = bound_ms((int((ids >= 0).sum()) + nrows) * row_b + 8 * nrows, 0,
                     "bf16")
    records["gather_rows"] = dict(
        name="gather_rows", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        replaces="src/repro/kernels/gather_cache/gather_cache.py:46",
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: gops.gather_rows(host, ids)),
        plain_ms=wall_ms(torch, lambda: gref.gather_rows_ref(
            host, ids.cpu()).to(dev)),
        bound_ms=nb, bound_by="bytes",
        library_ms=timed_ms(torch, lambda: dst.copy_(host[:nrows],
                                                     non_blocking=True)))

    # -- scatter_rows: the stacked prefill flush (4 layers x B x 256 rows) --
    Lh, C = 4, PREFILL_CHUNK
    tier = torch.zeros((Lh * NP * R, D), dtype=torch.bfloat16).pin_memory()
    want_tier = tier.clone()
    tgt = torch.randperm(Lh * NP * R, generator=g, device=dev)[:Lh * B * C]
    tgt[::11] = -1
    rows = randn((Lh * B * C, D))
    gops.scatter_rows(tier, tgt, rows)
    gref.scatter_rows_ref(want_tier, tgt.cpu(), rows.cpu())
    torch.cuda.synchronize()
    require(torch.equal(tier, want_tier), "scatter_rows differs")
    n = rows.shape[0]
    host_dst = torch.empty((n, D), dtype=torch.bfloat16).pin_memory()
    nb, _ = bound_ms(2 * int((tgt >= 0).sum()) * row_b + 8 * n, 0, "bf16")
    records["scatter_rows"] = dict(
        name="scatter_rows", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        # no Pallas kernel: the reference's XLA host-compute scatter
        replaces="src/repro/core/offload.py:274",
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: gops.scatter_rows(tier, tgt, rows)),
        plain_ms=wall_ms(torch, lambda: gref.scatter_rows_ref(
            want_tier, tgt.cpu(), rows.cpu())),
        bound_ms=nb, bound_by="bytes",
        library_ms=timed_ms(torch, lambda: host_dst.copy_(
            rows, non_blocking=True)))

    # -- indexer_scores: decode (Q=1) and a prefill chunk (causal) ----------
    def indexer_case(Q, causal):
        q = randn((B, Q, Hi, Di))
        w = randn((B, Q, Hi))
        keys = randn((B, S, Di))
        if causal:
            qpos = lens[:, None] - Q + torch.arange(Q, device=dev)
            valid = torch.arange(S, device=dev)[None, None] <= qpos[..., None]
        else:
            valid = (torch.arange(S, device=dev)[None, None]
                     < lens[:, None, None]).expand(B, Q, S)
        got = iops.indexer_scores(q, w, keys, valid)
        want = iref.indexer_scores_ref(q, w, keys, valid)
        torch.cuda.synchronize()
        require(torch.equal(got <= -1e37, want <= -1e37),
                "indexer_scores mask differs")
        mk = want > -1e37
        err = float((got[mk] - want[mk]).abs().max())
        torch.testing.assert_close(got[mk], want[mk], rtol=1e-4, atol=1e-3)
        return q, w, keys, valid, err

    q, w, keys, valid, err = indexer_case(1, False)
    err = max(err, indexer_case(C, True)[-1])
    nvalid = int(valid.sum())
    nbytes = (q.numel() + w.numel() + keys.numel()) * 2 + valid.numel() \
        + 4 * B * S
    bms, bby = bound_ms(nbytes, nvalid * Hi * (2 * Di + 2), "bf16")
    records["indexer_scores"] = dict(
        name="indexer_scores", route="cuda",
        source="src/repro_torch/kernels/indexer/csrc/indexer.cu",
        replaces="src/repro/kernels/indexer/indexer.py:41",
        max_abs_err=err,
        ms=timed_ms(torch, lambda: iops.indexer_scores(q, w, keys, valid)),
        plain_ms=timed_ms(torch, lambda: iref.indexer_scores_ref(
            q, w, keys, valid)),
        bound_ms=bms, bound_by=bby, library_ms=None)

    # -- sparse_mla_partial: Attn0 (K=2048), Attn1 (K=256) in bf16, and
    #    prefill (per-query fp32 rows, K=2048, a 16-query slice) ----------
    def mla_case(Q, Krows, dt, per_query):
        qq = randn((B, Q, H, D), dt)
        shape = (B, Q, Krows, D) if per_query else (B, Krows, D)
        rr = randn(shape, dt)
        vv = torch.rand(shape[:-1], generator=g, device=dev) < 0.9
        vv[..., -17:] = False
        got = sops.partial_attend(qq, rr, vv, scale, rank)
        r4 = rr if per_query else rr[:, None]
        v3 = vv if per_query else vv[:, None]
        want = sref.sparse_mla_partial_ref(qq, r4, v3, scale, rank)
        torch.cuda.synchronize()
        e = 0.0
        for a, b in zip(got, want):
            tol = 1e-4 * max(1.0, float(b.abs().max()))
            torch.testing.assert_close(a, b, rtol=1e-4, atol=tol)
            e = max(e, float((a - b).abs().max()))
        return qq, rr, vv, e

    errs = [mla_case(1, M, torch.bfloat16, False)[-1],
            mla_case(16, K, torch.float32, True)[-1]]
    qq, rr, vv, e0 = mla_case(1, K, torch.bfloat16, False)
    nvalid = int(vv.sum())
    nbytes = (qq.numel() + rr.numel()) * 2 + vv.numel() \
        + 4 * B * H * (rank + 2)
    bms, bby = bound_ms(nbytes, nvalid * H * 2 * (D + rank), "bf16")
    rq, rk = rr[:, None], vv[:, None]
    qs = qq.view(B, 1, H, D)
    kk = rr.view(B, 1, K, D)
    vvv = rr[..., :rank].reshape(B, 1, K, rank)
    mask = vv.view(B, 1, 1, K)
    records["sparse_mla_partial"] = dict(
        name="sparse_mla_partial", route="cuda",
        source="src/repro_torch/kernels/sparse_mla/csrc/sparse_mla.cu",
        replaces="src/repro/kernels/sparse_mla/sparse_mla.py:74",
        max_abs_err=max(errs + [e0]),
        ms=timed_ms(torch, lambda: sops.partial_attend(qq, rr, vv, scale,
                                                       rank)),
        plain_ms=timed_ms(torch, lambda: sref.sparse_mla_partial_ref(
            qq, rq, rk, scale, rank)),
        bound_ms=bms, bound_by=bby,
        library_ms=timed_ms(torch, lambda: torch.nn.functional
                            .scaled_dot_product_attention(
                                qs, kk, vvv, attn_mask=mask, scale=scale)))
    torch.cuda.synchronize()
    return records


def check_small(torch, dev):
    """Phase 4: the smoke config (fp32) on the card against the CPU plain
    path: prefill + 3 teacher-forced decode steps, logits and pool maps."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E

    cfg = dataclasses.replace(get_config("deepseek-v32-exp-ess-smoke"),
                              param_dtype=torch.float32)
    p_cpu = init_params(cfg, 7, device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}
    p_gpu = to(p_cpu, dev)
    rng = np.random.default_rng(7)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (3, 40)))
    pos = torch.arange(40)[None].expand(3, 40)
    lc, cc = E.ess_prefill(p_cpu, cfg, toks, pos, 48, prefill_chunk=16)
    lg, cg = E.ess_prefill(p_gpu, cfg, toks.to(dev), pos.to(dev), 48,
                           prefill_chunk=16)
    err = float((lg.cpu() - lc).abs().max())
    tok = lc[:, -1].argmax(-1)
    for _ in range(3):
        p = cc.lens[:, None]
        oc = E.ess_decode(p_cpu, cfg, tok[:, None], p, cc)
        og = E.ess_decode(p_gpu, cfg, tok[:, None].to(dev), p.to(dev), cg)
        cc, cg = oc.caches, og.caches
        err = max(err, float((og.logits.cpu() - oc.logits).abs().max()))
        tok = oc.logits[:, 0].argmax(-1)
    torch.cuda.synchronize()
    require(err <= 1e-3, f"small-input logits differ by {err}")
    for a, b in zip(cg.pools, cc.pools):
        require(torch.equal(a.slot_of.cpu(), b.slot_of),
                "small-input pool maps differ")
    return err


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels").is_dir():
        return fail("run from a checkout: src/repro_torch is missing")
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_cache import ops as gops
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.kernels.sparse_mla import ops as sops
    from repro_torch.launch import serve

    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    # 1. build
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()), flush=True)
    for name, log in _build.PTXAS_INFO.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
    # 2. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    # 3. kernels
    records = check_kernels(torch, dev)
    for r in records.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}, max err "
              f"{r['max_abs_err']:.3g}  [{card}]", flush=True)
    # 4. small input against the CPU plain path
    err = check_small(torch, dev)
    print(f"small: smoke config fp32 card vs CPU, max logit diff {err:.3g}",
          flush=True)
    # 5. serve
    counted = {"gather_rows": gops.gather_rows,
               "scatter_rows": gops.scatter_rows,
               "indexer_scores": iops.indexer_scores,
               "sparse_mla_partial": sops.partial_attend}
    args = serve.build_parser().parse_args(SERVE_ARGS)
    print("serve: deepseek-v32-exp-ess at full width; cuts: num_layers "
          "61 -> 4 (3 dense + 1 MoE), mtp_depth 1 -> 0", flush=True)
    torch.cuda.reset_peak_memory_stats()
    for fn in counted.values():
        fn.launches = 0
    out = serve.run(args)
    torch.cuda.synchronize()
    for name, fn in counted.items():
        records[name]["launches"] = fn.launches
    res = out["result"]
    print(f"serve: {serve.report(out)}  [{card}]", flush=True)
    print(f"serve: init {out['init_s']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches "
          + ", ".join(f"{k} {v['launches']}" for k, v in records.items()),
          flush=True)
    require(res.tokens.shape == (args.requests, args.new_tokens),
            f"tokens {res.tokens.shape}")
    require(res.logits_finite, "non-finite logits")
    for name, r in records.items():
        require(r["launches"] > 0, f"{name} was not launched by the serve run")
    require(res.misses.sum() > 0, "decode rounds read nothing from the tier")
    require(res.evicted > 0, "the pool never evicted")
    print(card)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
