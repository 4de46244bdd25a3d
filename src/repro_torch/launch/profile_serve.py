"""Where the time of a serve goes: prefill chunks and decode rounds under
``torch.profiler``, on the card.

Serves the same batch as :mod:`repro_torch.launch.serve` (same arguments),
then prints, for one prefill chunk (``--chunk``, 1-based, default the
second) and for ``--rounds`` decode rounds after the first, the wall time,
the device's busy share (summed kernel time over wall time), the kernels
with the most device time, the tier gathers' share (every kernel of
``kernels/gather_cache`` that reads rows: both routes' passes) and the
indexer's (both routes' kernels), each also per decode round.  With
``--mtp-depth 1`` it also times the pieces a speculative round adds, each
alone and replayed from a CUDA graph at the serve's batch: the sampler
(``sample_batch`` over the vocabulary, two slots greedy, one top-k, one
top-p) and the MTP draft (``mtp_draft``).  With ``--overlap`` the decode
rounds run pipelined (a staging slab of the session's default size, its
gather and the fallback fetches on a fetch stream), and the slab gather's
time beside other device work is printed too.

  python -m repro_torch.launch.profile_serve --arch deepseek-v32-exp-ess \\
      --layers 4 --requests 4 --prompt-len 8192 --new-tokens 32 \\
      --prefill-chunk 256 --rounds 5 [--chunk 9] [--host-cache-dtype int8]
      [--overlap]
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from repro_torch import resolve_device
from repro_torch.cache import latent_cache as LC
from repro_torch.launch.serve import build_parser, config_from_args
from repro_torch.models.params import init_params
from repro_torch.serving import engine as E


# kernel names of the row gathers' passes (direct, mark, fetch, expand;
# the pipelined round's slab gather)
_GATHER_KERNELS = ("gather_rows_kernel", "gather_rows_dequant_kernel",
                   "mark_rows_kernel", "fetch_marked_rows",
                   "gather_rows_raw_kernel")
# the slab gather alone
SLAB_KERNELS = ("gather_rows_raw_kernel",)
# kernel names of the indexer's two routes (tensor-core, general)
_INDEXER_KERNELS = ("indexer_tc_kernel", "indexer_scores_kernel")


def _summary(prof, wall_s: float, top: int, windows: int = 1) -> list[str]:
    """Device time of the profiled window, summed by kernel; the tier
    gathers' and the indexer's sums are also given per ``windows`` (the
    chunk, or each decode round)."""
    rows = []
    busy_us = gather_us = index_us = 0.0
    for ev in prof.key_averages():
        # device-side events only (kernels, copies): the CPU ops that
        # launched them carry the same time again
        if ev.device_type != DeviceType.CUDA:
            continue
        dev_us = ev.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.count, ev.key))
            busy_us += dev_us
            if any(k in ev.key for k in _GATHER_KERNELS):
                gather_us += dev_us
            if any(k in ev.key for k in _INDEXER_KERNELS):
                index_us += dev_us
    rows.sort(reverse=True)
    out = [f"wall {wall_s * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
           f"({100 * busy_us / 1e6 / wall_s:.1f} % of wall); tier gathers "
           f"{gather_us / 1e3:.3f} ms ({100 * gather_us / busy_us:.1f} % of "
           f"busy, {gather_us / 1e3 / windows:.3f} ms each); indexer "
           f"{index_us / 1e3:.3f} ms ({100 * index_us / busy_us:.1f} % of "
           f"busy, {index_us / 1e3 / windows:.3f} ms each)"]
    for us, n, key in rows[:top]:
        out.append(f"  {us / 1e3:9.3f} ms {100 * us / busy_us:5.1f} %  "
                   f"x{n:<5d} {key[:90]}")
    return out


def overlap_profile(prof, kernels: tuple = _GATHER_KERNELS) -> dict:
    """The device timeline of a profiled window, swept over every device
    activity's interval (kernels and copies): ``busy_us``, the time in
    which at least one ran; ``gather_us``, the time in which a tier row
    gather ran (either route's passes, the slab's; or the kernels named
    in ``kernels``, e.g. :data:`SLAB_KERNELS`); and ``overlap_us``, the
    time in which a gather ran while another device activity ran too.  One
    stream runs one kernel at a time, so that time is a gather running
    beside work of another stream (the DA / DBA fetch stream, a TBO
    half)."""
    edges = []
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        a, b = ev.time_range.start, ev.time_range.end
        if b > a:
            g = any(k in ev.name for k in kernels)
            edges += [(a, 1, g), (b, -1, g)]
    edges.sort(key=lambda e: (e[0], e[1]))      # ends before starts
    n = ng = 0
    last = None
    busy = gather = overlap = 0.0
    for t, d, g in edges:
        if last is not None and t > last:
            span = t - last
            busy += span if n else 0.0
            gather += span if ng else 0.0
            overlap += span if ng and n >= 2 else 0.0
        n += d
        ng += d if g else 0
        last = t
    return {"busy_us": busy, "gather_us": gather, "overlap_us": overlap}


def _graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of one replay of ``fn`` captured as a CUDA graph
    (warmed on a side stream first)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _pieces(params: dict, cfg, B: int, dev: torch.device) -> str:
    """The sampler and the MTP draft alone at batch ``B``, from graphs."""
    from repro_torch.serving.mtp import mtp_draft
    from repro_torch.serving.sampling import sample_batch
    g = torch.Generator(device=dev).manual_seed(5)
    V = cfg.vocab_size
    i32 = dict(dtype=torch.int32, device=dev)
    knobs = (torch.tensor([0, 123, 0, 7][:B] + [0] * (B - 4), **i32),
             torch.arange(B, **i32) * 7 + 3,
             torch.randn((B, V), generator=g, device=dev) * 3,
             torch.tensor(([0.0, 0.8, 0.0, 1.0] * B)[:B], device=dev),
             torch.tensor(([0, 64, 0, 0] * B)[:B], **i32),
             torch.tensor(([1.0, 1.0, 1.0, 0.9] * B)[:B], device=dev))
    hid = torch.randn((B, cfg.d_model), generator=g,
                      device=dev).to(cfg.param_dtype)
    tok = torch.randint(0, V, (B,), generator=g, device=dev)
    return (f"spec-round pieces alone (graph replays): sample_batch "
            f"[{B}, {V}] {_graph_ms(lambda: sample_batch(*knobs)):.4f} ms; "
            f"mtp_draft at B = {B} "
            f"{_graph_ms(lambda: mtp_draft(params, cfg, hid, tok)):.4f} ms")


def main(argv=None) -> int:
    ap = build_parser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--chunk", type=int, default=2,
                    help="the prefill chunk to profile (1-based)")
    ap.add_argument("--overlap", action="store_true",
                    help="pipelined decode rounds (the staging slab)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise RuntimeError("profile_serve measures the card; pass a CUDA "
                           "device")
    cfg = config_from_args(args)
    max_seq = args.prompt_len + args.new_tokens
    params = init_params(cfg, args.seed, dev)
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.requests, args.prompt_len))
    tokens = torch.as_tensor(prompts, device=dev)
    B, S = tokens.shape
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

    # one prefill chunk, profiled on its own caches after the ones before
    C = args.prefill_chunk
    a, b = (args.chunk - 1) * C, args.chunk * C
    caches = LC.init_ess_caches(cfg, B, max_seq, device=dev)
    for c0 in range(0, a, C):
        caches = E.ess_prefill_chunk(params, cfg, tokens[:, c0:c0 + C],
                                     positions[:, c0:c0 + C], caches,
                                     want_logits=False)[1]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        E.ess_prefill_chunk(params, cfg, tokens[:, a:b], positions[:, a:b],
                            caches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"prefill chunk {args.chunk}: {C} x {B} (rows {a}..{b}):")
    print("\n".join(_summary(prof, wall, args.top)))
    del caches

    logits, caches = E.ess_prefill(params, cfg, tokens, positions, max_seq,
                                   prefill_chunk=C, last_logits_only=True)
    tok = logits[:, -1].argmax(-1)
    kw = {}
    if args.overlap:
        from repro_torch.core import transfer as TR
        from repro_torch.core.overlap import side_stream
        hs = caches.host_scales
        P = max(1, int(cfg.ess.max_miss_ratio
                       * min(cfg.dsa.index_topk, max_seq)))
        kw = dict(staged=TR.empty_slab(
            cfg.num_layers, B, P, caches.host_latent.shape[-1],
            caches.host_latent.dtype, None if hs is None else hs.dtype,
            device=dev), fetch_stream=side_stream(dev))
    o = E.ess_decode(params, cfg, tok[:, None], caches.lens[:, None], caches,
                     **kw)
    tok, caches = o.logits[:, 0].argmax(-1), o.caches
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.rounds):
            o = E.ess_decode(params, cfg, tok[:, None], caches.lens[:, None],
                             caches, **kw)
            tok, caches = o.logits[:, 0].argmax(-1), o.caches
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ov = overlap_profile(prof)
    slab = ""
    if args.overlap:
        so = overlap_profile(prof, SLAB_KERNELS)
        slab = (f"; the slab gather beside other device work "
                f"{so['overlap_us'] / args.rounds:.1f} us/round of "
                f"{so['gather_us'] / args.rounds:.1f}")
    print(f"decode: {args.rounds} rounds after the first "
          f"({wall * 1e3 / args.rounds:.2f} ms/round under the profiler; "
          f"gathers beside other device work "
          f"{ov['overlap_us'] / args.rounds:.1f} us/round of "
          f"{ov['gather_us'] / args.rounds:.1f}{slab}):")
    print("\n".join(_summary(prof, wall, args.top, args.rounds)))
    if cfg.mtp_depth:
        print(_pieces(params, cfg, B, dev))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
