#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

  python3 chip_smoke.py

Phases (each ends in ``torch.cuda.synchronize()``; any failure raises and
the script exits non-zero without a result line):

1. build  — compile the CUDA kernels of ``src/repro_torch/kernels`` from
   the checkout (one nvcc per source, in parallel);
2. card   — print ``nvidia-smi`` name and power limit;
3. kernels — time the copy engine on the host link (256 MiB pinned <->
   device copies), call each kernel's wrapper at the shapes the serve path
   gives it, hold it against its plain PyTorch version (the gathers,
   dequant included, and the scatter bit for bit), time kernel, plain
   version and, where one exists, a single PyTorch call computing the
   same function, and compute the card's lower bound for the work (for
   the UVA kernels: the larger of the bytes that cross the host link over
   its peak, PCIe Gen5 x16, and the device bytes over HBM; a contiguous
   copy of the same bytes is timed beside them; the indexer's keys count
   only the rows that some query of their slot may see).  The row
   gathers run on both routes: the decode miss fetch (direct) and
   a prefill chunk's per-query rows (staged; each distinct row must be
   read once, by the kernel's own count), and the pipelined round's slab
   gather (``gather_rows_raw``: ids [4, 4, 256] over every layer of the
   stacked tier in one launch, bf16 rows, and an int8 / fp8 payload with
   its f16 scale, raw) bit for bit.  The indexer runs at its two
   serve shapes (decode, Q = 1 over the cache; a causal prefill chunk,
   Q = 256) on the tensor-core route, each also timed on the general route
   (the CUDA-core kernel) on the same inputs, back to back and from a CUDA
   graph; the prefill chunk's top-2048 must overlap the plain scores'
   by 0.999 or more.  The sparse-MLA
   partial runs at its three serve shapes (Attn0, Attn1, a whole prefill
   chunk) on the tensor-core route, each also timed on the general route
   (the CUDA-core kernel) on the same inputs; its split merge is held
   against its own plain version.  Then both kernels at the MTP verify
   step's shapes (session C, Q = 2): the indexer with each query causal
   over the cache, Attn0 over each query's own 2048 rows, Attn1 over the
   512 fetched rows shared by both queries (one set expanded over Q, each
   query masked to its own); and at DeepSeek-V3's dense-MLA shapes
   (:func:`check_v3_kernels`): the decode over a whole [4, 8224, 576]
   cache, and a prefill chunk's 256 queries over the prompt's 8192 rows
   shared, a causal mask per query;
4. small  — the smoke config in fp32 on the card against the plain CPU path
   (the ESS prefill + teacher-forced decode, then the monolithic model's
   prefill + decode), a reference on a small input; its sparse-MLA
   partials and indexer scores must all take the general route;
5. serve  — ``deepseek-v32-exp-ess`` at full width, cut to 4 layers (3
   dense + 1 MoE) and no MTP, 4 requests x 8192-token prompts x 32 new
   tokens with random weights from a seed, bf16 host tier; the launch
   counts of its kernels are read after this run and must be above 0, as
   must the decode misses (host-tier reads over UVA) and the pool
   evictions; every sparse-MLA partial and indexer launch must take the
   tensor-core route, every prefill tier fetch the staged gather route and
   the decode ones the direct route; the launches per kernel shape, as
   the indexer and sparse-MLA wrappers count them, must equal what the
   serve's arguments give (``serve_shapes``);
6. quant serve — the same serve on the same weights with an int8 host
   tier (``--host-cache-dtype int8``): the fused gather-dequant kernel
   must carry every tier read;
7. graft  — a 2048-token prompt prefilled alone, grafted into slot 2 of a
   fresh 4-slot cache through the page gathers, bf16 and int8 tiers
   (:func:`check_graft`);
8. session A — the continuous-batching ``ServeSession`` on the same
   weights: 4 slots, ``max_seq`` 8224, prefill chunk 256, bf16 tier, no
   warmup, 8 greedy requests of ragged prompt lengths (``SESSION_PROMPTS``,
   ``SESSION_NEW``), so slots recycle and last chunks are padded.  Run
   twice: the decode round replayed as a CUDA graph (``compiled=True``),
   then eagerly; the token streams must be bit-identical and the launch
   counts (the graph's replays added) equal.  Every request must end with
   one terminal event; every decode round's plan and compute stages, and
   every prefill round, run under ``torch.cuda.set_sync_debug_mode
   ("error")``, and each decode round makes exactly one host fetch
   (:func:`run_session`); the launches per route and shape must equal what
   the run's rounds and chunks give.  Prints decode ms/round, the device's
   busy share (``torch.profiler`` over three rounds), the time in those
   rounds in which a row gather ran beside other device work (the DA
   fetch on its side stream; above 0 in every graph session) and prefill
   tokens/s;
9. session B — the same with an int8 tier, the LRU warmup at admission
   (``do_warmup=True``) and 4 requests, graph then eager as in session A:
   the gather-dequant kernel and ``lru_warmup`` on the card;
9b. overlap — the serve's prompts prefilled once, then 8 teacher-forced
   decode rounds from identical copies of the caches under DA, DBA, the
   layer-wise plan DA / DBA / DA / DBA and TBO over DA, each round
   replayed as a CUDA graph whose fetch and TBO streams are branches
   (:func:`overlap_phase`): logits within 2e-2 of DA's, hits / misses /
   overflow compared with DA's, and in 3 profiled replays a row gather
   running beside other device work;
9c. session E — session A's requests with DBA layers and TBO
   (``overlap="dba"``, ``tbo=True``: halves of 2 slots, DBA halves of 1
   within them), graph then eager, with session A's checks, the launches
   per route and shape 4 per layer and round;
10. session C — MTP speculative rounds at depth 1 with the published MTP
   module (a full MoE block and its ``proj``, drawn from a generator of
   its own beside the same 4 layers), 4 slots, bf16 tier, 4 requests of
   32 tokens (``SESSION_C``), two of them sampled (top-k and top-p).
   Graph, then eager, with session A's checks; every round is a Q = 2
   verify round, and its indexer, Attn0 and Attn1 launches must take the
   tensor-core routes at the verify shapes.  Prints ms/round (per variant:
   greedy rounds and rounds with a sampling slot), tokens per live
   slot-round, the accept rate, the busy share and the profiled rounds'
   kernels by device time.  Then the same requests at Q = 1 rounds, whose
   streams differ by design: a verify step's queries share one miss
   envelope and one MoE capacity, so the rows and experts each query gets
   depend on the other.  Where neither can bind (``max_miss_ratio`` 1,
   capacity factor E / top_k) the depth-1 streams must equal the Q = 1
   session's; with the envelope alone unbound, for information;
12. session F — the pipelined round (``overlap=True``: each layer's
   misses from the round's own rows, a staging slab filled during the
   previous round on the fetch stream, and a fallback gather; one stacked
   tier write per round) on session A's requests (graph, then eager),
   session B's (int8 tier + warmup, graph then eager) and session C's
   (MTP depth 1 + the 2 sampled requests, graph), run after session C's
   information runs: each run's streams must equal the synchronous graph
   session's bit for bit, the pipeline must engage (prefetch hits + misses
   above 0), session A's checks hold (one fetch and no sync a round, the
   launches per route and shape, one slab gather and one stacked write
   per plane a round); prints ms/round, the prefetch hit rate, misses and
   wasted rows, and the time in the profiled rounds in which the slab
   gather (``gather_rows_raw``) ran beside other device work;
13. cluster — the PD-disaggregated ``EssCluster`` after session F: one
   prefill worker (2 slots) and two decode workers (2 slots each) sharing
   the serve's weights, ``max_seq`` 8224, chunk 256, on session A's first
   four requests (rid 1 sampled: temperature 0.8, top-k 16, seed 5), at a
   miss envelope and a MoE capacity that cannot bind; a bf16 tier, then
   int8 with the LRU warmup (the tails shipped in the packets); graph
   rounds.  Each run's streams must equal a 4-slot ``EssEngine``'s on the
   same weights bit for bit, each pack (the page gather straight into a
   pinned packet) must make exactly one host wait and no other sync and
   each install (the page write from the packet) none; prints migrations,
   wire bytes, the pack's page-copy device ms and wall ms, install ms,
   decode ms per round per decode worker, mean TTFT and the page
   kernels' launches (:func:`cluster_phase`); the run is also watched by
   ``audit.ClusterWatch`` (ESS107: one host wait a pack, each rid packed
   once, prefill rounds waiting only to pack, decode rounds at one fetch,
   none in an install, none outside a worker round);
13b. long prompt — after the cluster (:func:`long_prompt_phase`): the
   serve's model, weights and tier (bf16), a compiled 2-slot session of
   ``max_seq`` 32776 and chunk 256; rid 0 (8192 tokens + 160 new) decodes
   while rid 1 (32768 tokens + 2 new), submitted after rid 0's first
   token, prefills in 128 chunks, one a round.  Both must finish, rid 0
   must emit in every round in which rid 1 prefills, rid 1's tier rows
   and first token must equal a standalone ``ess_prefill`` of its prompt
   at chunk 256 (bit for bit; the first token otherwise within a bf16 ulp
   of the standalone logits' top), rid 0's stream must equal the same
   session's with rid 1 never submitted, the prefill's tier fetches all
   staged and the decode's direct, every indexer and sparse-MLA launch on
   the tensor-core route at the launches per shape the rounds and chunks
   give.  Prints rid 1's prefill tok/s (over its chunks' own time, and
   from submit to its first token) and TTFT, rid 0's decode ms/round
   while rid 1 prefills and after, the hits and misses of the rounds at
   32K context, and the pinned tier against the device bytes per slot.
   Phase 3 times the indexer at its shapes (rows ``decode-32k``,
   ``prefill-32k``);
11. session D — every weight zeroed in place, so every argmax is token 0
   and every draft is accepted: 2 requests (``SESSION_D``) at depth 1 in
   graph mode must show accept rate 1.0, 2 tokens per live slot-round
   but at the budget clamp, no request past its budget, and the streams
   of the same requests at Q = 1 rounds (the last session);
15. archs — after the sessions, with the serve's weights freed: the
   generic path on qwen3-0.6b, gemma2-27b, gemma3-27b, qwen1.5-110b,
   dbrx-132b, qwen2-vl-7b, deepseek-v3-671b, mamba2-780m, zamba2-7b and
   whisper-large-v3 at their published widths, depth cut as ``ARCHS``
   lists (the last three whole), random bf16 weights from the serve's
   seed: 4 x 8192-token prompts (qwen2-vl: seeded embeddings, M-RoPE;
   whisper: 416-token prompts over 4 x 1500 seeded frame embeddings),
   ``generic_prefill``, 32 ``generic_decode`` rounds (1-4 eager under
   sync-debug "error", then a CUDA graph, its first replay bit-equal to an
   eager round from the same state), rounds 1 and 32 within the
   reference's consistency bound of a prefill over the whole stream (the
   SSM-backbone rows: their bf16 errors printed, held against a second
   run in fp32, :func:`ssm_witness`); V3's partials all on the
   tensor-core route, at the launches per shape the run gives; Quest on qwen3-0.6b's cache (:func:`archs_phase`,
   :func:`quest_check`).  The monolithic phase prints Eq. 1 (the
   intra-layer similarity of two consecutive rounds' top-2048 sets);
16. train — after the archs phase (:func:`train_phase`), fp32 products
   (TF32 off): T1, qwen3-0.6b whole at published widths, fp32 params,
   remat "dots", 4 donated steps of micro-batch 2 x accumulation 4 x 4096
   tokens (finite losses and grad norms; step ms, train tokens/s, peak
   memory), then an accumulation check at seq 1024 (the loss and
   gradients at micro 1 x accum 2 against micro 2 x accum 1) and "dots"
   against "none" gradients; T2,
   DeepSeek-V3.2 cut to its first (dense) layer, MTP cut, fp32, batch 1 x
   3072 tokens (past index_topk: the DSA mask live), 2 steps counted: the
   mask's indexer scores must launch the kernel (row 2-tr of the kernels
   line), the indexer's leaves get exactly zero gradient, and the keep
   mask from the kernel's scores equals the plain version's but at keys
   within the score error of the top-k threshold; T3, one step of each
   plan's smoke config on the card against the CPU (:func:`step_vs_cpu`);
   the loop's resume on the card (:func:`resume_check`);
14. mirrors — ``examples/serve_ess_torch.py``, ``stream_abort_torch.py``
   and ``serve_cluster_torch.py`` on the card, and
   ``examples/train_small_torch.py --steps 50``, started together, each in
   its own process: each must exit 0 (:func:`mirrors_phase`).
17. sharding — last (:func:`sharding_phase`): an NCCL process group of
   one rank (an in-process store) and the host mesh over it;
   ``sharded_flash_decode``, ``pipeline_apply`` (one stage) and the
   compressed gradient all-reduce on CUDA tensors against their plain
   oracles on the card; the ESS decode at published widths as session A
   runs it (4 requests, graph rounds) without and then inside
   ``use_sharding(make_host_mesh(), PROFILES[cfg.sharding_profile]
   (False))``: equal greedy streams, the rounds replayed from CUDA
   graphs, the gather, indexer and sparse-MLA kernels launched.  Then
   the ESS decode over two ranks on the one card
   (:func:`two_rank_phase`): the serve model's 3 dense layers at
   published widths, the phase's 4 requests run once on one rank, then
   by two processes (a ``cpu:gloo,cuda:gloo`` group, a ``data 2 x model
   1`` mesh, 2 slots and their own pinned tier shard a rank), prefill on
   each slot's rank, eager decode rounds teacher-forced with the one-rank
   stream: every rank launches the gather, indexer, sparse-MLA, merge and
   scatter kernels and no collective, and its streams equal the one-rank
   run's but for near-ties.

The audits (``repro_torch.analysis.audit``; :func:`audit_run` in the
session phases).  Every session run of ``graph_and_eager`` (A, B, E, C, F)
is watched: ESS102, one host fetch (``engine.device_get``) a serve round
and as many as rounds; ESS103 (graph runs), one capture per (round kind,
sampled) key that ran; ESS104, every ``EngineState`` tensor's dtype as
built.  The graph runs of A, C, F-A and F-B then serve the same requests
again under fresh rids: ESS103's captures must not move.  Session B's
eager run profiles its decode round ``DEQUANT_ROUND`` with shapes and
dtypes: ESS106, no op widens an int8 tensor of one layer's tier elements
or more.  Each audit prints its counts and findings on a line of its own;
a finding fails the run.

Phase 3 also times the page kernels (a TMA ring) at the graft shape (129
pages) and the pack shape (128 pages): ``gather_pages`` and
``gather_pages_dequant`` into device memory, the pack's page copy straight
into a pinned packet (route (a), bf16 and int8 with its scale plane,
beside route (b): device out, then one device -> pinned copy) and the
install's ``put_pages`` (pinned packet -> pinned tier), each against its
plain version, the copy engine on the same bytes and its bound (the larger
direction over the link's peak).

Each of phases 5-13b sets every launch count to 0 just before it runs and
reads them just after (9b's replays count nothing: it prints the eager
rounds' and the captures' launches); the kernels line's
``launches_session_e`` are session E's eager run's, its
``launches_session_f`` session F's per run (F-A's and F-B's eager runs,
F-C's graph run with its replays counted by the capture), and the slab
gather's ``launches`` F-A's (bf16) and F-B's (int8) eager runs'.  The sparse-MLA cases
at Q <= 2 also time SDPA replayed from a graph (``library_device_ms``).
The kernels line's ``launches`` are session A's
eager run's (the row gathers, scatter, indexer and sparse-MLA shapes,
merge), session B's eager run's (the gather-dequant routes), session C's
eager run's (the verify shapes), the grafts' (the page gathers), the
monolithic run's prefill (the HBM gather at the prefill shape) and eager
decode rounds (the HBM gather at the decode shape, ``topk_select``'s
indexer, the mono-decode partial), the
cluster runs' (the pack's page gather and the install's page write), the
long prompt's (the indexer over 32776 keys, ``launches_long`` for every
kernel) and T2's steps (the train mask's indexer); every
kernel of the line must have one: counted where the wrappers launch, not derived
from a graph's replays, which the graph runs' equal counts then confirm.

The last two lines are the ``kernels`` JSON object and the result object.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and bf16 / fp32-TC ops/s,
# and float32 outside the tensor cores (the general indexer kernel's fp32)
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "fp32": 495e12, "fp32_simt": 67e12}
# the host link, PCIe Gen5 x16 (data sheet: 128 GB/s both ways), each way
LINK_BYTES_S = 64e9
# the copy engine's pinned <-> device rates, measured by copy_rates()
COPY_BYTES_S = {}

PREFILL_CHUNK = 256
SERVE_ARGS = ["--arch", "deepseek-v32-exp-ess", "--layers", "4",
              "--requests", "4", "--prompt-len", "8192", "--new-tokens", "32",
              "--prefill-chunk", str(PREFILL_CHUNK), "--seed", "0",
              "--device", "cuda", "--fixed-batch"]


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


def graph_ms(torch, fn, iters=20):
    """Mean device time of ``fn`` replayed from a CUDA graph: the kernels'
    time without the wrapper's host work (``timed_ms`` of back-to-back
    calls reads whichever of the two is longer)."""
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
    del graph
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


def bound_ms(nbytes: float, ops: float, dtype: str,
             host_bytes: float = 0.0) -> tuple[float, str]:
    """The least time for the work: the larger of the device bytes over HBM
    and, for the UVA kernels, the bytes that cross the host link over its
    peak (the two overlap), against the operations over the peak rate."""
    tb = max(nbytes / HBM_BYTES_S, host_bytes / LINK_BYTES_S) * 1e3
    to = ops / PEAK_OPS_S[dtype] * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def key_bytes(keys, valid) -> int:
    """Bytes of the indexer's keys that its scores need: each slot's key
    rows that some query may see (``valid`` [B,S] or [B,Q,S]).  A key that
    no query sees scores -2e38 unread, so a slot filled to ``n`` of ``S``
    rows counts ``n`` of them."""
    v = valid if valid.dim() == 2 else valid.any(dim=1)
    return int(v.sum()) * keys.shape[-1] * keys.element_size()


def copy_rates(torch, dev, nbytes=256 * 2**20):
    """Pinned host <-> device copy rates of one ``nbytes`` buffer (bytes/s):
    what the copy engine reaches on this host's link, beside its peak."""
    host = torch.empty(nbytes, dtype=torch.uint8).pin_memory()
    card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    COPY_BYTES_S["h2d"] = nbytes / timed_ms(
        torch, lambda: card.copy_(host, non_blocking=True), iters=5,
        warmup=1) * 1e3
    COPY_BYTES_S["d2h"] = nbytes / timed_ms(
        torch, lambda: host.copy_(card, non_blocking=True), iters=5,
        warmup=1) * 1e3
    del host, card


def host_us(torch, fn, uncached, n=200):
    """Mean host time of one call of a wrapper (its enqueue, the device not
    waited for), with the UVA mapping looked up anew each call when
    ``uncached`` (the lookup before the wrapper cached it)."""
    from repro_torch.kernels.gather_cache import ops as gops
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        if uncached:
            gops._UVA.clear()
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * t / n


def prefill_ids(torch, g, dev, B, C, K, start, slot_rows):
    """Tier rows a prefill chunk at ``start`` asks for, ``[B, C*K]``: each
    query's top-K of random scores over its causal positions, the chunk's
    own (local) positions -1, slot b's position p at row
    ``b * slot_rows + p`` (identity block tables)."""
    pos = torch.arange(start + C, device=dev)
    qpos = start + torch.arange(C, device=dev)
    sc = torch.rand((B, C, start + C), generator=g, device=dev)
    sc = sc.masked_fill(pos[None, None] > qpos[None, :, None], -1.0)
    ids = sc.topk(K, dim=-1).indices                           # [B,C,K]
    rows = ids + torch.arange(B, device=dev)[:, None, None] * slot_rows
    return torch.where(ids < start, rows, -1).reshape(B, C * K)


def distinct_live(torch, ids, s):
    return int(ids[ids >= 0].clamp_max(s - 1).unique().numel())


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
    C = PREFILL_CHUNK
    records = {}

    def randn(shape, dt=torch.bfloat16, s=1.0):
        return (torch.randn(shape, generator=g, device=dev) * s).to(dt)

    # -- gather_rows: one layer of the pinned paged tier; the decode misses
    #    (direct route) and a prefill chunk's per-query rows (staged) ------
    host = randn((NP * R, D)).cpu().pin_memory()
    for m_per_slot in (M, K):                   # decode envelope, warmup
        ids = torch.randint(0, NP * R, (B * m_per_slot,), generator=g,
                            device=dev)
        ids[::7] = -1
        require(not gops.staged_route(ids.numel(), NP * R),
                f"gather_rows at M={m_per_slot} must read directly")
        got = gops.gather_rows(host, ids)
        want = gref.gather_rows_ref(host, ids.cpu())
        torch.cuda.synchronize()
        require(torch.equal(got.cpu(), want),
                f"gather_rows differs at M={m_per_slot}")
    ids = torch.randint(0, NP * R, (B * M,), generator=g, device=dev)
    ids[::7] = -1
    nrows = B * M
    row_b = D * 2
    nread = int((ids >= 0).sum())
    dst = torch.empty((nrows, D), dtype=torch.bfloat16, device=dev)
    # rows read over the link; every row written + the ids in HBM
    nb, _ = bound_ms(nrows * row_b + 8 * nrows, 0, "bf16",
                     host_bytes=nread * row_b)
    records["gather_rows"] = dict(
        name="gather_rows", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        replaces="src/repro/kernels/gather_cache/gather_cache.py:46",
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: gops.gather_rows(host, ids)),
        device_ms=graph_ms(torch, lambda: gops.gather_rows(host, ids)),
        plain_ms=wall_ms(torch, lambda: gref.gather_rows_ref(
            host, ids.cpu()).to(dev)),
        bound_ms=nb, bound_by="bytes", library_ms=None,
        # the same bytes as one contiguous pinned -> device copy
        copy_ms=timed_ms(torch, lambda: dst.copy_(host[:nrows],
                                                  non_blocking=True)),
        host_us=host_us(torch, lambda: gops.gather_rows(host, ids), False),
        host_us_uncached=host_us(torch, lambda: gops.gather_rows(host, ids),
                                 True),
        shape=f"direct route, {nrows} ids ({nread} live) x {row_b} B")
    del dst

    # a prefill chunk at start 2048: 4 x 256 queries x top-2048 over 2048
    # prior positions per slot, local ids -1 (one layer's call)
    start = 2048
    pids = prefill_ids(torch, g, dev, B, C, K, start, -(-S // R) * R)
    require(gops.staged_route(pids.numel(), NP * R),
            "the prefill call must take the staged route")
    ndist, nlive = distinct_live(torch, pids, NP * R), int((pids >= 0).sum())
    tier_dev = host.to(dev)
    fetched = torch.zeros(1, dtype=torch.int32, device=dev)
    got = gops.gather_rows(host, pids, fetched=fetched)
    want = gref.gather_rows_ref(tier_dev, pids)
    torch.cuda.synchronize()
    require(torch.equal(got, want), "gather_rows (staged) differs")
    require(int(fetched) == ndist,
            f"gather_rows (staged) read {int(fetched)} rows, {ndist} distinct")
    del got, want
    npre = pids.numel()
    cdst = torch.empty((ndist, D), dtype=torch.bfloat16, device=dev)
    nb, _ = bound_ms(npre * row_b + 8 * npre, 0, "bf16",
                     host_bytes=ndist * row_b)
    records["gather_rows[prefill]"] = dict(
        name="gather_rows[prefill]", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        replaces="src/repro/kernels/gather_cache/gather_cache.py:46",
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: gops.gather_rows(host, pids), iters=5,
                    warmup=1),
        device_ms=graph_ms(torch, lambda: gops.gather_rows(host, pids),
                           iters=5),
        # the direct kernel on the same ids, cut into launches of at most
        # the view's rows (what the prefill paid before the staged route)
        direct_ms=timed_ms(torch, lambda: [gops.gather_rows(host, part)
                                           for part in pids.view(-1).split(
                                               NP * R)], iters=2, warmup=1),
        # the plain version on a device copy of the tier (on the host it
        # takes seconds at this size)
        plain_ms=timed_ms(torch, lambda: gref.gather_rows_ref(tier_dev, pids),
                          iters=3, warmup=1),
        bound_ms=nb, bound_by="bytes", library_ms=None,
        copy_ms=timed_ms(torch, lambda: cdst.copy_(host[:ndist],
                                                   non_blocking=True)),
        distinct_rows=ndist, live_ids=nlive,
        shape=f"staged route, ids {list(pids.shape)} ({nlive} live, "
              f"{ndist} distinct) x {row_b} B")
    del cdst, tier_dev, host
    torch.cuda.empty_cache()

    # -- scatter_rows: the stacked prefill flush (4 layers x B x 256 rows) --
    Lh = 4
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
    # rows read + the targets in HBM, the kept rows written over the link
    nkept = int((tgt >= 0).sum())
    nb, _ = bound_ms(nkept * row_b + 8 * n, 0, "bf16",
                     host_bytes=nkept * row_b)
    records["scatter_rows"] = dict(
        name="scatter_rows", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        # no Pallas kernel: the reference's XLA host-compute scatter
        replaces="src/repro/core/offload.py:274",
        max_abs_err=0.0,
        ms=timed_ms(torch, lambda: gops.scatter_rows(tier, tgt, rows)),
        plain_ms=wall_ms(torch, lambda: gref.scatter_rows_ref(
            want_tier, tgt.cpu(), rows.cpu())),
        bound_ms=nb, bound_by="bytes", library_ms=None,
        # the same bytes as one contiguous device -> pinned copy
        copy_ms=timed_ms(torch, lambda: host_dst.copy_(
            rows, non_blocking=True)))

    # -- gather_rows_dequant: the decode miss fetch of an int8 / fp8 tier
    #    (one layer of the serve cell's pinned tier, 4 slots x 256 rows,
    #    direct route) and the prefill chunk's call above (staged route) --
    from repro_torch.distributed import compression as cmp
    ids = torch.randint(0, NP * R, (B * M,), generator=g, device=dev)
    ids[::7] = -1
    nread = int((ids >= 0).sum())
    deq, deq_pre = {}, {}
    for qname in ("fp8", "int8"):            # int8 last: its tier is timed
        q, sc = cmp.quantize_rows(randn((NP * R, D)), cmp.CACHE_QUANT_DTYPES[
            qname])
        q, sc = q.cpu().pin_memory(), sc.cpu().pin_memory()
        for out_dt in (torch.bfloat16, torch.float32):
            got = gops.gather_rows_dequant(q, sc, ids, out_dt)
            want = gref.gather_rows_dequant_ref(q, sc, ids.cpu(), out_dt)
            torch.cuda.synchronize()
            require(torch.equal(got.cpu().view(torch.uint8),
                                want.view(torch.uint8)),
                    f"gather_rows_dequant differs ({qname}, {out_dt})")
        deq[qname] = dict(
            ms=timed_ms(torch, lambda: gops.gather_rows_dequant(q, sc, ids)),
            device_ms=graph_ms(torch, lambda: gops.gather_rows_dequant(
                q, sc, ids)),
            plain_ms=wall_ms(torch, lambda: gref.gather_rows_dequant_ref(
                q, sc, ids.cpu()).to(dev)),
            # the same rows' payload alone, by the plain row gather: the
            # difference is the cost of the 2-byte scale reads (and of
            # writing bf16 instead of one byte)
            payload_ms=timed_ms(torch, lambda: gops.gather_rows(q, ids)),
            payload_device_ms=graph_ms(torch, lambda: gops.gather_rows(
                q, ids)),
            host_us=host_us(torch, lambda: gops.gather_rows_dequant(
                q, sc, ids), False),
            host_us_uncached=host_us(torch, lambda: gops.gather_rows_dequant(
                q, sc, ids), True))
        # the prefill call on this tier, against the plain version on a
        # device copy of the tier
        qd, sd = q.to(dev), sc.to(dev)
        fetched = torch.zeros(1, dtype=torch.int32, device=dev)
        got = gops.gather_rows_dequant(q, sc, pids, fetched=fetched)
        want = gref.gather_rows_dequant_ref(qd, sd, pids)
        torch.cuda.synchronize()
        require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                f"gather_rows_dequant (staged, {qname}) differs")
        require(int(fetched) == ndist,
                f"gather_rows_dequant (staged, {qname}) read "
                f"{int(fetched)} rows, {ndist} distinct")
        del got, want
        deq_pre[qname] = dict(
            ms=timed_ms(torch, lambda: gops.gather_rows_dequant(q, sc, pids),
                        iters=5, warmup=1),
            device_ms=graph_ms(torch, lambda: gops.gather_rows_dequant(
                q, sc, pids), iters=5),
            direct_ms=timed_ms(torch, lambda: [
                gops.gather_rows_dequant(q, sc, part)
                for part in pids.view(-1).split(NP * R)], iters=2, warmup=1),
            plain_ms=timed_ms(torch, lambda: gref.gather_rows_dequant_ref(
                qd, sd, pids), iters=3, warmup=1))
        del qd, sd
        torch.cuda.empty_cache()
    # int8 (the serve's quantized tier): copies of the same bytes
    pay = torch.empty((max(nrows, ndist), D), dtype=q.dtype, device=dev)
    scd = torch.empty((max(nrows, ndist), 1), dtype=torch.float16,
                      device=dev)

    def copy_q8(n):
        pay[:n].copy_(q[:n], non_blocking=True)
        scd[:n].copy_(sc[:n], non_blocking=True)
    # rows read (payload + scale) over the link; bf16 rows written + the ids
    nb, _ = bound_ms(nrows * 2 * D + 8 * nrows, 0, "bf16",
                     host_bytes=nread * (D + 2))
    records["gather_rows_dequant"] = dict(
        name="gather_rows_dequant", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        replaces="src/repro/kernels/gather_cache/gather_cache.py:79",
        max_abs_err=0.0, ms=deq["int8"]["ms"],
        device_ms=deq["int8"]["device_ms"],
        plain_ms=deq["int8"]["plain_ms"], bound_ms=nb, bound_by="bytes",
        library_ms=None, copy_ms=timed_ms(torch, lambda: copy_q8(nrows)),
        host_us=deq["int8"]["host_us"],
        host_us_uncached=deq["int8"]["host_us_uncached"], detail=deq,
        shape=f"direct route, {nrows} ids ({nread} live) x ({D} + 2) B "
              f"int8, bf16 out")
    nb, _ = bound_ms(npre * 2 * D + 8 * npre, 0, "bf16",
                     host_bytes=ndist * (D + 2))
    records["gather_rows_dequant[prefill]"] = dict(
        name="gather_rows_dequant[prefill]", route="cuda",
        source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
        replaces="src/repro/kernels/gather_cache/gather_cache.py:79",
        max_abs_err=0.0, ms=deq_pre["int8"]["ms"],
        device_ms=deq_pre["int8"]["device_ms"],
        direct_ms=deq_pre["int8"]["direct_ms"],
        plain_ms=deq_pre["int8"]["plain_ms"], bound_ms=nb, bound_by="bytes",
        library_ms=None, copy_ms=timed_ms(torch, lambda: copy_q8(ndist)),
        distinct_rows=ndist, live_ids=nlive, detail=deq_pre,
        shape=f"staged route, ids {list(pids.shape)} ({nlive} live, "
              f"{ndist} distinct) x ({D} + 2) B int8, bf16 out")
    del q, sc, pay, scd, pids

    # -- the page kernels (TMA ring): gather_pages and its dequant variant
    #    at the graft shape (one slot's 129 pages in every layer, 4, of the
    #    serve cell's tier) and at the pack shape (an 8192-token prompt's
    #    128 pages), bf16 and int8; the pack's two routes; the install ----
    Lh = 4
    NBs = -(-S // R)
    PAGE_SRC = "src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu"

    def page_ids(n):
        return torch.arange(2 * NBs, 2 * NBs + n, device=dev)

    def want_pages(t, ids):
        return gref.gather_pages_ref(t, ids.cpu()[None].expand(Lh, -1), R)
    tier = randn((Lh, NP * R, D)).cpu().pin_memory()
    q, sc = cmp.quantize_rows(randn((Lh, NP * R, D)), torch.int8)
    q, sc = q.cpu().pin_memory(), sc.cpu().pin_memory()
    for n in (NBs, NBs - 1):
        pids = page_ids(n)
        got = gops.gather_pages(tier, pids, R)
        gq, gs = gops.gather_pages(q, pids, R, scales=sc)
        torch.cuda.synchronize()
        require(torch.equal(got.cpu(), want_pages(tier, pids))
                and torch.equal(gq.cpu(), want_pages(q, pids))
                and torch.equal(gs.cpu(), want_pages(sc, pids)),
                f"gather_pages differs ({n} pages)")
        for out_dt in (torch.bfloat16, torch.float32):
            got = gops.gather_pages_dequant(q, sc, pids, R, out_dt)
            want = gref.gather_pages_dequant_ref(
                q, sc, pids.cpu()[None].expand(Lh, -1), R, out_dt)
            torch.cuda.synchronize()
            require(torch.equal(got.cpu().view(torch.uint8),
                                want.view(torch.uint8)),
                    f"gather_pages_dequant differs ({n} pages, {out_dt})")
    del got, gq, gs, want

    def page_record(name, replaces, fn, plain, nbytes, host_bytes, copy,
                    **extra):
        nb, by = bound_ms(nbytes, 0, "bf16", host_bytes=host_bytes)
        return dict(name=name, route="cuda", source=PAGE_SRC,
                    replaces=replaces, max_abs_err=0.0,
                    ms=timed_ms(torch, fn, iters=10),
                    device_ms=graph_ms(torch, fn, iters=10),
                    plain_ms=wall_ms(torch, plain, iters=3),
                    bound_ms=nb, bound_by=by, library_ms=None,
                    copy_ms=timed_ms(torch, copy, iters=10), **extra)

    def h2d(n_rows, planes):
        """The copy engine moving the same bytes: contiguous pinned ->
        device copies of ``n_rows`` rows of each plane."""
        dsts = [torch.empty((n_rows, t.shape[-1]), dtype=t.dtype,
                            device=dev) for t in planes]

        def run():
            for d_, t in zip(dsts, planes):
                d_.copy_(t.view(-1, t.shape[-1])[:n_rows],
                         non_blocking=True)
        return run
    R5 = "src/repro/kernels/gather_cache/gather_cache.py:111"
    R6 = "src/repro/kernels/gather_cache/gather_cache.py:145"
    # the graft: device out
    pids = page_ids(NBs)
    pe = Lh * NBs * R * D                                  # elements
    records["gather_pages"] = page_record(
        "gather_pages", R5, lambda: gops.gather_pages(tier, pids, R),
        lambda: want_pages(tier, pids).to(dev), 2 * pe + 8 * Lh * NBs,
        2 * pe, h2d(Lh * NBs * R, [tier]),
        shape=f"graft: {Lh} layers x {NBs} pages x {R} x {2 * D} B, "
              f"device out")
    records["gather_pages_dequant"] = page_record(
        "gather_pages_dequant", R6,
        lambda: gops.gather_pages_dequant(q, sc, pids, R),
        lambda: gref.gather_pages_dequant_ref(
            q, sc, pids.cpu()[None].expand(Lh, -1), R).to(dev),
        2 * pe + 8 * Lh * NBs, pe + Lh * NBs * R * 2,
        h2d(Lh * NBs * R, [q, sc]),
        shape=f"graft: {Lh} x {NBs} pages x {R} x ({D} + 2) B int8, bf16 "
              f"out")
    # the pack shape (128 pages): #6 re-timed there for information; #5
    # writes straight into a pinned packet (route (a)), timed beside route
    # (b), the kernel into device memory and one device -> pinned copy
    pids = page_ids(NBs - 1)
    pe = Lh * (NBs - 1) * R * D
    n_rows = Lh * (NBs - 1) * R
    nb6, _ = bound_ms(2 * pe, 0, "bf16", host_bytes=pe + n_rows * 2)
    records["gather_pages_dequant"].update(
        pack_shape_ms=timed_ms(torch, lambda: gops.gather_pages_dequant(
            q, sc, pids, R), iters=10),
        pack_shape_device_ms=graph_ms(torch, lambda: gops.gather_pages_dequant(
            q, sc, pids, R), iters=10),
        pack_shape_bound_ms=nb6,
        pack_shape_copy_ms=timed_ms(torch, h2d(n_rows, [q, sc]), iters=10))
    for tag, src, ssc in (("", tier, None), ("-int8", q, sc)):
        row_b = D * src.element_size() + (0 if ssc is None else 2)
        out = torch.empty((Lh, n_rows // Lh, D), dtype=src.dtype,
                          pin_memory=True)
        osc = None if ssc is None else torch.empty(
            (Lh, n_rows // Lh, 1), dtype=torch.float16, pin_memory=True)
        kw = dict(scales=ssc, out=out, out_scales=osc)
        got = gops.gather_pages(src, pids, R, **kw)
        torch.cuda.synchronize()
        require(torch.equal(out, want_pages(src, pids)) and (
            ssc is None or torch.equal(osc, want_pages(ssc, pids))),
            f"gather_pages into a pinned packet differs{tag}")
        dev_out = torch.empty(out.shape, dtype=out.dtype, device=dev)
        dev_osc = None if osc is None else torch.empty(
            osc.shape, dtype=osc.dtype, device=dev)

        def route_b():
            gops.gather_pages(src, pids, R, scales=ssc, out=dev_out,
                              out_scales=dev_osc)
            out.copy_(dev_out, non_blocking=True)
            if osc is not None:
                osc.copy_(dev_osc, non_blocking=True)
        # read over the link one way, written over it the other: the bound
        # is the larger over one direction's peak
        records[f"gather_pages[pack{tag}]"] = page_record(
            f"gather_pages[pack{tag}]", R5,
            lambda: gops.gather_pages(src, pids, R, **kw),
            lambda: [t.pin_memory() for t in (
                [want_pages(src, pids)] if ssc is None
                else [want_pages(src, pids), want_pages(ssc, pids)])],
            8 * Lh * (NBs - 1), n_rows * row_b,
            h2d(n_rows, [src] if ssc is None else [src, ssc]),
            route_b_ms=timed_ms(torch, route_b, iters=10),
            shape=f"pack: {Lh} x {NBs - 1} pages x {R} x {row_b} B into "
                  f"a pinned packet (route (a))")
        # the install: the packet's pages into a pinned tier at fresh ids
        dst = torch.zeros_like(src).pin_memory()
        dsc = None if ssc is None else torch.zeros_like(ssc).pin_memory()
        new = torch.randperm(NP, device=dev)[:NBs - 1]
        gops.put_pages(dst, new, out.view(Lh, -1, D), R, dst_scales=dsc,
                       src_scales=osc)
        torch.cuda.synchronize()
        require(torch.equal(want_pages(dst, new), out) and (
            ssc is None or torch.equal(want_pages(dsc, new), osc)),
            f"put_pages differs{tag}")
        records[f"put_pages[install{tag}]"] = page_record(
            f"put_pages[install{tag}]",
            "src/repro/cluster/kv_transfer.py:155",
            lambda: gops.put_pages(dst, new, out.view(Lh, -1, D), R,
                                   dst_scales=dsc, src_scales=osc),
            lambda: gops.put_pages(dst, new.cpu(), out.view(Lh, -1, D), R,
                                   dst_scales=dsc, src_scales=osc),
            8 * Lh * (NBs - 1), n_rows * row_b,
            h2d(n_rows, [src] if ssc is None else [src, ssc]),
            shape=f"install: {Lh} x {NBs - 1} pages x {row_b} B, pinned "
                  f"packet -> pinned tier")
        del out, osc, dev_out, dev_osc, dst, dsc
    del tier, q, sc, pids
    torch.cuda.empty_cache()

    # -- gather_rows_raw: the pipelined round's slab gather, one launch over
    #    every layer of the serve cell's stacked tier (ids [L, B, P], P the
    #    miss envelope, 256 a slot), bf16 rows, and an int8 / fp8 tier's
    #    payload with its scale, raw ------------------------------------
    P = M
    sids = (torch.randint(0, NP * R, (Lh, B, P), generator=g, device=dev)
            + torch.arange(Lh, device=dev)[:, None, None] * (NP * R))
    sids.view(-1)[::7] = -1
    ns, nread = sids.numel(), int((sids >= 0).sum())
    for tname in ("bf16", "fp8", "int8"):
        flat = randn((Lh * NP * R, D))
        scl = None
        if tname != "bf16":
            flat, scl = cmp.quantize_rows(flat,
                                          cmp.CACHE_QUANT_DTYPES[tname])
            scl = scl.cpu().pin_memory()
        flat = flat.cpu().pin_memory()
        fetched = torch.zeros(1, dtype=torch.int32, device=dev)
        got, got_s = gops.gather_rows_raw(flat, scl, sids, fetched=fetched)
        want, want_s = gref.gather_rows_raw_ref(flat, scl, sids.cpu())
        torch.cuda.synchronize()
        require(torch.equal(got.cpu().view(torch.uint8),
                            want.view(torch.uint8))
                and (scl is None or torch.equal(
                    got_s.cpu().view(torch.int16), want_s.view(torch.int16)))
                and int(fetched) == nread,
                f"gather_rows_raw differs ({tname})")
        if tname == "fp8":
            continue
        row_b = D * flat.element_size() + (0 if scl is None else 2)
        sdst = torch.empty((ns, D), dtype=flat.dtype, device=dev)
        ssd = torch.empty((ns, 1), dtype=torch.float16, device=dev)

        def copy_slab():
            sdst.copy_(flat[:ns], non_blocking=True)
            if scl is not None:
                ssd.copy_(scl[:ns], non_blocking=True)
        # rows (and scales) read over the link; written + the ids in HBM
        nb, _ = bound_ms(ns * row_b + 8 * ns, 0, "bf16",
                         host_bytes=nread * row_b)
        name = "gather_rows_raw[slab]" if scl is None \
            else "gather_rows_raw[slab-int8]"
        records[name] = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
            replaces="src/repro/kernels/gather_cache/gather_cache.py:46",
            max_abs_err=0.0,
            ms=timed_ms(torch, lambda: gops.gather_rows_raw(flat, scl, sids)),
            device_ms=graph_ms(torch, lambda: gops.gather_rows_raw(
                flat, scl, sids)),
            plain_ms=wall_ms(torch, lambda: [
                t.to(dev) for t in gref.gather_rows_raw_ref(
                    flat, scl, sids.cpu()) if t is not None]),
            bound_ms=nb, bound_by="bytes", library_ms=None,
            # the same bytes as contiguous pinned -> device copies
            copy_ms=timed_ms(torch, copy_slab),
            shape=f"direct route, ids [{Lh}, {B}, {P}] ({ns} ids, {nread} "
                  f"live) x " + (f"{row_b} B" if scl is None
                                 else f"({D} + 2) B {tname}, raw"))
        del flat, scl, sdst, ssd, got, want
    torch.cuda.empty_cache()

    # -- indexer_scores: the decode case (Q = 1 over the whole cache) and a
    #    causal prefill chunk (Q = 256 ending at each slot's length), each
    #    on the tensor-core route against the plain version, timed beside
    #    the general route on the same inputs; for information, cuBLAS's
    #    dots alone (bmm) and the stable-sort top-k of the scores --------
    from repro_torch.models.mla import topk_desc

    def indexer_case(tag, Q, causal, nb=B, ns=S, at=lens):
        """``nb`` slots of ``ns`` keys, each slot ``at`` its length."""
        q = randn((nb, Q, Hi, Di))
        w = randn((nb, Q, Hi))
        keys = randn((nb, ns, Di))
        if causal:
            qpos = at[:, None] - Q + torch.arange(Q, device=dev)
            valid = torch.arange(ns, device=dev)[None, None] \
                <= qpos[..., None]
        else:
            valid = (torch.arange(ns, device=dev)[None, None]
                     < at[:, None, None]).expand(nb, Q, ns)
        require(iops.tc_route(q, keys), f"indexer {tag}: not the tc route")
        got = iops.indexer_scores(q, w, keys, valid)
        gen = iops.general_scores(q, w, keys, valid)
        want = iref.indexer_scores_ref(q, w, keys, valid)
        torch.cuda.synchronize()
        err = 0.0
        live = want != -2.0e38
        for a, route in ((got, "tc"), (gen, "general")):
            require(torch.equal(a == -2.0e38, ~live),
                    f"indexer {tag} ({route}): -2e38 positions differ")
            torch.testing.assert_close(a[live], want[live], rtol=1e-4,
                                       atol=1e-3)
            err = max(err, float((a[live] - want[live]).abs().max()))
        del gen
        # top-2048 of the kernel's scores against the plain version's
        ia, ib = topk_desc(got, K), topk_desc(want, K)
        hit = torch.zeros(got.shape, dtype=torch.bool, device=dev)
        hit = hit.scatter_(2, ia, True).gather(2, ib)
        overlap = float(hit.float().mean())
        del want, ia, ib, hit, live
        nvalid = int(valid.sum())
        nbytes = (q.numel() + w.numel()) * 2 + key_bytes(keys, valid) \
            + valid.numel() + 4 * got.numel()
        bms, bby = bound_ms(nbytes, nvalid * Hi * (2 * Di + 2), "bf16")
        it = 3 if Q > 2 else 20
        qh = q.reshape(nb, Q * Hi, Di).transpose(1, 2)         # [B,Di,Q*Hi]
        rec = dict(
            name=f"indexer_scores[{tag}]", route="cuda",
            source="src/repro_torch/kernels/indexer/csrc/indexer_tc.cu",
            replaces="src/repro/kernels/indexer/indexer.py:41",
            max_abs_err=err,
            ms=timed_ms(torch, lambda: iops.indexer_scores(q, w, keys, valid),
                        iters=max(it, 10)),
            device_ms=graph_ms(torch, lambda: iops.indexer_scores(
                q, w, keys, valid), iters=max(it, 10)),
            general_ms=timed_ms(torch, lambda: iops.general_scores(
                q, w, keys, valid), iters=it, warmup=1),
            general_device_ms=graph_ms(torch, lambda: iops.general_scores(
                q, w, keys, valid), iters=it),
            plain_ms=timed_ms(torch, lambda: iref.indexer_scores_ref(
                q, w, keys, valid), iters=it, warmup=1),
            bound_ms=bms, bound_by=bby, library_ms=None,
            # information only: the dots alone on cuBLAS, and the top-k
            bmm_ms=timed_ms(torch, lambda: torch.bmm(keys, qh), iters=it),
            topk_ms=timed_ms(torch, lambda: topk_desc(got, K), iters=it,
                             warmup=1),
            valid_pairs=nvalid,
            shape=f"q {list(q.shape)}, keys {list(keys.shape)} bf16, "
                  f"{'causal' if causal else 'decode'} mask, {nvalid} "
                  f"valid pairs")
        if causal:
            rec["top2048_overlap"] = overlap
            require(overlap >= 0.999, f"indexer {tag}: top-{K} overlap with "
                    f"the plain scores {overlap:.5f} < 0.999")
        records[rec["name"]] = rec

    indexer_case("decode", 1, False)
    indexer_case("prefill", C, True)
    # the long-prompt phase's shapes, keys over its max_seq: the round in
    # which rid 1 decodes (rid 0 about 130 tokens into its decode), and
    # rid 1's last prefill chunk (queries at 32512..32767, causal)
    indexer_case("decode-32k", 1, False, nb=LONG_SLOTS, ns=LONG_MAX_SEQ,
                 at=torch.tensor([LONG_PROMPTS[0] + 130, LONG_PROMPTS[1] + 1],
                                 device=dev))
    indexer_case("prefill-32k", C, True, nb=1, ns=LONG_MAX_SEQ,
                 at=torch.tensor([LONG_PROMPTS[1]], device=dev))
    torch.cuda.empty_cache()

    # -- sparse_mla_partial: the tensor-core route at the serve's three
    #    shapes (Attn0 K=2048, Attn1 K=256 at decode; a whole prefill chunk
    #    of per-query rows), each held against the fp32 plain version and
    #    timed beside the general route on the same inputs, the plain
    #    version and SDPA on the same MQA; then the split merge ----------
    def mla_hold(got, want):
        """rtol 1e-4, atol 1e-4 x max(1, |ref|max) over the non-sentinel
        values; the -2e38 sentinels must sit at the same places."""
        e = 0.0
        for a, b in zip(got, want):
            live = b > -1e37
            require(torch.equal(a > -1e37, live),
                    "sparse_mla sentinel positions differ")
            tol = 1e-4 * max(1.0, float(b[live].abs().max())
                             if bool(live.any()) else 0.0)
            torch.testing.assert_close(a, b, rtol=1e-4, atol=tol)
            e = max(e, float((a - b).abs().max()))
        return e

    def mla_case(tag, Q, Krows, per_query, shared=False):
        """``shared``: per-query rows that are one [B,Krows,D] set expanded
        over Q (stride 0), each query with its own mask, as the verify
        step's Attn1 passes the fetched rows."""
        qq = randn((B, Q, H, D))
        shape = (B, Q, Krows, D) if per_query else (B, Krows, D)
        base = randn((B, Krows, D)) if shared else None
        rr = base[:, None].expand(shape) if shared else randn(shape)
        vv = torch.rand(shape[:-1], generator=g, device=dev) < 0.9
        vv[..., -17:] = False
        zq = min(3, Q - 1) if per_query else 0
        if per_query:
            vv[1, zq] = False               # query (1, zq): no valid row
        else:
            vv[1] = False                   # batch 1's query: no valid row
        r4 = rr if per_query else rr[:, None]
        v4 = vv if per_query else vv[:, None]
        require(sops.tc_route(qq, rr, rank), f"{tag}: not the tc route")
        got = sops.partial_attend(qq, rr, vv, scale, rank)
        want = sref.sparse_mla_partial_ref(qq, r4, v4, scale, rank)
        gen = sops.general_attend(qq, rr, vv, scale, rank)
        torch.cuda.synchronize()
        e = mla_hold(got, want)
        mla_hold(gen, want)
        del want, gen
        require(bool((got.m[1, zq] == -2.0e38).all())
                and bool((got.l[1, zq] == 0).all())
                and bool((got.o[1, zq] == 0).all()),
                f"{tag}: the all-invalid query is not the sentinel partial")
        nvalid = int(v4.expand(B, Q, Krows).sum())
        # the distinct rows are read once, shared or not
        nbytes = (qq.numel() + (base if shared else rr).numel()) * 2 \
            + vv.numel() + 4 * B * Q * H * (rank + 2)
        bms, bby = bound_ms(nbytes, nvalid * H * 2 * (D + rank), "bf16")
        # SDPA on the same MQA: the heads are the query positions
        qs = qq.reshape(B * Q, 1, H, D)
        kk = r4.expand(B, Q, Krows, D).reshape(B * Q, 1, Krows, D)
        mask = v4.expand(B, Q, Krows).reshape(B * Q, 1, 1, Krows)
        it = 3 if Q > 2 else 20

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, kk, kk[..., :rank], attn_mask=mask, scale=scale)
        rec = dict(
            name=f"sparse_mla_partial[{tag}]", route="cuda",
            source="src/repro_torch/kernels/sparse_mla/csrc/sparse_mla_tc.cu",
            replaces="src/repro/kernels/sparse_mla/sparse_mla.py:74",
            max_abs_err=e,
            ms=timed_ms(torch, lambda: sops.partial_attend(
                qq, rr, vv, scale, rank), iters=max(it, 10)),
            device_ms=graph_ms(torch, lambda: sops.partial_attend(
                qq, rr, vv, scale, rank), iters=max(it, 10)),
            general_ms=timed_ms(torch, lambda: sops.general_attend(
                qq, rr, vv, scale, rank), iters=it, warmup=1),
            plain_ms=timed_ms(torch, lambda: sref.sparse_mla_partial_ref(
                qq, r4, v4, scale, rank), iters=it, warmup=1),
            bound_ms=bms, bound_by=bby,
            library_ms=timed_ms(torch, sdpa, iters=it, warmup=1),
            nsplit=sops.plan_splits(B * Q, H, Krows, torch.cuda
                                    .get_device_properties(dev)
                                    .multi_processor_count)[0],
            shape=f"q {list(qq.shape)}, rows {list(rr.shape)} bf16"
                  + (f" (one [{B},{Krows},{D}] set expanded over Q)"
                     if shared else ""))
        if Q <= 2:      # SDPA's device time, as the kernel's (a graph)
            rec["library_device_ms"] = graph_ms(torch, sdpa)
        records[rec["name"]] = rec
        return qq, rr, vv

    qq, rr, vv = mla_case("attn0", 1, K, False)
    mla_case("attn1", 1, M, False)
    # the merge kernel on Attn0's split partials, against its plain version
    parts = sops.tc_splits(qq, rr, vv, scale)
    got = sops.merge_splits(*parts)
    want = sref.merge_splits_ref(*parts)
    torch.cuda.synchronize()
    merr = 0.0
    for a, b in zip(got, want):   # summation order only
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        merr = max(merr, float((a - b).abs().max()))
    nsp = parts[0].shape[0]
    nb, _ = bound_ms(4 * (nsp + 1) * B * H * (rank + 2), 0, "bf16")
    records["sparse_mla_merge"] = dict(
        name="sparse_mla_merge", route="cuda",
        source="src/repro_torch/kernels/sparse_mla/csrc/sparse_mla_tc.cu",
        replaces="src/repro/kernels/sparse_mla/sparse_mla.py:74",
        max_abs_err=merr,
        ms=timed_ms(torch, lambda: sops.merge_splits(*parts)),
        device_ms=graph_ms(torch, lambda: sops.merge_splits(*parts)),
        plain_ms=timed_ms(torch, lambda: sref.merge_splits_ref(*parts)),
        bound_ms=nb, bound_by="bytes", library_ms=None,
        shape=f"{nsp} splits of o [4,1,128,512], m, l fp32")
    del qq, rr, vv, parts, got, want
    # a whole prefill chunk: 4 x 256 queries, each over its own 2048 rows
    mla_case("prefill", C, K, True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # -- the MTP verify step (depth 1, Q = 2) at session C's shapes: the
    #    indexer with each query causal over the cache (query j sees the
    #    keys below its slot's length - 1 + j), Attn0 over each query's own
    #    top-K pool rows, Attn1 over the fetched envelope of both queries
    #    (2 x 256 rows, shared, each query masked to the rows it asked for)
    indexer_case("verify", 2, True)
    mla_case("attn0-verify", 2, K, True)
    mla_case("attn1-verify", 2, 2 * M, True, shared=True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # -- the monolithic decode: one query over its own 2048 gathered rows
    mla_case("mono-decode", 1, K, True)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return records


def check_monolithic_kernels(torch, dev, records):
    """Phase 3, the generic path's new routes: the row gather over a
    device-resident ``[B,S,576]`` cache at the decode shape (ids [4,2048])
    and a prefill chunk's (ids [4, 256 x 2048]), bit for bit, each timed on
    both routes beside ``torch.index_select`` on the same ids (the library
    column); ``topk_select`` at the decode shape (the indexer, then the
    stable sort; its top-2048 against the plain scores'); then the two
    kernels together, ``sparse_mla_gather_attend``, at both shapes against
    their plain versions at 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.gather_cache import ops as gops
    from repro_torch.kernels.gather_cache import ref as gref
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.kernels.indexer import ref as iref
    from repro_torch.kernels.sparse_mla import ops as sops
    from repro_torch.kernels.sparse_mla import ref as sref
    from repro_torch.models.mla import mla_scale, topk_desc

    cfg = get_config("deepseek-v32-exp-ess")
    g = torch.Generator(device=dev).manual_seed(2121)
    B, S, C = 4, 8224, PREFILL_CHUNK
    D, rank, H = cfg.mla.latent_dim, cfg.mla.kv_lora_rank, cfg.num_heads
    Hi, Di, K = cfg.dsa.index_heads, cfg.dsa.index_dim, cfg.dsa.index_topk
    scale = mla_scale(cfg)
    lens = torch.tensor([8193, 8200, 8207, 8224], device=dev)

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    cache = randn((B, S, D))
    flat = cache.view(B * S, D)
    pos = torch.arange(S, device=dev)
    off = torch.arange(B, device=dev)[:, None] * S
    # decode: each slot's top-K of random scores over its valid positions;
    # prefill: C queries ending at each slot's length, each causal
    valid_d = pos[None] < lens[:, None]                           # [B,S]
    sc = torch.rand((B, 1, S), generator=g, device=dev)
    ids_d = sc.masked_fill(~valid_d[:, None], -1.0).topk(K, -1).indices
    qpos = lens[:, None] - C + torch.arange(C, device=dev)        # [B,C]
    valid_p = pos[None, None] <= qpos[..., None]                  # [B,C,S]
    sc = torch.rand((B, C, S), generator=g, device=dev)
    ids_p = sc.masked_fill(~valid_p, -1.0).topk(K, -1).indices    # [B,C,K]
    del sc

    def gather_case(tag, ids):
        """The gather as ``sparse_mla_gather_attend`` calls it: the flat
        cache, the ids offset by b * S."""
        m = ids.numel()
        fids = (ids.reshape(B, -1) + off).reshape(-1)
        want = gref.gather_rows_ref(flat, fids)
        for route in ("direct", "staged"):
            got = gops.gather_rows(flat, fids, route=route)
            torch.cuda.synchronize()
            require(torch.equal(got.view(-1, D), want),
                    f"gather_rows[hbm-{tag}] ({route}) differs")
            del got
        del want
        ndist = int(fids.unique().numel())
        nb, _ = bound_ms((ndist + m) * D * 2 + 8 * m, 0, "bf16")
        it = 5 if m > 10**5 else 20

        def run(route=None):
            return lambda: gops.gather_rows(flat, fids, route=route)
        rule = "staged" if gops.staged_route(m, B * S, host=False) \
            else "direct"
        records[f"gather_rows[hbm-{tag}]"] = dict(
            name=f"gather_rows[hbm-{tag}]", route="cuda",
            source="src/repro_torch/kernels/gather_cache/csrc/gather_rows.cu",
            replaces="src/repro/kernels/gather_cache/gather_cache.py:46",
            max_abs_err=0.0,
            ms=timed_ms(torch, run(), iters=it),
            device_ms=graph_ms(torch, run(), iters=it),
            direct_ms=timed_ms(torch, run("direct"), iters=it),
            direct_device_ms=graph_ms(torch, run("direct"), iters=it),
            staged_ms=timed_ms(torch, run("staged"), iters=it),
            staged_device_ms=graph_ms(torch, run("staged"), iters=it),
            plain_ms=timed_ms(torch, lambda: gref.gather_rows_ref(
                flat, fids), iters=it),
            bound_ms=nb, bound_by="bytes",
            library_ms=timed_ms(torch, lambda: torch.index_select(
                flat, 0, fids), iters=it),
            library_device_ms=graph_ms(torch, lambda: torch.index_select(
                flat, 0, fids), iters=it),
            distinct_rows=ndist,
            shape=f"HBM cache [{B}, {S}, {D}] bf16, ids [{B}, {m // B}] "
                  f"({ndist} distinct rows); the rule's route: {rule}")

    gather_case("decode", ids_d)
    gather_case("prefill", ids_p)
    torch.cuda.empty_cache()

    # topk_select at the decode shape: the scores kernel, then the stable
    # sort (lax.top_k's tie order)
    q, w, keys = randn((B, 1, Hi, Di)), randn((B, 1, Hi)), randn((B, S, Di))
    vals, ids = iops.topk_select(q, w, keys, valid_d, K)
    want = iref.indexer_scores_ref(q, w, keys, valid_d)
    wids = topk_desc(want, K)
    torch.cuda.synchronize()
    hit = torch.zeros(want.shape, dtype=torch.bool, device=dev)
    overlap = float(hit.scatter_(2, ids, True).gather(2, wids).float().mean())
    require(overlap >= 0.999, f"topk_select: top-{K} overlap with the "
            f"plain version {overlap:.5f} < 0.999")
    torch.testing.assert_close(vals, want.gather(2, ids), rtol=1e-4,
                               atol=1e-3)
    err = float((vals - want.gather(2, ids)).abs().max())
    nvalid = int(valid_d.sum())
    nbytes = (q.numel() + w.numel()) * 2 + key_bytes(keys, valid_d) \
        + valid_d.numel() + B * K * (4 + 8)
    bms, bby = bound_ms(nbytes, nvalid * Hi * (2 * Di + 2), "bf16")
    scores = iops.indexer_scores(q, w, keys, valid_d)
    records["indexer_scores[topk_select]"] = dict(
        name="indexer_scores[topk_select]", route="cuda",
        source="src/repro_torch/kernels/indexer/csrc/indexer_tc.cu",
        replaces="src/repro/kernels/indexer/indexer.py:41",
        max_abs_err=err,
        ms=timed_ms(torch, lambda: iops.topk_select(q, w, keys, valid_d, K)),
        device_ms=graph_ms(torch, lambda: iops.topk_select(
            q, w, keys, valid_d, K)),
        sort_ms=timed_ms(torch, lambda: topk_desc(scores, K)),
        plain_ms=timed_ms(torch, lambda: topk_desc(iref.indexer_scores_ref(
            q, w, keys, valid_d), K)),
        bound_ms=bms, bound_by=bby, library_ms=None, top2048_overlap=overlap,
        shape=f"topk_select: q [{B}, 1, {Hi}, {Di}], keys [{B}, {S}, {Di}] "
              f"bf16, k {K} (scores kernel + stable sort)")
    del q, w, keys, vals, ids, want, wids, hit, scores

    # the gather-attend (row gather + partial, normalized) against the
    # plain versions of both, at the decode and the prefill chunk's shapes
    for tag, ids, valid in (("decode", ids_d, valid_d),
                            ("prefill", ids_p, valid_p)):
        Q = ids.shape[1]
        qq = randn((B, Q, H, D))
        fids = (ids.reshape(B, -1) + off).reshape(-1)
        vq = valid if valid.dim() == 3 else valid[:, None].expand(B, Q, S)
        gv = vq.gather(2, ids)

        def plain():
            rows = gref.gather_rows_ref(flat, fids).view(B, Q, K, D)
            o, _, l = sref.sparse_mla_partial_ref(qq, rows, gv, scale, rank)
            return o / l.clamp_min(1e-30)[..., None]

        def kern():
            return sops.sparse_mla_gather_attend(qq, cache, ids, valid, scale,
                                                 rank)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)
        err = float((got.float() - want).abs().max())
        del got, want
        it = 3 if Q > 1 else 20
        print(f"  sparse_mla_gather_attend[{tag}]: q {list(qq.shape)}, ids "
              f"{list(ids.shape)} over the HBM cache: kernels "
              f"{timed_ms(torch, kern, iters=it):.4f} ms (device "
              f"{graph_ms(torch, kern, iters=it):.4f}), plain "
              f"{timed_ms(torch, plain, iters=it, warmup=1):.4f} ms, max "
              f"err {err:.3g} (2e-2)", flush=True)
        del qq
    del cache, flat
    torch.cuda.empty_cache()


def check_v3_kernels(torch, dev, records):
    """Phase 3, DeepSeek-V3's dense-MLA routes of the sparse-MLA partial
    (rows 1a-d / 1c-d): the decode over the whole latent cache, shared by
    the query (q [4,1,128,576], rows [4,8224,576], split and merged), and
    the prefill's last 256-query chunk over the prompt's 8192 rows shared,
    a causal mask per query (the kernel skips each query's tiles past its
    position); each held against the plain version (the prefill's in
    16-query slices: expanded per query, one chunk's rows are 19 GB of
    fp32) and timed beside the general route, the plain version and SDPA
    on the same MQA."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.sparse_mla import ops as sops
    from repro_torch.kernels.sparse_mla import ref as sref
    from repro_torch.models.mla import mla_scale

    cfg = get_config("deepseek-v3-671b")
    g = torch.Generator(device=dev).manual_seed(2323)
    B, C = 4, PREFILL_CHUNK
    D, rank, H = cfg.mla.latent_dim, cfg.mla.kv_lora_rank, cfg.num_heads
    scale = mla_scale(cfg)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    def hold(got, want, e=0.0):
        for a, b in zip(got, want):
            live = b > -1e37
            require(torch.equal(a > -1e37, live),
                    "sparse_mla sentinel positions differ")
            tol = 1e-4 * max(1.0, float(b[live].abs().max()))
            torch.testing.assert_close(a, b, rtol=1e-4, atol=tol)
            e = max(e, float((a - b).abs().max()))
        return e

    def case(tag, qq, rows, valid, slices):
        """valid [B,K] (decode) or [B,Q,K] (prefill); the plain version
        over ``slices`` of the queries."""
        Q, K = qq.shape[1], rows.shape[1]
        v3 = valid if valid.dim() == 3 else valid[:, None]

        def plain():
            out = []
            for q0 in range(0, Q, slices):
                n = min(slices, Q - q0)
                out.append(sref.sparse_mla_partial_ref(
                    qq[:, q0:q0 + n], rows[:, None].expand(B, n, K, D),
                    v3[:, q0:q0 + n].expand(B, n, K), scale, rank))
            return [torch.cat(t, 1) for t in zip(*out)]

        def kern():
            return sops.partial_attend(qq, rows, valid, scale, rank)
        require(sops.tc_route(qq, rows, rank), f"{tag}: not the tc route")
        n_gen = sops.partial_attend.launches_general
        got = kern()
        require(sops.partial_attend.launches_general == n_gen,
                f"{tag}: the partial left the tensor-core route")
        want = plain()
        gen = sops.general_attend(qq, rows, valid, scale, rank)
        torch.cuda.synchronize()
        e = hold(got, want)
        hold(gen, want)
        del got, want, gen
        nvalid = int(v3.expand(B, Q, K).sum())
        nbytes = (qq.numel() + rows.numel()) * 2 + valid.numel() \
            + 4 * B * Q * H * (rank + 2)
        bms, bby = bound_ms(nbytes, nvalid * H * 2 * (D + rank), "bf16")
        # SDPA on the same MQA: the heads of a query are its rows of one
        # sequence over the shared latent rows, the mask per query
        qs = qq.reshape(B, 1, Q * H, D)
        kk = rows[:, None]
        mask = v3.expand(B, Q, K)[:, :, None].expand(B, Q, H, K).reshape(
            B, 1, Q * H, K)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qs, kk, kk[..., :rank], attn_mask=mask, scale=scale)
        it = 3 if Q > 1 else 20
        rec = dict(
            name=f"sparse_mla_partial[{tag}]", route="cuda",
            source="src/repro_torch/kernels/sparse_mla/csrc/sparse_mla_tc.cu",
            replaces="src/repro/kernels/sparse_mla/sparse_mla.py:74",
            max_abs_err=e, ms=timed_ms(torch, kern, iters=max(it, 5)),
            device_ms=graph_ms(torch, kern, iters=max(it, 5)),
            general_ms=timed_ms(torch, lambda: sops.general_attend(
                qq, rows, valid, scale, rank), iters=it, warmup=1),
            plain_ms=timed_ms(torch, plain, iters=1, warmup=1),
            bound_ms=bms, bound_by=bby,
            library_ms=timed_ms(torch, sdpa, iters=it, warmup=1),
            nsplit=sops.plan_splits(B * Q, H, K, n_sm)[0],
            shape=f"q {list(qq.shape)}, rows {list(rows.shape)} shared over "
                  f"the queries, bf16, valid {list(valid.shape)} ({nvalid} "
                  f"valid (query, row) pairs)")
        if Q == 1:      # SDPA's device time, as the kernel's (a graph)
            rec["library_device_ms"] = graph_ms(torch, sdpa)
        records[rec["name"]] = rec

    # decode: each slot's cache valid below its length (V3's monolithic
    # decode after the prompt's 8192 tokens and some rounds)
    S = 8224
    lens = torch.tensor([8193, 8200, 8207, 8224], device=dev)
    case("v3-decode", randn((B, 1, H, D)), randn((B, S, D)),
         torch.arange(S, device=dev)[None] < lens[:, None], 1)
    torch.cuda.empty_cache()
    # prefill: the last chunk of an 8192-token prompt, causal per query
    S = 8192
    qpos = S - C + torch.arange(C, device=dev)
    causal = (torch.arange(S, device=dev)[None, None] <= qpos[None, :, None]
              ).expand(B, C, S).contiguous()
    case("v3-prefill", randn((B, C, H, D)), randn((B, S, D)), causal, 16)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


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
    # the monolithic model on the same input: prefill + 3 decode steps
    from repro_torch.models import transformer as T
    outs = []
    for p, d in ((p_cpu, "cpu"), (p_gpu, dev)):
        pf = E.generic_prefill(p, cfg, toks, pos, device=d)
        caches = T.pad_caches(pf.caches, 48)
        lg = [pf.logits[:, -1]]
        tok = lc[:, -1].argmax(-1)[:, None].to(d)
        for _ in range(3):
            o = E.generic_decode(p, cfg, tok, caches["lens"][:, None],
                                 caches, device=d)
            lg.append(o.logits[:, -1])
            tok = o.logits[:, -1].argmax(-1)[:, None]
        outs.append(torch.stack(lg).cpu())
    torch.cuda.synchronize()
    merr = float((outs[1] - outs[0]).abs().max())
    require(merr <= 1e-3, f"small-input monolithic logits differ by {merr}")
    return max(err, merr)


GRAFT_LEN = 2048


def check_graft(torch, dev, serve, params, tier, counted):
    """Phase 7: prefill one GRAFT_LEN-token prompt alone (batch 1, the
    donor) on a ``tier`` host tier and graft it into slot 2 of a fresh
    4-slot cache with ``graft_slot``, which reads the donor's pages with
    the page-gather kernel (its dequant variant for int8) and writes them
    with the scatter kernel.  Returns (summary, launch counts of the graft).

    Checks: the slot's rows equal the donor's (an int8 tier's after the
    reference's dequant -> requant); one decode step of slot 2 alone
    (``slot_mask``) gives the logits of the same step on a second cache
    whose slot 2 holds the donor's tier pages copied verbatim, within the
    bf16 tolerance (5e-2) and with the same greedy token.  The donor's own
    batch-1 step is printed beside it for information only: at 4 slots
    the MoE layer's capacity is one token per expert, and the masked slots'
    tokens come first in its token-major dispatch, so they can take an
    expert from slot 2."""
    import numpy as np

    from repro_torch.cache import latent_cache as LC
    from repro_torch.distributed import compression as cmp
    from repro_torch.serving import engine as E

    args = serve.build_parser().parse_args(
        SERVE_ARGS + ["--host-cache-dtype", tier])
    cfg = serve.config_from_args(args)
    n, max_seq = GRAFT_LEN, GRAFT_LEN + 64
    rng = np.random.default_rng(args.seed + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, n)),
                           device=dev)
    t0 = time.perf_counter()
    logits, donor = E.ess_prefill(params, cfg, toks,
                                  torch.arange(n, device=dev)[None], max_seq,
                                  prefill_chunk=PREFILL_CHUNK,
                                  last_logits_only=True)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    fresh = LC.init_ess_caches(cfg, 4, max_seq, device=dev)
    t0 = time.perf_counter()
    grafted, counts = counted(lambda: LC.graft_slot(fresh, 2, donor, n))
    graft_ms = 1e3 * (time.perf_counter() - t0)

    got = LC.slot_latents(grafted, 2)[:, :n]
    want = LC.slot_latents(donor, 0)[:, :n]
    if tier != "bf16":
        want = cmp.dequantize_rows(*cmp.quantize_rows(
            want, grafted.host_latent.dtype), torch.bfloat16)
    torch.cuda.synchronize()
    require(torch.equal(got.view(torch.int16), want.view(torch.int16)),
            f"graft {tier}: slot 2's rows differ from the donor's")

    # the donor's state copied verbatim into slot 2 of a second cache
    direct = LC.init_ess_caches(cfg, 4, max_seq, device=dev)
    NB = LC.num_blocks(cfg, max_seq)
    for dst, src in ((direct.host_latent, donor.host_latent),
                     (direct.host_scales, donor.host_scales)):
        if dst is not None:
            dst[:, 2 * NB:3 * NB] = src[:, :NB]
    for full, one in zip(direct.ikeys, donor.ikeys):
        full[2] = one[0]
    for full, one in zip(direct.pools, donor.pools):
        LC.graft_pool_into(full, one, 2)
    lens = direct.lens.clone()
    lens[2] = n
    direct = direct._replace(lens=lens)

    tok = logits[:, -1].argmax(-1)                               # [1]
    toks4 = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    pos4 = torch.zeros((4, 1), dtype=torch.int64, device=dev)
    toks4[2, 0], pos4[2, 0] = tok[0], n
    live = torch.tensor([False, False, True, False], device=dev)
    lg = E.ess_decode(params, cfg, toks4, pos4, grafted,
                      slot_mask=live).logits[2, 0].float()
    ld = E.ess_decode(params, cfg, toks4, pos4, direct,
                      slot_mask=live).logits[2, 0].float()
    l1 = E.ess_decode(params, cfg, tok[:, None], pos4[2:3],
                      donor).logits[0, 0].float()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(lg).all()), f"graft {tier}: non-finite")
    torch.testing.assert_close(lg, ld, rtol=5e-2, atol=5e-2)
    require(int(lg.argmax()) == int(ld.argmax()),
            f"graft {tier}: greedy token differs from the verbatim slot's")
    return (f"donor prefill {n} tokens {prefill_s:.2f} s, tier "
            f"{LC.tier_nbytes(donor)} bytes; graft_slot {graft_ms:.2f} ms; "
            f"slot rows equal to the donor's"
            f"{'' if tier == 'bf16' else ' after dequant -> requant'}; "
            f"decode step vs the verbatim slot: max |dlogit| "
            f"{float((lg - ld).abs().max()):.4g}, same greedy token; vs "
            f"the donor's own batch-1 step (information): max |dlogit| "
            f"{float((lg - l1).abs().max()):.4g}, greedy token "
            f"{'equal' if int(lg.argmax()) == int(l1.argmax()) else 'differs'}"
            ), counts


def require_tc_only(counts, phase):
    for name, what in (("sparse_mla", "sparse-MLA partials"),
                       ("indexer", "indexer launches")):
        require(counts[f"{name}_tc"] > 0
                and counts[f"{name}_general"] == 0,
                f"the {phase} run's {what} must all take the "
                f"tensor-core route: {counts}")


def check_shapes(counts, cfg, expected, phase, q_verify=None):
    """Launches per kernel shape, as the wrappers counted them: the
    indexer at Q = 1 (decode) and Q > 1 (a prefill chunk, or the
    warmup's W windows); sparse-MLA's partial at Q = 1 over K rows
    (attn0), at Q = 1 over the miss envelope (attn1) and at Q > 1
    (prefill).  With ``q_verify`` (an MTP session's depth + 1), the
    verify step's shapes count apart: the indexer at Q = q_verify, Attn0
    at (q_verify, K) and Attn1 at (q_verify, q_verify x the envelope);
    the session's prefill chunks (buckets of 256) never have that Q.
    Every launch must fall in one shape and each shape must equal
    ``expected``.  Returns the counted launches per shape."""
    K = cfg.dsa.index_topk
    M = max(1, int(cfg.ess.max_miss_ratio * K))
    by_q, by_s = counts["indexer_by_q"], counts["sparse_mla_by_shape"]
    qv = q_verify or 0
    got = {"indexer_scores[decode]": by_q.get(1, 0),
           "indexer_scores[prefill]": sum(
               v for q, v in by_q.items() if q > 1 and q != qv),
           "sparse_mla_partial[attn0]": by_s.get((1, K), 0),
           "sparse_mla_partial[attn1]": by_s.get((1, M), 0),
           "sparse_mla_partial[prefill]": sum(
               v for (q, _), v in by_s.items() if q > 1 and q != qv)}
    if q_verify:
        got.update({
            "indexer_scores[verify]": by_q.get(qv, 0),
            "sparse_mla_partial[attn0-verify]": by_s.get((qv, K), 0),
            "sparse_mla_partial[attn1-verify]": by_s.get((qv, qv * M), 0)})
    n_idx = sum(v for k, v in got.items() if k.startswith("indexer"))
    n_mla = sum(v for k, v in got.items() if k.startswith("sparse"))
    require(n_idx == counts["indexer_tc"]
            and n_mla == counts["sparse_mla_tc"],
            f"the {phase} run's launches outside the serve's shapes: "
            f"indexer {by_q}, sparse-MLA {by_s}")
    require(got == expected,
            f"the {phase} run's launches per shape {got}, expected "
            f"{expected}")
    return got


# the session phases: deepseek-v32-exp-ess cut as the serve, 4 slots,
# ragged prompts (ragged last chunks) and more requests than slots
SESSION_PROMPTS = (8192, 3000, 6144, 8192, 1000, 4500, 8192, 2048)
SESSION_NEW = (32, 16, 32, 24, 32, 16, 32, 32)
SESSION_SLOTS, SESSION_MAX_SEQ = 4, 8224
# decode rounds (by index) profiled for the device's busy share
PROFILED_ROUNDS = (20, 40, 60)
# session B's eager decode round profiled with shapes and dtypes (ESS106)
DEQUANT_ROUND = 10


def session_prompts(cfg, reqs):
    """The prompts of a session's requests (rids 0, 1, ...), from seed 0."""
    import numpy as np
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab_size, (1, r.prompt_len)) for r in reqs]


def run_session(torch, dev, params, cfg, counted, *, compiled, do_warmup,
                reqs, mtp_depth=0, num_slots=SESSION_SLOTS,
                max_seq=SESSION_MAX_SEQ, on_emit=None, tbo=False,
                overlap=False, watch=None, dequant_round=None):
    """One session run: ``reqs`` (``Request``s with rids 0, 1, ...)
    through ``ServeSession.run``, their prompts from seed 0.  Measures and
    checks around the session's own stages (the session itself is
    untouched):

    * the plan and compute stages of every decode round, and each prefill
      round without warmup, run under
      ``torch.cuda.set_sync_debug_mode("error")``: a host sync in them
      raises;
    * each decode round that steps calls the one fetch
      (``engine.device_get``) exactly once, and a round that does not step
      calls it never;
    * timing: each prefill round between two synchronizes (prefill
      tokens/s), each decode round on the host clock (it ends in its
      fetch) with the prefill's work already done; the rounds in
      ``PROFILED_ROUNDS`` run under ``torch.profiler`` for the busy share
      (summed kernel time over wall) and are left out of ms/round, as is
      each round that captured a graph (eager, then the capture: a graph
      session's first round of each variant); ms/round is also kept per
      variant (greedy, sampling), with the live slot-rounds; the profiled
      rounds' device timeline also gives the time in which a row gather
      ran beside other device work, and the time with any device work
      (``profile_serve.overlap_profile``), and for a pipelined session
      (``overlap``) the same for the slab gather alone;
    * ``on_emit(rid, n_emit, charged)``, if given, sees each decode
      delivery of the round's tokens;
    * ``watch`` (a name): the run under an ``audit.SessionWatch``
      (ESS102-ESS104), returned as ``metrics["watch"]``;
    * ``dequant_round`` (a decode round's index, with ``watch``): the
      watch runs that round eager under ``torch.profiler`` with shapes and
      dtypes (ESS106); its time is left out of ms/round.

    Returns ``(session, report, counts, metrics)``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import audit
    from repro_torch.launch.profile_serve import SLAB_KERNELS, overlap_profile
    from repro_torch.serving import engine as E

    prompts = session_prompts(cfg, reqs)
    session = E.ServeSession(
        params, cfg, num_slots=num_slots, max_seq=max_seq,
        prompt_fn=lambda r: prompts[r.rid % len(prompts)],
        do_warmup=do_warmup,
        prefill_chunk=PREFILL_CHUNK, mtp_depth=mtp_depth, tbo=tbo,
        compiled=compiled, overlap=overlap, device=dev)
    m = dict(prefill_s=0.0, decode_ms=[], busy_ms=0.0, profiled_ms=0.0,
             variant_ms={False: [], True: []}, slot_rounds=0, kernels={},
             overlap_us=0.0, gather_us=0.0, union_busy_us=0.0,
             slab_overlap_us=0.0, slab_gather_us=0.0)
    fetches = [0]
    fetch = E.device_get

    def counting_fetch(*a, **k):
        fetches[0] += 1
        return fetch(*a, **k)

    def sync_free(fn):
        def wrapped(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return wrapped

    plan_stage = sync_free(session._plan_round)
    plans = []

    def recorded_plan():
        plan = plan_stage()
        plans.append(plan)
        return plan

    session._plan_round = recorded_plan
    session._compute_round = sync_free(session._compute_round)
    if on_emit is not None:
        emit = session._emit

        def watched_emit(slot, req, tokens, now=None):
            charged, stopped = emit(slot, req, tokens, now)
            on_emit(req.rid, len(tokens), charged)
            return charged, stopped
        session._emit = watched_emit
    prefill = session.prefill_round if do_warmup \
        else sync_free(session.prefill_round)
    decode = session.decode_round

    def timed_prefill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ran = prefill()
        torch.cuda.synchronize()
        m["prefill_s"] += time.perf_counter() - t0
        return ran

    def timed_decode():
        k, n0 = session.report.rounds, fetches[0]
        caps = session.programs.captures
        plans.clear()
        if k == dequant_round:
            done = decode()                 # profiled by the watch
        elif k in PROFILED_ROUNDS:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                done = decode()
                wall = time.perf_counter() - t0
            m["profiled_ms"] += 1e3 * wall
            ov = overlap_profile(prof)
            m["overlap_us"] += ov["overlap_us"]
            m["gather_us"] += ov["gather_us"]
            m["union_busy_us"] += ov["busy_us"]
            ov = overlap_profile(prof, SLAB_KERNELS)
            m["slab_overlap_us"] += ov["overlap_us"]
            m["slab_gather_us"] += ov["gather_us"]
            for ev in prof.key_averages():
                if ev.device_type == DeviceType.CUDA:
                    t = ev.self_device_time_total / 1e3
                    m["busy_ms"] += t
                    m["kernels"][ev.key] = m["kernels"].get(ev.key, 0.0) + t
        else:
            t0 = time.perf_counter()
            done = decode()
            wall = time.perf_counter() - t0
            if session.report.rounds > k \
                    and session.programs.captures == caps:
                m["decode_ms"].append(1e3 * wall)
                m["variant_ms"][plans[0].sampled].append(1e3 * wall)
        if plans and plans[0] is not None:
            m["slot_rounds"] += len(plans[0].active)
        stepped = session.report.rounds - k
        require(fetches[0] - n0 == stepped,
                f"decode round {k}: {fetches[0] - n0} host fetches for "
                f"{stepped} stepped round(s)")
        return done

    session.prefill_round = timed_prefill
    session.decode_round = timed_decode
    E.device_get = counting_fetch
    w = m["watch"] = None if watch is None \
        else audit.SessionWatch(session, name=watch,
                                profile_decode=dequant_round)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with w or contextlib.nullcontext():
            rep, counts = counted(lambda: session.run(reqs,
                                                      max_rounds=10000))
        m["wall_s"] = time.perf_counter() - t0
    finally:
        E.device_get = fetch
        torch.cuda.set_sync_debug_mode(0)
    m["fetches"] = fetches[0]
    return session, rep, counts, m


# the overlap phase: teacher-forced decode rounds from one prefilled state
# under each overlap strategy (mode: layers' overlap, layer-wise plan, TBO)
OVERLAP_ROUNDS = 8
OVERLAP_MODES = {"da": ("da", None, False), "dba": ("dba", None, False),
                 "layerwise": ("layerwise", ("da", "dba", "da", "dba"),
                               False),
                 "tbo": ("da", None, True)}


def capture_graph(torch, fn):
    """``fn`` captured as a CUDA graph on a side stream (relaxed mode, as
    ``StepPrograms`` captures a round); nothing runs until a replay."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="relaxed")
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    return graph


def overlap_phase(torch, dev, serve, params, args, card):
    """The serve's 4 prompts prefilled once at the serve's config (with
    the LRU warmup), then ``OVERLAP_ROUNDS`` teacher-forced decode rounds
    from identical copies of those caches under each of
    ``OVERLAP_MODES``: DA, DBA, the layer-wise plan DA / DBA / DA / DBA,
    and TBO over DA.  DA's greedy tokens are fed to the others.  Rounds
    0-1 run eagerly, then the round is captured as a CUDA graph (its fetch
    and TBO streams as branches) and replayed; the last 3 replays run
    under ``torch.profiler``.

    The decode rounds' MoE capacity is set so that it cannot bind
    (capacity factor E / top_k): TBO's halves dispatch their own tokens,
    and with a capacity that binds they would drop other tokens than the
    whole batch does (as in the reference), which is a different result,
    not an overlap's.
    Every mode's logits must stay within rtol = atol = 2e-2 of DA's in
    every round, and a row gather must run beside other device work in
    its profiled replays.  Hits, misses and overflow are compared with
    DA's; where they differ (a near tie of the indexer's top-k flipped by
    another rounding), the first round and layer whose pool differs are
    printed."""
    import dataclasses

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import overlap_profile
    from repro_torch.serving import engine as E
    from repro_torch.serving import tbo as TBO

    scfg = serve.config_from_args(args)
    mo = scfg.moe
    cfg = dataclasses.replace(scfg, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    B, S = args.requests, args.prompt_len
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int64)
    tokens = torch.as_tensor(prompts, device=dev)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    t0 = time.perf_counter()
    logits, snap = E.ess_prefill(params, scfg, tokens, positions,
                                 S + args.new_tokens,
                                 prefill_chunk=PREFILL_CHUNK,
                                 last_logits_only=True)
    first = logits[:, -1].argmax(-1)
    torch.cuda.synchronize()
    print(f"overlap: the serve's {B} x {S} prompts prefilled (with the "
          f"warmup) in {time.perf_counter() - t0:.2f} s; decode rounds at "
          f"capacity factor {cfg.moe.capacity_factor:g} (no MoE drops)",
          flush=True)
    del logits, tokens, positions
    streams = TBO.make_streams(dev)

    def pinned(t):
        return None if t is None else torch.empty(
            t.shape, dtype=t.dtype, pin_memory=True).copy_(t)

    def copy(c):
        return c._replace(
            lens=c.lens.clone(), host_latent=pinned(c.host_latent),
            ikeys=[k.clone() for k in c.ikeys],
            pools=[p._replace(**{f: getattr(p, f).clone()
                                 for f in p._fields}) for p in c.pools],
            block_tables=c.block_tables.clone(),
            host_scales=pinned(c.host_scales))

    def run(mode, teacher):
        ov, plan, tbo = OVERLAP_MODES[mode]
        mcfg = dataclasses.replace(cfg, ess=dataclasses.replace(
            cfg.ess, overlap=ov))
        c = copy(snap)
        tok = first.clone()
        lg = torch.empty((B, 1, cfg.vocab_size), device=dev)
        st = torch.empty((3, B), dtype=torch.int64, device=dev)

        def step():
            pos = c.lens[:, None].clone()
            if tbo:
                out, _, stats = TBO.tbo_step(E.ess_decode, params, mcfg,
                                             tok[:, None], pos, c,
                                             streams=streams)
            else:
                o = E.ess_decode(params, mcfg, tok[:, None], pos, c,
                                 layerwise_policy=plan,
                                 fetch_stream=streams.fetch_a)
                c.lens.copy_(o.caches.lens)
                out, stats = o.logits, o.stats
            lg.copy_(out)
            st.copy_(torch.stack([stats["hits"], stats["misses"],
                                  stats["overflow"]]))

        recs, toks, graph = [], [], None
        m = dict(replay_ms=[], wall_ms=0.0, overlap_us=0.0, gather_us=0.0,
                 busy_us=0.0)
        for r in range(OVERLAP_ROUNDS):
            if r:
                tok.copy_(teacher[r] if teacher else lg[:, 0].argmax(-1))
            toks.append(tok.clone())
            if r < 2:
                step()
            elif r < OVERLAP_ROUNDS - 3:
                if graph is None:
                    graph = capture_graph(torch, step)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                graph.replay()
                torch.cuda.synchronize()
                m["replay_ms"].append(1e3 * (time.perf_counter() - t1))
            else:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t1 = time.perf_counter()
                    graph.replay()
                    torch.cuda.synchronize()
                    m["wall_ms"] += 1e3 * (time.perf_counter() - t1)
                for k, v in overlap_profile(prof).items():
                    m[k] += v
            recs.append((lg.clone(), st.clone(),
                         [p.ids.clone() for p in c.pools]))
        torch.cuda.synchronize()
        del graph, c
        return recs, toks, m

    results = {}
    for mode in OVERLAP_MODES:
        teacher = None if mode == "da" else results["da"][1]
        results[mode] = run(mode, teacher)
        torch.cuda.empty_cache()
    da_recs = results["da"][0]
    for mode, (recs, _, m) in results.items():
        worst, counts = 0.0, "equal to DA's in every round"
        for r, ((lg, st, ids), (lg0, st0, ids0)) in enumerate(
                zip(recs, da_recs)):
            d = (lg - lg0).abs()
            worst = max(worst, float(d.max()))
            require(bool((d <= 2e-2 + 2e-2 * lg0.abs()).all()),
                    f"overlap {mode}: round {r} logits off DA's by "
                    f"{float(d.max()):.4g}")
            if counts.startswith("equal") and not torch.equal(st, st0):
                layer = next((i for i, (a, b) in enumerate(zip(ids, ids0))
                              if not torch.equal(a, b)), None)
                counts = (f"differ from DA's first in round {r} (hits, "
                          f"misses, overflow {st.tolist()} vs "
                          f"{st0.tolist()}); first pool that differs: "
                          f"layer {layer}")
        k = OVERLAP_ROUNDS - 3
        print(f"overlap {mode}: {OVERLAP_ROUNDS} teacher-forced rounds, "
              f"logits max |diff| vs DA {worst:.4g}; hits/misses/overflow "
              f"{counts}; graph round "
              f"{sum(m['replay_ms']) / len(m['replay_ms']):.3f} ms "
              f"(host clock, {len(m['replay_ms'])} replays), profiled "
              f"{m['wall_ms'] / 3:.3f} ms/round: a row gather beside other "
              f"device work {m['overlap_us'] / 3:.1f} us/round of "
              f"{m['gather_us'] / 3:.1f} us/round gathering, some device "
              f"work running {100 * m['busy_us'] / 1e3 / m['wall_ms']:.1f} "
              f"% of wall  [{card}]", flush=True)
        require(m["overlap_us"] > 0,
                f"overlap {mode}: no row gather ran beside other device "
                f"work in {k} profiled replays")
    del snap, results
    torch.cuda.empty_cache()


# session C: MTP speculative rounds (depth 1, the published module) with
# two sampled requests among four (rid: prompt, knobs); session D: zero
# weights (every draft accepted), two greedy requests (prompt, budget)
# the monolithic phase: logits held to the ESS fixed batch's within this
# share of the round's largest logit; greedy disagreements with ESS at
# most ESS's own against itself (ESS at two prefill chunks: the same
# function through other GEMM shapes) plus this many, each a near-tie:
# the monolithic model's gap between the two tokens no wider than ESS's
# own top-2 gap moves between its two runs (the largest move over every
# (slot, round)).  Random weights make near-ties: ESS disagrees with
# itself at a few pairs when only its prefill chunk changes.
MONO_LOGIT_REL = 5e-2
MONO_EXTRA_DISAGREE = 1
MONO_EAGER_ROUNDS = 4             # decode rounds 1-4 eager, then a graph
MONO_PROFILED = 3                 # the last graph rounds, profiled
MONO_PLAIN_LEN = 1024             # the plain chunked flash fits here


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significand bits)."""
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


def counted_capture(torch, fn):
    """``fn`` captured as a CUDA graph (:func:`capture_graph`); the
    launches its wrappers counted while recording are taken back and
    returned as the delta one replay stands for (``StepPrograms``'
    bookkeeping: add it on each replay)."""
    from repro_torch.kernels import counters
    before = counters.snapshot()
    graph = capture_graph(torch, fn)
    delta = counters.diff(counters.snapshot(), before)
    counters.restore(before)
    return graph, delta


def latent_state_bytes(torch, caches) -> dict:
    """Device bytes of a path's latent state: the monolithic model's
    latent and indexer planes (a dict cache), or ESS's pools (rows and
    their maps) and indexer cache; ESS's pinned host tier apart."""
    def nb(t):
        return t.numel() * t.element_size()
    if isinstance(caches, dict):
        return {"latent": nb(caches["mla"].latent),
                "indexer": nb(caches["mla"].ikeys)}
    out = {"pool_rows": sum(nb(p.data) for p in caches.pools),
           "pool_maps": sum(nb(t) for p in caches.pools
                            for t in (p.ids, p.last_use, p.slot_of)),
           "indexer": sum(nb(t) for t in caches.ikeys)}
    out["host_tier"] = nb(caches.host_latent) + (
        0 if caches.host_scales is None else nb(caches.host_scales))
    return out


def monolithic_phase(torch, dev, serve, params, args, card, counted,
                     records):
    """Phase 7b: the generic path (the monolithic model, the whole latent
    cache in device memory) on the fixed-batch serve's 4 x 8192-token
    prompts, 32 new tokens: ``generic_prefill`` (the kernel route, by ids
    in 256-query chunks), then greedy ``generic_decode`` rounds, rounds
    1-``MONO_EAGER_ROUNDS`` eager, the rest replayed from a CUDA graph
    (a replay's launches, from the capture, checked against an eager
    round's; the kernels line takes the prefill's and the eager rounds'
    counts).  Held teacher-forced against the
    ESS fixed batch (``ess_prefill`` with the warmup, ``ess_decode``) fed
    the same tokens with the miss envelope unbound: every round's logits
    within ``MONO_LOGIT_REL`` of its largest; ESS run again at twice the
    prefill chunk gives its own greedy disagreements, which the monolithic
    model may exceed by ``MONO_EXTRA_DISAGREE``, and its own noise on a
    greedy choice (how far its top-2 gap moves between the two runs),
    which bounds each disagreement's gap.  Then the
    prefill and one decode round at ``MONO_PLAIN_LEN`` tokens against the
    plain version (the chunked flash, the plain decode).  Prints prefill
    tok/s, decode ms/round (graph and eager) and each path's device bytes
    of latent state."""
    import contextlib
    import dataclasses

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.overlap import side_stream
    from repro_torch.core.similarity import intra_layer_similarity
    from repro_torch.kernels import counters
    from repro_torch.models import layers as L
    from repro_torch.models import mla as Mmod
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E

    cfg = serve.config_from_args(args)
    B, S, new = args.requests, args.prompt_len, args.new_tokens
    max_seq = S + new
    prompts = np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int64)     # the serve's prompts
    toks = torch.as_tensor(prompts, device=dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)
    w_out = params.get("unembed", params["embed"])

    def main_path():
        start = counters.snapshot()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pf = E.generic_prefill(params, cfg, toks, pos, device=dev,
                               want_logits=False)
        first = L.unembed(w_out, pf.hidden[:, -1:])[:, 0]        # [B,V]
        caches = T.pad_caches(pf.caches, max_seq)
        del pf
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        at_prefill = counters.snapshot()
        prefill = counters.diff(at_prefill, start)
        logits = [first]
        tok = first.argmax(-1)[:, None].clone()
        eager_ms, graph_ms = [], []

        def step():
            return E.generic_decode(params, cfg, tok, caches["lens"][:, None],
                                    caches, device=dev)
        # each layer's top-2048 ids of the last two eager rounds, as
        # sparse_mla_decode's topk_select gave them (Eq. 1 below)
        picked = []

        def recording(*a, **kw):
            out, ids = decode_attend(*a, **kw)
            picked[-1].append(ids)
            return out, ids
        decode_attend = Mmod.sparse_mla_decode
        for r in range(MONO_EAGER_ROUNDS):
            t0 = time.perf_counter()
            if r >= MONO_EAGER_ROUNDS - 2:
                picked.append([])
                Mmod.sparse_mla_decode = recording
            try:
                lg = step().logits[:, -1].clone()
            finally:
                Mmod.sparse_mla_decode = decode_attend
            tok.copy_(lg.argmax(-1)[:, None])
            torch.cuda.synchronize()
            eager_ms.append(1e3 * (time.perf_counter() - t0))
            logits.append(lg)
        eager = counters.diff(counters.snapshot(), at_prefill)
        box = {}
        graph, delta = counted_capture(torch, lambda: box.update(out=step()))
        n_graph = new - 1 - MONO_EAGER_ROUNDS
        prof_ms, kern = 0.0, {}
        for i in range(n_graph):
            # the last MONO_PROFILED graph rounds run under the profiler
            profiled = i >= n_graph - MONO_PROFILED
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) \
                    if profiled else contextlib.nullcontext() as prof:
                t0 = time.perf_counter()
                graph.replay()
                counters.add(delta)
                lg = box["out"].logits[:, -1].clone()
                tok.copy_(lg.argmax(-1)[:, None])
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0)
            if profiled:
                prof_ms += wall
                for ev in prof.key_averages():
                    if ev.device_type == DeviceType.CUDA:
                        kern[ev.key] = kern.get(ev.key, 0.0) \
                            + ev.self_device_time_total / 1e3
            else:
                graph_ms.append(wall)
            logits.append(lg)
        del graph, box
        return dict(logits=torch.stack(logits, 1), caches=caches,
                    picked=picked, prefill=prefill, eager=eager, delta=delta,
                    prefill_s=prefill_s, eager_ms=eager_ms,
                    graph_ms=graph_ms, prof_ms=prof_ms, kernels=kern)

    torch.cuda.reset_peak_memory_stats()
    mono, n = counted(main_path)
    peak = torch.cuda.max_memory_allocated() / 2**30
    L_ = cfg.num_layers
    chunks = -(-S // PREFILL_CHUNK)
    rounds = new - 1
    for name in ("indexer_scores", "gather_rows", "sparse_mla_partial",
                 "sparse_mla_merge"):
        require(n[name] > 0, f"{name} was not launched by the monolithic run")
    require_tc_only(n, "monolithic")
    want = {"indexer_by_q": {1: L_ * rounds, PREFILL_CHUNK: L_ * chunks},
            "sparse_mla_by_shape": {(1, cfg.dsa.index_topk): L_ * rounds,
                                    (PREFILL_CHUNK, cfg.dsa.index_topk):
                                        L_ * chunks}}
    for key, exp in want.items():
        require(n[key] == exp, f"monolithic {key}: {n[key]}, expected {exp}")
    require(n["gather_rows"] == L_ * (rounds + chunks),
            f"monolithic gather_rows: {n['gather_rows']} launches, "
            f"expected {L_ * (rounds + chunks)}")
    require(n["gather_rows_dequant"] == 0 and n["scatter_rows"] == 0,
            "the monolithic path touched the host tier")
    # counted where the wrappers launch: the prefill's, and the eager
    # decode rounds'; each graph replay stands for one eager round
    K = cfg.dsa.index_topk
    n_pf, n_eg, delta = mono.pop("prefill"), mono.pop("eager"), \
        mono.pop("delta")
    E_ = MONO_EAGER_ROUNDS
    for what, got, exp in (
            ("prefill gather_rows", n_pf[("gather_rows", "launches")],
             L_ * chunks),
            ("prefill gather_rows staged",
             n_pf[("gather_rows", "launches_staged")], 0),
            ("prefill indexer by Q",
             n_pf[("indexer_scores", "launches_by_q")],
             {PREFILL_CHUNK: L_ * chunks}),
            ("prefill partial by shape",
             n_pf[("partial_attend", "launches_by_shape")],
             {(PREFILL_CHUNK, K): L_ * chunks}),
            ("eager decode gather_rows", n_eg[("gather_rows", "launches")],
             L_ * E_),
            ("eager decode gather_rows staged",
             n_eg[("gather_rows", "launches_staged")], 0),
            ("eager decode indexer by Q",
             n_eg[("indexer_scores", "launches_by_q")], {1: L_ * E_}),
            ("eager decode partial by shape",
             n_eg[("partial_attend", "launches_by_shape")],
             {(1, K): L_ * E_})):
        require(got == exp, f"monolithic {what}: {got}, expected {exp}")
    require(n_eg[("merge_splits", "launches")] > 0,
            "monolithic: the eager decode rounds merged no splits")
    for key, v in delta.items():
        per = {k: E_ * c for k, c in v.items()} if isinstance(v, dict) \
            else E_ * v
        require(n_eg[key] == per, f"monolithic {key}: a graph round stands "
                f"for {v}, {E_} eager rounds counted {n_eg[key]}")
    # Eq. 1: each layer's top-2048 sets of two consecutive rounds
    prev, cur = mono.pop("picked")
    sim = [intra_layer_similarity(a, b)[:, 0] for a, b in zip(prev, cur)]
    print(f"Eq. 1 intra-layer similarity, eager rounds "
          f"{MONO_EAGER_ROUNDS - 1} -> {MONO_EAGER_ROUNDS}, top-"
          f"{cfg.dsa.index_topk} per layer (slots "
          f"{list(range(B))}; random weights, not Figure 2's trained "
          f"0.85-0.99): " + "; ".join(
              f"layer {i} " + ", ".join(f"{float(v):.4f}" for v in r)
              for i, r in enumerate(sim)) + f"  [{card}]", flush=True)
    mono_bytes = latent_state_bytes(torch, mono["caches"])
    mono_logits = mono.pop("logits")
    del mono["caches"]
    torch.cuda.empty_cache()

    # the ESS fixed batch on the same tokens, teacher-forced: the envelope
    # unbound, each round fed the monolithic model's greedy token; run
    # twice, at the serve's prefill chunk and at twice it: the same
    # function through other GEMM shapes, ESS's spread against itself
    cfg_x = dataclasses.replace(cfg, ess=dataclasses.replace(
        cfg.ess, max_miss_ratio=1.0))
    forced = mono_logits.argmax(-1)                           # [B,new]
    fetch = side_stream(dev)

    def ess_run(chunk):
        lg0, ess = E.ess_prefill(params, cfg_x, toks, pos, max_seq,
                                 prefill_chunk=chunk, last_logits_only=True)
        out = [lg0[:, -1]]
        for r in range(rounds):
            o = E.ess_decode(params, cfg_x, forced[:, r:r + 1],
                             ess.lens[:, None], ess, fetch_stream=fetch)
            ess = o.caches
            out.append(o.logits[:, -1])
        return torch.stack(out, 1), latent_state_bytes(torch, ess)

    ess_logits, ess_bytes = ess_run(args.prefill_chunk)
    ess2_logits, _ = ess_run(2 * args.prefill_chunk)
    torch.cuda.empty_cache()
    require(bool(torch.isfinite(mono_logits).all()),
            "monolithic: non-finite logits")

    def spread(a, b):
        """Per (slot, round): max |a - b| over the vocabulary, its share
        of max|a|, and whether the argmaxes agree."""
        d = (a - b).abs().amax(-1)
        return d, d / a.abs().amax(-1), a.argmax(-1) == b.argmax(-1)

    def pair_gap(x, pair):
        """x[..., t1] - x[..., t2] for the token pairs ``pair`` [..., 2]."""
        v = x.gather(-1, pair)
        return v[..., 0] - v[..., 1]

    _, rel, agree = spread(mono_logits, ess_logits)
    _, rel2, agree2 = spread(ess_logits, ess2_logits)
    worst, share = float(rel.max()), float(agree.float().mean())
    # ESS's own noise on the quantity a greedy token turns on: how far the
    # gap between its top-2 tokens moves from one ESS run to the other
    top2 = ess_logits.topk(2, -1).indices                     # [B,new,2]
    moves = (pair_gap(ess_logits, top2) - pair_gap(ess2_logits, top2)).abs()
    bound = float(moves.max())
    n_mono, n_self = int((~agree).sum()), int((~agree2).sum())
    print(f"monolithic vs ESS (teacher-forced, {B} x {new} (slot, round) "
          f"pairs): max |logit diff| / max|logit| {worst:.4g} (limit "
          f"{MONO_LOGIT_REL}), greedy agreement {share:.4f} ({n_mono} "
          f"disagreements); ESS at chunk {args.prefill_chunk} vs ESS at "
          f"chunk {2 * args.prefill_chunk}: {float(rel2.max()):.4g}, "
          f"agreement {float(agree2.float().mean()):.4f} ({n_self} "
          f"disagreements; limit for the monolithic model {n_self} + "
          f"{MONO_EXTRA_DISAGREE}); ESS's top-2 gap moves up to {bound:.4g} "
          f"between its runs (median {float(moves.median()):.4g})",
          flush=True)
    print("  per round, max |logit diff| / max|logit|, monolithic vs ESS: "
          + ", ".join(f"{float(v):.3g}" for v in rel.amax(0))
          + "; ESS vs ESS: "
          + ", ".join(f"{float(v):.3g}" for v in rel2.amax(0)), flush=True)
    wide, sub_ulp = [], 0
    for b, r in (~agree).nonzero().tolist():
        m = mono_logits[b, r]
        am, ae = int(forced[b, r]), int(ess_logits[b, r].argmax())
        pair = torch.tensor([am, ae], device=m.device)
        gap = float(pair_gap(m, pair))
        own = float((pair_gap(ess_logits[b, r], pair)
                     - pair_gap(ess2_logits[b, r], pair)).abs())
        top = m.topk(2).values
        ulp = bf16_ulp(float(m[am]))
        sub_ulp += gap < ulp
        print(f"  disagreement slot {b} round {r}: monolithic {am} "
              f"(top-2 gap {float(top[0] - top[1]):.4g}), ESS {ae}; the "
              f"monolithic logits' gap between them {gap:.4g} (limit "
              f"{bound:.4g}); ESS's own gap between them moves {own:.4g} "
              f"between its runs; one bf16 ulp at {float(m[am]):.3f} is "
              f"{ulp:.4g}", flush=True)
        if gap > bound:
            wide.append((b, r, gap))
    print(f"  for information: {sub_ulp} of the {n_mono} disagreements "
          f"below one bf16 ulp", flush=True)
    require(worst <= MONO_LOGIT_REL,
            f"monolithic vs ESS: logits {worst:.4g} of their scale apart")
    require(n_mono <= n_self + MONO_EXTRA_DISAGREE,
            f"monolithic vs ESS: {n_mono} greedy disagreements, ESS against "
            f"itself {n_self}")
    require(not wide, f"monolithic vs ESS: disagreements wider than ESS's "
            f"own top-2 gap moves (slot, round, gap): {wide}")
    del ess2_logits
    del mono_logits, ess_logits

    # the kernel route against the plain version at MONO_PLAIN_LEN tokens
    Sp = MONO_PLAIN_LEN
    outs = {}
    for kern in (True, False):
        pf = E.generic_prefill(params, cfg, toks[:, :Sp], pos[:, :Sp],
                               device=dev, want_logits=False,
                               use_kernel=kern)
        first = L.unembed(w_out, pf.hidden[:, -1:])[:, 0]
        caches = T.pad_caches(pf.caches, Sp + 1)
        del pf
        o = E.generic_decode(params, cfg, first.argmax(-1)[:, None],
                             caches["lens"][:, None], caches, device=dev,
                             use_kernel=kern)
        outs[kern] = (first, o.logits[:, -1], caches["mla"])
        del o, caches
    errs = []
    for a, b in zip(outs[True][:2], outs[False][:2]):
        errs.append(float(((a - b).abs().amax(-1)
                           / b.abs().amax(-1)).max()))
    lat_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(outs[True][2], outs[False][2]))
    print(f"monolithic kernel route vs plain at {Sp} tokens: prefill "
          f"logits {errs[0]:.4g}, decode logits {errs[1]:.4g} of their "
          f"scale apart (limit {MONO_LOGIT_REL}); caches max |diff| "
          f"{lat_err:.4g}", flush=True)
    require(max(errs) <= MONO_LOGIT_REL,
            "monolithic kernel route differs from the plain version")
    del outs
    torch.cuda.empty_cache()

    em, gm = mono["eager_ms"], mono["graph_ms"]
    print(f"monolithic: prefill {B * S / mono['prefill_s']:.0f} tok/s "
          f"({mono['prefill_s']:.2f} s for {B} x {S}); decode "
          f"{sum(gm) / len(gm):.2f} ms/round graph ({len(gm)} rounds, "
          f"the profiled ones apart), "
          f"{sum(em[1:]) / len(em[1:]):.2f} ms/round eager (rounds 2-"
          f"{len(em)}; round 1 {em[0]:.2f}); peak device memory "
          f"{peak:.1f} GiB  [{card}]", flush=True)
    busy = sum(mono["kernels"].values())
    top = sorted(mono["kernels"].items(), key=lambda kv: -kv[1])[:6]
    print(f"monolithic: {MONO_PROFILED} profiled graph rounds: device busy "
          f"{100 * busy / mono['prof_ms']:.1f} % ({mono['prof_ms'] / MONO_PROFILED:.2f} "
          f"ms/round under the profiler); by device ms a round: "
          + ", ".join(f"{k[:48]} {v / MONO_PROFILED:.3f}" for k, v in top)
          + f"  [{card}]", flush=True)
    gb = 1e-6
    print(f"monolithic: latent state on the card {sum(mono_bytes.values()) * gb:.2f} "
          f"MB (latent {mono_bytes['latent'] * gb:.2f} + indexer "
          f"{mono_bytes['indexer'] * gb:.2f}); ESS {ess_bytes['pool_rows'] * gb + ess_bytes['indexer'] * gb:.2f} "
          f"MB (pool rows {ess_bytes['pool_rows'] * gb:.2f} + indexer "
          f"{ess_bytes['indexer'] * gb:.2f}; pool maps "
          f"{ess_bytes['pool_maps'] * gb:.2f}), its pinned host tier "
          f"{ess_bytes['host_tier'] * gb:.2f} MB", flush=True)
    print(f"monolithic: launches " + ", ".join(
        f"{k} {v}" for k, v in n.items()), flush=True)
    # the kernels line: the launches the wrappers counted, the prefill's
    # and the eager decode rounds' (the graph rounds' are checked above)
    records["gather_rows[hbm-prefill]"]["launches"] = \
        n_pf[("gather_rows", "launches")]
    records["gather_rows[hbm-decode]"]["launches"] = \
        n_eg[("gather_rows", "launches")]
    records["sparse_mla_partial[mono-decode]"]["launches"] = \
        n_eg[("partial_attend", "launches_by_shape")][(1, K)]
    records["indexer_scores[topk_select]"]["launches"] = \
        n_eg[("indexer_scores", "launches_by_q")][1]
    for name, v in (("sparse_mla_partial[prefill]",
                     n_pf[("partial_attend", "launches_by_shape")]
                     [(PREFILL_CHUNK, K)]),
                    ("indexer_scores[prefill]",
                     n_pf[("indexer_scores", "launches_by_q")]
                     [PREFILL_CHUNK]),
                    ("sparse_mla_merge", n_eg[("merge_splits", "launches")])):
        records[name]["launches_monolithic"] = v


SESSION_C = ((8192, {}), (3000, dict(temperature=0.8, top_k=64, seed=123)),
             (6144, {}), (8192, dict(temperature=1.0, top_p=0.9, seed=7)))
SESSION_C_NEW = 32
SESSION_D = ((1024, 7), (512, 8))
SESSION_D_MAX_SEQ = 1088


def session_phases(torch, dev, serve, params, args, qargs, records, counted,
                   card):
    """Phases 8-13b and 11 (see the module docstring); sets the kernel
    records' launches from session A's eager run, session B's and the long
    prompt's."""
    import dataclasses

    import numpy as np

    from repro_torch.analysis import audit
    from repro_torch.models.params import init_mtp_params
    from repro_torch.serving import engine as E
    from repro_torch.serving.scheduler import Request

    # 8. session A: bf16 tier, no warmup, 8 requests through 4 slots, the
    #    decode round replayed as a CUDA graph, then the same run eager
    scfg = serve.config_from_args(args)
    L = scfg.num_layers
    W = scfg.ess.warmup_windows

    def session_summary(tag, sess, rep, m):
        dm = m["decode_ms"]
        k = len(PROFILED_ROUNDS)
        busy = (f"device busy {100 * m['busy_ms'] / m['profiled_ms']:.1f} % "
                f"of {k} profiled rounds "
                f"({m['profiled_ms'] / k:.2f} ms/round under the profiler; "
                f"some device work running "
                f"{100 * m['union_busy_us'] / 1e3 / m['profiled_ms']:.1f} % "
                f"of wall; a row gather beside other device work "
                f"{m['overlap_us'] / k:.1f} us/round of "
                f"{m['gather_us'] / k:.1f} us/round gathering)") \
            if m["profiled_ms"] else "not profiled (fewer rounds)"
        spec = (f"; {rep.spec_rounds} speculative rounds, accept rate "
                f"{rep.accept_rate:.4f} ({rep.accepted_tokens}/"
                f"{rep.drafted_tokens} drafts)") if rep.spec_rounds else ""
        vm = m["variant_ms"]
        variants = (f"; greedy rounds {sum(vm[False]) / len(vm[False]):.2f} "
                    f"ms ({len(vm[False])}), sampling rounds "
                    f"{sum(vm[True]) / len(vm[True]):.2f} ms "
                    f"({len(vm[True])})") if vm[False] and vm[True] else ""
        print(f"session {tag}: {len(rep.finished_rids)} requests, "
              f"{rep.rounds} decode rounds, {rep.decode_tokens} decode "
              f"tokens, {rep.prefill_chunks} prefill chunks; wall "
              f"{m['wall_s']:.2f} s; decode {sum(dm) / len(dm):.2f} ms/round "
              f"(mean of {len(dm)} rounds; median "
              f"{sorted(dm)[len(dm) // 2]:.2f}, min {min(dm):.2f}); "
              f"{rep.decode_tokens / m['slot_rounds']:.3f} tokens per live "
              f"slot-round{spec}{variants}; {busy}; prefill "
              f"{rep.prefill_tokens / m['prefill_s']:.1f} tok/s "
              f"({m['prefill_s']:.2f} s); pool hit rate "
              f"{rep.pool_hit_rate:.4f}, {rep.h2d_rows / rep.rounds:.1f} "
              f"miss rows/round; {m['fetches']} host fetches  [{card}]",
              flush=True)

    def check_session(tag, sess, rep, n, reqs, warm, tier, q_verify=None,
                      parts=1, halves=1, pipelined=False):
        """Every request ends once with its whole budget; the launches per
        route and shape, with the graph's replays counted, equal what the
        run's rounds and chunks give (an MTP session's rounds are all
        verify rounds, at Q = ``q_verify``).  A round's layer runs its
        indexer, Attn0, Attn1 and miss fetch once per batch part (TBO
        halves, DBA halves within them: ``parts``) and its tier write once
        per TBO half (``halves``); a pipelined round writes the tier once
        per half after its layers (one stacked write per plane) and
        gathers its slab once per half (``gather_rows_raw``)."""
        n_req = len(reqs)
        terminal = [e.rid for e in sess.token_events if e.is_terminal]
        require(sorted(terminal) == list(range(n_req))
                and sorted(rep.finished_rids) == list(range(n_req)),
                f"session {tag}: terminal events {terminal}")
        for r in reqs:
            require(len(sess.outputs[r.rid]) == r.max_new_tokens,
                    f"session {tag}: rid {r.rid} emitted "
                    f"{len(sess.outputs[r.rid])} tokens")
        R, ch = rep.rounds, rep.prefill_chunks
        require(ch == sum(-(-r.prompt_len // PREFILL_CHUNK) for r in reqs),
                f"session {tag}: {ch} prefill chunks")
        require_tc_only(n, f"session {tag}")
        dec, ver = (0, parts * L * R) if q_verify else (parts * L * R, 0)
        want = {"indexer_scores[decode]": dec,
                "indexer_scores[prefill]": L * (ch + (n_req if warm else 0)),
                "sparse_mla_partial[attn0]": dec,
                "sparse_mla_partial[attn1]": dec,
                "sparse_mla_partial[prefill]": L * ch}
        if q_verify:
            want.update({"indexer_scores[verify]": ver,
                         "sparse_mla_partial[attn0-verify]": ver,
                         "sparse_mla_partial[attn1-verify]": ver})
        got = check_shapes(n, scfg, want, f"session {tag}", q_verify)
        gname = "gather_rows" if tier == "bf16" else "gather_rows_dequant"
        other = "gather_rows_dequant" if gname == "gather_rows" \
            else "gather_rows"
        planes = 1 if gname == "gather_rows" else 2
        writes = halves * (1 if pipelined else L) * R
        want = {f"{gname}_staged": L * ch,
                f"{gname}_direct": L * (parts * R + (n_req * W if warm
                                                     else 0)),
                other: 0, "scatter_rows": planes * (ch + writes),
                "gather_rows_raw": halves * R if pipelined else 0}
        require(all(n[k] == v for k, v in want.items())
                and n[gname] == n[f"{gname}_staged"] + n[f"{gname}_direct"]
                and n["sparse_mla_merge"] > 0,
                f"session {tag}: launches {n}, expected {want}")
        return got

    def audit_run(name, sess, w, make_reqs, second_pass):
        """The run's audits, from its watch: ESS102-ESS104 (and ESS106
        where a round was profiled), after a second pass of the same
        requests under fresh rids where asked (ESS103: the captures must
        not move; the run's own wrappers are taken off the session first).
        Prints the counts and the findings; a finding fails the run."""
        t0 = time.perf_counter()
        if second_pass:
            for attr in ("_plan_round", "_compute_round", "prefill_round",
                         "decode_round", "_emit"):
                vars(sess).pop(attr, None)
            reqs = make_reqs()
            with w:
                w.drive(audit.again(reqs, len(reqs)), max_rounds=10000)
        fs, c = w.findings(), w.counts()
        print(f"audit session {name}: ESS102 {c['fetches']} host fetches "
              f"over {c['rounds']} rounds (at most "
              f"{c['max_fetches_a_round']} a round); ESS103 "
              + (f"{c['captures']} captures for {len(c['round_keys'])} "
                 f"round keys {c['captures_by_key']}"
                 + (f" after a second pass of the requests "
                    f"({time.perf_counter() - t0:.1f} s)" if second_pass
                    else "") if sess.compiled else "eager, no graphs")
              + f"; ESS104 {len(w.dtypes_in)} state tensors"
              + (f"; ESS106 {c['profiled_ops']} profiled ops of one eager "
                 f"round, tier threshold {w.threshold} elements"
                 if w.profile_decode is not None else "")
              + f"; findings {len(fs)}"
              + "".join(f"\n  {f.format()}" for f in fs), flush=True)
        require(not fs, f"audit session {name}: {len(fs)} finding(s)")

    def graph_and_eager(tag, cfg, make_reqs, warm, tier, mtp_depth=0,
                        top_kernels=0, tbo=False, parts=1, overlap=False,
                        modes=(True, False), second_pass=False,
                        dequant_round=None):
        """The session run twice: its rounds replayed as graphs, then
        eagerly.  The streams must be bit-identical and the launch counts
        (the graph's with its replays added) equal; in the graph run's
        profiled rounds a row gather must run beside other device work.
        Returns the eager run's counts and shapes, counted where the
        wrappers launch, and the graph run's streams.  ``overlap`` runs
        the session pipelined (its prefetch counters printed, the pipeline
        engaged); ``modes=(True,)`` the graph run alone (its counts
        returned).  Every run is audited (:func:`audit_run`); the graph
        run also over a second pass with ``second_pass``, the eager run's
        decode round ``dequant_round`` profiled for ESS106."""
        runs = {}
        qv = mtp_depth + 1 if mtp_depth else None
        for compiled in modes:
            name = f"{tag} {'graph' if compiled else 'eager'}"
            reqs = make_reqs()
            sess, rep, n, m = run_session(
                torch, dev, params, cfg, counted, compiled=compiled,
                do_warmup=warm, reqs=reqs, mtp_depth=mtp_depth, tbo=tbo,
                overlap=overlap, watch=name,
                dequant_round=None if compiled else dequant_round)
            session_summary(name, sess, rep, m)
            if overlap:
                k = len(PROFILED_ROUNDS)
                slab = (f"the slab gather beside other device work "
                        f"{m['slab_overlap_us'] / k:.1f} us/round of "
                        f"{m['slab_gather_us'] / k:.1f} us/round gathering "
                        f"the slab") if m["profiled_ms"] else "not profiled"
                print(f"session {name}: prefetch hit rate "
                      f"{rep.prefetch_hit_rate:.4f} ({rep.prefetch_hits} "
                      f"slab hits, {rep.prefetch_misses} fallback misses, "
                      f"{rep.prefetch_wasted_rows} wasted rows; "
                      f"{rep.prefetch_misses / rep.rounds:.1f} misses and "
                      f"{rep.prefetch_wasted_rows / rep.rounds:.1f} wasted "
                      f"rows a round; slab of {sess.prefetch_rows} rows a "
                      f"layer and slot); {slab}  [{card}]", flush=True)
                require(rep.prefetch_hits + rep.prefetch_misses > 0,
                        f"session {name}: the pipeline never engaged")
            require(sess.tbo == tbo, f"session {name}: tbo {sess.tbo}")
            if compiled and m["profiled_ms"]:
                require(m["overlap_us"] > 0,
                        f"session {name}: no row gather ran beside other "
                        f"device work in the profiled graph rounds")
            if top_kernels and compiled:
                k = len(PROFILED_ROUNDS)
                top = sorted(m["kernels"].items(), key=lambda kv: -kv[1])
                print(f"session {name}: device ms per profiled round by "
                      f"kernel, top {top_kernels}: " + "; ".join(
                          f"{n_[:60]} {t / k:.3f}"
                          for n_, t in top[:top_kernels]), flush=True)
            got = check_session(name, sess, rep, n, reqs, warm, tier, qv,
                                parts, 2 if tbo else 1, overlap)
            if compiled:
                pr = sess.programs
                require(pr.replays + pr.captures == rep.rounds,
                        f"session {name}: {pr.replays} graph replays and "
                        f"{pr.captures} captures for {rep.rounds} rounds")
            runs[compiled] = (dict(sess.outputs), rep.rounds, n, got)
            audit_run(name, sess, m["watch"], make_reqs,
                      second_pass and compiled)
            del sess, m
            torch.cuda.empty_cache()
        if False not in runs:
            og, _, ng, got = runs[True]
            return ng, got, og
        (og, rg, ng, _), (oe, re_, ne, got) = runs[True], runs[False]
        require(og == oe and rg == re_,
                f"session {tag}: the graph and the eager session's streams "
                f"differ")
        require(ng == ne, f"session {tag}: launch counts differ, graph {ng}, "
                f"eager {ne}")
        print(f"session {tag}: graph and eager streams bit-identical over "
              f"{rg} rounds ({sum(len(v) for v in og.values())} tokens); "
              f"launch counts equal: "
              + ", ".join(f"{k} {v}" for k, v in ne.items()), flush=True)
        return ne, got, og

    def greedy_reqs(prompts, budgets):
        return lambda: [Request(rid=i, prompt_len=p, max_new_tokens=b)
                        for i, (p, b) in enumerate(zip(prompts, budgets))]

    n, got, a_out = graph_and_eager(
        "A", scfg, greedy_reqs(SESSION_PROMPTS, SESSION_NEW), False, "bf16",
        second_pass=True)
    for name, v in got.items():
        records[name]["launches"] = v
    for name in ("scatter_rows", "sparse_mla_merge"):
        records[name]["launches"] = n[name]
    records["gather_rows"]["launches"] = n["gather_rows_direct"]
    records["gather_rows[prefill]"]["launches"] = n["gather_rows_staged"]

    # 9. session B: int8 tier, LRU warmup at admission, 4 requests
    qcfg = serve.config_from_args(qargs)
    n, _, b_out = graph_and_eager(
        "B int8 warmup", qcfg,
        greedy_reqs(SESSION_PROMPTS[:4], SESSION_NEW[:4]), True, "int8",
        dequant_round=DEQUANT_ROUND)
    records["gather_rows_dequant"]["launches"] = \
        n["gather_rows_dequant_direct"]
    records["gather_rows_dequant[prefill]"]["launches"] = \
        n["gather_rows_dequant_staged"]

    # 9b. the overlap strategies from one prefilled state (DA, DBA, the
    #     layer-wise plan, TBO), each round a graph with its side streams
    t0 = time.perf_counter()
    _, n = counted(lambda: overlap_phase(torch, dev, serve, params, args,
                                         card))
    print(f"overlap: {time.perf_counter() - t0:.1f} s; launches (eager "
          f"rounds and captures; replays not counted) "
          + ", ".join(f"{k} {v}" for k, v in n.items()), flush=True)
    for name in ("gather_rows", "scatter_rows", "indexer_scores",
                 "sparse_mla_partial", "sparse_mla_merge"):
        require(n[name] > 0, f"{name} was not launched by the overlap "
                f"phase")

    # 9c. session E: session A's requests with DBA layers and TBO (halves
    #     of 2 slots, DBA halves of 1 within them: 4 parts per layer)
    ecfg = dataclasses.replace(scfg, ess=dataclasses.replace(
        scfg.ess, overlap="dba"))
    n, got, _ = graph_and_eager(
        "E dba+tbo", ecfg, greedy_reqs(SESSION_PROMPTS, SESSION_NEW), False,
        "bf16", tbo=True, parts=4)
    for name, v in got.items():
        records[name]["launches_session_e"] = v
    for name in ("scatter_rows", "sparse_mla_merge"):
        records[name]["launches_session_e"] = n[name]
    records["gather_rows"]["launches_session_e"] = n["gather_rows_direct"]

    # 10. session C: the published MTP module (its own generator) beside
    #     the same 4 layers, depth-1 speculative rounds, two sampled
    #     requests; graph, then eager
    margs = serve.build_parser().parse_args(SERVE_ARGS + ["--mtp-depth", "1"])
    ccfg = serve.config_from_args(margs)
    require(ccfg.mtp_depth == 1, f"session C: mtp_depth {ccfg.mtp_depth}")
    t0 = time.perf_counter()
    params["mtp"] = init_mtp_params(ccfg, margs.seed, dev)
    torch.cuda.synchronize()
    mtp_bytes = sum(t.numel() * t.element_size()
                    for t in leaves(params["mtp"]))
    print(f"session C: MTP module drawn in {time.perf_counter() - t0:.1f} s, "
          f"{mtp_bytes / 2**30:.2f} GiB; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB", flush=True)
    torch.cuda.reset_peak_memory_stats()

    def c_reqs(new=SESSION_C_NEW):
        return [Request(rid=i, prompt_len=p, max_new_tokens=new, **kn)
                for i, (p, kn) in enumerate(SESSION_C)]
    n, got, c_out = graph_and_eager("C mtp+sampling", ccfg, c_reqs, False,
                                    "bf16", mtp_depth=1, top_kernels=10,
                                    second_pass=True)
    print(f"session C: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; Q = 2 "
          f"launches (eager run): "
          + ", ".join(f"{k} {v}" for k, v in got.items()), flush=True)
    for name in ("indexer_scores[verify]", "sparse_mla_partial[attn0-verify]",
                 "sparse_mla_partial[attn1-verify]"):
        records[name]["launches"] = got[name]

    def agreement(a, b):
        """Tokens equal per rid, and the first index where they differ."""
        return {r: (sum(x == y for x, y in zip(a[r], b[r])),
                    next((i for i, (x, y) in enumerate(zip(a[r], b[r]))
                          if x != y), None)) for r in a}

    # for information: the same requests at Q = 1 rounds
    sess, rep, _, m = run_session(torch, dev, params, ccfg, counted,
                                  compiled=True, do_warmup=False,
                                  reqs=c_reqs(), mtp_depth=0)
    session_summary("C at mtp_depth 0 (information)", sess, rep, m)
    print(f"session C vs the same requests at mtp_depth 0 (information): "
          f"(tokens equal, first differing index) per rid "
          f"{agreement(c_out, sess.outputs)} of {SESSION_C_NEW} (rids 1 and "
          f"3 sample)", flush=True)
    del sess
    torch.cuda.empty_cache()
    # the same pair where a verify step's queries cannot change one
    # another's result: a miss envelope that cannot overflow
    # (max_miss_ratio 1) and a capacity that cannot bind (cf = E / top_k:
    # each expert can hold every token of a step); then the envelope alone
    mo = ccfg.moe
    env = dataclasses.replace(ccfg, ess=dataclasses.replace(
        ccfg.ess, max_miss_ratio=1.0))
    nodrop = dataclasses.replace(env, moe=dataclasses.replace(
        mo, capacity_factor=mo.num_experts / mo.top_k))
    iso = {}
    for tag, icfg in (("no-drop", nodrop), ("envelope unbound", env)):
        outs = {}
        for depth in (1, 0):
            sess, rep, _, m = run_session(torch, dev, params, icfg, counted,
                                          compiled=True, do_warmup=False,
                                          reqs=c_reqs(), mtp_depth=depth)
            session_summary(f"C {tag} at mtp_depth {depth} (information)",
                            sess, rep, m)
            outs[depth] = dict(sess.outputs)
            del sess
            torch.cuda.empty_cache()
        iso[tag] = agreement(outs[1], outs[0])
        print(f"session C {tag} (capacity factor "
              f"{icfg.moe.capacity_factor:g}, max_miss_ratio "
              f"{icfg.ess.max_miss_ratio:g}): mtp_depth 1 vs 0 (tokens "
              f"equal, first differing index) per rid {iso[tag]} of "
              f"{SESSION_C_NEW}", flush=True)
    # where a greedy stream of the last pair still differs: the logits of
    # that position computed a third way (the prompt and the common prefix
    # through a fixed-batch prefill), at the two tokens drawn there
    prompts = session_prompts(icfg, c_reqs())
    for r, (_, i) in iso[tag].items():
        if i is None or SESSION_C[r][1]:
            continue
        tok = torch.as_tensor(np.concatenate(
            [prompts[r][0], outs[0][r][:i]]), device=dev)[None]
        pos = torch.arange(tok.shape[1], device=dev)[None]
        lg = E.ess_prefill(params, icfg, tok, pos, SESSION_MAX_SEQ,
                           prefill_chunk=PREFILL_CHUNK,
                           last_logits_only=True)[0][0, -1].float()
        a, b = outs[1][r][i], outs[0][r][i]
        top = lg.topk(3).values
        print(f"session C {tag}, rid {r} at index {i}: depth 1 drew {a}, "
              f"Q = 1 drew {b}; their logits recomputed by a prefill "
              f"{float(lg[a]):.6f} and {float(lg[b]):.6f} (gap "
              f"{float(lg[a] - lg[b]):.6f}); top-3 {top.tolist()}, logits "
              f"std {float(lg.std()):.4f}", flush=True)
        del tok, lg

    # 12. session F: the pipelined round (overlap=True) on the requests of
    #     sessions A and B (int8 + warmup), each graph then eager, and C
    #     (MTP depth 1 + sampling, graph), each stream bit for bit the
    #     synchronous graph session's; the launches are the eager runs'
    #     (F-C's the graph run's, its replays counted by the capture)
    t0 = time.perf_counter()
    f_runs = (("F-A", scfg, greedy_reqs(SESSION_PROMPTS, SESSION_NEW), False,
               "bf16", 0, (True, False), a_out),
              ("F-B", qcfg, greedy_reqs(SESSION_PROMPTS[:4], SESSION_NEW[:4]),
               True, "int8", 0, (True, False), b_out),
              ("F-C", ccfg, c_reqs, False, "bf16", 1, (True,), c_out))
    for tag, fcfg, make, warm, tier, depth, modes, base in f_runs:
        n, got, out = graph_and_eager(f"{tag} pipelined", fcfg, make, warm,
                                      tier, mtp_depth=depth, overlap=True,
                                      modes=modes,
                                      second_pass=tag != "F-C")
        require(out == base, f"session {tag}: the pipelined streams differ "
                f"from the synchronous graph session's")
        print(f"session {tag}: pipelined streams bit-identical to the "
              f"synchronous graph session's ({sum(map(len, out.values()))} "
              f"tokens)", flush=True)
        counts = dict(got, gather_rows=n["gather_rows_direct"],
                      scatter_rows=n["scatter_rows"],
                      sparse_mla_merge=n["sparse_mla_merge"])
        counts["gather_rows[prefill]"] = n["gather_rows_staged"]
        counts["gather_rows_dequant"] = n["gather_rows_dequant_direct"]
        counts["gather_rows_dequant[prefill]"] = \
            n["gather_rows_dequant_staged"]
        counts["gather_rows_raw[slab-int8]" if tier == "int8"
               else "gather_rows_raw[slab]"] = n["gather_rows_raw"]
        for name, r in records.items():
            r.setdefault("launches_session_f", {})[tag] = counts.get(name, 0)
        if tag != "F-C":            # eager runs: counted where launched
            records["gather_rows_raw[slab-int8]" if tier == "int8"
                    else "gather_rows_raw[slab]"]["launches"] = \
                n["gather_rows_raw"]
    print(f"session F: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13. the PD cluster: one prefill and two decode workers sharing the
    #     weights, bf16 then int8 + warmup, each against a 4-slot EssEngine
    t0 = time.perf_counter()
    cl = cluster_phase(torch, dev, serve, args, qargs, params, counted,
                       card)
    for tag, n in cl.items():
        sfx = "" if tag == "bf16" else "-int8"
        records[f"gather_pages[pack{sfx}]"]["launches"] = n["gather_pages"]
        records[f"put_pages[install{sfx}]"]["launches"] = n["put_pages"]
    print(f"cluster: {time.perf_counter() - t0:.1f} s", flush=True)

    # 13b. the long prompt: a 32K-token prompt admitted in chunks beside a
    #      decoding slot, against a standalone prefill and rid 0 alone
    t0 = time.perf_counter()
    long_prompt_phase(torch, dev, params, scfg, card, counted, records)
    print(f"long prompt: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11. session D: every weight zeroed in place, so every argmax is token
    #     0 and every draft is accepted; graph mode, against Q = 1 rounds
    for t in leaves(params):
        t.zero_()
    emits = []
    d_reqs = greedy_reqs(*zip(*SESSION_D))
    sess, rep, n, m = run_session(
        torch, dev, params, ccfg, counted, compiled=True, do_warmup=False,
        reqs=d_reqs(), mtp_depth=1, num_slots=2, max_seq=SESSION_D_MAX_SEQ,
        on_emit=lambda rid, k, c: emits.append((rid, k, c)))
    session_summary("D zero weights", sess, rep, m)
    base, brep, _, _ = run_session(
        torch, dev, params, ccfg, counted, compiled=True, do_warmup=False,
        reqs=d_reqs(), mtp_depth=0, num_slots=2, max_seq=SESSION_D_MAX_SEQ)
    require(rep.accept_rate == 1.0 and rep.spec_rounds == rep.rounds,
            f"session D: accept rate {rep.accept_rate}")
    require(all(k == 2 for _, k, _ in emits),
            f"session D: tokens per live slot-round {emits}")
    for rid, (_, budget) in enumerate(SESSION_D):
        charged = [c for r, _, c in emits if r == rid]
        require(all(c == 2 for c in charged[:-1]) and 1 <= charged[-1] <= 2
                and sum(charged) == budget - 1,
                f"session D: rid {rid} charged {charged} of budget {budget}")
    for req in sess.sched.finished:
        require(len(sess.outputs[req.rid]) == req.max_new_tokens
                == req.generated + 1,
                f"session D: rid {req.rid} ran past its budget")
    terminal = sorted(e.rid for e in sess.token_events if e.is_terminal)
    require(terminal == list(range(len(SESSION_D))),
            f"session D: terminal events {terminal}")
    require(sess.outputs == base.outputs,
            "session D: the spec streams differ from the Q = 1 session's")
    print(f"session D: accept rate {rep.accept_rate}, {rep.rounds} spec "
          f"rounds against {brep.rounds} Q = 1 rounds, 2 tokens per live "
          f"slot-round (budget clamps: "
          + ", ".join(f"rid {r} {[c for q, _, c in emits if q == r]}"
                      for r in range(len(SESSION_D)))
          + "), streams equal to the Q = 1 session's", flush=True)


# the long-prompt phase: rid 0 (a prompt, its budget) decodes while rid 1,
# submitted after rid 0's first token, admits a 32K-token prompt in 256-token
# chunks beside it; 2 slots of max_seq the long prompt + 8
LONG_PROMPTS = (8192, 32768)
LONG_NEW = (160, 2)
LONG_SLOTS, LONG_MAX_SEQ = 2, 32776


def long_prompt_phase(torch, dev, params, cfg, card, counted, records):
    """Phase 13b (see the module docstring); sets the kernel records'
    ``launches_long``, and the 32K indexer rows' ``launches``."""
    import numpy as np

    from repro_torch.serving import engine as E
    from repro_torch.serving.scheduler import Request

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, (1, n)) for n in LONG_PROMPTS]
    L, R = cfg.num_layers, cfg.ess.host_page_rows
    nb1 = -(-LONG_PROMPTS[1] // R)

    def tier_rows(caches, slot):
        """The pinned tier's rows of ``slot``'s first ``LONG_PROMPTS[1]``
        positions, copied on the host (no kernel)."""
        bt = caches.block_tables[slot].cpu()[:nb1]
        host = caches.host_latent
        return host[:, bt].reshape(L, nb1 * R, host.shape[-1])[
            :, :LONG_PROMPTS[1]].clone()

    def drive(with_long):
        """One compiled session's rounds; rid 1 submitted after rid 0's
        first token when ``with_long``.  Returns the session and a record
        per round: the prefill chunk's rid and seconds (between two
        synchronizes), the decode round's wall ms (host clock, ending in
        its fetch), decode tokens, hit and miss rows, whether it captured
        a graph, and rid 1's tier rows at its promotion."""
        sess = E.ServeSession(
            params, cfg, num_slots=LONG_SLOTS, max_seq=LONG_MAX_SEQ,
            prompt_fn=lambda r: prompts[r.rid],
            prefill_chunk=PREFILL_CHUNK, compiled=True, device=dev)
        real_prefill, real_decode = sess.prefill_round, sess.decode_round
        rep, cur, snap = sess.report, {}, {}

        def prefill_round():
            slot, task = next(iter(sess._prefill.items()), (None, None))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ran = real_prefill()
            torch.cuda.synchronize()
            if task is not None:
                cur["prefill"] = (task.req.rid, time.perf_counter() - t0)
                if task.req.rid == 1 and slot not in sess._prefill:
                    snap["rows"] = tier_rows(sess.caches, slot)
            return ran

        def decode_round():
            d0, h0, m0 = rep.decode_tokens, rep.hit_rows, rep.h2d_rows
            k, caps = rep.rounds, sess.programs.captures
            live = sorted(sess.sched.slots[i].rid
                          for i in sess.sched.active_slots())
            t0 = time.perf_counter()
            done = real_decode()
            if rep.rounds > k:
                cur["decode"] = dict(
                    ms=1e3 * (time.perf_counter() - t0),
                    tokens=rep.decode_tokens - d0,
                    hits=rep.hit_rows - h0, misses=rep.h2d_rows - m0,
                    captured=sess.programs.captures > caps, live=live)
            return done

        sess.prefill_round, sess.decode_round = prefill_round, decode_round
        sess.submit(Request(rid=0, prompt_len=LONG_PROMPTS[0],
                            max_new_tokens=LONG_NEW[0]))
        log, submitted = [], not with_long
        while sess.sched.running or sess.sched.queue:
            if not submitted and sess.outputs.get(0):
                sess.submit(Request(rid=1, prompt_len=LONG_PROMPTS[1],
                                    max_new_tokens=LONG_NEW[1]))
                submitted = True
            cur.clear()
            sess.step_round()
            log.append(dict(cur))
            require(len(log) < 4 * sum(LONG_NEW) + 400,
                    "long: the session does not finish")
        return sess, log, snap

    t0 = time.perf_counter()
    (sess, log, snap), n = counted(lambda: drive(True))
    wall = time.perf_counter() - t0
    rep = sess.report
    finished = sorted(r.rid for r in sess.sched.finished)
    require(finished == [0, 1] and [len(sess.outputs[r]) for r in (0, 1)]
            == list(LONG_NEW), f"long: finished {finished}, streams "
            f"{[len(sess.outputs.get(r, ())) for r in (0, 1)]}")
    long_idx = [i for i, e in enumerate(log)
                if e.get("prefill", (None,))[0] == 1]
    long_rounds = [log[i] for i in long_idx]
    chunks1 = len(long_rounds)
    require(chunks1 >= LONG_PROMPTS[1] // PREFILL_CHUNK,
            f"long: rid 1 prefilled in {chunks1} chunks")
    stalled = [i for i in long_idx
               if log[i].get("decode", {}).get("tokens", 0) < 1]
    require(not stalled, f"long: rounds in which rid 1 prefilled and rid 0 "
            f"decoded nothing: {stalled}")
    ch = sum(-(-p // PREFILL_CHUNK) for p in LONG_PROMPTS)
    require(rep.prefill_chunks == ch, f"long: {rep.prefill_chunks} chunks")
    require_tc_only(n, "long")
    got = check_shapes(n, cfg, {
        "indexer_scores[decode]": L * rep.rounds,
        "indexer_scores[prefill]": L * ch,
        "sparse_mla_partial[attn0]": L * rep.rounds,
        "sparse_mla_partial[attn1]": L * rep.rounds,
        "sparse_mla_partial[prefill]": L * ch}, "long")
    want = {"gather_rows_staged": L * ch, "gather_rows_direct": L * rep.rounds,
            "gather_rows_dequant": 0, "scatter_rows": ch + L * rep.rounds}
    require(all(n[k] == v for k, v in want.items())
            and n["gather_rows"] == L * (ch + rep.rounds)
            and n["sparse_mla_merge"] > 0,
            f"long: launches {n}, expected {want}")
    state = latent_state_bytes(torch, sess.caches)
    t1 = sess.outputs[1][0]
    a_out = list(sess.outputs[0])
    del sess
    torch.cuda.empty_cache()

    # rid 1 against a standalone prefill of its prompt at the same chunk
    tok = torch.as_tensor(prompts[1], device=dev)
    pos = torch.arange(LONG_PROMPTS[1], device=dev)[None]
    lg, donor = E.ess_prefill(params, cfg, tok, pos, LONG_MAX_SEQ,
                              do_warmup=False, prefill_chunk=PREFILL_CHUNK,
                              last_logits_only=True)
    lg = lg[0, -1].float()
    torch.cuda.synchronize()
    ref_rows = tier_rows(donor, 0)
    del donor
    t_ref = int(lg.argmax())
    same = torch.equal(snap["rows"].view(torch.int16),
                       ref_rows.view(torch.int16))
    if not same:
        d = (snap["rows"].float() - ref_rows.float()).abs()
        print(f"long: rid 1's tier rows differ from a standalone prefill's: "
              f"max |diff| {float(d.max()):.4g} at (layer, position, dim) "
              f"{np.unravel_index(int(d.argmax()), d.shape)} of "
              f"host_latent {list(ref_rows.shape)}", flush=True)
        pair = torch.tensor([t1, t_ref], device=dev)
        gap = float((lg[pair[1]] - lg[pair[0]]).abs())
        require(t1 == t_ref or gap <= bf16_ulp(float(lg[t_ref])),
                f"long: rid 1's first token {t1}, standalone {t_ref}, "
                f"logit gap {gap:.4g} beyond a bf16 ulp")
    else:
        require(t1 == t_ref, f"long: rid 1's first token {t1}, a "
                f"standalone prefill's {t_ref} from equal rows")
    del ref_rows, lg

    # rid 0 alone: a prefilling, then a live slot 1 must not move its stream
    alone, _, _ = drive(False)
    require(list(alone.outputs[0]) == a_out,
            "long: rid 0's stream differs from the same session's without "
            "rid 1")
    del alone
    torch.cuda.empty_cache()

    # prints
    pre1 = sum(e["prefill"][1] for e in long_rounds)
    dec = [e["decode"] for e in log if "decode" in e
           and not e["decode"]["captured"]]
    during = [e["decode"]["ms"] for e in long_rounds
              if "decode" in e and not e["decode"]["captured"]]
    last1 = max(i for i, e in enumerate(log)
                if 1 in e.get("decode", {}).get("live", ()))
    after = [e["decode"]["ms"] for e in log[last1 + 1:]
             if "decode" in e and not e["decode"]["captured"]]
    at32 = [d for d in dec if 1 in d["live"]]
    alone_r = [d for d in dec if d["live"] == [0]]
    print(f"long: deepseek-v32-exp-ess as the serve, 2 slots, max_seq "
          f"{LONG_MAX_SEQ}, chunk {PREFILL_CHUNK}: rid 0 {LONG_PROMPTS[0]} "
          f"+ {LONG_NEW[0]} tokens, rid 1 {LONG_PROMPTS[1]} + {LONG_NEW[1]} "
          f"after rid 0's first token; {rep.rounds} decode rounds, "
          f"{rep.prefill_chunks} chunks, wall {wall:.2f} s  [{card}]",
          flush=True)
    print(f"long: rid 1 prefill {chunks1} chunks, {LONG_PROMPTS[1] / pre1:.1f} "
          f"tok/s over its chunks' own time ({pre1:.3f} s), "
          f"{LONG_PROMPTS[1] / rep.ttft_s[1]:.1f} tok/s from submit to first "
          f"token (the decode rounds between its chunks included); TTFT "
          f"{rep.ttft_rounds[1]} rounds, {1e3 * rep.ttft_s[1]:.1f} ms from "
          f"submit  [{card}]", flush=True)
    print(f"long: rid 0 decode {np.mean(during):.3f} ms/round while rid 1 "
          f"prefills ({len(during)} rounds; median "
          f"{float(np.median(during)):.3f}), {np.mean(after):.3f} ms/round "
          f"after ({len(after)} rounds)  [{card}]", flush=True)
    print(f"long: at 32K context (the rounds in which rid 1 decodes, both "
          f"slots live): hits / misses per round "
          + ", ".join(f"{d['hits']} / {d['misses']}" for d in at32)
          + f"; rid 0 alone: {np.mean([d['hits'] for d in alone_r]):.1f} / "
          f"{np.mean([d['misses'] for d in alone_r]):.1f} per round (mean of "
          f"{len(alone_r)})  [{card}]", flush=True)
    dev_b = state["indexer"] + state["pool_rows"] + state["pool_maps"]
    print(f"long: per slot, pinned host tier "
          f"{state['host_tier'] / LONG_SLOTS / 2**20:.2f} MiB against device "
          f"{dev_b / LONG_SLOTS / 2**20:.2f} MiB (indexer keys "
          f"{state['indexer'] / LONG_SLOTS / 2**20:.2f} + pools "
          f"{(state['pool_rows'] + state['pool_maps']) / LONG_SLOTS / 2**20:.2f}"
          f"); rid 1's tier rows {'equal' if same else 'NOT equal'} to a "
          f"standalone prefill's bit for bit, first token {t1} ({t_ref}); "
          f"rid 0's {len(a_out)} tokens equal to its run alone  [{card}]",
          flush=True)
    counts = dict(got, gather_rows=n["gather_rows_direct"],
                  scatter_rows=n["scatter_rows"],
                  sparse_mla_merge=n["sparse_mla_merge"])
    counts["gather_rows[prefill]"] = n["gather_rows_staged"]
    # every indexer launch of this phase reads keys over max_seq 32776
    for tag in ("decode", "prefill"):
        counts[f"indexer_scores[{tag}-32k]"] = got[f"indexer_scores[{tag}]"]
        records[f"indexer_scores[{tag}-32k]"]["launches"] = \
            counts[f"indexer_scores[{tag}-32k]"]
    for name, r in records.items():
        r["launches_long"] = counts.get(name, 0)


# the cluster phase: one prefill worker (2 slots) and two decode workers
# (2 slots each) on the card, on session A's first four requests (rid 1
# sampled), held bit for bit against one 4-slot EssEngine
CLUSTER_PROMPTS = SESSION_PROMPTS[:4]
CLUSTER_NEW = SESSION_NEW[:4]
CLUSTER_SAMPLED = {1: dict(temperature=0.8, top_k=16, seed=5)}


def cluster_phase(torch, dev, serve, args, qargs, params, counted, card):
    """The PD-disaggregated cluster on one card (see the module docstring):
    the serve's config at a miss envelope and a MoE capacity that cannot
    bind (``max_miss_ratio`` 1, capacity factor E / top_k), so that a
    slot's decode math does not depend on its co-residents; a bf16 tier
    (graph rounds), then an int8 tier with the LRU warmup (tails shipped in
    the packets, replayed on the decode side; graph rounds).  Each run's
    streams must equal a 4-slot ``EssEngine``'s on the same weights bit for
    bit; every request migrates; every pack makes exactly one host wait
    and no other sync, every install none (``set_sync_debug_mode
    ("error")`` around both); the page gather carries every pack and the
    page write every install.  Returns ``{run: launch counts}``."""
    import dataclasses

    import numpy as np

    from repro_torch.analysis import audit
    from repro_torch.cluster import EssCluster
    from repro_torch.cluster import kv_transfer as KT
    from repro_torch.core import offload
    from repro_torch.serving.api import EssEngine, SamplingParams

    def unbound(cfg):
        mo = cfg.moe
        return dataclasses.replace(
            cfg, moe=dataclasses.replace(
                mo, capacity_factor=mo.num_experts / mo.top_k),
            ess=dataclasses.replace(cfg.ess, max_miss_ratio=1.0))
    rng = np.random.default_rng(0)
    cfg0 = serve.config_from_args(args)
    prompts = [rng.integers(0, cfg0.vocab_size, (1, n))
               for n in CLUSTER_PROMPTS]
    sps = [SamplingParams(max_tokens=n, **CLUSTER_SAMPLED.get(i, {}))
           for i, n in enumerate(CLUSTER_NEW)]
    kw = dict(max_seq=SESSION_MAX_SEQ, prefill_chunk=PREFILL_CHUNK,
              prompt_fn=lambda r: prompts[r.rid], device=dev)
    out = {}
    for tag, a, warm in (("bf16", args, False),
                         ("int8 warmup", qargs, True)):
        cfg = unbound(serve.config_from_args(a))
        t0 = time.perf_counter()
        eng = EssEngine(params, cfg, num_slots=4, do_warmup=warm, **kw)
        want = [(o.tokens, o.finish_reason)
                for o in eng.generate(CLUSTER_PROMPTS, sps,
                                      max_rounds=10000)]
        eng_s = time.perf_counter() - t0
        del eng
        torch.cuda.empty_cache()
        m = dict(pack_wall=[], copy_ev=[], install_wall=[], put_ev=[],
                 waits=0)
        pack, install = KT.pack_migration, KT.install_migration
        gather, put, wait = (offload.gather_tier_pages,
                             offload.put_tier_pages, KT.host_wait)

        def events(key, fn):
            def run(*a_, **k_):
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
                fn(*a_, **k_)
                ev[1].record()
                m[key].append(ev)
            return run

        def one_wait(d):
            torch.cuda.set_sync_debug_mode(0)
            m["waits"] += 1
            wait(d)
            torch.cuda.set_sync_debug_mode("error")

        def sync_checked(key, fn):
            def run(*a_, **k_):
                torch.cuda.set_sync_debug_mode("error")
                t = time.perf_counter()
                try:
                    return fn(*a_, **k_)
                finally:
                    m[key].append(1e3 * (time.perf_counter() - t))
                    torch.cuda.set_sync_debug_mode(0)
            return run
        KT.pack_migration = sync_checked("pack_wall", pack)
        KT.install_migration = sync_checked("install_wall", install)
        offload.gather_tier_pages = events("copy_ev", gather)
        offload.put_tier_pages = events("put_ev", put)
        KT.host_wait = one_wait
        try:
            t0 = time.perf_counter()
            clu = EssCluster(params, cfg, num_prefill=1, num_decode=2,
                             num_slots=2, do_warmup=warm, **kw)
            with audit.ClusterWatch(clu) as cw:
                outs, n = counted(lambda: clu.generate(
                    CLUSTER_PROMPTS, sps, max_rounds=10000))
            clu_s = time.perf_counter() - t0
        finally:
            KT.pack_migration, KT.install_migration = pack, install
            offload.gather_tier_pages, offload.put_tier_pages = gather, put
            KT.host_wait = wait
            torch.cuda.set_sync_debug_mode(0)
        got = [(o.tokens, o.finish_reason) for o in outs]
        met = clu.metrics()
        require(got == want, f"cluster {tag}: streams differ from the "
                f"4-slot EssEngine's: {got} vs {want}")
        nm = met["migrations"]
        require(nm == len(CLUSTER_PROMPTS) == met["installed"]
                and all(w.installed > 0 for w in clu.decode),
                f"cluster {tag}: {nm} migrations, installs "
                f"{[w.installed for w in clu.decode]}")
        require(m["waits"] == nm == len(m["pack_wall"]),
                f"cluster {tag}: {m['waits']} host waits for {nm} packs")
        require(n["gather_pages"] == nm and n["put_pages"] == nm,
                f"cluster {tag}: page launches {n['gather_pages']} / "
                f"{n['put_pages']} for {nm} migrations")
        if warm:
            require(n["gather_rows_dequant_direct"] > 0,
                    f"cluster {tag}: no warmup replay on the decode side")
        torch.cuda.synchronize()
        copy_ms = [a.elapsed_time(b) for a, b in m["copy_ev"]]
        put_ms = [a.elapsed_time(b) for a, b in m["put_ev"]]
        per_worker = []
        for w in clu.decode:
            r = w.session.report
            steady = r.rounds - r.fill_rounds
            per_worker.append(f"{1e3 * r.decode_wall_s / steady:.2f} "
                              f"({steady} rounds)" if steady else "none")
        ttft = [o.ttft_s for o in outs if o.ttft_s is not None]
        print(f"cluster {tag}: launches " + ", ".join(
            f"{k} {v}" for k, v in n.items()), flush=True)
        print(f"cluster {tag}: streams bit-identical to the 4-slot "
              f"EssEngine's ({sum(len(t) for t, _ in got)} tokens; engine "
              f"{eng_s:.1f} s, cluster {clu_s:.1f} s wall); {nm} migrations, "
              f"{met['wire_bytes']} wire bytes; pack: page copy "
              f"{sum(copy_ms) / nm:.3f} ms device ({min(copy_ms):.3f}-"
              f"{max(copy_ms):.3f}), wall incl. its one wait "
              f"{sum(m['pack_wall']) / nm:.3f} ms; install: wall "
              f"{sum(m['install_wall']) / nm:.3f} ms (no host sync), page "
              f"write {sum(put_ms) / nm:.3f} ms device; decode ms/round per "
              f"decode worker {per_worker}; mean TTFT "
              f"{1e3 * sum(ttft) / len(ttft):.1f} ms; launches gather_pages "
              f"{n['gather_pages']}, put_pages {n['put_pages']}  [{card}]",
              flush=True)
        fs, c = cw.findings(), cw.counts()
        print(f"audit cluster {tag}: ESS107 {c['packs']} packs, "
              f"{c['waits_per_pack']} host wait(s) a pack; {c['installs']} "
              f"installs, {c['install_waits']} waits in them; "
              f"{c['prefill_rounds']} prefill rounds waiting only to pack; "
              f"{c['decode_fetches']} fetches over {c['decode_rounds']} "
              f"decode rounds; findings {len(fs)}"
              + "".join(f"\n  {f.format()}" for f in fs), flush=True)
        require(not fs, f"audit cluster {tag}: {len(fs)} finding(s)")
        out[tag] = n
        del clu
        torch.cuda.empty_cache()
    return out


# the example mirrors (examples/*_torch.py) and their arguments, each in
# its own process; CKPT_DIR stands for a fresh temporary directory
CKPT_DIR = "{ckpt}"
MIRRORS = (("serve_ess_torch.py", ()), ("stream_abort_torch.py", ()),
           ("serve_cluster_torch.py", ()),
           ("train_small_torch.py",
            ("--steps", "50", "--ckpt-dir", CKPT_DIR)))
MIRROR_TIMEOUT_S = 300


# the archs phase: (config, layers kept, what the cut keeps); every width
# is the published one
ARCHS = (("qwen3-0.6b", 28, "whole, 28 layers"),
         ("gemma2-27b", 2, "46 -> 2 layers: local + global"),
         ("gemma3-27b", 6, "62 -> 6 layers: one period, 5 local + 1 global"),
         ("qwen1.5-110b", 2, "80 -> 2 layers"),
         ("dbrx-132b", 2, "40 -> 2 layers, MoE 16 experts top-4"),
         ("qwen2-vl-7b", 2, "28 -> 2 layers, embedding inputs"),
         ("deepseek-v3-671b", 4, "61 -> 4 layers (3 dense + 1 MoE), "
                                 "mtp_depth 1 -> 0"),
         ("mamba2-780m", 48, "whole, 48 Mamba2 layers"),
         ("zamba2-7b", 81, "whole, 81 Mamba2 layers: 13 groups of 6, each "
                           "followed by one of 2 shared attention blocks in "
                           "turn, 3 remainder layers"),
         ("whisper-large-v3", 32, "whole, 32 encoder + 32 decoder layers"))
ARCH_EAGER_ROUNDS = 4       # decode rounds 1-4 eager, then a CUDA graph
ARCH_PROFILED = 2           # the last graph rounds, profiled
QUEST_BLOCK, QUEST_TOPB = 32, 64     # 2048 positions, DSA's top-2048


def consistency(got, ref) -> tuple[float, float]:
    """(max |got - ref|, the bound 2e-2 + 2e-2 max|ref|): the reference's
    ``test_prefill_decode_consistent_with_train``."""
    return (float((got - ref).abs().max()),
            2e-2 + 2e-2 * float(ref.abs().max()))


def to_fp32(tree):
    """A parameter tree's leaves cast to fp32 (bf16 widens exactly: the
    same function in exact arithmetic)."""
    return {k: to_fp32(v) if isinstance(v, dict) else v.float()
            for k, v in tree.items()}


def ssm_witness(name, new, dec_b, pre_b, dec_f, pre_f, secs, card):
    """An SSM-backbone row (mamba2, zamba2) held against its own fp32
    run: the bf16 weights widened to fp32, the rounds fed the bf16 run's
    stream.  Each argument holds the logits at rounds 1 and ``new``
    ``[B, 2, V]``: the bf16 decode and prefill over the stream, the fp32
    ones.  Printed: the fp32 decode against the fp32 prefill, the bf16
    prefill against the fp32 prefill (how far bf16 rounding alone moves
    the stack's output: its floor) and the bf16 decode against the fp32
    decode.  Required: the fp32 decode within the reference's bound of
    the fp32 prefill, and the bf16 decode within its floor plus that
    bound of the fp32 decode (a decode that rounds worse than the
    prefill does fails)."""
    fp = [consistency(dec_f[:, i], pre_f[:, i]) for i in (0, 1)]
    floor = [consistency(pre_b[:, i], pre_f[:, i])[0] for i in (0, 1)]
    dec = [consistency(dec_b[:, i], dec_f[:, i]) for i in (0, 1)]

    def pair(e):
        return (f"round 1 {e[0][0]:.4g} (bound {e[0][1]:.4g}), round "
                f"{new} {e[1][0]:.4g} (bound {e[1][1]:.4g})")
    print(f"  {name} witness (fp32: the bf16 weights widened, the rounds "
          f"fed the bf16 stream): fp32 decode vs fp32 prefill {pair(fp)}; "
          f"bf16 prefill vs fp32 prefill (the floor) round 1 "
          f"{floor[0]:.4g}, round {new} {floor[1]:.4g}; bf16 decode vs "
          f"fp32 decode {pair(dec)}; {secs:.1f} s  [{card}]", flush=True)
    require(all(e <= b for e, b in fp),
            f"{name}: fp32 decode vs prefill logits {pair(fp)}")
    require(all(e <= f + b for (e, b), f in zip(dec, floor)),
            f"{name}: bf16 decode vs fp32 decode {pair(dec)}, past the "
            f"floor {floor[0]:.4g} / {floor[1]:.4g} plus the bound")


def quest_check(torch, dev, cfg, caches, card):
    """Quest at qwen3-0.6b's widths on the last layer's decode cache after
    the run (every position written: 8224 = 257 blocks of 32), a seeded
    bf16 query per head: with every block selected the sparse attention
    equals full decode attention within 2e-2; the meta update for one new
    token equals the min / max of the old meta and a rebuild; the top-64
    blocks go through the LRU pool, missing at the first lookup and not
    at the second.  Prints the recall of the top 64 (random weights)."""
    from repro_torch.core import lru_pool as LP
    from repro_torch.core import quest as Q
    from repro_torch.models.attention import repeat_kv
    k, v = caches["kv"].k[-1], caches["kv"].v[-1]           # [B,S,KV,hd]
    lens = caches["lens"]
    B, S, KV, hd = k.shape
    H = cfg.num_heads
    scale = cfg.query_scale or hd ** -0.5
    g = torch.Generator(device=dev).manual_seed(77)
    q = torch.randn((B, H, hd), generator=g, device=dev).to(k.dtype)
    meta = Q.build_block_meta(k, QUEST_BLOCK)
    nb = S // QUEST_BLOCK
    ids, bv = Q.quest_topk_blocks(q, meta, lens, QUEST_BLOCK, nb)
    got = Q.gqa_sparse_attention(q, k, v, ids, bv, lens, QUEST_BLOCK, scale)
    s = torch.einsum("bhd,bshd->bhs", q.float(),
                     repeat_kv(k, H // KV).float()) * scale
    s = s.masked_fill(~(torch.arange(S, device=dev)[None] < lens[:, None]
                        )[:, None], -2.0e38)
    w = torch.softmax(s, -1).to(v.dtype).float()
    full = torch.einsum("bhs,bshd->bhd", w, repeat_kv(v, H // KV).float())
    err = float((got.float() - full).abs().max())
    require(err <= 2e-2, f"quest: every block selected, {err:.3g} from full "
            f"decode attention (2e-2)")
    ids, bv = Q.quest_topk_blocks(q, meta, lens, QUEST_BLOCK, QUEST_TOPB)
    rec = Q.attention_recall(q, k, lens, ids, bv, QUEST_BLOCK, scale)
    # the incremental update: a new key at each slot's last position
    old = Q.BlockMeta(meta.kmin.clone(), meta.kmax.clone())
    k_new = torch.randn((B, KV, hd), generator=g, device=dev).to(k.dtype)
    pos = lens - 1
    Q.update_block_meta(meta, k_new, pos, QUEST_BLOCK)
    k2 = k.clone()
    k2[torch.arange(B, device=dev), pos] = k_new
    reb = Q.build_block_meta(k2, QUEST_BLOCK)
    require(torch.equal(meta.kmin, torch.minimum(old.kmin, reb.kmin))
            and torch.equal(meta.kmax, torch.maximum(old.kmax, reb.kmax)),
            "quest: the meta update differs from min / max with a rebuild")
    del k2, reb, old
    # the selected blocks through the LRU pool, a block (its k and v) a row
    dim = QUEST_BLOCK * KV * hd * 2
    rows = torch.cat([k.reshape(B, nb, -1), v.reshape(B, nb, -1)], -1)
    pool = LP.init_pool(B, QUEST_TOPB, nb, dim, k.dtype, dev)
    pool, lk, st1 = LP.lookup(pool, ids, bv, max_misses=QUEST_TOPB,
                              slot_mask=None)
    miss_rows = rows.gather(1, lk.miss_ids.clamp_min(0)[..., None].expand(
        B, QUEST_TOPB, dim))
    LP.admit(pool, lk.miss_ids, miss_rows, slot_mask=None)
    LP.tick(pool)
    pool, _, st2 = LP.lookup(pool, ids, bv, max_misses=QUEST_TOPB,
                             slot_mask=None)
    m1, m2 = st1.misses.tolist(), st2.misses.tolist()
    require(all(m > 0 for m in m1) and not any(m2),
            f"quest pool: misses {m1} then {m2}")
    print(f"  quest (qwen3-0.6b's last layer, block {QUEST_BLOCK}, top "
          f"{QUEST_TOPB} of {nb}): all blocks vs full decode attention "
          f"{err:.3g} (2e-2); meta update = min/max with a rebuild; pool "
          f"misses {m1} then {m2}; recall of the top {QUEST_TOPB} (worst "
          f"head, per slot, random weights) "
          + ", ".join(f"{float(r):.4f}" for r in rec) + f"  [{card}]",
          flush=True)


def archs_phase(torch, dev, args, card, counted, records):
    """Phase 15, the generic path on the GQA family, DeepSeek-V3's
    dense-MLA branch, and the SSM, hybrid and encoder-decoder stacks
    (``ARCHS``): per configuration, random bf16 weights from the serve's
    seed at the published widths, depth cut as listed; 4 prompts of 8192
    tokens from the serve's seed (qwen2-vl: seeded embeddings, M-RoPE
    positions t = h = w = position; whisper: 416-token decoder prompts and
    4 x 1500 seeded frame embeddings, the stubbed front end's output),
    ``generic_prefill``, then 32 ``generic_decode`` rounds to ``max_seq``
    8224 (whisper: 448, its text context; greedy; qwen2-vl
    teacher-forced), rounds 1-4 eager under sync-debug "error" and the rest
    replays of a CUDA graph captured over one round; before the first
    replay an eager round from a copy of the state (every cache entry, the
    SSM state included) must give the replay's logits bit for bit.  Then
    one prefill over the whole stream (8224 positions; whisper: 448, the
    same frames): its logits at position 8192 (the prompt plus the first
    fed token: causal, the same function as a prefill of 8193) and 8223
    must meet the reference's consistency bound against rounds 1 and 32.
    The SSM-backbone rows (mamba2, zamba2) print their bf16 errors and
    run again in fp32 on the same stream, held by :func:`ssm_witness`
    (PERF.md §6 has why).  The MoE configs (dbrx, V3) run with
    their capacity unbound (``capacity_factor = E / top_k``): at the
    published 1.25 a 4-token decode round and a 32K-token prefill drop
    different tokens, so the two compute different functions (dbrx's
    round 1 missed the bound by 2.5x so), and the reference's own test
    holds only where nothing drops, as in its smoke configs.  V3's sparse-MLA launches must all
    take the tensor-core route.  Quest runs on qwen3-0.6b's cache
    (:func:`quest_check`)."""
    import contextlib
    import dataclasses

    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.configs.whisper_large_v3 import TEXT_CTX
    from repro_torch.kernels import counters
    from repro_torch.kernels.sparse_mla import ops as sops
    from repro_torch.models import transformer as T
    from repro_torch.models.mla import PREFILL_QUERY_CHUNK
    from repro_torch.models.params import count_params, init_params, model_def
    from repro_torch.serving import engine as E

    B, new = args.requests, args.new_tokens
    for name, layers, cut in ARCHS:
        t_cfg = time.perf_counter()
        full = get_config(name)
        # the encoder-decoder's decoder prompt: its text context less the
        # rounds; the other rows take the serve's prompt length
        S = TEXT_CTX - new if full.encdec is not None else args.prompt_len
        max_seq = S + new
        cfg = cut_depth(full, layers) if full.attn_kind == "mla" else \
            dataclasses.replace(full, num_layers=layers)
        if cfg.moe is not None:
            # the capacity unbound: a decode round of 4 tokens and a
            # prefill of 32K route each token alike only where nothing
            # drops (the reference's smoke configs never bind it)
            mo = cfg.moe
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                mo, capacity_factor=mo.num_experts / mo.top_k))
            cut += (f"; MoE capacity factor {mo.capacity_factor} -> "
                    f"E / top_k = {mo.num_experts / mo.top_k:g} (none "
                    f"dropped)")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = init_params(cfg, args.seed, device=dev)
        wbytes = sum(t.numel() * t.element_size() for t in leaves(params))
        g = torch.Generator(device=dev).manual_seed(args.seed)
        pos = torch.arange(max_seq, device=dev)[None].expand(B, max_seq)
        mrope = pos[..., None].expand(B, max_seq, 3) \
            if cfg.mrope_sections else None
        if cfg.embedding_inputs:
            stream = torch.randn((B, max_seq, cfg.d_model), generator=g,
                                 device=dev).to(cfg.param_dtype)
        else:
            stream = torch.zeros((B, max_seq), dtype=torch.int64, device=dev)
            stream[:, :S] = torch.as_tensor(np.random.default_rng(
                args.seed).integers(0, cfg.vocab_size, (B, S)), device=dev)
        frames = None
        if cfg.encdec is not None:
            frames = torch.randn((B, cfg.encdec.encoder_seq, cfg.d_model),
                                 generator=g, device=dev).to(cfg.param_dtype)

        def run(params, cfg, forced):
            """Prefill, then the rounds: greedy, or fed the stream
            (``forced``: the rounds a first run recorded there)."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pf = E.generic_prefill(
                params, cfg, stream[:, :S], pos[:, :S], device=dev,
                mrope_positions=None if mrope is None else mrope[:, :S],
                enc_inputs=frames, want_logits=False)
            first = T._unembed(params, cfg, pf.hidden[:, -1])    # [B,V]
            caches = T.pad_caches(pf.caches, max_seq)
            del pf
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            at_prefill = counters.snapshot()
            x = stream[:, S:S + 1].clone()          # the round's input
            if not (cfg.embedding_inputs or forced):
                x.copy_(first.argmax(-1)[:, None])
            logits, eager_ms, graph_ms_ = [], [], []

            def step():
                return E.generic_decode(params, cfg, x,
                                        caches["lens"][:, None], caches,
                                        device=dev)

            def feed(r, lg):
                """Round r's logits -> the next round's input (greedy,
                recorded in the stream; or the stream's next entry)."""
                if cfg.embedding_inputs or forced:
                    if r + 1 < new:
                        x.copy_(stream[:, S + r + 1:S + r + 2])
                else:
                    stream[:, S + r:S + r + 1].copy_(x)
                    x.copy_(lg.argmax(-1)[:, None])
            for r in range(ARCH_EAGER_ROUNDS):
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    lg = step().logits[:, -1].clone()
                    feed(r, lg)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                eager_ms.append(1e3 * (time.perf_counter() - t0))
                logits.append(lg)
            eager = counters.diff(counters.snapshot(), at_prefill)
            box = {}
            graph, delta = counted_capture(
                torch, lambda: box.update(out=step()))
            # the first replay against an eager round from a copy of the
            # state, the same input (a check: its launches are not counted)
            copy = {k: v.clone() if torch.is_tensor(v)
                    else type(v)(*(a.clone() for a in v))
                    for k, v in caches.items()}
            before = counters.snapshot()
            want = E.generic_decode(params, cfg, x, copy["lens"][:, None],
                                    copy, device=dev).logits.clone()
            counters.restore(before)
            del copy
            bitwise, prof_ms, kern = None, 0.0, {}
            for r in range(ARCH_EAGER_ROUNDS, new):
                profiled = r >= new - ARCH_PROFILED
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) \
                        if profiled else contextlib.nullcontext() as prof:
                    t0 = time.perf_counter()
                    graph.replay()
                    counters.add(delta)
                    lg = box["out"].logits[:, -1].clone()
                    if bitwise is None:
                        bitwise = torch.equal(box["out"].logits, want)
                    feed(r, lg)
                    torch.cuda.synchronize()
                    wall = 1e3 * (time.perf_counter() - t0)
                if profiled:
                    prof_ms += wall
                    for ev in prof.key_averages():
                        if ev.device_type == DeviceType.CUDA:
                            kern[ev.key] = kern.get(ev.key, 0.0) \
                                + ev.self_device_time_total / 1e3
                else:
                    graph_ms_.append(wall)
                logits.append(lg)
            del graph, box, want
            return dict(caches=caches, logits=torch.stack(logits, 1),
                        prefill_s=prefill_s, eager=eager, delta=delta,
                        eager_ms=eager_ms, graph_ms=graph_ms_,
                        bitwise=bitwise, prof_ms=prof_ms, kernels=kern)

        def drive(params, cfg, forced=False):
            """:func:`run` counted, its cache checked and freed, then one
            prefill over the whole stream: its logits at rounds 1 and
            ``new`` (``out["ref"]``)."""
            out, n = counted(lambda: run(params, cfg, forced))
            caches = out.pop("caches")
            out["cache_bytes"] = sum(a.numel() * a.element_size()
                                     for k, v in caches.items()
                                     if k != "lens" for a in v)
            require(int(caches["lens"].min()) == max_seq,
                    f"{name}: lens {caches['lens'].tolist()}")
            if name.startswith("qwen3-0.6b"):
                quest_check(torch, dev, cfg, caches, card)
            del caches
            torch.cuda.empty_cache()
            # positions S (round 1's) and max_seq - 1 (round 32's)
            ck = E.generic_prefill(
                params, cfg, stream, pos, device=dev,
                mrope_positions=mrope, enc_inputs=frames, want_logits=False)
            out["ref"] = T._unembed(params, cfg,
                                    ck.hidden[:, [S, max_seq - 1]])
            require(bool(torch.isfinite(out["logits"]).all()),
                    f"{name}: non-finite logits")
            require(out["bitwise"], f"{name}: a graph round's logits "
                    f"differ from an eager round's from the same state")
            return out, n

        out, n = drive(params, cfg)
        ref, lg = out.pop("ref"), out["logits"]
        cache_bytes = out["cache_bytes"]
        e1, b1 = consistency(lg[:, 0], ref[:, 0])
        e2, b2 = consistency(lg[:, -1], ref[:, 1])
        # an SSM-backbone row's bf16 errors are printed, and the row is
        # held by ssm_witness below
        require(cfg.ssm is not None or (e1 <= b1 and e2 <= b2),
                f"{name}: decode vs prefill logits {e1:.4g} (round 1, bound "
                f"{b1:.4g}), {e2:.4g} (round {new}, bound {b2:.4g})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        em, gm = out["eager_ms"], out["graph_ms"]
        row = dict(name=name, cut=cut, weights_gb=wbytes / 1e9,
                   params_full=count_params(model_def(full)),
                   prefill_tok_s=B * S / out["prefill_s"],
                   graph_ms=sum(gm[1:]) / len(gm[1:]), graph_first=gm[0],
                   eager_ms=sum(em[1:]) / len(em[1:]), eager_first=em[0],
                   cache_mb=cache_bytes / 1e6, err1=e1, bound1=b1, err32=e2,
                   bound32=b2, peak_gib=peak,
                   s=time.perf_counter() - t_cfg)
        print(f"archs {name} ({row['cut']}; weights {row['weights_gb']:.2f} "
              f"GB of {row['params_full'] / 1e9:.2f}B params at full depth): "
              f"prefill {row['prefill_tok_s']:.0f} tok/s; decode "
              f"{row['graph_ms']:.2f} ms/round graph (rounds 6-"
              f"{new - ARCH_PROFILED}), "
              f"{row['eager_ms']:.2f} eager (rounds 2-{ARCH_EAGER_ROUNDS}; "
              f"round 1 {row['eager_first']:.2f}); cache on the card "
              f"{row['cache_mb']:.2f} MB; decode vs prefill logits"
              f"{' (bf16, printed)' if cfg.ssm else ''}: round 1 "
              f"{e1:.4g} (bound {b1:.4g}), round {new} {e2:.4g} (bound "
              f"{b2:.4g}); graph round == eager round bit for bit; peak "
              f"{peak:.1f} GiB; {row['s']:.1f} s  [{card}]", flush=True)
        busy = sum(out["kernels"].values())
        top = sorted(out["kernels"].items(), key=lambda kv: -kv[1])[:5]
        print(f"  {name}: {ARCH_PROFILED} profiled graph rounds: device busy "
              f"{100 * busy / out['prof_ms']:.1f} %; by device ms a round: "
              + ", ".join(f"{k[:44]} {v / ARCH_PROFILED:.3f}" for k, v in top)
              + f"  [{card}]", flush=True)
        if cfg.attn_kind == "mla":
            require(n["sparse_mla_tc"] > 0 and n["sparse_mla_general"] == 0,
                    f"{name}: sparse-MLA launches tc {n['sparse_mla_tc']}, "
                    f"general {n['sparse_mla_general']}")
            by = n["sparse_mla_by_shape"]
            L_, C = cfg.num_layers, PREFILL_QUERY_CHUNK
            want = {(C, S): L_ * -(-S // C), (1, max_seq): L_ * new}
            require(by == want, f"{name}: partial launches by shape {by}, "
                    f"expected {want}")
            eg = out["eager"][("partial_attend", "launches_by_shape")]
            require(eg == {(1, max_seq): L_ * ARCH_EAGER_ROUNDS},
                    f"{name}: eager rounds' partials {eg}")
            print(f"  {name}: partial_attend launches by (Q, rows): "
                  + ", ".join(f"{k} {v}" for k, v in by.items())
                  + f" (all on the tensor-core route; merges "
                  f"{n['sparse_mla_merge']})", flush=True)
            records["sparse_mla_partial[v3-decode]"]["launches"] = \
                eg[(1, max_seq)]
            records["sparse_mla_partial[v3-prefill]"]["launches"] = \
                by[(C, S)]
        if cfg.ssm is not None:
            t32 = time.perf_counter()
            lg, ref = lg[:, [0, -1]].float(), ref.float()
            p32 = to_fp32(params)
            del params, out
            torch.cuda.empty_cache()
            o32, _ = drive(p32, dataclasses.replace(
                cfg, param_dtype=torch.float32), forced=True)
            ssm_witness(name, new, lg, ref, o32["logits"][:, [0, -1]],
                        o32["ref"], time.perf_counter() - t32, card)
            del p32, o32
        else:
            del params, out
        del ref, lg, stream, frames
        torch.cuda.empty_cache()


# the sharding phase (17): a world of one on the card
SHARD_PROMPTS = (4096, 2048, 3000, 1000)
SHARD_NEW = 16
# its two-rank part: the serve model cut to its 3 dense layers (a MoE
# layer's capacity dispatch spans the whole batch, so DTensor gathers its
# routing across ranks, and DTensor's functional all-gather does not run
# on a gloo group over CUDA tensors), two processes of 2 slots each
SHARD_RANK_LAYERS = 3
SHARD_WORLD = 2


def sharding_phase(torch, dev, serve, args, card, counted):
    """Phase 17: ``repro_torch.distributed`` on the card, a world of one.

    An NCCL process group of one rank from an in-process store
    (``HashStore``: no network), the host mesh over it
    (``make_host_mesh``: data 1 x model 1).  On CUDA tensors, each against
    its plain oracle on the card: ``sharded_flash_decode`` (the merge's
    MAX and SUM all-reduces over the data group) against a softmax over
    every key; ``pipeline_apply`` over one stage against the layer loop;
    the compressed gradient all-reduce against the dequantized gradients
    (exact: the mean of one rank) and the true ones (0.02).  Then the ESS
    decode at published widths (the serve's 4 layers, new weights from
    the serve's seed) as session A runs it, graph rounds, 4 requests
    through 4 slots, without a context and then inside
    ``use_sharding(host mesh, PROFILES[cfg.sharding_profile](False))``:
    the greedy streams must be equal, the context run's rounds replayed
    from CUDA graphs, and its gather, indexer and sparse-MLA launches
    above 0.  Last, the ESS decode over two ranks on this card
    (:func:`two_rank_phase`).  The other multi-rank checks run only on
    the CPU (8 gloo ranks, the 512-rank fake group), printed as such."""
    import torch.distributed as dist

    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.collectives import sharded_flash_decode
    from repro_torch.distributed.compression import (allreduce_compressed,
                                                     compress_grads,
                                                     decompress_grads,
                                                     init_ef)
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models.params import init_params
    from repro_torch.serving.scheduler import Request

    t_phase = time.perf_counter()
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh(device_type="cuda")
        print(f"sharding: NCCL world {dist.get_world_size()}, host mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))}",
              flush=True)
        g = torch.Generator(device=dev).manual_seed(0)
        # the flash merge at the serve's decode widths: 4 sequences, 128
        # heads, 576-dim rows, 8192 keys, ragged valid lengths
        B, H, S, D = 4, 128, 8192, 576
        q = torch.randn((B, H, D), generator=g, device=dev)
        k = torch.randn((B, S, D), generator=g, device=dev)
        v = torch.randn((B, S, D), generator=g, device=dev)
        valid = torch.arange(S, device=dev)[None] < torch.tensor(
            [8192, 6000, 1, 4097], device=dev)[:, None]
        scale = D ** -0.5
        got = sharded_flash_decode(mesh, "data", q, k, v, valid, scale)
        s = torch.einsum("bhd,bsd->bhs", q, k) * scale
        w = torch.softmax(torch.where(valid[:, None], s, -2.0e38), -1)
        want = torch.einsum("bhs,bsd->bhd", w, v)
        err = float((got - want).abs().max())
        print(f"sharding: sharded_flash_decode [{B},{H},{S},{D}] vs softmax "
              f"on the card, max err {err:.3g} (tol 1e-5 x max|ref| "
              f"{float(want.abs().max()):.3g})", flush=True)
        require(got.is_cuda and err <= 1e-5 * max(1.0, float(
            want.abs().max())), f"sharded_flash_decode off by {err}")
        # GPipe over one stage: 8 layers, 4 microbatches
        pm = make_mesh((1, 1), ("pod", "model"), "cuda")
        wl = torch.randn((8, 1024, 1024), generator=g, device=dev) * 0.03
        x = torch.randn((64, 1024), generator=g, device=dev)
        got = pipeline_apply(lambda lw, h: torch.tanh(h @ lw), wl, x, pm,
                             axis="pod", microbatches=4)
        want = x
        for i in range(wl.shape[0]):
            want = torch.tanh(want @ wl[i])
        err = float((got - want).abs().max())
        print(f"sharding: pipeline_apply 1 stage x 8 layers [64,1024] vs "
              f"the layer loop, max err {err:.3g}", flush=True)
        require(got.is_cuda and err <= 1e-6, f"pipeline_apply off by {err}")
        # the compressed all-reduce of gradients
        grads = {"w": torch.randn((4096, 1024), generator=g, device=dev),
                 "b": torch.randn((1024,), generator=g, device=dev)}
        mean, _ = allreduce_compressed(grads, init_ef(grads),
                                       mesh.get_group("data"))
        deq = decompress_grads(*compress_grads(grads, init_ef(grads))[:2])
        exact = all(torch.equal(mean[n], deq[n]) for n in grads)
        err = max(float((mean[n] - grads[n]).abs().max()) for n in grads)
        print(f"sharding: compressed all-reduce, equal to the dequantized "
              f"gradients {exact}, max err vs the gradients {err:.3g} "
              f"(tol 0.02 x max|g|)", flush=True)
        require(exact and err <= 0.02 * max(float(t.abs().max())
                                            for t in grads.values()),
                "the compressed all-reduce is off")
        print("sharding: ran on the CPU only (NCCL takes one rank a "
              "card): pipeline_apply over 4 stages, sharded_flash_decode "
              "over 8 shards and the compressed all-reduce over 8 ranks "
              "(tests/test_torch_distributed.py, 8 gloo ranks); the ESS "
              "decode over data 2 x model 2 (tests/test_torch_ess_ranks.py, "
              "4 gloo ranks); every cell's shard shapes on the 16x16 and "
              "2x16x16 meshes (tests/test_torch_sharding.py) and the dry "
              "run (tests/test_torch_dryrun.py; 512-rank fake group)",
              flush=True)
        del q, k, v, s, w, want, wl, x, got, grads, mean, deq

        # the ESS decode under a context of one
        cfg = serve.config_from_args(args)
        params = init_params(cfg, args.seed, dev)
        rules = shd.PROFILES[cfg.sharding_profile](False)
        reqs = lambda: [Request(rid=i, prompt_len=p, max_new_tokens=SHARD_NEW)
                        for i, p in enumerate(SHARD_PROMPTS)]
        runs = {}
        for ctx in (False, True):
            with (shd.use_sharding(mesh, rules) if ctx
                  else contextlib.nullcontext()):
                sess, rep, n, m = run_session(
                    torch, dev, params, cfg, counted, compiled=True,
                    do_warmup=False, reqs=reqs())
            pr = sess.programs
            dm = m["decode_ms"]
            runs[ctx] = dict(sess.outputs)
            tag = "under the context" if ctx else "without a context"
            print(f"sharding: ESS decode {tag}: {rep.rounds} rounds, "
                  f"{pr.captures} captures, {pr.replays} replays, decode "
                  f"{sum(dm) / len(dm):.2f} ms/round (mean of {len(dm)}, "
                  f"graph rounds), wall {m['wall_s']:.2f} s; launches "
                  f"gather_rows {n['gather_rows']}, indexer_scores "
                  f"{n['indexer_scores']}, sparse_mla_partial "
                  f"{n['sparse_mla_partial']} (by shape "
                  f"{n.get('sparse_mla_by_shape')}; indexer by Q "
                  f"{n.get('indexer_by_q')}; gather_rows staged "
                  f"{n.get('gather_rows_staged')}, direct "
                  f"{n.get('gather_rows_direct')}), sparse_mla_merge "
                  f"{n.get('sparse_mla_merge')}, scatter_rows "
                  f"{n.get('scatter_rows')}  [{card}]", flush=True)
            require(pr.captures > 0 and pr.replays > 0
                    and pr.replays + pr.captures == rep.rounds,
                    f"sharding {tag}: {pr.captures} captures, "
                    f"{pr.replays} replays for {rep.rounds} rounds")
            missing = [k_ for k_ in ("gather_rows", "indexer_scores",
                                     "sparse_mla_partial") if n[k_] == 0]
            require(not missing, f"sharding {tag}: not launched {missing}")
            del sess
        same = runs[False] == runs[True]
        print(f"sharding: greedy streams under the context equal to the "
              f"run without one: {same} "
              f"({sum(len(v) for v in runs[True].values())} tokens)",
              flush=True)
        require(same, "sharding: the context changed the greedy streams")
        del params
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    two_rank_phase(torch, dev, serve, card, counted)
    print(f"sharding phase: {time.perf_counter() - t_phase:.1f} s  "
          f"[{card}]", flush=True)


def shard_prefill(torch, E, params, cfg, caches, prompts, slots, dev):
    """Each of ``slots`` prefilled alone, chunk by chunk, as a session's
    bucketed prefill runs it (chunks of ``PREFILL_CHUNK``, a ragged last
    chunk padded to its power-of-two bucket); returns ``(first tokens
    {slot: token}, caches)``.  Over several ranks the caller passes its
    own slots, and each chunk runs on this rank's tensors alone."""
    from repro_torch.serving.step import chunk_bucket
    firsts = {}
    for slot in slots:
        toks = torch.as_tensor(prompts[slot], device=dev).long()
        n = toks.shape[1]
        for c0 in range(0, n, PREFILL_CHUNK):
            ck = min(PREFILL_CHUNK, n - c0)
            C = chunk_bucket(ck, PREFILL_CHUNK)
            t = torch.nn.functional.pad(toks[:, c0:c0 + ck], (0, C - ck))
            last = c0 + ck >= n
            lg, caches, _, _ = E.ess_prefill_chunk(
                params, cfg, t, c0 + torch.arange(C, device=dev)[None],
                caches, slot=slot, want_logits=last, n_valid=ck)
        firsts[slot] = int(lg[0, ck - 1].argmax())
    return firsts, caches


def shard_rank_config(serve):
    """The two-rank part's model: the serve's arguments, cut to its
    dense layers."""
    args = serve.build_parser().parse_args(
        SERVE_ARGS + ["--layers", str(SHARD_RANK_LAYERS)])
    return args, serve.config_from_args(args)


def shard_rank_main(rank: int, world: int, d: str) -> int:
    """One rank of :func:`two_rank_phase`, in its own process: joins the
    group through a file store in ``d``, makes its caches (its 2 slots, its
    pinned tier shard), prefills its own slots, then runs the decode
    rounds teacher-forced with the one-rank stream, and writes its rows'
    logits, launches, round times and collectives to ``d``."""
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.cache import latent_cache as LC
    from repro_torch.distributed import sharding as shd
    from repro_torch.kernels import counters
    from repro_torch.launch import serve
    from repro_torch.launch.dryrun import _counter_mode
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.params import distribute_params, init_params
    from repro_torch.serving import engine as E

    if not torch.cuda.is_available():
        return fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("cpu:gloo,cuda:gloo",
                            init_method=f"file://{d}/store", rank=rank,
                            world_size=world)
    try:
        spec = json.loads(Path(d, "spec.json").read_text())
        prompts = [np.asarray(p) for p in spec["prompts"]]
        stream = np.asarray(spec["stream"])                # [R + 1, B]
        args, cfg = shard_rank_config(serve)
        mesh = make_mesh((world, 1), ("data", "model"), "cuda")
        rules = shd.PROFILES["tp"](False)
        out = {"rank": rank}
        with shd.use_sharding(mesh, rules), implicit_replication(), \
                torch.no_grad():
            params = distribute_params(init_params(cfg, args.seed, dev),
                                       cfg, mesh, rules)
            B = len(prompts)
            caches = LC.init_ess_caches(cfg, B, SESSION_MAX_SEQ, device=dev)
            r0, nb = shd.batch_block(mesh, B)
            out.update(rows=[r0, r0 + nb],
                       tier=list(caches.host_latent.shape),
                       tier_pinned=caches.host_latent.is_pinned(),
                       tier_plain=type(caches.host_latent) is torch.Tensor,
                       dtensor_caches=shd.is_dtensor(caches.lens))
            before = counters.snapshot()
            t0 = time.perf_counter()
            firsts, caches = shard_prefill(torch, E, params, cfg, caches,
                                           prompts, range(r0, r0 + nb), dev)
            torch.cuda.synchronize()
            out["prefill_s"] = time.perf_counter() - t0
            out["firsts"] = [firsts[s_] for s_ in range(r0, r0 + nb)]
            out["prefill_launches"] = {
                k[0]: v for k, v in counters.diff(
                    counters.snapshot(), before).items()
                if k[1] == "launches"}
            before = counters.snapshot()
            logits, ms, colls = [], [], None
            for r in range(len(stream) - 1):
                tok = torch.as_tensor(stream[r], device=dev).long()
                counter = _counter_mode() if r == 0 else \
                    contextlib.nullcontext()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with counter:
                    o = E.ess_decode(params, cfg, tok[:, None],
                                     caches.lens[:, None], caches,
                                     slot_mask=None)
                    lo = shd.to_local_batch(o.logits)[:, 0]
                torch.cuda.synchronize()
                if r == 0:
                    colls = dict(counter.coll_count)
                else:
                    ms.append((time.perf_counter() - t0) * 1e3)
                caches = o.caches
                logits.append(lo.float().cpu().numpy())
            out["decode_launches"] = {
                k[0]: v for k, v in counters.diff(
                    counters.snapshot(), before).items()
                if k[1] == "launches"}
            out.update(round_ms=ms, collectives=colls)
        n = out["decode_launches"]
        print(f"sharding rank {rank} of {world}: slots {r0}-{r0 + nb - 1}, "
              f"decode {np.mean(ms):.2f} ms/round (eager, rounds "
              f"2-{len(ms) + 1}); launches gather_rows {n['gather_rows']}, "
              f"indexer_scores {n['indexer_scores']}, sparse_mla_partial "
              f"{n['partial_attend']}, sparse_mla_merge {n['merge_splits']}, "
              f"scatter_rows {n['scatter_rows']}; collectives {colls}",
              flush=True)
        np.save(Path(d, f"logits_{rank}.npy"), np.stack(logits))
        Path(d, f"rank_{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()
    return 0


def two_rank_phase(torch, dev, serve, card, counted):
    """Phase 17's two ranks on the one card.

    The model: the serve's weights (``args.seed``) cut to its 3 dense
    layers at published widths.  The phase's 4 requests, each slot
    prefilled alone (:func:`shard_prefill`), then ``SHARD_NEW`` eager
    decode rounds over the 4 slots, first on one rank here (the greedy
    stream and its logits), then by ``SHARD_WORLD`` processes
    (:func:`shard_rank_main`), a gloo group carrying CUDA tensors and a
    ``data 2 x model 1`` mesh: each rank holds 2 slots, its own pinned
    tier shard and DTensor caches, prefills its own slots and runs every
    round teacher-forced with the one-rank stream.  Each rank must exit
    0, launch the gather, indexer, sparse-MLA, merge and scatter kernels
    in its decode rounds, issue no collective in a round, and keep its
    logits within ``MONO_LOGIT_REL`` of the one-rank run's, greedy tokens
    equal but where the one-rank top-2 gap is within the two runs' own
    logit distance there (a near-tie)."""
    import os
    import tempfile

    import numpy as np

    from repro_torch.cache import latent_cache as LC
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E

    from repro_torch.serving.scheduler import Request
    args, cfg = shard_rank_config(serve)
    prompts = session_prompts(cfg, [Request(rid=i, prompt_len=p,
                                            max_new_tokens=SHARD_NEW)
                                    for i, p in enumerate(SHARD_PROMPTS)])
    B = len(prompts)
    params = init_params(cfg, args.seed, dev)
    caches = LC.init_ess_caches(cfg, B, SESSION_MAX_SEQ, device=dev)
    with torch.no_grad():
        firsts, caches = shard_prefill(torch, E, params, cfg, caches,
                                       prompts, range(B), dev)
        stream = [[firsts[b] for b in range(B)]]
        ref, ms = [], []

        def rounds():
            nonlocal caches
            for r in range(SHARD_NEW):
                tok = torch.tensor(stream[r], device=dev)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                o = E.ess_decode(params, cfg, tok[:, None],
                                 caches.lens[:, None], caches,
                                 slot_mask=None)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                caches = o.caches
                ref.append(o.logits[:, 0].float().cpu().numpy())
                stream.append(ref[-1].argmax(-1).tolist())
        _, n1 = counted(rounds)
    ref = np.stack(ref)                                   # [R, B, V]
    print(f"sharding two ranks: one rank first, {cfg.num_layers} dense "
          f"layers at published widths, {B} slots, prompts "
          f"{SHARD_PROMPTS}, {SHARD_NEW} eager rounds: {np.mean(ms[1:]):.2f}"
          f" ms/round (rounds 2-{SHARD_NEW}); launches gather_rows "
          f"{n1['gather_rows']}, indexer_scores {n1['indexer_scores']}, "
          f"sparse_mla_partial {n1['sparse_mla_partial']}, sparse_mla_merge "
          f"{n1['sparse_mla_merge']}, scatter_rows {n1['scatter_rows']}  "
          f"[{card}]", flush=True)
    del params, caches
    torch.cuda.empty_cache()

    d = tempfile.mkdtemp(prefix="ess_ranks_")
    Path(d, "spec.json").write_text(json.dumps(
        {"prompts": [p.tolist() for p in prompts], "stream": stream}))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    logs = [open(Path(d, f"rank_{r}.log"), "w") for r in range(SHARD_WORLD)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--shard-rank",
         str(r), str(SHARD_WORLD), d], env=env, cwd=str(ROOT), stdout=log,
        stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    try:
        rcs = [p.wait(timeout=900) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    wall = time.perf_counter() - t0
    for r, rc in enumerate(rcs):
        log = Path(d, f"rank_{r}.log").read_text()
        print(log[-4000:] if rc else "\n".join(
            f"{line}  [{card}]" for line in log.splitlines()
            if line.startswith("sharding rank")), flush=True)
        require(rc == 0, f"sharding two ranks: rank {r} exited {rc} (the "
                         f"world must form; there is no world of one "
                         f"instead)")
    need = ("gather_rows", "indexer_scores", "partial_attend",
            "merge_splits", "scatter_rows")
    for r in range(SHARD_WORLD):
        got = json.loads(Path(d, f"rank_{r}.json").read_text())
        lg = np.load(Path(d, f"logits_{r}.npy"))          # [R, nb, V]
        b0, b1 = got["rows"]
        want = ref[:, b0:b1]
        diff = np.abs(lg - want)
        rel = float(diff.max() / np.abs(want).max())
        top = want.argmax(-1)
        mine = lg.argmax(-1)
        gap = np.take_along_axis(want, top[..., None], -1)[..., 0] \
            - np.take_along_axis(want, mine[..., None], -1)[..., 0]
        flips = mine != top
        near = flips & (gap <= 2 * diff.max(-1))
        n = got["decode_launches"]
        ms = got["round_ms"]
        print(f"sharding two ranks: rank {r} of {SHARD_WORLD} (slots "
              f"{b0}-{b1 - 1}, tier {got['tier']} pinned "
              f"{got['tier_pinned']}, caches DTensors "
              f"{got['dtensor_caches']}): prefill {got['prefill_s']:.2f} s; "
              f"decode {np.mean(ms):.2f} ms/round (rounds 2-{SHARD_NEW}, "
              f"eager; min {min(ms):.2f}, max {max(ms):.2f}); launches "
              f"gather_rows {n['gather_rows']}, indexer_scores "
              f"{n['indexer_scores']}, sparse_mla_partial "
              f"{n['partial_attend']}, sparse_mla_merge {n['merge_splits']}, "
              f"scatter_rows {n['scatter_rows']} (prefill: "
              + ", ".join(f"{k} {v}" for k, v in
                          got["prefill_launches"].items() if v)
              + f"); collectives in a round "
              f"{got['collectives']}; logits vs one rank max |diff| / "
              f"max|ref| {rel:.3g} (limit {MONO_LOGIT_REL}); greedy "
              f"disagreements {int(flips.sum())} of {flips.size}, near-ties "
              f"{int(near.sum())}  [{card}]", flush=True)
        require(got["tier_plain"] and got["tier_pinned"]
                and got["tier"][1] * SHARD_WORLD == B * (-(-SESSION_MAX_SEQ
                    // cfg.ess.host_page_rows)),
                f"rank {r}: its tier must be its own pinned shard")
        missing = [k for k in need if n[k] == 0]
        require(not missing, f"rank {r}: not launched {missing}")
        require(not got["collectives"],
                f"rank {r}: collectives in a decode round "
                f"{got['collectives']}")
        require(rel <= MONO_LOGIT_REL, f"rank {r}: logits off by {rel}")
        require(bool((near == flips).all()),
                f"rank {r}: greedy tokens differ beyond near-ties")
    print(f"sharding two ranks: {SHARD_WORLD} processes, {wall:.1f} s "
          f"wall  [{card}]", flush=True)


def mirrors_phase(card):
    """The three serve mirrors and the train mirror (the ~100M qwen3-family
    model, 50 steps, checkpoints in a temporary directory) on the card,
    started together, each its own process (the kernels built above);
    each must exit 0 (its own assertions included).  Every process is
    waited for, and killed if it outlives the time limit."""
    import tempfile

    t0 = time.perf_counter()
    logs = {name: tempfile.TemporaryFile(mode="w+") for name, _ in MIRRORS}
    ckpt = tempfile.TemporaryDirectory()
    procs = {}
    for name, extra in MIRRORS:
        argv = [ckpt.name if a == CKPT_DIR else a for a in extra]
        procs[name] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / name), *argv], cwd=ROOT,
            stdout=logs[name], stderr=subprocess.STDOUT, text=True)
    try:
        for name, proc in procs.items():
            try:
                proc.wait(timeout=max(1.0, MIRROR_TIMEOUT_S
                                      - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            logs[name].seek(0)
            lines = logs[name].read().strip().splitlines()
            print(f"mirror {name}: exit {proc.returncode} after "
                  f"{time.perf_counter() - t0:.1f} s; the last lines of its "
                  f"output:  [{card}]", flush=True)
            print("\n".join(f"  {line}" for line in lines[-40:]),
                  flush=True)
            require(proc.returncode == 0,
                    f"mirror {name} exited {proc.returncode}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
        ckpt.cleanup()


# the train phase (16): the optimizer's schedule for every run of it
TRAIN_OPT = dict(lr=3e-4, total_steps=100, warmup_steps=10)
# T1: qwen3-0.6b whole at published widths, the reference's train_4k
# length; micro-batch 2 x accumulation 4 (8 sequences a step)
T1_SEQ, T1_MICRO, T1_ACCUM, T1_STEPS = 4096, 2, 4, 4
T1_PREDICTED_GB = 46.0
# T2: DeepSeek-V3.2 cut to its first (dense) layer, MTP cut; 3072 tokens
# is past index_topk 2048, so the DSA mask is live
T2_SEQ, T2_STEPS = 3072, 2
T2_PREDICTED_GB = 63.0
# T3: one step of each plan's smoke config, card against CPU
TRAIN_SMOKES = ("qwen3-0.6b-smoke", "deepseek-v32-exp-ess-smoke",
                "mamba2-780m-smoke", "zamba2-7b-smoke",
                "whisper-large-v3-smoke")
def amax(t) -> float:
    """max |t|, 0 for an empty tensor."""
    return float(t.abs().max()) if t.numel() else 0.0


# a first AdamW step moves an element by lr * c g / (|c g| + eps), about
# lr times the sign of the clipped gradient c g: where |c g| is near eps a
# gradient difference at fp32 rounding moves it by up to lr, from
# WELL_POSED * eps on by under 1e-8 (tests/test_torch_training.py)
WELL_POSED = 100


def step_vs_cpu(torch, dev, name, tol=1e-5):
    """One train step of the smoke config ``name`` (fp32, remat "dots")
    on the card against the same step on the CPU, the same parameters and
    batch (2 x 32): the loss within ``tol`` relative, each leaf's gradient
    within 1e-4 of its largest entry, and the parameters and moments after
    the AdamW step within ``tol`` of each leaf's scale of the CPU's AdamW
    on the card's own gradients (every element) and of the CPU's step
    wherever that is well posed (at least 95 % of the elements).  Returns
    (the loss relative error, the largest step error where well posed,
    the share of elements left out, the indexer's launches, the card's
    step ms and its peak GB)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.params import init_params
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                                init_opt_state)
    from repro_torch.training.tree import leaves, tree_map

    cfg = dataclasses.replace(get_config(name), param_dtype=torch.float32)
    opt = AdamWConfig(**TRAIN_OPT)
    cpu = init_params(cfg, 1, device="cpu")
    batch = make_batch(DataConfig(cfg.vocab_size, 2, 32), 0)
    if cfg.encdec is not None:
        batch["enc_inputs"] = torch.as_tensor(np.random.default_rng(
            5).standard_normal((2, cfg.encdec.encoder_seq, cfg.d_model)),
            dtype=torch.float32)
    out = {}
    n0 = iops.indexer_scores.launches
    for where, d in (("cpu", "cpu"), ("card", dev)):
        p = tree_map(lambda t: t.to(d), cpu)
        b = {k: v.to(d) for k, v in batch.items()}
        loss, g = loss_and_grads(p, cfg, b)
        o = init_opt_state(p)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        p2, o2, m = make_train_step(cfg, opt)(p, o, b)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() * 1e-9
        out[where] = (float(loss), tree_map(lambda t: t.cpu(), g),
                      tree_map(lambda t: t.cpu(), (p2, o2.m, o2.v)), m)
    launches = iops.indexer_scores.launches - n0
    (l_c, g_c, s_c, m_c), (l_d, g_d, s_d, m_d) = out["cpu"], out["card"]
    lerr = abs(l_d - l_c) / abs(l_c)
    require(lerr <= tol and abs(float(m_d["loss"]) - float(m_c["loss"]))
            <= tol * abs(float(m_c["loss"])),
            f"train {name}: card loss {l_d} vs CPU {l_c}")
    gmax = max(amax(a) for a in leaves(g_c))
    for a, b in zip(leaves(g_d), leaves(g_c)):
        top = amax(b)
        if top < 1e-7 * gmax:       # zero in exact arithmetic: noise
            require(amax(a) < 1e-7 * gmax,
                    f"train {name}: a noise gradient grew on the card")
            continue
        require(float((a - b).abs().max()) <= 1e-4 * top,
                f"train {name}: card gradient off by "
                f"{float((a - b).abs().max()):.3g} (max {top:.3g})")
    # the card's AdamW against the CPU's on the same (the card's) grads
    p_cpu = tree_map(lambda t: t.clone(), cpu)
    ref = adamw_update(opt, p_cpu, g_d, init_opt_state(p_cpu))
    for a, b in zip(leaves(s_d), leaves((ref[0], ref[1].m, ref[1].v))):
        require(amax(a - b) <= tol * max(1.0, amax(b)), f"train {name}: "
                f"AdamW on the card differs from the CPU's on the same "
                f"gradients")
    scale = min(1.0, opt.grad_clip / float(m_c["grad_norm"]))
    left = total = 0
    worst = 0.0
    for a, b, g, gd in zip(leaves(s_d[0]), leaves(s_c[0]), leaves(g_c),
                           leaves(g_d)):
        well = ((scale * g).abs() >= WELL_POSED * opt.eps) | (
            (g == 0) & (gd == 0))
        left += int((~well).sum())
        total += g.numel()
        worst = max(worst, amax((a - b)[well]) / max(1.0, amax(b)))
    require(worst <= tol and left <= 0.05 * total,
            f"train {name}: parameters after the step off by {worst:.3g} "
            f"of their scale ({left} of {total} elements ill posed)")
    return lerr, worst, left / total, launches, ms, peak


def keep_mask_vs_plain(torch, q, w, keys, valid, k):
    """The DSA keep mask (top-``k``) from the indexer kernel's scores
    against the plain version's on the same inputs: they may differ only
    at keys whose plain score lies within twice the kernel-vs-plain score
    error of their row's k-th plain score (where the k-th and (k+1)-th
    scores are that close).  Returns (the kernel's scores, the score
    error, the keys and the rows that differ); raises otherwise."""
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.kernels.indexer import ref as iref
    from repro_torch.models import mla as M

    sc = iops.indexer_scores(q, w, keys, valid)
    want = iref.indexer_scores_ref(q, w, keys, valid)
    err = float((sc - want).abs().max())
    diff = M.dsa_keep_mask(sc, k, valid) ^ M.dsa_keep_mask(want, k, valid)
    thr = torch.sort(torch.where(valid, want, M.NEG_INF), dim=-1,
                     descending=True).values[..., k - 1:k]
    require(bool((~diff | ((want - thr).abs() <= 2 * err)).all()),
            "the keep mask from the indexer kernel's scores differs from "
            "the plain version's away from the top-k threshold")
    return sc, err, int(diff.sum()), int(diff.any(-1).sum())


def t1_qwen3(torch, dev, card):
    """T1: qwen3-0.6b (28 of 28 layers, published widths), fp32 params,
    remat "dots", micro-batch ``T1_MICRO`` x accumulation ``T1_ACCUM`` at
    ``T1_SEQ`` tokens, ``T1_STEPS`` donated steps (the launcher's step):
    finite losses and grad norms; step ms, tokens/s, peak memory.  Then at
    seq 1024: the loss and gradients at micro 1 x accum 2 against micro 2
    x accum 1 on the same two sequences (loss within 1e-5 relative, each
    leaf's gradient within 1e-4 of its largest entry: a missing division
    by the accumulation, or a dropped microbatch, fails it), and "dots"
    against "none" gradients at micro 1 (within 1e-6 of each leaf's
    largest entry)."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.params import count_params, init_params, model_def
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.tree import leaves

    cfg = get_config("qwen3-0.6b", param_dtype=torch.float32, remat="dots")
    opt = AdamWConfig(**TRAIN_OPT)
    gb = 1e-9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device=dev)
    state = init_opt_state(params)
    bsz = T1_MICRO * T1_ACCUM
    dc = DataConfig(cfg.vocab_size, bsz, T1_SEQ, seed=0)
    step = make_train_step(cfg, opt, accum_steps=T1_ACCUM, donate=True)
    rows = []
    for i in range(T1_STEPS):
        batch = make_batch(dc, i, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        rows.append((loss, gn, time.perf_counter() - t0))
        require(math.isfinite(loss) and math.isfinite(gn),
                f"T1 step {i + 1}: loss {loss}, grad norm {gn}")
    peak = torch.cuda.max_memory_allocated() * gb
    warm = [r[2] for r in rows[1:]]
    ms = 1e3 * sum(warm) / len(warm)
    print(f"train T1 qwen3-0.6b (28 of 28 layers, "
          f"{count_params(model_def(cfg)) / 1e9:.3f}B params fp32, remat "
          f"dots; micro {T1_MICRO} x accum {T1_ACCUM} x seq {T1_SEQ} = "
          f"{bsz * T1_SEQ} tokens a step): step {ms:.1f} ms (steps 2-"
          f"{T1_STEPS}; step 1 {1e3 * rows[0][2]:.1f}), "
          f"{bsz * T1_SEQ / (ms / 1e3):.0f} train tokens/s; peak "
          f"{peak:.2f} GB (predicted about {T1_PREDICTED_GB:.0f}); losses "
          + ", ".join(f"{r[0]:.4f}" for r in rows) + "; grad norms "
          + ", ".join(f"{r[1]:.4f}" for r in rows) + f"  [{card}]",
          flush=True)
    del state, batch, m
    torch.cuda.empty_cache()

    b = make_batch(DataConfig(cfg.vocab_size, 2, 1024, seed=1), 0,
                   device=dev)
    la, ga = loss_and_grads(params, cfg, b, accum_steps=2)
    lb, gb_ = loss_and_grads(params, cfg, b, accum_steps=1)
    lrel = abs(float(la) - float(lb)) / abs(float(lb))
    aerr = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(leaves(ga), leaves(gb_)))
    print(f"train T1 accumulation at seq 1024: micro 1 x accum 2 vs micro "
          f"2 x accum 1: loss rel diff {lrel:.3g} (limit 1e-5), gradients' "
          f"largest error {aerr:.3g} of the leaf's max (limit 1e-4)  "
          f"[{card}]", flush=True)
    require(lrel <= 1e-5 and aerr <= 1e-4, "T1 accumulation check failed")
    del ga, gb_, la, lb
    torch.cuda.empty_cache()

    b1 = {k: v[:1] for k, v in b.items()}
    grads, peaks = {}, {}
    for r in ("dots", "none"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        grads[r] = loss_and_grads(params, dataclasses.replace(cfg, remat=r),
                                  b1)[1]
        torch.cuda.synchronize()
        peaks[r] = (torch.cuda.max_memory_allocated() - base) * gb
    rerr = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(leaves(grads["dots"]), leaves(grads["none"])))
    print(f"train T1 remat at micro 1 x seq 1024: dots vs none gradients, "
          f"largest error {rerr:.3g} of the leaf's max (limit 1e-6); peak "
          f"above the weights: dots {peaks['dots']:.2f} GB, none "
          f"{peaks['none']:.2f} GB  [{card}]", flush=True)
    require(rerr <= 1e-6, "T1 remat check failed")
    del grads, params
    torch.cuda.empty_cache()
    return ms, peak


def t2_dsa(torch, dev, card, counted, records):
    """T2: DeepSeek-V3.2 at published widths cut to its first (dense)
    layer, MTP cut, fp32 params, remat "dots", batch 1 x ``T2_SEQ``,
    ``T2_STEPS`` donated steps counted: the DSA mask's indexer scores must
    launch the kernel; finite losses; the indexer's leaves must get
    exactly zero gradient (their moments stay 0).  Then the keep mask
    from the kernel's scores against the plain version's on the layer's
    own inputs: they may differ only at keys whose plain score lies
    within twice the kernel-vs-plain score error of that row's k-th
    score.  Times the kernel at this shape (row 2-tr)."""
    import dataclasses
    import math

    from repro_torch.configs import cut_depth, get_config
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.kernels.indexer import ref as iref
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import layers as L
    from repro_torch.models import mla as M
    from repro_torch.models import transformer as T
    from repro_torch.models.params import count_params, init_params, model_def
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.tree import flatten

    full = get_config("deepseek-v32-exp-ess", param_dtype=torch.float32,
                      remat="dots")
    cfg = dataclasses.replace(cut_depth(full, 1), moe=dataclasses.replace(
        full.moe, first_dense_layers=1))
    k = cfg.dsa.index_topk
    gb = 1e-9
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, 0, device=dev)
    state = init_opt_state(params)
    dc = DataConfig(cfg.vocab_size, 1, T2_SEQ, seed=0)
    step = make_train_step(cfg, AdamWConfig(**TRAIN_OPT), donate=True)
    rows = []

    def run():
        nonlocal params, state
        for i in range(T2_STEPS):
            batch = make_batch(dc, i, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, batch)
            rows.append((float(m["loss"]), float(m["grad_norm"]),
                         time.perf_counter() - t0))
    _, n = counted(run)
    peak = torch.cuda.max_memory_allocated() * gb
    for loss, gn, _ in rows:
        require(math.isfinite(loss) and math.isfinite(gn),
                f"T2: loss {loss}, grad norm {gn}")
    launches = n["indexer_scores"]
    require(launches > 0, "T2: the indexer kernel was not launched")
    idx = [t for p, t in flatten(state.m) + flatten(state.v)
           if "indexer" in p]
    require(any(t.numel() for t in idx) and all(amax(t) == 0.0
                                                for t in idx),
            "T2: the indexer's leaves got a gradient")
    ms = 1e3 * sum(r[2] for r in rows[1:]) / max(1, len(rows) - 1)
    print(f"train T2 deepseek-v32-exp-ess (61 -> 1 layer, dense; mtp_depth "
          f"1 -> 0; {count_params(model_def(cfg)) / 1e9:.3f}B params fp32, "
          f"remat dots; batch 1 x seq {T2_SEQ}, DSA top-{k}): step "
          f"{ms:.1f} ms (steps 2-{T2_STEPS}; step 1 {1e3 * rows[0][2]:.1f}), "
          f"{T2_SEQ / (ms / 1e3):.0f} train tokens/s; peak {peak:.2f} GB "
          f"(predicted about {T2_PREDICTED_GB:.0f}); losses "
          + ", ".join(f"{r[0]:.4f}" for r in rows) + f"; indexer launches "
          f"{launches} (general {n['indexer_general']}, tc "
          f"{n['indexer_tc']}); indexer leaves' gradients exactly 0  "
          f"[{card}]", flush=True)
    del state
    torch.cuda.empty_cache()

    # the keep mask: kernel scores against the plain version's
    batch = make_batch(dc, 0, device=dev)
    with torch.no_grad():
        x = T._embed_in(params, cfg, batch["inputs"])
        lp, _ = T.layer_params(params, cfg, 0)
        h = L.rmsnorm(lp["ln1"], x, cfg.norm_eps)
        iq = M.indexer_query(lp["indexer"], h)
        keys = M.indexer_keys(lp["indexer"], h)
        pos = batch["positions"]
        valid = (pos[:, None, :, None] >= pos[:, None, None, :])[:, 0]
        del x, h, lp
    params.clear()
    torch.cuda.empty_cache()
    q, w = iq.q.contiguous(), iq.w.contiguous()
    sc, err, n_diff, n_rows = keep_mask_vs_plain(torch, q, w, keys, valid,
                                                 k)
    print(f"train T2 keep mask (2-tr): kernel vs plain scores max |diff| "
          f"{err:.3g}; the masks differ at {n_diff} keys in {n_rows} of "
          f"{T2_SEQ} rows (allowed only within 2x that of a row's k-th "
          f"score)  [{card}]", flush=True)
    nvalid = int(valid.sum())
    Hi, Di = q.shape[2], q.shape[3]
    nbytes = (q.numel() + w.numel()) * 4 + key_bytes(keys, valid) \
        + valid.numel() \
        + sc.numel() * 4
    bms, bby = bound_ms(nbytes, nvalid * Hi * (2 * Di + 2), "fp32_simt")
    records["indexer_scores[train]"] = dict(
        name="indexer_scores[train]", route="cuda",
        source="src/repro_torch/kernels/indexer/csrc/indexer.cu",
        replaces="src/repro/kernels/indexer/indexer.py:41",
        launches=launches, max_abs_err=err,
        ms=timed_ms(torch, lambda: iops.indexer_scores(q, w, keys, valid),
                    iters=5, warmup=1),
        device_ms=graph_ms(torch, lambda: iops.indexer_scores(
            q, w, keys, valid), iters=5),
        sort_ms=timed_ms(torch, lambda: M.dsa_keep_mask(sc, k, valid),
                         iters=5, warmup=1),
        plain_ms=timed_ms(torch, lambda: iref.indexer_scores_ref(
            q, w, keys, valid), iters=3, warmup=1),
        bound_ms=bms, bound_by=bby, library_ms=None,
        shape=f"DSA train mask: q [1, {T2_SEQ}, {Hi}, {Di}], keys [1, "
              f"{T2_SEQ}, {Di}] fp32 (the general route: the tc kernel "
              f"reads bf16), causal valid [1, {T2_SEQ}, {T2_SEQ}]; "
              f"sort_ms: the exact top-{k} keep mask from the scores")
    del q, w, keys, valid, sc, iq
    torch.cuda.empty_cache()
    return ms, peak


def resume_check(torch, dev, card):
    """``train_loop`` on the card (qwen3-0.6b-smoke, fp32): 6 steps saving
    every 3, a fresh loop resumes to 10; the parameters within 1e-5 of a
    straight 10-step run (the reference's
    ``test_train_loop_resumes_from_checkpoint``)."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.params import init_params
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig
    from repro_torch.training.optimizer import AdamWConfig, init_opt_state
    from repro_torch.training.train_loop import LoopConfig, train_loop
    from repro_torch.training.tree import leaves

    cfg = get_config("qwen3-0.6b-smoke", param_dtype=torch.float32)
    params = init_params(cfg, 0, device=dev)
    opt = init_opt_state(params)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=50,
                                            warmup_steps=5))
    dc = DataConfig(cfg.vocab_size, global_batch=4, seq_len=32)
    quiet = dict(log=lambda *_: None)
    with tempfile.TemporaryDirectory() as d:
        _, _, st1 = train_loop(step, params, opt, dc, LoopConfig(
            total_steps=6, ckpt_every=3, ckpt_dir=f"{d}/a", log_every=100),
            **quiet)
        saved = ckpt.latest_step(f"{d}/a")
        p2, o2, st2 = train_loop(step, params, opt, dc, LoopConfig(
            total_steps=10, ckpt_every=100, ckpt_dir=f"{d}/a",
            log_every=100), **quiet)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        px, _, _ = train_loop(step, params, opt, dc, LoopConfig(
            total_steps=10, ckpt_every=100, ckpt_dir=f"{d}/x",
            log_every=100), **quiet)
        ms = 1e3 * (time.perf_counter() - t0) / 10
        peak = torch.cuda.max_memory_allocated() * 1e-9
    err = max(float((a - b).abs().max()) for a, b in
              zip(leaves(p2), leaves(px)))
    on_card = all(t.is_cuda for t in leaves(p2))
    print(f"train resume: 6 steps (checkpoint at {saved}), resumed to "
          f"{st2.step}, against 10 straight: max |diff| {err:.3g} (limit "
          f"1e-5); resumed leaves on the card: {on_card}; the straight run "
          f"{ms:.1f} ms a step with the loop's data and final save (4 x 32 "
          f"tokens: {128 / (ms / 1e3):.0f} tokens/s), peak {peak:.3f} GB  "
          f"[{card}]", flush=True)
    require(st1.step == 6 and saved == 6 and st2.step == 10
            and int(o2.step) == 10 and err < 1e-5 and on_card,
            "train resume check failed")


def train_phase(torch, dev, card, counted, records):
    """Phase 16, training: T1, T2, T3 (:func:`step_vs_cpu` on each of
    ``TRAIN_SMOKES``) and the loop's resume on the card."""
    t1_qwen3(torch, dev, card)
    t2_dsa(torch, dev, card, counted, records)
    for name in TRAIN_SMOKES:
        t0 = time.perf_counter()
        lerr, worst, left, launches, ms, peak = step_vs_cpu(torch, dev,
                                                            name)
        print(f"train T3 {name}: one step card vs CPU, loss rel diff "
              f"{lerr:.3g}, parameters after AdamW {worst:.3g} of their "
              f"scale where well posed ({100 * left:.2f} % of elements "
              f"ill posed); indexer launches {launches}; card step "
              f"{ms:.1f} ms (2 x 32 tokens, eager, first call: "
              f"{64 / (ms / 1e3):.0f} tokens/s), peak {peak:.3f} GB; "
              f"{time.perf_counter() - t0:.1f} s  [{card}]", flush=True)
        if "v32" in name:
            require(launches > 0, "T3: the V3.2 smoke's train step did not "
                    "launch the indexer kernel on the card")
    resume_check(torch, dev, card)


def leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def main() -> int:
    t_start = time.perf_counter()
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
    copy_rates(torch, dev)
    print(f"host link: pinned -> device {COPY_BYTES_S['h2d'] / 1e9:.2f} GB/s, "
          f"device -> pinned {COPY_BYTES_S['d2h'] / 1e9:.2f} GB/s (256 MiB "
          f"copies; the bounds take its peak, {LINK_BYTES_S / 1e9:.0f} GB/s "
          f"each way)  [{card}]", flush=True)
    records = check_kernels(torch, dev)
    check_monolithic_kernels(torch, dev, records)
    check_v3_kernels(torch, dev, records)
    for r in records.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), library {r['library_ms']}, max err "
              f"{r['max_abs_err']:.3g}"
              + (f", device (graph) {r['device_ms']:.4f} ms"
                 if "device_ms" in r else "")
              + (f", library device (graph) {r['library_device_ms']:.4f} ms"
                 if "library_device_ms" in r else "")
              + (f", general route {r['general_ms']:.4f} ms"
                 if "general_ms" in r else "")
              + (f" (device {r['general_device_ms']:.4f} ms)"
                 if "general_device_ms" in r else "")
              + (f", {r['nsplit']} split(s)" if "nsplit" in r else "")
              + (f"; for information: cuBLAS bmm of the dots alone "
                 f"{r['bmm_ms']:.4f} ms, stable-sort top-k "
                 f"{r['topk_ms']:.4f} ms" if "bmm_ms" in r else "")
              + (f", top-2048 overlap with the plain scores "
                 f"{r['top2048_overlap']:.6f}" if "top2048_overlap" in r
                 else "")
              + (f", copy of the same bytes {r['copy_ms']:.4f} ms"
                 if "copy_ms" in r else "")
              + (f", route (b) (device out + one device -> pinned copy) "
                 f"{r['route_b_ms']:.4f} ms" if "route_b_ms" in r else "")
              + (f"; at the pack shape: kernel {r['pack_shape_ms']:.4f} ms "
                 f"(device {r['pack_shape_device_ms']:.4f}), bound "
                 f"{r['pack_shape_bound_ms']:.4f} ms, copy "
                 f"{r['pack_shape_copy_ms']:.4f} ms"
                 if "pack_shape_ms" in r else "")
              + (f", direct route on the same ids {r['direct_ms']:.4f} ms"
                 if "direct_ms" in r and "staged_ms" not in r else "")
              + (f", direct route {r['direct_ms']:.4f} ms (device "
                 f"{r['direct_device_ms']:.4f}), staged route "
                 f"{r['staged_ms']:.4f} ms (device "
                 f"{r['staged_device_ms']:.4f})" if "staged_ms" in r else "")
              + (f", stable sort alone {r['sort_ms']:.4f} ms"
                 if "sort_ms" in r else "")
              + (f", wrapper host {r['host_us']:.2f} us (UVA lookup each "
                 f"call: {r['host_us_uncached']:.2f} us)"
                 if "host_us" in r else "")
              + (f"; {r['shape']}" if "shape" in r else "")
              + f"  [{card}]", flush=True)
    a0, pf = records["sparse_mla_partial[attn0]"], \
        records["sparse_mla_partial[prefill]"]
    print(f"  sparse_mla: attn0 {a0['ms']:.4f} ms vs SDPA "
          f"{a0['library_ms']:.4f} ms ({a0['library_ms'] / a0['ms']:.2f}x; "
          f"device {a0['device_ms']:.4f} ms); "
          f"prefill {pf['ms']:.4f} ms vs the general route "
          f"{pf['general_ms']:.4f} ms ({pf['general_ms'] / pf['ms']:.2f}x); "
          f"shares of bound {a0['bound_ms'] / a0['ms']:.4f} (attn0), "
          f"{pf['bound_ms'] / pf['ms']:.4f} (prefill)  [{card}]", flush=True)
    for tag in ("decode", "prefill", "verify"):
        r = records[f"indexer_scores[{tag}]"]
        print(f"  indexer {tag}: tc {r['ms']:.4f} ms (device "
              f"{r['device_ms']:.4f}) vs general {r['general_ms']:.4f} ms "
              f"(device {r['general_device_ms']:.4f}): "
              f"{r['general_device_ms'] / r['device_ms']:.2f}x in device "
              f"time; share of bound {r['bound_ms'] / r['device_ms']:.4f} "
              f"({r['bound_by']})  [{card}]", flush=True)
    for qname, d in records["gather_rows_dequant"]["detail"].items():
        print(f"  gather_rows_dequant[{qname}]: kernel {d['ms']:.4f} ms "
              f"(device {d['device_ms']:.4f}), plain {d['plain_ms']:.4f} ms; "
              f"the same rows' payload alone by gather_rows "
              f"{d['payload_ms']:.4f} ms (device "
              f"{d['payload_device_ms']:.4f}); wrapper host "
              f"{d['host_us']:.2f} us ({d['host_us_uncached']:.2f} with a "
              f"UVA lookup each call)  [{card}]", flush=True)
    for qname, d in records["gather_rows_dequant[prefill]"]["detail"].items():
        print(f"  gather_rows_dequant[prefill, {qname}]: staged "
              f"{d['ms']:.4f} ms (device {d['device_ms']:.4f}), direct "
              f"route on the same ids {d['direct_ms']:.4f} ms, plain (device "
              f"copy of the tier) {d['plain_ms']:.4f} ms  [{card}]",
              flush=True)
    # 4. small input against the CPU plain path (fp32: the general routes)
    for k in ("launches_tc", "launches_general"):
        setattr(sops.partial_attend, k, 0)
        setattr(iops.indexer_scores, k, 0)
    err = check_small(torch, dev)
    print(f"small: smoke config fp32 card vs CPU, max logit diff {err:.3g}; "
          f"sparse-MLA launches: general "
          f"{sops.partial_attend.launches_general}, tc "
          f"{sops.partial_attend.launches_tc}; indexer launches: general "
          f"{iops.indexer_scores.launches_general}, tc "
          f"{iops.indexer_scores.launches_tc}", flush=True)
    require(sops.partial_attend.launches_general > 0
            and sops.partial_attend.launches_tc == 0,
            "small: fp32 must take the general sparse-MLA route")
    require(iops.indexer_scores.launches_general > 0
            and iops.indexer_scores.launches_tc == 0,
            "small: fp32 must take the general indexer route")
    # 5. serve (bf16 tier), 6. quant serve (int8 tier), 7. graft: each
    #    path runs with every count set to 0 just before it and read just
    #    after; a kernel's "launches" is the count of the path it carries
    kernels = {"gather_rows": gops.gather_rows,
               "gather_rows_dequant": gops.gather_rows_dequant,
               "gather_rows_raw": gops.gather_rows_raw,
               "gather_pages": gops.gather_pages,
               "gather_pages_dequant": gops.gather_pages_dequant,
               "put_pages": gops.put_pages,
               "scatter_rows": gops.scatter_rows,
               "indexer_scores": iops.indexer_scores,
               "sparse_mla_partial": sops.partial_attend,
               "sparse_mla_merge": sops.merge_splits}
    # the per-route counts of the sparse-MLA and indexer wrappers and the
    # row gathers beside their totals
    routes = {"sparse_mla_tc": (sops.partial_attend, "launches_tc"),
              "sparse_mla_general": (sops.partial_attend, "launches_general"),
              "indexer_tc": (iops.indexer_scores, "launches_tc"),
              "indexer_general": (iops.indexer_scores, "launches_general")}
    for name in ("gather_rows", "gather_rows_dequant"):
        for r in ("direct", "staged"):
            routes[f"{name}_{r}"] = (kernels[name], f"launches_{r}")

    # the per-shape counts, each wrapper's own: the indexer's by query
    # count Q, the sparse-MLA partial's by (Q, rows per query K)
    shape_counts = {"indexer_by_q": iops.indexer_scores.launches_by_q,
                    "sparse_mla_by_shape":
                        sops.partial_attend.launches_by_shape}

    def counted(fn):
        for k in kernels.values():
            k.launches = 0
        for k, attr in routes.values():
            setattr(k, attr, 0)
        for d in shape_counts.values():
            d.clear()
        out = fn()
        torch.cuda.synchronize()
        n = {name: k.launches for name, k in kernels.items()}
        n.update({name: getattr(k, attr)
                  for name, (k, attr) in routes.items()})
        n.update({name: dict(sorted(d.items()))
                  for name, d in shape_counts.items()})
        return out, n

    def serve_shapes(counts, a, phase):
        """The fixed-batch serve's launches per shape, against what its
        arguments give: per layer, one indexer call and one partial per
        prefill chunk; per warmup window and decode round one indexer
        call, Attn0 over the K selected rows and Attn1 over the fetched
        ones, K rows in the warmup (max_miss_ratio 1: the attn0 shape)
        and the envelope at decode."""
        cfg = serve.config_from_args(a)
        L = cfg.num_layers
        W = min(cfg.ess.warmup_windows, a.prompt_len - 1)
        chunks = -(-(a.prompt_len - W) // a.prefill_chunk)
        rounds = a.new_tokens - 1
        return check_shapes(counts, cfg, {
            "indexer_scores[decode]": L * (W + rounds),
            "indexer_scores[prefill]": L * chunks,
            "sparse_mla_partial[attn0]": L * (W + rounds) + L * W,
            "sparse_mla_partial[attn1]": L * rounds,
            "sparse_mla_partial[prefill]": L * chunks}, phase)

    def require_launched(counts, names, phase):
        for name in names:
            require(counts[name] > 0,
                    f"{name} was not launched by the {phase} run")

    def require_gather_routes(counts, name, a, phase):
        """The prefill's tier fetch (one per layer and chunk) takes the
        staged route, the decode and warmup fetches the direct one."""
        cfg = serve.config_from_args(a)
        W = min(cfg.ess.warmup_windows, a.prompt_len - 1)
        prefill = cfg.num_layers * -(-(a.prompt_len - W) // a.prefill_chunk)
        staged, direct = counts[f"{name}_staged"], counts[f"{name}_direct"]
        require(staged == prefill and direct > 0
                and staged + direct == counts[name],
                f"the {phase} run's {name} routes: {staged} staged (the "
                f"prefill's {prefill} expected), {direct} direct")

    args = serve.build_parser().parse_args(SERVE_ARGS)
    print("serve: deepseek-v32-exp-ess at full width; cuts: num_layers "
          "61 -> 4 (3 dense + 1 MoE), mtp_depth 1 -> 0", flush=True)
    torch.cuda.reset_peak_memory_stats()
    out, n = counted(lambda: serve.run(args))
    res = out["result"]
    print(f"serve: {serve.report(out)}  [{card}]", flush=True)
    print(f"serve: init {out['init_s']:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, launches "
          + ", ".join(f"{k} {v}" for k, v in n.items()), flush=True)
    require(res.tokens.shape == (args.requests, args.new_tokens),
            f"tokens {res.tokens.shape}")
    require(res.logits_finite, "non-finite logits")
    require_launched(n, ("gather_rows", "scatter_rows", "indexer_scores",
                         "sparse_mla_partial", "sparse_mla_merge"), "serve")
    require_tc_only(n, "serve")
    serve_shapes(n, args, "serve")
    require_gather_routes(n, "gather_rows", args, "serve")
    require(res.misses.sum() > 0, "decode rounds read nothing from the tier")
    require(res.evicted > 0, "the pool never evicted")
    params, bf16_tokens = out["params"], res.tokens
    del out, res

    # 6. the same serve with an int8 host tier, on the same weights
    qargs = serve.build_parser().parse_args(
        SERVE_ARGS + ["--host-cache-dtype", "int8"])
    torch.cuda.reset_peak_memory_stats()
    out, n = counted(lambda: serve.run(qargs, params=params))
    res = out["result"]
    agree = int((res.tokens == bf16_tokens).sum())
    print(f"quant serve: {serve.report(out)}  [{card}]", flush=True)
    print(f"quant serve: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB, greedy "
          f"tokens equal to the bf16 run {agree}/{res.tokens.size} (for "
          f"information), launches "
          + ", ".join(f"{k} {v}" for k, v in n.items()), flush=True)
    require(res.logits_finite, "quant serve: non-finite logits")
    require(res.misses.sum() > 0, "quant serve: no tier reads")
    require(res.evicted > 0, "quant serve: the pool never evicted")
    require_launched(n, ("gather_rows_dequant", "scatter_rows",
                         "indexer_scores", "sparse_mla_partial",
                         "sparse_mla_merge"), "quant serve")
    require_tc_only(n, "quant serve")
    serve_shapes(n, qargs, "quant serve")
    require_gather_routes(n, "gather_rows_dequant", qargs, "quant serve")
    require(n["gather_rows"] == 0, "quant serve read the tier unquantized")
    del out, res

    # 7. graft a batch-1 donor prefill into slot 2 of a fresh 4-slot cache
    for tier in ("bf16", "int8"):
        gr, n = check_graft(torch, dev, serve, params, tier, counted)
        page_kernel = "gather_pages" if tier == "bf16" \
            else "gather_pages_dequant"
        records[page_kernel]["launches"] = n[page_kernel]
        print(f"graft {tier}: {gr}  [{card}]", flush=True)
        require_launched(n, (page_kernel, "scatter_rows"), f"graft {tier}")

    # 7b. the monolithic model (the generic path) on the serve's prompts
    t0 = time.perf_counter()
    monolithic_phase(torch, dev, serve, params, args, card, counted, records)
    print(f"monolithic phase: {time.perf_counter() - t0:.1f} s", flush=True)

    # 8-13. the serve sessions, audited, and the cluster
    session_phases(torch, dev, serve, params, args, qargs, records, counted,
                   card)
    # 15. the GQA family and DeepSeek-V3 on the generic path, with the
    #     serve's weights freed first
    del params
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    print(f"archs: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
          f"allocated from the earlier phases", flush=True)
    t0 = time.perf_counter()
    archs_phase(torch, dev, args, card, counted, records)
    print(f"archs phase: {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    # 16. training: T1 qwen3-0.6b, T2 DeepSeek-V3.2's DSA mask on the
    #     indexer kernel, T3 the smokes card vs CPU, the loop's resume
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    train_phase(torch, dev, card, counted, records)
    print(f"train phase: {time.perf_counter() - t0:.1f} s  [{card}]",
          flush=True)
    # 14. the serve example mirrors and the train mirror
    mirrors_phase(card)
    # 17. repro_torch.distributed on the card (a world of one), the ESS
    #     decode under a sharding context
    gc.collect()
    torch.cuda.empty_cache()
    sharding_phase(torch, dev, serve, args, card, counted)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s from start to "
          f"the result", flush=True)
    print(card)
    require(all("launches" in r for r in records.values()),
            "kernels without a main-path launch count: "
            + ", ".join(r["name"] for r in records.values()
                        if "launches" not in r))
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "device_ms", "library_device_ms", "general_ms",
            "general_device_ms", "copy_ms", "direct_ms", "distinct_rows",
            "top2048_overlap", "launches_session_e", "launches_session_f",
            "route_b_ms", "pack_shape_ms", "pack_shape_device_ms",
            "pack_shape_bound_ms", "pack_shape_copy_ms", "staged_ms",
            "staged_device_ms", "direct_device_ms", "sort_ms",
            "launches_monolithic", "launches_long")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-rank"]:
        sys.exit(shard_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                 sys.argv[4]))
    sys.exit(main())
