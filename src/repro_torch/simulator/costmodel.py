"""Analytic op-level cost model for DeepSeek-V3.2-Exp decode (paper §4.1):
the port's own copy of ``repro.simulator.costmodel``, numpy only.

Every term is physical (FLOPs / bytes over datasheet rates with an
MFU-saturation curve); the only fitted quantities are the two MFU-curve
parameters, calibrated against the paper's own Table 2 baseline row
(BS=52 → 9,647 tok/s/node) and one scaling row.  Timings are *per decode
round per GPU* with the paper's Table 1 system (TP=1, EP=32): attention and
caches are data-parallel (B sequences resident per GPU), experts are
expert-parallel.

All byte counts use the paper's fp8 serving layout: latent entry 656 B
(576 dims + scales), indexer entry 132 B (≈16.8 % of cache bytes).
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.simulator.hardware import HardwareProfile, MFUCurve

# DeepSeek-V3.2-Exp constants (arXiv:2412.19437 + paper)
D_MODEL = 7168
N_LAYERS = 61
N_DENSE = 3                 # first 3 layers dense
N_HEADS = 128
Q_LORA = 1536
KV_LORA = 512
QK_NOPE = 128
QK_ROPE = 64
V_HEAD = 128
D_FF_DENSE = 18432
D_EXPERT = 2048
N_EXPERTS = 256
TOPK_EXP = 8
N_SHARED = 1
VOCAB = 129280
IDX_HEADS = 64
IDX_DIM = 128
TOPK_DSA = 2048

LATENT_BYTES = 656          # paper §2.2
LATENT_Q8_BYTES = 578       # quantized host tier: 576 int8 + 2 B f16 scale
IDX_BYTES = 132             # 16.8 % of (656+132)
WEIGHT_BYTES = 1            # fp8 serving weights
ACT_BYTES = 2               # bf16 activations


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    batch_per_gpu: int = 52
    context: int = 32768
    mtp: int = 2                     # draft depth; q_len = mtp + 1
    accept_ratio: float = 1.7        # emitted tokens / round / sequence
    ep_size: int = 32
    gpus_per_node: int = 8
    sparse_memory_ratio: float = 1.0 # 1.0 = all cache on GPU (baseline)
    offload: bool = False            # ESS on/off
    use_flashtrans: bool = True
    overlap: str = "da"              # none | da | dba | layerwise
    two_batch_overlap: bool = True
    avg_miss_per_seq: float | None = None   # override (else from locality model)
    warmup: bool = True
    # paged host tier (repro_torch.cache.latent_cache): page-granular
    # transfers + page-granular host reservations.  False keeps the calibrated
    # FlashTrans row-fragment baseline (Table-2 anchors unchanged).
    paged_host: bool = False
    host_page_rows: int = 64
    # async-offload pipeline (repro_torch.core.transfer): the previous
    # round's indexer scores drive a speculative H2D stage, so
    # ``prefetch_hit_rate`` of each round's misses arrive pre-staged and
    # only the residual misses pay a synchronous fetch.  The staged traffic still crosses
    # PCIe — it is exposed only when its link time exceeds the round's
    # compute (modeled in simulate_step).  False keeps the calibrated
    # synchronous-fetch model (Table-2 anchors unchanged).
    async_offload: bool = False
    prefetch_hit_rate: float = 0.9
    # host-tier storage bytes per latent row.  The calibrated default is
    # the paper's 656 B fp8 serving layout (Table-2 anchors unchanged);
    # the quantized tier (repro_torch.distributed.compression) stores
    # 576 int8 dims + a 2 B f16 scale = 578 B, shrinking the host
    # reservation *and* every PCIe transfer by the same factor.  Device
    # HBM terms (attention reads, device cache ceiling) keep
    # LATENT_BYTES — the LRU pool stays bf16.
    cache_bytes_per_row: int = LATENT_BYTES

    @property
    def q_len(self) -> int:
        return self.mtp + 1


def active_params() -> float:
    """~37 B active params/token (dense + shared + top-8 experts + MLA)."""
    mla = (D_MODEL * Q_LORA + Q_LORA * N_HEADS * (QK_NOPE + QK_ROPE)
           + D_MODEL * KV_LORA + D_MODEL * QK_ROPE
           + KV_LORA * N_HEADS * (QK_NOPE + V_HEAD)
           + N_HEADS * V_HEAD * D_MODEL)
    dense_ffn = 3 * D_MODEL * D_FF_DENSE
    moe_ffn = 3 * D_MODEL * D_EXPERT * (TOPK_EXP + N_SHARED)
    idx = D_MODEL * (IDX_HEADS * IDX_DIM + IDX_DIM + IDX_HEADS)
    per_moe_layer = mla + moe_ffn + idx
    per_dense_layer = mla + dense_ffn + idx
    return (N_DENSE * per_dense_layer
            + (N_LAYERS - N_DENSE) * per_moe_layer
            + 2 * VOCAB * D_MODEL)


# ---------------------------------------------------------------------------
# Paged host-tier transfer + reservation model
# ---------------------------------------------------------------------------

# PCIe payload headroom over FlashTrans's measured 656-byte-fragment rate:
# the paper's 37 GB/s folds a per-fragment descriptor cost; whole-page
# fragments amortize it toward the link payload limit (~64/37 for PCIe5;
# 1.6 is the conservative figure used here for every profile).
PAGE_LINK_HEADROOM = 1.6


@dataclasses.dataclass(frozen=True)
class PagedTransferModel:
    """Scatter-gather transfer cost at page granularity.

    ``t = bytes / link_bw + fragments * frag_overhead``: the per-fragment
    descriptor overhead is *derived* from the profile's measured
    row-fragment bandwidth (``1/bw_meas = 1/link + ovh/656``), so the model
    reduces exactly to FlashTrans when every fragment is one 656 B row and
    approaches the link payload limit when fragments are whole pages.
    """
    page_rows: int
    link_h2d_bw: float
    link_d2h_bw: float
    h2d_frag_overhead_s: float
    d2h_frag_overhead_s: float
    row_bytes: int = LATENT_BYTES

    def h2d_time(self, rows: float, fragments: float) -> float:
        return (rows * self.row_bytes / self.link_h2d_bw
                + fragments * self.h2d_frag_overhead_s)

    def d2h_time(self, rows: float, fragments: float) -> float:
        return (rows * self.row_bytes / self.link_d2h_bw
                + fragments * self.d2h_frag_overhead_s)


def paged_transfer_model(hw: HardwareProfile, page_rows: int = 64,
                         row_bytes: int = LATENT_BYTES
                         ) -> PagedTransferModel:
    link_h2d = hw.h2d_bw * PAGE_LINK_HEADROOM
    link_d2h = hw.d2h_bw * PAGE_LINK_HEADROOM
    # the per-fragment descriptor overhead is a property of the link, not
    # the payload encoding: derive it from the measured 656 B-row rate
    # regardless of what this tier stores per row
    ovh_h2d = LATENT_BYTES * (1.0 / hw.h2d_bw - 1.0 / link_h2d)
    ovh_d2h = LATENT_BYTES * (1.0 / hw.d2h_bw - 1.0 / link_d2h)
    return PagedTransferModel(page_rows, link_h2d, link_d2h,
                              ovh_h2d, ovh_d2h, row_bytes)


def host_bytes_per_seq(sc: ServeConfig, avg_fill: float = 0.43) -> float:
    """Host-tier bytes one admitted sequence pins across the layer stack.

    Dense layout reserves ``context`` rows per slot up front; the paged
    layout maps pages as the sequence grows, so the pin tracks the actual
    mean fill (rounded up to whole pages — the only fragmentation)."""
    rows = float(sc.context)
    if sc.paged_host:
        R = sc.host_page_rows
        rows = math.ceil(avg_fill * sc.context / R) * R
    return N_LAYERS * rows * sc.cache_bytes_per_row


def max_host_admission_batch(hw: HardwareProfile, sc: ServeConfig,
                             avg_fill: float = 0.43,
                             reserve_frac: float = 0.05) -> int:
    """Host-memory admission ceiling: sequences admittable by free-page
    count (paged) vs dense per-slot reservations — the serve loop's gate."""
    usable = hw.host_mem_bytes * (1.0 - reserve_frac)
    return max(1, int(usable // host_bytes_per_seq(sc, avg_fill)))


# ---------------------------------------------------------------------------
# Inter-node migration model (PD-disaggregated handoff)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InterNodeModel:
    """Prefill→decode migration link (the PD handoff's wire).

    One migration moves a finished prompt's whole latent state at page
    granularity — per layer, the prompt's latent pages in the host tier's
    *storage* dtype (the quantized int8/fp8 page format doubles as the
    wire format, no dequant/requant round-trip) plus the indexer-key
    rows.  ``t = latency + bytes / bandwidth``: a single fabric message
    per handoff (the packet is one contiguous pack), so latency is paid
    once, not per page."""
    bandwidth: float         # bytes/s, usable point-to-point fabric
    latency_s: float         # per-packet (RDMA rendezvous + descriptor)
    row_bytes: int = LATENT_BYTES

    def packet_bytes(self, rows: float, num_layers: int = N_LAYERS
                     ) -> float:
        """Wire bytes of one migration: latent payload (+ per-row scales,
        folded into ``row_bytes``) and indexer keys across the stack."""
        return num_layers * rows * (self.row_bytes + IDX_BYTES)

    def transfer_time(self, rows: float, num_layers: int = N_LAYERS
                      ) -> float:
        return self.latency_s + self.packet_bytes(rows, num_layers) \
            / self.bandwidth


def internode_model(hw: HardwareProfile,
                    row_bytes: int = LATENT_BYTES) -> InterNodeModel:
    """The profile's scale-out fabric as a migration link.  The same
    per-GPU usable EP-fabric bandwidth carries handoffs (migrations and
    all-to-alls share the NICs); a2a latency stands in for the RDMA
    per-message cost."""
    return InterNodeModel(bandwidth=hw.fabric_bw, latency_s=hw.a2a_latency,
                          row_bytes=row_bytes)


def pd_migration_time_per_seq(hw: HardwareProfile, sc: ServeConfig,
                              avg_fill: float = 0.43) -> float:
    """Per-sequence handoff cost in a PD-disaggregated cluster: the
    prompt's rows (mean fill of the context, rounded up to whole pages
    when paged) cross the inter-node link once, in the host tier's
    storage dtype."""
    rows = avg_fill * sc.context
    if sc.paged_host:
        R = sc.host_page_rows
        rows = math.ceil(rows / R) * R
    return internode_model(hw, sc.cache_bytes_per_row).transfer_time(rows)


@dataclasses.dataclass
class LayerCosts:
    """Per-layer, per-GPU, per-decode-round timings (seconds)."""
    t_preattn: float        # q down/up-proj, rope, o-proj
    t_indexer: float        # full indexer scoring + top-k
    t_attn: float           # sparse MLA over top-2048
    t_attn0_frac: float     # fraction of t_attn independent of the fetch
    t_ffn: float            # routed+shared experts (incl. weight streaming)
    t_a2a: float            # EP dispatch+combine
    t_fetch: float          # H2D miss fetch
    t_writeback: float      # D2H new-latent writeback
    t_dba_overhead: float   # indexer batch-split loss


def _gemm_time(hw: HardwareProfile, rows: float, flops: float,
               weight_bytes: float) -> float:
    """max(compute @ MFU(rows), weight streaming) + launch."""
    eff = hw.mfu(rows)
    t_c = flops / (hw.peak_flops * max(eff, 1e-3))
    t_m = weight_bytes / hw.hbm_bw
    return max(t_c, t_m) + hw.kernel_launch


def layer_costs(hw: HardwareProfile, sc: ServeConfig, *, moe_layer: bool,
                miss_per_seq: float) -> LayerCosts:
    B = sc.batch_per_gpu
    q = sc.q_len
    rows = B * q                                  # GEMM rows per round
    S = sc.context

    # --- PreAttn: q projections + output proj (paper §3.3 PreAttn set) ----
    pre_flops = 2 * rows * (D_MODEL * Q_LORA
                            + Q_LORA * N_HEADS * (QK_NOPE + QK_ROPE)
                            + KV_LORA * N_HEADS * QK_NOPE    # absorb W_uk
                            + KV_LORA * N_HEADS * V_HEAD     # absorb W_uv
                            + N_HEADS * V_HEAD * D_MODEL
                            + D_MODEL * (KV_LORA + QK_ROPE))
    pre_w = WEIGHT_BYTES * (D_MODEL * Q_LORA
                            + Q_LORA * N_HEADS * (QK_NOPE + QK_ROPE)
                            + KV_LORA * N_HEADS * (QK_NOPE + V_HEAD)
                            + N_HEADS * V_HEAD * D_MODEL
                            + D_MODEL * (KV_LORA + QK_ROPE))
    t_preattn = _gemm_time(hw, rows, pre_flops, pre_w)

    # --- Indexer: reads the whole Indexer-Cache, scores, top-k ------------
    idx_flops = 2.0 * rows * S * IDX_HEADS * IDX_DIM
    idx_bytes = B * S * IDX_BYTES                 # cache resident per GPU
    # long-context scoring GEMMs run near peak (S-wide contraction)
    t_indexer = max(idx_flops / (hw.peak_flops * 0.75),
                    idx_bytes / hw.hbm_bw) + hw.kernel_launch

    # --- Sparse MLA over top-K latents ------------------------------------
    K = min(TOPK_DSA, S)
    attn_flops = 2.0 * rows * N_HEADS * K * ((KV_LORA + QK_ROPE) + KV_LORA)
    attn_bytes = B * q * K * LATENT_BYTES
    t_attn = max(attn_flops / (hw.peak_flops * 0.60),
                 attn_bytes / hw.hbm_bw) + hw.kernel_launch
    hit_frac = 1.0 - miss_per_seq / K if sc.offload else 1.0
    t_attn0_frac = max(0.0, min(1.0, hit_frac))

    # --- FFN ---------------------------------------------------------------
    if moe_layer:
        experts_per_gpu = N_EXPERTS / sc.ep_size
        tokens_total = rows * sc.ep_size          # DP over EP group
        routed_rows = tokens_total * TOPK_EXP / N_EXPERTS  # rows per expert
        ffn_flops = (2 * 3 * rows * D_MODEL * D_EXPERT * TOPK_EXP   # routed
                     + 2 * 3 * rows * D_MODEL * D_EXPERT * N_SHARED)
        ffn_w = WEIGHT_BYTES * 3 * D_MODEL * D_EXPERT * (experts_per_gpu
                                                         + N_SHARED)
        t_ffn = _gemm_time(hw, routed_rows, ffn_flops, ffn_w)
        # EP all-to-all: fp8 dispatch + bf16 combine per (token, expert)
        a2a_bytes = rows * TOPK_EXP * D_MODEL * (1 + ACT_BYTES)
        t_a2a = a2a_bytes / hw.fabric_bw + hw.a2a_latency
    else:
        ffn_flops = 2 * 3 * rows * D_MODEL * D_FF_DENSE
        ffn_w = WEIGHT_BYTES * 3 * D_MODEL * D_FF_DENSE
        t_ffn = _gemm_time(hw, rows, ffn_flops, ffn_w)
        t_a2a = 0.0

    # --- Offload traffic ----------------------------------------------------
    if sc.offload:
        if sc.paged_host and sc.use_flashtrans:
            pm = paged_transfer_model(hw, sc.host_page_rows,
                                      sc.cache_bytes_per_row)
            # fetched misses are top-k scattered: one fragment per miss,
            # bounded by the pages a context spans
            frags = B * min(miss_per_seq,
                            math.ceil(sc.context / pm.page_rows))
            t_fetch = pm.h2d_time(B * miss_per_seq, frags)
            # writeback rows are consecutive: whole-page fragments
            wb_frags = B * math.ceil(q / pm.page_rows)
            t_writeback = pm.d2h_time(B * q, wb_frags)
        else:
            bw_h2d = hw.h2d_bw if sc.use_flashtrans else hw.h2d_naive_bw
            bw_d2h = hw.d2h_bw if sc.use_flashtrans else hw.d2h_naive_bw
            t_fetch = B * miss_per_seq * sc.cache_bytes_per_row / bw_h2d
            t_writeback = B * q * sc.cache_bytes_per_row / bw_d2h
    else:
        t_fetch = 0.0
        t_writeback = 0.0

    t_dba_overhead = 0.15 * t_indexer / 2 + 2 * hw.kernel_launch

    return LayerCosts(t_preattn, t_indexer, t_attn, t_attn0_frac, t_ffn,
                      t_a2a, t_fetch, t_writeback, t_dba_overhead)


def lm_head_time(hw: HardwareProfile, sc: ServeConfig) -> float:
    rows = sc.batch_per_gpu * sc.q_len
    flops = 2 * rows * D_MODEL * VOCAB
    return _gemm_time(hw, rows, flops, WEIGHT_BYTES * D_MODEL * VOCAB)


def weights_bytes_per_gpu(sc: ServeConfig) -> float:
    mla_idx = (D_MODEL * Q_LORA + Q_LORA * N_HEADS * (QK_NOPE + QK_ROPE)
               + D_MODEL * (KV_LORA + QK_ROPE)
               + KV_LORA * N_HEADS * (QK_NOPE + V_HEAD)
               + N_HEADS * V_HEAD * D_MODEL
               + D_MODEL * (IDX_HEADS * IDX_DIM + IDX_DIM + IDX_HEADS))
    dense = 3 * D_MODEL * D_FF_DENSE
    moe = 3 * D_MODEL * D_EXPERT * (N_EXPERTS / sc.ep_size + N_SHARED)
    total = (N_LAYERS * mla_idx + N_DENSE * dense
             + (N_LAYERS - N_DENSE) * moe + 2 * VOCAB * D_MODEL)
    return total * WEIGHT_BYTES


def cache_bytes_per_seq(context: int, sparse_ratio: float,
                        offload: bool) -> float:
    """Device-resident cache bytes per sequence per layer-stack."""
    latent_dev = context * (sparse_ratio if offload else 1.0) * LATENT_BYTES
    idx_dev = context * IDX_BYTES            # indexer cache never offloaded
    return N_LAYERS * (latent_dev + idx_dev)


def max_feasible_batch(hw: HardwareProfile, sc: ServeConfig,
                       activation_reserve: float = 4e9,
                       avg_fill: float = 0.43) -> int:
    """GPU-memory batch ceiling (paper §2.1).  ``avg_fill`` is the mean
    context occupancy across the continuous batch — inferred from the
    paper's own ceiling (52 sequences @32K on 80 GB with ~41 GB of weights
    implies ~43 % average fill; full-fill would cap at ~20)."""
    free = hw.hbm_bytes - weights_bytes_per_gpu(sc) - activation_reserve
    per_seq = cache_bytes_per_seq(sc.context, sc.sparse_memory_ratio,
                                  sc.offload) * avg_fill
    return max(1, int(free // per_seq))


def calibrate(hw: HardwareProfile, target_base: float = 9647.71,
              target_ess: float = 16347.88) -> HardwareProfile:
    """Fit the two MFU-curve params to the paper's Table 2 anchor rows
    (MTP=2, 32K: BS=52 baseline and BS=160 ratio-0.21 ESS row).

    This implements the paper's methodology: the simulator is anchored on
    measured metadata — here the published measurements themselves."""
    # imported at call: pipeline imports this module
    from repro_torch.simulator.pipeline import simulate_step

    def thr(hwx, bs, ratio, offload, miss):
        scx = ServeConfig(batch_per_gpu=bs, sparse_memory_ratio=ratio,
                          offload=offload, avg_miss_per_seq=miss)
        t = simulate_step(hwx, scx)
        return scx.gpus_per_node * bs * scx.accept_ratio / t

    best = None
    import numpy as np
    for eff_max in np.linspace(0.3, 0.9, 25):
        for rows_half in np.linspace(100, 3000, 60):
            hwx = dataclasses.replace(hw, mfu=MFUCurve(eff_max, rows_half))
            e1 = thr(hwx, 52, 1.0, False, 0.0) / target_base - 1.0
            e2 = thr(hwx, 160, 0.21, True, 128.0) / target_ess - 1.0
            err = e1 * e1 + e2 * e2
            if best is None or err < best[0]:
                best = (err, eff_max, rows_half)
    return dataclasses.replace(hw, mfu=MFUCurve(best[1], best[2]))
