"""Paper experiment reproductions (one function per table/figure).

Every function returns plain python structures;
``examples/simulate_paper_torch.py`` prints them, and
``tests/test_torch_simulator.py`` holds them to the reference's to the bit.

The port's own copy of ``repro.simulator.experiments``: numpy only, no device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from repro_torch.simulator import locality, lru_sim
from repro_torch.simulator.costmodel import (ServeConfig, layer_costs,
                                             max_feasible_batch,
                                             weights_bytes_per_gpu)
from repro_torch.simulator.hardware import H800_EP32, HardwareProfile
from repro_torch.simulator.pipeline import (layer_time, otps,
                                            throughput_node)

PAPER_TABLE2 = [
    # (mtp, accept, context, bs, ratio, offload, tbo, thr, otps)
    (2, 1.7, 32768, 52, 1.00, False, True, 9647.71, 23.19),
    (2, 1.7, 32768, 64, 0.82, True, True, 10693.31, 20.89),
    (2, 1.7, 32768, 96, 0.48, True, True, 13155.98, 17.13),
    (2, 1.7, 32768, 128, 0.31, True, True, 15620.14, 15.25),
    (2, 1.7, 32768, 160, 0.21, True, True, 16347.88, 12.77),
    (4, 2.8, 32768, 52, 1.00, False, True, 12168.02, 29.25),
    (4, 2.8, 32768, 64, 0.82, True, True, 13656.66, 26.67),
    (4, 2.8, 32768, 96, 0.48, True, True, 15814.07, 20.59),
    (4, 2.8, 32768, 128, 0.31, True, True, 17746.10, 17.33),
    (4, 2.8, 32768, 160, 0.21, True, True, 17601.03, 13.75),
    (4, 3.4, 32768, 52, 1.00, False, True, 14775.45, 35.52),
    (4, 3.4, 32768, 64, 0.82, True, True, 16583.08, 32.39),
    (4, 3.4, 32768, 96, 0.48, True, True, 19202.80, 25.00),
    (4, 3.4, 32768, 128, 0.31, True, True, 21548.83, 21.04),
    (4, 3.4, 32768, 160, 0.21, True, True, 21372.68, 16.70),
    (2, 1.7, 131072, 13, 1.00, False, False, 3669.19, 23.19),
    (2, 1.7, 131072, 40, 0.20, True, False, 6925.06, 21.64),
    (2, 1.7, 131072, 54, 0.10, True, False, 8169.60, 18.91),
]


def _sc(mtp, acc, ctx, bs, ratio, offload, tbo) -> ServeConfig:
    return ServeConfig(batch_per_gpu=bs, context=ctx, mtp=mtp,
                       accept_ratio=acc, sparse_memory_ratio=ratio,
                       offload=offload, two_batch_overlap=tbo,
                       overlap="layerwise")


def table2(hw: HardwareProfile = H800_EP32) -> list[dict[str, Any]]:
    """Throughput/OTPS for every paper row + our simulation + deviation."""
    out = []
    for (mtp, acc, ctx, bs, ratio, off, tbo, pthr, potps) in PAPER_TABLE2:
        sc = _sc(mtp, acc, ctx, bs, ratio, off, tbo)
        thr = throughput_node(hw, sc)
        ot = otps(hw, sc)
        out.append(dict(mtp=mtp, accept=acc, context=ctx, batch=bs,
                        ratio=ratio, offload=off,
                        sim_throughput=round(thr, 2), paper_throughput=pthr,
                        sim_otps=round(ot, 2), paper_otps=potps,
                        dev_pct=round(100 * (thr / pthr - 1), 1)))
    return out


def headline_improvements(hw: HardwareProfile = H800_EP32) -> dict[str, float]:
    """The abstract's two numbers: +69.4 % @32K and +123 % @128K."""
    b32 = throughput_node(hw, _sc(2, 1.7, 32768, 52, 1.0, False, True))
    e32 = throughput_node(hw, _sc(2, 1.7, 32768, 160, 0.21, True, True))
    b128 = throughput_node(hw, _sc(2, 1.7, 131072, 13, 1.0, False, False))
    e128 = throughput_node(hw, _sc(2, 1.7, 131072, 54, 0.10, True, False))
    return {"improvement_32k_pct": 100 * (e32 / b32 - 1),
            "paper_32k_pct": 69.4,
            "improvement_128k_pct": 100 * (e128 / b128 - 1),
            "paper_128k_pct": 123.0}


def fig1_throughput_vs_batch(hw: HardwareProfile = H800_EP32,
                             ctx: int = 32768) -> list[dict[str, Any]]:
    """Figure 1: throughput vs batch; GPU memory caps the baseline at ~52."""
    rows = []
    sc0 = _sc(2, 1.7, ctx, 52, 1.0, False, True)
    cap = max_feasible_batch(hw, sc0)
    for bs in [8, 16, 24, 32, 40, 52, 64, 80, 96, 112, 128, 144, 160]:
        sc = _sc(2, 1.7, ctx, bs, 1.0, False, True)
        feasible = bs <= cap
        rows.append(dict(batch=bs, feasible_on_gpu=feasible,
                         throughput=round(throughput_node(hw, sc), 2)))
    return rows


def fig2_similarity(ctx_list=(8192, 32768, 131072), layers=(0, 8, 24, 48),
                    steps: int = 64) -> list[dict[str, Any]]:
    """Figure 2: intra-layer similarity across context lengths."""
    out = []
    for ctx in ctx_list:
        for l in layers:
            tr = locality.make_trace(steps, ctx, layer=l, seed=7)
            sim = locality.similarity_of_trace(tr)
            out.append(dict(context=ctx, layer=l,
                            similarity_mean=round(float(sim.mean()), 4),
                            similarity_p10=round(float(np.percentile(sim, 10)), 4)))
    return out


def fig4_warmup(ctx: int = 32768, ratio: float = 0.2,
                steps: int = 48) -> dict[str, list[float]]:
    """Figure 4: early-decode miss count, before/after LRU-Warmup (MTP=1)."""
    cold = lru_sim.early_miss_curve(ctx, ratio, warmup=False, steps=steps)
    warm = lru_sim.early_miss_curve(ctx, ratio, warmup=True, steps=steps)
    return {"before_warmup": cold.tolist(), "after_warmup": warm.tolist()}


def fig5_miss_by_layer(ctx: int = 32768,
                       ratios=(0.1, 0.2, 0.4, 0.6)) -> list[dict[str, Any]]:
    """Figure 5: per-layer miss count across Sparse Memory Ratios."""
    out = []
    for r in ratios:
        prof = lru_sim.miss_profile(ctx, r, layers=61, steps=48)
        out.append(dict(ratio=r, miss_min=round(float(prof.min()), 2),
                        miss_max=round(float(prof.max()), 2),
                        miss_mean=round(float(prof.mean()), 2)))
    return out


def fig7_overlap_comparison(hw: HardwareProfile = H800_EP32
                            ) -> list[dict[str, Any]]:
    """Figure 7: per-layer time of the three overlap strategies vs miss
    count (paper setting: 128K, BS=160, MTP=2, TBO on, PCIe 37 GB/s)."""
    sc = ServeConfig(batch_per_gpu=160, context=131072, mtp=2,
                     offload=True, two_batch_overlap=True)
    out = []
    for miss in [0, 32, 64, 128, 256, 512, 1024, 2048]:
        c = layer_costs(hw, sc, moe_layer=True, miss_per_seq=float(miss))
        out.append(dict(miss=miss,
                        none_ms=round(1e3 * layer_time(c, "none"), 4),
                        da_ms=round(1e3 * layer_time(c, "da"), 4),
                        dba_ms=round(1e3 * layer_time(c, "dba"), 4)))
    return out


def fig8_9_miss_vs_context(ratios=(0.1, 0.2, 0.3, 0.4),
                           ctxs=(8192, 32768, 65536, 131072)
                           ) -> list[dict[str, Any]]:
    """Figures 8/9: miss behaviour across context lengths (MTP=2 r=0.2 for
    the layer consistency; ratio sweep for scalability)."""
    out = []
    for ctx in ctxs:
        for r in ratios:
            prof = lru_sim.miss_profile(ctx, r, layers=16, steps=32)
            out.append(dict(context=ctx, ratio=r,
                            miss_mean=round(float(prof.mean()), 2)))
    return out


def flashtrans_comparison(hw: HardwareProfile = H800_EP32,
                          miss: float = 256.0) -> dict[str, float]:
    """§3.1: effective-bandwidth impact — naive per-block copies vs
    FlashTrans-grade coalesced transfers, as per-layer fetch time."""
    sc_fast = ServeConfig(batch_per_gpu=160, offload=True,
                          use_flashtrans=True, avg_miss_per_seq=miss)
    sc_slow = dataclasses.replace(sc_fast, use_flashtrans=False)
    cf = layer_costs(hw, sc_fast, moe_layer=True, miss_per_seq=miss)
    cs = layer_costs(hw, sc_slow, moe_layer=True, miss_per_seq=miss)
    return {"flashtrans_fetch_ms": 1e3 * cf.t_fetch,
            "naive_fetch_ms": 1e3 * cs.t_fetch,
            "speedup": cs.t_fetch / max(cf.t_fetch, 1e-12)}


def v5e_projection() -> list[dict[str, Any]]:
    """ESS on the deployment target (TPU v5e pod, 256 chips, EP=256).

    v5e's 16 GB HBM makes the paper's §2.1 memory wall *harsher* than on
    80 GB H800s, so ESS buys more: the same machinery projects +87 % @32K
    and +128 % @128K decode throughput per pod."""
    from repro_torch.simulator.costmodel import cache_bytes_per_seq
    from repro_torch.simulator.hardware import TPU_V5E
    out = []
    for ctx, tbo in [(32768, True), (131072, False)]:
        free = TPU_V5E.hbm_bytes - 671e9 / 256 - 2e9
        cap_b = max(1, int(free / (cache_bytes_per_seq(ctx, 1.0, False)
                                   * 0.43)))
        cap_e = max(1, int(free / (cache_bytes_per_seq(ctx, 0.25, True)
                                   * 0.43)))

        def thr(bs, ratio, off):
            sc = ServeConfig(batch_per_gpu=bs, sparse_memory_ratio=ratio,
                             offload=off, two_batch_overlap=tbo, context=ctx,
                             overlap="layerwise", ep_size=256,
                             gpus_per_node=256)
            return throughput_node(TPU_V5E, sc)

        b = thr(cap_b, 1.0, False)
        e = thr(cap_e, 0.25, True)
        out.append(dict(context=ctx, batch_base=cap_b, batch_ess=cap_e,
                        thr_base=round(b, 1), thr_ess=round(e, 1),
                        improvement_pct=round(100 * (e / b - 1), 1)))
    return out


def memory_analysis(hw: HardwareProfile = H800_EP32) -> dict[str, Any]:
    """§2.1: weights/cache memory accounting + feasible-batch ceilings."""
    out = {}
    for ctx in (32768, 131072):
        for ratio, off in [(1.0, False), (0.3, True), (0.2, True), (0.1, True)]:
            sc = ServeConfig(batch_per_gpu=1, context=ctx,
                             sparse_memory_ratio=ratio, offload=off)
            out[f"ctx{ctx}_ratio{ratio}"] = max_feasible_batch(hw, sc)
    out["weights_gb_per_gpu"] = round(weights_bytes_per_gpu(
        ServeConfig()) / 1e9, 2)
    return out
