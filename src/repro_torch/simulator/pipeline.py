"""Execution-pipeline reconstruction (paper §4.1): assembles per-layer op
timings into a decode-round time under the chosen overlap strategy, MTP and
Two-Batch Overlap — an event-level model of Figure 6's timelines.

Resources: one compute stream, one PCIe stream, one fabric (EP) stream per
GPU.  TBO interleaves two half-batches so one half's transfers/a2a overlap
the other half's compute (SGLang dual-stream semantics).

The port's own copy of ``repro.simulator.pipeline``: numpy only, no device.
"""

from __future__ import annotations

import dataclasses

from repro_torch.simulator.costmodel import (LayerCosts, N_DENSE,
                                             N_LAYERS, ServeConfig,
                                             layer_costs, lm_head_time)
from repro_torch.simulator.hardware import HardwareProfile


def layer_time(c: LayerCosts, overlap: str) -> float:
    """One layer's critical path (single batch stream), Figure 6 semantics."""
    serial_tail = c.t_ffn + c.t_a2a + c.t_writeback
    if overlap == "none":
        # Indexer -> fetch -> attention, fully serialized
        return (c.t_indexer + c.t_fetch + c.t_preattn + c.t_attn
                + serial_tail)
    t_attn0 = c.t_attn * c.t_attn0_frac
    t_attn1 = c.t_attn * (1.0 - c.t_attn0_frac)
    if overlap == "da":
        # fetch ∥ (PreAttn + Attn0); Attn1 waits for the fetch
        hidden = c.t_preattn + t_attn0
        exposed = max(0.0, c.t_fetch - hidden)
        return c.t_indexer + max(hidden, c.t_fetch) * 0 + hidden + exposed \
            + t_attn1 + serial_tail
    if overlap == "dba":
        # half the indexer also overlaps the fetch (batch-split indexer)
        hidden = c.t_preattn + t_attn0 + 0.5 * c.t_indexer
        exposed = max(0.0, c.t_fetch - hidden)
        return (0.5 * c.t_indexer + hidden + exposed + t_attn1
                + c.t_dba_overhead + serial_tail)
    raise ValueError(overlap)


def pick_overlap(hw: HardwareProfile, c: LayerCosts, sc: ServeConfig) -> str:
    """Layer-wise policy (paper §3.3): pick the strategy with the smaller
    modeled layer time — the offline-profiling decision."""
    return min(("da", "dba"), key=lambda o: layer_time(c, o))


def simulate_step(hw: HardwareProfile, sc: ServeConfig,
                  miss_by_layer: list[float] | None = None) -> float:
    """Seconds per decode round per GPU.

    With ``sc.async_offload`` the plan/compute/commit pipeline stages
    ``prefetch_hit_rate`` of each layer's misses one round ahead: the
    staged fraction leaves the layer critical path (only the residual
    misses pay a synchronous fetch), but its bytes still cross PCIe —
    the accumulated staged link time is exposed only when it exceeds
    the round's compute."""
    from repro_torch.simulator.locality import expected_miss_per_seq
    hr = sc.prefetch_hit_rate if (sc.offload and sc.async_offload) else 0.0
    pf_hidden = 0.0
    times = []
    for layer in range(N_LAYERS):
        if sc.avg_miss_per_seq is not None:
            miss = sc.avg_miss_per_seq
        elif miss_by_layer is not None:
            miss = miss_by_layer[layer]
        else:
            miss = expected_miss_per_seq(sc.context, sc.sparse_memory_ratio,
                                         layer=layer, warmed=sc.warmup) \
                if sc.offload else 0.0
        c = layer_costs(hw, sc, moe_layer=(layer >= N_DENSE),
                        miss_per_seq=miss)
        if hr > 0.0:
            pf_hidden += c.t_fetch * hr
            c = dataclasses.replace(c, t_fetch=c.t_fetch * (1.0 - hr))
        ov = sc.overlap
        if ov == "layerwise":
            ov = pick_overlap(hw, c, sc)
        if not sc.offload:
            ov = "none"  # no fetch to hide; layer_time none path w/ fetch=0
        times.append(layer_time(c, ov))
    t = sum(times) + lm_head_time(hw, sc)

    if sc.two_batch_overlap and sc.batch_per_gpu >= 16:
        # two half-batches: each half's comm hides under the other half's
        # compute; effectiveness bounded by the comm/compute ratio.
        half = dataclasses.replace(sc, batch_per_gpu=sc.batch_per_gpu // 2)
        comm = 0.0
        comp = 0.0
        for layer in range(N_LAYERS):
            miss = (sc.avg_miss_per_seq if sc.avg_miss_per_seq is not None
                    else (expected_miss_per_seq(sc.context,
                                                sc.sparse_memory_ratio,
                                                layer=layer,
                                                warmed=sc.warmup)
                          if sc.offload else 0.0))
            ch = layer_costs(hw, half, moe_layer=(layer >= N_DENSE),
                             miss_per_seq=miss)
            # the staged fraction leaves the TBO comm stream too: only
            # residual (synchronous) fetches compete with the a2a there
            comm += ch.t_a2a + ch.t_fetch * (1.0 - hr) + ch.t_writeback
            comp += ch.t_preattn + ch.t_indexer + ch.t_attn + ch.t_ffn
        comp += lm_head_time(hw, half)
        # steady state: each half's comm hides under the other half's
        # compute; exposed only when comm > comp.  Plus pipeline edges
        # (first comm burst / last compute drain).
        t_tbo = 2 * comp + 2 * max(0.0, comm - comp) + 0.02 * comm
        t = min(t, t_tbo)

    if hr > 0.0:
        # staged traffic of one round (≈ next round's hits, full batch)
        # rides the PCIe stream under the whole round's compute; exposed
        # only past the link's round-level headroom.
        t += max(0.0, pf_hidden - t)
    return t


def throughput_node(hw: HardwareProfile, sc: ServeConfig,
                    miss_by_layer: list[float] | None = None) -> float:
    """Output tokens/s per node (Table 2 metric)."""
    t = simulate_step(hw, sc, miss_by_layer)
    return sc.gpus_per_node * sc.batch_per_gpu * sc.accept_ratio / t


def otps(hw: HardwareProfile, sc: ServeConfig,
         miss_by_layer: list[float] | None = None) -> float:
    """Output tokens/s per sequence (Table 2 'OTPS')."""
    return sc.accept_ratio / simulate_step(hw, sc, miss_by_layer)
