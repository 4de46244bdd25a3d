"""Layer-wise overlap strategy selection (paper section 3.3, Figures 7
and 8; the port's own numpy copy of ``repro.core.policy``).

The paper's rule: a layer's expected cache-miss count, stable across
context lengths (Figure 8) and so obtainable by offline profiling,
decides whether DA hides the miss fetch or DBA's split indexer is needed:

    DA  exposed = max(0, t_fetch(miss) - t_attn0 - t_preattn)
    DBA exposed = max(0, t_fetch(miss) - t_attn0 - t_preattn
                       - 0.5 * t_indexer) + t_split_overhead

A layer takes DBA when its exposed time plus overhead is lower.  The
resulting plan (one mode per layer) is what ``ess_decode``'s
``layerwise_policy`` takes under ``overlap="layerwise"``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class OverlapCosts:
    """Per-layer decode timings (seconds) from offline profiling."""
    t_attn0: float          # sparse attention over pool hits
    t_preattn: float        # q projections etc. (independent of the fetch)
    t_indexer: float        # the whole indexer (scales with context)
    t_split_overhead: float  # DBA's batch-split loss
    fetch_bw: float         # effective host-to-device bytes/s
    block_bytes: int        # bytes fetched per miss


def exposed_da(c: OverlapCosts, miss: float) -> float:
    t_fetch = miss * c.block_bytes / c.fetch_bw
    return max(0.0, t_fetch - c.t_attn0 - c.t_preattn)


def exposed_dba(c: OverlapCosts, miss: float) -> float:
    t_fetch = miss * c.block_bytes / c.fetch_bw
    hidden = c.t_attn0 + c.t_preattn + 0.5 * c.t_indexer
    return max(0.0, t_fetch - hidden) + c.t_split_overhead


def dba_threshold(c: OverlapCosts, max_miss: int = 4096) -> int:
    """Smallest miss count (in steps of 8) at which DBA beats DA;
    ``max_miss + 1`` if it never does."""
    for m in range(0, max_miss + 1, 8):
        if exposed_dba(c, m) < exposed_da(c, m):
            return m
    return max_miss + 1


def choose_layerwise(miss_profile: np.ndarray, costs: OverlapCosts
                     ) -> list[str]:
    """miss_profile [L] (expected misses per layer) -> a mode per layer."""
    thr = dba_threshold(costs)
    return ["dba" if m >= thr else "da" for m in np.asarray(miss_profile)]
