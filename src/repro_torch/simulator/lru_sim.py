"""Empirical LRU pool simulation over locality traces — produces the
paper's miss-count figures (4, 5, 8, 9) from first principles.

A numpy LRU (timestamp array, identical semantics to
``repro_torch.core.lru_pool``) replays Top-K traces; misses per step are
counted with/without LRU-Warmup at any Sparse-Memory-Ratio / context length.

The port's own copy of ``repro.simulator.lru_sim``: numpy only, no device.
"""

from __future__ import annotations

import numpy as np

from repro_torch.simulator.locality import make_trace


class NumpyLRU:
    def __init__(self, pool_entries: int, context: int):
        self.P = pool_entries
        self.slot_of = np.full(context, -1, np.int64)
        self.ids = np.full(pool_entries, -1, np.int64)
        self.last = np.full(pool_entries, -1, np.int64)
        self.step = 0

    def access(self, req: np.ndarray) -> int:
        """Touch the requested set; LRU-admit misses; return miss count."""
        slots = self.slot_of[req]
        hit = slots >= 0
        self.last[slots[hit]] = self.step
        miss_ids = req[~hit]
        n = miss_ids.size
        if n:
            evict = np.argpartition(self.last, n - 1)[:n]
            old = self.ids[evict]
            self.slot_of[old[old >= 0]] = -1
            self.ids[evict] = miss_ids
            self.slot_of[miss_ids] = evict
            self.last[evict] = self.step
        self.step += 1
        return int(n)


def run_lru(trace: np.ndarray, ratio: float, context: int,
            warmup_windows: int = 0) -> np.ndarray:
    """trace [T, K]; first ``warmup_windows`` rows preheat the pool (not
    counted).  Returns misses per counted step."""
    K = trace.shape[1]
    P = max(int(ratio * context), K)
    lru = NumpyLRU(P, context)
    for w in range(warmup_windows):
        lru.access(trace[w])
    out = []
    for t in range(warmup_windows, len(trace)):
        out.append(lru.access(trace[t]))
    return np.asarray(out)


def miss_profile(context: int, ratio: float, layers: int = 61,
                 steps: int = 96, warmup: bool = True, seed: int = 0
                 ) -> np.ndarray:
    """Average steady misses per layer (Figure 5/8)."""
    W = 32 if warmup else 0
    prof = []
    for l in range(layers):
        tr = make_trace(steps + W, context, layer=l, seed=seed)
        m = run_lru(tr, ratio, context, warmup_windows=W)
        prof.append(m[steps // 4:].mean())     # steady window
    return np.asarray(prof)


def early_miss_curve(context: int, ratio: float, layer: int = 8,
                     steps: int = 64, warmup: bool = True, mtp: int = 1,
                     seed: int = 3) -> np.ndarray:
    """Misses per decode step from step 0 (Figure 4)."""
    W = 32 if warmup else 0
    tr = make_trace(steps * mtp + W, context, layer=layer, seed=seed)
    m = run_lru(tr, ratio, context, warmup_windows=W)
    if mtp > 1:
        m = m[:steps * mtp].reshape(steps, mtp).sum(1)
    return m[:steps]
