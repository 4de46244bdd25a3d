"""Top-K access-pattern model with temporal locality (paper §2.2).

Two layers of modelling:

* ``make_trace`` — synthetic per-step Top-K index sets with controlled
  intra-layer similarity (Figure 2's 0.85–0.99 band): a Markov churn model
  where each step keeps a fraction of the previous set and redraws the rest
  from a recency-biased Zipf distribution (LongBench-V2-like reuse).
* ``expected_miss_per_seq`` — closed-form steady-state miss estimate used
  by the pipeline model, with per-layer churn heterogeneity matching
  Figure 5/8 (16.66–605 misses/step at ratio 0.2, consistent layer pattern
  across context lengths) and the small-pool thrashing blow-up of Figure 9.

The port's own copy of ``repro.simulator.locality``: numpy only, no device.
"""

from __future__ import annotations

import numpy as np

TOPK = 2048


def layer_churn(layer: int, n_layers: int = 61, lo: float = 0.008,
                hi: float = 0.40, seed: int = 1234) -> float:
    """Per-layer churn (1 - intra-layer similarity), fixed pseudo-random
    profile: heavy-churn layers cluster early-mid stack (Fig. 5/8 shape)."""
    rng = np.random.default_rng(seed)
    prof = np.exp(rng.uniform(np.log(lo), np.log(hi), size=n_layers))
    prof.sort()
    perm = np.random.default_rng(seed + 1).permutation(n_layers)
    return float(prof[perm[layer % n_layers]])


def expected_miss_per_seq(context: int, ratio: float, layer: int = 0,
                          warmed: bool = True, topk: int = TOPK) -> float:
    """Steady-state misses per sequence per decode step."""
    K = min(topk, context)
    P = max(int(ratio * context), K)
    S = max(context, K + 1)
    churn = layer_churn(layer)
    deficit = max(0.0, 1.0 - (P - K) / max(1, S - K))   # 0 when pool == S
    # Fig 9: misses stable for pools >= ~6.4K entries (P/K >= 3.2), sharp
    # thrashing blow-up below that (frequent swap-in/swap-out)
    thrash = 2.5 * max(0.0, 3.2 * K / P - 1.0) ** 2
    miss = K * churn * deficit * (1.0 + thrash)
    if not warmed:
        miss += K * 0.25                                # early-phase penalty
    return float(min(miss, K))


def make_trace(steps: int, context: int, layer: int = 0, topk: int = TOPK,
               seed: int = 0, zipf_a: float = 1.1,
               recency_frac: float = 0.25) -> np.ndarray:
    """[steps, K] Top-K id sets with Figure-2-like temporal locality."""
    K = min(topk, context)
    rng = np.random.default_rng(seed + 17 * layer)
    churn = layer_churn(layer)

    # popularity: Zipf over positions + recency boost
    ranks = rng.permutation(context)
    pop = 1.0 / (1 + ranks.astype(np.float64)) ** zipf_a
    recent = np.zeros(context)
    n_rec = max(1, int(recency_frac * context))
    recent[-n_rec:] = np.linspace(0, 2.0, n_rec)
    p = pop * np.exp(recent)
    p /= p.sum()

    cur = rng.choice(context, size=K, replace=False, p=p)
    out = np.empty((steps, K), np.int64)
    for t in range(steps):
        n_new = rng.binomial(K, churn)
        if n_new:
            keep = rng.choice(K, size=K - n_new, replace=False)
            kept = cur[keep]
            mask = np.ones(context, bool)
            mask[kept] = False
            cand = np.nonzero(mask)[0]
            pw = p[cand] / p[cand].sum()
            new = rng.choice(cand, size=n_new, replace=False, p=pw)
            cur = np.concatenate([kept, new])
        out[t] = np.sort(cur)
    return out


def similarity_of_trace(trace: np.ndarray) -> np.ndarray:
    """Empirical Eq.-1 similarity of a [T, K] trace."""
    sims = []
    for t in range(1, len(trace)):
        inter = np.intersect1d(trace[t - 1], trace[t]).size
        sims.append(inter / trace.shape[1])
    return np.asarray(sims)
