"""The indexer's tensor-core route, its plain parts on the CPU: the routing
rule, the grid plan (query groups and key spans) against brute force, and
the plain version (the one CPU path) against the Pallas kernel in
interpret mode on the masks the tile skip must honour.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``-k indexer``).  Plain version vs Pallas: both take the same fp32 values
and differ only in the order of the sums, so they agree to rtol 1e-5; atol
1e-4 covers cancellation in the 64-head sum of terms of magnitude ~10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.indexer.indexer import indexer_scores_kernel
from repro_torch.kernels.indexer import ops as iops

NEG = -2.0e38


@pytest.mark.parametrize("dt,Hi,Di,want", [
    (torch.bfloat16, 64, 128, True),
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 192, 128, True),
    (torch.bfloat16, 256, 128, True),
    (torch.float32, 64, 128, False),
    (torch.bfloat16, 96, 128, False),
    (torch.bfloat16, 320, 128, False),
    (torch.bfloat16, 64, 64, False),
    (torch.bfloat16, 2, 16, False),
])
def test_tc_route_rule(dt, Hi, Di, want):
    q = torch.zeros((1, 1, Hi, Di), dtype=dt)
    keys = torch.zeros((1, 5, Di), dtype=dt)
    assert iops.tc_route(q, keys) is want


def _cover(B, Q, S, Hi, n_sm):
    """Brute force over the plan's CTAs: how often each (b, q, tile) is
    computed, and the number of CTAs."""
    nq, per, nspans = iops.tc_plan(B, Q, S, Hi, n_sm)
    ntiles = -(-S // 64)
    seen = np.zeros((B, Q, ntiles), dtype=int)
    ctas = 0
    for b in range(B):
        for q0 in range(0, Q, nq):
            for y in range(nspans):
                t0, t1 = y * per, min(ntiles, (y + 1) * per)
                assert t1 > t0, f"span {y} is empty"
                seen[b, q0:q0 + nq, t0:t1] += 1
                ctas += 1
    return (nq, per, nspans), seen, ctas


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("B,Q,S,Hi", [
    (4, 1, 8224, 64), (4, 2, 8224, 64), (4, 256, 8224, 64),
    (4, 224, 8224, 64), (1, 1, 64, 64), (2, 3, 1000, 64), (3, 7, 1, 64),
    (4, 1, 8224, 128), (4, 5, 8224, 128), (2, 9, 300, 192),
    (1, 1, 200000, 64), (4, 256, 40, 256)])
def test_tc_plan_covers_every_pair_once(n_sm, B, Q, S, Hi):
    (nq, per, nspans), seen, ctas = _cover(B, Q, S, Hi, n_sm)
    assert np.all(seen == 1)
    assert nq in (1, 2, 4) and nq * Hi <= 256 and nq <= max(Q, 1)
    assert 1 <= per <= iops.MAX_SPAN_TILES
    groups = B * -(-Q // nq)
    min_spans = -(-(-(-S // 64)) // iops.MAX_SPAN_TILES)
    # key spans only where the groups alone leave the card idle, and then
    # about one CTA per SM
    if groups >= n_sm:
        assert nspans == min_spans
    else:
        assert ctas <= max(n_sm + groups - 1, groups * min_spans)


def test_tc_plan_at_the_serve_shapes():
    # decode: 4 CTAs alone -> 33 spans of 4 tiles (132 CTAs)
    assert iops.tc_plan(4, 1, 8224, 64, 132) == (1, 4, 33)
    assert iops.tc_plan(4, 2, 8224, 64, 132) == (2, 4, 33)
    # a prefill chunk: groups of 4 queries (N = 256), 256 CTAs, one span
    assert iops.tc_plan(4, 256, 8224, 64, 132) == (4, 129, 1)
    # the last, shorter chunk of the serve (224 queries)
    assert iops.tc_plan(4, 224, 8224, 64, 132) == (4, 129, 1)


def _pallas(q, w, keys, valid):
    """The reference's Pallas kernel (interpret mode) per (b, q) row, with a
    per-query mask [B,Q,S]."""
    f = jax.vmap(jax.vmap(
        lambda qq, ww, kk, vv: indexer_scores_kernel(qq, ww, kk, vv,
                                                     interpret=True),
        in_axes=(0, 0, None, 0)))
    return np.asarray(jax.jit(f)(jnp.asarray(q), jnp.asarray(w),
                                 jnp.asarray(keys), jnp.asarray(valid)))


@pytest.mark.parametrize("S", [1000, 130, 64])
def test_plain_matches_pallas_on_tile_skip_masks(S):
    """Holes of every size: random holes, a query with no valid key, whole
    64-key tiles invalid for every query of a group of 4 (the tiles the
    tensor-core kernel skips), a causal staircase, S not a multiple of
    64."""
    rng = np.random.default_rng(5)
    B, Q, Hi, Di = 2, 8, 64, 128
    q = rng.standard_normal((B, Q, Hi, Di), dtype=np.float32)
    w = rng.standard_normal((B, Q, Hi), dtype=np.float32)
    keys = rng.standard_normal((B, S, Di), dtype=np.float32)
    valid = rng.random((B, Q, S)) < 0.6
    valid[0, 3] = False                              # no valid key
    valid[0, 4:, :64] = False                        # tile 0 of group 1
    valid[1] = np.arange(S)[None] <= (S - Q + np.arange(Q))[:, None]
    want = _pallas(q, w, keys, valid)
    got = iops.indexer_scores(torch.from_numpy(q), torch.from_numpy(w),
                              torch.from_numpy(keys),
                              torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got == NEG, ~valid)
    np.testing.assert_array_equal(want == NEG, ~valid)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-5,
                               atol=1e-4)
    assert np.all(got[0, 3] == NEG)
