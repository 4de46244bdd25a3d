"""The sparse-MLA tensor-core route's plain parts on the CPU: the split
merge against the unsplit partial, the K-split planner, the routing rule,
and the prefill's bf16 attend equal to its fp32 one bit for bit.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``).
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)
import numpy as np
import pytest
import torch

from repro_torch.kernels.sparse_mla import ops as sops
from repro_torch.kernels.sparse_mla import ref as sref

NEG = -2.0e38


def _inputs(seed, B=2, Q=2, H=4, D=40, K=50):
    rng = np.random.default_rng(seed)
    q = torch.as_tensor(rng.standard_normal((B, Q, H, D)), dtype=torch.float32)
    rows = torch.as_tensor(rng.standard_normal((B, Q, K, D)),
                           dtype=torch.float32)
    valid = torch.as_tensor(rng.random((B, Q, K)) < 0.8)
    return q, rows, valid


@pytest.mark.parametrize("nsplit", [1, 2, 5])
def test_split_merge_equals_unsplit_partial(nsplit):
    q, rows, valid = _inputs(0)
    K, rank = rows.shape[2], 32
    valid[:, :, :10] = False              # the first of 5 splits: all invalid
    valid[0, 1, 20:] = False              # query (0, 1): later splits invalid
    valid[1, 0] = False                   # query (1, 0): all invalid
    want = sref.sparse_mla_partial_ref(q, rows, valid, 0.2, rank)
    bounds = np.linspace(0, K, nsplit + 1).astype(int)
    parts = [sref.sparse_mla_partial_ref(q, rows[:, :, a:b], valid[:, :, a:b],
                                         0.2, rank)
             for a, b in zip(bounds[:-1], bounds[1:])]
    got = sops.merge_splits(*(torch.stack(t) for t in zip(*parts)))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    o, m, l = got
    assert torch.all(m[1, 0] == NEG)
    assert torch.all(l[1, 0] == 0) and torch.all(o[1, 0] == 0)


@pytest.mark.parametrize("bq,H,K", [(1024, 128, 2048), (1024, 128, 256),
                                    (256, 128, 2048), (66, 128, 2048)])
def test_plan_splits_prefill_is_one_split(bq, H, K):
    assert sops.plan_splits(bq, H, K, 132) == (1, -(-K // 64) * 64)


@pytest.mark.parametrize("n_sm", [132, 114])
@pytest.mark.parametrize("bq,H,K", [(4, 128, 2048), (4, 128, 256),
                                    (4, 128, 1), (4, 128, 65), (4, 64, 8224),
                                    (2, 128, 300), (4, 128, 2047),
                                    (1, 128, 64)])
def test_plan_splits_cover_every_row_once(n_sm, bq, H, K):
    nsplit, per = sops.plan_splits(bq, H, K, n_sm)
    assert per % 64 == 0 and nsplit >= 1
    seen = np.zeros(K, dtype=int)
    for s in range(nsplit):
        a, b = s * per, min(K, (s + 1) * per)
        assert b > a, f"split {s} is empty"
        seen[a:b] += 1
    assert np.all(seen == 1)
    ctas = bq * H // 64
    assert nsplit == 1 or nsplit * ctas <= n_sm


def test_plan_splits_fill_the_card_at_decode():
    # Attn0 of the serve cell: 8 CTAs, 32 tiles -> 8 splits of 4 tiles
    assert sops.plan_splits(4, 128, 2048, 132) == (8, 256)
    # Attn1: 4 tiles -> one split, no merge
    assert sops.plan_splits(4, 128, 256, 132) == (1, 256)
    # the warmup replay's Attn1 over 2048 fetched rows, as Attn0
    assert sops.plan_splits(4, 128, 2048, 114) == (8, 256)


@pytest.mark.parametrize("dt,H,D,rank,K,want", [
    (torch.bfloat16, 128, 576, 512, 2048, True),
    (torch.bfloat16, 64, 576, 512, 1, True),
    (torch.float32, 128, 576, 512, 2048, False),
    (torch.bfloat16, 96, 576, 512, 2048, False),
    (torch.bfloat16, 128, 576, 256, 2048, False),
    (torch.bfloat16, 4, 40, 32, 33, False),
    (torch.bfloat16, 128, 576, 512, 0, False),
])
def test_tc_route_rule(dt, H, D, rank, K, want):
    q = torch.zeros((1, 1, H, D), dtype=dt)
    rows = torch.zeros((1, K, D), dtype=dt)
    assert sops.tc_route(q, rows, rank) is want


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_query"])
def test_partial_attend_bf16_equals_its_fp32_bitwise(shared):
    """The prefill hands its bf16 q and rows to the attend as they are; on
    the CPU the plain version widens them itself, so the result is the
    same bits as the former call on their fp32 copies."""
    rng = np.random.default_rng(3)
    B, Q, H, D, K = 2, 3, 64, 576, 70
    q = torch.as_tensor(rng.standard_normal((B, Q, H, D)),
                        dtype=torch.float32).bfloat16()
    rshape = (B, K, D) if shared else (B, Q, K, D)
    rows = torch.as_tensor(rng.standard_normal(rshape),
                           dtype=torch.float32).bfloat16()
    valid = torch.as_tensor(rng.random(rshape[:-1]) < 0.8)
    got = sops.partial_attend(q, rows, valid, 0.07, 512)
    want = sops.partial_attend(q.float(), rows.float(), valid, 0.07, 512)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)
