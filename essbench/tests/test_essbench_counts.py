"""The FLOP and byte counts behind every ``mfu`` and ``*_roofline``, held to
hand-worked shapes, and the trace's interval arithmetic."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(REPO)]

from essbench import trace as T  # noqa: E402
from essbench.roofline import counts as K  # noqa: E402


def conf(name):
    return json.loads((REPO / "essbench/configs" / f"{name}.json")
                      .read_text())


V32, V3 = conf("dsv32-ess-4l"), conf("dsv3-4l")
# one layer's MLA projections, multiply-adds: W_dq, W_uq, W_uk absorbed,
# W_dkv, W_kr, W_uv absorbed, W_o
PROJ = (7168 * 1536 + 1536 * 128 * 192 + 128 * 128 * 512 + 7168 * 512
        + 7168 * 64 + 128 * 512 * 128 + 128 * 128 * 7168)
DENSE = 3 * 7168 * 18432
MOE = 7168 * 256 + (8 + 1) * 3 * 7168 * 2048
UNEMBED = 7168 * 129280


def test_projection_count_by_hand():
    assert PROJ == 187_105_280


def test_v32_token_flops_at_4k():
    attn = 128 * 2048 * (576 + 512)           # the top-2048 rows
    idx = 7168 * 64 * 128 + 7168 * 64 + 7168 * 128 + 64 * 128 * 4096
    want = 2 * (4 * (PROJ + attn + idx) + 3 * DENSE + MOE + UNEMBED)
    assert K.token_flops(V32, 4096) == want == 9_555_673_088


def test_v32_below_topk_attends_every_row_and_prefill_has_no_logits():
    attn = 128 * 1000 * 1088
    idx = 7168 * 64 * 128 + 7168 * 64 + 7168 * 128 + 64 * 128 * 1000
    want = 2 * (4 * (PROJ + attn + idx) + 3 * DENSE + MOE)
    assert K.token_flops(V32, 1000, logits=False) == want


def test_v3_attends_its_whole_context():
    attn = 128 * 8704 * 1088
    want = 2 * (4 * (PROJ + attn) + 3 * DENSE + MOE + UNEMBED)
    assert K.token_flops(V3, 8704) == want


def test_kernel_bytes_and_ops():
    b, o = K.sparse_mla(V32, 10_000)
    assert b == 2048 * 576 * 2 + 128 * 576 * 2 + 128 * 512 * 2
    assert o == 2 * 128 * 2048 * 1088
    b, o = K.sparse_mla(V3, 8704)
    assert b == 8704 * 1152 + 128 * 1152 + 128 * 1024
    b, o = K.indexer(V32, 1000)
    assert b == 1000 * 256 + 64 * 256 + 64 * 2 + 1000 * 4
    assert o == 2 * 64 * 128 * 1000
    assert K.tier_gather(10, 1152) == (10 * 1160, 10 * 1152)


def test_bound_takes_the_slowest_roof():
    assert K.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert K.bound_s(0, 989e12) == pytest.approx(1.0)
    assert K.bound_s(1.0, 0, 64e9) == pytest.approx(1.0)


def test_work_flops_sums_decode_and_prefill():
    work = [([100, 200], [(0, 3)])]
    want = K.token_flops(V32, 100) + K.token_flops(V32, 200) + sum(
        K.token_flops(V32, c, logits=False) for c in (1, 2, 3))
    assert K.work_flops(work, V32) == want


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7)]
    assert T.union_us(iv) == 4
    assert T.gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert T.gaps([], 1, 2) == [(1, 2)]


def test_kernel_time_by_name():
    data = {"kernels": [("sparse_mla_tc_kernel<...>", 0, 5),
                        ("nvjet_tst_256x8", 5, 9),
                        ("indexer_tc_kernel", 9, 10)]}
    assert T.kernel_s(data, T.SPARSE_MLA_NAMES) == pytest.approx(5e-6)
    assert T.kernel_s(data, T.GEMM_NAMES) == pytest.approx(4e-6)
    assert T.kernel_s(None, T.GEMM_NAMES) == 0.0
