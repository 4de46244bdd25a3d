"""The traffic generators: the same seed gives the same traffic, and every
seed gives the same schedule (sizes, their order, arrivals): a seed changes
the data, not the amount of work."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
sys.path[0:0] = [str(REPO)]

from essbench.traffic import open_loop_chat as chat  # noqa: E402
from essbench.traffic import pd_closed_loop as pd  # noqa: E402


def params(cell):
    return json.loads((REPO / "essbench/workloads" / f"{cell}.json")
                      .read_text())["params"]


def rng(seed):
    return np.random.default_rng([seed, 1])


def test_stratified_spans_the_range():
    v = pd.stratified(256, 768, 64)
    assert v.min() >= 256 and v.max() <= 768 and len(set(v)) == 64
    assert abs(v.mean() - 512) < 1
    assert list(pd.stratified(16384, 32768, 4)) == [18432, 22528, 26624,
                                                    30720]


def test_pd_plan_per_seed():
    p = params("v32-pd-decode-32k")
    a = pd.plan(p, rng(2**31 + 5), 256, 129280)
    b = pd.plan(p, rng(2**31 + 5), 256, 129280)
    c = pd.plan(p, rng(17), 256, 129280)
    for k in ("lens", "ctx", "new", "greedy", "seeds"):
        assert np.array_equal(a[k], b[k])
    assert all(np.array_equal(x, y) for x, y in zip(a["prompts"],
                                                     b["prompts"]))
    assert not np.array_equal(a["prompts"][0][:64], c["prompts"][0][:64])
    # the same schedule for every seed
    for k in ("lens", "ctx", "new", "greedy"):
        assert np.array_equal(a[k], c[k])
    assert not np.array_equal(a["seeds"], c["seeds"])
    B = p["concurrency"]
    for blk in range(3):
        sl = slice(blk * B, (blk + 1) * B)
        assert sorted(a["new"][sl]) == sorted(pd.stratified(
            *p["new_tokens"], B))
    assert a["greedy"].mean() == 1 / p["greedy_every"]
    # each greedy block holds every context
    assert set(a["ctx"][a["greedy"]]) == set(range(p["contexts"]))
    assert all(len(x) == n for x, n in zip(a["prompts"], a["lens"]))


def test_chat_plan_per_seed():
    p = params("v32-chat-2k")
    a = chat.plan(p, rng(3), 300, 129280)
    b = chat.plan(p, rng(3), 300, 129280)
    c = chat.plan(p, rng(2**31 + 99), 300, 129280)
    assert np.array_equal(a["due"], b["due"]) and np.array_equal(
        a["due"], c["due"])
    assert np.array_equal(a["new"], b["new"])
    assert np.array_equal(a["new"], c["new"])
    assert list(map(len, a["prompts"])) == list(map(len, c["prompts"]))
    assert not np.array_equal(a["prompts"][0], c["prompts"][0])
    lens = np.array([len(x) for x in a["prompts"]])
    lo, hi = p["prompt_len"]
    assert lens.min() >= lo and lens.max() <= hi
    # log-uniform: the median is near the geometric mean of the range
    assert abs(np.median(lens) / np.sqrt(lo * hi) - 1) < 0.05
    # the mean gap is the rate's
    assert abs(np.diff(a["due"]).mean() * p["rate"] - 1) < 0.05
    assert a["due"][0] == 0 and np.all(np.diff(a["due"]) > 0)
