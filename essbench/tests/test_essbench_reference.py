"""The frozen reference against the port at smoke widths on the CPU (the
test imports both; the reference imports nothing of the port), and its
float8 control."""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[0:0] = [str(HERE.parents[1]), str(HERE)]

import smoke_cells as SC  # noqa: E402

from essbench import spec as S  # noqa: E402
from essbench import weights as W  # noqa: E402
from essbench.reference import deepseek as R  # noqa: E402

S_LEN = 40          # past the smoke indexer's top-8: the selection binds


def setup(conf, seed):
    torch.set_num_threads(1)
    conf = {**conf, "port": {**conf["port"], "param_dtype": "float32"}}
    cfg = S.arch_config(conf)
    w = W.draw(cfg, seed, torch.device("cpu"))
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, S_LEN))
    return conf, cfg, w, toks


@pytest.mark.parametrize("conf", [SC.SMOKE_V3, SC.SMOKE_V32],
                         ids=["v3", "v32"])
def test_reference_matches_the_port_at_fp32(conf):
    from repro_torch.models import transformer as T
    conf, cfg, w, toks = setup(conf, 2**31 + 3)
    pos = torch.arange(S_LEN)[None]
    port = T.forward(w, cfg, toks[None], pos, mode="prefill",
                     use_kernel=False).logits[0]
    ref = R.logits(w, R.forward_hidden(w, conf, toks))
    scale = ref.abs().max().item()
    assert (port - ref).abs().max().item() <= 1e-4 * scale
    assert torch.equal(port.argmax(-1), ref.argmax(-1))


def test_served_gaps_read_the_reference_and_the_control():
    conf, cfg, w, toks = setup(SC.SMOKE_V32, 5)
    prompt = toks[:24].numpy()
    # the reference's own greedy continuation: every served token its best
    seq = torch.as_tensor(prompt)
    for _ in range(8):
        nxt = R.logits(w, R.forward_hidden(w, conf, seq)[-1:]).argmax(-1)
        seq = torch.cat([seq, nxt])
    served = seq[24:]
    out = R.served_gaps(w, conf, prompt, served.numpy(), quant="fp8")
    assert out["gap"].shape == (len(served),)
    assert out["gap"].max() < 1e-5          # the same function, re-blocked
    assert out["control_gap"].max() > 0
    other = (served + 1) % cfg.vocab_size
    assert R.served_gaps(w, conf, prompt, other.numpy())["gap"].max() > 0


def test_topk_takes_the_lowest_index_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, 0.0, 3.0]])
    assert R.topk_lowest_index(x, 3).tolist() == [[1, 2, 4]]


def test_fp8_rounding_is_coarser_than_bf16():
    x = torch.randn(64, 256, generator=torch.Generator().manual_seed(0))
    e8 = (R.fp8_round(x, -1) - x).abs().mean()
    e16 = (x.bfloat16().float() - x).abs().mean()
    assert e8 > 4 * e16
