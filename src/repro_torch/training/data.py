"""Deterministic synthetic LM data (the port's own copy of
``repro.training.data``).

Batch ``i`` is a function of ``(seed, i, host_id)`` alone, drawn with the
reference's numpy generator in the reference's order, so both packages
make the same tokens and a resumed run replays the batches it would have
seen.  A host takes its ``global_batch / num_hosts`` rows.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    global_batch: int
    seq_len: int
    seed: int = 0
    # synthetic structure: zipf unigrams + copy spans (so loss can fall)
    zipf_a: float = 1.2
    copy_prob: float = 0.3


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


def make_batch(cfg: DataConfig, step: int, host_id: int = 0,
               num_hosts: int = 1, device="cpu") -> dict[str, torch.Tensor]:
    """Batch for ``step`` (this host's rows): ``{"inputs", "labels",
    "positions"}``, int64 tensors ``[b, seq_len]`` on ``device``; the
    labels are the inputs shifted by one token."""
    b_local = cfg.global_batch // num_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    probs = _zipf_probs(cfg.vocab_size, cfg.zipf_a)
    toks = rng.choice(cfg.vocab_size, size=(b_local, cfg.seq_len + 1),
                      p=probs).astype(np.int32)
    # copy spans: the second half repeats a window of the first half
    for i in range(b_local):
        if rng.random() < cfg.copy_prob:
            w = cfg.seq_len // 4
            src = rng.integers(0, cfg.seq_len // 2 - w)
            dst = rng.integers(cfg.seq_len // 2, cfg.seq_len + 1 - w)
            toks[i, dst:dst + w] = toks[i, src:src + w]
    t = torch.from_numpy(toks.astype(np.int64))
    pos = torch.arange(cfg.seq_len)[None].expand(b_local, cfg.seq_len)
    return {"inputs": t[:, :-1].contiguous().to(device),
            "labels": t[:, 1:].contiguous().to(device),
            "positions": pos.contiguous().to(device)}
