"""Token selection (counterpart of ``repro.serving.sampling``): greedy,
temperature, top-k and top-p, with the reference's per-request keys.

* :func:`sample` — host-driven: one row of logits and Python knobs (the
  ``do_warmup`` session's first token).
* :func:`sample_one` / :func:`sample_batch` — device-resident knobs (one
  slot's, or ``[B]`` tensors for the whole slot batch) so the draw runs
  inside a serve round and its CUDA graph.  Sentinels replace ``None``:
  ``top_k <= 0`` and ``top_p >= 1`` turn truncation off; a row with
  ``temperature == 0`` returns a draw the caller replaces with the greedy
  token.

Both follow the reference's arithmetic order: divide by the temperature,
threshold at the k-th largest value of a descending sort, softmax and
cumsum over the sorted logits for top-p, mask with ``-inf`` and take the
Gumbel argmax under ``fold_in(key(seed), index)``
(:mod:`repro_torch.serving.prng`, JAX's threefry bit for bit).  The masks
compare against values, so the two entry points emit the same token for
the same ``(seed, index, logits, knobs)``.  The top-p sort reuses the
top-k sort: masking values below the threshold keeps a descending row
descending, so it equals a second sort of the masked row.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.serving import prng


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """Index of the largest logit along the last axis (the first one among
    equal values, as ``jnp.argmax``), int64."""
    return logits.argmax(dim=-1)


def request_key(seed, index, device=None) -> torch.Tensor:
    """Per-emission key of one request, ``fold_in(key(seed), index)``:
    the same key for the same chain position, so a preempted request's
    re-run and the Q = 1 and speculative rounds draw the same tokens.
    ``seed`` and ``index`` are Python ints (a ``[2]`` key on ``device``)
    or integer tensors (``[..., 2]`` on their device)."""
    return prng.fold_in(prng.key(seed, device), index)


def _truncate(lg: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor
              ) -> torch.Tensor:
    """Top-k then top-p masking of ``lg [..., V]`` (already divided by the
    temperature) with per-row knobs ``[...]`` and their sentinels."""
    V = lg.shape[-1]
    neg = float("-inf")
    srt = lg.sort(dim=-1, descending=True).values
    # top-k: threshold at the k-th largest value
    use_k = ((top_k >= 1) & (top_k < V))[..., None]
    kth = srt.gather(-1, (top_k.long().clamp(1, V) - 1)[..., None])
    lg = torch.where(use_k & (lg < kth), neg, lg)
    srt = torch.where(use_k & (srt < kth), neg, srt)
    # top-p over the top-k-masked logits: softmax as jax.nn.softmax
    # (exp of the shifted row over its sum), then the cumulative mass
    e = torch.exp(srt - srt[..., :1])
    cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    tp = top_p.float()[..., None]
    cut_idx = (cum < tp).sum(dim=-1, keepdim=True).clamp_max(V - 1)
    cutoff = srt.gather(-1, cut_idx)
    return torch.where((tp < 1.0) & (lg < cutoff), neg, lg)


def sample_batch(seed: torch.Tensor, index: torch.Tensor,
                 logits: torch.Tensor, temperature: torch.Tensor,
                 top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """Per-slot draws: logits ``[B,V]``, every knob a ``[B]`` tensor on the
    logits' device.  Returns ``[B]`` int64; rows with ``temperature == 0``
    hold a draw the caller replaces with the greedy token."""
    t = temperature.float()
    lg = logits.float() / torch.where(t > 0.0, t, 1.0)[:, None]
    lg = _truncate(lg, top_k, top_p)
    return prng.categorical(request_key(seed, index), lg)


def sample_one(seed: torch.Tensor, index: torch.Tensor, logits: torch.Tensor,
               temperature: torch.Tensor, top_k: torch.Tensor,
               top_p: torch.Tensor) -> torch.Tensor:
    """One draw: logits ``[V]``, knobs as 0-d or ``[1]`` tensors (one
    slot's view of the state).  Returns a ``[1]`` int64 tensor."""
    def one(x):
        return x.reshape(1)
    return sample_batch(one(seed), one(index), logits.reshape(1, -1),
                        one(temperature), one(top_k), one(top_p))


def sample(key: torch.Tensor, logits: torch.Tensor, temperature: float = 1.0,
           top_k: Optional[int] = None, top_p: Optional[float] = None
           ) -> torch.Tensor:
    """One draw from ``logits [V]`` under ``key [2]`` with Python knobs
    (``temperature <= 0`` is greedy); a 0-d int64 tensor."""
    if temperature <= 0.0:
        return greedy(logits)
    dev, V = logits.device, logits.shape[-1]
    t = torch.full((1,), float(temperature), dtype=torch.float32,
                   device=dev)
    k = torch.full((1,), 0 if top_k is None or top_k >= V else int(top_k),
                   dtype=torch.int64, device=dev)
    p = torch.full((1,), 1.0 if top_p is None else float(top_p),
                   dtype=torch.float32, device=dev)
    lg = _truncate(logits.float().reshape(1, V) / t[:, None], k, p)
    return prng.categorical(key.to(dev), lg)[0]
