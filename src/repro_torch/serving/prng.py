"""JAX's threefry2x32 random numbers in torch, bit for bit.

The reference keys every sampled token by ``jax.random.fold_in(
jax.random.key(seed), index)`` and draws it with ``jax.random.categorical``
(the Gumbel-max trick).  This module computes the same keys, the same
random bits and the same uniforms as JAX's default PRNG (threefry2x32, with
the partitionable counter layout that ``jax_threefry_partitionable=True``
selects), so a sampled stream of the port equals the reference's:

* a **key** is an int64 tensor ``[..., 2]`` holding the two uint32 words;
* :func:`key` — ``jax.random.key(seed)`` for an int32 seed: ``(0, seed)``;
* :func:`fold_in` — ``jax.random.fold_in``: threefry of the counter pair
  ``(0, data)`` under the key;
* :func:`random_bits` — 32-bit words for a shape: threefry of each flat
  index's ``(hi, lo)`` 32-bit halves under the key, the two outputs xor-ed;
* :func:`uniform` / :func:`gumbel` / :func:`categorical` — ``_uniform``
  (23 mantissa bits under the exponent of 1.0, minus 1, scaled, floored
  at ``minval``), ``_gumbel`` in its default ``"low"`` mode
  (``-log(-log(u))``, one uniform per element) and the Gumbel argmax.

uint32 arithmetic runs in int64 masked to 32 bits (torch's uint32 covers
few ops).  Everything is torch ops on the keys' device, with no host value
in the loop, so it runs inside a CUDA graph.  Keys and bits are exact
integers; ``gumbel`` differs from XLA's only by the rounding of ``log``.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# float32 constants of _uniform / _gumbel
_TINY = float(np.finfo(np.float32).tiny)
_NMANT = 23


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs ``(x0, x1)``
    under the key ``(k0, k1)``: int64 tensors holding uint32 values,
    broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    x0, x1 = torch.broadcast_tensors(x0, x1)
    x0, x1 = x0.clone(), x1.clone()
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(_M32)
            x1 = _rotl(x1, r).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(_M32)
        x1.add_(ks[(i + 2) % 3]).add_(i + 1).bitwise_and_(_M32)
    return x0, x1


def key(seed, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for an int32 seed: a Python int (-> ``[2]``
    on ``device``) or an integer tensor (-> ``[..., 2]`` on its device).
    The high word of an int32 seed is 0; a negative seed keeps its two's
    complement low word."""
    if not isinstance(seed, torch.Tensor):
        k = torch.zeros((2,), dtype=torch.int64, device=device)
        k[1].fill_(int(seed) & _M32)              # a fill: no host copy
        return k
    lo = seed.long() & _M32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(k, data)``: ``data`` a Python int or an integer
    tensor broadcast against ``k[..., 0]``, taken modulo 2**32."""
    if isinstance(data, torch.Tensor):
        data = data.long() & _M32
    else:
        data = int(data) & _M32
    zero = torch.zeros_like(k[..., 0])
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], zero, zero + data)
    return torch.stack([y0, y1], dim=-1)


def random_bits(k: torch.Tensor, n: int) -> torch.Tensor:
    """32-bit random words ``[..., n]`` (int64 holding uint32) for the
    shape ``(n,)`` under each key of ``k [..., 2]`` — JAX's partitionable
    layout: flat index ``i`` hashes the counter pair ``(i >> 32, i & M)``,
    and the word is the two outputs xor-ed."""
    if n >= 1 << 32:
        raise ValueError(f"{n} words: the high counter word is not handled")
    lo = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(lo), lo)
    return y0.bitwise_xor_(y1)


def uniform(k: torch.Tensor, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, (n,), float32, minval, maxval)`` per key:
    fp32 ``[..., n]``, bit for bit."""
    bits = random_bits(k, n)
    fbits = (bits >> (32 - _NMANT)) | 0x3F800000        # < 2**31: fits i32
    floats = fbits.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    scale = float(hi - lo)                              # fp32 arithmetic
    return (floats * scale + float(lo)).clamp_min(float(lo))


def gumbel(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(k, (n,), float32)`` in its default ``"low"``
    mode: ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(k, n, _TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits)`` along the last axis: the
    argmax of Gumbel noise plus the logits (the first among equal values,
    as ``jnp.argmax``), int64 ``[...]``; ``k`` is ``[..., 2]`` against
    ``logits [..., V]``."""
    g = gumbel(k, logits.shape[-1])
    return (g + logits.float()).argmax(dim=-1)
