"""Common layers (counterpart of ``repro.models.layers``): rmsnorm, rotary
embeddings, the gated MLP, embed / unembed."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if zero_centered else w.float()
    return (xf * scale).to(dt)


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (fp32)."""
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> cos, sin [..., head_dim//2] fp32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x [..., H, D] (half-split layout); cos/sin broadcast to
    [..., 1, D/2]."""
    dt = x.dtype
    xf = x.float()
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def mlp(p: dict, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    if act != "silu":
        raise NotImplementedError(f"activation {act!r} is not ported")
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


def embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return w[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ w[vocab, d]^T -> fp32 logits (fp32 accumulation).

    On the card a bf16 product keeps cuBLAS's fp32 accumulator as its
    output (``out_dtype``); on the CPU the operands widen exactly to fp32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float().t()
    return out.reshape(*x.shape[:-1], w.shape[0])
