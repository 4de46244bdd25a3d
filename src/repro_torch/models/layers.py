"""Common layers (counterpart of ``repro.models.layers``): rmsnorm,
layernorm, soft capping, rotary embeddings (half-split and interleaved, M-RoPE), the gated
and plain MLPs and their activations, embed / unembed.

Where the reference multiplies an array by a Python constant, JAX first
rounds the constant to the array's dtype (a weak type); :func:`const`
does the same, so a bf16 product rounds once, as XLA's does."""

from __future__ import annotations

import torch

from repro_torch.models.params import ParamDef


def rmsnorm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6,
            zero_centered: bool = True) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    scale = (1.0 + w.float()) if zero_centered else w.float()
    return (xf * scale).to(dt)


def layernorm_def(dim: int, dtype=torch.float32) -> dict:
    """Scale ``w`` (ones) and bias ``b`` (zeros) of :func:`layernorm`."""
    return {"w": ParamDef((dim,), dtype, "ones"),
            "b": ParamDef((dim,), dtype, "zeros")}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) / sqrt(var + eps) * w + b`` over the last axis, in
    fp32 (the variance of the centred values, as ``jnp.var``), returned in
    x's dtype."""
    dt = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p["w"].float() + p["b"].float()).to(dt)


def const(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (as JAX casts a Python scalar)."""
    # a host tensor made from a Python constant: nothing waits for the card
    return float(torch.tensor(v, dtype=dtype))  # esslint: disable=ESS002


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None or cap <= 0:
        return x
    return torch.tanh(x / cap) * cap


def proj(x: torch.Tensor, w: torch.Tensor, n: int = 1) -> torch.Tensor:
    """``x``'s last ``n`` axes contracted with ``w``'s first ``n`` (the
    reference's projection einsums ``"bsd,dhk->bshk"``,
    ``"bqhk,hkd->bqd"``) as one ``aten.mm``: a product without batch
    dims, the kind remat ``"dots"`` keeps.  ``einsum`` would run it as a
    ``bmm`` over a batch of 1, which at batch 1 looks the same as
    attention's scores."""
    k = 1
    for s in w.shape[:n]:
        k *= s
    out = x.reshape(-1, k) @ w.reshape(k, -1)
    return out.view(*x.shape[:x.dim() - n], *w.shape[n:])


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched) in fp32: the products of the stored operands,
    summed in fp32 (the reference's ``preferred_element_type=f32``).  On
    the card two bf16 operands keep cuBLAS's fp32 accumulator as the
    output (``out_dtype``); otherwise the operands widen exactly."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def rope_freqs(head_dim: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies [head_dim//2] (fp32), computed in fp64 and
    rounded once: XLA's fp32 ``theta ** (i / half)`` and reciprocal give
    these values, where torch's fp32 ``pow`` is an ulp off in places (and
    an ulp of a frequency is many of the angle at position 8K)."""
    half = head_dim // 2
    e = torch.arange(half, dtype=torch.float32, device=device) / half
    return (1.0 / (theta ** e.double())).float()


def _cos_sin(ang: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """cos, sin of fp32 angles, rounded from fp64 (nearer XLA's than
    torch's fp32 kernels: 1 % of values an ulp apart against 5 %)."""
    a = ang.double()
    return torch.cos(a).float(), torch.sin(a).float()


def rope_cos_sin(positions: torch.Tensor, head_dim: int,
                 theta: float = 10000.0) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] int -> cos, sin [..., head_dim//2] fp32."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    return _cos_sin(positions.float()[..., None] * freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """x [..., H, D]; cos/sin broadcast to [..., 1, D/2].  Half-split
    pairs (i, i + D/2) or, ``interleaved``, pairs (2i, 2i + 1)."""
    dt = x.dtype
    xf = x.float()
    if interleaved:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape).to(dt)
    half = x.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)


def mrope_cos_sin(positions: torch.Tensor, head_dim: int,
                  sections: tuple[int, ...], theta: float = 10000.0
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Multimodal RoPE (Qwen2-VL): positions [..., 3] (temporal, height,
    width) -> cos, sin [..., head_dim//2].  ``sections`` counts the
    frequency pairs of each component (summing to head_dim//2); a text
    token's equal (t, h, w) makes it plain RoPE."""
    half = head_dim // 2
    if sum(sections) != half:
        raise ValueError(f"mrope sections {sections} do not sum to {half}")
    freqs = rope_freqs(head_dim, theta, positions.device)
    comp = torch.cat([torch.full((s,), i, dtype=torch.long,
                                 device=positions.device)
                      for i, s in enumerate(sections)])
    pos = positions.float().gather(
        -1, comp.expand(*positions.shape[:-1], half))      # [..., half]
    return _cos_sin(pos * freqs)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` rounded as the reference's ``jax.nn.silu``: XLA
    expands the logistic to ``1 / (1 + exp(-x))`` and rounds each step to
    the input's dtype (bf16: four roundings where ``F.silu`` makes one, up
    to an ulp apart)."""
    return x * torch.reciprocal(torch.exp(-x) + 1.0)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (its default, the tanh approximation) with the
    reference's roundings: constants in the input's dtype, each step
    rounded to it."""
    c, k = const(0.7978845608028654, x.dtype), const(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    """The reference's ``_act``: its "gelu" is ``jax.nn.gelu``'s default,
    the tanh approximation, as "gelu_tanh" is."""
    if name == "silu":
        return silu(x)
    if name in ("gelu", "gelu_tanh"):
        return gelu_tanh(x)
    if name == "relu":
        return torch.relu(x)
    raise ValueError(name)


def mlp(p: dict, x: torch.Tensor, act_name: str = "silu") -> torch.Tensor:
    """The gated MLP (``wi_gate``, ``wi_up``) or the plain one (``wi``)."""
    if "wi_gate" in p:
        h = act(act_name, x @ p["wi_gate"]) * (x @ p["wi_up"])
    else:
        h = act(act_name, x @ p["wi"])
    return h @ p["wo"]


def embed(w: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return w[tokens]


def unembed(w: torch.Tensor, x: torch.Tensor,
            cap: float | None = None) -> torch.Tensor:
    """x [..., d] @ w[vocab, d]^T -> fp32 logits (fp32 accumulation),
    soft-capped at ``cap``.

    On the card a bf16 product keeps cuBLAS's fp32 accumulator as its
    output (``out_dtype``); on the CPU the operands widen exactly to fp32."""
    x2 = x.reshape(-1, x.shape[-1])
    if x.is_cuda and x.dtype != torch.float32:
        out = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        out = x2.float() @ w.float().t()
    return softcap(out.reshape(*x.shape[:-1], w.shape[0]), cap)
