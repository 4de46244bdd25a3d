"""Mamba2 blocks (counterpart of ``repro.models.ssm``): the chunked SSD scan
(state-space duality) for train and prefill, the recurrent step for
decode, and the block around them (z / x / B / C / dt projections, the
depthwise causal convolution, the gated RMSNorm and the out projection).

No Pallas kernel lies on this path in the reference (XLA einsums), so the
port is plain torch on every device.  Each 3- and 4-operand einsum of
:func:`ssd_chunked` is written as batched products in a fixed order,
grouped by the ``ngroups`` B / C groups so that no step builds more than
one ``[b, nc, l, l, h]`` block.

The arithmetic follows the reference where the tests compare with it:
``_segsum`` masks with ``-inf`` (its ``exp`` is 0); the prefill's
convolution sums in fp32 and rounds to the activation dtype before
``silu``, the decode step's feeds ``silu`` the fp32 sum unrounded
(:func:`_conv_step`), so at bf16 the two paths round differently;
``dt_raw`` is an fp32 product; a length that is not a multiple of the
chunk is zero-padded (``a_dt`` included).  A decode step updates the
state in place.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef


def ssm_def(cfg: ArchConfig) -> dict:
    """One Mamba2 mixer's parameter definitions (the reference's keys)."""
    s, dt, d = cfg.ssm, cfg.param_dtype, cfg.d_model
    din, H, gn = s.d_inner(d), s.nheads(d), s.ngroups * s.state_dim
    return {
        "w_z": ParamDef((d, din), dt), "w_x": ParamDef((d, din), dt),
        "w_B": ParamDef((d, gn), dt), "w_C": ParamDef((d, gn), dt),
        "w_dt": ParamDef((d, H), dt),
        "dt_bias": ParamDef((H,), torch.float32, "zeros"),
        "A_log": ParamDef((H,), torch.float32, "zeros"),
        "D": ParamDef((H,), torch.float32, "ones"),
        "conv_x": ParamDef((s.conv_width, din), dt),
        "conv_B": ParamDef((s.conv_width, gn), dt),
        "conv_C": ParamDef((s.conv_width, gn), dt),
        "norm": ParamDef((din,), dt, "zeros"),
        "w_out": ParamDef((din, d), dt),
    }


class SSMState(NamedTuple):
    """Decode-time recurrent state of one layer (stacked ``[L, ...]`` in
    the model's cache)."""
    h: torch.Tensor          # [B, H, P, N] SSM state, fp32
    conv_x: torch.Tensor     # [B, W-1, din] the convolutions' last inputs
    conv_B: torch.Tensor     # [B, W-1, g*N]
    conv_C: torch.Tensor     # [B, W-1, g*N]


def init_state(cfg: ArchConfig, batch: int, device=None) -> SSMState:
    """Zeros, fp32 throughout (the reference's), on ``device`` (the card
    unless ``"cpu"``)."""
    s = cfg.ssm
    dev = resolve_device(device)
    din, H, W = s.d_inner(cfg.d_model), s.nheads(cfg.d_model), s.conv_width
    gn = s.ngroups * s.state_dim

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)
    return SSMState(z(batch, H, s.head_dim, s.state_dim), z(batch, W - 1, din),
                    z(batch, W - 1, gn), z(batch, W - 1, gn))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) +
    log1p(exp(-|x|))``."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B,S,C], w [W,C] -> [B,S,C] in x's dtype,
    the shifted products summed in fp32."""
    W, S = w.shape[0], x.shape[1]
    xp = torch.nn.functional.pad(x, (0, 0, W - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xp[:, i:i + S].float() * w[i].float()
    return out.to(x.dtype)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a [..., L] -> [..., L, L]: ``cs_i - cs_j`` (the sum of ``a_{j+1..i}``)
    on and below the diagonal, ``-inf`` above it."""
    n = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    mask = torch.ones((n, n), dtype=torch.bool, device=a.device).tril()
    return torch.where(mask, cs[..., :, None] - cs[..., None, :],
                       float("-inf"))


def ssd_chunked(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int, h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan.  x [b,s,h,p], a_dt [b,s,h] (``dt * A``, negative),
    B, C [b,s,g,n] (each group shared by ``h // g`` consecutive heads);
    ``s`` a multiple of ``chunk``.  Returns fp32 (y [b,s,h,p], the final
    state [b,h,p,n]).

    Within a chunk the quadratic form, across chunks the recurrence over
    each chunk's summary state (sequential over the ``s / chunk``
    chunks, as the reference's scan)."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep, nc, l = h // g, s // chunk, chunk
    xc = x.float().reshape(b, nc, l, h, p)
    ac = a_dt.float().reshape(b, nc, l, h).transpose(2, 3)   # [b,nc,h,l]
    Bg = B.float().reshape(b, nc, l, g, n).transpose(2, 3)   # [b,nc,g,l,n]
    Cg = C.float().reshape(b, nc, l, g, n).transpose(2, 3)

    # intra-chunk: (C . B) per group, times the decay block, times x
    cb = Cg @ Bg.transpose(-1, -2)                         # [b,nc,g,l,l]
    blk = (torch.exp(_segsum(ac)).view(b, nc, g, rep, l, l)
           * cb[:, :, :, None]).view(b, nc, h, l, l)
    del cb
    y_diag = blk @ xc.permute(0, 1, 3, 2, 4)               # [b,nc,h,l,p]
    del blk

    # each chunk's summary state: (x * decay to the chunk's end) . B
    a_cum = torch.cumsum(ac, dim=-1)                       # [b,nc,h,l]
    decay = torch.exp(a_cum[..., -1:] - a_cum).transpose(2, 3)
    xd = (xc * decay[..., None]).view(b, nc, l, g, rep, p).permute(
        0, 1, 3, 4, 5, 2).reshape(b * nc * g, rep * p, l)
    states = torch.bmm(xd, Bg.reshape(b * nc * g, l, n)).view(
        b, nc, h, p, n)

    # across chunks: the state entering each chunk
    chunk_decay = torch.exp(a_cum[..., -1])                # [b,nc,h]
    hcur = h0.float() if h0 is not None else torch.zeros(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(hcur)
        hcur = hcur * chunk_decay[:, c, :, None, None] + states[:, c]
    hp = torch.stack(h_prevs, 1).view(b, nc, g, rep, p, n).permute(
        0, 1, 2, 5, 3, 4).reshape(b * nc * g, n, rep * p)

    # the entering state's contribution: (C . h_prev) * decay from the start
    y_off = torch.bmm(Cg.reshape(b * nc * g, l, n), hp).view(
        b, nc, g, l, rep, p).permute(0, 1, 3, 2, 4, 5).reshape(
        b, nc, l, h, p) * torch.exp(a_cum).transpose(2, 3)[..., None]
    y = y_diag.permute(0, 1, 3, 2, 4) + y_off
    return y.reshape(b, s, h, p), hcur


def ssd_sequential(x: torch.Tensor, a_dt: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, h0: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The O(S) recurrence, token by token (the tests' oracle for
    :func:`ssd_chunked`; the same shapes)."""
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    hcur = h0.float() if h0 is not None else torch.zeros(
        (b, h, p, B.shape[3]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        hcur = hcur * torch.exp(a_dt[:, t].float())[..., None, None] + \
            x[:, t].float()[..., :, None] * Bh[:, t][..., None, :]
        ys.append((hcur @ Ch[:, t][..., None])[..., 0])
    return torch.stack(ys, 1), hcur


def _conv_step(tail: torch.Tensor, new: torch.Tensor, w: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode token through a convolution, as the reference's decode
    step: the window's products summed in fp32, ``silu`` of that fp32 sum
    (no rounding to the activation dtype, unlike the prefill's
    :func:`_causal_conv`).  Returns (that output in fp32, the window
    [B,W,C] in the tail's dtype)."""
    win = torch.cat([tail, new[:, None].to(tail.dtype)], 1)
    out = torch.zeros(new.shape, dtype=torch.float32, device=new.device)
    for i in range(w.shape[0]):
        out = out + win[:, i].float() * w[i].float()
    return L.silu(out), win


def ssm_forward(p: dict, cfg: ArchConfig, u: torch.Tensor,
                state: SSMState | None = None, *, mode: str = "train"
                ) -> tuple[torch.Tensor, SSMState | None]:
    """The Mamba2 mixer: u [B,S,d] -> (y [B,S,d] in u's dtype, state).

    * ``"train"`` / ``"prefill"``: the chunked scan over the sequence from
      ``state.h`` (zeros without a state).  A prefill, or a call given a
      state, returns a new state: ``h`` fp32, the convolutions' last
      ``W - 1`` inputs (the pre-convolution projections, zero-padded in
      front of a shorter sequence) in u's dtype.
    * ``"decode"``: the recurrence over the S tokens one at a time,
      updating ``state`` **in place** (``h`` and the three windows,
      shifted by one; each plane keeps its dtype); returns it."""
    s = cfg.ssm
    B_, S, d = u.shape
    din, H, P = s.d_inner(d), s.nheads(d), s.head_dim
    g, N = s.ngroups, s.state_dim

    z = u @ p["w_z"]
    xr = u @ p["w_x"]
    Br = u @ p["w_B"]
    Cr = u @ p["w_C"]
    dt = softplus(u.float() @ p["w_dt"].float() + p["dt_bias"])  # [B,S,H]
    A = -torch.exp(p["A_log"])                                   # [H]

    if mode == "decode":
        ys = []
        for t in range(S):
            xt, wx = _conv_step(state.conv_x, xr[:, t], p["conv_x"])
            Bt, wB = _conv_step(state.conv_B, Br[:, t], p["conv_B"])
            Ct, wC = _conv_step(state.conv_C, Cr[:, t], p["conv_C"])
            xh = xt.view(B_, H, P)
            Bh = Bt.view(B_, g, N).repeat_interleave(H // g, dim=1)
            Ch = Ct.view(B_, g, N).repeat_interleave(H // g, dim=1)
            dtt = dt[:, t]                                       # [B,H]
            hnew = state.h * torch.exp(dtt * A)[..., None, None] + \
                xh[..., :, None] * (Bh * dtt[..., None])[..., None, :]
            yt = (hnew @ Ch[..., None])[..., 0] + p["D"][None, :, None] * xh
            state.h.copy_(hnew)
            for plane, win in ((state.conv_x, wx), (state.conv_B, wB),
                               (state.conv_C, wC)):
                plane.copy_(win[:, 1:])
            ys.append(yt.reshape(B_, din))
        y = torch.stack(ys, 1)
    elif mode in ("train", "prefill"):
        xh = L.silu(_causal_conv(xr, p["conv_x"])).view(B_, S, H, P)
        Bh = L.silu(_causal_conv(Br, p["conv_B"])).view(B_, S, g, N)
        Ch = L.silu(_causal_conv(Cr, p["conv_C"])).view(B_, S, g, N)
        a_dt = dt * A                                            # [B,S,H]
        chunk = min(s.chunk, S)
        pad = (-S) % chunk
        dtp = dt
        if pad:
            def zpad(a):
                return torch.nn.functional.pad(
                    a, (0, 0) * (a.dim() - 2) + (0, pad))
            xh, a_dt, Bh, Ch, dtp = (zpad(a) for a in (xh, a_dt, Bh, Ch, dt))
        y4, hf = ssd_chunked(xh * dtp[..., None], a_dt, Bh, Ch, chunk,
                             state.h if state is not None else None)
        y4 = y4[:, :S] + p["D"][None, None, :, None] * xh[:, :S].float()
        y = y4.reshape(B_, S, din)
        if mode == "prefill" or state is not None:
            W = s.conv_width

            def tail(r):
                # a copy: a view would keep the whole [B,S,C] projection
                return torch.nn.functional.pad(
                    r, (0, 0, max(0, W - 1 - S), 0))[:, -(W - 1):].clone()
            state = SSMState(hf, tail(xr), tail(Br), tail(Cr))
    else:
        raise ValueError(f"mode={mode!r}: train | prefill | decode")

    # gated RMSNorm + out projection
    y = L.rmsnorm(p["norm"], y.to(u.dtype) * L.silu(z), cfg.norm_eps)
    return y @ p["w_out"], state
