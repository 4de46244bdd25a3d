"""The plain reference: DeepSeek-V3 / V3.2 forward in float32, written from
the published equations with nothing of the program under test.

One sequence at a time, layer by layer over the whole sequence: RMSNorm
(zero-centred scale, ``1 + w``), MLA in the absorbed form over 576-dim
latent rows (``rmsnorm(c_kv) ++ rope(k_pe)``), the DSA lightning indexer
(``sum_h w_h relu(q_h . k)`` over the causal keys, the top-``index_topk``
keys with the lowest index first among equal scores) where the
configuration has one, causal attention over the selected rows (every
causal row without an indexer), then the dense gated MLP or the MoE: a
sigmoid router with its selection bias, the top-``k`` experts' gates
normalized and scaled by ``routed_scaling_factor``, every routed token
computed (no capacity, nothing dropped), plus the shared expert; the final
norm and the unembedding.

The weights are the tree the benchmark drew (bf16 tensors), widened to
float32 one matrix at a time; TF32 is off for the whole computation.  With
``quant="fp8"`` every matrix product instead takes operands rounded to
float8 e4m3 (per output channel for weights, per row for activations) and
the latent and indexer caches are rounded the same way: the control, one
precision below the bf16 the configuration states.
"""

from __future__ import annotations

import contextlib

import torch

NEG = float("-inf")
# float32 bytes of one query block's largest temporary: the indexer's
# [q, heads, keys] scores, or the rows gathered for the selected keys
BLOCK_BYTES = 1 << 30
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """Float32 products without TF32, restored afterwards."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    p = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(p)


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` (float32) through float8 e4m3 with one scale per slice along
    ``dim``'s complement (amax over ``dim`` maps to 448), back in float32."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


class Precision:
    """Where the reference rounds: nowhere (float32), or to e4m3 (fp8)."""

    def __init__(self, quant: str | None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant={quant!r}: None | 'fp8'")
        self.fp8 = quant == "fp8"

    def weight(self, w: torch.Tensor) -> torch.Tensor:
        """A ``[in, out]`` weight in float32 (rounded per output column)."""
        w = w.float()
        return fp8_round(w, 0) if self.fp8 else w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation ``[..., in]`` entering a product (per row)."""
        return fp8_round(x, -1) if self.fp8 else x

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``x [..., in] @ w [in, out]``."""
        return self.act(x) @ self.weight(w)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope_cos_sin(pos: torch.Tensor, dim: int, theta: float):
    """cos, sin ``[n, dim/2]``: inverse frequencies ``theta ** (-i/half)``
    rounded to float32, angles ``position * frequency`` in float32."""
    half = dim // 2
    e = torch.arange(half, dtype=torch.float64, device=pos.device) / half
    freqs = (1.0 / theta ** e).float()
    ang = pos.float()[:, None] * freqs[None, :]
    return torch.cos(ang.double()).float(), torch.sin(ang.double()).float()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """Rotate pairs ``(i, i + D/2)`` of ``x [n, heads, D]``."""
    half = x.shape[-1] // 2
    c, s = cos[:, None, :], sin[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def topk_lowest_index(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, the lowest index
    first among equal values."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def _layer(weights: dict, layer: int, n_dense: int) -> tuple[dict, bool]:
    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}
    if layer < n_dense:
        return pick(weights["dense_layers"], layer), False
    return pick(weights["layers"], layer - n_dense), True


def _attention(lp: dict, cfg: dict, h: torch.Tensor, pos: torch.Tensor,
               cos, sin, pr: Precision) -> torch.Tensor:
    """MLA over the causal (DSA: selected) keys of ``h [N, d]``."""
    m = lp["mla"]
    N = h.shape[0]
    H = cfg["num_attention_heads"]
    nope, rdim = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    rank, vdim = cfg["kv_lora_rank"], cfg["v_head_dim"]
    eps = cfg["rms_norm_eps"]
    scale = (nope + rdim) ** -0.5

    c_kv = rmsnorm(pr.mm(h, m["w_dkv"]), m["kv_norm"], eps)
    k_pe = rope(pr.mm(h, m["w_kr"])[:, None, :], cos, sin)[:, 0]
    lat = torch.cat([c_kv, k_pe], dim=-1)                       # [N, 576]
    if pr.fp8:
        lat = fp8_round(lat, -1)
    # each weight widened once for the whole sequence
    w_dq = pr.weight(m["w_dq"])
    w_uq = pr.weight(m["w_uq"].reshape(m["w_uq"].shape[0], -1))
    w_uk = pr.weight(m["w_uk"].reshape(rank, -1)).view(rank, H, nope)
    w_uv = pr.weight(m["w_uv"].reshape(rank, -1)).view(rank, H, vdim)
    w_o = pr.weight(m["wo"].reshape(H * vdim, -1))

    dsa = "indexer" in lp and cfg.get("index_topk") is not None
    if dsa:
        ix = lp["indexer"]
        Hi, Di = cfg["index_n_heads"], cfg["index_head_dim"]
        keys = pr.mm(h, ix["w_ik"])                             # [N, Di]
        if pr.fp8:
            keys = fp8_round(keys, -1)
        w_iq = pr.weight(ix["w_iq"].reshape(ix["w_iq"].shape[0], -1))
        w_iw = pr.weight(ix["w_iw"])
        topk = cfg["index_topk"]
        k_max = min(topk, N)
        per_q = 4 * max(Hi * N, k_max * lat.shape[1], H * k_max)
    else:
        per_q = 4 * H * N
    qb = max(1, min(N, BLOCK_BYTES // per_q))
    out = torch.empty_like(h)
    for q0 in range(0, N, qb):
        q1 = min(N, q0 + qb)
        hq, pq = h[q0:q1], pos[q0:q1]
        n = q1 - q0
        cq = rmsnorm(pr.act(hq) @ w_dq, m["q_norm"], eps)
        q = (pr.act(cq) @ w_uq).view(n, H, nope + rdim)
        q_pe = rope(q[..., nope:], cos[q0:q1], sin[q0:q1])
        q_lat = torch.einsum("qhk,lhk->qhl", pr.act(q[..., :nope]), w_uk)
        qc = torch.cat([q_lat, q_pe], dim=-1)                   # [n, H, 576]
        if pr.fp8:
            qc = fp8_round(qc, -1)
        kv = q1                                                 # causal end
        causal = torch.arange(kv, device=h.device)[None, :] <= pq[:, None]
        if dsa:
            iq = (pr.act(hq) @ w_iq).view(n, Hi, Di)
            iw = pr.act(hq) @ w_iw                              # [n, Hi]
            sc = torch.einsum("qhd,sd->qhs", iq, keys[:kv]).relu_()
            sc = torch.einsum("qhs,qh->qs", sc, iw)
            sc = sc.masked_fill(~causal, NEG)
            k = min(topk, kv)
            ids = topk_lowest_index(sc, k)                      # [n, k]
            ok = ids <= pq[:, None]
            rows = lat[ids]                                     # [n, k, 576]
            s = torch.einsum("qhd,qkd->qhk", qc, rows) * scale
            s = s.masked_fill(~ok[:, None, :], NEG)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("qhk,qkv->qhv", p, rows[..., :rank])
        else:
            s = torch.einsum("qhd,sd->qhs", qc, lat[:kv]) * scale
            s = s.masked_fill(~causal[:, None, :], NEG)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("qhs,sv->qhv", p, lat[:kv, :rank])
        o = torch.einsum("qhl,lhv->qhv", pr.act(o), w_uv)       # [n, H, v]
        out[q0:q1] = pr.act(o.reshape(n, H * vdim)) @ w_o
    return out


def _mlp(p: dict, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    g = pr.mm(x, p["wi_gate"])
    return pr.mm(torch.nn.functional.silu(g) * pr.mm(x, p["wi_up"]),
                 p["wo"])


def _moe(p: dict, cfg: dict, x: torch.Tensor, pr: Precision) -> torch.Tensor:
    """Every token through its top-k routed experts and the shared one."""
    K = cfg["num_experts_per_tok"]
    logits = x @ p["router"].float()                            # [N, E]
    gates = torch.sigmoid(logits)
    sel = gates + p["router_bias"].float()[None, :] \
        if "router_bias" in p else gates
    top = topk_lowest_index(sel, K)                             # [N, K]
    w = gates.gather(1, top)
    if cfg.get("norm_topk_prob", True):
        w = w / w.sum(-1, keepdim=True).clamp_min(1e-20)
    w = w * cfg["routed_scaling_factor"]
    out = torch.zeros_like(x)
    flat = top.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=p["w_gate"].shape[0]).tolist()
    tok = order // K
    wt = w.reshape(-1)[order]
    start = 0
    for e, c in enumerate(counts):
        if c == 0:
            continue
        t, we = tok[start:start + c], wt[start:start + c]
        start += c
        xe = x[t]
        h = torch.nn.functional.silu(pr.mm(xe, p["w_gate"][e])) \
            * pr.mm(xe, p["w_up"][e])
        out.index_add_(0, t, pr.mm(h, p["w_down"][e]) * we[:, None])
    if "shared" in p:
        out = out + _mlp(p["shared"], x, pr)
    return out


def forward_hidden(weights: dict, cfg: dict, tokens: torch.Tensor,
                   quant: str | None = None) -> torch.Tensor:
    """Token ids ``[N]`` -> final-normed hidden states ``[N, d]`` (float32)."""
    pr = Precision(quant)
    with exact_fp32():
        N = tokens.shape[0]
        pos = torch.arange(N, device=tokens.device)
        cos, sin = rope_cos_sin(pos, cfg["qk_rope_head_dim"],
                                cfg["rope_theta"])
        x = weights["embed"][tokens].float()
        nd = cfg["first_k_dense_replace"]
        eps = cfg["rms_norm_eps"]
        for layer in range(cfg["num_hidden_layers"]):
            lp, is_moe = _layer(weights, layer, nd)
            h = rmsnorm(x, lp["ln1"], eps)
            x = x + _attention(lp, cfg, h, pos, cos, sin, pr)
            h2 = rmsnorm(x, lp["ln2"], eps)
            x = x + (_moe(lp["ffn"], cfg, h2, pr) if is_moe
                     else _mlp(lp["ffn"], h2, pr))
        return rmsnorm(x, weights["final_norm"], eps)


def logits(weights: dict, hidden: torch.Tensor,
           quant: str | None = None) -> torch.Tensor:
    """``hidden [n, d]`` -> float32 logits ``[n, vocab]``."""
    pr = Precision(quant)
    with exact_fp32():
        w = weights["unembed"].float()
        if pr.fp8:
            w = fp8_round(w, 1)
        return pr.act(hidden) @ w.t()


def served_gaps(weights: dict, cfg: dict, prompt, served,
                quant: str | None = None, block: int = 256) -> dict:
    """Run the reference over ``prompt ++ served[:-1]`` and read, at every
    position that produced a served token, how far that token's logit lies
    below the reference's best (``gap``).  With ``quant`` the same positions
    are also run at that precision, and ``control_gap`` is how far the
    token the lower precision puts first lies below the float32 best.
    Returns the per-position arrays (numpy)."""
    dev = weights["embed"].device
    prompt = torch.as_tensor(prompt, dtype=torch.long, device=dev)
    served_t = torch.as_tensor(served, dtype=torch.long, device=dev)
    seq = torch.cat([prompt, served_t[:-1]])
    first = prompt.shape[0] - 1
    hid = forward_hidden(weights, cfg, seq)[first:]
    gaps = []
    for a in range(0, hid.shape[0], block):
        lg = logits(weights, hid[a:a + block])
        got = lg.gather(1, served_t[a:a + block, None])[:, 0]
        gaps.append(lg.amax(-1) - got)
    out = {"gap": torch.cat(gaps).cpu().numpy()}
    if quant is not None:
        hq = forward_hidden(weights, cfg, seq, quant=quant)[first:]
        cg = []
        for a in range(0, hid.shape[0], block):
            lg = logits(weights, hid[a:a + block])
            pick = logits(weights, hq[a:a + block], quant=quant).argmax(-1)
            cg.append(lg.amax(-1) - lg.gather(1, pick[:, None])[:, 0])
        out["control_gap"] = torch.cat(cg).cpu().numpy()
    return out
