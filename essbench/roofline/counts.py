"""Operations and bytes from shapes: the model's FLOPs per token and each
kernel's least work, the numerators of every ``mfu`` and ``*_roofline``.

``cfg`` is a configuration file's dict (the published keys).  A token's
FLOPs are the products the model's equations need at that token's context
``ctx`` (the keys it may attend, itself included), in the absorbed MLA
form the port decodes with: the MLA projections, the indexer's
projections and its scores over the ``ctx`` valid keys (V3.2), attention
over the ``min(index_topk, ctx)`` selected rows (V3: all ``ctx``), the
dense MLP or the top-k routed experts plus the shared ones and the
router, and the unembedding where the token yields logits.  Capacity
padding and unselected experts are never counted.  A multiply-add is two
operations.
"""

from __future__ import annotations

# H100 SXM, NVIDIA's data sheet (dense, no sparsity), at 700 W
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12
# PCIe Gen5 x16, each way
LINK_BYTES_S = 64e9
BF16 = 2


def _dims(cfg: dict) -> dict:
    return {"d": cfg["hidden_size"], "H": cfg["num_attention_heads"],
            "qr": cfg["q_lora_rank"], "kr": cfg["kv_lora_rank"],
            "nope": cfg["qk_nope_head_dim"], "rd": cfg["qk_rope_head_dim"],
            "v": cfg["v_head_dim"]}


def selected(cfg: dict, ctx: int) -> int:
    """Rows one query attends: the DSA top-k, or every causal row."""
    k = cfg.get("index_topk")
    return min(k, ctx) if k else ctx


def token_flops(cfg: dict, ctx: int, logits: bool = True) -> float:
    m = _dims(cfg)
    d, H, kr, rd = m["d"], m["H"], m["kr"], m["rd"]
    proj = (d * m["qr"] + m["qr"] * H * (m["nope"] + rd)   # q path
            + H * m["nope"] * kr                          # absorb W_uk
            + d * kr + d * rd                             # latent row
            + H * kr * m["v"] + H * m["v"] * d)           # W_uv, W_o
    attn = H * selected(cfg, ctx) * ((kr + rd) + kr)
    idx = 0
    if cfg.get("index_topk"):
        Hi, Di = cfg["index_n_heads"], cfg["index_head_dim"]
        idx = d * Hi * Di + d * Hi + d * Di + Hi * Di * ctx
    L, nd = cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["n_routed_experts"] + (
        cfg["num_experts_per_tok"] + cfg["n_shared_experts"]) \
        * 3 * d * cfg["moe_intermediate_size"]
    macs = L * (proj + attn + idx) + nd * dense + (L - nd) * moe
    if logits:
        macs += d * cfg["vocab_size"]
    return 2.0 * macs


def sparse_mla(cfg: dict, ctx: int) -> tuple[float, float]:
    """(bytes, ops) of one query's attention in one layer: the selected
    latent rows read once, the absorbed query read, the output written,
    scores and values over the rows."""
    m = _dims(cfg)
    H, D, kr = m["H"], m["kr"] + m["rd"], m["kr"]
    n = selected(cfg, ctx)
    nbytes = n * D * BF16 + H * D * BF16 + H * kr * BF16
    return float(nbytes), 2.0 * H * n * (D + kr)


def indexer(cfg: dict, ctx: int) -> tuple[float, float]:
    """(bytes, ops) of one query's indexer scores in one layer: the
    ``ctx`` valid keys and the query and head weights read once, one fp32
    score written a key."""
    Hi, Di = cfg["index_n_heads"], cfg["index_head_dim"]
    nbytes = ctx * Di * BF16 + Hi * Di * BF16 + Hi * BF16 + ctx * 4
    return float(nbytes), 2.0 * Hi * Di * ctx


def bound_s(nbytes: float, ops: float, host_bytes: float = 0.0) -> float:
    """The least time: device bytes over HBM, or host bytes over the link
    (the two overlap), against operations over the bf16 peak."""
    return max(nbytes / HBM_BYTES_S, host_bytes / LINK_BYTES_S,
               ops / PEAK_BF16_FLOPS)


def tier_gather(rows: int, row_bytes: int) -> tuple[float, float]:
    """(device bytes, host bytes) of fetching ``rows`` tier rows: each read
    once over the link and written once into device memory, its id read."""
    return float(rows * (row_bytes + 8)), float(rows * row_bytes)


def work_flops(work, cfg: dict) -> float:
    """FLOPs of a run of rounds ``[(decode contexts, prefill chunks)]``:
    each decode token at its context with its logits, each prefill token
    ``i`` of a chunk ``(start, n)`` at context ``i + 1`` without."""
    total = 0.0
    for dec, chunks in work:
        total += sum(token_flops(cfg, c) for c in dec)
        for start, n in chunks:
            total += sum(token_flops(cfg, i + 1, logits=False)
                         for i in range(start, start + n))
    return total
