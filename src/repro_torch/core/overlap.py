"""ESS decode attention, modes ``none`` and ``da`` (paper section 3.3;
counterpart of ``repro.core.overlap``; ``dba`` is not ported yet).

* ``none``: one attention over the union of pool hits and fetched misses.
* ``da`` (Dual-Attention): the miss fetch is issued first; **Attn0** runs
  over pool-resident rows and **Attn1** over the fetched rows; the two
  unnormalized partials merge exactly.

Both attends run the sparse-MLA partial kernel, the fetch runs the UVA
row-gather kernel (its fused dequant variant for a quantized tier, which
returns bf16 rows as the reference's does), and the indexer scores run
the indexer kernel.  The pool is updated in place; admission casts the
fetched rows to the pool's dtype.  Q>1 (draft verification) flattens the
per-query top-k into one pool lookup and keeps each query causal.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload
from repro_torch.kernels.sparse_mla import ops as sk
from repro_torch.models import mla as M


class ESSLayerState(NamedTuple):
    pool: LP.PoolState            # device-resident sparse memory pool
    host_latent: torch.Tensor     # dense [L,B,S,D] / paged [L,NP,R,D]
    layer: int = 0                # layer index into a stacked tier
    batch_offset: int = 0         # row offset into the tier's batch
    block_table: torch.Tensor | None = None   # [B_total, NB] (paged)
    host_scales: torch.Tensor | None = None   # quantized tier: row scales


class ESSStats(NamedTuple):
    hits: torch.Tensor
    misses: torch.Tensor
    overflow: torch.Tensor


def _attend_rows(q_comb: torch.Tensor, rows: torch.Tensor,
                 valid: torch.Tensor, cfg: ArchConfig) -> M.Partial:
    """q [B,Q,H,D] vs per-query rows [B,Q,K,D] (or shared [B,K,D]); the
    sparse-MLA kernel (fp32 math, as the reference's ``use_kernel=True``):
    bf16 at MLA's widths takes the tensor-core route, fp32 the general one
    (``kernels/sparse_mla/ops.tc_route``).  Rows of another dtype (a
    quantized tier's bf16 misses under fp32 params) widen to the query's,
    as the reference's promotion does."""
    return sk.partial_attend(q_comb, rows.to(q_comb.dtype), valid,
                             M.mla_scale(cfg),
                             cfg.mla.kv_lora_rank)


def ess_sparse_attention(mla_p: dict, idx_p: dict, cfg: ArchConfig,
                         x_norm: torch.Tensor, positions: torch.Tensor,
                         state: ESSLayerState, idx_keys: torch.Tensor,
                         lens: torch.Tensor, *, overlap: str = "da",
                         slot_mask: torch.Tensor | None = None
                         ) -> tuple[torch.Tensor, ESSLayerState, ESSStats]:
    """One layer of ESS decode attention.

    x_norm [B,Q,d], positions [B,Q], idx_keys [B,S,Di] already holding the
    new tokens' keys, lens [B] (or per-query [B,Q]) = cache length after
    the append; ``state.host_latent`` already holds the new latent rows.
    ``slot_mask`` [B] gates frozen rows' pool mutations."""
    if overlap not in ("none", "da"):
        raise NotImplementedError(f"overlap={overlap!r} is not ported yet")
    pool, lk, stats, ids, req_valid, K, M_env = _topk_and_lookup(
        idx_p, cfg, x_norm, state, idx_keys, lens, slot_mask)
    # issue the fetch first (DA: Attn0 does not depend on it)
    fetched = offload.gather_tier_rows(
        state.host_latent, state.host_scales, lk.miss_ids, layer=state.layer,
        batch_offset=state.batch_offset, block_table=state.block_table)
    out, pool = _finish_attention(mla_p, cfg, x_norm, positions, pool, lk,
                                  ids, req_valid, fetched, K, M_env, overlap,
                                  slot_mask)
    pool = LP.tick(pool)
    return out, state._replace(pool=pool), ESSStats(*stats)


def _fetch_valid(lk: LP.Lookup, B: int, Q: int, K: int, M_env: int
                 ) -> torch.Tensor:
    """[B,Q,M_env] bool — which fetched rows each query requested."""
    qidx = (torch.arange(Q * K, device=lk.miss_rank.device) // K)
    qidx = qidx[None].expand(B, Q * K)
    scat = lk.miss_rank.clamp_max(M_env)              # non-miss rank is big
    out = torch.zeros((B, Q, M_env + 1), dtype=torch.bool,
                      device=lk.miss_rank.device)
    bi = torch.arange(B, device=out.device)[:, None].expand(B, Q * K)
    out.index_put_((bi, qidx, scat), out.new_ones(()))
    return out[:, :, :M_env]


def _topk_and_lookup(idx_p, cfg, x_norm, state, idx_keys, lens, slot_mask):
    B, Q, _ = x_norm.shape
    S = idx_keys.shape[1]
    K = min(cfg.dsa.index_topk, S)
    M_env = max(1, int(cfg.ess.max_miss_ratio * K)) * Q

    qlens = lens[:, None] if lens.dim() == 1 else lens          # [B,Q]
    valid_s = (torch.arange(S, device=lens.device)[None, None, :]
               < qlens[:, :, None]).expand(B, Q, S)
    iq = M.indexer_query(idx_p, x_norm)
    sc = M.indexer_scores(iq, idx_keys, valid_s)                 # [B,Q,S]
    ids = M.topk_ids(sc, K, valid_s)                             # [B,Q,K]
    req_valid = valid_s.gather(2, ids)
    pool, lk, stats = LP.lookup(state.pool, ids.reshape(B, Q * K),
                                req_valid.reshape(B, Q * K), M_env,
                                slot_mask=slot_mask, dedup=Q > 1)
    return pool, lk, stats, ids, req_valid, K, M_env


def _finish_attention(mla_p, cfg, x_norm, positions, pool, lk, ids,
                      req_valid, fetched, K, M_env, overlap, slot_mask):
    """Attn0 on pool-resident rows, Attn1 on ``fetched``, exact merge (or
    one union attention for ``none``); then LRU admission.  Returns
    ``(out, pool)``; the caller ticks the clock."""
    B, Q, _ = x_norm.shape
    q_comb = M.absorbed_query(mla_p, cfg, x_norm, positions)     # [B,Q,H,D]
    D = fetched.shape[-1]
    if overlap == "none":
        rows_hit, _ = LP.gather_resident(pool, lk.slot, lk.hit)
        fr = fetched.gather(1, lk.miss_rank.clamp(0, M_env - 1)[..., None]
                            .expand(B, Q * K, D))
        fr = torch.where((lk.miss_rank < M_env)[..., None], fr,
                         torch.zeros_like(fr))
        rows = torch.where(lk.hit[..., None], rows_hit, fr)
        valid = (lk.hit | (lk.miss_rank < M_env)) & \
            (ids.reshape(B, Q * K) >= 0)
        part = _attend_rows(q_comb, rows.view(B, Q, K, D),
                            valid.view(B, Q, K), cfg)
    else:
        rows0, _ = LP.gather_resident(pool, lk.slot, lk.hit)
        p0 = _attend_rows(q_comb, rows0.view(B, Q, K, D),
                          lk.hit.view(B, Q, K) & req_valid, cfg)
        mvalid = lk.miss_ids >= 0
        if Q > 1:
            fvalid = _fetch_valid(lk, B, Q, K, M_env) & mvalid[:, None]
            p1 = _attend_rows(q_comb, fetched[:, None].expand(B, Q, -1, D),
                              fvalid, cfg)
        else:
            p1 = _attend_rows(q_comb, fetched[:, None], mvalid[:, None], cfg)
        part = M.merge_partials(p0, p1)

    out_lat = M.finalize_partial(part, x_norm.dtype)
    out = M.output_proj(mla_p, cfg, out_lat)
    pool = LP.admit(pool, lk.miss_ids, fetched, slot_mask=slot_mask)
    return out, pool
