"""Wrappers of the sparse-MLA partial kernels.

CPU tensors run the plain version (:mod:`.ref`); CUDA tensors launch a
kernel or raise.  Two kernels compute the same partial, chosen by shape
and dtype (:func:`tc_route`):

* ``csrc/sparse_mla_tc.cu`` — bf16 ``q`` and rows at MLA's widths (D = 576,
  rank = 512, H a multiple of 64, K >= 1): TMA-fed row tiles and wgmma,
  split over K when the (b, q, head block) CTAs cannot fill the card, the
  splits combined by :func:`merge_splits`;
* ``csrc/sparse_mla.cu`` — every other shape or dtype (fp32 params, small
  widths): the general CUDA-core kernel.

``partial_attend.launches`` counts every partial launch, and
``.launches_tc`` / ``.launches_general`` each route's own,
``.launches_by_shape`` each ``(Q, K)``'s (queries, rows per query);
``merge_splits.launches`` counts the merges.

:func:`sparse_mla_gather_attend` is the monolithic path's two-kernel
attention over a device-resident latent cache: the row gather
(``kernels/gather_cache``) of each query's selected rows, then the
partial, normalized.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.sparse_mla import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D, _MAX_RANK = 1024, 512
_READY: set = set()

# the tensor-core route's shapes (csrc/sparse_mla_tc.cu)
TC_D, TC_RANK, TC_HEADS, TC_TILE = 576, 512, 64, 64
MIN_TILES_PER_SPLIT = 4   # so Attn1's 4 tiles run unsplit, with no merge


def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_mla")
    if "sparse_mla" not in _READY:
        lib.ess_sparse_mla_partial.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
            _I64, _I64, _I64, _I64, _I, _P]
        lib.ess_sparse_mla_partial.restype = ctypes.c_int
        _READY.add("sparse_mla")
    return lib


def _tc_lib() -> ctypes.CDLL:
    lib = _build.load("sparse_mla_tc")
    if "sparse_mla_tc" not in _READY:
        lib.ess_sparse_mla_tc.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
            ctypes.c_float, _P]
        lib.ess_sparse_mla_tc.restype = ctypes.c_int
        lib.ess_sparse_mla_merge.argtypes = [_P, _P, _P, _P, _P, _P, _I,
                                             _I64, _I, _P]
        lib.ess_sparse_mla_merge.restype = ctypes.c_int
        _READY.add("sparse_mla_tc")
    return lib


def tc_route(q_comb: torch.Tensor, rows: torch.Tensor, rank: int) -> bool:
    """Whether :func:`partial_attend` takes the tensor-core kernel: bf16
    ``q`` and rows, D = 576, rank = 512, H % 64 == 0 and K >= 1.  A routing
    by shape and dtype, not a fallback: every other call on CUDA takes the
    general kernel, and a failure of either kernel raises."""
    H, D = q_comb.shape[-2:]
    return (q_comb.dtype == torch.bfloat16 and rows.dtype == torch.bfloat16
            and D == TC_D and rows.shape[-1] == TC_D and rank == TC_RANK
            and H % TC_HEADS == 0 and rows.shape[-2] >= 1)


def plan_splits(bq: int, H: int, K: int, n_sm: int) -> tuple[int, int]:
    """``(nsplit, rows_per_split)`` of the tensor-core kernel's K split.

    One CTA holds 64 heads of one (b, q) and one split, and takes most of
    an SM's shared memory, so ``bq * H / 64`` CTAs fill the card once they
    reach ``n_sm``.  Below that, K is cut into ``nsplit`` runs of whole
    64-row tiles, at least ``MIN_TILES_PER_SPLIT`` each, so that about
    ``n_sm`` CTAs run; every split is non-empty and split ``s`` covers rows
    ``[s * rows_per_split, min(K, (s + 1) * rows_per_split))``."""
    ntiles = -(-K // TC_TILE)
    ctas = bq * (H // TC_HEADS)
    nsplit = max(1, min(n_sm // max(ctas, 1),
                        -(-ntiles // MIN_TILES_PER_SPLIT)))
    tiles_per = -(-ntiles // nsplit)
    return -(-ntiles // tiles_per), tiles_per * TC_TILE


def tc_splits(q_comb: torch.Tensor, rows: torch.Tensor, valid: torch.Tensor,
              scale: float):
    """Launch the tensor-core kernel (CUDA, :func:`tc_route` shapes) and
    return its per-split partials ``(o [S,B,Q,H,512], m [S,B,Q,H], l)``,
    S from :func:`plan_splits`; :func:`merge_splits` combines them."""
    lib = _tc_lib()
    B, Q, H, D = q_comb.shape
    K = rows.shape[-2]
    shared = rows.dim() == 3
    if not tc_route(q_comb, rows, TC_RANK) or q_comb.device.type != "cuda":
        raise ValueError(f"tc_splits: q {tuple(q_comb.shape)} "
                         f"{q_comb.dtype}, rows {tuple(rows.shape)} "
                         f"{rows.dtype} on {q_comb.device}")
    if not shared and rows.shape[:2] != (B, Q):
        raise ValueError(f"partial_attend: rows {tuple(rows.shape)} vs q "
                         f"{tuple(q_comb.shape)}")
    q_comb = q_comb.contiguous()
    rows = rows.contiguous()
    valid = valid.expand(rows.shape[:-1]).contiguous()
    if q_comb.data_ptr() % 16 or rows.data_ptr() % 16:
        raise ValueError("partial_attend: q and rows must be 16-byte aligned")
    dev = q_comb.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    nsplit, per = plan_splits(B * Q, H, K, n_sm)
    o = torch.empty((nsplit, B, Q, H, TC_RANK), dtype=torch.float32,
                    device=dev)
    m = torch.empty((nsplit, B, Q, H), dtype=torch.float32, device=dev)
    l = torch.empty((nsplit, B, Q, H), dtype=torch.float32, device=dev)
    _build.check(lib, lib.ess_sparse_mla_tc(
        _P(q_comb.data_ptr()), _P(rows.data_ptr()), _P(valid.data_ptr()),
        _P(o.data_ptr()), _P(m.data_ptr()), _P(l.data_ptr()), B, Q, H, K,
        int(shared), nsplit, per, float(scale), _build.stream_ptr(o)),
        "sparse_mla_tc")
    partial_attend.launches_tc += 1
    return o, m, l


def merge_splits(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor):
    """Combine the partials of disjoint K splits stacked on dim 0 (o
    [S,...,rank], m / l [S,...] fp32) into one ``(o, m, l)``."""
    if o.device.type == "cpu":
        return ref.merge_splits_ref(o, m, l)
    if o.device.type != "cuda":
        raise ValueError(f"merge_splits: unsupported device {o.device}")
    if {o.dtype, m.dtype, l.dtype} != {torch.float32}:
        raise ValueError("merge_splits: o, m and l must be fp32")
    S, rank = o.shape[0], o.shape[-1]
    if m.shape != o.shape[:-1] or l.shape != m.shape or rank % 4:
        raise ValueError(f"merge_splits: o {tuple(o.shape)}, m "
                         f"{tuple(m.shape)}, l {tuple(l.shape)}")
    o, m, l = o.contiguous(), m.contiguous(), l.contiguous()
    lib = _tc_lib()
    rows = m[0].numel()
    oo = torch.empty(o.shape[1:], dtype=torch.float32, device=o.device)
    mo = torch.empty(m.shape[1:], dtype=torch.float32, device=o.device)
    lo = torch.empty(m.shape[1:], dtype=torch.float32, device=o.device)
    _build.check(lib, lib.ess_sparse_mla_merge(
        _P(o.data_ptr()), _P(m.data_ptr()), _P(l.data_ptr()),
        _P(oo.data_ptr()), _P(mo.data_ptr()), _P(lo.data_ptr()), S, rows,
        rank, _build.stream_ptr(oo)), "sparse_mla_merge")
    merge_splits.launches += 1
    return oo, mo, lo


def partial_attend(q_comb: torch.Tensor, rows: torch.Tensor,
                   valid: torch.Tensor, scale: float, rank: int):
    """Batched flash partials.

    q_comb [B,Q,H,D]; rows [B,K,D] (shared over Q) or [B,Q,K,D]; valid
    [B,K] / [B,Q,K] bool.  Returns ``Partial(o [B,Q,H,rank], m [B,Q,H],
    l [B,Q,H])`` in fp32, for :func:`repro_torch.models.mla.merge_partials`.
    On CUDA, :func:`tc_route` picks the kernel.
    """
    from repro_torch.models.mla import Partial
    B, Q, H, D = q_comb.shape
    if q_comb.device.type == "cpu":
        if rows.dim() == 3:
            rows = rows[:, None].expand(B, Q, *rows.shape[1:])
            valid = valid[:, None].expand(B, Q, valid.shape[-1])
        return Partial(*ref.sparse_mla_partial_ref(q_comb, rows, valid,
                                                   scale, rank))
    if q_comb.device.type != "cuda":
        raise ValueError(f"partial_attend: unsupported device "
                         f"{q_comb.device}")
    if q_comb.dtype not in _DTYPES or rows.dtype != q_comb.dtype:
        raise ValueError(f"partial_attend: q and rows must share fp32 or "
                         f"bf16 ({q_comb.dtype}, {rows.dtype})")
    if valid.dtype != torch.bool:
        raise ValueError("partial_attend: valid must be bool")
    if tc_route(q_comb, rows, rank):
        o, m, l = tc_splits(q_comb, rows, valid, scale)
        part = Partial(o[0], m[0], l[0]) if o.shape[0] == 1 else \
            Partial(*merge_splits(o, m, l))
    else:
        part = Partial(*general_attend(q_comb, rows, valid, scale, rank))
    partial_attend.launches += 1
    key = (Q, rows.shape[-2])
    partial_attend.launches_by_shape[key] = \
        partial_attend.launches_by_shape.get(key, 0) + 1
    return part


def general_attend(q_comb: torch.Tensor, rows: torch.Tensor,
                   valid: torch.Tensor, scale: float, rank: int):
    """Launch the general CUDA-core kernel (fp32 or bf16, any D % 4 == 0
    up to 1024, rank <= 512); returns ``(o, m, l)``."""
    B, Q, H, D = q_comb.shape
    if D % 4 or D > _MAX_D or rank > _MAX_RANK or rank > D:
        raise ValueError(f"partial_attend: D={D} must be a multiple of 4 "
                         f"<= {_MAX_D}, rank={rank} <= min(D, {_MAX_RANK})")
    K = rows.shape[-2]
    q_comb = q_comb.contiguous()
    rows = rows.contiguous()
    if rows.shape[-1] != D or rows.data_ptr() % 16:
        raise ValueError("partial_attend: rows must be [.., K, D] and "
                         "16-byte aligned")
    if rows.dim() == 3:
        rb, rq = K * D, 0
        valid = valid.expand(B, K).contiguous()
        vb, vq = K, 0
    else:
        if rows.shape[:2] != (B, Q):
            raise ValueError(f"partial_attend: rows {tuple(rows.shape)} "
                             f"vs q {tuple(q_comb.shape)}")
        rb, rq = Q * K * D, K * D
        valid = valid.expand(B, Q, K).contiguous()
        vb, vq = Q * K, K
    o = torch.empty((B, Q, H, rank), dtype=torch.float32,
                    device=q_comb.device)
    m = torch.empty((B, Q, H), dtype=torch.float32, device=q_comb.device)
    l = torch.empty((B, Q, H), dtype=torch.float32, device=q_comb.device)
    lib = _lib()
    _build.check(lib, lib.ess_sparse_mla_partial(
        _P(q_comb.data_ptr()), _P(rows.data_ptr()), _P(valid.data_ptr()),
        _P(o.data_ptr()), _P(m.data_ptr()), _P(l.data_ptr()), B, Q, H, K, D,
        rank, float(scale), rb, rq, vb, vq, _DTYPES[q_comb.dtype],
        _build.stream_ptr(o)), "sparse_mla_partial")
    partial_attend.launches_general += 1
    return o, m, l


partial_attend.launches = 0
partial_attend.launches_tc = 0
partial_attend.launches_general = 0
partial_attend.launches_by_shape = {}
merge_splits.launches = 0


def sparse_mla_gather_attend(q_comb: torch.Tensor, latent_cache: torch.Tensor,
                             ids: torch.Tensor, valid_s: torch.Tensor,
                             scale: float, rank: int) -> torch.Tensor:
    """Gather the top-k rows, then attend; the normalized output
    ``o / max(l, 1e-30)`` in ``q_comb``'s dtype.

    q_comb [B,Q,H,D], latent_cache [B,S,D] (device memory on CUDA), ids
    [B,Q,K] in ``[0, S)``, valid_s [B,S] (or per query [B,Q,S]) bool.
    The rows ``[B,Q,K,D]`` come from one ``gather_rows`` launch over the
    flattened ``[B*S, D]`` cache (the ids offset by ``b * S``: top-k ids
    are in range, so none is clipped or dropped), their validity is
    ``valid_s`` at the ids, and one :func:`partial_attend` (plus its split
    merge) attends to them."""
    from repro_torch.kernels.gather_cache import ops as gops
    B, Q, K = ids.shape
    S, D = latent_cache.shape[1:]
    flat = ids.reshape(B, Q * K) + torch.arange(
        0, B * S, S, device=ids.device)[:, None]
    rows = gops.gather_rows(latent_cache.reshape(B * S, D),
                            flat.view(-1)).view(B, Q, K, D)
    if valid_s.dim() == 2:
        valid_s = valid_s[:, None].expand(B, Q, valid_s.shape[-1])
    gvalid = valid_s.gather(2, ids)
    p = partial_attend(q_comb, rows, gvalid, scale, rank)
    return (p.o / p.l.clamp_min(1e-30)[..., None]).to(q_comb.dtype)
