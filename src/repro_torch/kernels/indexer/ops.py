"""Wrappers of the lightning-indexer scoring kernels.

CPU tensors run the plain version (:mod:`.ref`); CUDA tensors launch a
kernel or raise.  Two kernels compute the same scores, chosen by shape
and dtype (:func:`tc_route`):

* ``csrc/indexer_tc.cu`` — bf16 at Di = 128 and Hi a multiple of 64 up to
  256 (the serve's widths): TMA-fed 64-key tiles on wgmma, query groups
  and key spans from :func:`tc_plan`, tiles with no valid key skipped;
* ``csrc/indexer.cu`` — every other shape or dtype (fp32 params, small
  widths): the general CUDA-core kernel.

``indexer_scores.launches`` counts every launch, ``.launches_tc`` /
``.launches_general`` each route's own, and ``.launches_by_q`` each query
count Q's (1 at decode, the chunk's length at prefill).

:func:`topk_select` is the DSA selection stage: the scores kernel, then
the exact top-k with ``lax.top_k``'s tie order (a stable descending sort:
the lowest index wins among equal scores; ``torch.topk`` on CUDA does not
promise that order).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.indexer import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DI = 184            # staged queries: 64 heads x Di fp32 <= 48 KB
_READY: set = set()

# the tensor-core route's shapes (csrc/indexer_tc.cu)
TC_DI, TC_HEADS, TC_TILE, TC_MAX_COLS = 128, 64, 64, 256
MAX_SPAN_TILES = 1024    # tiles one CTA walks (its live list in smem)


def _lib() -> ctypes.CDLL:
    lib = _build.load("indexer")
    if "indexer" not in _READY:
        lib.ess_indexer_scores.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _I64, _I64, _I, _P]
        lib.ess_indexer_scores.restype = ctypes.c_int
        _READY.add("indexer")
    return lib


def _tc_lib() -> ctypes.CDLL:
    lib = _build.load("indexer_tc")
    if "indexer_tc" not in _READY:
        lib.ess_indexer_tc.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                       _I64, _I64, _I, _I, _I, _P]
        lib.ess_indexer_tc.restype = ctypes.c_int
        _READY.add("indexer_tc")
    return lib


def tc_route(q: torch.Tensor, keys: torch.Tensor) -> bool:
    """Whether :func:`indexer_scores` takes the tensor-core kernel: bf16
    queries and keys, Di = 128 and Hi % 64 == 0 with Hi <= 256 (one wgmma
    holds a query's heads).  A routing by shape and dtype, not a fallback:
    every other call on CUDA takes the general kernel, and a failure of
    either kernel raises."""
    if q.dim() != 4 or keys.dim() != 3:
        return False
    Hi = q.shape[2]
    return (q.dtype == torch.bfloat16 and keys.dtype == torch.bfloat16
            and q.shape[3] == TC_DI and keys.shape[2] == TC_DI
            and Hi % TC_HEADS == 0 and 0 < Hi <= TC_MAX_COLS)


@functools.lru_cache(maxsize=256)
def tc_plan(B: int, Q: int, S: int, Hi: int, n_sm: int
            ) -> tuple[int, int, int]:
    """``(nq, tiles_per_span, nspans)`` of the tensor-core kernel's grid.

    A CTA holds ``nq`` queries of one b (``nq * Hi`` wgmma columns, at most
    256; ``nq`` in 1, 2, 4) and walks one span of 64-key tiles.  Query
    groups alone fill the card at a prefill chunk (Q = 256: 64 groups per
    slot); below ``n_sm`` CTAs the keys are cut into ``nspans`` spans of
    ``tiles_per_span`` whole tiles so that about ``n_sm`` CTAs run, and
    never more than ``MAX_SPAN_TILES`` tiles a span.  Span ``y`` covers
    tiles ``[y * tiles_per_span, min(ntiles, (y + 1) * tiles_per_span))``,
    every span non-empty.  Cached: a serve asks for a handful of shapes
    on every layer."""
    nq = 1
    while nq < 4 and 2 * nq <= Q and 2 * nq * Hi <= TC_MAX_COLS:
        nq *= 2
    ntiles = max(1, -(-S // TC_TILE))
    ctas = max(1, B * -(-Q // nq))
    nspans = max(1, min(ntiles, -(-n_sm // ctas)),
                 -(-ntiles // MAX_SPAN_TILES))
    per = -(-ntiles // nspans)
    return nq, per, -(-ntiles // per)


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(q, w, keys):
    B, Q, Hi, Di = q.shape
    S = keys.shape[1]
    if keys.shape != (B, S, Di) or w.shape != (B, Q, Hi):
        raise ValueError(f"indexer_scores: shapes q {tuple(q.shape)} "
                         f"w {tuple(w.shape)} keys {tuple(keys.shape)}")
    if q.dtype not in _DTYPES or w.dtype != q.dtype or keys.dtype != q.dtype:
        raise ValueError(f"indexer_scores: q/w/keys must share fp32 or bf16 "
                         f"({q.dtype}, {w.dtype}, {keys.dtype})")
    if q.device.type != "cuda" or w.device != q.device \
            or keys.device != q.device:
        raise ValueError(f"indexer_scores: q, w and keys must lie on one "
                         f"CUDA device ({q.device}, {w.device}, "
                         f"{keys.device})")
    q, w, keys = q.contiguous(), w.contiguous(), keys.contiguous()
    if keys.data_ptr() % 16:
        raise ValueError("indexer_scores: keys must be 16-byte aligned")
    return q, w, keys


def _valid_args(valid, q, S):
    """``(valid [B,Q,S] view or None, vb, vq)``: the flag of (b, q, s) at
    ``b * vb + q * vq + s`` (broadcast dims keep stride 0)."""
    if valid is None:
        return None, 0, 0
    B, Q = q.shape[:2]
    if valid.dtype != torch.bool or valid.device != q.device:
        raise ValueError("indexer_scores: valid must be a bool tensor on "
                         "the queries' device")
    if valid.dim() == 2:
        valid = valid[:, None, :]
    if valid.shape != (B, Q, S):          # the serve's masks already are
        valid = valid.expand(B, Q, S)
    if valid.stride(2) != 1:
        valid = valid.contiguous()
    vb, vq, _ = valid.stride()
    return valid, vb, vq


def indexer_scores(q: torch.Tensor, w: torch.Tensor, keys: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,Q,Hi,Di], w [B,Q,Hi], keys [B,S,Di], valid [B,S] / [B,Q,S] bool
    (or None: every key valid) -> scores [B,Q,S] fp32, ``-2e38`` where
    invalid.  On CUDA, :func:`tc_route` picks the kernel."""
    if q.device.type == "cpu":
        return ref.indexer_scores_ref(q, w, keys, valid)
    if q.device.type != "cuda":
        raise ValueError(f"indexer_scores: unsupported device {q.device}")
    out = _tc_launch(q, w, keys, valid) if tc_route(q, keys) else \
        general_scores(q, w, keys, valid)
    indexer_scores.launches += 1
    by_q, Q = indexer_scores.launches_by_q, q.shape[1]
    by_q[Q] = by_q.get(Q, 0) + 1
    return out


def topk_select(q: torch.Tensor, w: torch.Tensor, keys: torch.Tensor,
                valid: torch.Tensor | None, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Scores + top-k in one call: ``(vals [B,Q,k] fp32, ids [B,Q,k])``,
    the k largest of :func:`indexer_scores` (``-2e38`` where ``valid`` is
    False, so invalid keys come last) in descending order, ties in index
    order.  One indexer launch on CUDA; the plain scores on the CPU."""
    from repro_torch.models.mla import topk_desc
    sc = indexer_scores(q, w, keys, valid)
    ids = topk_desc(sc, k)
    return sc.gather(-1, ids), ids


def _tc_launch(q, w, keys, valid):
    q, w, keys = _check(q, w, keys)
    if q.data_ptr() % 16:
        raise ValueError("indexer_scores (tc): q must be 16-byte aligned")
    if w.data_ptr() % 4:                # read as bf16 pairs
        raise ValueError("indexer_scores (tc): w must be 4-byte aligned")
    B, Q, Hi, _ = q.shape
    S = keys.shape[1]
    valid, vb, vq = _valid_args(valid, q, S)
    nq, per, nspans = tc_plan(B, Q, S, Hi, _n_sm(q.device.index))
    out = torch.empty((B, Q, S), dtype=torch.float32, device=q.device)
    lib = _tc_lib()
    _build.check(lib, lib.ess_indexer_tc(
        _P(q.data_ptr()), _P(w.data_ptr()), _P(keys.data_ptr()),
        _P(None if valid is None else valid.data_ptr()), _P(out.data_ptr()),
        B, Q, S, Hi, vb, vq, nq, per, nspans, _build.stream_ptr(out)),
        "indexer_tc")
    indexer_scores.launches_tc += 1
    return out


def general_scores(q: torch.Tensor, w: torch.Tensor, keys: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the general CUDA-core kernel (fp32 or bf16, any Hi, Di a
    multiple of 8 up to 184)."""
    q, w, keys = _check(q, w, keys)
    B, Q, Hi, Di = q.shape
    S = keys.shape[1]
    if Di % 8 or Di > _MAX_DI:
        raise ValueError(f"indexer_scores: Di={Di} must be a multiple of 8 "
                         f"and <= {_MAX_DI}")
    valid, vb, vq = _valid_args(valid, q, S)
    out = torch.empty((B, Q, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    _build.check(lib, lib.ess_indexer_scores(
        _P(q.data_ptr()), _P(w.data_ptr()), _P(keys.data_ptr()),
        _P(None if valid is None else valid.data_ptr()), _P(out.data_ptr()),
        B, Q, S, Hi, Di, vb, vq, _DTYPES[q.dtype], _build.stream_ptr(out)),
        "indexer_scores")
    indexer_scores.launches_general += 1
    return out


indexer_scores.launches = 0
indexer_scores.launches_tc = 0
indexer_scores.launches_general = 0
indexer_scores.launches_by_q = {}
