"""Wrapper of the sparse-MLA partial kernel.

CPU tensors run the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise.  ``partial_attend.launches`` counts the launches.
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


def _lib() -> ctypes.CDLL:
    lib = _build.load("sparse_mla")
    if "sparse_mla" not in _READY:
        lib.ess_sparse_mla_partial.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, ctypes.c_float,
            _I64, _I64, _I64, _I64, _I, _P]
        lib.ess_sparse_mla_partial.restype = ctypes.c_int
        _READY.add("sparse_mla")
    return lib


def partial_attend(q_comb: torch.Tensor, rows: torch.Tensor,
                   valid: torch.Tensor, scale: float, rank: int):
    """Batched flash partials.

    q_comb [B,Q,H,D]; rows [B,K,D] (shared over Q) or [B,Q,K,D]; valid
    [B,K] / [B,Q,K] bool.  Returns ``Partial(o [B,Q,H,rank], m [B,Q,H],
    l [B,Q,H])`` in fp32, for :func:`repro_torch.models.mla.merge_partials`.
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
    if D % 4 or D > _MAX_D or rank > _MAX_RANK or rank > D:
        raise ValueError(f"partial_attend: D={D} must be a multiple of 4 "
                         f"<= {_MAX_D}, rank={rank} <= min(D, {_MAX_RANK})")
    if valid.dtype != torch.bool:
        raise ValueError("partial_attend: valid must be bool")
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
    partial_attend.launches += 1
    return Partial(o, m, l)


partial_attend.launches = 0
