"""Wrapper of the lightning-indexer scoring kernel.

CPU tensors run the plain version (:mod:`.ref`); CUDA tensors launch the
kernel or raise.  ``indexer_scores.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.indexer import ref

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_DI = 184            # staged queries: 64 heads x Di fp32 <= 48 KB
_READY: set = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load("indexer")
    if "indexer" not in _READY:
        lib.ess_indexer_scores.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _I64, _I64, _I, _P]
        lib.ess_indexer_scores.restype = ctypes.c_int
        _READY.add("indexer")
    return lib


def indexer_scores(q: torch.Tensor, w: torch.Tensor, keys: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """q [B,Q,Hi,Di], w [B,Q,Hi], keys [B,S,Di], valid [B,S] / [B,Q,S] bool
    (or None: every key valid) -> scores [B,Q,S] fp32, ``-2e38`` where
    invalid."""
    if q.device.type == "cpu":
        return ref.indexer_scores_ref(q, w, keys, valid)
    if q.device.type != "cuda":
        raise ValueError(f"indexer_scores: unsupported device {q.device}")
    B, Q, Hi, Di = q.shape
    S = keys.shape[1]
    if keys.shape != (B, S, Di) or w.shape != (B, Q, Hi):
        raise ValueError(f"indexer_scores: shapes q {tuple(q.shape)} "
                         f"w {tuple(w.shape)} keys {tuple(keys.shape)}")
    if q.dtype not in _DTYPES or w.dtype != q.dtype or keys.dtype != q.dtype:
        raise ValueError(f"indexer_scores: q/w/keys must share fp32 or bf16 "
                         f"({q.dtype}, {w.dtype}, {keys.dtype})")
    if Di % 8 or Di > _MAX_DI:
        raise ValueError(f"indexer_scores: Di={Di} must be a multiple of 8 "
                         f"and <= {_MAX_DI}")
    q, w, keys = q.contiguous(), w.contiguous(), keys.contiguous()
    if keys.data_ptr() % 16:
        raise ValueError("indexer_scores: keys must be 16-byte aligned")
    vptr, vb, vq = None, 0, 0
    if valid is not None:
        if valid.dtype != torch.bool or valid.device != q.device:
            raise ValueError("indexer_scores: valid must be a bool tensor "
                             "on the queries' device")
        if valid.dim() == 2:
            valid = valid[:, None, :]
        # expand gives broadcast dims stride 0, which the kernel honours
        valid = valid.expand(B, Q, S)
        if valid.stride(2) != 1:
            valid = valid.contiguous()
        vb, vq = valid.stride(0), valid.stride(1)
        vptr = valid.data_ptr()
    out = torch.empty((B, Q, S), dtype=torch.float32, device=q.device)
    lib = _lib()
    _build.check(lib, lib.ess_indexer_scores(
        _P(q.data_ptr()), _P(w.data_ptr()), _P(keys.data_ptr()), _P(vptr),
        _P(out.data_ptr()), B, Q, S, Hi, Di, vb, vq, _DTYPES[q.dtype],
        _build.stream_ptr(out)), "indexer_scores")
    indexer_scores.launches += 1
    return out


indexer_scores.launches = 0
