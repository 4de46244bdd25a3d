"""Wrappers of the UVA row gather / scatter kernels.

On CPU tensors they run the plain versions in :mod:`.ref`; on CUDA tensors
they launch the kernels or raise.  The cache/tier side may be a CUDA
tensor or a **pinned** host tensor, which the kernel reads (or writes)
through its UVA device pointer.  Each wrapper counts its launches in a
plain integer attribute, ``gather_rows.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_cache import ref

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_READY: set = set()


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather_cache")
    if "gather_cache" not in _READY:
        lib.ess_uva_pointer.argtypes = [_P, ctypes.POINTER(_P)]
        lib.ess_uva_pointer.restype = ctypes.c_int
        lib.ess_gather_rows.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P]
        lib.ess_gather_rows.restype = ctypes.c_int
        lib.ess_scatter_rows.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P]
        lib.ess_scatter_rows.restype = ctypes.c_int
        _READY.add("gather_cache")
    return lib


def device_pointer(t: torch.Tensor) -> int:
    """Address the card dereferences for ``t``: its own pointer on CUDA, the
    UVA mapping of its page-locked storage on the host (raises if the host
    tensor is not pinned)."""
    if t.is_cuda:
        return t.data_ptr()
    if not t.is_pinned():
        raise ValueError("host tier must be pinned (page-locked) memory for "
                         "the UVA kernels; allocate it with pin_memory=True")
    lib = _lib()
    base = t.untyped_storage().data_ptr()
    dev = _P()
    _build.check(lib, lib.ess_uva_pointer(_P(base), ctypes.byref(dev)),
                 "cudaHostGetDevicePointer")
    return dev.value + (t.data_ptr() - base)


def _check_rows(t: torch.Tensor, what: str) -> int:
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous [N, D] tensor")
    row_bytes = t.shape[1] * t.element_size()
    if row_bytes % 16 or t.data_ptr() % 16:
        raise ValueError(f"{what}: rows must be 16-byte multiples and "
                         f"16-byte aligned (row of {row_bytes} B)")
    return row_bytes


def _flat_ids(cache: torch.Tensor, ids: torch.Tensor):
    """Batched [B,S,D] cache + [B,M] ids -> flat [B*S,D] view + flat ids."""
    if cache.dim() == 2:
        return cache, ids
    B, S, D = cache.shape
    off = torch.arange(B, device=ids.device)[:, None] * S
    flat = torch.where(ids >= 0, ids.clamp(0, S - 1) + off, -1)
    return cache.reshape(B * S, D), flat


def gather_rows(cache: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """cache [S,D] (or [B,S,D]), ids [...] (or [B,M]) -> rows [..., D] on
    ``ids.device``: ``cache[clip(ids)]``, zero rows where ``ids < 0``."""
    cache, ids = _flat_ids(cache, ids)
    if ids.device.type == "cpu":
        return ref.gather_rows_ref(cache, ids)
    if ids.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {ids.device}")
    row_bytes = _check_rows(cache, "gather_rows cache")
    idf = ids.reshape(-1).to(torch.int64).contiguous()
    out = torch.empty((idf.shape[0], cache.shape[1]), dtype=cache.dtype,
                      device=ids.device)
    src = device_pointer(cache)
    lib = _lib()
    _build.check(lib, lib.ess_gather_rows(
        _P(src), _P(idf.data_ptr()), _P(out.data_ptr()), idf.shape[0],
        cache.shape[0], row_bytes, _build.stream_ptr(out)), "gather_rows")
    gather_rows.launches += 1
    return out.reshape(*ids.shape, cache.shape[1])


gather_rows.launches = 0


def scatter_rows(dst: torch.Tensor, tgt: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """In place: ``dst[tgt[i]] = rows[i]`` for ``0 <= tgt[i] < len(dst)``;
    other rows drop.  dst [N,D] (CUDA or pinned host), tgt [M], rows [M,D]
    on the same device as ``tgt``.  Returns ``dst``."""
    if rows.device.type == "cpu":
        return ref.scatter_rows_ref(dst, tgt, rows)
    if rows.device.type != "cuda" or tgt.device != rows.device:
        raise ValueError("scatter_rows: rows and tgt must share a CUDA device")
    row_bytes = _check_rows(dst, "scatter_rows dst")
    rows = rows.to(dst.dtype).contiguous()
    tgt = tgt.reshape(-1).to(torch.int64).contiguous()
    if rows.shape != (tgt.shape[0], dst.shape[1]):
        raise ValueError(f"scatter_rows: rows {tuple(rows.shape)} vs "
                         f"tgt {tuple(tgt.shape)} / dst {tuple(dst.shape)}")
    dptr = device_pointer(dst)
    lib = _lib()
    _build.check(lib, lib.ess_scatter_rows(
        _P(dptr), _P(tgt.data_ptr()), _P(rows.data_ptr()), tgt.shape[0],
        dst.shape[0], row_bytes, _build.stream_ptr(rows)), "scatter_rows")
    scatter_rows.launches += 1
    return dst


scatter_rows.launches = 0
