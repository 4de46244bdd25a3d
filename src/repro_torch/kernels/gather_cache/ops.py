"""Wrappers of the UVA row / page gather (plain and fused dequant) and
row scatter kernels.

On CPU tensors they run the plain versions in :mod:`.ref`; on CUDA tensors
they launch the kernels or raise.  The cache/tier side may be a CUDA
tensor or a **pinned** host tensor, which the kernel reads (or writes)
through its UVA device pointer.  Each wrapper counts its launches in a
plain integer attribute, ``gather_rows.launches``.

The row gathers take one of two routes, by :func:`staged_route` (the
shapes, and whether the source is host memory): *direct*, one warp per
id reading its row over the link (or from device memory), or
*staged*, where each distinct row crosses the link once per launch into a
device staging buffer that is then expanded to the ids.  Their counters
split ``launches`` into ``launches_direct`` and ``launches_staged``.
:func:`gather_rows_raw` is the direct route without widening: a quantized
tier's payload and scale in one launch (the pipelined round's slab).

The page kernels move whole pages (``block_rows`` rows) over every layer in
one launch, by TMA bulk copies through a shared-memory ring:
:func:`gather_pages` (by source ids, a quantized tier's scale plane raw in
the same launch, into device memory or pinned host memory) and its inverse
:func:`put_pages` (to destination ids: the PD migration's install) share
one kernel; :func:`gather_pages_dequant` widens as it goes.
:func:`probe_link_read` measures the link's read rate by either kind of
SM read (measurement only).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import PLAIN_DEVICES, _build, refuse_dtensors
from repro_torch.kernels.gather_cache import ref

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_READY: set = set()
# payload and output kinds of the dequant kernels
_QKIND = {torch.int8: 0, torch.float8_e4m3fn: 1}
_OKIND = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = _build.load("gather_cache")
    if "gather_cache" not in _READY:
        lib.ess_uva_pointer.argtypes = [_P, ctypes.POINTER(_P)]
        lib.ess_uva_pointer.restype = ctypes.c_int
        lib.ess_gather_rows.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P,
                                        _P]
        lib.ess_gather_rows.restype = ctypes.c_int
        lib.ess_gather_rows_staged.argtypes = [_P, _P, _P, _P, _P, _I64,
                                               _I64, _I64, _P, _P]
        lib.ess_gather_rows_staged.restype = ctypes.c_int
        lib.ess_gather_rows_raw.argtypes = [_P, _P, _P, _P, _P, _I64, _I64,
                                            _I64, _P, _P]
        lib.ess_gather_rows_raw.restype = ctypes.c_int
        lib.ess_scatter_rows.argtypes = [_P, _P, _P, _I64, _I64, _I64, _P]
        lib.ess_scatter_rows.restype = ctypes.c_int
        lib.ess_gather_rows_dequant.argtypes = [
            _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P, _P]
        lib.ess_gather_rows_dequant.restype = ctypes.c_int
        lib.ess_gather_rows_dequant_staged.argtypes = [
            _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P, _P]
        lib.ess_gather_rows_dequant_staged.restype = ctypes.c_int
        lib.ess_copy_pages.argtypes = [_P, _P, _P, _I64, _P, _P, _P, _I64,
                                       _I64, _I64, _I64, _I64, _P]
        lib.ess_copy_pages.restype = ctypes.c_int
        lib.ess_probe_bulk_read.argtypes = [_P, _I64, _I, _I, _P, _P]
        lib.ess_probe_bulk_read.restype = ctypes.c_int
        lib.ess_probe_lsu_read.argtypes = [_P, _I64, _I, _P, _P]
        lib.ess_probe_lsu_read.restype = ctypes.c_int
        lib.ess_gather_pages_dequant.argtypes = [
            _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I, _I, _P]
        lib.ess_gather_pages_dequant.restype = ctypes.c_int
        _READY.add("gather_cache")
    return lib


# UVA device address of each pinned host storage seen, by its host base.
# A hit is used only while the storage is still pinned, so a base that was
# unpinned and reused by ordinary memory raises instead of being read.
_UVA: dict[int, int] = {}


def device_pointer(t: torch.Tensor) -> int:
    """Address the card dereferences for ``t``: its own pointer on CUDA, the
    UVA mapping of its page-locked storage on the host (raises if the host
    tensor is not pinned).  The mapping is looked up once per storage."""
    if t.is_cuda:
        return t.data_ptr()
    if not t.is_pinned():
        raise ValueError("host tier must be pinned (page-locked) memory "
                         "for the UVA kernels; allocate it with "
                         "pin_memory=True")
    base = t.untyped_storage().data_ptr()
    dev = _UVA.get(base)
    if dev is None:
        lib = _lib()
        ptr = _P()
        _build.check(lib, lib.ess_uva_pointer(_P(base), ctypes.byref(ptr)),
                     "cudaHostGetDevicePointer")
        dev = _UVA[base] = ptr.value
    return dev + (t.data_ptr() - base)


def staged_route(m: int, s: int, host: bool = True) -> bool:
    """The row gathers' route rule: stage when the launch's ``m`` ids
    outnumber the ``s`` rows of the host tier view they index, so that
    ids repeat (by pigeonhole) and each repeat would cross the link again.
    The prefill's per-query fetch takes it; the decode miss fetch and the
    warmup replay (``m <= s``) read directly.  A source in device memory
    (``host=False``: the monolithic model's latent cache) always reads
    directly: its repeats hit L2, and staging measured no faster there
    (PERF.md section 6)."""
    return host and m > s


def _count_ptr(fetched: torch.Tensor | None, device) -> _P:
    if fetched is None:
        return _P(None)
    if fetched.dtype != torch.int32 or fetched.device != device:
        raise ValueError("fetched must be an int32 tensor on the ids' device")
    return _P(fetched.data_ptr())


def _check_rows(t: torch.Tensor, what: str, *, vec16: bool = True) -> int:
    if t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{what} must be a contiguous [N, D] tensor")
    row_bytes = t.shape[1] * t.element_size()
    if vec16 and (row_bytes % 16 or t.data_ptr() % 16):
        raise ValueError(f"{what}: rows must be 16-byte multiples and "
                         f"16-byte aligned (row of {row_bytes} B)")
    return row_bytes


def _is_float(dt: torch.dtype) -> bool:
    """A float dtype that plain casts reach (not a quantized fp8 payload)."""
    return dt.is_floating_point and dt.itemsize >= 2


def _out_rows(out: torch.Tensor | None, ids: torch.Tensor, D: int, dtype
              ) -> torch.Tensor:
    """The ``[m, D]`` rows a gather writes: a new tensor, or the caller's
    ``out`` (``[..., D]`` of ``ids``' shape, contiguous, on ``ids``'
    device, of the result's dtype), viewed flat."""
    if out is None:
        return torch.empty((ids.numel(), D), dtype=dtype, device=ids.device)
    if (out.shape != (*ids.shape, D) or out.dtype != dtype
            or out.device != ids.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {dtype} tensor of shape "
                         f"{(*ids.shape, D)} on {ids.device}, got "
                         f"{out.dtype} {tuple(out.shape)} on {out.device}")
    return out.view(-1, D)


def _into(out: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor
          ) -> torch.Tensor:
    """The plain versions' ``out=``: the rows copied into ``out``."""
    return _out_rows(out, ids, rows.shape[-1], rows.dtype).copy_(
        rows.reshape(-1, rows.shape[-1])).view(rows.shape)


def _flat_ids(cache: torch.Tensor, ids: torch.Tensor):
    """Batched [B,S,D] cache + [B,M] ids -> flat [B*S,D] view + flat ids."""
    if cache.dim() == 2:
        return cache, ids
    B, S, D = cache.shape
    off = torch.arange(B, device=ids.device)[:, None] * S
    flat = torch.where(ids >= 0, ids.clamp(0, S - 1) + off, -1)
    return cache.reshape(B * S, D), flat


def _pick_route(route: str | None, m: int, s: int, host: bool) -> bool:
    """Whether a row gather stages: :func:`staged_route`'s rule, or the
    route a caller names (``"staged"`` / ``"direct"``: both routes timed
    and tested on the same ids)."""
    if route is None:
        return staged_route(m, s, host)
    if route not in ("staged", "direct"):
        raise ValueError(f"route={route!r}: staged | direct | None")
    return route == "staged"


def gather_rows(cache: torch.Tensor, ids: torch.Tensor, *,
                fetched: torch.Tensor | None = None,
                out: torch.Tensor | None = None,
                route: str | None = None) -> torch.Tensor:
    """cache [S,D] (or [B,S,D]), ids [...] (or [B,M]) -> rows [..., D] on
    ``ids.device``: ``cache[clip(ids)]``, zero rows where ``ids < 0``.

    ``fetched`` (an int32 tensor beside ``ids``, optional) gains the number
    of cache rows the call read: each live id's on the direct route, each
    distinct row once on the staged route (:func:`staged_route`, or
    ``route``).  ``out`` (optional, ``[..., D]`` of ``ids``' shape)
    receives the rows: memory the caller allocated, on the stream that
    consumes them."""
    refuse_dtensors("gather_rows", cache, ids, fetched, out)
    cache, ids = _flat_ids(cache, ids)
    m, s = ids.numel(), cache.shape[0]
    staged = _pick_route(route, m, s, not cache.is_cuda)
    if ids.device.type in PLAIN_DEVICES:
        if fetched is not None:
            fetched += ref.rows_read(ids, s, staged)
        rows = ref.gather_rows_ref(cache, ids)
        return rows if out is None else _into(out, rows, ids)
    if ids.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {ids.device}")
    row_bytes = _check_rows(cache, "gather_rows cache")
    idf = ids.reshape(-1).to(torch.int64).contiguous()
    rows = _out_rows(out, ids, cache.shape[1], cache.dtype)
    src = device_pointer(cache)
    cnt = _count_ptr(fetched, ids.device)
    lib = _lib()
    stream = _build.stream_ptr(rows)
    if staged:
        staging = torch.empty((s, cache.shape[1]), dtype=cache.dtype,
                              device=ids.device)
        flags = torch.empty(s, dtype=torch.int32, device=ids.device)
        rc = lib.ess_gather_rows_staged(
            _P(src), _P(idf.data_ptr()), _P(rows.data_ptr()),
            _P(staging.data_ptr()), _P(flags.data_ptr()), m, s, row_bytes,
            cnt, stream)
        gather_rows.launches_staged += 1
    else:
        rc = lib.ess_gather_rows(_P(src), _P(idf.data_ptr()),
                                 _P(rows.data_ptr()), m, s, row_bytes, cnt,
                                 stream)
        gather_rows.launches_direct += 1
    _build.check(lib, rc, "gather_rows")
    gather_rows.launches += 1
    return rows.view(*ids.shape, cache.shape[1])


gather_rows.launches = 0
gather_rows.launches_direct = 0
gather_rows.launches_staged = 0


def gather_rows_raw(cache: torch.Tensor, scales: torch.Tensor | None,
                    ids: torch.Tensor, *, out: torch.Tensor | None = None,
                    out_scales: torch.Tensor | None = None,
                    fetched: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The tier's stored bytes, not widened: cache [S,D] (bf16, or an
    int8/fp8 payload), scales [S,1] f16 or None, ids [...] -> ``(rows
    [..., D] of the cache's dtype, scales [..., 1] or None)`` on
    ``ids.device``; row ``clip(ids)``, zero rows and zero scales where
    ``ids < 0`` (those read nothing).  One launch of the direct route's
    warp per id moves the payload and its scale together (the pipelined
    round's staging slab, which dequantizes later at miss width).
    ``out`` / ``out_scales`` receive the results; ``fetched`` as
    :func:`gather_rows`."""
    refuse_dtensors("gather_rows_raw", cache, scales, ids, out, out_scales,
                    fetched)
    if scales is not None and (
            scales.dtype != torch.float16
            or scales.shape != (*cache.shape[:-1], 1)):
        raise ValueError("gather_rows_raw: scales must be f16 [..., 1], one "
                         "per row of the cache")
    D = cache.shape[-1]
    if ids.device.type in PLAIN_DEVICES:
        if fetched is not None:
            fetched += ref.rows_read(ids, cache.shape[0], False)
        rows, sc = ref.gather_rows_raw_ref(cache, scales, ids)
        return (rows if out is None else _into(out, rows, ids),
                sc if out_scales is None or sc is None
                else _into(out_scales, sc, ids))
    if ids.device.type != "cuda":
        raise ValueError(f"gather_rows_raw: unsupported device {ids.device}")
    row_bytes = _check_rows(cache, "gather_rows_raw cache")
    idf = ids.reshape(-1).to(torch.int64).contiguous()
    rows = _out_rows(out, ids, D, cache.dtype)
    sptr = optr = _P(None)
    srows = None
    if scales is not None:
        _check_rows(scales, "gather_rows_raw scales", vec16=False)
        srows = _out_rows(out_scales, ids, 1, scales.dtype)
        sptr, optr = _P(device_pointer(scales)), _P(srows.data_ptr())
    lib = _lib()
    _build.check(lib, lib.ess_gather_rows_raw(
        _P(device_pointer(cache)), sptr, _P(idf.data_ptr()),
        _P(rows.data_ptr()), optr, ids.numel(), cache.shape[0], row_bytes,
        _count_ptr(fetched, ids.device), _build.stream_ptr(rows)),
        "gather_rows_raw")
    gather_rows_raw.launches += 1
    return (rows.view(*ids.shape, D),
            None if srows is None else srows.view(*ids.shape, 1))


gather_rows_raw.launches = 0


def scatter_rows(dst: torch.Tensor, tgt: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """In place: ``dst[tgt[i]] = rows[i]`` for ``0 <= tgt[i] < len(dst)``;
    other rows drop.  dst [N,D] (CUDA or pinned host) with rows of any byte
    width (the 2-byte scale plane included), tgt [M], rows [M,D] on the
    same device as ``tgt``.  Returns ``dst``.

    Float rows are cast to a float ``dst``; a quantized (integer or fp8)
    ``dst`` takes only rows of its own dtype, so an unquantized row can
    never be truncated into the tier."""
    refuse_dtensors("scatter_rows", dst, tgt, rows)
    if rows.dtype != dst.dtype and not _is_float(dst.dtype):
        raise TypeError(f"scatter_rows: {rows.dtype} rows into a "
                        f"{dst.dtype} destination; quantize them first")
    if rows.device.type in PLAIN_DEVICES:
        return ref.scatter_rows_ref(dst, tgt, rows)
    if rows.device.type != "cuda" or tgt.device != rows.device:
        raise ValueError("scatter_rows: rows and tgt must share a CUDA device")
    row_bytes = _check_rows(dst, "scatter_rows dst", vec16=False)
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


def _check_quant(cache: torch.Tensor, scales: torch.Tensor, out_dtype,
                 what: str) -> None:
    if cache.dtype not in _QKIND or scales.dtype != torch.float16:
        raise ValueError(f"{what}: payload int8/float8_e4m3fn with f16 "
                         f"scales, got {cache.dtype} / {scales.dtype}")
    if out_dtype not in _OKIND:
        raise ValueError(f"{what}: out_dtype must be bf16 or fp32")
    if not scales.is_contiguous() or scales.shape != (*cache.shape[:-1], 1):
        raise ValueError(f"{what}: scales must be contiguous [..., 1], one "
                         f"per row of the payload")


def gather_rows_dequant(cache: torch.Tensor, scales: torch.Tensor,
                        ids: torch.Tensor, out_dtype=torch.bfloat16, *,
                        fetched: torch.Tensor | None = None,
                        out: torch.Tensor | None = None) -> torch.Tensor:
    """Fused quantized-tier gather: cache [S,D] int8/fp8, scales [S,1] f16,
    ids [...] -> rows [..., D] ``out_dtype`` on ``ids.device``:
    ``float(q) * float(s)`` of row ``clip(ids)``, zero rows where
    ``ids < 0``.  Routes, ``fetched`` and ``out`` as :func:`gather_rows`;
    the staged route widens each distinct row once."""
    refuse_dtensors("gather_rows_dequant", cache, scales, ids, fetched, out)
    _check_quant(cache, scales, out_dtype, "gather_rows_dequant")
    m, s = ids.numel(), cache.shape[0]
    if ids.device.type in PLAIN_DEVICES:
        if fetched is not None:
            fetched += ref.rows_read(ids, s, staged_route(m, s))
        rows = ref.gather_rows_dequant_ref(cache, scales, ids, out_dtype)
        return rows if out is None else _into(out, rows, ids)
    if ids.device.type != "cuda":
        raise ValueError(f"gather_rows_dequant: unsupported device "
                         f"{ids.device}")
    _check_rows(cache, "gather_rows_dequant cache")
    idf = ids.reshape(-1).to(torch.int64).contiguous()
    D = cache.shape[1]
    rows = _out_rows(out, ids, D, out_dtype)
    src, sc = device_pointer(cache), device_pointer(scales)
    cnt = _count_ptr(fetched, ids.device)
    lib = _lib()
    stream = _build.stream_ptr(rows)
    kinds = (_QKIND[cache.dtype], _OKIND[out_dtype])
    if staged_route(m, s):
        staging = torch.empty((s, D), dtype=out_dtype, device=ids.device)
        flags = torch.empty(s, dtype=torch.int32, device=ids.device)
        rc = lib.ess_gather_rows_dequant_staged(
            _P(src), _P(sc), _P(idf.data_ptr()), _P(rows.data_ptr()),
            _P(staging.data_ptr()), _P(flags.data_ptr()), m, s, D, *kinds,
            cnt, stream)
        gather_rows_dequant.launches_staged += 1
    else:
        rc = lib.ess_gather_rows_dequant(
            _P(src), _P(sc), _P(idf.data_ptr()), _P(rows.data_ptr()), m, s,
            D, *kinds, cnt, stream)
        gather_rows_dequant.launches_direct += 1
    _build.check(lib, rc, "gather_rows_dequant")
    gather_rows_dequant.launches += 1
    return rows.view(*ids.shape, D)


gather_rows_dequant.launches = 0
gather_rows_dequant.launches_direct = 0
gather_rows_dequant.launches_staged = 0


def _page_args(cache: torch.Tensor, block_ids: torch.Tensor,
               block_rows: int):
    """[S,D] / [L,S,D] cache + [NB] / [L,NB] ids -> the [L,S,D] view, the
    [L,NB] int64 ids and the page count."""
    c3 = cache if cache.dim() == 3 else cache[None]
    Lh, S, _ = c3.shape
    if S % block_rows:
        raise ValueError(f"page gather: {S} rows are not whole pages of "
                         f"{block_rows}")
    ids = block_ids.to(torch.int64)
    ids = (ids if ids.dim() == 2 else ids[None]).expand(Lh, -1).contiguous()
    return c3, ids, S // block_rows


def _plane(t: torch.Tensor | None, shape: tuple, dtype, device, what: str
           ) -> torch.Tensor:
    """A page kernel's output plane: a new tensor on ``device``, or the
    caller's ``t`` (contiguous, of ``shape`` and ``dtype``; on the card or
    pinned on the host, which the kernel writes through its UVA
    pointer)."""
    if t is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or not t.is_contiguous()):
        raise ValueError(f"{what} must be a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    return t


def _check_scales(scales: torch.Tensor, c3: torch.Tensor, what: str
                  ) -> torch.Tensor:
    s3 = scales.reshape(*c3.shape[:-1], 1)
    if scales.dtype != torch.float16 or not scales.is_contiguous():
        raise ValueError(f"{what}: scales must be contiguous f16 [..., 1], "
                         f"one per row")
    return s3


def _copy_pages(src, src_sc, src_ids, dst, dst_sc, dst_ids, nb: int,
                block_rows: int, stream_of: torch.Tensor) -> None:
    """One launch of the page-copy kernel over every layer (see
    ``ess_copy_pages`` in ``csrc/gather_rows.cu``)."""
    Lh, _, D = src.shape
    row_bytes = _check_rows(src.reshape(-1, D), "page copy source")
    if src_sc is not None and block_rows % 8:
        raise ValueError(f"page copy with scales: {block_rows} rows a page "
                         f"is not a multiple of 8")

    def ptr(t):
        return _P(None) if t is None else _P(device_pointer(t))
    lib = _lib()
    _build.check(lib, lib.ess_copy_pages(
        ptr(src), ptr(src_sc), _P(None if src_ids is None
                                  else src_ids.data_ptr()),
        src.shape[1] // block_rows, ptr(dst), ptr(dst_sc),
        _P(None if dst_ids is None else dst_ids.data_ptr()),
        dst.shape[1] // block_rows, Lh, nb, block_rows, row_bytes,
        _build.stream_ptr(stream_of)), "copy_pages")


def gather_pages(cache: torch.Tensor, block_ids: torch.Tensor,
                 block_rows: int, *, scales: torch.Tensor | None = None,
                 out: torch.Tensor | None = None,
                 out_scales: torch.Tensor | None = None):
    """Whole-page gather: cache [S,D] (or [L,S,D]) of ``S / block_rows``
    pages, block_ids [NB] (or [L,NB], or [NB] for every layer) -> pages
    [NB*block_rows, D] (or [L, NB*block_rows, D]) of the cache's dtype on
    ``block_ids.device``.  Page ids are clipped to the pool; one launch
    covers every layer.

    ``scales`` (f16 ``[..., 1]``, one per row of the cache: a quantized
    tier's scale plane) moves in the same launch, raw, and the result is
    ``(pages, page_scales)``.  ``out`` / ``out_scales`` receive them: the
    caller's memory, on the card or pinned on the host (the kernel writes
    it through its UVA pointer)."""
    refuse_dtensors("gather_pages", cache, block_ids, scales, out,
                    out_scales)
    c3, ids, _ = _page_args(cache, block_ids, block_rows)
    Lh, _, D = c3.shape
    nb = ids.shape[1]
    shape = (Lh, nb * block_rows, D) if cache.dim() == 3 \
        else (nb * block_rows, D)
    s3 = None if scales is None else _check_scales(scales, c3,
                                                   "gather_pages")
    dev = block_ids.device
    if dev.type in PLAIN_DEVICES:
        got = ref.gather_pages_ref(c3, ids, block_rows)
        got_s = None if s3 is None else ref.gather_pages_ref(s3, ids,
                                                             block_rows)
        pages = got.view(shape) if out is None else out.copy_(got.view(shape))
        if s3 is None:
            return pages
        ss = shape[:-1] + (1,)
        return pages, (got_s.view(ss) if out_scales is None
                       else out_scales.copy_(got_s.view(ss)))
    if dev.type != "cuda":
        raise ValueError(f"gather_pages: unsupported device {dev}")
    pages = _plane(out, shape, c3.dtype, dev, "gather_pages out")
    sc = None if s3 is None else _plane(out_scales, shape[:-1] + (1,),
                                        torch.float16, dev,
                                        "gather_pages out_scales")
    _copy_pages(c3, s3, ids, pages.view(Lh, nb * block_rows, D),
                None if sc is None else sc.view(Lh, nb * block_rows, 1),
                None, nb, block_rows, ids)
    gather_pages.launches += 1
    return pages if sc is None else (pages, sc)


gather_pages.launches = 0


def put_pages(dst: torch.Tensor, dst_ids: torch.Tensor, src: torch.Tensor,
              block_rows: int, *, dst_scales: torch.Tensor | None = None,
              src_scales: torch.Tensor | None = None) -> torch.Tensor:
    """Whole-page write, the inverse of :func:`gather_pages`: page ``i`` of
    ``src`` [L, NB*block_rows, D] -> page ``dst_ids[l, i]`` of ``dst``
    [L, S, D] (``dst_ids`` [NB] for every layer, or [L, NB]); ids outside
    the pool drop.  ``src_scales`` -> ``dst_scales`` (f16 ``[..., 1]``)
    in the same launch.  In place, verbatim bits; returns ``dst``.  Either
    side may be on the card or pinned on the host; the launch runs on
    ``dst_ids``' device (the plain version for CPU ids)."""
    refuse_dtensors("put_pages", dst, dst_ids, src, dst_scales, src_scales)
    if src.dtype != dst.dtype:
        raise TypeError(f"put_pages: {src.dtype} pages into a {dst.dtype} "
                        f"destination")
    if (src_scales is None) != (dst_scales is None):
        raise ValueError("put_pages: scales on both sides or neither")
    Lh, S, D = dst.shape
    if S % block_rows or src.shape[1] % block_rows or src.shape[0] != Lh:
        raise ValueError(f"put_pages: src {tuple(src.shape)} / dst "
                         f"{tuple(dst.shape)} not whole pages of "
                         f"{block_rows} rows over the same layers")
    nb = src.shape[1] // block_rows
    ids = dst_ids.to(torch.int64)
    ids = (ids if ids.dim() == 2 else ids[None]).expand(Lh, nb).contiguous()
    if ids.device.type in PLAIN_DEVICES:
        ref.put_pages_ref(dst, ids, src, block_rows)
        if dst_scales is not None:
            ref.put_pages_ref(dst_scales, ids, src_scales, block_rows)
        return dst
    if ids.device.type != "cuda":
        raise ValueError(f"put_pages: unsupported device {ids.device}")
    if not (src.is_contiguous() and dst.is_contiguous()):
        raise ValueError("put_pages: src and dst must be contiguous")
    s_sc = None if src_scales is None else _check_scales(
        src_scales, src, "put_pages src")
    d_sc = None if dst_scales is None else _check_scales(
        dst_scales, dst, "put_pages dst")
    _copy_pages(src, s_sc, None, dst, d_sc, ids, nb, block_rows, ids)
    put_pages.launches += 1
    return dst


put_pages.launches = 0


def gather_pages_dequant(cache: torch.Tensor, scales: torch.Tensor,
                         block_ids: torch.Tensor, block_rows: int,
                         out_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`gather_pages` of a quantized tier, widened per row:
    cache [S,D] (or [L,S,D]) int8/fp8 + scales [S,1] (or [L,S,1]) f16 ->
    ``out_dtype`` pages ``float(q) * float(s)``."""
    refuse_dtensors("gather_pages_dequant", cache, scales, block_ids)
    _check_quant(cache, scales, out_dtype, "gather_pages_dequant")
    c3, ids, npages = _page_args(cache, block_ids, block_rows)
    Lh, S, D = c3.shape
    s3 = scales.reshape(Lh, S, 1)
    if block_ids.device.type in PLAIN_DEVICES:
        out = ref.gather_pages_dequant_ref(c3, s3, ids, block_rows,
                                           out_dtype)
    else:
        if block_ids.device.type != "cuda":
            raise ValueError(f"gather_pages_dequant: unsupported device "
                             f"{block_ids.device}")
        _check_rows(c3.reshape(-1, D), "gather_pages_dequant cache")
        nb = ids.shape[1]
        out = torch.empty((Lh, nb * block_rows, D), dtype=out_dtype,
                          device=block_ids.device)
        lib = _lib()
        _build.check(lib, lib.ess_gather_pages_dequant(
            _P(device_pointer(c3)), _P(device_pointer(s3)),
            _P(ids.data_ptr()), _P(out.data_ptr()), Lh, nb, npages,
            block_rows, D, _QKIND[c3.dtype], _OKIND[out_dtype],
            _build.stream_ptr(out)), "gather_pages_dequant")
        gather_pages_dequant.launches += 1
    return out if cache.dim() == 3 else out[0]


gather_pages_dequant.launches = 0


def probe_link_read(src: torch.Tensor, *, bulk_chunk: int = 0,
                    ctas_per_sm: int = 2, kb_in_flight: int = 16
                    ) -> torch.Tensor:
    """Measurement only (the link probe of ``tests/test_torch_cuda.py``):
    read every byte of ``src`` (on the card, or pinned on the host through
    its UVA pointer) once on the SMs, by TMA bulk copies of
    ``bulk_chunk`` bytes (``ctas_per_sm`` persistent CTAs an SM, four
    chunks in flight each) or, with ``bulk_chunk=0``, by 16-byte loads
    with ``kb_in_flight`` (16, 32 or 64) KB in flight an SM.  Returns the
    per-CTA sink (int64 on the card)."""
    nbytes = src.numel() * src.element_size()
    if nbytes % max(bulk_chunk, 16):
        raise ValueError("probe_link_read: bytes not whole chunks")
    sink = torch.zeros(1024, dtype=torch.int64, device="cuda")
    lib = _lib()
    stream = _build.stream_ptr(sink)
    if bulk_chunk:
        rc = lib.ess_probe_bulk_read(_P(device_pointer(src)), nbytes,
                                     bulk_chunk, ctas_per_sm,
                                     _P(sink.data_ptr()), stream)
    else:
        rc = lib.ess_probe_lsu_read(_P(device_pointer(src)), nbytes,
                                    kb_in_flight, _P(sink.data_ptr()),
                                    stream)
    _build.check(lib, rc, "probe_link_read")
    return sink
