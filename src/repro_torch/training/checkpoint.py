"""Atomic, verified checkpoints in the reference's on-disk format (the
port's own copy of ``repro.training.checkpoint``), so a checkpoint written
by either package restores in the other.

A checkpoint of step ``n`` is the directory ``step_{n:08d}`` holding one
``.npy`` file a leaf and ``manifest.json``,
``{"step": n, "leaves": {key: {"file", "shape", "dtype", "crc"}}}``:

* a leaf's key joins its path with ``///``: dict keys, ``.m`` / ``.v`` /
  ``.step`` for ``OptState``'s fields (:mod:`.tree`), sequence indices;
* its file is ``{crc32(key):08x}.npy``, its ``crc`` the crc32 of the
  array's bytes, checked on restore;
* a dtype numpy lacks (bf16, fp8) is stored as its raw bits, a ``'<V2'``
  (``'<V1'``) array, with the dtype's name (``"bfloat16"``) in the
  manifest: what ``np.save`` writes for the reference's ``ml_dtypes``
  arrays, read here from the 16-bit patterns (``ml_dtypes`` is not
  needed).

Writes land in ``step_{n:08d}.tmp``, renamed only after the manifest is
flushed to disk: a crash mid-save never leaves a partial checkpoint under
the final name.  :class:`AsyncSaver` copies the leaves to host memory on
the caller's thread and writes them on a thread of its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import zlib
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.params import VIEW_DTYPES
from repro_torch.training.tree import flatten, tree_map, unflatten

SEP = "///"

# torch's integer view of each raw-bits dtype, by width
_INT_VIEW = {2: torch.int16, 1: torch.uint8}


@dataclasses.dataclass
class HostLeaf:
    """A leaf copied to host memory: ``array`` holds its bytes (the raw
    bits, as unsigned ints, for a dtype numpy lacks); ``dtype`` is the
    manifest's name for it."""
    array: np.ndarray
    dtype: str


def _key(path: tuple) -> str:
    return SEP.join(str(p) for p in path)


def to_host(leaf: Any) -> HostLeaf:
    """A tensor (any device; the copy waits for it) or a host array."""
    if isinstance(leaf, HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in VIEW_DTYPES:
            view = VIEW_DTYPES[name][0]
            return HostLeaf(t.view(_INT_VIEW[t.element_size()]).numpy()
                            .view(view), name)
        return HostLeaf(t.numpy(), str(t.numpy().dtype))
    arr = np.asarray(leaf, order="C")
    return HostLeaf(arr, str(arr.dtype))


def _write_npy(file: str, h: HostLeaf) -> None:
    with open(file, "wb") as f:
        if h.dtype in VIEW_DTYPES:
            np.lib.format.write_array_header_1_0(f, {
                "descr": f"<V{h.array.itemsize}", "fortran_order": False,
                "shape": h.array.shape})
            f.write(h.array.tobytes())
        else:
            np.save(f, h.array)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr, order="C")            # a copy torch may own
    if dtype in VIEW_DTYPES:
        view, tdt = VIEW_DTYPES[dtype]
        return torch.from_numpy(arr.view(view)).view(tdt)
    return torch.from_numpy(arr)


def save(path: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Synchronous atomic save; keeps the newest ``keep`` checkpoints.
    Returns the checkpoint's directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest: dict[str, Any] = {"step": step, "leaves": {}}
    for p, leaf in flatten(tree):
        key = _key(p)
        h = to_host(leaf)
        fn = f"{zlib.crc32(key.encode()):08x}.npy"
        _write_npy(os.path.join(tmp, fn), h)
        manifest["leaves"][key] = {
            "file": fn, "shape": list(h.array.shape), "dtype": h.dtype,
            "crc": zlib.crc32(h.array.tobytes()) & 0xFFFFFFFF,
        }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(path, keep)
    return final


class AsyncSaver:
    """A snapshot to host memory on the caller's thread, then the write on
    a thread of its own; at most one in flight.  A failed write raises
    from the next :meth:`wait` (or :meth:`save`)."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path: str, step: int, tree: Any, keep: int = 3) -> None:
        self.wait()
        snapshot = tree_map(to_host, tree)
        self._thread = threading.Thread(
            target=self._write, args=(path, step, snapshot, keep),
            daemon=True)
        self._thread.start()

    def _write(self, path, step, snapshot, keep):
        try:
            save(path, step, snapshot, keep=keep)
        except BaseException as e:       # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def _steps(path: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(path)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(path: str) -> int | None:
    if not os.path.isdir(path):
        return None
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, step: int | None, like: Any,
            device_fn: Callable[[str, tuple], Any] | None = None) -> Any:
    """The checkpoint of ``step`` (the latest when None) in the structure
    of ``like``, each leaf a tensor of the stored dtype.  A leaf goes to
    the device of ``like``'s leaf (the CPU where that is no tensor) unless
    ``device_fn(key, shape)`` names another (the counterpart of the
    reference's ``sharding_fn``).  Raises ``KeyError`` for a missing leaf
    and ``IOError`` for a shard whose crc32 does not match."""
    if step is None:
        step = latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for p, leaf in flatten(like):
        key = _key(p)
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = np.load(os.path.join(d, meta["file"]))
        if (zlib.crc32(arr.tobytes()) & 0xFFFFFFFF) != meta["crc"]:
            raise IOError(f"checkpoint corruption in {key}")
        dev = device_fn(key, arr.shape) if device_fn is not None else None
        if dev is None:
            dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(_from_host(arr, meta["dtype"]).to(dev))
    return unflatten(like, out)


def _gc(path: str, keep: int) -> None:
    for s in _steps(path)[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)
