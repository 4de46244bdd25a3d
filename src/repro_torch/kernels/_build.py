"""Build and load the CUDA kernels (nvcc -> shared library -> ctypes).

Each source (``csrc/*.cu``; sparse-MLA and the indexer have two each, the
general kernel and the tensor-core one) has a plain C interface (no
PyTorch headers, so ``nvcc`` takes seconds, not minutes).  The first call
to :func:`load` compiles every source at once, one ``nvcc`` process per
file, into ``kernels/build/`` (listed in ``.gitignore``); a library is
named by the hash of its source and flags, so an edited source rebuilds
and an unchanged one is reused.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE / "build"

SOURCES = {
    "gather_cache": _HERE / "gather_cache" / "csrc" / "gather_rows.cu",
    "indexer": _HERE / "indexer" / "csrc" / "indexer.cu",
    "indexer_tc": _HERE / "indexer" / "csrc" / "indexer_tc.cu",
    "sparse_mla": _HERE / "sparse_mla" / "csrc" / "sparse_mla.cu",
    "sparse_mla_tc": _HERE / "sparse_mla" / "csrc" / "sparse_mla_tc.cu",
}

NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}     # per source, filled by build_all
PTXAS_INFO: dict[str, str] = {}          # nvcc's register/smem report


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (CUDA_HOME, /usr/local/cuda, PATH)")
    return found


def _lib_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every missing library in parallel; returns seconds per
    source built.  Raises with nvcc's output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    exe = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = _lib_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    failed = []
    for n, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        BUILD_SECONDS[n] = time.perf_counter() - t0
        PTXAS_INFO[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n} (rc={p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: BUILD_SECONDS[n] for n in todo}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel family (builds all on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.ess_error_string.argtypes = [ctypes.c_int]
        lib.ess_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if rc != 0:
        msg = lib.ess_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> ctypes.c_void_p:
    """The current CUDA stream of ``t``'s device, by PyTorch's raw accessor
    (the one Triton's launcher uses), which returns the pointer without
    building the Stream object ``torch.cuda.current_stream(dev)`` makes on
    every call: host time on every kernel launch."""
    import torch
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(t.device.index))
