"""The port stands alone: it imports neither JAX nor the reference package,
its entry points refuse to carry on on the CPU without being asked, and its
kernel wrappers launch or raise on CUDA tensors (never the plain version).
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_chip_smoke_imports_neither_jax_nor_reference():
    for mod in _imports(ROOT / "chip_smoke.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_quickstart_mirror_imports_neither_jax_nor_reference():
    for mod in _imports(ROOT / "examples" / "quickstart_torch.py"):
        assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod


def test_package_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None\n"
            "import repro_torch, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.kernels._build, "
            "repro_torch.serving.api, repro_torch.cluster, "
            "repro_torch.simulator.costmodel, "
            "repro_torch.models.transformer\n"
            "assert 'jax' not in [m.split('.')[0] for m in sys.modules "
            "if sys.modules[m] is not None]\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"),
                            "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch import resolve_device
    from repro_torch.cache.latent_cache import init_ess_caches
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import cache_spec
    from repro_torch.serving.engine import (generate_batch, generic_decode,
                                            generic_prefill)
    cfg = get_config("deepseek-v32-exp-ess-smoke")
    toks = torch.zeros((1, 4), dtype=torch.long)
    for call in (lambda: resolve_device(None),
                 lambda: init_params(cfg, 0),
                 lambda: init_ess_caches(cfg, 1, 8),
                 lambda: generate_batch({}, cfg, np.zeros((1, 4)), 1, 8),
                 lambda: cache_spec(cfg, 1, 8),
                 lambda: generic_prefill({}, cfg, toks, toks),
                 lambda: generic_decode({}, cfg, toks, toks, {})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu").type == "cpu"


def _fake_cuda_calls():
    from repro_torch.kernels.gather_cache import ops as g
    from repro_torch.kernels.indexer import ops as i
    from repro_torch.kernels.sparse_mla import ops as s
    dev = "cuda"
    return {
        "gather_rows": lambda: g.gather_rows(
            torch.zeros((8, 64), device=dev),
            torch.zeros(3, dtype=torch.long, device=dev)),
        "scatter_rows": lambda: g.scatter_rows(
            torch.zeros((8, 64), device=dev),
            torch.zeros(3, dtype=torch.long, device=dev),
            torch.zeros((3, 64), device=dev)),
        "indexer_scores": lambda: i.indexer_scores(
            torch.zeros((1, 1, 2, 16), device=dev),
            torch.zeros((1, 1, 2), device=dev),
            torch.zeros((1, 5, 16), device=dev)),
        "gather_rows_dequant": lambda: g.gather_rows_dequant(
            torch.zeros((8, 64), dtype=torch.int8, device=dev),
            torch.zeros((8, 1), dtype=torch.float16, device=dev),
            torch.zeros(3, dtype=torch.long, device=dev)),
        "gather_pages": lambda: g.gather_pages(
            torch.zeros((2, 8, 64), device=dev),
            torch.zeros(2, dtype=torch.long, device=dev), 4),
        "put_pages": lambda: g.put_pages(
            torch.zeros((2, 8, 64), device=dev),
            torch.zeros(2, dtype=torch.long, device=dev),
            torch.zeros((2, 4, 64), device=dev), 2),
        "gather_pages_dequant": lambda: g.gather_pages_dequant(
            torch.zeros((2, 8, 64), dtype=torch.float8_e4m3fn, device=dev),
            torch.zeros((2, 8, 1), dtype=torch.float16, device=dev),
            torch.zeros(2, dtype=torch.long, device=dev), 4),
        "partial_attend": lambda: s.partial_attend(
            torch.zeros((1, 1, 4, 40), device=dev),
            torch.zeros((1, 6, 40), device=dev),
            torch.ones((1, 6), dtype=torch.bool, device=dev), 0.1, 32),
        "partial_attend_tc": lambda: s.partial_attend(
            torch.zeros((1, 1, 64, 576), dtype=torch.bfloat16, device=dev),
            torch.zeros((1, 6, 576), dtype=torch.bfloat16, device=dev),
            torch.ones((1, 6), dtype=torch.bool, device=dev), 0.1, 512),
        "topk_select": lambda: i.topk_select(
            torch.zeros((1, 1, 2, 16), device=dev),
            torch.zeros((1, 1, 2), device=dev),
            torch.zeros((1, 5, 16), device=dev), None, 2),
        "sparse_mla_gather_attend": lambda: s.sparse_mla_gather_attend(
            torch.zeros((1, 1, 4, 40), device=dev),
            torch.zeros((1, 6, 40), device=dev),
            torch.zeros((1, 1, 3), dtype=torch.long, device=dev),
            torch.ones((1, 6), dtype=torch.bool, device=dev), 0.1, 32),
        "merge_splits": lambda: s.merge_splits(
            torch.zeros((2, 3, 512), device=dev),
            torch.zeros((2, 3), device=dev), torch.zeros((2, 3), device=dev)),
    }


@pytest.mark.parametrize("name", ["gather_rows", "scatter_rows",
                                  "gather_rows_dequant", "gather_pages",
                                  "put_pages", "gather_pages_dequant",
                                  "indexer_scores",
                                  "partial_attend", "partial_attend_tc",
                                  "merge_splits", "topk_select",
                                  "sparse_mla_gather_attend"])
def test_kernel_wrappers_raise_on_cuda_tensors_they_cannot_launch(name):
    """Fake CUDA tensors on a machine without CUDA or nvcc: the wrapper
    must try its kernel and fail, not return the plain version."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import repro_torch.kernels._build as B
    import warnings
    saved = dict(B._LIBS)
    B._LIBS.clear()
    try:
        with FakeTensorMode(), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError):
                _fake_cuda_calls()[name]()
    finally:
        B._LIBS.update(saved)
    assert not (PKG / "kernels" / "build").exists() or \
        not any((PKG / "kernels" / "build").glob("*.so"))


def test_meta_tensors_are_refused():
    from repro_torch.kernels.gather_cache import ops as g
    with pytest.raises(ValueError):
        g.gather_rows(torch.zeros((4, 8), device="meta"),
                      torch.zeros(2, dtype=torch.long, device="meta"))
