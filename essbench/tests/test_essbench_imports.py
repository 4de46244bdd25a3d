"""Nothing the benchmark runs loads JAX or the JAX package.

Top-level module names are compared whole: the port's ``repro_torch``
begins with ``repro`` and is allowed; ``repro`` itself is not."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

PROBE = r"""
import json, sys, time
sys.path[0:0] = [sys.argv[1], sys.argv[1] + "/src", sys.argv[2]]
import torch
torch.set_num_threads(1)
import tempfile
from pathlib import Path
import smoke_cells as SC
from essbench import harness as H, spec as S
specs = S.Specs(SC.bench(), roots=[SC.write(Path(tempfile.mkdtemp()))])
for kind in ("traffic", "metrics"):
    for p in sorted((Path(sys.argv[1]) / "essbench" / kind).glob("*.py")):
        if p.stem != "__init__":
            specs.module(kind, p.stem)
import essbench.calibrate, essbench.sweep, essbench.entry  # noqa
for cell in ("t-pd", "t-v3", "t-chat"):
    H.run_cell(specs, cell, 1, 0.2, True, device=torch.device("cpu"),
               t_start=time.perf_counter())
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(REPO), str(REPO / "essbench/tests")],
        capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded and "essbench" in loaded
    assert not loaded & FORBIDDEN


def test_no_source_imports_jax_or_the_jax_package():
    for p in (REPO / "essbench").rglob("*.py"):
        if "tests" in p.parts:
            continue
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, (p, n)


def test_the_reference_imports_nothing_of_the_port():
    files = sorted((REPO / "essbench/reference").glob("*.py"))
    assert any(p.stem == "deepseek" for p in files)
    for p in files:
        for node in ast.walk(ast.parse(p.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(
                    node, ast.Import) else [node.module]
                assert all(m.split(".")[0] in ("torch", "contextlib",
                                               "__future__")
                           for m in mods), (p, mods)
