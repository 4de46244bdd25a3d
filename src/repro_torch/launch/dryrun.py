"""Multi-pod dry run (counterpart of ``repro.launch.dryrun``): every (arch
× input shape × mesh) cell's step run once on abstract arguments, without
hardware — the proof that the distribution config is coherent.

The process joins a ``fake`` process group of 512 ranks (rank 0; no
collective moves data) and builds the production meshes over it
(:mod:`repro_torch.launch.mesh`).  Parameters, optimizer state, caches
and inputs are DTensors on the ``meta`` device (:func:`~repro_torch
.launch.steps.abstract_state`, :func:`~repro_torch.launch.steps
.input_specs`), so no cell allocates; the step runs on them under the
cell's sharding context, with plain tensors the model makes taken as
replicated (``implicit_replication``).  Kernel wrappers see ``meta``
tensors and take their plain versions.

For each cell this records:

* ``memory``: rank 0's argument bytes, device and host tier apart
  (``argument_bytes`` / ``host_argument_bytes``, from the local shard
  shapes of parameters, optimizer state, caches and inputs) and the
  output bytes.  XLA's ``temp_bytes`` (its buffer assignment's scratch)
  has no counterpart on ``meta`` tensors, where nothing is allocated and
  no buffer is reused: recorded as ``null``.
* ``flops``: rank 0's floating-point operations, counted over the local
  operations DTensor runs (``torch.utils.flop_counter``'s formulas).
* ``collectives``: count and output bytes of every collective the step's
  DTensor redistributions issue (the ``_c10d_functional`` ops), by kind.
  These are not XLA's numbers (its partitioner chooses other
  collectives) and are not held against the reference's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
      --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all \\
      --multi-pod both --out results/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Any

import torch

from repro_torch.configs import ASSIGNED, SHAPES, get_config
from repro_torch.configs.base import ess_enabled
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.training.tree import leaves

WORLD = 512

# ---------------------------------------------------------------------------
# Cell enumeration + skip table (the reference's)
# ---------------------------------------------------------------------------

SKIPS: dict[tuple[str, str], str] = {
    ("whisper-large-v3", "long_500k"): "enc-dec, full attention decoder",
    ("gemma2-27b", "long_500k"): "global layers are full attention",
    ("gemma3-27b", "long_500k"): "global layers are full attention",
    ("qwen3-0.6b", "long_500k"): "pure full attention",
    ("qwen1.5-110b", "long_500k"): "pure full attention",
    ("dbrx-132b", "long_500k"): "pure full attention",
    ("qwen2-vl-7b", "long_500k"): "pure full attention",
}


def enumerate_cells() -> list[tuple[str, str, str | None]]:
    """[(arch, shape, skip_reason|None)] — 40 cells total."""
    return [(arch, shape, SKIPS.get((arch, shape)))
            for arch in ASSIGNED for shape in SHAPES]


def cell_config(arch: str, shape: str):
    """Arch config for a cell; deepseek's long cell uses the paper's
    V3.2-Exp + ESS variant (DSA makes 500k sub-quadratic)."""
    cfg = get_config(arch)
    cell = SHAPES[shape]
    if arch == "deepseek-v3-671b" and shape == "long_500k":
        cfg = get_config("deepseek-v32-exp-ess")
    return cfg, cell


def cell_profile(cfg, cell, profile: str | None = None) -> str:
    """The rule profile of a cell: the config's, except a weights-
    stationary ``2d_ws`` for a non-ESS ``2d`` decode (the reference's
    choice; ``profile`` overrides)."""
    if profile is not None:
        return profile
    if cell.kind == "decode" and cfg.sharding_profile == "2d" \
            and not ess_enabled(cfg):
        return "2d_ws"
    return cfg.sharding_profile


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def _nbytes(t) -> int:
    n = 1
    for s in shd.local_shape(t):
        n *= s
    return n * t.element_size()


def argument_bytes(*trees) -> dict[str, int]:
    """Rank 0's bytes of the leaves, device and host tier apart."""
    dev = host = 0
    for tree in trees:
        for t in leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            if shd.memory_kind(t) == "pinned_host":
                host += _nbytes(t)
            else:
                dev += _nbytes(t)
    return {"argument_bytes": dev, "host_argument_bytes": host}


def on_meta(*trees) -> bool:
    """Whether every tensor leaf lives on ``meta`` (nothing allocated)."""
    return all(t.device.type == "meta" for tree in trees
               for t in leaves(tree) if isinstance(t, torch.Tensor))


def _counter_mode():
    """A dispatch mode that counts rank 0's local work: DTensor-level ops
    are handed back (``NotImplemented``) so DTensor desugars them into
    local ops and collectives under the mode, which then counts the
    local ops' FLOPs (``torch.utils.flop_counter``'s formulas) and each
    collective's kind and output bytes."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    skip = {"wait_tensor", "_wrap_tensor_autograd"}

    class Counter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0
            self.coll_bytes: dict[str, int] = {}
            self.coll_count: dict[str, int] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            pkt = getattr(func, "_overloadpacket", None)
            if pkt in flop_registry:
                self.flops += int(flop_registry[pkt](*args, **kwargs,
                                                     out_val=out))
            ns = getattr(func, "namespace", "")
            name = getattr(pkt, "__name__", "")
            if ns in ("_c10d_functional", "c10d") and name not in skip:
                b = sum(t.numel() * t.element_size() for t in
                        (out if isinstance(out, (list, tuple)) else [out])
                        if isinstance(t, torch.Tensor))
                self.coll_bytes[name] = self.coll_bytes.get(name, 0) + b
                self.coll_count[name] = self.coll_count.get(name, 0) + 1
            return out

    return Counter()


# ---------------------------------------------------------------------------
# One cell
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape: str, *, multi_pod: bool,
             verbose: bool = True, profile: str | None = None
             ) -> dict[str, Any]:
    from torch.distributed.tensor.experimental import implicit_replication
    cfg, cell = cell_config(arch, shape)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    skip = SKIPS.get((arch, shape))
    if skip:
        return {"arch": arch, "shape": shape, "mesh": mesh_name,
                "status": "skipped", "reason": skip}
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    prof = cell_profile(cfg, cell, profile)
    rules = shd.PROFILES[prof](multi_pod,
                               seq_data=cell.global_batch == 1)
    rec: dict[str, Any] = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "profile": prof}
    try:
        with shd.use_sharding(mesh, rules):
            specs = ST.input_specs(cfg, cell)
            params, opt = ST.abstract_state(cfg, cell)
            step = ST.make_step(cfg, cell)
            mem = argument_bytes(params, opt, specs)
            t_build = time.time() - t0
            counter = _counter_mode()
            with implicit_replication(), counter, torch.no_grad() \
                    if cell.kind != "train" else contextlib.nullcontext():
                out = step(params, opt, specs) if cell.kind == "train" \
                    else step(params, specs)
            t_run = time.time() - t0 - t_build
        out_b = argument_bytes(out)
        rec.update({
            "status": "ok",
            "meta_only": on_meta(params, opt, specs, out),
            "build_s": round(t_build, 1),
            "run_s": round(t_run, 1),
            "flops": float(counter.flops),
            "collectives": {
                "bytes_by_kind": counter.coll_bytes,
                "count_by_kind": counter.coll_count,
                "total_bytes": sum(counter.coll_bytes.values())},
            "memory": {
                **mem,
                "output_bytes": out_b["argument_bytes"]
                + out_b["host_argument_bytes"],
                "temp_bytes": None,
                "temp_bytes_note": "no meta-tensor counterpart of XLA's "
                                   "buffer assignment",
            },
        })
        if verbose:
            print(f"[ok] {arch} × {shape} × {mesh_name} "
                  f"(build {t_build:.0f}s run {t_run:.0f}s) "
                  f"flops={rec['flops']:.3e} "
                  f"coll={rec['collectives']['total_bytes']:.3e}B "
                  f"args/dev={mem['argument_bytes'] / 2**30:.2f}GiB "
                  f"host/dev={mem['host_argument_bytes'] / 2**30:.2f}GiB")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        rec.update({"status": "error", "error": f"{type(e).__name__}: {e}"
                    [:2000], "trace": traceback.format_exc()[-2000:]})
        if verbose:
            print(f"[ERR] {arch} × {shape} × {mesh_name}: "
                  f"{rec['error'][:300]}")
    return rec


def init_fake_world(world: int = WORLD) -> None:
    """Join a ``fake`` process group of ``world`` ranks as rank 0 (no
    data moves; every collective returns at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=["off", "on", "both"],
                    default="off")
    ap.add_argument("--out", default=None)
    ap.add_argument("--ess", action="store_true",
                    help="use the ESS-enabled deepseek variant for decode")
    ap.add_argument("--sharding-profile", default=None,
                    help="override the arch sharding profile")
    args = ap.parse_args(argv)

    init_fake_world()
    meshes = {"off": [False], "on": [True], "both": [False, True]}[
        args.multi_pod]
    if args.all:
        cells = [(a, s) for a, s, _ in enumerate_cells()]
    else:
        archs = [args.arch] if args.arch else ASSIGNED
        shapes = [args.shape] if args.shape else list(SHAPES)
        cells = [(a, s) for a in archs for s in shapes]

    results = []
    for arch, shape in cells:
        a = arch
        if args.ess and arch == "deepseek-v3-671b":
            a = "deepseek-v32-exp-ess"
        for mp in meshes:
            results.append(run_cell(a, shape, multi_pod=mp,
                                    profile=args.sharding_profile))

    ok = sum(r["status"] == "ok" for r in results)
    sk = sum(r["status"] == "skipped" for r in results)
    err = sum(r["status"] == "error" for r in results)
    print(f"\n=== dry-run: {ok} ok, {sk} skipped, {err} errors "
          f"/ {len(results)} cells ===")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    return 1 if err else 0


if __name__ == "__main__":
    sys.exit(main())
