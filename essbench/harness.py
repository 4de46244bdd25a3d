"""One run of one cell: set-up, the measured window, the check, the result.

:func:`run_cell` draws the weights, hands them to the cell's traffic
driver (``traffic/<kind>.py``: it builds the program's serving object,
warms the cell's shapes, measures, optionally profiles a slice, frees the
program's state and returns a :class:`Run`), checks the served tokens
against the plain reference that the configuration names, and reads the
cell's metrics (``metrics/<name>.py``).  :func:`main` is ``run.py``'s command.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Any, Optional

import numpy as np

from essbench import spec as S
from essbench.trace import Spans

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Run:
    """What a traffic driver hands back; the metric readers read it."""
    t_window: float = 0.0            # perf_counter at the window's start
    window_s: float = 0.0
    # every delivered token: (rid, index, perf_counter stamp)
    tokens: list = dataclasses.field(default_factory=list)
    # open loop: rid -> the instant it was due
    due: dict = dataclasses.field(default_factory=dict)
    ttft_s: list = dataclasses.field(default_factory=list)
    # counter differences over the window and over the profiled slice
    counters: dict = dataclasses.field(default_factory=dict)
    slice_counters: dict = dataclasses.field(default_factory=dict)
    ttft_rounds: list = dataclasses.field(default_factory=list)
    # the slice's rounds: (decode contexts, prefill chunks (start, n))
    slice_work: list = dataclasses.field(default_factory=list)
    # the profiled slice (a trace.Slice), then what its reduce() gives
    trace: Any = None
    attempted: int = 0
    failed: int = 0
    memory_peak: int = 0
    # served requests to compare: (prompt ids, served ids)
    samples: list = dataclasses.field(default_factory=list)
    notes: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Ctx:
    """What a traffic driver is given."""
    cell: str
    cfg: Any                         # the port's ArchConfig
    conf: dict                       # the configuration file
    params: dict                     # the cell's traffic parameters
    seed: int
    seconds: float
    trace: bool
    device: Any
    weights: dict
    spans: Spans
    t_start: float

    def rng(self, stream: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, stream])

    def sync(self) -> None:
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize()


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile (0-100), linear between order statistics."""
    if len(values) == 0:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def free_device() -> None:
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def judge(gap: float, compared: int, run: Run,
          limits: dict) -> tuple[bool, dict]:
    """The comparison that decides ``correct``: the widest gap by which a
    compared token's logit lies below the reference's best, and the
    requests that failed, each against its limit.  Returns (correct,
    {number: {value, limit}})."""
    limit = limits["logit_gap_max"]
    numbers = {"logit_gap_max": {"value": gap, "limit": limit},
               "failed_requests": {"value": run.failed, "limit": 0}}
    ok = compared > 0 and run.attempted > 0 and run.failed == 0 \
        and gap <= limit
    return ok, numbers


def check(specs: S.Specs, run: Run, weights: dict, conf: dict,
          limits: dict, quant: Optional[str] = None
          ) -> tuple[bool, dict, dict]:
    """Hold the sample of served tokens to the plain reference that the
    configuration names (``reference/<name>.py``).  With ``quant`` the
    reference also runs the same prompts and served tokens at that
    precision in the program's place: the tokens it puts first at each
    position are judged by :func:`judge` as served tokens are, and
    ``control_correct`` is its verdict.  Returns (correct,
    {number: {value, limit}}, readings)."""
    ref = specs.module("reference", conf["reference"])
    gap, ctl, n = 0.0, 0.0, 0
    for prompt, served in run.samples:
        out = ref.served_gaps(weights, conf, prompt, served, quant=quant)
        gap = max(gap, float(out["gap"].max()))
        n += len(served)
        if quant is not None:
            ctl = max(ctl, float(out["control_gap"].max()))
    ok, numbers = judge(gap, n, run, limits)
    readings = {"tokens_compared": n, "gap": gap}
    if quant is not None:
        readings["control_gap"] = ctl
        readings["control_correct"] = judge(ctl, n, run, limits)[0]
    return ok, numbers, readings


def read_metrics(specs: S.Specs, entries: list, run: Run, ctx: Ctx) -> dict:
    out = {}
    for m in entries:
        mod = specs.module("metrics", m["name"])
        v = mod.read(run, ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def card_facts() -> dict:
    import torch
    facts = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "torch": torch.__version__, "cuda": torch.version.cuda}
    try:
        q = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm,"
             "clocks.mem,driver_version", "--format=csv,noheader",
             "--id=0"], capture_output=True, text=True, timeout=30)
        vals = [v.strip() for v in q.stdout.strip().split(",")]
        for k, v in zip(("power_limit", "clock_sm", "clock_sm_max",
                         "clock_mem", "driver"), vals):
            facts[k] = v
    except (OSError, subprocess.SubprocessError):
        facts["nvidia_smi"] = "unavailable"
    return facts


def run_cell(specs: S.Specs, cell: str, seed: int, seconds: float,
             trace: bool, *, device, t_start: float,
             quant: Optional[str] = None) -> dict:
    """One run; returns the result's fields (and ``readings``)."""
    import torch

    from essbench import weights as W

    wl = specs.json("workloads", cell)
    conf = specs.json("configs", wl["config"])
    cfg = S.arch_config(conf)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    weights = W.draw(cfg, seed, device)
    ctx = Ctx(cell=cell, cfg=cfg, conf=conf, params=wl["params"], seed=seed,
              seconds=seconds, trace=trace, device=device, weights=weights,
              spans=Spans(trace), t_start=t_start)
    driver = specs.module("traffic", wl["traffic"])
    run = driver.run(ctx)
    free_device()
    if run.trace is not None:
        run.trace = run.trace.reduce()
    t_check = time.perf_counter()
    ok, numbers, readings = check(specs, run, weights, conf,
                                  wl["check"], quant)
    readings["check_s"] = time.perf_counter() - t_check
    metrics = read_metrics(specs, specs.metrics(cell, trace), run, ctx)
    return {"correct": ok, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "numbers": numbers, "readings": readings,
            "run": run}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="essbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    specs = S.Specs()
    entry = specs.cell(args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"essbench: the cell needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    _build.build_all()
    dev = torch.device("cuda", 0)
    res = run_cell(specs, args.workload, args.seed, args.seconds,
                   bool(args.trace), device=dev, t_start=t_start)
    run: Run = res["run"]
    bad = forbidden_modules()
    if bad:
        print(f"essbench: the run loaded {bad}", file=sys.stderr)
        return 3
    device = {**card_facts(), "count": chips,
              "memory_peak_bytes": int(run.memory_peak)}
    if args.trace:
        if run.trace is None or run.trace["busy_s"] <= 0:
            print("essbench: the traced slice shows no device activity",
                  file=sys.stderr)
            return 4
        device["busy_s"] = run.trace["busy_s"]
        device["window_s"] = run.trace["window_s"]
    for k, v in {**res["readings"], **run.notes}.items():
        print(f"essbench: {k} = {v}", file=sys.stderr)
    for k, v in res["numbers"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    line = {"correct": bool(res["correct"]), "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if args.trace:
        line["breakdown"] = run.trace["breakdown"]
    line["checks"] = res["numbers"]
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
