"""The fault-tolerant training loop (the port's own copy of
``repro.training.train_loop``):

* resume from the latest checkpoint on start (a crash or preemption
  restart),
* SIGTERM: finish the current step, save a checkpoint, stop,
* periodic asynchronous checkpoints,
* deterministic data (batch ``i`` a function of the seed and ``i``), so a
  resumed run replays the batches it would have seen,
* a watchdog flagging straggling steps (over ``straggler_factor`` times
  the trailing median),
* a NaN budget (a non-finite loss counted; past the budget, stop).

Its one host read a step is ``float(loss)``, outside the step.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import tempfile
import time
from typing import Any, Callable

import numpy as np

from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.tree import leaves


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    log_every: int = 10
    straggler_factor: float = 3.0
    nan_budget: int = 5


@dataclasses.dataclass
class LoopState:
    step: int = 0
    nan_count: int = 0
    straggler_events: int = 0
    stop_requested: bool = False


def train_loop(train_step: Callable, params: Any, opt_state: Any,
               data_cfg: DataConfig, loop: LoopConfig, *,
               log: Callable[[str], None] = print
               ) -> tuple[Any, Any, LoopState]:
    """Run (or resume) training to ``loop.total_steps``, the batches on
    the parameters' device.  Returns the final ``(params, opt_state,
    state)``."""
    st = LoopState()
    saver = ckpt.AsyncSaver()
    dev = leaves(params)[0].device

    last = ckpt.latest_step(loop.ckpt_dir)
    if last is not None:
        restored = ckpt.restore(loop.ckpt_dir, last,
                                {"params": params, "opt": opt_state})
        params, opt_state = restored["params"], restored["opt"]
        st.step = last
        log(f"[resume] restored step {last} from {loop.ckpt_dir}")

    def _on_term(signum, frame):
        st.stop_requested = True
        log(f"[signal] {signum}: will checkpoint and exit after this step")

    old_term = signal.signal(signal.SIGTERM, _on_term)
    durations: list[float] = []
    try:
        while st.step < loop.total_steps and not st.stop_requested:
            t0 = time.time()
            batch = make_batch(data_cfg, st.step, device=dev)
            params, opt_state, metrics = train_step(params, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0

            if not np.isfinite(loss):
                st.nan_count += 1
                log(f"[warn] non-finite loss at step {st.step} "
                    f"({st.nan_count}/{loop.nan_budget})")
                if st.nan_count > loop.nan_budget:
                    raise FloatingPointError("nan budget exhausted")
            if durations and dt > loop.straggler_factor * np.median(durations):
                st.straggler_events += 1
                log(f"[straggler] step {st.step} took {dt:.2f}s "
                    f"(median {np.median(durations):.2f}s)")
            durations = (durations + [dt])[-32:]

            st.step += 1
            if st.step % loop.log_every == 0:
                log(f"step {st.step}: loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} {dt*1e3:.0f}ms")
            if st.step % loop.ckpt_every == 0:
                saver.save(loop.ckpt_dir, st.step,
                           {"params": params, "opt": opt_state}, loop.keep)
    finally:
        signal.signal(signal.SIGTERM, old_term)
        saver.wait()
        if st.stop_requested or st.step >= loop.total_steps:
            ckpt.save(loop.ckpt_dir, st.step,
                      {"params": params, "opt": opt_state}, keep=loop.keep)
            log(f"[ckpt] final checkpoint at step {st.step}")
    return params, opt_state, st
