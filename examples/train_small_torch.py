"""Training end to end on the PyTorch/CUDA port (the mirror of
``examples/train_small.py``): a ~100M-parameter qwen3-family model trained
on the synthetic copy-structure corpus with the fault-tolerance stack
(asynchronous checkpoints, resume, the straggler watchdog, the NaN
budget).

    PYTHONPATH=src python examples/train_small_torch.py          # card, 200 steps
    PYTHONPATH=src python examples/train_small_torch.py --tiny --device cpu

Without a CUDA device it stops unless given ``--device cpu``.  A run
resumes from the latest checkpoint under ``--ckpt-dir``.
"""

import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_step  # noqa: E402
from repro_torch.models.params import (count_params, init_params,  # noqa: E402
                                       model_def)
from repro_torch.training.data import DataConfig  # noqa: E402
from repro_torch.training.optimizer import (AdamWConfig,  # noqa: E402
                                            init_opt_state)
from repro_torch.training.train_loop import LoopConfig, train_loop  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small"))
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.tiny:
        cfg = get_config("qwen3-0.6b-smoke", param_dtype=torch.float32)
        steps, batch, seq = args.steps or 60, 8, 64
    else:
        # ~100M-param member of the qwen3 family (same code path as 0.6B)
        cfg = get_config("qwen3-0.6b", param_dtype=torch.float32,
                         num_layers=8, d_model=512, num_heads=8,
                         num_kv_heads=4, head_dim=64, d_ff=1536,
                         vocab_size=32000)
        steps, batch, seq = args.steps or 200, 16, 256

    n = count_params(model_def(cfg))
    print(f"training {cfg.name}: {n/1e6:.1f}M params, {steps} steps, "
          f"batch {batch} x seq {seq}, on {dev}")
    params = init_params(cfg, 0, device=dev)
    opt_cfg = AdamWConfig(lr=6e-4, total_steps=steps,
                          warmup_steps=max(5, steps // 20))
    step = make_train_step(cfg, opt_cfg, donate=True)
    data = DataConfig(vocab_size=cfg.vocab_size, global_batch=batch,
                      seq_len=seq, copy_prob=0.5)
    loop = LoopConfig(total_steps=steps, ckpt_every=max(50, steps // 4),
                      ckpt_dir=args.ckpt_dir, log_every=10)
    t0 = time.perf_counter()
    _, _, st = train_loop(step, params, init_opt_state(params), data, loop)
    ms = 1e3 * (time.perf_counter() - t0) / max(1, steps)
    peak = (f", peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB"
            if dev.type == "cuda" else "")
    print(f"{ms:.1f} ms a step with the loop's data and checkpoints, "
          f"{batch * seq / (ms / 1e3):.0f} train tokens/s{peak}")
    print(f"done at step {st.step} (stragglers flagged: "
          f"{st.straggler_events}, nan events: {st.nan_count})")


if __name__ == "__main__":
    main()
