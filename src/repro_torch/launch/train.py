"""Train on the synthetic copy-structure corpus (the port's counterpart of
``repro.launch.train``): random fp32 weights from ``--seed``, AdamW with a
warmup of a tenth of the steps, ``--accum`` microbatches a step, each
layer body under ``--remat`` (default: the config's, ``dots``), periodic
asynchronous checkpoints under ``--ckpt-dir`` in the reference's format,
resumed from the latest one there (:func:`repro_torch.training.train_loop
.train_loop`).  On the card unless ``--device cpu``; without a card it
stops rather than carry on on the CPU.

  python -m repro_torch.launch.train --arch qwen3-0.6b-smoke \\
      --steps 50 --batch 8 --seq 128            # the card
  python -m repro_torch.launch.train --device cpu --steps 20
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_train_step
from repro_torch.models.params import init_params
from repro_torch.training.data import DataConfig
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import LoopConfig, train_loop


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b-smoke")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--remat", choices=("none", "full", "dots"),
                    default=None, help="activation checkpointing of each "
                    "layer body (default: the config's)")
    ap.add_argument("--device", default=None,
                    help="cpu to run on the CPU (default: the CUDA card)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    over = {"param_dtype": torch.float32}
    if args.remat is not None:
        over["remat"] = args.remat
    cfg = get_config(args.arch, **over)
    params = init_params(cfg, args.seed, device=dev)
    opt_cfg = AdamWConfig(lr=args.lr, total_steps=args.steps,
                          warmup_steps=max(1, args.steps // 10))
    step = make_train_step(cfg, opt_cfg, accum_steps=args.accum,
                           donate=True)
    data_cfg = DataConfig(vocab_size=cfg.vocab_size,
                          global_batch=args.batch, seq_len=args.seq,
                          seed=args.seed)
    loop = LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                      ckpt_dir=args.ckpt_dir)
    train_loop(step, params, init_opt_state(params), data_cfg, loop)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
