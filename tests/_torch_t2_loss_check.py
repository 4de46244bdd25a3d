"""T2's first two losses in both packages, on the CPU.

``chip_smoke.py``'s T2 (DeepSeek-V3.2 at published widths cut to its
first, dense layer, fp32, AdamW at ``lr`` 6e-5 on its first step) reads a
loss that rises after one step.  This script takes one train step of that
model in each package from the same parameters (the reference's
``init_params``, seed 0, carried across as numpy files) on the same batch
(``make_batch``, seed 0) and prints both packages' first loss and the
loss after the step, each package in a process of its own:

  PYTHONPATH=src python tests/_torch_t2_loss_check.py --dir DIR [--seq N]

``DIR`` receives the parameters (about 10 GB) and each side's result
(``jax.json``, ``torch.json``).  A step is the reference's ``train_step``
taken apart so that a process holds the parameters and their gradients
and never the moments of every leaf at once: the loss and its gradient
(one jitted ``value_and_grad`` / the port's ``loss_and_grads``), the
gradients' global norm and clipping scale, then each package's own
``adamw_update`` applied a block of rows at a time with zero moments at
step 0 (elementwise, so the same values as one update of the whole tree)
and its clipping made exact by scaling the gradients first.  A process
peaks at about 34 GB at ``--seq 128``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

CFG = "deepseek-v32-exp-ess"
# chip_smoke.py's T2: TRAIN_OPT, so lr_at(step 1) = 3e-4 * 2 / 10 = 6e-5
TRAIN_OPT = dict(lr=3e-4, total_steps=100, warmup_steps=10)
ROWS = 1 << 14             # rows of a leaf updated at once
NO_CLIP = 3.0e38           # the gradients are clipped before the update


def _blocks(shape: tuple):
    """Index blocks of a leaf: ``...`` for a scalar, else row ranges."""
    if not shape:
        yield ...
        return
    for r0 in range(0, shape[0], ROWS):
        yield slice(r0, min(shape[0], r0 + ROWS))


def one_dense_layer(cfg, **kw):
    """T2's model: the first (dense) layer alone, no MTP.  Its FFN is
    written as the one layer of a config without MoE (``d_ff`` is the
    dense layers' 18432 in both packages): the reference's forward cannot
    run a model whose MoE group is empty, and this is the same layer."""
    assert cfg.d_ff == cfg.moe.dense_d_ff
    return dataclasses.replace(cfg, num_layers=1, mtp_depth=0, moe=None,
                               **kw)


def jax_side(d: Path, seq: int) -> dict:
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config
    from repro.launch.steps import lm_loss
    from repro.models import transformer as T
    from repro.models.params import init_params
    from repro.training import optimizer as O
    from repro.training.data import DataConfig, make_batch

    cfg = one_dense_layer(get_config(CFG), param_dtype=jnp.float32)
    t0 = time.perf_counter()
    params = jax.jit(lambda k: init_params(k, T.model_def(cfg)))(
        jax.random.key(0))
    paths = jax.tree_util.tree_leaves_with_path(params)
    names = [".".join(k.key for k in p) for p, _ in paths]
    for name, (_, a) in zip(names, paths):
        np.save(d / f"{name}.npy", np.asarray(a))
    batch = make_batch(DataConfig(cfg.vocab_size, 1, seq, seed=0), 0)
    np.save(d / "inputs.npy", np.asarray(batch["inputs"]))
    print(f"jax: params and batch written ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    def loss_fn(p):
        out = T.forward(p, cfg, batch["inputs"], batch["positions"],
                        mode="train")
        return lm_loss(out.logits, batch["labels"]) + \
            0.01 * out.aux.get("moe_lb", 0.0)

    loss1, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss1 = float(loss1)
    norm = O.global_norm(grads)
    scale = jnp.minimum(1.0, O.AdamWConfig(**TRAIN_OPT).grad_clip
                        / jnp.maximum(norm, 1e-9))
    opt = O.AdamWConfig(**TRAIN_OPT, **{"grad_clip": NO_CLIP})
    step = jax.jit(lambda p, g: O.adamw_update(
        opt, p, g.astype(jnp.float32) * scale,
        O.init_opt_state(p))[0])
    treedef = jax.tree.structure(params)
    p_leaves, g_leaves = jax.tree.leaves(params), jax.tree.leaves(grads)
    del params, grads
    new = []
    for i in range(len(p_leaves)):
        p, g = p_leaves[i], g_leaves[i]
        out = np.empty(p.shape, np.float32)
        for sl in _blocks(p.shape):
            out[sl] = np.asarray(step(p[sl], g[sl]))
        p_leaves[i] = g_leaves[i] = None
        new.append(jnp.asarray(out))
        del p, g, out
    params2 = jax.tree.unflatten(treedef, new)
    del new
    loss2 = float(jax.jit(loss_fn)(params2))
    return dict(loss1=loss1, loss2=loss2, grad_norm=float(norm),
                lr=float(O.lr_at(opt, jnp.asarray(1))), seq=seq,
                seconds=time.perf_counter() - t0)


def torch_side(d: Path, seq: int) -> dict:
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import loss_and_grads, train_loss
    from repro_torch.models.params import from_jax_params
    from repro_torch.training import optimizer as O
    from repro_torch.training.data import DataConfig, make_batch
    from repro_torch.training.tree import leaves

    torch.set_num_threads(os.cpu_count() or 1)
    cfg = one_dense_layer(get_config(CFG), param_dtype=torch.float32)
    t0 = time.perf_counter()
    tree: dict = {}
    for f in sorted(d.glob("*.npy")):
        if f.stem == "inputs":
            continue
        *head, last = f.stem.split(".")
        node = tree
        for k in head:
            node = node.setdefault(k, {})
        node[last] = np.load(f, mmap_mode="r")
    params = from_jax_params(tree)
    del tree
    batch = make_batch(DataConfig(cfg.vocab_size, 1, seq, seed=0), 0)
    np.testing.assert_array_equal(batch["inputs"].numpy(),
                                  np.load(d / "inputs.npy"))
    print(f"torch: params and batch read ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    loss1, grads = loss_and_grads(params, cfg, batch)
    norm = O.global_norm(grads)
    scale = O._clip_scale(norm, O.AdamWConfig(**TRAIN_OPT).grad_clip)
    opt = O.AdamWConfig(**TRAIN_OPT, **{"grad_clip": NO_CLIP})
    g_leaves = leaves(grads)
    del grads
    with torch.no_grad():
        for i, p in enumerate(leaves(params)):
            g = g_leaves[i]
            for sl in _blocks(tuple(p.shape)):
                pc, gc = p[sl], g[sl].float() * scale
                O.adamw_update(opt, [pc], [gc], O.init_opt_state([pc]),
                               inplace=True)
            g_leaves[i] = None
            del g
        loss2 = float(train_loss(params, cfg, batch)[0])
    step1 = torch.ones((), dtype=torch.int32)
    return dict(loss1=float(loss1), loss2=loss2, grad_norm=float(norm),
                lr=float(O.lr_at(opt, step1)), seq=seq,
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dir", required=True, type=Path)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--side", choices=("jax", "torch"))
    a = ap.parse_args(argv)
    a.dir.mkdir(parents=True, exist_ok=True)
    if a.side is not None:
        res = (jax_side if a.side == "jax" else torch_side)(a.dir, a.seq)
        (a.dir / f"{a.side}.json").write_text(json.dumps(res))
        print(f"{a.side}: {res}", flush=True)
        return 0
    for side in ("jax", "torch"):
        rc = subprocess.call([sys.executable, __file__, "--dir", str(a.dir),
                              "--seq", str(a.seq), "--side", side])
        if rc:
            return rc
    j, t = (json.loads((a.dir / f"{s}.json").read_text())
            for s in ("jax", "torch"))
    for k in ("loss1", "loss2", "grad_norm", "lr"):
        print(f"{k}: reference {j[k]!r}, port {t[k]!r}, |diff| "
              f"{abs(j[k] - t[k]):.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
