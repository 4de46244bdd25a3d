"""Quickstart of the PyTorch/CUDA port: the ESS pipeline end to end.

Builds the smoke-scale DeepSeek-V3.2-Exp (DSA + MLA + MoE + ESS), prefills
a prompt, decodes greedily through the offload-centric engine, and shows
that (a) the tokens match the monolithic model's (the whole latent cache
in device memory) and (b) the Sparse Memory Pool's misses fall after the
first steps, and the LRU warmup cuts the first step's.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # CPU

Without a CUDA device it stops unless given ``--device cpu``.
"""

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import resolve_device  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import init_params, model_def  # noqa: E402
from repro_torch.serving import engine as E  # noqa: E402
from repro_torch.serving.sampling import greedy  # noqa: E402


def count_params(defs) -> int:
    if isinstance(defs, dict):
        return sum(count_params(v) for v in defs.values())
    return int(np.prod(defs.shape))


def main(argv=None) -> bool:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu to run the plain path on the CPU (default: "
                         "the CUDA card)")
    dev = resolve_device(ap.parse_args(argv).device)
    cfg = get_config("deepseek-v32-exp-ess-smoke")
    cfg = dataclasses.replace(
        cfg, ess=dataclasses.replace(cfg.ess, max_miss_ratio=1.0))
    cold_cfg = dataclasses.replace(
        cfg, ess=dataclasses.replace(cfg.ess, warmup_windows=0))
    print(f"model: {cfg.name} — {count_params(model_def(cfg)) / 1e6:.2f}M "
          f"params, {cfg.num_layers} layers, DSA top-{cfg.dsa.index_topk}, "
          f"pool ratio {cfg.ess.sparse_memory_ratio}, on {dev}")
    params = init_params(cfg, 0, device=dev)

    B, S, SMAX, NEW = 2, 24, 64, 8
    g = torch.Generator(device=dev).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    pos = torch.arange(S, device=dev)[None].expand(B, S)

    print("\n-- prefill (exactness demo uses the cold pool; warmup shown "
          "below) --")
    logits, caches = E.ess_prefill(params, cold_cfg, toks, pos, SMAX)
    tok = greedy(logits[:, -1])

    # the monolithic model for the same continuation
    pf = E.generic_prefill(params, cfg, toks, pos, device=dev)
    cm = T.pad_caches(pf.caches, SMAX)
    tok_m = greedy(pf.logits[:, -1])

    print("\n-- ESS decode (fetch ∥ Attn0 → Attn1 → exact merge) --")
    same = True
    for step in range(NEW):
        out = E.ess_decode(params, cfg, tok[:, None], caches.lens[:, None],
                           caches)
        caches = out.caches
        tok = greedy(out.logits[:, -1])
        om = E.generic_decode(params, cfg, tok_m[:, None],
                              cm["lens"][:, None], cm, device=dev)
        tok_m = greedy(om.logits[:, -1])
        same &= bool(torch.equal(tok, tok_m))
        print(f"  step {step}: tokens={tok.tolist()} pool misses/seq="
              f"{out.stats['misses'].tolist()} hits/seq="
              f"{out.stats['hits'].tolist()}")
    print(f"\nESS continuation == monolithic continuation: {same}")

    print("\n-- LRU-Warmup effect (paper Fig. 4) --")
    _, cold = E.ess_prefill(params, cold_cfg, toks, pos, SMAX)
    _, warm = E.ess_prefill(params, cfg, toks, pos, SMAX)
    nxt = greedy(logits[:, -1])
    oc = E.ess_decode(params, cfg, nxt[:, None], cold.lens[:, None], cold)
    ow = E.ess_decode(params, cfg, nxt[:, None], warm.lens[:, None], warm)
    print(f"  first-step misses/seq  cold pool: "
          f"{oc.stats['misses'].tolist()}  warmed pool: "
          f"{ow.stats['misses'].tolist()}")
    return same


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
