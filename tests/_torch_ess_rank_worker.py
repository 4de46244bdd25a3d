"""One gloo rank of ``tests/test_torch_ess_ranks.py``: run as ``python
tests/_torch_ess_rank_worker.py RANK WORLD MODEL DIR`` with ``src`` on the
path, every rank of the world at once.  The ranks meet through a file
store in ``DIR`` on a ``(WORLD / MODEL, MODEL)`` ``data, model`` mesh,
read the seeded parameters and inputs ``DIR/inputs.npz`` and, for the bf16
and the int8 tier, run the ESS prefill of the batch and the teacher-forced
decode rounds under ``use_sharding(mesh, rules_tp)`` (weights replicated
over ``data``, split over ``model``).  Each rank writes its own rows of
the logits, the pools, ``lens``, the block tables and its own pinned-tier
shard (plain tensors, never gathered) to ``DIR/rank_RANK.npz``.  On the
data-only mesh each rank also counts the collectives of its first decode
round, checks that every kernel wrapper refuses a DTensor, and then
prefills its own slots one at a time on its own tensors and runs one
decode round (the per-slot path a serve loop takes)."""

import contextlib
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.params import distribute_params
from repro_torch.serving import engine as E
from repro_torch.training.tree import flatten, unflatten

CFG = "deepseek-v32-exp-ess-smoke"
TIERS = ("bf16", "int8")
KINDS = ("all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor",
         "all_to_all_single")


def config(tier: str):
    c = get_config(CFG)
    return dataclasses.replace(c, param_dtype=torch.float32,
                               ess=dataclasses.replace(
                                   c.ess, host_cache_dtype=tier))


def load_params(a: dict, cfg) -> dict:
    """The parameter tree from ``inputs.npz``'s ``p/<path>`` entries."""
    from repro_torch.models.params import init_params
    like = init_params(cfg, 0, "cpu")
    return unflatten(like, [torch.from_numpy(a["p/" + "/".join(map(
        str, path))]) for path, _ in flatten(like)])


def counter_mode():
    """The dry run's dispatch mode that counts collectives by kind."""
    from repro_torch.launch.dryrun import _counter_mode
    return _counter_mode()


def local(t) -> np.ndarray:
    return shd.to_local_batch(t).numpy() if shd.is_dtensor(t) \
        else t.numpy()


def per_slot(params, cfg, a, mesh, out, tier):
    """Each rank prefills its own slots one at a time (ragged chunks of
    ``a["chunk"]``), then one decode round of the whole batch."""
    B = a["toks"].shape[0]
    caches = LC.init_ess_caches(cfg, B, int(a["max_seq"]), device="cpu")
    r0, nb = shd.batch_block(mesh, B)
    C = int(a["chunk"])
    toks = torch.from_numpy(a["toks"]).long()
    for slot in range(r0, r0 + nb):
        n = int(a["slot_lens"][slot])
        for c0 in range(0, n, C):
            ck = min(C, n - c0)
            t = torch.nn.functional.pad(toks[slot:slot + 1, c0:c0 + ck],
                                        (0, C - ck))
            pos = c0 + torch.arange(C)[None]
            _, caches, _, _ = E.ess_prefill_chunk(
                params, cfg, t, pos, caches, slot=slot, want_logits=False,
                n_valid=ck)
    tok = torch.from_numpy(a["forced"][0]).long()
    o = E.ess_decode(params, cfg, tok[:, None], caches.lens[:, None],
                     caches, slot_mask=None)
    out[f"{tier}/slot_logits"] = local(o.logits)
    out[f"{tier}/slot_tier"] = caches.host_latent.numpy()


def refusals(mesh) -> list[str]:
    """The kernel wrappers that raise ``TypeError`` when handed a DTensor
    (each must: none may run its plain version on one instead)."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.gather_cache import ops as gops
    from repro_torch.kernels.indexer import ops as iops
    from repro_torch.kernels.sparse_mla import ops as sops

    def dt(t):
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    rows, ids = dt(torch.zeros(16, 8)), dt(torch.zeros(2, 3).long())
    q8, sc = dt(torch.zeros(16, 8, dtype=torch.int8)), \
        dt(torch.ones(16, 1, dtype=torch.float16))
    q, w = dt(torch.zeros(2, 1, 2, 8)), dt(torch.zeros(2, 1, 2))
    keys, valid = dt(torch.zeros(2, 5, 8)), dt(torch.ones(2, 5).bool())
    o, m = dt(torch.zeros(2, 2, 1, 2, 4)), dt(torch.zeros(2, 2, 1, 2))
    calls = {
        "gather_rows": lambda: gops.gather_rows(rows, ids),
        "gather_rows_raw": lambda: gops.gather_rows_raw(rows, None, ids),
        "gather_rows_dequant": lambda: gops.gather_rows_dequant(q8, sc, ids),
        "scatter_rows": lambda: gops.scatter_rows(
            rows, ids.reshape(-1), dt(torch.zeros(6, 8))),
        "gather_pages": lambda: gops.gather_pages(rows, ids[0], 4),
        "gather_pages_dequant": lambda: gops.gather_pages_dequant(
            q8, sc, ids[0], 4),
        "put_pages": lambda: gops.put_pages(
            rows.reshape(1, 16, 8), ids[0], dt(torch.zeros(1, 12, 8)), 4),
        "indexer_scores": lambda: iops.indexer_scores(q, w, keys, valid),
        "topk_select": lambda: iops.topk_select(q, w, keys, valid, 2),
        "partial_attend": lambda: sops.partial_attend(
            dt(torch.zeros(2, 1, 2, 8)), keys, valid, 1.0, 4),
        "merge_splits": lambda: sops.merge_splits(o, m, m),
        "sparse_mla_gather_attend": lambda: sops.sparse_mla_gather_attend(
            dt(torch.zeros(2, 1, 2, 8)), keys, dt(torch.zeros(2, 1, 2).long()),
            valid, 1.0, 4)}
    out = []
    for name, fn in calls.items():
        try:
            fn()
        except TypeError as e:
            if "DTensor" in str(e):
                out.append(name)
    return out


def main(rank: int, world: int, model: int, d: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store",
                            rank=rank, world_size=world)
    a = dict(np.load(os.path.join(d, "inputs.npz")))
    mesh = make_mesh((world // model, model), ("data", "model"), "cpu")
    rules = shd.PROFILES["tp"](False)
    toks = torch.from_numpy(a["toks"]).long()
    pos = torch.from_numpy(a["pos"]).long()
    out = {"first_row": np.int64(shd.batch_block(mesh, toks.shape[0])[0])}
    if model == 1:
        out["refused"] = np.array(refusals(mesh))
    for tier in TIERS:
        cfg = config(tier)
        with shd.use_sharding(mesh, rules), implicit_replication(), \
                torch.no_grad():
            params = distribute_params(load_params(a, cfg), cfg, mesh, rules)
            logits, caches = E.ess_prefill(params, cfg, toks, pos,
                                           int(a["max_seq"]),
                                           prefill_chunk=int(a["chunk"]))
            out[f"{tier}/prefill"] = local(logits)
            for r, tok in enumerate(a["forced"]):
                # data only: the first round's collectives, counted (all
                # in the MoE layers' batch-wide capacity dispatch)
                count = r == 0 and model == 1
                counter = counter_mode() if count else \
                    contextlib.nullcontext()
                with counter:
                    o = E.ess_decode(params, cfg,
                                     torch.from_numpy(tok).long()[:, None],
                                     caches.lens[:, None], caches,
                                     slot_mask=None)
                    if count:
                        out[f"{tier}/collectives"] = np.array(
                            [counter.coll_count.get(k, 0) for k in KINDS])
                caches = o.caches
                out[f"{tier}/round{r}"] = local(o.logits)
            out[f"{tier}/lens"] = local(caches.lens)
            out[f"{tier}/block_tables"] = local(caches.block_tables)
            for i, p in enumerate(caches.pools):
                for f in ("ids", "last_use", "slot_of"):
                    out[f"{tier}/pool{i}/{f}"] = local(getattr(p, f))
            host = caches.host_latent
            assert type(host) is torch.Tensor        # the rank's own shard
            out[f"{tier}/tier"] = host.numpy()
            if caches.host_scales is not None:
                out[f"{tier}/scales"] = caches.host_scales.numpy()
            if model == 1:
                per_slot(params, cfg, a, mesh, out, tier)
    np.savez(os.path.join(d, f"rank_{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(*map(int, sys.argv[1:4]), sys.argv[4])
