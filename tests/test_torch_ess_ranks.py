"""The ESS decode over several ranks, each rank on its own host-tier shard
(the port's counterpart of the reference's mesh branches in
``repro.core.offload``, which keep the host buffer batch-sharded), on the
CPU against the reference's one-device ``ess_prefill`` / ``ess_decode``
and against the port's one-rank run.

Model and traffic: ``deepseek-v32-exp-ess-smoke`` at fp32 parameters, a
bf16 and an int8 tier; the ESS prefill of 4 requests of 20 tokens (chunks
of 8, the last 4 tokens replayed as the LRU warmup), then 4 decode rounds
teacher-forced with seeded tokens.  The parameters are the port's seeded
ones, handed to the reference as its pytree (numpy in both).  Meshes:

* 2 gloo ranks, ``data 2`` (weights replicated);
* 4 gloo ranks, ``data 2 x model 2`` (``rules_tp``: heads, ff, vocab and
  experts split over ``model``).

Held, for every rank, tier and mesh:

* against the reference: the prefill's logits and each round's logits of
  the rank's rows within rtol / atol 1e-5 (``test_torch_ess.py``'s);
* against the port's one-rank run: data only, logits within 1e-6 of the
  largest logit, pool ids, stamps and maps, ``lens`` and the rank's tier
  rows bit for bit; data x model, logits within rtol / atol 1e-5;
* each rank's pinned tier holds its own rows only (``NP / 2`` pages, the
  block tables rank-local);
* data only, the per-slot path: each rank prefills its own slots one at a
  time on its own tensors, then one decode round, bit for bit with the
  one-rank per-slot run;
* data only, a decode round's collectives: the MoE layers' capacity
  dispatch (3 all-gathers a MoE layer), nothing else;
* every kernel wrapper handed a DTensor raises ``TypeError``.

The ranks are subprocesses (``tests/_torch_ess_rank_worker.py``) meeting
through a file store; the reference runs in one subprocess a tier, jitted
once per step shape; all eight start together, and the one-rank port runs
here meanwhile.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config
from repro_torch.models.params import init_params
from repro_torch.serving import engine as E
from repro_torch.training.tree import flatten

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
CFG = "deepseek-v32-exp-ess-smoke"
TIERS = ("bf16", "int8")
B, S, MAX_SEQ, CHUNK, ROUNDS = 4, 20, 32, 8, 4
SLOT_LENS = (20, 12, 17, 7)          # the per-slot path's ragged prompts
WORLDS = {"data2": (2, 1), "data2xmodel2": (4, 2)}
TOL = dict(rtol=1e-5, atol=1e-5)

REF = """
import dataclasses, sys
import jax, jax.numpy as jnp, numpy as np
from repro.cache import latent_cache as JLC
from repro.configs import get_config
from repro.serving import engine as JE

d, tier = sys.argv[1], sys.argv[2]
a = dict(np.load(d + "/inputs.npz"))
params = {}
for k, v in a.items():
    if k.startswith("p/"):
        node = params
        *head, last = k[2:].split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(v)
cfg = get_config("deepseek-v32-exp-ess-smoke")
cfg = dataclasses.replace(cfg, param_dtype=jnp.float32, ess=dataclasses.replace(
    cfg.ess, host_cache_dtype=tier))
cfg_x = dataclasses.replace(cfg, ess=dataclasses.replace(cfg.ess,
                                                         max_miss_ratio=1.0))
OPTS = {"xla_allow_excess_precision": False,
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}

def compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=OPTS)

toks, pos = a["toks"].astype(np.int32), a["pos"].astype(np.int32)
C, Bn, S = int(a["chunk"]), toks.shape[0], toks.shape[1]
W = min(cfg.ess.warmup_windows, S - 1)
caches = JLC.init_ess_caches(cfg, Bn, int(a["max_seq"]), jnp.float32)
# ess_prefill's own steps (use_kernel: a quantized tier's misses are bf16
# rows, as the port's), each jitted once
chunk = compiled(lambda p, t, q, c: JE.ess_prefill_chunk(
    p, cfg, t, q, c, use_kernel=True, n_valid=None)[:2], params,
    toks[:, :C], pos[:, :C], caches)
parts = []
for c0 in range(0, S - W, C):
    lg, caches = chunk(params, toks[:, c0:c0 + C], pos[:, c0:c0 + C], caches)
    parts.append(np.asarray(lg))

def decode_fn(c_):
    return compiled(lambda p, t, q, c: JE.ess_decode(
        p, c_, t, q, c, use_kernel=True, slot_mask=None),
        params, toks[:, :1], pos[:, :1], caches)
warm = decode_fn(cfg_x)
for w in range(S - W, S):
    o = warm(params, toks[:, w:w + 1], pos[:, w:w + 1], caches)
    caches = o.caches
    parts.append(np.asarray(o.logits))
out = {"prefill": np.concatenate(parts, 1)}
dec = decode_fn(cfg)
for r, tok in enumerate(a["forced"]):
    p = np.asarray(caches.lens)[:, None].astype(np.int32)
    o = dec(params, tok[:, None].astype(np.int32), p, caches)
    caches = o.caches
    out[f"round{r}"] = np.asarray(o.logits)
np.savez(f"{d}/ref_{tier}.npz", **out)
"""


def config(tier: str):
    c = get_config(CFG)
    return dataclasses.replace(c, param_dtype=torch.float32,
                               ess=dataclasses.replace(
                                   c.ess, host_cache_dtype=tier))


def inputs() -> dict:
    rng = np.random.default_rng(0)
    params = init_params(config("bf16"), 0, "cpu")
    a = {"p/" + "/".join(map(str, path)): leaf.numpy()
         for path, leaf in flatten(params)}
    a.update(toks=rng.integers(0, 256, (B, S)),
             pos=np.broadcast_to(np.arange(S), (B, S)).copy(),
             forced=rng.integers(0, 256, (ROUNDS, B)),
             slot_lens=np.array(SLOT_LENS), max_seq=np.int64(MAX_SEQ),
             chunk=np.int64(CHUNK))
    return params, a


def one_rank(params, a) -> dict:
    """The port on one rank, no context: the same steps as each rank."""
    out = {}
    toks = torch.from_numpy(a["toks"]).long()
    pos = torch.from_numpy(a["pos"]).long()
    for tier in TIERS:
        cfg = config(tier)
        with torch.no_grad():
            logits, caches = E.ess_prefill(params, cfg, toks, pos, MAX_SEQ,
                                           prefill_chunk=CHUNK)
            out[f"{tier}/prefill"] = logits.numpy()
            for r, tok in enumerate(a["forced"]):
                o = E.ess_decode(params, cfg,
                                 torch.from_numpy(tok).long()[:, None],
                                 caches.lens[:, None], caches,
                                 slot_mask=None)
                caches = o.caches
                out[f"{tier}/round{r}"] = o.logits.numpy()
            out[f"{tier}/caches"] = caches
            # the per-slot path
            sc = LC.init_ess_caches(cfg, B, MAX_SEQ, device="cpu")
            for slot, n in enumerate(SLOT_LENS):
                for c0 in range(0, n, CHUNK):
                    ck = min(CHUNK, n - c0)
                    t = torch.nn.functional.pad(
                        toks[slot:slot + 1, c0:c0 + ck], (0, CHUNK - ck))
                    _, sc, _, _ = E.ess_prefill_chunk(
                        params, cfg, t, c0 + torch.arange(CHUNK)[None], sc,
                        slot=slot, want_logits=False, n_valid=ck)
            o = E.ess_decode(params, cfg, torch.from_numpy(
                a["forced"][0]).long()[:, None], sc.lens[:, None], sc,
                slot_mask=None)
            out[f"{tier}/slot_logits"] = o.logits.numpy()
            out[f"{tier}/slot_tier"] = sc.host_latent.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    params, a = inputs()
    dirs = {k: str(tmp_path_factory.mktemp(k)) for k in (*WORLDS, "ref")}
    for d in dirs.values():
        np.savez(os.path.join(d, "inputs.npz"), **a)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    ref_env = dict(env, JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(REF), dirs["ref"], tier],
        env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for tier in TIERS]
    for name, (world, model) in WORLDS.items():
        procs += [subprocess.Popen(
            [sys.executable, os.path.join(HERE, "_torch_ess_rank_worker.py"),
             str(r), str(world), str(model), dirs[name]], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    port = one_rank(params, a)
    for p in procs:
        _, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
    ref = {t: dict(np.load(os.path.join(dirs["ref"], f"ref_{t}.npz")))
           for t in TIERS}
    ranks = {name: [dict(np.load(os.path.join(dirs[name], f"rank_{r}.npz")))
                    for r in range(world)]
             for name, (world, _) in WORLDS.items()}
    return a, ref, port, ranks


def rows(got: dict):
    b0 = int(got["first_row"])
    return slice(b0, b0 + B // 2)


def steps():
    return ["prefill"] + [f"round{r}" for r in range(ROUNDS)]


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("tier", TIERS)
def test_ranks_match_reference_ess_decode(runs, world, tier):
    _, ref, _, ranks = runs
    for r, got in enumerate(ranks[world]):
        for k in steps():
            np.testing.assert_allclose(
                got[f"{tier}/{k}"], ref[tier][k][rows(got)], **TOL,
                err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("tier", TIERS)
def test_ranks_match_one_rank_port(runs, world, tier):
    _, _, port, ranks = runs
    data_only = WORLDS[world][1] == 1
    for r, got in enumerate(ranks[world]):
        sl = rows(got)
        for k in steps():
            want = port[f"{tier}/{k}"][sl]
            if data_only:
                err = np.abs(got[f"{tier}/{k}"] - want).max()
                assert err <= 1e-6 * np.abs(want).max(), (r, k, err)
            else:
                np.testing.assert_allclose(got[f"{tier}/{k}"], want, **TOL,
                                           err_msg=f"rank {r} {k}")
        if not data_only:
            continue
        caches = port[f"{tier}/caches"]
        np.testing.assert_array_equal(got[f"{tier}/lens"],
                                      caches.lens[sl].numpy())
        for i, p in enumerate(caches.pools):
            for f in ("ids", "last_use", "slot_of"):
                np.testing.assert_array_equal(
                    got[f"{tier}/pool{i}/{f}"], getattr(p, f)[sl].numpy(),
                    err_msg=f"rank {r} pool {i} {f}")


@pytest.mark.parametrize("world", list(WORLDS))
@pytest.mark.parametrize("tier", TIERS)
def test_each_rank_tier_holds_its_own_rows(runs, world, tier):
    _, _, port, ranks = runs
    caches = port[f"{tier}/caches"]
    NP, NB = caches.host_latent.shape[1], caches.block_tables.shape[1]
    for r, got in enumerate(ranks[world]):
        b0 = int(got["first_row"])
        own = slice(b0 * NB, (b0 + B // 2) * NB)        # identity mapping
        assert got[f"{tier}/tier"].shape[1] == NP // 2
        np.testing.assert_array_equal(
            got[f"{tier}/block_tables"],
            np.arange(B // 2 * NB).reshape(B // 2, NB))
        if WORLDS[world][1] == 1:
            np.testing.assert_array_equal(
                got[f"{tier}/tier"], caches.host_latent[:, own].numpy())
            if tier != "bf16":
                np.testing.assert_array_equal(
                    got[f"{tier}/scales"],
                    caches.host_scales[:, own].numpy())


@pytest.mark.parametrize("tier", TIERS)
def test_data_only_round_collectives_are_the_moe_dispatch(runs, tier):
    """With the weights replicated, what a data-only decode round moves
    between ranks is the MoE layers' batch-wide capacity dispatch alone
    (its token-major cumsum and dispatch buffer, all-gathered): 3
    all-gathers a MoE layer, nothing else."""
    _, _, _, ranks = runs
    moe_layers = config(tier).num_layers - config(tier).moe.first_dense_layers
    for got in ranks["data2"]:
        np.testing.assert_array_equal(got[f"{tier}/collectives"],
                                      [3 * moe_layers, 0, 0, 0])


@pytest.mark.parametrize("tier", TIERS)
def test_per_slot_prefill_on_its_rank_matches_one_rank(runs, tier):
    _, _, port, ranks = runs
    NB = port[f"{tier}/caches"].block_tables.shape[1]
    for r, got in enumerate(ranks["data2"]):
        sl = rows(got)
        want = port[f"{tier}/slot_logits"][sl]
        assert np.abs(got[f"{tier}/slot_logits"] - want).max() \
            <= 1e-6 * np.abs(want).max(), r
        b0 = int(got["first_row"])
        np.testing.assert_array_equal(
            got[f"{tier}/slot_tier"],
            port[f"{tier}/slot_tier"][:, b0 * NB:(b0 + B // 2) * NB])


def test_kernel_wrappers_refuse_dtensors(runs):
    _, _, _, ranks = runs
    want = {"gather_rows", "gather_rows_raw", "gather_rows_dequant",
            "scatter_rows", "gather_pages", "gather_pages_dequant",
            "put_pages", "indexer_scores", "topk_select", "partial_attend",
            "merge_splits", "sparse_mla_gather_attend"}
    for got in ranks["data2"]:
        assert set(got["refused"].tolist()) == want
