"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, the
counterpart of the reference's ``test_dryrun_entrypoint_small_cell``:

* the CLI on qwen3-0.6b × decode_32k prints ``1 ok, 0 skipped, 0 errors``
  and exits 0; its record has rank 0's FLOPs, collectives and memory,
  every argument and output a ``meta`` tensor (nothing allocated);
* the cell's per-device argument bytes equal the sum over the
  reference's ``NamedSharding.shard_shape`` of every parameter and input
  leaf (the reference's int32 ids and ``lens`` counted at int64, the
  dtype the port's step takes), with no host-tier bytes;
* deepseek's long_500k ESS cell's abstract caches on both production
  meshes: the host tier (``host_latent``, paged and batch-major, tagged
  ``pinned_host``) against the device pools, indexer keys and tables,
  each side's per-device bytes equal to the sum over the reference's
  shard shapes (its pools at int64 ids, plus the port-only ``evicted``
  counter of each layer's pool); the same for every argument of the
  ``--ess`` decode_32k cell;
* the ops DTensor refused in four cells before (the MoE aux's counts, a
  weight or token flatten whose gradient splits unevenly, the host-tier
  scatter's plain version) run on meta DTensors (the aux's CPU values
  against the reference: ``test_torch_monolithic.py::
  test_moe_aux_matches_reference``), and the long_500k and ``--ess``
  decode_32k ESS decode steps, cut to a dense and a MoE layer, run on
  meta.

The port runs in subprocesses on a 512-rank ``fake`` process group (the
CLI, the cells' caches, the guards), the reference in one with 512
forced host devices (no compile), all at once.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

REF = """
import json, sys
import jax, numpy as np
from repro.distributed import sharding as shd
from repro.launch import steps as ST
from repro.launch.dryrun import cell_config
from repro.launch.mesh import make_production_mesh
def leaves(tree):
    out = []
    for x in jax.tree.leaves(tree):
        sh = x.sharding
        out.append([list(sh.shard_shape(x.shape)), np.dtype(x.dtype).name,
                    getattr(sh, "memory_kind", None) == "pinned_host"])
    return out
res = {}
cfg, cell = cell_config("qwen3-0.6b", "decode_32k")
with shd.use_sharding(make_production_mesh(),
                      shd.PROFILES["tp"](False)):
    params, _ = ST.abstract_state(cfg, cell)
    res["qwen3"] = leaves(params) + leaves(ST.input_specs(cfg, cell))
cfg, cell = cell_config("deepseek-v3-671b", "long_500k")
for mp in (False, True):
    with shd.use_sharding(make_production_mesh(multi_pod=mp),
                          shd.PROFILES["2d"](mp, seq_data=True)):
        c = ST.input_specs(cfg, cell)["caches"]
        res[f"ess/{mp}"] = {"leaves": leaves(c), "layers": len(c.pools)}
# the --ess decode_32k cell: batch 128 over data, the tier batch-sharded
cfg, cell = cell_config("deepseek-v32-exp-ess", "decode_32k")
for mp in (False, True):
    with shd.use_sharding(make_production_mesh(multi_pod=mp),
                          shd.PROFILES["2d"](mp)):
        specs = ST.input_specs(cfg, cell)
        res[f"ess32k/{mp}"] = {"leaves": leaves(specs),
                               "layers": len(specs["caches"].pools)}
json.dump(res, open(sys.argv[1], "w"))
"""

PORT_ESS = """
import json, sys
from repro_torch.launch import dryrun as D
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
D.init_fake_world()
cfg, cell = D.cell_config("deepseek-v3-671b", "long_500k")
res = {}
for mp in (False, True):
    prof = D.cell_profile(cfg, cell)
    with shd.use_sharding(make_production_mesh(multi_pod=mp,
                                               device_type="cpu"),
                          shd.PROFILES[prof](mp, seq_data=True)):
        c = ST.input_specs(cfg, cell)["caches"]
    res[f"ess/{mp}"] = {**D.argument_bytes(c), "meta": D.on_meta(c),
                        "profile": prof,
                        "host_kind": shd.memory_kind(c.host_latent),
                        "pool_kind": shd.memory_kind(c.pools[0].data)}
cfg, cell = D.cell_config("deepseek-v32-exp-ess", "decode_32k")
for mp in (False, True):
    prof = D.cell_profile(cfg, cell)
    with shd.use_sharding(make_production_mesh(multi_pod=mp,
                                               device_type="cpu"),
                          shd.PROFILES[prof](mp)):
        specs = ST.input_specs(cfg, cell)
    res[f"ess32k/{mp}"] = {**D.argument_bytes(specs), "profile": prof}

json.dump(res, open(sys.argv[1], "w"))
"""

PORT_GUARDS = """
import json, sys
from repro_torch.launch import dryrun as D
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as ST
from repro_torch.launch.mesh import make_production_mesh
D.init_fake_world()
# the guards of the cells DTensor refused: each op on meta DTensors of the
# 16 x 16 mesh, and the ESS decode steps cut to 2 layers (a dense one and
# a MoE one)
import dataclasses
import torch
from torch.distributed.tensor.experimental import implicit_replication
from repro_torch.kernels.gather_cache.ref import scatter_rows_ref
from repro_torch.models import layers as L
from repro_torch.models import moe
mesh = make_production_mesh(multi_pod=False, device_type="cpu")

def dt(shape, dtype, spec):
    return shd.abstract(shape, dtype, shd.NamedSharding(mesh, spec))
guards = {}
with implicit_replication():
    T, E, K = 64, 32, 4
    aux = moe._aux(dt((T, E), torch.float32, ("data",)),
                   dt((T, E), torch.float32, ("data",)),
                   dt((T, K), torch.int64, ("data",)),
                   dt((T * K,), torch.bool, ("data",)), E)
    guards["aux"] = all(shd.is_dtensor(a) for a in aux)
    # a gradient split 16 ways over 8 kv heads of [d, 8, 16]
    w = dt((64, 8, 16), torch.float32, ("data",)).requires_grad_()
    g = dt((64, 128), torch.float32, (None, "model"))
    try:
        torch.autograd.grad((w.reshape(64, -1) * g).sum(), [w])
        guards["plain_flatten_refused"] = False
    except RuntimeError:
        guards["plain_flatten_refused"] = True
    (gw,) = torch.autograd.grad((L.flat2d(w, 1) * g).sum(),
                                [w])
    guards["flat_grad_placements"] = gw.placements == w.placements
    # 16 sequences' tokens split over 16 x 16 ranks (deepseek's train
    # cell: 64 sequences of 4096 tokens)
    x = dt((16, 64, 32), torch.float32, ("data",)).requires_grad_()
    g = dt((1024, 32), torch.float32, (("data", "model"),))
    try:
        torch.autograd.grad((x.reshape(1024, -1) * g).sum(), [x])
        guards["plain_token_flatten_refused"] = False
    except RuntimeError:
        guards["plain_token_flatten_refused"] = True
    (gx,) = torch.autograd.grad((L.flat2d(x, 2) * g).sum(), [x])
    guards["token_flat_grad_placements"] = gx.placements == x.placements
    x = dt((32, 64), torch.float32, ("data",))
    (gw,) = torch.autograd.grad(
        (L.proj(x, w) * dt((32, 8, 16), torch.float32, ("data",))).sum(),
        [w])
    guards["proj_grad_placements"] = gw.placements == w.placements
m = torch.empty((100, 4), device="meta")
scatter_rows_ref(m, torch.empty((7,), dtype=torch.int64, device="meta"),
                 torch.empty((7, 4), device="meta"))
guards["scatter_meta"] = True
for arch, shape in (("deepseek-v3-671b", "long_500k"),
                    ("deepseek-v32-exp-ess", "decode_32k")):
    cfg, cell = D.cell_config(arch, shape)
    cfg = dataclasses.replace(cfg, num_layers=2, moe=dataclasses.replace(
        cfg.moe, first_dense_layers=1))
    rules = shd.PROFILES[D.cell_profile(cfg, cell)](
        False, seq_data=cell.global_batch == 1)
    with shd.use_sharding(mesh, rules):
        specs = ST.input_specs(cfg, cell)
        params, _ = ST.abstract_state(cfg, cell)
        with implicit_replication(), torch.no_grad():
            out = ST.make_step(cfg, cell)(params, specs)
    guards[f"step/{shape}"] = D.on_meta(out) and all(
        shd.is_dtensor(t) for t in out[1].ikeys)
json.dump(guards, open(sys.argv[1], "w"))
"""

# the port's dtype of each reference dtype (ids, positions, lens, tables)
PORT_ITEMSIZE = {"int32": 8}


def _bytes(leaves, host: bool) -> int:
    n = 0
    for shape, dt, on_host in leaves:
        if on_host == host:
            n += int(np.prod(shape)) * PORT_ITEMSIZE.get(
                dt, np.dtype(dt if dt != "bfloat16" else "float16").itemsize)
    return n


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    flags = "--xla_force_host_platform_device_count=512"
    ref_env = dict(env, XLA_FLAGS=flags, REPRO_XLA_FLAGS=flags)
    files = {k: str(d / f"{k}.json")
             for k in ("cli", "ref", "ess", "guards")}
    procs = {
        "cli": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-0.6b", "--shape", "decode_32k", "--out", files["cli"]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "ref": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(REF), files["ref"]],
            env=ref_env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "ess": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(PORT_ESS), files["ess"]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True),
        "guards": subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(PORT_GUARDS),
             files["guards"]], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    out = {}
    for k, p in procs.items():
        stdout, err = p.communicate(timeout=300)
        out[k] = (p.returncode, stdout, err)
    return out, {k: json.load(open(v)) if os.path.exists(v) else None
                 for k, v in files.items()}


def test_dryrun_entrypoint_small_cell(runs):
    out, data = runs
    rc, stdout, err = out["cli"]
    assert rc == 0, err[-3000:]
    assert "1 ok, 0 skipped, 0 errors" in stdout
    (rec,) = data["cli"]
    assert rec["status"] == "ok" and rec["meta_only"]
    assert rec["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert sum(rec["collectives"]["count_by_kind"].values()) > 0
    assert rec["memory"]["temp_bytes"] is None
    assert rec["memory"]["output_bytes"] > 0


def test_dryrun_argument_bytes_equal_reference_shard_shapes(runs):
    out, data = runs
    assert out["ref"][0] == 0, out["ref"][2][-3000:]
    (rec,) = data["cli"]
    ref = data["ref"]["qwen3"]
    assert rec["memory"]["argument_bytes"] == _bytes(ref, host=False)
    assert rec["memory"]["host_argument_bytes"] == _bytes(ref, host=True) \
        == 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_ess_long_cell_abstract_caches_host_tier_vs_device(runs, multi_pod):
    out, data = runs
    assert out["ess"][0] == 0, out["ess"][2][-3000:]
    got = data["ess"][f"ess/{multi_pod}"]
    ref = data["ref"][f"ess/{multi_pod}"]
    assert got["meta"] and got["profile"] == "2d"
    assert got["host_kind"] == "pinned_host" and got["pool_kind"] is None
    # the port's pools add an int64 [B] counter a layer (B = 1)
    evicted = ref["layers"] * 8
    assert got["host_argument_bytes"] == _bytes(ref["leaves"], host=True)
    assert got["argument_bytes"] == _bytes(ref["leaves"], host=False) \
        + evicted
    assert got["host_argument_bytes"] > 0


@pytest.mark.parametrize("multi_pod", [False, True])
def test_ess_decode_32k_argument_bytes_equal_reference_shard_shapes(
        runs, multi_pod):
    """The ``--ess`` decode_32k cell: batch 128 over the data axes, the
    host tier batch-sharded; rank 0's host and device argument bytes equal
    the reference's shard shapes (its ids and ``lens`` at int64, plus the
    port's ``evicted`` counter of each layer's pool)."""
    out, data = runs
    assert out["ess"][0] == 0, out["ess"][2][-3000:]
    got = data["ess"][f"ess32k/{multi_pod}"]
    ref = data["ref"][f"ess32k/{multi_pod}"]
    assert got["profile"] == "2d"
    evicted = ref["layers"] * 8 * 128 // (32 if multi_pod else 16)
    assert got["host_argument_bytes"] == _bytes(ref["leaves"], host=True) > 0
    assert got["argument_bytes"] == _bytes(ref["leaves"], host=False) \
        + evicted


@pytest.mark.parametrize("guard", [
    "aux", "plain_flatten_refused", "flat_grad_placements",
    "proj_grad_placements", "plain_token_flatten_refused",
    "token_flat_grad_placements", "scatter_meta", "step/long_500k",
    "step/decode_32k"])
def test_refused_cells_ops_run_on_meta_dtensors(runs, guard):
    """The ops DTensor refused in four dry-run cells, on meta DTensors of
    the 16 x 16 mesh: the MoE aux's expert counts (no ``bincount``); a
    weight flatten whose gradient splits 8 kv heads 16 ways, and a token
    flatten whose gradient splits 16 sequences 256 ways (the plain
    reshape is refused, ``flat2d`` returns the gradient at the tensor's
    placements, also through ``proj``); the host-tier scatter's plain
    version (no data-dependent shape); the ESS decode steps of long_500k
    and of the ``--ess`` decode_32k cell, cut to a dense and a MoE layer,
    every output on meta."""
    out, data = runs
    assert out["guards"][0] == 0, out["guards"][2][-3000:]
    assert data["guards"][guard] is True
