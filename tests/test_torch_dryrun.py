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
  counter of each layer's pool).

The port runs in subprocesses on a 512-rank ``fake`` process group, the
reference in one with 512 forced host devices (no compile), all at once.
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
json.dump(res, open(sys.argv[1], "w"))
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
    files = {k: str(d / f"{k}.json") for k in ("cli", "ref", "ess")}
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
            text=True)}
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
