"""The port's sharding substrate against the reference's
(``repro_torch.distributed.sharding``, the logical axes of
``repro_torch.models.params``, the dry-run half of
``repro_torch.launch.steps``), exactly:

* ``rules_tp`` / ``rules_2d`` / ``rules_2d_ws`` for both meshes, with and
  without ``seq_data``; ``axes_to_pspec`` and ``prune_spec`` over every
  leaf's axes under every profile, on both production meshes;
* every ``ParamDef``'s shape and logical axes, for every registered
  config (the port's defs sit in one tree, ``params.model_def``);
* the per-device shard shape (and host / device memory) of every
  parameter, optimizer, cache and input leaf of all 40 dry-run cells on
  the single-pod (16 x 16) and multi-pod (2 x 16 x 16) meshes, under the
  profile the dry run picks; the reference's side is
  ``NamedSharding.shard_shape`` on its ``abstract_state`` /
  ``input_specs``.  Leaves are compared in flatten order; the port's
  pools carry one leaf more (``PoolState.evicted``, a port-only counter,
  batch-sharded), left out of the comparison;
* ``dp_degree``, ``auto_accum`` and ``seq_axis_name`` of every cell.

Also: ``shard`` is an exact no-op outside a context (the tensor itself)
and raises ``ValueError`` on a wrong number of axes inside one.

The reference runs in one subprocess with 512 forced host devices (no
compile: shardings of ``ShapeDtypeStruct`` trees only), the port in one
subprocess on a 512-rank ``fake`` process group (``meta`` DTensors), so
no process group is initialised in the test process; both at once.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.distributed import sharding as shd

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

COMMON = """
import json, sys
from repro{T}.configs import ASSIGNED, SHAPES
from repro{T}.launch import steps as ST
from repro{T}.launch.dryrun import SKIPS, cell_config
from repro{T}.launch.mesh import make_production_mesh
PROFILES = shd.PROFILES
out = {{"rules": {{}}, "pspec": {{}}, "defs": {{}}, "cells": {{}}}}
meshes = {{False: make_production_mesh(multi_pod=False{DEV}),
          True: make_production_mesh(multi_pod=True{DEV})}}
for name, fn in PROFILES.items():
    for mp in (False, True):
        for sd in (False, True):
            r = fn(mp, seq_data=sd)
            out["rules"][f"{{name}}/{{mp}}/{{sd}}"] = sorted(
                (k, list(v) if isinstance(v, tuple) else v)
                for k, v in r.items())
def tolist(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]
for cname in sorted(NAMES):
    leaves = DEFS(cname)
    out["defs"][cname] = [[p, list(s), list(a)] for p, s, a in leaves]
    if cname not in ASSIGNED and cname != "deepseek-v32-exp-ess":
        continue
    for name, fn in PROFILES.items():
        for mp in (False, True):
            rules = fn(mp, seq_data=False)
            out["pspec"][f"{{cname}}/{{name}}/{{mp}}"] = [
                [tolist(axes_to_pspec(a, rules)),
                 tolist(shd.prune_spec(axes_to_pspec(a, rules), tuple(s),
                                       meshes[mp]))]
                for _, s, a in leaves]
for arch in ASSIGNED:
    for shape in SHAPES:
        if (arch, shape) in SKIPS:
            continue
        cfg, cell = cell_config(arch, shape)
        prof = cfg.sharding_profile
        if cell.kind == "decode" and prof == "2d" and not ESS(cfg):
            prof = "2d_ws"
        for mp in (False, True):
            rules = PROFILES[prof](mp, seq_data=cell.global_batch == 1)
            with shd.use_sharding(meshes[mp], rules):
                params, opt = ST.abstract_state(cfg, cell)
                specs = ST.input_specs(cfg, cell)
                rec = {{"params": LEAVES(params), "opt": LEAVES(opt),
                       "specs": LEAVES(specs), "dp": ST.dp_degree(),
                       "accum": ST.auto_accum(cell) if cell.kind == "train"
                       else None, "seq": ST.seq_axis_name(cell)}}
            out["cells"][f"{{arch}}/{{shape}}/{{mp}}"] = rec
json.dump(out, open(sys.argv[1], "w"))
"""

REF = """
import jax
from repro.configs.base import _REGISTRY
import repro.configs
from repro.distributed import sharding as shd
from repro.models import transformer as T
from repro.models.params import axes_to_pspec, is_def
NAMES = list(_REGISTRY)
ESS = lambda cfg: cfg.ess.enabled
def key(k):
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))
def DEFS(cname):
    from repro.configs import get_config
    flat = jax.tree_util.tree_flatten_with_path(
        T.model_def(get_config(cname)), is_leaf=is_def)[0]
    return [("/".join(key(k) for k in p), d.shape,
             d.axes or (None,) * len(d.shape)) for p, d in flat]
def LEAVES(tree):
    if tree is None:
        return []
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    out = []
    for p, x in flat:
        sh = getattr(x, "sharding", None)
        out.append(["/".join(key(k) for k in p), list(x.shape),
                    list(sh.shard_shape(x.shape)) if sh is not None
                    else list(x.shape),
                    getattr(sh, "memory_kind", None) == "pinned_host"])
    return out
""" + COMMON.format(T="", DEV="")

PORT = """
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=512)
from repro_torch.configs.base import _REGISTRY, ess_enabled
import repro_torch.configs
from repro_torch.distributed import sharding as shd
from repro_torch.models import params as PM
from repro_torch.models.params import axes_to_pspec
from repro_torch.training.tree import flatten
NAMES = list(_REGISTRY)
ESS = ess_enabled
def DEFS(cname):
    from repro_torch.configs import get_config
    flat = flatten(PM.model_def(get_config(cname)))
    return [("/".join(str(k) for k in p), d.shape,
             d.axes or (None,) * len(d.shape)) for p, d in flat]
def LEAVES(tree):
    out = []
    for p, x in flatten(tree):
        if p[-1] == ".evicted":            # port-only pool counter
            continue
        out.append(["/".join(str(k).lstrip(".") for k in p), list(x.shape),
                    list(shd.local_shape(x)),
                    shd.memory_kind(x) == "pinned_host"])
    return out
""" + COMMON.format(T="_torch", DEV=', device_type="cpu"')


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    d = tmp_path_factory.mktemp("shard")
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count"
                                  "=512",
                   REPRO_XLA_FLAGS="--xla_force_host_platform_device_count"
                                   "=512")
    outs = {k: str(d / f"{k}.json") for k in ("ref", "port")}
    procs = {
        "ref": subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF),
                                 outs["ref"]], env=ref_env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen([sys.executable, "-c",
                                  textwrap.dedent(PORT), outs["port"]],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)}
    for k, p in procs.items():
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, (k, err[-3000:])
    return {k: json.load(open(v)) for k, v in outs.items()}


def test_rules_match_reference(both):
    assert both["port"]["rules"] == both["ref"]["rules"]


def test_axes_to_pspec_and_prune_spec_match_reference(both):
    ref, port = both["ref"]["pspec"], both["port"]["pspec"]
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k] == ref[k], k


def test_every_param_def_axes_and_shape_match_reference(both):
    """Every leaf of every registered config's ``model_def``: path, shape
    and logical axes (the stacked ``layers`` axis included)."""
    ref, port = both["ref"]["defs"], both["port"]["defs"]
    assert sorted(port) == sorted(ref)
    for name in ref:
        assert port[name] == ref[name], name


@pytest.mark.parametrize("part", ["params", "opt", "specs"])
def test_cell_shard_shapes_match_reference(both, part):
    """Global shape, per-device shard shape and host / device memory of
    every leaf of all 40 cells on both production meshes."""
    ref, port = both["ref"]["cells"], both["port"]["cells"]
    assert sorted(port) == sorted(ref)
    assert len(ref) == 2 * (40 - 7)            # 7 skipped cells
    n = 0
    for k in ref:
        got = [g[1:] for g in port[k][part]]
        want = [w[1:] for w in ref[k][part]]
        assert got == want, k
        n += len(want)
    assert n > 0


def test_dp_degree_auto_accum_and_seq_axis_match_reference(both):
    ref, port = both["ref"]["cells"], both["port"]["cells"]
    for k in ref:
        assert (port[k]["dp"], port[k]["accum"], port[k]["seq"]) == \
            (ref[k]["dp"], ref[k]["accum"], ref[k]["seq"]), k


def test_shard_is_a_no_op_outside_a_context_and_checks_rank():
    x = torch.randn(2, 3, 4)
    assert shd.current() is None
    assert shd.shard(x, "batch", None, "embed") is x
    assert shd.shard(x, "batch") is x           # no check outside
    assert shd.logical_axis_size("batch") == 1
    assert shd.logical_sharding("batch") is None

    class Mesh:                                 # a mesh's names and sizes
        mesh_dim_names = ("data", "model")
        mesh = torch.empty(1, 1)
    with shd.use_sharding(Mesh(), shd.rules_tp(False)) as ctx:
        assert shd.current() is ctx
        with pytest.raises(ValueError):
            shd.shard(x, "batch", None)
        # a plain tensor on a mesh of one stays itself
        assert shd.shard(x, "batch", None, "embed") is x
        assert shd.logical_axis_size("batch") == 1
    assert shd.current() is None
