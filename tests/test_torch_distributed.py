"""The port's distributed substrate over eight gloo processes against the
reference's own functions over eight forced JAX devices, on the same
inputs made from a seed with numpy (counterparts of the reference's
``test_pipeline_parallel_matches_sequential``,
``test_sharded_flash_decode_matches_oracle`` and
``test_compression_under_psum``, with their shapes and meshes):

* ``pipeline_apply``: GPipe over ``pod`` of a (4, 2) ``pod, model`` mesh,
  8 tanh layers in 4 stages, 4 microbatches;
* ``sharded_flash_decode``: the sequence of 64 keys over an (8,) ``data``
  mesh, one sequence with 40 valid keys;
* the compressed all-reduce: each rank's int8-compressed row, dequantized
  and averaged over the group.

Every rank's result is held against the reference's result and against
the plain oracle (the sequential layer loop, the softmax over all keys,
the true mean).  Tolerances, with the reference's own as ceilings: the
pipeline 1e-5 relative + 1e-6 absolute (reference: 1e-4 / 1e-5), the
flash merge 1e-5 (reference: 1e-5), the compressed mean 0.02 against the
true mean (reference: 0.02) and 1e-6 against the reference's compressed
mean (the same int8 grid; only the sum's order differs).

No process group is initialised in the test process itself: the eight
ranks are subprocesses (``tests/_torch_dist_worker.py``) meeting through a
file store, and the reference runs in a subprocess of its own, all eight
plus one at once.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

HERE = os.path.dirname(__file__)
SRC = os.path.join(HERE, "..", "src")
WORLD = 8

REF = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.distributed.collectives import sharded_flash_decode
from repro.distributed.compression import (compress_grads,
                                           decompress_grads, init_ef)
from repro.distributed.pipeline import pipeline_apply
from repro.distributed.sharding import shard_map_compat
from repro.launch.mesh import make_mesh

a = dict(np.load(sys.argv[1] + "/inputs.npz"))
out = {}
mesh = make_mesh((4, 2), ("pod", "model"))
out["pipeline"] = pipeline_apply(lambda lw, h: jnp.tanh(h @ lw),
                                 jnp.asarray(a["pipe_w"]),
                                 jnp.asarray(a["pipe_x"]), mesh,
                                 axis="pod", microbatches=4)
mesh = make_mesh((8,), ("data",))
out["flash"] = sharded_flash_decode(mesh, "data", jnp.asarray(a["q"]),
                                    jnp.asarray(a["k"]), jnp.asarray(a["v"]),
                                    jnp.asarray(a["valid"]), 0.25)

def allreduce_compressed(gs):
    q, s, _ = compress_grads(gs, init_ef(gs))
    deq = decompress_grads(q, s)
    return jax.tree.map(lambda x: jax.lax.pmean(x, "data"), deq)

fn = shard_map_compat(allreduce_compressed, mesh=mesh,
                      in_specs=({"w": P("data")},),
                      out_specs={"w": P("data")})
out["compress"] = fn({"w": jnp.asarray(a["grad"])})["w"]
np.savez(sys.argv[1] + "/ref.npz", **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    L, B, D = 8, 8, 16
    Bf, H, S, Df = 2, 4, 64, 16
    return {
        "pipe_w": (rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
        "pipe_x": rng.standard_normal((B, D)).astype(np.float32),
        "q": rng.standard_normal((Bf, H, Df)).astype(np.float32),
        "k": rng.standard_normal((Bf, S, Df)).astype(np.float32),
        "v": rng.standard_normal((Bf, S, Df)).astype(np.float32),
        "valid": np.arange(S)[None] < np.array([64, 40])[:, None],
        "grad": rng.standard_normal((8, 64)).astype(np.float32),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("dist"))
    a = _inputs()
    np.savez(os.path.join(d, "inputs.npz"), **a)
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    ref_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    procs = [subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF),
                               d], env=ref_env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
    procs += [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_dist_worker.py"),
         str(r), str(WORLD), d], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
    ref = dict(np.load(os.path.join(d, "ref.npz")))
    port = [dict(np.load(os.path.join(d, f"port_{r}.npz")))
            for r in range(WORLD)]
    return a, ref, port


def test_pipeline_parallel_matches_sequential_and_reference(runs):
    a, ref, port = runs
    want = a["pipe_x"]
    for i in range(a["pipe_w"].shape[0]):
        want = np.tanh(want @ a["pipe_w"][i])
    for r, got in enumerate(port):
        np.testing.assert_allclose(got["pipeline"], ref["pipeline"],
                                   rtol=1e-5, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["pipeline"], want, rtol=1e-5,
                                   atol=1e-6, err_msg=f"rank {r}")


def test_sharded_flash_decode_matches_oracle_and_reference(runs):
    a, ref, port = runs
    s = np.einsum("bhd,bsd->bhs", a["q"].astype(np.float64),
                  a["k"].astype(np.float64)) * 0.25
    s = np.where(a["valid"][:, None], s, -2e38)
    w = np.exp(s - s.max(-1, keepdims=True))
    w /= w.sum(-1, keepdims=True)
    want = np.einsum("bhs,bsd->bhd", w, a["v"].astype(np.float64))
    for r, got in enumerate(port):
        np.testing.assert_allclose(got["flash"], ref["flash"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["flash"], want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"rank {r}")


def test_compression_under_all_reduce_matches_reference(runs):
    a, ref, port = runs
    mean = a["grad"].mean(axis=0, keepdims=True)
    for r, got in enumerate(port):
        # the reference's out_specs P("data"): rank r holds row r
        np.testing.assert_allclose(got["compress"], ref["compress"][r:r + 1],
                                   rtol=0, atol=1e-6, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["compress"], mean, atol=0.02,
                                   err_msg=f"rank {r}")
