"""One gloo rank of ``tests/test_torch_distributed.py``: run as
``python tests/_torch_dist_worker.py RANK WORLD DIR`` with ``src`` on the
path, eight of them at once.  Each rank joins a process group through a
file store in ``DIR``, reads the seeded inputs ``DIR/inputs.npz``, runs
the port's ``pipeline_apply`` on a (4, 2) ``pod, model`` mesh,
``sharded_flash_decode`` on an (8,) ``data`` mesh and the compressed
gradient all-reduce on its own row of the gradients, and writes its
results to ``DIR/port_RANK.npz``."""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.collectives import sharded_flash_decode
from repro_torch.distributed.compression import allreduce_compressed, init_ef
from repro_torch.distributed.pipeline import pipeline_apply
from repro_torch.launch.mesh import make_mesh


def main(rank: int, world: int, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out}/store",
                            rank=rank, world_size=world)
    a = {k: torch.from_numpy(v) for k, v in
         np.load(os.path.join(out, "inputs.npz")).items()}
    res = {}
    mesh = make_mesh((4, 2), ("pod", "model"), "cpu")
    res["pipeline"] = pipeline_apply(
        lambda lw, h: torch.tanh(h @ lw), a["pipe_w"], a["pipe_x"], mesh,
        axis="pod", microbatches=4)
    mesh = make_mesh((8,), ("data",), "cpu")
    res["flash"] = sharded_flash_decode(mesh, "data", a["q"], a["k"],
                                        a["v"], a["valid"], 0.25)
    g = {"w": a["grad"][rank:rank + 1]}        # this rank's row: P("data")
    mean, _ = allreduce_compressed(g, init_ef(g), mesh.get_group("data"))
    res["compress"] = mean["w"]
    np.savez(os.path.join(out, f"port_{rank}.npz"),
             **{k: v.numpy() for k, v in res.items()})
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
