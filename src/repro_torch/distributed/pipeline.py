"""GPipe pipeline parallelism over one mesh dimension (counterpart of
``repro.distributed.pipeline``).

For multi-pod training, where the pod link is much slower than the links
inside a pod, pipelining the *layer stack* across pods trades the
per-step data-parallel all-reduce over that link for thin activations
between neighbouring stages.

Schedule: GPipe with M microbatches — stage s processes microbatch m at
tick t = s + m; bubbles = (S-1)/(M+S-1).  Every rank runs the same
program on its own stage slice of the stacked layer parameters; a stage
hands each finished microbatch to the next one with point-to-point
``isend`` / ``irecv`` (``batch_isend_irecv``) on the process group of
that mesh dimension, and at the end every stage receives the last
stage's outputs (the reference's masked ``psum``: a broadcast from the
last stage).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _stage_slice(t: torch.Tensor, mesh, axis: str, idx: int, n: int):
    """This stage's ``[L/n, ...]`` block of a stacked leaf: a DTensor is
    redistributed to ``Shard(0)`` on ``axis``; a whole tensor sliced."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if isinstance(t, DTensor):
        pl = [Replicate()] * mesh.ndim
        pl[list(mesh.mesh_dim_names).index(axis)] = Shard(0)
        return t.redistribute(mesh, pl).to_local()
    per = t.shape[0] // n
    return t[idx * per:(idx + 1) * per]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    while isinstance(tree, (dict, list, tuple)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree


def pipeline_apply(layer_fn: Callable, stacked_params, x: torch.Tensor,
                   mesh, *, axis: str = "pod",
                   microbatches: int = 4) -> torch.Tensor:
    """Run the layers split into ``n_stages = size(axis)`` contiguous
    stages.

    ``layer_fn(layer_params, x_micro) -> x_micro``; the leaves of
    ``stacked_params`` are ``[L, ...]`` with ``L % n_stages == 0`` (whole
    on every rank, or DTensors); ``x [B, ...]`` (the same on every rank)
    with ``B % microbatches == 0``.  Returns ``[B, ...]``, the same on
    every rank of the stage group."""
    n_stages = mesh.size(list(mesh.mesh_dim_names).index(axis))
    idx = mesh.get_local_rank(axis)
    group = mesh.get_group(axis)
    L = _first_leaf(stacked_params).shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches}")
    sparams = _tree_map(lambda t: _stage_slice(t, mesh, axis, idx,
                                               n_stages), stacked_params)
    n_local = L // n_stages
    mb = x.reshape((microbatches, B // microbatches) + tuple(x.shape[1:]))
    out = torch.zeros_like(mb)
    buf = mb.clone() if idx == 0 else torch.empty_like(mb)
    prev = dist.get_global_rank(group, idx - 1) if idx > 0 else None
    nxt = dist.get_global_rank(group, idx + 1) \
        if idx < n_stages - 1 else None

    for t in range(microbatches + n_stages - 1):
        m = t - idx                       # the microbatch this stage runs
        ops = []
        if 0 <= m < microbatches:
            y = buf[m]
            for i in range(n_local):
                y = layer_fn(_tree_map(lambda a: a[i], sparams), y)
            if nxt is None:
                out[m] = y
            else:
                ops.append(dist.P2POp(dist.isend, y.contiguous(), nxt,
                                      group))
        # the message from the stage before: its microbatch of this tick
        m_prev = t - idx + 1
        if prev is not None and 0 <= m_prev < microbatches:
            ops.append(dist.P2POp(dist.irecv, buf[m_prev], prev, group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    # every stage receives the last stage's collected outputs
    dist.broadcast(out, src=dist.get_global_rank(group, n_stages - 1),
                   group=group)
    return out.reshape(x.shape)
