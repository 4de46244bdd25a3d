"""Logical-axis sharding rules and the activation-constraint context
(counterpart of ``repro.distributed.sharding``).

Model code never names mesh dimensions.  It calls ``shard(x, "batch",
None, "embed")`` with *logical* axes; the active :class:`ShardingCtx`
(installed by a launcher or the dry run with :func:`use_sharding`) maps
them to the dimensions of its ``DeviceMesh`` and redistributes a DTensor
to the placements they name.  Outside a context ``shard`` returns its
argument itself, so the single-card paths and the CPU tests never see
it.

* A **spec** is the port's counterpart of a ``PartitionSpec``: a tuple
  with one entry a tensor dim, each ``None``, a mesh-dimension name or a
  tuple of names, trailing ``None`` dropped.
* :meth:`NamedSharding.placements` turns a spec into DTensor placements,
  one a mesh dimension: ``Shard(d)`` where tensor dim ``d`` names it,
  else ``Replicate()``.  A dim named by several mesh dimensions is split
  over them in mesh order, outer first (the order the rules name them).

Three rule profiles, as in the reference:

* ``tp``  — tensor-parallel weights over ``model``, replicated over
  ``data``; activations batch-sharded over (``pod``, ``data``).
* ``2d``  — also shards the non-TP weight dim over ``data`` (FSDP-style
  weight gathering, for >= 100B parameters).
* ``2d_ws`` — the weights-stationary decode variant of ``2d``.

The reference's ``shard_map_compat`` papers over two JAX versions'
``shard_map`` spellings and has no counterpart: the port's per-rank
programs (:mod:`.collectives`, :mod:`.pipeline`) run on a process group
directly.

Over several data ranks (the ESS decode, each rank on its own batch rows
and host-tier shard) a kernel wrapper never sees a DTensor: it raises on
one.  :func:`local_call` hands it one rank's local tensors of a
batch-major call and wraps the results back as DTensors sharded on batch
(the reference's ``axes_out``), with no collective; the LRU pool's
transitions run the same way, and :func:`local_mm` takes the products
DTensor has no strategy for.  :func:`batch_placements`,
:func:`batch_block`, :func:`to_local_batch` and :func:`from_local_batch`
are the batch layout they share with the host-tier routes
(:mod:`repro_torch.core.offload`) and the caches
(:func:`repro_torch.cache.latent_cache.init_ess_caches`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

_STATE = threading.local()


# Logical activation axes: batch, seq (sequence-parallel for long ctx),
# heads/kv/ff/embed/vocab/experts follow the parameter logical axes.
def rules_tp(multi_pod: bool, *, seq_data: bool = False) -> dict[str, Any]:
    data = ("pod", "data") if multi_pod else ("data",)
    r = {
        "batch": data, "heads": "model", "kv": "model", "ff": "model",
        "vocab": "model", "experts": "model",
        # the cache tier's batch axis: never unmapped (weights-stationary
        # profiles unmap "batch" for activations; caches stay
        # batch-parallel)
        "cache_batch": data,
        # Megatron-style sequence parallelism of the residual stream
        "seq_sp": "model",
    }
    if seq_data:
        # long context: batch too small to shard -> sequence over data
        r["seq"] = data
        r["batch"] = None
    return r


def rules_2d(multi_pod: bool, *, seq_data: bool = False) -> dict[str, Any]:
    r = rules_tp(multi_pod, seq_data=seq_data)
    data = ("pod", "data") if multi_pod else ("data",)
    # FSDP-style: shard the "long" replicated weight dims over data
    r.update({"embed": data, "ff2": "model"})
    return r


def rules_2d_ws(multi_pod: bool, *, seq_data: bool = False
                ) -> dict[str, Any]:
    """Weights-stationary decode variant of ``2d``: the activations'
    hidden dim takes the data axes (aligned with the weights' data-sharded
    contraction dim), batch leaves them; caches keep batch over data
    through their explicit annotations (``launch/steps.py``)."""
    r = rules_2d(multi_pod, seq_data=seq_data)
    data = ("pod", "data") if multi_pod else ("data",)
    r["batch"] = None
    r["embed_act"] = data
    return r


PROFILES = {"tp": rules_tp, "2d": rules_2d, "2d_ws": rules_2d_ws}


def mesh_sizes(mesh) -> dict[str, int]:
    """Mesh-dimension name -> size."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape)))


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def prune_spec(spec: tuple, shape: tuple[int, ...], mesh) -> tuple:
    """Drop mesh dimensions whose product does not divide the dim (8 kv
    heads on a 16-wide model axis): keeps the largest divisible prefix."""
    sizes = mesh_sizes(mesh)
    out: list = []
    for d, entry in enumerate(tuple(spec) + (None,) * (len(shape)
                                                       - len(spec))):
        keep: list[str] = []
        prod = 1
        for a in _names(entry):
            if shape[d] % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        out.append(None if not keep else keep[0] if len(keep) == 1
                   else tuple(keep))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``), with the
    memory the leaf lives in: ``None`` the device, ``"pinned_host"`` the
    host tier."""
    mesh: Any
    spec: tuple
    memory_kind: str | None = None

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for name in self.mesh.mesh_dim_names:
            dims = [d for d, e in enumerate(self.spec) if name in _names(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def shard_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """One rank's local shape (each named dim divides evenly)."""
        sizes = mesh_sizes(self.mesh)
        out = list(shape)
        for d, e in enumerate(self.spec):
            for a in _names(e):
                if out[d] % sizes[a]:
                    raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                     f"divide over {a}={sizes[a]}")
                out[d] //= sizes[a]
        return tuple(out)


class ShardingCtx:
    def __init__(self, mesh, rules: dict[str, Any]):
        self.mesh = mesh
        self.rules = dict(rules)

    def pspec(self, *axes: str | None) -> tuple:
        from repro_torch.models.params import axes_to_pspec
        return axes_to_pspec(axes, self.rules)

    def sharding(self, *axes: str | None,
                 memory_kind: str | None = None) -> NamedSharding:
        return NamedSharding(self.mesh, self.pspec(*axes), memory_kind)

    def sharding_for(self, shape: tuple[int, ...], axes,
                     memory_kind: str | None = None) -> NamedSharding:
        """Shape-aware: prunes mesh dimensions that do not divide."""
        spec = prune_spec(self.pspec(*axes), tuple(shape), self.mesh)
        return NamedSharding(self.mesh, spec, memory_kind)


def current() -> ShardingCtx | None:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: dict[str, Any] | None):
    prev = getattr(_STATE, "ctx", None)
    _STATE.ctx = ShardingCtx(mesh, rules or {}) if mesh is not None \
        else None
    try:
        yield _STATE.ctx
    finally:
        _STATE.ctx = prev


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (the dry run's leaves)."""
    if type(x) is torch.Tensor:        # the card's paths: no import
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *axes: str | None) -> torch.Tensor:
    """Constrain an activation's layout by logical axes.

    Outside a context: ``x`` itself.  Inside one: a wrong number of axes
    raises ``ValueError``; a DTensor is redistributed to the pruned spec's
    placements (itself when it has them); a plain tensor, which holds the
    whole value on its rank, is returned as it is (on a mesh of one, the
    card's paths, every tensor is plain)."""
    ctx = current()
    if ctx is None or ctx.mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"shard(): {len(axes)} axes for rank-{x.dim()} "
                         f"tensor")
    if not is_dtensor(x):
        return x
    pl = ctx.sharding_for(tuple(x.shape), axes).placements
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(x.device_mesh, pl)


def fit_unflatten(t: torch.Tensor, dim: int, lead: int) -> torch.Tensor:
    """``t`` ready to have dim ``dim`` split into ``[lead, rest]``: a
    DTensor sharded there over mesh dimensions whose product ``lead``
    does not take is replicated on them (DTensor cannot unflatten an
    uneven split; XLA's partitioner reshards the same way).  Anything
    else is returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    mesh, pl = t.device_mesh, list(t.placements)
    n = 1
    for i, p in enumerate(pl):
        if p == Shard(dim):
            if lead % (n * mesh.size(i)):
                pl[i] = Replicate()
            else:
                n *= mesh.size(i)
    if pl == list(t.placements):
        return t
    return t.redistribute(mesh, pl)


def logical_axis_size(name: str) -> int:
    """Product of the mesh-dimension sizes a logical axis maps to (1
    outside a context)."""
    ctx = current()
    if ctx is None or ctx.mesh is None:
        return 1
    sizes = mesh_sizes(ctx.mesh)
    n = 1
    for a in _names(ctx.rules.get(name)):
        n *= sizes.get(a, 1)
    return n


def logical_sharding(*axes, memory_kind: str | None = None):
    """The :class:`NamedSharding` of logical ``axes`` under the current
    context (None outside one)."""
    ctx = current()
    if ctx is None or ctx.mesh is None:
        return None
    return ctx.sharding(*axes, memory_kind=memory_kind)


# ---------------------------------------------------------------------------
# Abstract (meta) leaves for the dry run
# ---------------------------------------------------------------------------

def abstract(shape, dtype, sharding: NamedSharding | None = None,
             memory_kind: str | None = None) -> torch.Tensor:
    """A leaf that allocates nothing: a ``meta`` tensor of ``shape``, or,
    with a ``sharding``, a DTensor on ``meta`` whose local tensor is one
    rank's shard.  The memory kind (the sharding's, else
    ``memory_kind``) rides along as an attribute (:func:`memory_kind`)."""
    shape = tuple(int(s) for s in shape)
    if sharding is None:
        t = torch.empty(shape, dtype=dtype, device="meta")
        t.memory_kind = memory_kind
        return t
    from torch.distributed.tensor import DTensor
    local = torch.empty(sharding.shard_shape(shape), dtype=dtype,
                        device="meta")
    t = DTensor.from_local(local, sharding.mesh, sharding.placements,
                           run_check=False, shape=torch.Size(shape),
                           stride=torch.empty(shape, device="meta").stride())
    t.memory_kind = sharding.memory_kind
    return t


def abstract_like(t, dtype) -> torch.Tensor:
    """An abstract device leaf of ``t``'s shape and layout in ``dtype``
    (the optimizer's moments beside their parameters)."""
    if not is_dtensor(t):
        return abstract(t.shape, dtype)
    from torch.distributed.tensor import DTensor
    local = torch.empty(t.to_local().shape, dtype=dtype, device="meta")
    return DTensor.from_local(local, t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def memory_kind(t) -> str | None:
    """The memory an abstract leaf was tagged with (None: the device)."""
    return getattr(t, "memory_kind", None)


def local_shape(t) -> tuple[int, ...]:
    """One rank's shape of a leaf (a plain tensor's own)."""
    return tuple(t.to_local().shape) if is_dtensor(t) else tuple(t.shape)


def _as_dtensor(t, mesh, placements):
    """``t`` on ``mesh`` with ``placements``: a plain tensor is taken as
    replicated (the whole value on every rank) and chunked locally."""
    from torch.distributed.tensor import DTensor, Replicate
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(t.placements) != tuple(placements):
        t = t.redistribute(mesh, placements)
    return t


def put_drop_sharded(dst, idx: torch.Tensor, vals, keep: torch.Tensor,
                     local_put) -> None:
    """``local_put`` (``lru_pool.put_drop``'s semantics: in place
    ``dst[b, idx[b,j]] = vals[b,j]`` where ``keep``) on a DTensor ``dst``
    whose dims 0 and 1 may be sharded: each rank writes the entries that
    fall in its own block of dim 1, into its local shard, with no
    gather of ``dst`` (XLA's partitioned scatter).  ``vals`` is
    redistributed to ``dst``'s placements with dim 1 replicated, ``idx``
    and ``keep`` to its batch sharding."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = dst.device_mesh, tuple(dst.placements)
    B, M = idx.shape
    if not isinstance(vals, torch.Tensor):
        vals = torch.full((1, 1) + tuple(dst.shape[2:]), vals,
                          dtype=dst.dtype, device=dst.device)
    vals = vals.expand(B, M, *dst.shape[2:])
    v_pl = tuple(Replicate() if p == Shard(1) else p for p in pl)
    i_pl = tuple(p if p == Shard(0) else Replicate() for p in pl)
    v = _as_dtensor(vals, mesh, v_pl).to_local().to(dst.dtype)
    i = _as_dtensor(idx, mesh, i_pl).to_local()
    k = _as_dtensor(keep, mesh, i_pl).to_local()
    d = dst.to_local()
    _, off = compute_local_shape_and_global_offset(dst.shape, mesh, pl)
    i = i - off[1]
    k = k & (i >= 0) & (i < d.shape[1])
    local_put(d, i.clamp(0, max(d.shape[1] - 1, 0)), v, k)


# ---------------------------------------------------------------------------
# One rank's local tensors: kernel calls and the host tier
# ---------------------------------------------------------------------------

#: the mesh dimensions a batch (and the cache tier's batch) splits over
DATA_AXES = ("pod", "data")


def batch_split(mesh, n: int) -> tuple[int, ...]:
    """Indices of the mesh dimensions a batch of ``n`` rows splits over:
    the data dimensions, outer first, each kept while the product divides
    ``n`` (:func:`prune_spec`'s rule; a batch of 1 splits over none)."""
    out, prod = [], 1
    for i, name in enumerate(mesh.mesh_dim_names):
        if name in DATA_AXES and n % (prod * mesh.size(i)) == 0:
            out.append(i)
            prod *= mesh.size(i)
    return tuple(out)


def batch_placements(mesh, n: int, dim: int = 0) -> tuple:
    """DTensor placements of a tensor whose dim ``dim`` is a batch of ``n``
    rows: ``Shard(dim)`` on the dimensions of :func:`batch_split`,
    ``Replicate()`` on the others (``model`` included)."""
    from torch.distributed.tensor import Replicate, Shard
    split = batch_split(mesh, n)
    return tuple(Shard(dim) if i in split else Replicate()
                 for i in range(mesh.ndim))


def batch_block(mesh, n: int) -> tuple[int, int]:
    """``(first row, rows)`` of this rank's block of a batch of ``n``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(
        (n,), mesh, batch_placements(mesh, n))
    return int(off[0]), int(shape[0])


def data_ranks() -> int:
    """Ranks the batch splits over under the current context: the product
    of its mesh's data dimensions (1 outside a context)."""
    ctx = current()
    if ctx is None or ctx.mesh is None:
        return 1
    sizes = mesh_sizes(ctx.mesh)
    n = 1
    for a in DATA_AXES:
        n *= sizes.get(a, 1)
    return n


def to_local_batch(t, dim: int = 0):
    """This rank's rows of ``t``'s batch (dim ``dim``) as a plain tensor: a
    DTensor is first brought to :func:`batch_placements` (nothing moves
    when it is there already, as every batch-sharded tensor of the serve
    path is); anything else is returned as it is."""
    if not is_dtensor(t):
        return t
    pl = batch_placements(t.device_mesh, t.shape[dim] if t.dim() else 1,
                          dim)
    if tuple(t.placements) != pl:
        t = t.redistribute(t.device_mesh, pl)
    return t.to_local()


def from_local_batch(t: torch.Tensor, mesh, n: int, dim: int = 0):
    """A DTensor of global batch ``n`` (dim ``dim``) from this rank's rows
    ``t``, at :func:`batch_placements` (no collective)."""
    from torch.distributed.tensor import DTensor
    shape = list(t.shape)
    shape[dim] = n
    return DTensor.from_local(
        t, mesh, batch_placements(mesh, n, dim), run_check=False,
        shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def from_local_replicated(t: torch.Tensor, mesh):
    """A DTensor replicated over ``mesh`` from this rank's copy ``t`` (no
    collective: each rank holds the same value, such as the pools'
    clock)."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _map_tensors(fn, out):
    if isinstance(out, torch.Tensor):
        return fn(out)
    if isinstance(out, (tuple, list)):
        vals = [_map_tensors(fn, o) for o in out]
        if hasattr(out, "_fields"):
            return type(out)(*vals)
        return type(out)(vals)
    return out


def _tensors(tree) -> list:
    out: list = []
    _map_tensors(out.append, tree)
    return out


def local_call(fn, *args, **kwargs):
    """``fn`` (a kernel wrapper, or a batch-row-local step such as the
    LRU pool's) on this rank's local tensors.

    Every tensor argument, also inside a tuple or NamedTuple, is
    batch-major (dim 0) or a scalar.  Without a DTensor among them this is
    ``fn(*args, **kwargs)`` itself.  With one, each DTensor is taken at
    :func:`batch_placements` (its rows of the batch, whole over
    ``model``) and handed over as its local tensor (a replicated scalar
    as its own copy); a plain tensor holds the whole batch (a replicated
    value) and is cut to this rank's rows.  The results come back as
    DTensors of the global batch at the same placements (scalars
    replicated), the reference's ``axes_out=("cache_batch", ...)``: each
    rank computes its own rows, so no collective runs on the way out, and
    what ``fn`` updates in place is the DTensors' own storage."""
    dts = [a for a in _tensors((args, tuple(kwargs.values())))
           if is_dtensor(a)]
    if not dts:
        return fn(*args, **kwargs)
    mesh = dts[0].device_mesh
    n = next((a.shape[0] for a in dts if a.dim()), 1)
    start, rows = batch_block(mesh, n)

    def local(a):
        if not a.dim():
            return a.to_local() if is_dtensor(a) else a
        if a.shape[0] != n:
            raise ValueError(f"local_call: batch {a.shape[0]} beside {n}")
        if is_dtensor(a):
            return to_local_batch(a)
        return a if rows == n else a[start:start + rows]
    out = fn(*_map_tensors(local, args),
             **{k: _map_tensors(local, v) for k, v in kwargs.items()})

    return _map_tensors(lambda t: from_local_batch(t, mesh, n) if t.dim()
                        else from_local_replicated(t, mesh), out)


def empty_batch(like, shape, dtype) -> torch.Tensor:
    """``torch.empty(shape)`` on ``like``'s device, batch-major: a DTensor
    at :func:`batch_placements` when ``like`` (whose dim 0 is the same
    batch) is one, its local tensor allocated here (on the current
    stream)."""
    if not is_dtensor(like):
        return torch.empty(shape, dtype=dtype, device=like.device)
    rows = batch_block(like.device_mesh, shape[0])[1]
    t = torch.empty((rows, *shape[1:]), dtype=dtype, device=like.device)
    return from_local_batch(t, like.device_mesh, shape[0])


def local_mm(a, b, fn):
    """``a [M, K] @ b [K, N]`` of DTensors (a plain operand is taken as
    replicated) as ``fn(a_local, b_local)``, for a product DTensor has no
    strategy for (``torch.mm(..., out_dtype=)``): the contraction dim is
    made whole, each mesh dimension splits at most one of ``M`` and ``N``,
    and the result comes back at those placements (no collective when the
    operands are there already: a batch-sharded ``a``, a replicated or
    ``N``-sharded ``b``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = (a if is_dtensor(a) else b).device_mesh
    a, b = (t if is_dtensor(t) else from_local_replicated(t, mesh)
            for t in (a, b))
    pa, pb, po = list(a.placements), list(b.placements), []
    for i in range(mesh.ndim):
        if pa[i] != Shard(0):
            pa[i] = Replicate()
        if pb[i] != Shard(1) or pa[i] == Shard(0):
            pb[i] = Replicate()
        po.append(Shard(0) if pa[i] == Shard(0) else
                  Shard(1) if pb[i] == Shard(1) else Replicate())
    a = _as_dtensor(a, mesh, tuple(pa))
    b = _as_dtensor(b, mesh, tuple(pb))
    out = fn(a.to_local(), b.to_local())
    shape = (a.shape[0], b.shape[1])
    return DTensor.from_local(out, mesh, po, run_check=False,
                              shape=torch.Size(shape), stride=(shape[1], 1))
