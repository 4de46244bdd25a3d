"""The row gathers' two routes on the CPU: the route rule, and the staged
route's plan (mark -> each distinct row read once -> expand) in plain
torch, bit for bit against the direct plain versions and the JAX Pallas
kernels in interpret mode (tests/test_torch_cuda.py holds both CUDA
routes against the plain versions on the card).

Inputs come from seeded numpy; ids hold duplicates, ``-1`` and ids past
the end (``>= S``, read as the last row).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed.compression import quantize_rows as jquant
from repro.kernels.gather_cache import ops as jgops
from repro_torch.configs import get_config
from repro_torch.distributed.compression import dequantize_rows
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.kernels.gather_cache import ref as gref
from repro_torch.models.params import array_to_torch

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

QDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}
OUT = {"bf16": (jnp.bfloat16, torch.bfloat16),
       "f32": (jnp.float32, torch.float32)}
S, D = 16, 64


def T(a):
    return array_to_torch(np.asarray(a), "cpu")


def assert_bits(got: torch.Tensor, want) -> None:
    """Equal bit for bit; ``want`` a torch tensor or a JAX array."""
    if not isinstance(want, torch.Tensor):
        want = T(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def repeated_ids(rng, m):
    """m ids over S rows (m > S: they repeat), with -1 and ids >= S."""
    ids = rng.integers(-2, S + 3, (m,)).astype(np.int32)
    ids[:3] = (-1, S + 2, S - 1)
    return ids


def distinct_live(ids: np.ndarray) -> int:
    return len(np.unique(np.clip(ids[ids >= 0], 0, S - 1)))


def fetch_marked(cache, ids, scales=None, out_dtype=None):
    """The staged route's plan up to its expand: mark the distinct clipped
    ids ``>= 0``, read each marked row once (dequantized when ``scales``
    is given) into a staging copy ``[S, D]`` indexed by row.  Returns
    ``(rows read, staging)``; ``gather_rows_ref(staging, ids)`` is the
    expand."""
    flags = torch.zeros(cache.shape[0], dtype=torch.bool)
    flags[ids[ids >= 0].clamp_max(cache.shape[0] - 1)] = True
    rows = flags.nonzero().squeeze(1)
    staging = torch.zeros(cache.shape, dtype=cache.dtype if scales is None
                          else out_dtype)
    staging[rows] = cache[rows] if scales is None else dequantize_rows(
        cache[rows], scales[rows], out_dtype)
    return rows.numel(), staging


def test_route_rule_at_the_serve_shapes():
    """The serve cell's prefill call stages; its decode miss fetch and its
    warmup replay (every window's top-k missing at most) read directly."""
    cfg = get_config("deepseek-v32-exp-ess")
    B, C, K = 4, 256, cfg.dsa.index_topk
    R = cfg.ess.host_page_rows
    view = B * -(-(8192 + 32) // R) * R           # one layer of the tier
    assert view == 33024
    assert gops.staged_route(B * C * K, view)                    # prefill
    assert not gops.staged_route(B * int(cfg.ess.max_miss_ratio * K), view)
    assert not gops.staged_route(B * K, view)                    # warmup
    assert not gops.staged_route(view, view)
    assert gops.staged_route(view + 1, view)


@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_staged_plan_matches_direct_and_pallas_bitwise(dt):
    rng = np.random.default_rng(3)
    cache = rng.standard_normal((S, D), dtype=np.float32).astype(OUT[dt][0])
    ids = repeated_ids(rng, 4 * S)
    n, staging = fetch_marked(T(cache), T(ids).long())
    assert n == distinct_live(ids)                # each distinct row once
    got = gref.gather_rows_ref(staging, T(ids).long())
    fetched = torch.zeros(1, dtype=torch.int32)
    assert_bits(got, gops.gather_rows(T(cache), T(ids).long(),
                                      fetched=fetched))
    assert int(fetched) == distinct_live(ids)     # counted as staged
    assert_bits(got, gref.gather_rows_ref(T(cache), T(ids).long()))
    assert_bits(got, jgops.gather_rows(jnp.asarray(cache), jnp.asarray(ids)))


@pytest.mark.parametrize("out", ["bf16", "f32"])
@pytest.mark.parametrize("name", ["int8", "fp8"])
def test_staged_dequant_plan_matches_direct_and_pallas_bitwise(name, out):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((S, D)).astype(np.float32)
    x[5] = 0                                      # a zero-scale row
    q, s = (np.asarray(a) for a in jquant(jnp.asarray(x.astype(jnp.bfloat16)),
                                          QDT[name]))
    ids = repeated_ids(rng, 3 * S)
    jdt, tdt = OUT[out]
    n, staging = fetch_marked(T(q), T(ids).long(), T(s), tdt)
    assert n == distinct_live(ids)
    assert staging.dtype == tdt
    fetched = torch.zeros(1, dtype=torch.int32)
    got = gops.gather_rows_dequant(T(q), T(s), T(ids).long(), tdt,
                                   fetched=fetched)
    assert int(fetched) == distinct_live(ids)
    assert_bits(got, gref.gather_rows_ref(staging, T(ids).long()))
    assert_bits(got, gref.gather_rows_dequant_ref(T(q), T(s), T(ids).long(),
                                                  tdt))
    assert_bits(got, jgops.gather_rows_dequant(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(ids), jdt))


def test_direct_route_counts_every_live_id():
    """Below the rule's threshold the plain direct version runs, and a
    repeated id is read (and counted) each time it appears."""
    rng = np.random.default_rng(5)
    cache = T(rng.standard_normal((S, D), dtype=np.float32))
    ids = torch.tensor([3, 3, -1, S + 4, 0, 3])
    fetched = torch.zeros(1, dtype=torch.int32)
    got = gops.gather_rows(cache, ids, fetched=fetched)
    assert int(fetched) == 5
    assert torch.equal(got, gref.gather_rows_ref(cache, ids))


def test_staged_plan_with_no_live_id_is_all_zero():
    """A first prefill chunk has no prior rows: every id is -1."""
    cache = torch.randn((S, D)).bfloat16()
    ids = torch.full((2, 3 * S), -1)
    fetched = torch.zeros(1, dtype=torch.int32)
    got = gops.gather_rows(cache, ids, fetched=fetched)
    assert int(fetched) == 0 and got.shape == (2, 3 * S, D)
    assert not bool(got.float().abs().sum())


def test_uva_cache_hit_still_requires_pinned_memory(monkeypatch):
    """A host base left in the UVA cache by a storage since unpinned must
    not hand its stale mapping to ordinary memory at the same address."""
    t = torch.zeros((S, D))
    monkeypatch.setitem(gops._UVA, t.untyped_storage().data_ptr(), 1 << 40)
    with pytest.raises(ValueError, match="pinned"):
        gops.device_pointer(t)
