"""The port's kernel modules against the JAX Pallas kernels (interpret mode)
(tests/test_torch_cuda.py holds each CUDA kernel against its plain
version on the card).

Inputs come from seeded numpy and go to both packages.  Tolerances are the
reference's own (tests/test_kernels.py): fp32 1e-5, bf16 2e-2; gathers are
bit-exact.  The ``test_cuda_*`` tests need a card and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_cache import ops as jgops
from repro.kernels.indexer import ops as jiops
from repro.kernels.sparse_mla.sparse_mla import sparse_mla_partial_kernel
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.kernels.indexer import ops as iops
from repro_torch.kernels.sparse_mla import ops as sops
from repro_torch.models.params import array_to_torch

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

DTYPES = ["f32", "bf16"]
NP_DT = {"f32": np.float32, "bf16": jnp.bfloat16}


def tol(dt):
    return dict(rtol=2e-2, atol=2e-2) if dt == "bf16" \
        else dict(rtol=1e-5, atol=1e-5)


def randn(rng, shape, dt):
    return rng.standard_normal(shape, dtype=np.float32).astype(NP_DT[dt])


def t(a, device="cpu"):
    return array_to_torch(a, device)


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("S,D,M", [(64, 576, 16), (100, 64, 7), (33, 128, 33)])
def test_gather_rows_matches_pallas_bitwise(dt, S, D, M):
    rng = np.random.default_rng(0)
    cache = randn(rng, (S, D), dt)
    ids = rng.integers(-3, S + 2, (M,)).astype(np.int32)
    ids[0] = -1
    want = np.asarray(jgops.gather_rows(jnp.asarray(cache), jnp.asarray(ids)))
    got = gops.gather_rows(t(cache), t(ids).long())
    np.testing.assert_array_equal(got.float().numpy(),
                                  want.astype(np.float32))


def test_gather_rows_batched_matches_pallas():
    rng = np.random.default_rng(1)
    cache = randn(rng, (2, 20, 32), "f32")
    ids = rng.integers(-2, 20, (2, 9)).astype(np.int32)
    want = np.asarray(jgops.gather_rows(jnp.asarray(cache), jnp.asarray(ids)))
    got = gops.gather_rows(t(cache), t(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_plain_drops_out_of_range():
    rng = np.random.default_rng(2)
    dst = randn(rng, (10, 8), "f32")
    rows = randn(rng, (4, 8), "f32")
    tgt = np.array([3, -1, 10, 7])
    want = dst.copy()
    want[3], want[7] = rows[0], rows[3]
    got = gops.scatter_rows(t(dst), t(tgt), t(rows))
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_rows_plain_fixed_shape_equals_boolean_index():
    """The plain scatter writes dropped rows back onto the last kept
    row's target (a fixed shape, so it runs on ``meta``): bit for bit the
    boolean-index version it replaced, duplicate targets (the last write
    wins, on this file's one torch thread), all-dropped and empty calls,
    bf16 rows into fp32 included."""
    from repro_torch.kernels.gather_cache.ref import scatter_rows_ref

    def boolean_index(dst, tgt, rows):
        keep = (tgt >= 0) & (tgt < dst.shape[0])
        dst[tgt[keep]] = rows[keep].to(dst.dtype)
        return dst
    g = torch.Generator().manual_seed(0)
    for case in range(400):
        N = int(torch.randint(1, 12, (1,), generator=g))
        M = int(torch.randint(0, 20, (1,), generator=g))
        dst = torch.randn(N, 3, generator=g)
        tgt = torch.randint(-3, N + 3, (M,), generator=g)
        if case % 7 == 0:
            tgt = tgt.clamp_max(-1)                  # nothing kept
        rows = torch.randn(M, 3, generator=g)
        if case % 2:
            rows = rows.to(torch.bfloat16)
        assert torch.equal(scatter_rows_ref(dst.clone(), tgt, rows),
                           boolean_index(dst.clone(), tgt, rows)), case
    meta = torch.empty((100, 4), device="meta")
    out = scatter_rows_ref(meta, torch.empty((7,), dtype=torch.int64,
                                             device="meta"),
                           torch.empty((7, 4), device="meta"))
    assert out.device.type == "meta" and out.shape == (100, 4)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("Hi,Di,S", [(64, 128, 300), (10, 48, 64),
                                     (4, 32, 1000)])
def test_indexer_scores_matches_pallas(dt, Hi, Di, S):
    B, Q = 2, 3
    rng = np.random.default_rng(3)
    q = randn(rng, (B, Q, Hi, Di), dt)
    w = randn(rng, (B, Q, Hi), dt)
    keys = randn(rng, (B, S, Di), dt)
    valid = np.arange(S)[None, :] < np.array([S, S // 2])[:, None]
    want = np.asarray(jiops.indexer_scores(jnp.asarray(q), jnp.asarray(w),
                                           jnp.asarray(keys),
                                           jnp.asarray(valid)))
    got = iops.indexer_scores(t(q), t(w), t(keys), t(valid)).numpy()
    mask = want > -1e37
    np.testing.assert_array_equal(got > -1e37, mask)
    np.testing.assert_allclose(got[mask], want[mask], **tol(dt))
    # the per-query [B,Q,S] mask form gives the same scores
    got3 = iops.indexer_scores(t(q), t(w), t(keys),
                               t(np.broadcast_to(valid[:, None], (B, Q, S))))
    np.testing.assert_array_equal(got3.numpy(), got)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H,D,K,R,kb", [
    (16, 576, 128, 512, 128), (12, 96, 100, 64, 32),
    (4, 64, 17, 32, 8), (128, 576, 256, 512, 128)])
def test_sparse_mla_partial_matches_pallas(dt, H, D, K, R, kb):
    rng = np.random.default_rng(4)
    q = randn(rng, (H, D), dt)
    rows = randn(rng, (K, D), dt)
    valid = rng.random(K) < 0.8
    valid[0] = True
    o, m, l = sparse_mla_partial_kernel(jnp.asarray(q), jnp.asarray(rows),
                                        jnp.asarray(valid), 0.1, R, kb=kb)
    part = sops.partial_attend(t(q)[None, None], t(rows)[None],
                               t(valid)[None], 0.1, R)
    np.testing.assert_allclose(part.m[0, 0].numpy(), np.asarray(m), **tol(dt))
    np.testing.assert_allclose(part.l[0, 0].numpy(), np.asarray(l), **tol(dt))
    # o sums K exp-weighted rows: its absolute tolerance is taken relative
    # to the output's scale.  At (128, 576, 256) two fp32 implementations
    # with different dot-product orders each sit ~3e-5 from a float64
    # truth (the exp amplifies the scores' rounding), so an absolute 1e-5
    # holds only between implementations that share XLA's dot.
    tl = tol(dt)
    tl["atol"] *= max(1.0, float(np.abs(np.asarray(o, np.float32)).max()))
    np.testing.assert_allclose(part.o[0, 0].numpy(), np.asarray(o), **tl)


def test_sparse_mla_empty_partial_merges_without_nan():
    from repro_torch.models import mla as M
    rng = np.random.default_rng(5)
    q = t(randn(rng, (1, 1, 4, 16), "f32"))
    rows = t(randn(rng, (1, 8, 16), "f32"))
    none = sops.partial_attend(q, rows, torch.zeros((1, 8), dtype=torch.bool),
                               0.25, 8)
    some = sops.partial_attend(q, rows, torch.ones((1, 8), dtype=torch.bool),
                               0.25, 8)
    assert bool((none.m == -2.0e38).all()) and bool((none.l == 0).all())
    merged = M.finalize_partial(M.merge_partials(none, some), torch.float32)
    assert torch.isfinite(merged).all()
    np.testing.assert_allclose(
        merged.numpy(),
        M.finalize_partial(some, torch.float32).numpy(), rtol=1e-6)
