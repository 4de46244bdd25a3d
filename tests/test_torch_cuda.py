"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and nvcc; without one they skip.  They
import neither JAX nor the reference package, so they run on a machine
that has only PyTorch (the repository's conftest imports JAX, hence
``--noconftest``):

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Both sides compute in fp32 from the same inputs, so the float kernels are
held at rtol/atol 1e-4 (summation order only: the sparse-MLA tensor-core
route multiplies bf16 inputs exactly and keeps P to about 16 bits as a
hi + lo pair of bf16 halves), the indexer scores at rtol 1e-4, atol 1e-3
with their -2e38 entries bit for bit (both routes: bf16 products are
exact in fp32, summation order only); the row and page gathers
(plain and fused dequant, both routes of the row gathers), the scatter
and the quantize-and-write path are bit-exact.
"""

import functools

import pytest
import torch

from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.kernels.gather_cache import ref as gref
from repro_torch.kernels.indexer import ops as iops
from repro_torch.kernels.indexer import ref as iref
from repro_torch.kernels.sparse_mla import ops as sops

DTYPES = ["f32", "bf16"]
TORCH_DT = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_gather_rows_uva_bitwise(cuda, dt):
    g = torch.Generator().manual_seed(0)
    host = torch.randn((300, 576), generator=g).to(TORCH_DT[dt]).pin_memory()
    ids = torch.randint(-2, 310, (257,), generator=g)
    n0 = gops.gather_rows.launches
    got = gops.gather_rows(host, ids.to(cuda))
    assert gops.gather_rows.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gref.gather_rows_ref(host, ids))


def test_cuda_gather_rows_refuses_unpinned_host(cuda):
    with pytest.raises(ValueError, match="pinned"):
        gops.gather_rows(torch.zeros((4, 8)), torch.zeros(2, dtype=torch.long,
                                                          device=cuda))


def _heavy_ids(g, m, s, distinct):
    """m ids (m > s) drawn from ``distinct`` rows of s, with -1 and ids
    past the end (read as the last row): heavy duplication."""
    pick = torch.randperm(s, generator=g)[:distinct]
    ids = pick[torch.randint(0, distinct, (m,), generator=g)]
    ids[::9] = -1
    ids[5::97] = s + 3
    return ids


def _distinct_live(ids, s):
    return int(ids[ids >= 0].clamp_max(s - 1).unique().numel())


@pytest.mark.parametrize("on_card", [False, True], ids=["pinned", "device"])
@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_gather_rows_staged_bitwise(cuda, dt, on_card):
    g = torch.Generator().manual_seed(6)
    S = 300
    cache = torch.randn((S, 576), generator=g).to(TORCH_DT[dt])
    cache = cache.to(cuda) if on_card else cache.pin_memory()
    ids = _heavy_ids(g, 20 * S, S, 37).reshape(4, 5 * S)
    assert gops.staged_route(ids.numel(), S)
    n0, st0, di0 = (gops.gather_rows.launches, gops.gather_rows.launches_staged,
                    gops.gather_rows.launches_direct)
    fetched = torch.zeros(1, dtype=torch.int32, device=cuda)
    # the rule reads a device cache directly: name the staged route there
    got = gops.gather_rows(cache, ids.to(cuda), fetched=fetched,
                           route="staged" if on_card else None)
    assert (gops.gather_rows.launches, gops.gather_rows.launches_staged,
            gops.gather_rows.launches_direct) == (n0 + 1, st0 + 1, di0)
    torch.cuda.synchronize()
    assert got.shape == (4, 5 * S, 576)
    assert torch.equal(got.cpu(), gref.gather_rows_ref(cache.cpu(), ids))
    assert int(fetched) == _distinct_live(ids, S)     # each row read once


def test_cuda_gather_rows_direct_route_and_counts(cuda):
    g = torch.Generator().manual_seed(7)
    host = torch.randn((300, 576), generator=g).bfloat16().pin_memory()
    ids = _heavy_ids(g, 300, 300, 20)                  # M == S: direct
    st0, di0 = (gops.gather_rows.launches_staged,
                gops.gather_rows.launches_direct)
    fetched = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = gops.gather_rows(host, ids.to(cuda), fetched=fetched)
    assert (gops.gather_rows.launches_staged,
            gops.gather_rows.launches_direct) == (st0, di0 + 1)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gref.gather_rows_ref(host, ids))
    assert int(fetched) == int((ids >= 0).sum())      # every live id read
    # the UVA mapping of the tier is looked up once and reused
    assert host.untyped_storage().data_ptr() in gops._UVA
    assert gops.device_pointer(host[7:]) == \
        gops.device_pointer(host) + 7 * 576 * 2


def test_cuda_scatter_rows_uva_bitwise(cuda):
    g = torch.Generator().manual_seed(1)
    host = torch.randn((64, 576), generator=g).bfloat16().pin_memory()
    want = host.clone()
    rows = torch.randn((9, 576), generator=g).bfloat16()
    tgt = torch.tensor([0, 5, -1, 63, 64, 7, 8, 9, 30])
    gref.scatter_rows_ref(want, tgt, rows)
    gops.scatter_rows(host, tgt.to(cuda), rows.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(host, want)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("Hi,Di,S", [(64, 128, 1000), (2, 16, 40)])
def test_cuda_indexer_scores_vs_plain(cuda, dt, Hi, Di, S):
    g = torch.Generator().manual_seed(2)
    B, Q = 2, 3
    q = torch.randn((B, Q, Hi, Di), generator=g).to(TORCH_DT[dt])
    w = torch.randn((B, Q, Hi), generator=g).to(TORCH_DT[dt])
    keys = torch.randn((B, S, Di), generator=g).to(TORCH_DT[dt])
    valid = torch.arange(S)[None, None, :] < torch.tensor(
        [[S, S // 2, 1], [3, S, 0]])[:, :, None]
    want = iref.indexer_scores_ref(q, w, keys, valid)
    got = iops.indexer_scores(q.to(cuda), w.to(cuda), keys.to(cuda),
                              valid.to(cuda)).cpu()
    assert torch.equal(got <= -1e37, want <= -1e37)
    m = want > -1e37
    torch.testing.assert_close(got[m], want[m], rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# the indexer's tensor-core route (bf16, Di = 128, Hi % 64 == 0, Hi <= 256)
# ---------------------------------------------------------------------------

def _idx_inputs(g, B, Q, S, Hi=64, Di=128, dt=torch.bfloat16):
    return (torch.randn((B, Q, Hi, Di), generator=g).to(dt),
            torch.randn((B, Q, Hi), generator=g).to(dt),
            torch.randn((B, S, Di), generator=g).to(dt))


def _idx_vs_plain(cuda, q, w, keys, valid, route="tc"):
    """The card's scores on ``route`` against the plain fp32 version on the
    card (the serve's shapes are too large for the host's einsum): the
    -2e38 entries equal bit for bit, the others at rtol 1e-4, atol 1e-3
    (summation order only: bf16 products are exact in fp32)."""
    q, w, keys = q.to(cuda), w.to(cuda), keys.to(cuda)
    valid = None if valid is None else valid.to(cuda)
    assert iops.tc_route(q, keys) == (route == "tc")
    n = (iops.indexer_scores.launches_tc,
         iops.indexer_scores.launches_general)
    got = iops.indexer_scores(q, w, keys, valid)
    d = (iops.indexer_scores.launches_tc - n[0],
         iops.indexer_scores.launches_general - n[1])
    assert d == ((1, 0) if route == "tc" else (0, 1))
    want = iref.indexer_scores_ref(q, w, keys, valid)
    torch.cuda.synchronize()
    assert torch.equal(got == -2.0e38, want == -2.0e38)
    m = want != -2.0e38
    torch.testing.assert_close(got[m], want[m], rtol=1e-4, atol=1e-3)
    return got


def _prefix_mask(lens, Q, S, causal):
    """[B,Q,S]: key s valid below each query's length; causal chunks end at
    ``lens`` (query i of Q sits at lens - Q + i)."""
    lens = torch.as_tensor(lens)
    ar = torch.arange(S)
    if causal:
        qpos = lens[:, None] - Q + torch.arange(Q)
        return ar[None, None] <= qpos[..., None]
    return (ar[None, None] < lens[:, None, None]).expand(len(lens), Q, S)


@pytest.mark.parametrize("case", ["decode", "decode_q2", "prefill_causal"])
def test_cuda_indexer_tc_serve_shapes(cuda, case):
    """The serve's shapes: Q = 1 and Q = 2 decode over S = 8224 cached keys,
    and a causal Q = 256 chunk (its tiles past each group's last position
    skipped)."""
    g = torch.Generator().manual_seed(21)
    lens = [8193, 8200, 8207, 8224]
    Q, B = {"decode": (1, 4), "decode_q2": (2, 4),
            "prefill_causal": (256, 2)}[case]
    q, w, keys = _idx_inputs(g, B, Q, 8224)
    _idx_vs_plain(cuda, q, w, keys,
                  _prefix_mask(lens[:B], Q, 8224, case == "prefill_causal"))


@pytest.mark.parametrize("S", [1000, 1001, 64, 8224])
@pytest.mark.parametrize("Q", [1, 3, 8])
def test_cuda_indexer_tc_holey_masks(cuda, S, Q):
    """Random holes, a query with no valid key, whole tiles (and whole key
    spans) without one, S not a multiple of 64 and rows not 16-byte
    aligned (S = 1001: the flags are read a byte at a time)."""
    g = torch.Generator().manual_seed(22)
    B = 2
    q, w, keys = _idx_inputs(g, B, Q, S)
    valid = torch.rand((B, Q, S), generator=g) < 0.5
    valid[0, 0] = False                          # no valid key
    valid[1, :, :min(S, 640)] = False            # tiles 0-9 skipped
    if S > 5000:
        valid[0, :, 4096:] = False               # whole spans at decode
    got = _idx_vs_plain(cuda, q, w, keys, valid)
    assert bool((got[0, 0] == -2.0e38).all())


def test_cuda_indexer_tc_mask_forms(cuda):
    """valid None, [B,S] (broadcast over Q, stride 0) and a [B,Q,S] view
    whose keys are not contiguous give the plain version's scores."""
    g = torch.Generator().manual_seed(23)
    B, Q, S = 2, 5, 777
    q, w, keys = _idx_inputs(g, B, Q, S)
    _idx_vs_plain(cuda, q, w, keys, None)
    v2 = torch.rand((B, S), generator=g) < 0.7
    _idx_vs_plain(cuda, q, w, keys, v2)
    wide = torch.rand((B, Q, 2 * S), generator=g) < 0.7
    _idx_vs_plain(cuda, q, w, keys, wide[..., ::2])


@pytest.mark.parametrize("dt,Hi,Di,route", [
    (torch.bfloat16, 64, 128, "tc"), (torch.bfloat16, 128, 128, "tc"),
    (torch.bfloat16, 192, 128, "tc"), (torch.bfloat16, 256, 128, "tc"),
    (torch.float32, 64, 128, "general"), (torch.bfloat16, 96, 128, "general"),
    (torch.bfloat16, 64, 64, "general"), (torch.bfloat16, 320, 128,
                                          "general")])
@pytest.mark.parametrize("Q", [1, 2, 7])
def test_cuda_indexer_routes(cuda, dt, Hi, Di, route, Q):
    """bf16 at Di = 128 and Hi a multiple of 64 up to 256 takes the
    tensor-core kernel (every query grouping: 1, 2 or 4 per CTA); fp32 and
    other widths the general one.  Both agree with the plain version."""
    g = torch.Generator().manual_seed(24)
    B, S = 2, 300
    q, w, keys = _idx_inputs(g, B, Q, S, Hi, Di, dt)
    valid = torch.rand((B, Q, S), generator=g) < 0.8
    _idx_vs_plain(cuda, q, w, keys, valid, route)


def test_cuda_stream_ptr_is_the_current_stream(cuda):
    """Every wrapper launches on PyTorch's current stream, a side stream
    (as under CUDA-graph capture) included."""
    from repro_torch.kernels import _build
    t = torch.zeros(1, device=cuda)
    # c_void_p(0).value is None: the legacy default stream
    assert (_build.stream_ptr(t).value or 0) == \
        torch.cuda.current_stream(cuda).cuda_stream
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        assert _build.stream_ptr(t).value == side.cuda_stream != 0


def test_cuda_indexer_general_route_at_serve_shape(cuda):
    """The general kernel, called directly, on the decode shape, against
    the tensor-core route that ``indexer_scores`` takes there (chip_smoke
    times the two side by side)."""
    g = torch.Generator().manual_seed(25)
    q, w, keys = _idx_inputs(g, 4, 1, 8224)
    valid = _prefix_mask([8193, 8200, 8207, 8224], 1, 8224, False).to(cuda)
    q, w, keys = q.to(cuda), w.to(cuda), keys.to(cuda)
    n = (iops.indexer_scores.launches_tc,
         iops.indexer_scores.launches_general)
    got = iops.general_scores(q, w, keys, valid)
    tc = iops.indexer_scores(q, w, keys, valid)
    assert (iops.indexer_scores.launches_tc,
            iops.indexer_scores.launches_general) == (n[0] + 1, n[1] + 1)
    torch.cuda.synchronize()
    assert torch.equal(got == -2.0e38, tc == -2.0e38)
    m = got != -2.0e38
    torch.testing.assert_close(tc[m], got[m], rtol=1e-4, atol=1e-3)


def test_cuda_indexer_tc_rejects_misaligned_weights(cuda):
    """The tensor-core kernel reads w as bf16 pairs: a contiguous w at an
    odd element offset raises a ValueError before any launch."""
    g = torch.Generator().manual_seed(26)
    B, Q, S = 2, 3, 200
    q, _, keys = _idx_inputs(g, B, Q, S)
    flat = torch.randn(B * Q * 64 + 1, generator=g).bfloat16().to(cuda)
    w_odd = flat[1:].view(B, Q, 64)
    assert w_odd.is_contiguous() and w_odd.data_ptr() % 4 == 2
    n = iops.indexer_scores.launches
    with pytest.raises(ValueError, match="4-byte"):
        iops.indexer_scores(q.to(cuda), w_odd, keys.to(cuda))
    assert iops.indexer_scores.launches == n
    # the same weights, aligned, give the plain version's scores
    _idx_vs_plain(cuda, q, w_odd.cpu(), keys, None)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("H,D,K,R,shared", [(128, 576, 300, 512, True),
                                            (4, 40, 33, 32, False)])
def test_cuda_sparse_mla_partial_vs_plain(cuda, dt, H, D, K, R, shared):
    g = torch.Generator().manual_seed(3)
    B, Q = 2, 2
    q = torch.randn((B, Q, H, D), generator=g).to(TORCH_DT[dt])
    rshape = (B, K, D) if shared else (B, Q, K, D)
    rows = torch.randn(rshape, generator=g).to(TORCH_DT[dt])
    valid = torch.rand(rshape[:-1], generator=g) < 0.7
    valid[..., -5:] = False
    want = sops.partial_attend(q, rows, valid, 0.07, R)
    got = sops.partial_attend(q.to(cuda), rows.to(cuda), valid.to(cuda),
                              0.07, R)
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the sparse-MLA tensor-core route (bf16, D = 576, rank = 512, H % 64 == 0)
# ---------------------------------------------------------------------------

def _mla_bf16(g, B, Q, K, shared, H=128):
    q = torch.randn((B, Q, H, 576), generator=g).bfloat16()
    rshape = (B, K, 576) if shared else (B, Q, K, 576)
    rows = torch.randn(rshape, generator=g).bfloat16()
    valid = torch.rand(rshape[:-1], generator=g) < 0.9
    return q, rows, valid


def _tc_vs_plain(cuda, q, rows, valid, scale=0.07):
    """The card's partial (tensor-core route) against the CPU plain fp32
    version at rtol = atol = 1e-4; returns the card's partial."""
    want = sops.partial_attend(q, rows, valid, scale, 512)
    n_tc = sops.partial_attend.launches_tc
    n_gen = sops.partial_attend.launches_general
    got = sops.partial_attend(q.to(cuda), rows.to(cuda), valid.to(cuda),
                              scale, 512)
    assert sops.partial_attend.launches_tc == n_tc + 1
    assert sops.partial_attend.launches_general == n_gen
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)
    return got


@pytest.mark.parametrize("shared", [True, False],
                         ids=["shared", "per_query"])
@pytest.mark.parametrize("K", [256, 300, 2048])
def test_cuda_sparse_mla_tc_vs_plain(cuda, K, shared):
    g = torch.Generator().manual_seed(6)
    q, rows, valid = _mla_bf16(g, 2, 2, K, shared)
    valid[..., -5:] = False
    _tc_vs_plain(cuda, q, rows, valid)


def test_cuda_sparse_mla_tc_whole_split_invalid(cuda):
    g = torch.Generator().manual_seed(7)
    B, K = 2, 2048
    q, rows, valid = _mla_bf16(g, B, 1, K, True)
    nsplit, per = sops.plan_splits(B, 128, K, torch.cuda.get_device_properties(
        cuda).multi_processor_count)
    assert nsplit > 2
    valid[:, :per] = False                 # split 0 has no valid row
    valid[0, per:3 * per] = False          # nor splits 1 and 2 of batch 0
    _tc_vs_plain(cuda, q, rows, valid)


@pytest.mark.parametrize("K", [300, 2048])
def test_cuda_sparse_mla_tc_all_invalid_query(cuda, K):
    g = torch.Generator().manual_seed(8)
    q, rows, valid = _mla_bf16(g, 2, 2, K, False)
    valid[1, 0] = False
    o, m, l = _tc_vs_plain(cuda, q, rows, valid)
    assert torch.all(m[1, 0] == -2.0e38)
    assert torch.all(l[1, 0] == 0) and torch.all(o[1, 0] == 0)


@pytest.mark.parametrize("K", [300, 2048, 8224])
def test_cuda_sparse_mla_tc_query_mask_shared_rows(cuda, K):
    """Rows shared over Q with a mask per query (``valid [B,Q,K]``): a
    causal prefix per query (DeepSeek-V3's prefill chunk, the kernel
    skipping each query's tiles past its last valid row) with holes, one
    query with no valid row, one with every row; and the general route
    (fp32) on the same case."""
    g = torch.Generator().manual_seed(31)
    B, Q = 2, 5
    q, rows, _ = _mla_bf16(g, B, Q, K, True)
    last = torch.randint(0, K, (B, Q), generator=g)
    valid = torch.arange(K)[None, None] <= last[..., None]
    valid &= torch.rand((B, Q, K), generator=g) < 0.95
    valid[0, 1] = False
    valid[1, 2] = True
    o, m, l = _tc_vs_plain(cuda, q, rows, valid)
    assert torch.all(m[0, 1] == -2.0e38) and torch.all(l[0, 1] == 0)
    assert torch.all(o[0, 1] == 0)
    want = sops.partial_attend(q.float(), rows.float(), valid, 0.07, 512)
    n_gen = sops.partial_attend.launches_general
    got = sops.partial_attend(q.float().to(cuda), rows.float().to(cuda),
                              valid.to(cuda), 0.07, 512)
    assert sops.partial_attend.launches_general == n_gen + 1
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


def test_cuda_sparse_mla_routes(cuda):
    """bf16 at MLA's widths takes the tensor-core kernel; fp32, other
    widths and head counts that are not a multiple of 64 the general one."""
    g = torch.Generator().manual_seed(9)
    cases = [(torch.bfloat16, 128, 576, 512, "tc"),
             (torch.float32, 128, 576, 512, "general"),
             (torch.bfloat16, 4, 40, 32, "general"),
             (torch.bfloat16, 96, 576, 512, "general")]
    for dt, H, D, R, route in cases:
        q = torch.randn((1, 1, H, D), generator=g).to(dt).to(cuda)
        rows = torch.randn((1, 70, D), generator=g).to(dt).to(cuda)
        valid = torch.ones((1, 70), dtype=torch.bool, device=cuda)
        assert sops.tc_route(q, rows, R) == (route == "tc")
        n = (sops.partial_attend.launches_tc,
             sops.partial_attend.launches_general)
        sops.partial_attend(q, rows, valid, 0.1, R)
        d = (sops.partial_attend.launches_tc - n[0],
             sops.partial_attend.launches_general - n[1])
        assert d == ((1, 0) if route == "tc" else (0, 1)), (dt, H, D, R)


def test_cuda_sparse_mla_merge_vs_plain(cuda):
    from repro_torch.kernels.sparse_mla import ref as sref
    g = torch.Generator().manual_seed(10)
    S, B, Q, H, R = 5, 2, 1, 128, 512
    o = torch.randn((S, B, Q, H, R), generator=g)
    m = torch.randn((S, B, Q, H), generator=g) * 3
    l = torch.rand((S, B, Q, H), generator=g) * 10
    for t in (o, l):
        t[1] = 0
        t[:, 1] = 0
    m[1] = -2.0e38                         # an all-invalid split
    m[:, 1] = -2.0e38                      # an all-invalid query
    want = sref.merge_splits_ref(o, m, l)
    n0 = sops.merge_splits.launches
    got = sops.merge_splits(o.to(cuda), m.to(cuda), l.to(cuda))
    assert sops.merge_splits.launches == n0 + 1
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6)
    assert torch.all(got[1][1].cpu() == -2.0e38)
    assert torch.all(got[2][1].cpu() == 0) and torch.all(got[0][1].cpu() == 0)


# ---------------------------------------------------------------------------
# the quantized tier: fused gather-dequant, page gathers, quantize-and-write
# ---------------------------------------------------------------------------

QDT = {"int8": torch.int8, "fp8": torch.float8_e4m3fn}


def _quantized_tier(g, shape, name):
    from repro_torch.distributed import compression as cmp
    x = torch.randn(shape, generator=g).bfloat16()
    x[..., 3, :] = 0                                  # a sentinel row
    q, s = cmp.quantize_rows(x, QDT[name])
    return q.pin_memory(), s.pin_memory()


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_gather_rows_dequant_uva_bitwise(cuda, name, dt):
    g = torch.Generator().manual_seed(4)
    q, s = _quantized_tier(g, (300, 576), name)
    ids = torch.randint(-2, 310, (257,), generator=g)
    n0 = gops.gather_rows_dequant.launches
    di0 = gops.gather_rows_dequant.launches_direct
    got = gops.gather_rows_dequant(q, s, ids.to(cuda), TORCH_DT[dt])
    assert gops.gather_rows_dequant.launches == n0 + 1
    assert gops.gather_rows_dequant.launches_direct == di0 + 1
    torch.cuda.synchronize()
    want = gref.gather_rows_dequant_ref(q, s, ids, TORCH_DT[dt])
    assert got.dtype == want.dtype
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_gather_rows_dequant_staged_bitwise(cuda, name, dt):
    g = torch.Generator().manual_seed(8)
    S = 300
    q, s = _quantized_tier(g, (S, 576), name)
    ids = _heavy_ids(g, 16 * S, S, 41).reshape(2, 8 * S)
    st0, di0 = (gops.gather_rows_dequant.launches_staged,
                gops.gather_rows_dequant.launches_direct)
    fetched = torch.zeros(1, dtype=torch.int32, device=cuda)
    got = gops.gather_rows_dequant(q, s, ids.to(cuda), TORCH_DT[dt],
                                   fetched=fetched)
    assert (gops.gather_rows_dequant.launches_staged,
            gops.gather_rows_dequant.launches_direct) == (st0 + 1, di0)
    torch.cuda.synchronize()
    want = gref.gather_rows_dequant_ref(q, s, ids, TORCH_DT[dt])
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))
    assert int(fetched) == _distinct_live(ids, S)


@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_gather_pages_uva_bitwise(cuda, dt):
    g = torch.Generator().manual_seed(5)
    L, NP, R, D = 3, 20, 64, 576
    tier = torch.randn((L, NP * R, D), generator=g).to(TORCH_DT[dt])
    tier = tier.pin_memory()
    ids = torch.randint(-1, NP + 2, (L, 7), generator=g)
    n0 = gops.gather_pages.launches
    got = gops.gather_pages(tier, ids.to(cuda), R)
    assert gops.gather_pages.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), gops.gather_pages(tier, ids, R))
    # one id list for every layer
    got1 = gops.gather_pages(tier, ids[0].to(cuda), R).cpu()
    assert torch.equal(got1, gref.gather_pages_ref(
        tier, ids[0][None].expand(L, -1), R))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("R", [64, 300])
def test_cuda_gather_pages_dequant_uva_bitwise(cuda, name, dt, R):
    g = torch.Generator().manual_seed(6)
    L, NP, D = 2, 6, 576
    q, s = _quantized_tier(g, (L, NP * R, D), name)
    ids = torch.randint(0, NP + 1, (L, 5), generator=g)
    n0 = gops.gather_pages_dequant.launches
    got = gops.gather_pages_dequant(q, s, ids.to(cuda), R, TORCH_DT[dt])
    assert gops.gather_pages_dequant.launches == n0 + 1
    torch.cuda.synchronize()
    want = gref.gather_pages_dequant_ref(q, s, ids, R, TORCH_DT[dt])
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("paged", [True, False])
def test_cuda_quantize_and_write_matches_cpu_bitwise(cuda, name, paged):
    """scatter_tier_rows (quantize on the card, payload + 2-byte scale rows
    through UVA) against the CPU plain path on the same rows."""
    import dataclasses
    from repro_torch.cache import latent_cache as LC
    from repro_torch.configs import get_config
    from repro_torch.core import offload as OF
    cfg = get_config("deepseek-v32-exp-ess")
    cfg = dataclasses.replace(cfg, num_layers=2, ess=dataclasses.replace(
        cfg.ess, host_cache_dtype=name, paged_host=paged))
    gpu = LC.init_ess_caches(cfg, 3, 200, device=cuda)
    cpu = LC.init_ess_caches(cfg, 3, 200, device="cpu")
    assert gpu.host_latent.is_pinned() and gpu.host_scales.is_pinned()
    g = torch.Generator().manual_seed(7)
    ids = torch.tensor([[0, 5, 130, 199], [1, 2, 3, -1], [64, 0, 20, 63]])
    mask = torch.tensor([True, False, True])
    for layer in range(2):
        rows = torch.randn((3, 4, 576), generator=g).bfloat16()
        rows[0, 1] = 0
        rows[2, 0] *= 1e-5                        # a subnormal f16 scale
        OF.scatter_tier_rows(gpu.host_latent, gpu.host_scales, ids.to(cuda),
                             rows.to(cuda), slot_mask=mask.to(cuda),
                             layer=layer, block_table=gpu.block_tables)
        OF.scatter_tier_rows(cpu.host_latent, cpu.host_scales, ids, rows,
                             slot_mask=mask, layer=layer,
                             block_table=cpu.block_tables)
    rows_l = torch.randn((2, 1, 4, 576), generator=g).bfloat16()
    OF.scatter_tier_rows_stacked(gpu.host_latent, gpu.host_scales,
                                 ids[2:].to(cuda), rows_l.to(cuda),
                                 slot_mask=None, batch_offset=1,
                                 block_table=gpu.block_tables)
    OF.scatter_tier_rows_stacked(cpu.host_latent, cpu.host_scales, ids[2:],
                                 rows_l, slot_mask=None, batch_offset=1,
                                 block_table=cpu.block_tables)
    torch.cuda.synchronize()
    assert torch.equal(gpu.host_latent.view(torch.uint8),
                       cpu.host_latent.view(torch.uint8))
    assert torch.equal(gpu.host_scales.view(torch.int16),
                       cpu.host_scales.view(torch.int16))
    got = OF.gather_tier_rows(gpu.host_latent, gpu.host_scales, ids.to(cuda),
                              layer=1, block_table=gpu.block_tables)
    want = OF.gather_tier_rows(cpu.host_latent, cpu.host_scales, ids,
                               layer=1, block_table=cpu.block_tables)
    assert torch.equal(got.cpu().view(torch.int16), want.view(torch.int16))


def test_cuda_scatter_refuses_bf16_rows_into_int8_tier(cuda):
    tier = torch.zeros((16, 576), dtype=torch.int8).pin_memory()
    rows = torch.ones((2, 576), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="quantize"):
        gops.scatter_rows(tier, torch.tensor([0, 1], device=cuda), rows)
    assert (tier == 0).all()


# ---------------------------------------------------------------------------
# The serve step without host syncs, and the decode round as a CUDA graph
# ---------------------------------------------------------------------------

def _mini_cfg(tier="bf16"):
    """deepseek-v32-exp-ess's attention widths (the kernels' tensor-core
    routes: 128 heads x 576, indexer 64 x 128) under a narrow model: 2
    layers (1 dense + 1 MoE of 16 experts), d_model 512, vocab 1024."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v32-exp-ess")
    return dataclasses.replace(
        cfg, num_layers=2, d_model=512, d_ff=1024, vocab_size=1024,
        mtp_depth=0,
        moe=dataclasses.replace(cfg.moe, num_experts=16, d_expert=128,
                                first_dense_layers=1, dense_d_ff=1024),
        ess=dataclasses.replace(cfg.ess, host_cache_dtype=tier,
                                warmup_windows=4))


class _SyncFree:
    """``torch.cuda.set_sync_debug_mode("error")`` for a block: any host
    sync inside raises."""

    def __enter__(self):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("tier", ["bf16", "int8", "fp8"])
def test_cuda_serve_steps_free_of_host_syncs(cuda, tier):
    """A per-slot prefill chunk (ragged: 100 valid of 128) and two
    ``ess_decode`` steps, slot 0 masked, under sync-debug "error"."""
    from repro_torch.cache import latent_cache as LC
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _mini_cfg(tier)
    params = init_params(cfg, 0, device=cuda)
    caches = LC.init_ess_caches(cfg, 2, 300, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (1, 128), generator=g,
                         device=cuda)
    pos = torch.arange(128, device=cuda)[None]
    live = torch.tensor([False, True], device=cuda)
    with _SyncFree():
        lg, caches, tails, hid = E.ess_prefill_chunk(
            params, cfg, toks, pos, caches, slot=1, collect_tail=4,
            n_valid=100)
        tok = lg[0, 99].argmax()[None].expand(2)[:, None]
        for _ in range(2):
            o = E.ess_decode(params, cfg, tok, caches.lens[:, None], caches,
                             slot_mask=live)
            caches = o.caches
            tok = o.logits[:, 0].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches.lens.tolist() == [0, 102]
    assert bool(torch.isfinite(o.logits[1]).all())
    assert int(o.stats["misses"][1]) > 0 and int(o.stats["misses"][0]) == 0


def test_cuda_session_graph_replay_matches_eager(cuda):
    """The decode round replayed from a CUDA graph against the same session
    run eagerly: streams and the caches afterwards bit for bit, over 8
    rounds or more; the wrappers' launch counts (replays added) equal the
    eager run's; plan, compute and prefill stages free of host syncs."""
    from repro_torch.kernels import counters
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving.scheduler import Request
    cfg = _mini_cfg()
    params = init_params(cfg, 1, device=cuda)

    def sync_free(fn):
        def wrapped(*a, **k):
            with _SyncFree():
                return fn(*a, **k)
        return wrapped

    def run(compiled):
        s = E.ServeSession(params, cfg, num_slots=2, max_seq=300,
                           prefill_chunk=64, compiled=compiled, device=cuda)
        for name in ("_plan_round", "_compute_round", "prefill_round"):
            setattr(s, name, sync_free(getattr(s, name)))
        before = counters.snapshot()
        rep = s.run([Request(rid=0, prompt_len=150, max_new_tokens=12),
                     Request(rid=1, prompt_len=90, max_new_tokens=6),
                     Request(rid=2, prompt_len=200, max_new_tokens=9)])
        torch.cuda.synchronize()
        return s, rep, counters.diff(counters.snapshot(), before)

    g, rg, ng = run(True)
    e, re_, ne = run(False)
    assert g.outputs == e.outputs and rg.rounds == re_.rounds >= 8
    assert g.programs.replays == rg.rounds - 1
    assert ng == ne
    assert ng[("indexer_scores", "launches_by_q")][1] == \
        cfg.num_layers * rg.rounds
    cg, ce = g.caches, e.caches
    assert torch.equal(cg.lens, ce.lens)
    assert torch.equal(cg.host_latent.view(torch.int16),
                       ce.host_latent.view(torch.int16))
    for a, b in zip(cg.pools, ce.pools):
        for f in ("ids", "last_use", "slot_of", "step"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.data.view(torch.int16), b.data.view(torch.int16))
    for a, b in zip(cg.ikeys, ce.ikeys):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


# ---------------------------------------------------------------------------
# Chunked prefill and masked decode slots on the card (the smoke config, the
# kernels' general routes; the CPU counterparts in test_torch_chunked_prefill)
# ---------------------------------------------------------------------------

def _smoke_prefill(cuda, B, S, max_seq, **kw):
    """The smoke config's ``ess_prefill`` (no warmup) of seeded tokens on
    the card: ``(cfg, params, logits, caches)``."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = get_config("deepseek-v32-exp-ess-smoke")
    params = init_params(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=cuda)
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    lg, caches = E.ess_prefill(params, cfg, toks, pos, max_seq,
                               do_warmup=False, **kw)
    return cfg, params, lg, caches


def _clone_ess_caches(c):
    """A copy of ``ESSCaches``, its host tier pinned as the original."""
    from repro_torch.core import lru_pool as LP
    host = c.host_latent.clone()
    return c._replace(
        lens=c.lens.clone(),
        host_latent=host.pin_memory() if c.host_latent.is_pinned() else host,
        ikeys=[k.clone() for k in c.ikeys],
        pools=[LP.PoolState(*(t.clone() for t in p)) for p in c.pools],
        block_tables=None if c.block_tables is None
        else c.block_tables.clone())


def _assert_caches_unchanged(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got.lens, want.lens)
    assert torch.equal(got.host_latent.view(torch.int16),
                       want.host_latent.view(torch.int16))
    for a, b in zip(got.ikeys, want.ikeys):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    for a, b in zip(got.pools, want.pools):
        for f in ("ids", "last_use", "slot_of"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.data.view(torch.int16), b.data.view(torch.int16))


def _bf16_ulp(x: float) -> float:
    import math
    return 2.0 ** (math.floor(math.log2(max(abs(x), 1e-30))) - 7)


@pytest.mark.parametrize("chunk", [7, 64])
def test_cuda_chunked_prefill_matches_oneshot(cuda, chunk):
    """``ess_prefill`` in chunks of 7 and 64 against one shot on the card:
    lens equal; host rows, indexer keys and logits bit for bit, or (the
    card's products of other shapes summing in another order) their
    largest difference printed and held within 2e-2 of the planes' scale,
    with the first tokens equal or a near-tie (their gap in the one-shot
    logits within one bf16 ulp of its top)."""
    from repro_torch.serving import engine as E
    B, S, SMAX = 2, 24, 64
    cfg, params, lg1, c1 = _smoke_prefill(cuda, B, S, SMAX)
    g = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=cuda)
    pos = torch.arange(S, device=cuda)[None].expand(B, S)
    lgc, cc = E.ess_prefill(params, cfg, toks, pos, SMAX, do_warmup=False,
                            prefill_chunk=chunk)
    torch.cuda.synchronize()
    assert torch.equal(c1.lens, cc.lens)
    planes = [("host_latent", c1.host_latent, cc.host_latent),
              ("logits", lg1, lgc)] + [
        (f"ikeys[{i}]", a, b) for i, (a, b) in enumerate(zip(c1.ikeys,
                                                           cc.ikeys))]
    for name, a, b in planes:
        a, b = a.float().cpu(), b.float().cpu()
        if not torch.equal(a, b):
            d = float((a - b).abs().max())
            print(f"chunk {chunk}: {name} differs from one shot by at most "
                  f"{d:.4g}")
            assert d <= 2e-2 * max(1.0, float(a.abs().max())), name
    top1, topc = lg1[:, -1].argmax(-1), lgc[:, -1].argmax(-1)
    for b in range(B):
        t1, tc = int(top1[b]), int(topc[b])
        row = lg1[b, -1].float()
        assert t1 == tc or float(row[t1] - row[tc]) <= _bf16_ulp(
            float(row[t1])), (b, t1, tc)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "graph"])
def test_cuda_masked_decode_writes_nothing(cuda, graph):
    """Every slot masked: a decode step, eager or replayed from a CUDA
    graph (twice), leaves host tier, lens, pools and indexer keys bit for
    bit, with no hits and no misses."""
    from repro_torch.serving import engine as E
    cfg, params, _, caches = _smoke_prefill(cuda, 2, 12, 32)
    before = _clone_ess_caches(caches)
    g = torch.Generator(device=cuda).manual_seed(2)
    nxt = torch.randint(0, cfg.vocab_size, (2, 1), generator=g, device=cuda)
    mask = torch.zeros((2,), dtype=torch.bool, device=cuda)
    pos = caches.lens[:, None].clone()
    out = E.ess_decode(params, cfg, nxt, pos, caches, slot_mask=mask)
    _assert_caches_unchanged(out.caches, before)
    assert int(out.stats["hits"].sum()) == int(out.stats["misses"].sum()) \
        == 0
    if not graph:
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        cap = torch.cuda.CUDAGraph()
        cap.capture_begin(capture_error_mode="relaxed")
        out = E.ess_decode(params, cfg, nxt, pos, caches, slot_mask=mask)
        cap.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    for _ in range(2):
        cap.replay()
        _assert_caches_unchanged(out.caches, before)
        assert int(out.stats["hits"].sum()) == \
            int(out.stats["misses"].sum()) == 0


def test_cuda_freed_slot_does_not_alias_live_slot_pages(cuda):
    """Slot 1 reset and its block table set to slot 0's: a decode masked
    to slot 0 changes only slot 0's append row in each layer, slot 1's
    pools stay empty and its lens 0; unmasked, the same step writes slot
    1's phantom row into slot 0's page 0."""
    from repro_torch.cache import latent_cache as LC
    from repro_torch.serving import engine as E
    S = 12
    cfg, params, _, caches = _smoke_prefill(cuda, 2, S, 32)
    LC.reset_slot(caches, 1)
    caches.block_tables[1].copy_(caches.block_tables[0])
    buggy = _clone_ess_caches(caches)
    torch.cuda.synchronize()
    before = caches.host_latent.clone()
    g = torch.Generator(device=cuda).manual_seed(2)
    nxt = torch.randint(0, cfg.vocab_size, (2, 1), generator=g, device=cuda)
    out = E.ess_decode(params, cfg, nxt, caches.lens[:, None].clone(),
                       caches, slot_mask=torch.tensor([True, False],
                                                      device=cuda))
    torch.cuda.synchronize()
    after = out.caches.host_latent
    R = cfg.ess.host_page_rows
    bt0 = caches.block_tables[0].cpu()
    pg, rw = int(bt0[S // R]), S % R
    changed = (after != before).any(dim=-1)                  # [L, NP, R]
    expect = torch.zeros_like(changed)
    expect[:, pg, rw] = True
    assert torch.equal(changed, changed & expect)
    assert bool(changed[:, pg, rw].all())
    for p in out.caches.pools:
        assert bool((p.ids[1] == -1).all())
    assert int(out.caches.lens[1]) == 0
    ob = E.ess_decode(params, cfg, nxt, buggy.lens[:, None].clone(), buggy)
    torch.cuda.synchronize()
    p0 = int(bt0[0])
    assert bool((ob.caches.host_latent[:, p0, 0]
                 != before[:, p0, 0]).any())


# ---------------------------------------------------------------------------
# Sampling and the MTP speculative round on the card
# ---------------------------------------------------------------------------

def _sampler_inputs(dev):
    """Four slots' knobs at the model's vocabulary (V = 129280): greedy,
    top-k 64, top-p 0.9, both, as the serve state holds them."""
    g = torch.Generator().manual_seed(11)
    logits = torch.randn((4, 129280), generator=g) * 3
    knobs = (torch.tensor([0, 123, 7, 2**31 - 1], dtype=torch.int32),
             torch.tensor([1, 4, 2**20, 0], dtype=torch.int32), logits,
             torch.tensor([0.0, 0.8, 1.0, 0.6]),
             torch.tensor([0, 64, 0, 1000], dtype=torch.int32),
             torch.tensor([1.0, 1.0, 0.9, 0.95]))
    return tuple(k.to(dev) for k in knobs)


def test_cuda_sampler_matches_cpu(cuda):
    """The threefry bits and uniforms on the card equal the CPU's bit for
    bit, the Gumbel noise is within 2 ulp (of max(|g|, 1): ``log`` rounds
    differently), and the draws are the same tokens: a differing draw
    would pass only with its top two perturbed scores within 4 ulp."""
    import numpy as np

    from repro_torch.serving import prng
    from repro_torch.serving import sampling as S
    cpu = _sampler_inputs("cpu")
    card = _sampler_inputs(cuda)
    for idx in range(3):
        kc = S.request_key(cpu[0], cpu[1] + idx)
        kg = S.request_key(card[0], card[1] + idx)
        assert torch.equal(kg.cpu(), kc)
        assert torch.equal(prng.random_bits(kg, 129280).cpu(),
                           prng.random_bits(kc, 129280))
        assert torch.equal(prng.uniform(kg, 129280).cpu().view(torch.int32),
                           prng.uniform(kc, 129280).view(torch.int32))
        gc, gg = prng.gumbel(kc, 129280), prng.gumbel(kg, 129280).cpu()
        ulp = (gg.double() - gc.double()).abs() / torch.from_numpy(
            np.spacing(np.maximum(gc.abs().numpy(), 1.0).astype(np.float32)))
        assert float(ulp.max()) <= 2.0
    with _SyncFree():
        got = S.sample_batch(*card)
    want = S.sample_batch(*cpu)
    for r in range(4):
        if int(got[r]) != int(want[r]):
            lg = cpu[2][r:r + 1] / max(float(cpu[3][r]), 1.0)
            m = S._truncate(lg, cpu[4][r:r + 1], cpu[5][r:r + 1])
            sc = (prng.gumbel(S.request_key(cpu[0][r], cpu[1][r]), 129280)
                  + m)[0].topk(2).values
            print(f"row {r}: card {int(got[r])}, cpu {int(want[r])}, top "
                  f"two {sc.tolist()}")
            assert float(sc[0] - sc[1]) <= 4 * float(
                np.spacing(np.float32(max(abs(float(sc[0])), 1.0))))


def _mtp_cfg(tier="bf16"):
    """``_mini_cfg`` with one MTP module (a MoE block of its 16 experts)."""
    import dataclasses
    return dataclasses.replace(_mini_cfg(tier), mtp_depth=1)


def _spec_requests(sampled):
    from repro_torch.serving.scheduler import Request
    knobs = dict(temperature=0.8, top_k=64, seed=5) if sampled else {}
    return [Request(rid=0, prompt_len=150, max_new_tokens=12),
            Request(rid=1, prompt_len=90, max_new_tokens=6, **knobs),
            Request(rid=2, prompt_len=200, max_new_tokens=9)]


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
def test_cuda_spec_session_graph_replay_matches_eager(cuda, sampled):
    """The MTP session (depth 1) with its rounds replayed from CUDA graphs
    (a greedy and, with a sampled request, a sampling variant) against the
    same session run eagerly: streams, speculative counters and the caches
    bit for bit; launch counts (replays added) equal; every round a Q = 2
    verify round; plan, compute and prefill stages free of host syncs."""
    from repro_torch.kernels import counters
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _mtp_cfg()
    params = init_params(cfg, 1, device=cuda)

    def sync_free(fn):
        def wrapped(*a, **k):
            with _SyncFree():
                return fn(*a, **k)
        return wrapped

    def run(compiled):
        s = E.ServeSession(params, cfg, num_slots=2, max_seq=300,
                           prefill_chunk=64, mtp_depth=1, compiled=compiled,
                           device=cuda)
        for name in ("_plan_round", "_compute_round", "prefill_round"):
            setattr(s, name, sync_free(getattr(s, name)))
        before = counters.snapshot()
        rep = s.run(_spec_requests(sampled))
        torch.cuda.synchronize()
        return s, rep, counters.diff(counters.snapshot(), before)

    g, rg, ng = run(True)
    e, re_, ne = run(False)
    assert g.outputs == e.outputs and rg.rounds == re_.rounds >= 8
    for f in ("spec_rounds", "drafted_tokens", "accepted_tokens",
              "decode_tokens", "h2d_rows"):
        assert getattr(rg, f) == getattr(re_, f), f
    assert rg.spec_rounds == rg.rounds
    assert g.programs.captures == (2 if sampled else 1)
    assert g.programs.replays + g.programs.captures == rg.rounds
    assert ng == ne
    by_q = ng[("indexer_scores", "launches_by_q")]
    assert by_q[2] == cfg.num_layers * rg.rounds and 1 not in by_q
    cg, ce = g.caches, e.caches
    assert torch.equal(cg.lens, ce.lens)
    for a, b in zip(cg.pools, ce.pools):
        for f in ("ids", "last_use", "slot_of", "step"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_cuda_spec_round_and_truncate_free_of_host_syncs(cuda, tier):
    """The spec round (both variants) and ``_truncate_slot_tail`` under
    sync-debug "error", after a few rounds of a session with a sampled
    request; the truncation shrinks the slot's ``lens`` in place and drops
    its pool entries beyond."""
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _mtp_cfg(tier)
    params = init_params(cfg, 2, device=cuda)
    s = E.ServeSession(params, cfg, num_slots=2, max_seq=300,
                       prefill_chunk=64, mtp_depth=1, compiled=False,
                       device=cuda)
    for r in _spec_requests(True)[:2]:
        s.submit(r)
    for _ in range(5):
        s.step()
    assert len(s.sched.active_slots()) == 2
    lens0 = s.caches.lens.clone()
    with _SyncFree():
        for sampled in (False, True):
            s.programs.spec(False, sampled)(s.params, s.state, s._out)
        lens1 = s.caches.lens.clone()
        s._truncate_slot_tail(0, 1)
    torch.cuda.synchronize()
    lens = s.caches.lens
    assert (lens1 - lens0 >= 2).all() and (lens1 - lens0 <= 4).all()
    assert int(lens[0]) == int(lens1[0]) - 1 and int(lens[1]) == int(lens1[1])
    for p in s.caches.pools:
        assert ((p.ids[0] < lens[0]) | (p.ids[0] < 0)).all()


def test_cuda_sparse_mla_general_route_watch_case_repeats(cuda):
    """ROADMAP Queue 3's watch case (a single past failure of
    ``test_cuda_sparse_mla_partial_vs_plain[128-576-300-512-True-f32]``):
    the same inputs on the general route 40 times, each against the plain
    version at rtol = atol = 1e-4."""
    g = torch.Generator().manual_seed(3)
    B, Q, H, D, K, R = 2, 2, 128, 576, 300, 512
    q = torch.randn((B, Q, H, D), generator=g)
    rows = torch.randn((B, K, D), generator=g)
    valid = torch.rand((B, K), generator=g) < 0.7
    valid[..., -5:] = False
    want = sops.partial_attend(q, rows, valid, 0.07, R)
    qc, rc, vc = q.to(cuda), rows.to(cuda), valid.to(cuda)
    bad = []
    for i in range(40):
        got = sops.partial_attend(qc, rc, vc, 0.07, R)
        err = max(float((a.cpu() - b).abs().max()) for a, b in
                  zip(got, want))
        if not all(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4)
                   for a, b in zip(got, want)):
            bad.append((i, err))
    print(f"watch case: {40 - len(bad)}/40 within 1e-4, failures {bad}")
    assert not bad


# ---------------------------------------------------------------------------
# The overlap strategies on the card: side streams inside the round's graph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("m", [300, 2000], ids=["direct", "staged"])
def test_cuda_gather_rows_out_bitwise(cuda, name, m):
    """``out=`` receives exactly the rows each route returns, from a
    pinned tier, raw or quantized."""
    g = torch.Generator().manual_seed(8)
    S = 500
    ids = torch.randint(-3, S + 5, (4, m // 4), generator=g).to(cuda)
    if name == "bf16":
        host = torch.randn((S, 576), generator=g).bfloat16().pin_memory()
        want = gops.gather_rows(host, ids)
        out = torch.full_like(want, 3.0)
        got = gops.gather_rows(host, ids, out=out)
    else:
        host, scales = _quantized_tier(g, (S, 576), name)
        want = gops.gather_rows_dequant(host, scales, ids)
        out = torch.full_like(want, 3.0)
        got = gops.gather_rows_dequant(host, scales, ids, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))


def test_cuda_fork_join_inside_graph_capture(cuda):
    """A fork onto a side stream and its join, recorded inside a capture,
    replay as a branch of the graph: the side branch's result is there
    after the join, each replay."""
    from repro_torch.core.overlap import Fork, side_stream
    side = side_stream(cuda)
    x = torch.arange(1 << 20, device=cuda, dtype=torch.float32)
    y = torch.empty_like(x)
    z = torch.empty_like(x)

    def body():
        with Fork(side, x, y) as f:
            y.copy_(x * 2)
        z.copy_(x + 1)
        f.join()
        z.add_(y)

    body()
    graph = torch.cuda.CUDAGraph()
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):
        graph.capture_begin()
        body()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(cap)
    for k in range(3):
        x.add_(k)
        z.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(z, 3 * x + 1)


def _overlap_cfg(overlap, mtp_depth=0):
    import dataclasses
    cfg = _mini_cfg()
    return dataclasses.replace(cfg, mtp_depth=mtp_depth,
                               ess=dataclasses.replace(cfg.ess,
                                                       overlap=overlap))


def _overlap_requests():
    from repro_torch.serving.scheduler import Request
    return [Request(rid=0, prompt_len=150, max_new_tokens=12),
            Request(rid=1, prompt_len=90, max_new_tokens=6),
            Request(rid=2, prompt_len=200, max_new_tokens=9,
                    temperature=0.8, top_k=64, seed=5),
            Request(rid=3, prompt_len=120, max_new_tokens=10)]


# (overlap mode, tbo, MTP depth); 4 slots: TBO halves of 2, DBA within
# them 1 and 1, so every layer of a round runs `parts` indexer launches
OVERLAP_SESSIONS = {"dba": ("dba", False, 0, 2), "tbo": ("da", True, 0, 2),
                    "dba-tbo": ("dba", True, 0, 4),
                    "tbo-mtp": ("da", True, 1, 2)}


@pytest.mark.parametrize("case", list(OVERLAP_SESSIONS))
def test_cuda_overlap_session_graph_replay_matches_eager(cuda, case):
    """DBA and TBO sessions (4 slots, a sampled request among four) with
    their rounds replayed from CUDA graphs against the same session run
    eagerly: streams and the caches bit for bit, launch counts (replays
    added) equal, ``parts`` indexer launches per layer and round; plan,
    compute and prefill stages free of host syncs."""
    from repro_torch.kernels import counters
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    overlap, tbo, depth, parts = OVERLAP_SESSIONS[case]
    cfg = _overlap_cfg(overlap, depth)
    params = init_params(cfg, 1, device=cuda)

    def sync_free(fn):
        def wrapped(*a, **k):
            with _SyncFree():
                return fn(*a, **k)
        return wrapped

    def run(compiled):
        s = E.ServeSession(params, cfg, num_slots=4, max_seq=300,
                           prefill_chunk=64, mtp_depth=depth, tbo=tbo,
                           compiled=compiled, device=cuda)
        for name in ("_plan_round", "_compute_round", "prefill_round"):
            setattr(s, name, sync_free(getattr(s, name)))
        before = counters.snapshot()
        rep = s.run(_overlap_requests())
        torch.cuda.synchronize()
        return s, rep, counters.diff(counters.snapshot(), before)

    g, rg, ng = run(True)
    e, re_, ne = run(False)
    assert g.tbo == tbo and g.outputs == e.outputs
    assert rg.rounds == re_.rounds >= 8
    assert g.programs.replays + g.programs.captures == rg.rounds
    assert g.programs.captures == 2            # greedy and sampling
    assert ng == ne
    by_q = ng[("indexer_scores", "launches_by_q")]
    assert by_q[depth + 1] == parts * cfg.num_layers * rg.rounds
    cg, ce = g.caches, e.caches
    assert torch.equal(cg.lens, ce.lens)
    assert torch.equal(cg.host_latent.view(torch.int16),
                       ce.host_latent.view(torch.int16))
    for a, b in zip(cg.pools, ce.pools):
        for f in ("ids", "last_use", "slot_of", "step"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.data.view(torch.int16), b.data.view(torch.int16))


@pytest.mark.parametrize("case", ["da", "dba", "tbo"])
def test_cuda_overlap_profiled_graph_rounds(cuda, case):
    """In graph rounds under ``torch.profiler``, a row-gather kernel runs
    beside other device work (the fetch on its side stream, a TBO half):
    overlapped time above 0, for DA, DBA and TBO."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import overlap_profile
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving.scheduler import Request
    cfg = _overlap_cfg("dba" if case == "dba" else "da")
    params = init_params(cfg, 3, device=cuda)
    s = E.ServeSession(params, cfg, num_slots=4, max_seq=600,
                       prefill_chunk=128, tbo=case == "tbo", compiled=True,
                       device=cuda)
    for i in range(4):
        s.submit(Request(rid=i, prompt_len=400 + 30 * i, max_new_tokens=40))
    while len(s.sched.active_slots()) < 4 or s.programs.replays < 2:
        s.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            s.step()
        torch.cuda.synchronize()
    ov = overlap_profile(prof)
    print(f"{case}: {ov}")
    assert ov["gather_us"] > 0 and ov["overlap_us"] > 0


# ---------------------------------------------------------------------------
# The pipelined round: the slab gather, graph rounds, host syncs
# ---------------------------------------------------------------------------

def _stacked_tier(g, name, paged, L=3, B=4, S=96, R=16, D=576):
    """A pinned stacked tier ([L, B*S/R, R, D] paged with shuffled block
    tables, or [L, B, S, D] dense) of ``name`` (bf16, or an int8 / fp8
    payload with its f16 scales)."""
    from repro_torch.distributed import compression as cmp
    lead = (L, B * S // R, R) if paged else (L, B, S)
    x = torch.randn(lead + (D,), generator=g)
    scales = None
    if name == "bf16":
        host = x.to(torch.bfloat16)
    else:
        host, scales = cmp.quantize_rows(x, QDT[name])
        scales = scales.pin_memory()
    bt = torch.randperm(B * S // R, generator=g).view(B, S // R) \
        if paged else None
    return host.pin_memory(), scales, bt


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("name", ["int8", "fp8", "bf16"])
def test_cuda_gather_into_slab_bitwise(cuda, name, paged):
    """The slab gather (one ``gather_rows_raw`` launch over every layer:
    payload and, for a quantized tier, its scale, raw) against its plain
    version on the same pinned tier, bit for bit; ids -1 (zero rows and
    scales), live and past the end; one dense TBO half's view too."""
    from repro_torch.core import offload as TO
    g = torch.Generator().manual_seed(4)
    host, scales, bt = _stacked_tier(g, name, paged)
    ids = torch.randint(-1, 100, (3, 4, 256), generator=g, dtype=torch.int32)
    n0 = gops.gather_rows_raw.launches
    got, got_s = TO.gather_into_slab(
        host, scales, ids.to(cuda), slot_mask=None,
        block_table=None if bt is None else bt.to(cuda))
    assert gops.gather_rows_raw.launches == n0 + 1
    want, want_s = TO.gather_into_slab(host, scales, ids, slot_mask=None,
                                       block_table=bt)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))
    if scales is None:
        assert got_s is None
    else:
        assert torch.equal(got_s.cpu().view(torch.int16),
                           want_s.view(torch.int16))
    if not paged:                                     # a TBO half's view
        half_s = None if scales is None else scales[:, 2:]
        got, got_s = TO.gather_into_slab(host[:, 2:], half_s,
                                         ids[:, 2:].to(cuda), slot_mask=None)
        want, want_s = TO.gather_into_slab(host[:, 2:], half_s, ids[:, 2:],
                                           slot_mask=None)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu().view(torch.uint8),
                           want.view(torch.uint8))


def test_cuda_slab_gather_fork_join_inside_capture(cuda):
    """The commit's tier write on the current stream, the slab gather
    forked onto a side stream after it, joined before the slab's copy, all
    recorded in one capture: every replay's slab holds the rows that
    replay wrote (the gather is ordered after the write)."""
    from repro_torch.core import offload as TO
    from repro_torch.core.overlap import Fork, side_stream
    g = torch.Generator().manual_seed(6)
    host, _, bt = _stacked_tier(g, "bf16", True)
    btd = bt.to(cuda)
    side = side_stream(cuda)
    widx = torch.tensor([[5], [17], [40], [95]], device=cuda)
    ids = widx.view(1, 4, 1).expand(3, 4, 1).to(torch.int32).contiguous()
    rows = torch.empty((3, 4, 1, 576), dtype=torch.bfloat16, device=cuda)
    slab = torch.zeros((3, 4, 1, 576), dtype=torch.bfloat16, device=cuda)

    def body():
        TO.scatter_from_slab(host, None, widx, rows, None, slot_mask=None,
                             block_table=btd)
        fresh = torch.empty_like(slab)
        with Fork(side, ids, fresh) as f:
            TO.gather_into_slab(host, None, ids, slot_mask=None,
                                block_table=btd, out=fresh)
        f.join()
        slab.copy_(fresh)

    rows.normal_()
    body()
    torch.cuda.synchronize()
    assert torch.equal(slab, rows)
    graph = torch.cuda.CUDAGraph()
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cap):
        graph.capture_begin(capture_error_mode="relaxed")
        body()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(cap)
    for _ in range(3):
        rows.normal_()
        slab.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(slab, rows)


PIPELINED = {"bf16-q1": ("bf16", 0), "int8-q1": ("int8", 0),
             "bf16-spec": ("bf16", 1)}


@pytest.mark.parametrize("case", list(PIPELINED))
def test_cuda_pipelined_session_graph_replay_matches_eager(cuda, case):
    """A pipelined session (``overlap=True``, 4 slots, a sampled request
    among four; Q = 1 rounds, or depth-1 spec rounds) with its rounds
    replayed from CUDA graphs against the same session run eagerly:
    streams, caches and the slab bit for bit, launch counts (replays
    added) equal, one slab gather a round; plan, compute and prefill
    stages under sync-debug "error"; and the streams equal the
    synchronous graph session's (the slab holds the gather's bits)."""
    from repro_torch.kernels import counters
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    tier, depth = PIPELINED[case]
    import dataclasses
    cfg = dataclasses.replace(_mini_cfg(tier), mtp_depth=depth)
    params = init_params(cfg, 1, device=cuda)

    def sync_free(fn):
        def wrapped(*a, **k):
            with _SyncFree():
                return fn(*a, **k)
        return wrapped

    def run(compiled, overlap=True):
        s = E.ServeSession(params, cfg, num_slots=4, max_seq=300,
                           prefill_chunk=64, mtp_depth=depth,
                           compiled=compiled, overlap=overlap, device=cuda)
        for name in ("_plan_round", "_compute_round", "prefill_round"):
            setattr(s, name, sync_free(getattr(s, name)))
        before = counters.snapshot()
        rep = s.run(_overlap_requests())
        torch.cuda.synchronize()
        return s, rep, counters.diff(counters.snapshot(), before)

    g, rg, ng = run(True)
    e, re_, ne = run(False)
    base, rb, _ = run(True, overlap=False)
    assert g.outputs == e.outputs == base.outputs
    assert rg.rounds == re_.rounds == rb.rounds >= 8
    assert rg.prefetch_hits + rg.prefetch_misses > 0
    assert (rg.prefetch_hits, rg.prefetch_misses,
            rg.prefetch_wasted_rows) == (re_.prefetch_hits,
                                         re_.prefetch_misses,
                                         re_.prefetch_wasted_rows)
    assert g.programs.replays + g.programs.captures == rg.rounds
    assert ng == ne
    assert ng[("gather_rows_raw", "launches")] == rg.rounds
    cg, ce = g.caches, e.caches
    assert torch.equal(cg.lens, ce.lens)
    assert torch.equal(cg.host_latent.view(torch.uint8),
                       ce.host_latent.view(torch.uint8))
    for a, b in zip(cg.pools, ce.pools):
        for f in ("ids", "last_use", "slot_of", "step"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert torch.equal(a.data.view(torch.int16), b.data.view(torch.int16))
    sg, se = g.state, e.state
    assert torch.equal(sg.staged_ids, se.staged_ids)
    assert torch.equal(sg.staged_rows.view(torch.uint8),
                       se.staged_rows.view(torch.uint8))
    if tier != "bf16":
        assert torch.equal(sg.staged_scales.view(torch.int16),
                           se.staged_scales.view(torch.int16))


def test_cuda_pipelined_profiled_slab_gather(cuda):
    """In pipelined graph rounds under ``torch.profiler`` the slab gather
    (``gather_rows_raw``) runs on the card each round; its time beside
    other device work is printed."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_serve import SLAB_KERNELS, overlap_profile
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    from repro_torch.serving.scheduler import Request
    cfg = _overlap_cfg("da")
    params = init_params(cfg, 3, device=cuda)
    s = E.ServeSession(params, cfg, num_slots=4, max_seq=600,
                       prefill_chunk=128, overlap=True, compiled=True,
                       device=cuda)
    for i in range(4):
        s.submit(Request(rid=i, prompt_len=400 + 30 * i, max_new_tokens=40))
    while len(s.sched.active_slots()) < 4 or s.programs.replays < 2:
        s.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            s.step()
        torch.cuda.synchronize()
    slab = overlap_profile(prof, SLAB_KERNELS)
    print(f"slab: {slab}; all gathers: {overlap_profile(prof)}")
    assert slab["gather_us"] > 0


# ---------------------------------------------------------------------------
# The page kernels (TMA ring), the link probe, and the PD migration
# ---------------------------------------------------------------------------

_PROBE = r"""
import json, sys, torch
sys.path.insert(0, "src")
from repro_torch.kernels.gather_cache import ops as gops
n = 256 * 2**20
host = torch.randint(0, 255, (n,), dtype=torch.uint8).pin_memory()
card = torch.empty(n, dtype=torch.uint8, device="cuda")

def rate(fn, iters=4):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return n * iters / (a.elapsed_time(b) * 1e-3)

out = {"copy_engine_h2d": rate(lambda: card.copy_(host, non_blocking=True))}
for src, tag in ((card, "device"), (host, "host")):
    for kb in (16, 32, 64):
        out[f"lsu_{tag}_{kb}kb"] = rate(
            lambda: gops.probe_link_read(src, kb_in_flight=kb))
    for chunk in (16384, 32768):
        for per_sm in (1, 2):
            out[f"bulk_{tag}_{chunk // 1024}kb_x{per_sm}"] = rate(
                lambda: gops.probe_link_read(src, bulk_chunk=chunk,
                                             ctas_per_sm=per_sm))
print(json.dumps(out))
"""


def test_cuda_link_probe_tma_reads_host_memory(cuda):
    """The microbenchmark behind the page kernels' design: can TMA bulk
    copies read pinned host memory through its UVA pointer, at what rate,
    and how does that compare with the SMs' own 16-byte loads at 16 / 32 /
    64 KB in flight an SM, and with the copy engine?  Run in a child
    process (a fault would end it, not this session); the rates (bytes/s,
    256 MiB per read) go to ``chiprun_out/link_probe.json``."""
    import json
    import pathlib
    import subprocess
    import sys
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rates = json.loads(r.stdout.strip().splitlines()[-1])
    out = root / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "link_probe.json").write_text(json.dumps(rates, indent=1))
    print("link probe GB/s: " + ", ".join(f"{k} {v / 1e9:.2f}"
                                           for k, v in rates.items()))
    assert all(v > 0 for v in rates.values())


def _tier(g, shape, name):
    if name == "bf16":
        return torch.randn(shape, generator=g).bfloat16().pin_memory(), None
    return _quantized_tier(g, shape, name)


def _bits(t):
    return t.view({1: torch.uint8, 2: torch.int16,
                   4: torch.int32}[t.element_size()])


@pytest.mark.parametrize("name", ["bf16", "int8", "fp8"])
@pytest.mark.parametrize("shape", ["graft", "pack", "odd"])
@pytest.mark.parametrize("out", ["device", "pinned"])
def test_cuda_gather_pages_tma_bitwise(cuda, name, shape, out):
    """#5 on the TMA ring: 4 layers x 129 pages (the graft), x 128 (the
    pack) and 7 (odd), 64 rows of 576, bf16 / int8 / fp8 tiers with the
    scale plane riding in the same launch, ids past either end clipped as
    the plain version clips them; into device memory and straight into
    pinned host memory (the pack's route (a)); bit for bit."""
    g = torch.Generator().manual_seed(20)
    L, R, D = 4, 64, 576
    nb = {"graft": 129, "pack": 128, "odd": 7}[shape]
    NP = nb + 5
    tier, sc = _tier(g, (L, NP * R, D), name)
    ids = torch.randperm(NP, generator=g)[:nb]
    ids[::11] = NP + 4
    ids[3::13] = -3
    kw = {}
    if out == "pinned":
        kw["out"] = torch.empty((L, nb * R, D), dtype=tier.dtype,
                                pin_memory=True)
        if sc is not None:
            kw["out_scales"] = torch.empty((L, nb * R, 1),
                                           dtype=torch.float16,
                                           pin_memory=True)
    n0 = gops.gather_pages.launches
    got = gops.gather_pages(tier, ids.to(cuda), R, scales=sc, **kw)
    assert gops.gather_pages.launches == n0 + 1
    torch.cuda.synchronize()
    want = gops.gather_pages(tier, ids, R, scales=sc)
    if sc is None:
        got, want = (got,), (want,)
    for a, b in zip(got, want):
        assert (a.device.type == "cpu") == (out == "pinned")
        assert torch.equal(_bits(a.cpu()), _bits(b))


@pytest.mark.parametrize("name", ["int8", "fp8"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("nb", [129, 128, 7])
def test_cuda_gather_pages_dequant_tma_bitwise(cuda, name, dt, nb):
    """#6 on the TMA ring at the graft and pack shapes and an odd count,
    bf16 and fp32 out, ids clipped: bit for bit the plain version."""
    g = torch.Generator().manual_seed(21)
    L, R, D = 4, 64, 576
    NP = nb + 3
    q, s = _quantized_tier(g, (L, NP * R, D), name)
    ids = torch.randint(-2, NP + 3, (nb,), generator=g)
    got = gops.gather_pages_dequant(q, s, ids.to(cuda), R, TORCH_DT[dt])
    torch.cuda.synchronize()
    want = gref.gather_pages_dequant_ref(q, s, ids[None].expand(L, -1), R,
                                         TORCH_DT[dt])
    assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("name", ["bf16", "int8"])
@pytest.mark.parametrize("src_on", ["pinned", "device"])
def test_cuda_put_pages_bitwise(cuda, name, src_on):
    """The install's page write: packet pages (pinned, read over UVA, or on
    the card) into a pinned tier at destination ids, the scale plane in
    the same launch; ids outside the pool drop; other pages untouched."""
    g = torch.Generator().manual_seed(22)
    L, R, D, NP, n = 4, 64, 576, 40, 9
    src, ssc = _tier(g, (L, n * R, D), name)
    dst, dsc = _tier(g, (L, NP * R, D), name)
    want, wsc = dst.clone(), None if dsc is None else dsc.clone()
    ids = torch.randperm(NP, generator=g)[:n]
    ids[4] = NP + 1
    ids[6] = -1
    if src_on == "device":
        src = src.to(cuda)
        ssc = None if ssc is None else ssc.to(cuda)
    n0 = gops.put_pages.launches
    gops.put_pages(dst, ids.to(cuda), src, R, dst_scales=dsc,
                   src_scales=ssc)
    assert gops.put_pages.launches == n0 + 1
    torch.cuda.synchronize()
    gops.put_pages(want, ids, src.cpu(), R, dst_scales=wsc,
                   src_scales=None if ssc is None else ssc.cpu())
    assert torch.equal(_bits(dst), _bits(want))
    if dsc is not None:
        assert torch.equal(_bits(dsc), _bits(wsc))


def _cluster_cfg(tier):
    """The mini config with a miss envelope and a MoE capacity that cannot
    bind, so a slot's decode math does not depend on its co-residents."""
    import dataclasses
    cfg = _mini_cfg(tier)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k),
        ess=dataclasses.replace(cfg.ess, max_miss_ratio=1.0))


def _prefilled(cuda, cfg, params):
    """A prefill session on the card with one 300-token prompt promoted
    (rid 0, 12 new tokens): ``(session, slot, req, t0)``."""
    from repro_torch.cluster import workers as W
    from repro_torch.serving.scheduler import Request
    s = W.make_prefill_session()(params, cfg, num_slots=2, max_seq=400,
                                 prefill_chunk=128, device=cuda)
    s.submit(Request(rid=0, prompt_len=300, max_new_tokens=12))
    s.admit()
    while not s._pending_first:
        s.prefill_round()
    [(slot, req, t0)] = s._pending_first
    s._pending_first = []
    return s, slot, req, t0


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_cuda_pack_install_bitwise_one_wait_no_sync(cuda, tier,
                                                    monkeypatch):
    """The pack on the card against the plain path on the same state (the
    page copy with CPU ids), bit for bit, with exactly one host wait and
    no other sync; the install into a decode session under sync-debug
    "error": the decode tier's new pages hold the packet's bits, and
    ``lens``, keys, token and hidden are written in place."""
    from repro_torch.cluster import kv_transfer as KT
    from repro_torch.core import offload
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _cluster_cfg(tier)
    params = init_params(cfg, 3, device=cuda)
    s, slot, req, t0 = _prefilled(cuda, cfg, params)
    waits = []
    wait = KT.host_wait

    def counted_wait(dev):
        torch.cuda.set_sync_debug_mode(0)
        waits.append(dev)
        wait(dev)
        torch.cuda.set_sync_debug_mode("error")
    monkeypatch.setattr(KT, "host_wait", counted_wait)
    n0 = gops.gather_pages.launches
    with _SyncFree():
        pkt = KT.pack_migration(s, slot, req, t0)
    assert len(waits) == 1 and gops.gather_pages.launches == n0 + 1
    assert pkt.pages.is_pinned() and pkt.t0 == int(t0)
    ids = torch.tensor(s.allocator.owned(slot)[:pkt.n_pages])
    pages = torch.empty_like(pkt.pages)
    scales = None if pkt.scales is None else torch.empty_like(pkt.scales)
    c = s.caches
    offload.gather_tier_pages(c.host_latent, c.host_scales, ids, pages,
                              scales)
    assert torch.equal(_bits(pkt.pages), _bits(pages))
    if scales is not None:
        assert torch.equal(_bits(pkt.scales), _bits(scales))
    for k, ik in zip(c.ikeys, pkt.ikeys):
        assert torch.equal(_bits(k[slot, :300].cpu()), _bits(ik))
    assert torch.equal(_bits(s.state.hidden[slot].cpu()), _bits(pkt.hidden))

    d = E.ServeSession(params, cfg, num_slots=2, max_seq=400, device=cuda)
    keep = (d.caches.lens, d.caches.block_tables, d.state.tok,
            d.state.hidden)
    n0 = gops.put_pages.launches
    with _SyncFree():
        dslot = KT.install_migration(d, pkt)
    assert gops.put_pages.launches == n0 + 1
    torch.cuda.synchronize()
    assert all(a is b for a, b in zip(keep, (d.caches.lens,
               d.caches.block_tables, d.state.tok, d.state.hidden)))
    new = d.allocator.owned(dslot)[:pkt.n_pages]
    assert torch.equal(_bits(d.caches.host_latent[:, new]), _bits(pkt.pages))
    if pkt.scales is not None:
        assert torch.equal(_bits(d.caches.host_scales[:, new]),
                           _bits(pkt.scales))
    assert int(d.caches.lens[dslot]) == 300
    assert int(d.state.tok[dslot]) == pkt.t0
    assert torch.equal(_bits(d.state.hidden[dslot].cpu()), _bits(pkt.hidden))
    for k, ik in zip(d.caches.ikeys, pkt.ikeys):
        assert torch.equal(_bits(k[dslot, :300].cpu()), _bits(ik))


@pytest.mark.parametrize("tier,warm", [("bf16", False), ("int8", True)],
                         ids=["bf16", "int8-warmup"])
def test_cuda_cluster_streams_match_engine(cuda, tier, warm):
    """One prefill and two decode workers on one card, sharing the weights,
    graph rounds: the streams of 4 requests (one sampled) equal a 4-slot
    ``EssEngine``'s bit for bit; every request migrates; the page gather
    carries the pack and the page write the install."""
    from repro_torch.cluster import EssCluster
    from repro_torch.models.params import init_params
    from repro_torch.serving.api import EssEngine, SamplingParams
    cfg = _cluster_cfg(tier)
    params = init_params(cfg, 4, device=cuda)
    prompts = [300, 120, 250, 64]
    sps = [SamplingParams(max_tokens=12), SamplingParams(
        max_tokens=6, temperature=0.8, top_k=16, seed=5),
        SamplingParams(max_tokens=9), SamplingParams(max_tokens=7)]

    def prompt_fn(req):
        g = torch.Generator().manual_seed(50 + req.rid)
        return torch.randint(0, cfg.vocab_size, (1, req.prompt_len),
                             generator=g)
    kw = dict(max_seq=400, prefill_chunk=128, do_warmup=warm,
              prompt_fn=prompt_fn, device=cuda)
    eng = EssEngine(params, cfg, num_slots=4, **kw)
    want = [(o.tokens, o.finish_reason) for o in eng.generate(prompts, sps)]
    g0, p0 = gops.gather_pages.launches, gops.put_pages.launches
    clu = EssCluster(params, cfg, num_prefill=1, num_decode=2, num_slots=2,
                     **kw)
    got = [(o.tokens, o.finish_reason) for o in clu.generate(prompts, sps)]
    assert got == want
    m = clu.metrics()
    assert m["migrations"] == 4 == m["installed"]
    assert gops.gather_pages.launches - g0 == 4
    assert gops.put_pages.launches - p0 == 4
    assert all(w.installed > 0 for w in clu.decode)


# ---------------------------------------------------------------------------
# The monolithic path: gather-attend over an HBM cache, topk_select, the
# generic decode, forward in each mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["direct", "staged"])
@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_sparse_mla_gather_attend_hbm_vs_plain(cuda, dt, route):
    """Gather-attend on a device-resident [B,S,D] cache against the plain
    version on the CPU: bf16 at MLA's widths (the tensor-core route, K =
    2048, 2 queries with their own masks) at 2e-2, fp32 at narrow widths
    (the general route) at 1e-5; its gather reads device memory directly,
    and the same flat ids through ``gather_rows`` on either route give
    the CPU's rows bit for bit."""
    g = torch.Generator().manual_seed(21)
    if dt == "bf16":
        B, Q, H, D, R, K, S = 2, 2, 128, 576, 512, 2048, 4096
        tol = dict(rtol=2e-2, atol=2e-2)
    else:
        B, Q, H, D, R, K, S = 2, 2, 8, 96, 64, 16, 64
        tol = dict(rtol=1e-5, atol=1e-5)
    q = torch.randn((B, Q, H, D), generator=g).to(TORCH_DT[dt])
    lat = torch.randn((B, S, D), generator=g).to(TORCH_DT[dt])
    ids = torch.stack([torch.stack([torch.randperm(S, generator=g)[:K]
                                    for _ in range(Q)]) for _ in range(B)])
    valid = torch.arange(S)[None, None] < torch.tensor(
        [[S - 5, S // 2], [S // 3, S]])[..., None]
    n0 = gops.gather_rows.launches
    direct0 = gops.gather_rows.launches_direct
    assert not gops.staged_route(B * Q * K, B * S, host=False)
    got = sops.sparse_mla_gather_attend(
        q.to(cuda), lat.to(cuda), ids.to(cuda), valid.to(cuda), 0.07, R)
    torch.cuda.synchronize()
    assert gops.gather_rows.launches == n0 + 1
    assert gops.gather_rows.launches_direct == direct0 + 1
    want = sops.sparse_mla_gather_attend(q, lat, ids, valid, 0.07, R)
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
    flat = (ids.reshape(B, Q * K) + torch.arange(0, B * S, S)[:, None])
    flat = flat.reshape(-1)
    rows = gops.gather_rows(lat.reshape(B * S, D).to(cuda), flat.to(cuda),
                            route=route)
    assert torch.equal(rows.cpu(), lat.reshape(B * S, D)[flat])


@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_topk_select_ids_equal_plain(cuda, dt):
    """Scores exact in both (small integers), full of ties and with
    invalid keys: the kernel's ids, tie order included, and values equal
    the plain version's; bf16 at the indexer's widths takes the
    tensor-core route."""
    g = torch.Generator().manual_seed(22)
    B, Q, Hi, Di, S, k = 2, 3, 64, 128, 700, 256
    q = torch.randint(-1, 2, (B, Q, Hi, Di), generator=g).float()
    keys = torch.randint(-1, 2, (B, S, Di), generator=g).float()
    keys[:, 7::5] = keys[:, 3:4]                        # repeated keys
    w = torch.randint(0, 3, (B, Q, Hi), generator=g).float() * 0.25
    valid = torch.arange(S)[None] < torch.tensor([S, 500])[:, None]
    q, keys, w = (t.to(TORCH_DT[dt]) for t in (q, keys, w))
    tc0 = iops.indexer_scores.launches_tc
    vals, ids = iops.topk_select(q.to(cuda), w.to(cuda), keys.to(cuda),
                                 valid.to(cuda), k)
    torch.cuda.synchronize()
    assert iops.indexer_scores.launches_tc - tc0 == (dt == "bf16")
    pv, pids = iops.topk_select(q, w, keys, valid, k)
    assert torch.equal(ids.cpu(), pids)
    assert torch.equal(vals.cpu(), pv)
    assert int(ids[1].max()) < 500


def _mono_cfg(dt=torch.float32):
    """The smoke config in ``dt`` (fp32: the kernels' general routes)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("deepseek-v32-exp-ess-smoke"),
                               param_dtype=dt)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_cuda_forward_modes_vs_cpu(cuda, mode):
    """``forward`` on the card at smoke widths (fp32) against the plain
    path on the CPU, same weights: logits (and caches) at 1e-4; decode:
    prefill, then 4 teacher-forced steps through ``generic_decode``."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _mono_cfg()
    cpu = init_params(cfg, 3, device="cpu")
    card = {k: v for k, v in _to(cpu, cuda).items()}
    g = torch.Generator().manual_seed(23)
    toks = torch.randint(0, cfg.vocab_size, (2, 44), generator=g)
    pos = torch.arange(44)[None].expand(2, 44)
    tol = dict(rtol=1e-4, atol=1e-4)
    if mode != "decode":
        want = T.forward(cpu, cfg, toks[:, :40], pos[:, :40], mode=mode)
        got = T.forward(card, cfg, toks[:, :40].to(cuda),
                        pos[:, :40].to(cuda), mode=mode)
        torch.testing.assert_close(got.logits.cpu(), want.logits, **tol)
        if mode == "prefill":
            for a, b in zip(got.caches["mla"], want.caches["mla"]):
                torch.testing.assert_close(a.cpu(), b, **tol)
        return
    runs = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        pf = E.generic_prefill(params, cfg, toks[:, :40], pos[:, :40],
                               device=dev)
        caches = T.pad_caches(pf.caches, 48)
        out = []
        for r in range(4):
            o = E.generic_decode(params, cfg, toks[:, 40 + r:41 + r],
                                 caches["lens"][:, None], caches, device=dev)
            out.append(o.logits.cpu())
        runs[name] = (out, caches)
    for a, b in zip(runs["card"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(runs["card"][1]["mla"], runs["cpu"][1]["mla"]):
        torch.testing.assert_close(a.cpu(), b, **tol)
    assert runs["card"][1]["lens"].tolist() == [44, 44]


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def test_cuda_generic_decode_free_of_host_syncs(cuda):
    """A bf16 prefill at the attention's widths (``_mini_cfg``), then two
    ``generic_decode`` steps under sync-debug "error"; a CUDA graph
    captured over a third step replays the next ones with the same logits
    as eager steps from a copy of the caches."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _mini_cfg()
    params = init_params(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 300), generator=g,
                         device=cuda)
    pos = torch.arange(300, device=cuda)[None].expand(2, 300)
    pf = E.generic_prefill(params, cfg, toks, pos, device=cuda)
    caches = T.pad_caches(pf.caches, 320)
    tok = pf.logits[:, -1].argmax(-1)[:, None]
    with _SyncFree():
        for _ in range(2):
            o = E.generic_decode(params, cfg, tok, caches["lens"][:, None],
                                 caches, device=cuda)
            tok = o.logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches["lens"].tolist() == [302, 302]
    # capture one step over persistent buffers, replay it
    eager = {k: v for k, v in caches.items()}
    eager["mla"] = T.B.MLACache(*(a.clone() for a in caches["mla"]))
    eager["lens"] = caches["lens"].clone()
    static_tok = tok.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="relaxed")
        out = E.generic_decode(params, cfg, static_tok,
                               caches["lens"][:, None], caches, device=cuda)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    et = tok.clone()
    for _ in range(3):
        graph.replay()
        e = E.generic_decode(params, cfg, et, eager["lens"][:, None], eager,
                             device=cuda)
        torch.testing.assert_close(out.logits, e.logits, rtol=0, atol=0)
        static_tok.copy_(out.logits[:, -1].argmax(-1)[:, None])
        et = e.logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches["lens"].tolist() == eager["lens"].tolist() == [305, 305]
    assert torch.equal(caches["mla"].latent, eager["mla"].latent)


# ---------------------------------------------------------------------------
# The runtime audits on the card (repro_torch.analysis.audit): the capture
# budget (ESS103) needs CUDA graphs, the tier-dequant profile (ESS106) an
# eager round of a session that otherwise replays graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["q1", "mtp2", "tbo", "pipelined"])
def test_cuda_capture_audit_one_graph_per_key(cuda, case):
    """The mixed workload twice through a compiled smoke session: one
    capture per (kind, sampled) key that ran, unchanged by the second
    pass; one fetch a round; no state dtype drift."""
    from repro_torch.analysis import audit as A
    kw = dict(q1={}, mtp2=dict(mtp_depth=2), tbo=dict(tbo=True, mtp_depth=2),
              pipelined=dict(overlap=True, mtp_depth=2))[case]
    s = A.smoke_session(device=cuda, **kw)
    assert s.compiled
    w = A.audit_session(s, name=case, passes=2)
    assert w.findings() == []
    c = w.counts()
    assert c["captures"] == len(c["round_keys"]) >= 2     # greedy + sampled
    assert all(n == 1 for n in c["captures_by_key"].values())
    assert c["fetches"] == c["rounds"] > 0
    assert s.programs.replays + s.programs.captures == c["rounds"]


def test_cuda_capture_audit_flags_a_recapture(cuda):
    """A session whose graphs are dropped between the passes captures each
    key again: ESS103 flags it."""
    from repro_torch.analysis import audit as A
    from repro_torch.serving import engine as E

    class ForgetfulSession(E.ServeSession):
        def run(self, *a, **k):
            # set the graphs aside (alive: they hold the shared pool)
            self.lost = list(self.programs._graphs.values())
            self.programs._graphs.clear()
            return super().run(*a, **k)

    w = A.audit_session(A.smoke_session(device=cuda,
                                        session_cls=ForgetfulSession),
                        passes=2)
    fs = w.findings()
    assert fs and {f.rule for f in fs} == {"ESS103"}
    assert any("captured 2x" in f.message for f in fs)


@pytest.mark.parametrize("tier", ["int8", "fp8"])
def test_cuda_tier_dequant_audit_eager_round(cuda, tier):
    """ESS106 on the card: a compiled session's first decode round run
    eager under the profiler; no op widens the tier, while a gather that
    dequantizes the whole (pinned) tier first is flagged."""
    from repro_torch.analysis import audit as A
    from repro_torch.kernels.gather_cache import ops as gops
    w = A.audit_session(A.smoke_session(A.smoke_cfg(tier), device=cuda),
                        name=tier, profile_decode=0)
    assert w.profiled_ops and w.findings() == []
    real = gops.gather_rows_dequant
    # the sabotaged session runs eager: its whole-tier copy could not be
    # captured into a graph at all

    def dequant_then_gather(cache, scales, ids, out_dtype=torch.bfloat16,
                            **kw):
        wide = cache.to(ids.device, out_dtype) * scales.to(ids.device,
                                                          out_dtype)
        rows = wide[ids.clamp_min(0)]
        return torch.where((ids >= 0)[..., None], rows, 0)

    gops.gather_rows_dequant = dequant_then_gather
    try:
        w = A.audit_session(A.smoke_session(A.smoke_cfg(tier), device=cuda,
                                            compiled=False),
                            name=tier, profile_decode=0)
    finally:
        gops.gather_rows_dequant = real
    assert {f.rule for f in w.findings()} == {"ESS106"}


def test_cuda_migration_pack_audit(cuda):
    """ESS107 on the card: one host wait a pack, none an install, decode
    rounds at one fetch."""
    from repro_torch.analysis import audit as A
    w = A.audit_cluster(A.smoke_cluster(device=cuda))
    assert w.findings() == []
    c = w.counts()
    assert c["waits_per_pack"] == [1] and c["install_waits"] == 0


def test_cuda_engine_explicit_token_prompts(cuda):
    """An explicit token prompt (``prompt_tensor`` puts it on "cuda:0"
    while the session's device is "cuda") is taken as it is: the stream
    equals the one from the same tokens given through ``prompt_fn``."""
    import numpy as np
    from repro_torch.analysis import audit as A
    from repro_torch.models.params import init_params
    from repro_torch.serving.api import EssEngine, SamplingParams
    cfg = A.smoke_cfg()
    params = init_params(cfg, 0, device=cuda)
    toks = [int(t) for t in np.random.default_rng(11).integers(0, 256, 12)]
    outs = []
    for explicit in (True, False):
        eng = EssEngine(params, cfg, num_slots=2, max_seq=64, device=cuda,
                        prompt_fn=lambda r: np.asarray([toks]))
        [o] = eng.generate([toks] if explicit else [len(toks)],
                           SamplingParams(max_tokens=4))
        outs.append(o.tokens)
    assert len(outs[0]) == 4 and outs[0] == outs[1]


# ---------------------------------------------------------------------------
# DeepSeek-V3's dense MLA, the GQA family, Quest and the paged cache
# ---------------------------------------------------------------------------

def _v3_mini_cfg():
    """deepseek-v3-671b's attention widths (128 heads x 576: the
    tensor-core route) without the indexer, under a narrow model: 2
    layers (1 dense + 1 MoE of 16 experts), d_model 512, vocab 1024."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v3-671b")
    return dataclasses.replace(
        cfg, num_layers=2, d_model=512, d_ff=1024, vocab_size=1024,
        mtp_depth=0,
        moe=dataclasses.replace(cfg.moe, num_experts=16, d_expert=128,
                                first_dense_layers=1, dense_d_ff=1024))


def test_cuda_v3_dense_mla_prefill_and_decode_vs_cpu(cuda):
    """V3's kernel routes (bf16, the tensor-core partial: the prefill's
    causal mask per query beside the prompt's shared rows, in chunks of
    256; the decode over the whole latent cache, split and merged) against
    the same routes' plain versions on the CPU, same weights: logits of
    the prefill and of 3 teacher-forced ``generic_decode`` steps within
    2e-2 of their scale, and every partial on the tensor-core route."""
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = _v3_mini_cfg()
    cpu = init_params(cfg, 4, device="cpu")
    card = _to(cpu, cuda)
    g = torch.Generator().manual_seed(5)
    n = 300
    toks = torch.randint(0, cfg.vocab_size, (2, n + 3), generator=g)
    pos = torch.arange(n + 3)[None].expand(2, n + 3)
    runs = {}
    n_tc = sops.partial_attend.launches_tc
    n_gen = sops.partial_attend.launches_general
    for name, params, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        pf = E.generic_prefill(params, cfg, toks[:, :n], pos[:, :n],
                               device=dev, use_kernel=True)
        caches = T.pad_caches(pf.caches, n + 8)
        out = [pf.logits[:, -1].float().cpu()]
        for r in range(3):
            o = E.generic_decode(params, cfg, toks[:, n + r:n + r + 1],
                                 caches["lens"][:, None], caches,
                                 device=dev)
            out.append(o.logits[:, -1].float().cpu())
        runs[name] = out
    # 2 prefill chunks and 3 decode steps a layer on the card
    assert sops.partial_attend.launches_tc - n_tc == 2 * (2 + 3)
    assert sops.partial_attend.launches_general == n_gen
    for a, b in zip(runs["card"], runs["cpu"]):
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())


@pytest.mark.parametrize("name", ["gemma2-27b-smoke", "dbrx-132b-smoke",
                                  "qwen2-vl-7b-smoke"])
def test_cuda_gqa_forward_vs_cpu(cuda, name):
    """A GQA config (fp32) on the card against the CPU, same weights:
    prefill logits and caches, then 3 teacher-forced decode steps, at
    1e-4 (qwen2-vl from embeddings, with M-RoPE positions)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = dataclasses.replace(get_config(name), param_dtype=torch.float32)
    cpu = init_params(cfg, 1, device="cpu")
    card = _to(cpu, cuda)
    g = torch.Generator().manual_seed(3)
    n = 40
    if cfg.embedding_inputs:
        ins = torch.randn((2, n + 3, cfg.d_model), generator=g)
    else:
        ins = torch.randint(0, cfg.vocab_size, (2, n + 3), generator=g)
    pos = torch.arange(n + 3)[None].expand(2, n + 3)
    mr = pos[..., None].expand(2, n + 3, 3) if cfg.mrope_sections else None
    tol = dict(rtol=1e-4, atol=1e-4)
    runs = {}
    for which, params, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        pf = E.generic_prefill(params, cfg, ins[:, :n], pos[:, :n],
                               device=dev, mrope_positions=None if mr is None
                               else mr[:, :n])
        caches = T.pad_caches(pf.caches, n + 8)
        out = [pf.logits.cpu()]
        for r in range(3):
            o = E.generic_decode(params, cfg, ins[:, n + r:n + r + 1],
                                 caches["lens"][:, None], caches, device=dev)
            out.append(o.logits.cpu())
        runs[which] = (out, caches)
    for a, b in zip(runs["card"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, **tol)
    for a, b in zip(runs["card"][1]["kv"], runs["cpu"][1]["kv"]):
        torch.testing.assert_close(a.cpu(), b, **tol)


def test_cuda_gqa_generic_decode_graph_replay_sync_free(cuda):
    """gemma2's pattern at bf16 (a local and a global layer, soft caps):
    a prefill past the window, two ``generic_decode`` steps under
    sync-debug "error", then a CUDA graph captured over a third step
    replays the next ones with the logits of eager steps from a copy of
    the caches, bit for bit."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = dataclasses.replace(get_config("gemma2-27b-smoke"), num_layers=2)
    params = init_params(cfg, 0, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (2, 40), generator=g,
                         device=cuda)
    pos = torch.arange(40, device=cuda)[None].expand(2, 40)
    pf = E.generic_prefill(params, cfg, toks, pos, device=cuda)
    caches = T.pad_caches(pf.caches, 64)
    tok = pf.logits[:, -1].argmax(-1)[:, None]
    with _SyncFree():
        for _ in range(2):
            o = E.generic_decode(params, cfg, tok, caches["lens"][:, None],
                                 caches, device=cuda)
            tok = o.logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches["lens"].tolist() == [42, 42]
    eager = dict(caches)
    eager["kv"] = T.B.GQACache(*(a.clone() for a in caches["kv"]))
    eager["lens"] = caches["lens"].clone()
    static_tok = tok.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="relaxed")
        out = E.generic_decode(params, cfg, static_tok,
                               caches["lens"][:, None], caches, device=cuda)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    et = tok.clone()
    for _ in range(3):
        graph.replay()
        e = E.generic_decode(params, cfg, et, eager["lens"][:, None], eager,
                             device=cuda)
        torch.testing.assert_close(out.logits, e.logits, rtol=0, atol=0)
        static_tok.copy_(out.logits[:, -1].argmax(-1)[:, None])
        et = e.logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches["lens"].tolist() == eager["lens"].tolist() == [45, 45]
    assert torch.equal(caches["kv"].k, eager["kv"].k)


def test_cuda_quest_and_paged_cache_vs_cpu(cuda):
    """Quest's meta, scores, top blocks (exact), the sparse attention and
    recall (1e-5), the meta update in place, and the paged cache's
    append / gather / release on CUDA tensors against the CPU."""
    from repro_torch.cache import kv_cache as KV
    from repro_torch.core import quest as Q
    g = torch.Generator().manual_seed(2)
    B, S, KVh, H, D, block = 2, 128, 2, 8, 16, 8
    k = torch.randn((B, S, KVh, D), generator=g)
    v = torch.randn((B, S, KVh, D), generator=g)
    q = torch.randn((B, H, D), generator=g)
    lens = torch.tensor([128, 77])
    res = {}
    for dev in ("cpu", cuda):
        meta = Q.build_block_meta(k.to(dev), block)
        ids, bv = Q.quest_topk_blocks(q.to(dev), meta, lens.to(dev), block, 6)
        out = Q.gqa_sparse_attention(q.to(dev), k.to(dev), v.to(dev), ids,
                                     bv, lens.to(dev), block, 0.25)
        rec = Q.attention_recall(q.to(dev), k.to(dev), lens.to(dev), ids, bv,
                                 block, 0.25)
        Q.update_block_meta(meta, k[:, 5].to(dev) * 3, lens.to(dev) - 1,
                            block)
        res[str(dev)] = [x.cpu() for x in (meta.kmin, meta.kmax, ids, bv,
                                           out, rec)]
    for i, (a, b) in enumerate(zip(res[str(cuda)], res["cpu"])):
        if i in (2, 3):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    pk = {}
    for dev in ("cpu", cuda):
        kv = KV.init_paged(16, 4, KVh, D, B, 4, torch.float32, device=dev)
        for t in range(7):
            KV.append_token(kv, k[:, t].to(dev), v[:, t].to(dev))
        kk, vv, valid = KV.gather_kv(kv, 8)
        KV.release_sequence(kv, 1)
        pk[str(dev)] = [x.cpu() for x in (*kv, kk, vv, valid)]
    for a, b in zip(pk[str(cuda)], pk["cpu"]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The SSM, hybrid and encoder-decoder stacks (plain torch on the card: the
# reference has no Pallas kernel there)
# ---------------------------------------------------------------------------

STACK_SMOKES = ["mamba2-780m-smoke", "zamba2-7b-smoke",
                "whisper-large-v3-smoke"]


def _clone_caches(caches):
    return {k: v.clone() if torch.is_tensor(v)
            else type(v)(*(a.clone() for a in v)) for k, v in caches.items()}


def _stack_inputs(cfg, n, dev, seed=3):
    """Token ids [2, n] and, for the encoder-decoder, frame embeddings
    [2, Se, d] (the stubbed front end's output), from a CPU generator."""
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, cfg.vocab_size, (2, n), generator=g)
    enc = None
    if cfg.encdec is not None:
        enc = torch.randn((2, cfg.encdec.encoder_seq, cfg.d_model),
                          generator=g).to(cfg.param_dtype).to(dev)
    return toks.to(dev), enc


def test_cuda_ssd_chunked_vs_cpu(cuda):
    """The SSD scan at mamba2-780m's mixer widths (48 heads of 64, state
    128, chunks of 256) over 1000 tokens padded to 1024, from an h0: the
    card against the CPU within 1e-4 of the outputs' scale."""
    from repro_torch.models import ssm as SSM
    g = torch.Generator().manual_seed(4)
    b, s, h, p, n = 2, 1024, 48, 64, 128
    x = torch.randn((b, s, h, p), generator=g)
    a = -torch.randn((b, s, h), generator=g).abs() * 0.1
    a[:, 1000:] = 0                       # the zero-padded tail
    Bm = torch.randn((b, s, 1, n), generator=g)
    Cm = torch.randn((b, s, 1, n), generator=g)
    h0 = torch.randn((b, h, p, n), generator=g)
    want = SSM.ssd_chunked(x, a, Bm, Cm, 256, h0)
    got = SSM.ssd_chunked(*(t.to(cuda) for t in (x, a, Bm, Cm)), 256,
                          h0.to(cuda))
    for t, w in zip(got, want):
        assert float((t.cpu() - w).abs().max()) <= \
            1e-4 * float(w.abs().max())


@pytest.mark.parametrize("name", STACK_SMOKES)
def test_cuda_stack_forward_vs_cpu(cuda, name):
    """A stack (fp32) on the card against the CPU, same weights: train
    logits, prefill logits and every cache entry, then 3 teacher-forced
    decode steps and the caches after them, at 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = dataclasses.replace(get_config(name), param_dtype=torch.float32)
    cpu = init_params(cfg, 1, device="cpu")
    card = _to(cpu, cuda)
    n = 40
    toks, enc = _stack_inputs(cfg, n + 3, "cpu")
    pos = torch.arange(n + 3)[None].expand(2, n + 3)
    tol = dict(rtol=1e-4, atol=1e-4)
    runs = {}
    for which, params, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        e = None if enc is None else enc.to(dev)
        out = [T.forward(params, cfg, toks.to(dev), pos.to(dev),
                         mode="train", enc_inputs=e).logits.cpu()]
        pf = E.generic_prefill(params, cfg, toks[:, :n], pos[:, :n],
                               device=dev, enc_inputs=e)
        out.append(pf.logits.cpu())
        caches = T.pad_caches(pf.caches, n + 8)
        pre = _clone_caches(caches)
        for r in range(3):
            o = E.generic_decode(params, cfg, toks[:, n + r:n + r + 1],
                                 caches["lens"][:, None], caches, device=dev)
            out.append(o.logits.cpu())
        runs[which] = (out, pre, caches)
    for a, b in zip(runs["card"][0], runs["cpu"][0]):
        torch.testing.assert_close(a, b, **tol)
    for i in (1, 2):
        for k, v in runs["cpu"][i].items():
            for a, b in zip(runs["card"][i][k], v):
                torch.testing.assert_close(a.cpu(), b, **tol)


@pytest.mark.parametrize("name", STACK_SMOKES)
def test_cuda_stack_generic_decode_graph_replay_sync_free(cuda, name):
    """bf16: a prefill, two ``generic_decode`` steps under sync-debug
    "error", then a CUDA graph captured over a third step replays the
    next ones with the logits of eager steps from a copy of the caches,
    bit for bit; the state / caches end equal too."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import init_params
    from repro_torch.serving import engine as E
    cfg = get_config(name)
    params = init_params(cfg, 0, device=cuda)
    toks, enc = _stack_inputs(cfg, 40, cuda)
    pos = torch.arange(40, device=cuda)[None].expand(2, 40)
    pf = E.generic_prefill(params, cfg, toks, pos, device=cuda,
                           enc_inputs=enc)
    caches = T.pad_caches(pf.caches, 64)
    dtypes = {k: [a.dtype for a in v] for k, v in caches.items()
              if k != "lens"}
    tok = pf.logits[:, -1].argmax(-1)[:, None]
    with _SyncFree():
        for _ in range(2):
            o = E.generic_decode(params, cfg, tok, caches["lens"][:, None],
                                 caches, device=cuda)
            tok = o.logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches["lens"].tolist() == [42, 42]
    eager = _clone_caches(caches)
    static_tok = tok.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(capture_error_mode="relaxed")
        out = E.generic_decode(params, cfg, static_tok,
                               caches["lens"][:, None], caches, device=cuda)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    et = tok.clone()
    for _ in range(3):
        graph.replay()
        e = E.generic_decode(params, cfg, et, eager["lens"][:, None], eager,
                             device=cuda)
        torch.testing.assert_close(out.logits, e.logits, rtol=0, atol=0)
        static_tok.copy_(out.logits[:, -1].argmax(-1)[:, None])
        et = e.logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    assert caches["lens"].tolist() == eager["lens"].tolist() == [45, 45]
    for k, v in eager.items():
        if k != "lens":
            assert [a.dtype for a in caches[k]] == dtypes[k], k
            assert all(torch.equal(a, b) for a, b in zip(caches[k], v)), k


# ---------------------------------------------------------------------------
# training: a step on the card against the CPU, the DSA train mask
# ---------------------------------------------------------------------------

@functools.cache
def _chip_smoke():
    """``chip_smoke.py`` as a module (its import runs nothing): the train
    phase's checks and configs."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", _chip_smoke().TRAIN_SMOKES)
def test_cuda_train_step_vs_cpu(cuda, name):
    """One train step (fp32, remat "dots") on the card against the CPU on
    the same parameters and batch (``chip_smoke.step_vs_cpu``, the train
    phase's T3): the loss within 1e-5 relative; each leaf's gradient
    within 1e-4 of its largest entry; the parameters and moments within
    1e-5 of the CPU's AdamW on the card's gradients, and of the CPU's
    step wherever a first AdamW step is well posed.  V3.2's DSA mask
    launches the indexer kernel."""
    lerr, worst, left, launches, _, _ = _chip_smoke().step_vs_cpu(
        torch, cuda, name)
    assert lerr <= 1e-5 and worst <= 1e-5 and left <= 0.05
    assert (launches > 0) == ("v32" in name)


@pytest.mark.parametrize("dt", DTYPES)
def test_cuda_dsa_train_mask_vs_plain(cuda, dt):
    """``mla.dsa_train_keep`` (the train step's DSA mask, row 2-tr) on the
    card at the indexer's widths (64 heads x 128), 600 causal positions,
    top-256: one launch of the indexer kernel (fp32: the general route;
    bf16: the tensor-core route), the mask it builds equal to the mask of
    the kernel's scores, and that mask equal to the plain version's except
    at keys within twice the score error of their row's k-th score
    (``chip_smoke.keep_mask_vs_plain``)."""
    import dataclasses

    from repro_torch.configs.base import DSAConfig
    from repro_torch.models import mla as M
    cfg = dataclasses.replace(_mono_cfg(TORCH_DT[dt]), dsa=DSAConfig(
        index_heads=64, index_dim=128, index_topk=256))
    g = torch.Generator().manual_seed(8)
    d, S = 256, 600

    def rnd(*shape):
        return (torch.randn(shape, generator=g) * d ** -0.5).to(
            TORCH_DT[dt]).to(cuda)
    pi = {"w_iq": rnd(d, 64, 128), "w_ik": rnd(d, 128), "w_iw": rnd(d, 64)}
    x = rnd(2, S, d) * d ** 0.5
    pos = torch.arange(S, device=cuda)[None].expand(2, S)
    valid = (pos[:, None, :, None] >= pos[:, None, None, :])[:, 0]
    n0, tc0 = iops.indexer_scores.launches, iops.indexer_scores.launches_tc
    keep = M.dsa_train_keep(pi, cfg, x, valid)
    assert iops.indexer_scores.launches == n0 + 1
    assert iops.indexer_scores.launches_tc == tc0 + (dt == "bf16")
    iq = M.indexer_query(pi, x)
    sc, _, _, _ = _chip_smoke().keep_mask_vs_plain(
        torch, iq.q, iq.w, M.indexer_keys(pi, x), valid, 256)
    assert torch.equal(keep, M.dsa_keep_mask(sc, 256, valid))
    assert int(keep.sum(-1).max()) == 256
