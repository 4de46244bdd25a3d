"""Each CUDA kernel against its plain PyTorch version, on the card.

These tests need a CUDA device and nvcc; without one they skip.  They
import neither JAX nor the reference package, so they run on a machine
that has only PyTorch (the repository's conftest imports JAX, hence
``--noconftest``):

  PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_cuda.py

Both sides compute in fp32 from the same inputs, so the float kernels are
held at rtol/atol 1e-4 (summation order only); the row gather and scatter
are bit-exact.
"""

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
