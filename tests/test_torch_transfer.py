"""The pipelined round's slab primitives of the port against
``repro.core.transfer`` and ``repro.core.offload`` on the CPU (numpy
inputs from a seed; everything here is integer work or data movement, so
every comparison is exact, bit for bit):

* ``empty_slab``, raw and quantized (``test_overlap_pipeline.py``'s
  primitives);
* ``plan_prefetch`` on the reference's cases and on random scores with
  many exact 0.0 ties (the ReLU'd indexer's): the same ids as
  ``lax.top_k``, whose lowest index wins a tie;
* ``match_staged``, raw and int8 (dequantized at miss width);
* the ``TransferEngine`` edges (truncate with a device length,
  invalidate, issue, await, commit);
* ``gather_into_slab`` / ``scatter_from_slab`` on paged and dense tiers,
  bf16 and int8 (payload and scale plane), and on the dense tier's TBO
  half views, against the reference's per-plane calls; the raw gather's
  plain version (the CUDA kernel's oracle) against the reference's
  gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import offload as JO
from repro.core import transfer as JTR
from repro_torch.core import offload as TO
from repro_torch.core import transfer as TTR
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.models.params import array_to_torch
from repro_torch.serving.engine import ServeReport


def eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def tt(a):
    return array_to_torch(np.asarray(a))


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
def test_empty_slab_matches_reference(quant):
    jid, jrow, jsc = JTR.empty_slab(3, 2, 4, 8, jnp.int8 if quant
                                    else jnp.bfloat16,
                                    jnp.float16 if quant else None)
    tid, trow, tsc = TTR.empty_slab(3, 2, 4, 8, torch.int8 if quant
                                    else torch.bfloat16,
                                    torch.float16 if quant else None)
    assert tid.dtype == torch.int32 and tid.shape == jid.shape
    eq(tid, jid)
    assert trow.shape == jrow.shape and not trow.any()
    assert trow.dtype == (torch.int8 if quant else torch.bfloat16)
    if quant:
        assert tsc.dtype == torch.float16 and tsc.shape == jsc.shape
        assert not tsc.any()
    else:
        assert tsc is None and jsc is None


def _plan_cases():
    """(sc [N,S], qlens [N], slot_of [N,S], live [N], P) cases: the
    reference tests' two, then random ones with many exact zeros."""
    sc = np.asarray([[.1, .9, .3, .8, .7, .2, .99, .5],
                     [.9, .9, .9, .9, .9, .9, .9, .9]], np.float32)
    so = np.full((2, 8), -1, np.int32)
    so[0, 1], so[0, 4] = 3, 0
    yield "reference", sc, np.asarray([6, 8]), so, np.asarray([True, False]), 3
    yield ("pads", np.asarray([[.5, .6, .7, .8]], np.float32),
           np.asarray([2]), np.full((1, 4), -1, np.int32),
           np.asarray([True]), 6)
    rng = np.random.default_rng(7)
    for N, S, P in ((16, 300, 64), (8, 40, 64), (12, 1000, 256)):
        sc = rng.standard_normal((N, S)).astype(np.float32)
        sc[rng.random((N, S)) < 0.6] = 0.0           # ReLU'd: exact ties
        sc[:, ::7] = -2.0e38                         # masked positions
        so = np.where(rng.random((N, S)) < 0.3,
                      rng.integers(0, 50, (N, S)), -1).astype(np.int32)
        qlens = rng.integers(0, S + 1, N)
        live = rng.random(N) < 0.8
        yield f"ties-{N}x{S}-P{P}", sc, qlens, so, live, P


@pytest.mark.parametrize("case", list(_plan_cases()), ids=lambda c: c[0])
def test_plan_prefetch_matches_reference(case):
    _, sc, qlens, so, live, P = case
    want = JTR.plan_prefetch(jnp.asarray(sc), jnp.asarray(qlens, jnp.int32),
                             jnp.asarray(so), jnp.asarray(live), topk=8,
                             prefetch_rows=P)
    got = TTR.plan_prefetch(torch.tensor(sc), torch.tensor(qlens),
                            torch.tensor(so, dtype=torch.int64),
                            torch.tensor(live), 8, P)
    assert got.dtype == torch.int32 and got.shape == want.shape
    eq(got, want)


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
def test_match_staged_matches_reference(quant):
    rng = np.random.default_rng(3)
    B, P, M, D = 3, 24, 40, 16
    ids = np.where(rng.random((B, P)) < 0.8,
                   rng.permutation(64)[:P][None].repeat(B, 0), -1)
    ids = ids.astype(np.int32)
    miss = np.where(rng.random((B, M)) < 0.9,
                    rng.integers(0, 64, (B, M)), -1).astype(np.int32)
    need = rng.random((B, M)) < 0.7
    if quant:
        rows = rng.integers(-127, 128, (B, P, D)).astype(np.int8)
        scales = (rng.random((B, P, 1)) * 0.1).astype(np.float16)
        jm, jr = JTR.match_staged(jnp.asarray(ids), jnp.asarray(rows),
                                  jnp.asarray(miss), jnp.asarray(need),
                                  staged_scales_l=jnp.asarray(scales),
                                  out_dtype=jnp.float32)
        tm, tr = TTR.match_staged(tt(ids), tt(rows), tt(miss).long(),
                                  torch.tensor(need), tt(scales),
                                  out_dtype=torch.float32)
    else:
        rows = rng.standard_normal((B, P, D)).astype(np.float32)
        jm, jr = JTR.match_staged(jnp.asarray(ids), jnp.asarray(rows),
                                  jnp.asarray(miss), jnp.asarray(need))
        tm, tr = TTR.match_staged(tt(ids), tt(rows), tt(miss).long(),
                                  torch.tensor(need))
    assert bool(tm.any()) and not bool(tm.all())
    eq(tm, jm)
    eq(tr, jr)


class _State:
    """The slab fields of an engine state (both packages' edges read and
    write only these)."""

    def __init__(self, ids, rows, scales=None):
        self.staged_ids, self.staged_rows = ids, rows
        self.staged_scales = scales

    def _replace(self, **kw):
        return _State(kw.get("staged_ids", self.staged_ids),
                      kw.get("staged_rows", self.staged_rows),
                      kw.get("staged_scales", self.staged_scales))


def test_transfer_engine_edges_match_reference():
    ids = np.asarray([[[2, 5, 9], [1, 4, 8]],
                      [[3, 6, 7], [0, 2, 5]]], np.int32)
    rows = np.arange(2 * 2 * 3 * 4, dtype=np.float32).reshape(2, 2, 3, 4)
    jte = JTR.TransferEngine(2, 2, 3, 4, jnp.float32)
    tte = TTR.TransferEngine(2, 2, 3, 4, torch.float32)
    js = _State(jnp.asarray(ids), jnp.asarray(rows))
    ts = _State(tt(ids), tt(rows).clone())
    keep = ts.staged_ids
    # truncate slot 1 at a device length (no host int); invalidate slot 0
    js = jte.truncate_slot(js, 1, jnp.asarray(5, jnp.int32))
    ts = tte.truncate_slot(ts, 1, torch.tensor(5))
    assert ts.staged_ids is keep                     # in place
    eq(ts.staged_ids, js.staged_ids)
    js, ts = jte.invalidate_slot(js, 0), tte.invalidate_slot(ts, 0)
    eq(ts.staged_ids, js.staged_ids)
    assert ts.staged_ids.tolist()[0] == [[-1, -1, -1], [1, 4, -1]]
    for (j, t) in zip(jte.await_staged(js), tte.await_staged(ts)):
        if j is None:
            assert t is None
        else:
            eq(t, j)
    js, ts = jte.issue_stage(js), tte.issue_stage(ts)
    assert ts.staged_ids is keep
    eq(ts.staged_ids, js.staged_ids)
    eq(ts.staged_rows, js.staged_rows)
    jr, tr = ServeReport(), ServeReport()
    for rep, te in ((jr, jte), (tr, tte)):
        te.commit(rep, np.int64(7), np.int64(3), np.int64(11))
        te.commit(rep, 1, 1, 0)
    assert (tr.prefetch_hits, tr.prefetch_misses,
            tr.prefetch_wasted_rows) == (8, 4, 11) == \
        (jr.prefetch_hits, jr.prefetch_misses, jr.prefetch_wasted_rows)
    assert tr.prefetch_hit_rate == pytest.approx(8 / 12)


# ---------------------------------------------------------------------------
# the slab gather and the commit scatter on the tier
# ---------------------------------------------------------------------------

L, B, NB, R, D, P, Q = 3, 4, 5, 4, 16, 6, 2


def _tier(rng, paged, quant):
    """A random stacked tier (payload, scales | None) and block tables."""
    lead = (L, B * NB, R) if paged else (L, B, NB * R)
    if quant:
        host = rng.integers(-127, 128, lead + (D,)).astype(np.int8)
        scales = (rng.random(lead + (1,)) * 0.1).astype(np.float16)
    else:
        host = rng.standard_normal(lead + (D,)).astype(np.float32)
        scales = None
    bt = None
    if paged:
        bt = rng.permutation(B * NB).reshape(B, NB).astype(np.int32)
        bt[1, 3:] = -1                                # unmapped pages
    return host, scales, bt


def _slab_ids(rng):
    ids = rng.integers(-1, NB * R + 3, (L, B, P)).astype(np.int32)
    return ids                                        # -1, live, past end


CASES = [(p, q) for p in (True, False) for q in (False, True)]
CASE_IDS = [f"{'paged' if p else 'dense'}-{'int8' if q else 'raw'}"
            for p, q in CASES]


@pytest.mark.parametrize("paged,quant", CASES, ids=CASE_IDS)
def test_gather_into_slab_matches_reference(paged, quant):
    rng = np.random.default_rng(11)
    host, scales, bt = _tier(rng, paged, quant)
    ids = _slab_ids(rng)
    mask = np.asarray([True, True, False, True])
    jbt = None if bt is None else jnp.asarray(bt)
    want = JO.gather_into_slab(jnp.asarray(host), jnp.asarray(ids),
                               slot_mask=jnp.asarray(mask), block_table=jbt)
    tbt = None if bt is None else tt(bt).long()
    got, got_s = TO.gather_into_slab(
        tt(host), None if scales is None else tt(scales), tt(ids),
        slot_mask=torch.tensor(mask), block_table=tbt)
    eq(got, want)
    assert got.dtype == tt(host).dtype
    if quant:
        want_s = JO.gather_into_slab(jnp.asarray(scales), jnp.asarray(ids),
                                     slot_mask=jnp.asarray(mask),
                                     block_table=jbt)
        eq(got_s.view(torch.int16), np.asarray(want_s).view(np.int16))
    else:
        assert got_s is None
    # out= / out_scales= receive the same bytes
    out = torch.full_like(got, 3)
    out_s = None if got_s is None else torch.full_like(got_s, 3)
    TO.gather_into_slab(tt(host), None if scales is None else tt(scales),
                        tt(ids), slot_mask=torch.tensor(mask),
                        block_table=tbt, out=out, out_scales=out_s)
    assert torch.equal(out, got)
    if quant:
        assert torch.equal(out_s.view(torch.int16), got_s.view(torch.int16))


@pytest.mark.parametrize("paged,quant", CASES, ids=CASE_IDS)
def test_scatter_from_slab_matches_reference(paged, quant):
    rng = np.random.default_rng(12)
    host, scales, bt = _tier(rng, paged, quant)
    widx = rng.integers(0, NB * R + 2, (B, Q))
    widx[2] = -1                                      # a masked slot
    if quant:
        rows = rng.integers(-127, 128, (L, B, Q, D)).astype(np.int8)
        rs = (rng.random((L, B, Q, 1)) * 0.1).astype(np.float16)
    else:
        rows = rng.standard_normal((L, B, Q, D)).astype(np.float32)
        rs = None
    jbt = None if bt is None else jnp.asarray(bt)
    want = JO.scatter_from_slab(jnp.asarray(host), jnp.asarray(widx),
                                jnp.asarray(rows), slot_mask=None,
                                block_table=jbt)
    th, ts = tt(host).clone(), None if scales is None else tt(scales).clone()
    got, got_s = TO.scatter_from_slab(
        th, ts, torch.tensor(widx), tt(rows),
        None if rs is None else tt(rs), slot_mask=None,
        block_table=None if bt is None else tt(bt).long())
    assert got is th
    eq(got, want)
    if quant:
        want_s = JO.scatter_from_slab(jnp.asarray(scales), jnp.asarray(widx),
                                      jnp.asarray(rs), slot_mask=None,
                                      block_table=jbt)
        eq(got_s.view(torch.int16), np.asarray(want_s).view(np.int16))


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
def test_slab_ops_on_a_dense_tbo_half(quant):
    """A TBO half of a dense tier is a strided view of its batch rows: the
    stacked gather and write address the whole tier's storage through it,
    as the reference's halves do on their slices."""
    rng = np.random.default_rng(13)
    host, scales, _ = _tier(rng, False, quant)
    ids = _slab_ids(rng)[:, 2:]
    th = tt(host).clone()
    ts = None if scales is None else tt(scales).clone()
    half = th[:, 2:]
    half_s = None if ts is None else ts[:, 2:]
    got, got_s = TO.gather_into_slab(half, half_s, tt(ids), slot_mask=None)
    eq(got, JO.gather_into_slab(jnp.asarray(host[:, 2:]), jnp.asarray(ids),
                                slot_mask=None))
    if quant:
        eq(got_s.view(torch.int16), np.asarray(JO.gather_into_slab(
            jnp.asarray(scales[:, 2:]), jnp.asarray(ids),
            slot_mask=None)).view(np.int16))
    widx = rng.integers(0, NB * R, (2, Q))
    rows = tt(host[:, :2, :Q])                      # [L,2,Q,D] of the dtype
    rs = None if scales is None else tt(scales[:, :2, :Q])
    TO.scatter_from_slab(half, half_s, torch.tensor(widx), rows, rs,
                         slot_mask=None)
    want = JO.scatter_from_slab(jnp.asarray(host[:, 2:]), jnp.asarray(widx),
                                jnp.asarray(host[:, :2, :Q]), slot_mask=None)
    eq(th[:, 2:], want)
    eq(th[:, :2], host[:, :2])                      # the other half intact


@pytest.mark.parametrize("quant", [False, True], ids=["raw", "int8"])
def test_gather_rows_raw_plain_version(quant):
    """The raw gather's plain version (what the CUDA kernel is held
    against): each id's stored row and scale, zeros below 0, the last row
    past the end, as the reference's gather."""
    rng = np.random.default_rng(5)
    S = 50
    ids = rng.integers(-3, S + 4, (7, 9))
    if quant:
        cache = rng.integers(-127, 128, (S, 576)).astype(np.int8)
        sc = (rng.random((S, 1)) * 0.1).astype(np.float16)
    else:
        cache = rng.standard_normal((S, 576)).astype(np.float32)
        sc = None
    fetched = torch.zeros((), dtype=torch.int32)
    rows, srows = gops.gather_rows_raw(tt(cache), None if sc is None
                                       else tt(sc), torch.tensor(ids),
                                       fetched=fetched)
    eq(rows, JO.host_gather_rows(jnp.asarray(cache)[None], jnp.asarray(ids)
                                 .reshape(1, -1)).reshape(7, 9, 576))
    assert int(fetched) == int((ids >= 0).sum())
    if quant:
        want = JO.host_gather_rows(jnp.asarray(sc)[None],
                                   jnp.asarray(ids).reshape(1, -1))
        eq(srows.view(torch.int16),
           np.asarray(want).reshape(7, 9, 1).view(np.int16))
    else:
        assert srows is None

