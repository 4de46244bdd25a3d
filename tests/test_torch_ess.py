"""The port's ESS state machinery against ``repro.core`` / ``repro.cache``
on the CPU: LRU pool (lookup with and without dedup, admit, tick), the host
tier (block-table translation, paged and dense gather/scatter) and one
layer of ESS sparse attention in modes ``none`` and ``da``.

Pool maps, miss buffers, block tables and ``lens`` must be **equal**;
float outputs are fp32 at rtol/atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import latent_cache as JLC
from repro.configs import get_config as jget
from repro.core import lru_pool as JLP
from repro.core import offload as JOF
from repro.core import overlap as JOV
from repro.models import mla as JM
from repro.models.params import init_params as jinit
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload as OF
from repro_torch.core import overlap as OV
from repro_torch.models.params import from_jax_params

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

TOL = dict(rtol=1e-5, atol=1e-5)


def eq(t, j):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j))


def close(t, j):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL)


def assert_pool_equal(tp, jp):
    for f in ("ids", "last_use", "slot_of", "step"):
        eq(getattr(tp, f), getattr(jp, f))
    close(tp.data, jp.data)


# ---------------------------------------------------------------------------
# LRU pool
# ---------------------------------------------------------------------------

def _requests(rng, B, K, S, dup):
    ids = np.stack([rng.choice(S, K, replace=dup) for _ in range(B)])
    valid = rng.random((B, K)) < 0.85
    return ids.astype(np.int32), valid


@pytest.mark.parametrize("dedup", [True, False])
@pytest.mark.parametrize("M", [3, 6])
def test_lookup_admit_tick_sequence_matches_reference(dedup, M):
    B, P, S, D, K = 3, 7, 24, 4, 6
    rng = np.random.default_rng(M + 10 * dedup)
    jp = JLP.init_pool(B, P, S, D, jnp.float32)
    tp = LP.init_pool(B, P, S, D, torch.float32, "cpu")
    mask = np.array([True, True, False])
    for step in range(12):
        ids, valid = _requests(rng, B, K, S, dup=dedup)
        sm = mask if step % 3 == 1 else None
        jp, jl, js = JLP.lookup(jp, jnp.asarray(ids), jnp.asarray(valid), M,
                                slot_mask=None if sm is None
                                else jnp.asarray(sm), dedup=dedup)
        tp, tl, ts = LP.lookup(tp, torch.tensor(ids).long(),
                               torch.tensor(valid), M,
                               slot_mask=None if sm is None
                               else torch.tensor(sm), dedup=dedup)
        for a, b in zip(tl, jl):
            eq(a, b)
        for a, b in zip(ts, js):
            eq(a, b)
        rows = rng.standard_normal((B, M, D), dtype=np.float32)
        jp = JLP.tick(JLP.admit(jp, jl.miss_ids, jnp.asarray(rows),
                                slot_mask=None if sm is None
                                else jnp.asarray(sm)))
        tp = LP.tick(LP.admit(tp, tl.miss_ids, torch.tensor(rows),
                              slot_mask=None if sm is None
                              else torch.tensor(sm)))
        assert_pool_equal(tp, jp)
        assert LP.check_consistent(tp)


def test_pool_tie_order_equal_stamps_and_empty_slots():
    # every admission of a step shares one stamp and empty slots tie at -1:
    # eviction must pick the lowest slot among equal stamps, as lax.top_k
    B, P, S, D = 2, 5, 30, 2
    jp = JLP.init_pool(B, P, S, D, jnp.float32)
    tp = LP.init_pool(B, P, S, D, torch.float32, "cpu")
    batches = [[[1, 2, 3], [4, 5, -1]], [[6, 7, 8], [9, 1, 2]],
               [[1, 10, 11], [4, 12, 13]], [[14, 15, 16], [17, 18, 19]]]
    for req in batches:
        ids = np.array(req, np.int32)
        valid = ids >= 0
        jp, jl, _ = JLP.lookup(jp, jnp.asarray(ids), jnp.asarray(valid), 3,
                               slot_mask=None, dedup=False)
        tp, tl, _ = LP.lookup(tp, torch.tensor(ids).long(),
                              torch.tensor(valid), 3, slot_mask=None,
                              dedup=False)
        rows = np.full((B, 3, D), 1.0 + len(req), np.float32)
        jp = JLP.tick(JLP.admit(jp, jl.miss_ids, jnp.asarray(rows),
                                slot_mask=None))
        tp = LP.tick(LP.admit(tp, tl.miss_ids, torch.tensor(rows),
                              slot_mask=None))
        assert_pool_equal(tp, jp)
    assert int(tp.evicted.sum()) > 0


def test_protected_slots_and_pool_size():
    jp = JLP.init_pool(1, 4, 16, 2, jnp.float32)
    tp = LP.init_pool(1, 4, 16, 2, torch.float32, "cpu")
    ids = np.array([[0, 1, 2, 3]])
    rows = np.ones((1, 4, 2), np.float32)
    jp = JLP.tick(JLP.admit(jp, jnp.asarray(ids), jnp.asarray(rows),
                            slot_mask=None))
    tp = LP.tick(LP.admit(tp, torch.tensor(ids), torch.tensor(rows),
                          slot_mask=None))
    new = np.array([[5, 6]])
    prot = np.array([[0, 1]])
    jp = JLP.admit(jp, jnp.asarray(new), jnp.asarray(rows[:, :2]),
                   slot_mask=None, protect_slots=jnp.asarray(prot))
    tp = LP.admit(tp, torch.tensor(new), torch.tensor(rows[:, :2]),
                  slot_mask=None, protect_slots=torch.tensor(prot))
    assert_pool_equal(tp, jp)
    for args in [(0.25, 8224, 2048, 6400), (0.5, 40, 8, 8),
                 (0.3, 100, 64, 6400)]:
        assert LP.pool_entries_for(*args) == JLP.pool_entries_for(*args)


# ---------------------------------------------------------------------------
# Host tier
# ---------------------------------------------------------------------------

def smoke_cfgs():
    j = dataclasses.replace(jget("deepseek-v32-exp-ess-smoke"),
                            param_dtype=jnp.float32)
    t = dataclasses.replace(tget("deepseek-v32-exp-ess-smoke"),
                            param_dtype=torch.float32)
    return j, t


def test_init_ess_caches_layout_matches_reference():
    jcfg, tcfg = smoke_cfgs()
    jc = JLC.init_ess_caches(jcfg, 3, 40, jnp.float32)
    tc = LC.init_ess_caches(tcfg, 3, 40, torch.float32, device="cpu")
    assert tuple(tc.host_latent.shape) == jc.host_latent.shape
    eq(tc.block_tables, jc.block_tables)
    eq(tc.lens, jc.lens)
    assert len(tc.ikeys) == len(jc.ikeys) == jcfg.num_layers
    assert tuple(tc.ikeys[0].shape) == jc.ikeys[0].shape
    assert_pool_equal(tc.pools[0], jc.pools[0])
    assert LC.pool_entries(tcfg, 40) == JLC.pool_entries(jcfg, 40)
    assert LC.num_blocks(tcfg, 40) == JLC.num_blocks(jcfg, 40)
    # a quantized tier: one-byte payload beside an f16 scale plane
    for name, qdt in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        q = dict(host_cache_dtype=name)
        jq = JLC.init_ess_caches(dataclasses.replace(jcfg, ess=dataclasses
                                 .replace(jcfg.ess, **q)), 3, 40, jnp.float32)
        tq = LC.init_ess_caches(dataclasses.replace(tcfg, ess=dataclasses
                                .replace(tcfg.ess, **q)), 3, 40,
                                torch.float32, device="cpu")
        assert tq.host_latent.dtype == qdt
        assert tuple(tq.host_latent.shape) == jq.host_latent.shape
        assert tq.host_scales.dtype == torch.float16
        assert tuple(tq.host_scales.shape) == jq.host_scales.shape


@pytest.mark.parametrize("paged", [True, False])
def test_host_scatter_gather_match_reference(paged):
    jcfg, tcfg = smoke_cfgs()
    B, S, D = 3, 40, jcfg.mla.latent_dim
    rng = np.random.default_rng(7)
    if paged:
        jh = JLC.init_ess_caches(jcfg, B, S, jnp.float32).host_latent
        NP = jh.shape[1]
        bt = rng.permutation(NP).reshape(B, -1).astype(np.int32)
        bt[2, 1] = -1                                  # an unmapped page
        jbt, tbt = jnp.asarray(bt), torch.tensor(bt).long()
    else:
        jh = jnp.zeros((jcfg.num_layers, B, S, D), jnp.float32)
        jbt = tbt = None
    th = torch.tensor(np.asarray(jh))
    ids = np.array([[0, 5, 17, 39], [1, 2, 3, -1], [38, 0, 20, 45]],
                   np.int32)
    rows = rng.standard_normal((B, 4, D), dtype=np.float32)
    mask = np.array([True, False, True])
    for layer in (0, jcfg.num_layers - 1):
        jh = JOF.host_scatter_rows(jh, jnp.asarray(ids), jnp.asarray(rows),
                                   slot_mask=jnp.asarray(mask), layer=layer,
                                   block_table=jbt)
        th = OF.host_scatter_rows(th, torch.tensor(ids).long(),
                                  torch.tensor(rows),
                                  slot_mask=torch.tensor(mask), layer=layer,
                                  block_table=tbt)
        eq(th, jh)
        got = OF.host_gather_rows(th, torch.tensor(ids).long(), layer=layer,
                                  block_table=tbt)
        want = JOF.host_gather_rows(jh, jnp.asarray(ids), layer=layer,
                                    block_table=jbt)
        eq(got, want)
    # stacked (prefill flush): every layer at once
    rows_l = rng.standard_normal((jcfg.num_layers, B, 4, D), dtype=np.float32)
    jh = JOF.host_scatter_rows_stacked(jh, jnp.asarray(ids),
                                       jnp.asarray(rows_l), slot_mask=None,
                                       block_table=jbt)
    th = OF.host_scatter_rows_stacked(th, torch.tensor(ids).long(),
                                      torch.tensor(rows_l), slot_mask=None,
                                      block_table=tbt)
    eq(th, jh)


def test_paged_phys_matches_reference():
    rng = np.random.default_rng(8)
    bt = rng.permutation(12).reshape(4, 3).astype(np.int32)
    bt[1, 2] = -1
    ids = rng.integers(-2, 60, (2, 9)).astype(np.int32)
    for off in (0, 1, 3):
        jphys, jv = JOF._paged_phys(jnp.asarray(ids), jnp.asarray(bt), 16,
                                    12, off)
        tphys, tv = OF._paged_phys(torch.tensor(ids).long(),
                                   torch.tensor(bt).long(), 16, 12, off)
        eq(tv, jv)
        eq(torch.where(tv, tphys, -1), jnp.where(jv, jphys, -1))


# ---------------------------------------------------------------------------
# One layer of ESS sparse attention
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def attn_setup():
    jcfg, tcfg = smoke_cfgs()
    defs = {"mla": JM.mla_def(jcfg), "indexer": JM.indexer_def(jcfg)}
    jp = jax.jit(lambda k: jinit(k, defs))(jax.random.key(0))
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(9)
    B, S, ctx = 3, 64, 40
    lat = rng.standard_normal((B, S, jcfg.mla.latent_dim),
                              dtype=np.float32) * 0.5
    ikeys = rng.standard_normal((B, S, jcfg.dsa.index_dim), dtype=np.float32)
    x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32) * 0.3
    return jcfg, tcfg, jp, tp, lat, ikeys, x, B, S, ctx


@pytest.mark.parametrize("mode", ["none", "da"])
@pytest.mark.parametrize("zero_keys", [False, True])
def test_ess_sparse_attention_matches_reference(attn_setup, mode, zero_keys):
    """Two steps from a cold pool (misses, admissions, then hits); with
    all-zero indexer keys every score ties at 0.0 and the top-k must pick
    the lowest positions, as lax.top_k."""
    jcfg, tcfg, jp, tp, lat, ikeys, x, B, S, ctx = attn_setup
    if zero_keys:
        ikeys = np.zeros_like(ikeys)
    P = 16
    jst = JOV.ESSLayerState(JLP.init_pool(B, P, S, lat.shape[-1],
                                          jnp.float32), jnp.asarray(lat))
    tst = OV.ESSLayerState(LP.init_pool(B, P, S, lat.shape[-1],
                                        torch.float32, "cpu"),
                           torch.tensor(lat))
    lens = np.array([ctx, ctx - 7, 9])
    pos = (lens - 1)[:, None]
    mask = np.array([True, True, False])
    for step in range(2):
        sm = None if step == 0 else mask
        jo, jst, js = JOV.ess_sparse_attention(
            jp["mla"], jp["indexer"], jcfg, jnp.asarray(x), jnp.asarray(pos),
            jst, jnp.asarray(ikeys), jnp.asarray(lens), overlap=mode,
            slot_mask=None if sm is None else jnp.asarray(sm))
        to, tst, ts = OV.ess_sparse_attention(
            tp["mla"], tp["indexer"], tcfg, torch.tensor(x),
            torch.tensor(pos), tst, torch.tensor(ikeys), torch.tensor(lens),
            overlap=mode, slot_mask=None if sm is None else torch.tensor(sm))
        close(to, jo)
        for a, b in zip(ts, js):
            eq(a, b)
        assert_pool_equal(tst.pool, jst.pool)
    assert int(np.asarray(js.hits).sum()) > 0


def test_ess_sparse_attention_q2_draft_verify_matches_reference(attn_setup):
    """Q=2 (draft verification): per-query causal lens, the flattened
    top-k with duplicate requests (dedup lookup) and the per-query fetch
    mask."""
    jcfg, tcfg, jp, tp, lat, ikeys, x, B, S, ctx = attn_setup
    x2 = np.concatenate([x, x[:, :, ::-1].copy()], axis=1)       # [B,2,d]
    lens = np.array([[ctx - 1, ctx], [20, 21], [9, 10]])
    pos = lens - 1
    P = 16
    jst = JOV.ESSLayerState(JLP.init_pool(B, P, S, lat.shape[-1],
                                          jnp.float32), jnp.asarray(lat))
    tst = OV.ESSLayerState(LP.init_pool(B, P, S, lat.shape[-1],
                                        torch.float32, "cpu"),
                           torch.tensor(lat))
    jo, jst, js = JOV.ess_sparse_attention(
        jp["mla"], jp["indexer"], jcfg, jnp.asarray(x2), jnp.asarray(pos),
        jst, jnp.asarray(ikeys), jnp.asarray(lens), overlap="da")
    to, tst, ts = OV.ess_sparse_attention(
        tp["mla"], tp["indexer"], tcfg, torch.tensor(x2), torch.tensor(pos),
        tst, torch.tensor(ikeys), torch.tensor(lens), overlap="da")
    close(to, jo)
    for a, b in zip(ts, js):
        eq(a, b)
    assert_pool_equal(tst.pool, jst.pool)
