"""Quest block selection, the Eq. 1 similarity and the paged GQA cache
(``core/quest.py``, ``core/similarity.py``, ``cache/kv_cache.py``)
against the reference on the CPU, on numpy-seeded inputs.

Block meta, scores and top-k ids are held exactly (ties included: the
stable descending sort against ``lax.top_k``); the sparse attention and
the recall at 1e-5; the pool round trip through ``core/lru_pool`` as the
reference's; the paged append, gather and release exactly.

Reference tests this file counts as covered:

* ``test_quest::test_quest_upper_bound_is_sound``
* ``test_quest::test_quest_selection_captures_softmax_mass``
* ``test_quest::test_quest_attention_exact_over_selection``
* ``test_quest::test_quest_blocks_pool_roundtrip``
* ``test_quest::test_incremental_meta_update_matches_rebuild``
* ``test_ess::test_intra_layer_similarity_eq1``
* ``test_serving::test_paged_kv_append_and_gather``
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import kv_cache as JKV
from repro.core import lru_pool as JLP
from repro.core import quest as JQ
from repro.core import similarity as JS
from repro_torch.cache import kv_cache as KV
from repro_torch.core import lru_pool as LP
from repro_torch.core import quest as Q
from repro_torch.core import similarity as SIM


def _mk(B=2, S=64, KV_=2, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((B, S, KV_, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV_, D)).astype(np.float32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    return q, k, v


def t(a):
    return torch.tensor(np.ascontiguousarray(a))


def j(a):
    return jnp.asarray(a)


def eq(tt, ja):
    np.testing.assert_array_equal(tt.numpy(), np.asarray(ja))


@pytest.mark.parametrize("block", [4, 8])
def test_block_meta_and_scores_exact(block):
    """build_block_meta, quest_scores (some blocks invalid) and the
    Quest invariant: the bound is at least every true score in a block."""
    q, k, _ = _mk()
    meta = Q.build_block_meta(t(k), block)
    jmeta = JQ.build_block_meta(j(k), block)
    eq(meta.kmin, jmeta.kmin)
    eq(meta.kmax, jmeta.kmax)
    nb = k.shape[1] // block
    valid = np.arange(nb)[None] < np.array([nb, nb - 3])[:, None]
    sc = Q.quest_scores(t(q), meta, t(valid))
    np.testing.assert_allclose(sc.numpy(), np.asarray(
        JQ.quest_scores(j(q), jmeta, j(valid))), rtol=1e-6, atol=1e-6)
    groups = q.shape[1] // k.shape[2]
    true = np.einsum("bhd,bshd->bhs", q, np.repeat(k, groups, axis=2))
    tb = true.reshape(2, q.shape[1], nb, block).max(axis=(1, 3))
    ok = sc.numpy() >= tb - 1e-4
    assert ok[valid].all()
    assert (sc.numpy()[~valid] == -2e38).all()


@pytest.mark.parametrize("topb", [3, 8, 16])
def test_topk_blocks_exact_with_ties(topb):
    """Ragged lengths (an empty sequence among them), keys with repeated
    blocks (tied scores) and invalid blocks tied at -2e38: the ids and
    their validity equal ``lax.top_k``'s, the newest block pinned."""
    q, k, _ = _mk(B=3, S=64, seed=3)
    k[:, 16:24] = k[:, 0:8]                      # blocks 2 == 0: a tie
    k[:, 40:48] = k[:, 0:8]
    block = 8
    lens = np.array([64, 30, 0])
    meta = Q.build_block_meta(t(k), block)
    jmeta = JQ.build_block_meta(j(k), block)
    ids, bv = Q.quest_topk_blocks(t(q), meta, t(lens), block, topb)
    jids, jbv = JQ.quest_topk_blocks(j(q), jmeta, j(lens), block, topb)
    eq(ids, jids)
    eq(bv, jbv)
    assert int(ids[1, 0]) == (30 - 1) // 8       # the newest block first


def test_quest_selection_captures_softmax_mass():
    """Half the blocks selected: the recall at 1e-5 of the reference's,
    above the reference's floors, and above random blocks' on average."""
    q, k, _ = _mk(S=128, seed=3)
    block, topb = 8, 8
    lens = np.array([128, 96])
    meta = Q.build_block_meta(t(k), block)
    ids, bv = Q.quest_topk_blocks(t(q), meta, t(lens), block, topb)
    rec = Q.attention_recall(t(q), t(k), t(lens), ids, bv, block, 0.25)
    jmeta = JQ.build_block_meta(j(k), block)
    jids, jbv = JQ.quest_topk_blocks(j(q), jmeta, j(lens), block, topb)
    jrec = JQ.attention_recall(j(q), j(k), j(lens), jids, jbv, block, 0.25)
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), rtol=1e-5,
                               atol=1e-5)
    assert float(rec.min()) > 0.35 and float(rec.mean()) > 0.5
    rids = np.random.default_rng(9).integers(0, 128 // block, ids.shape)
    rrec = Q.attention_recall(t(q), t(k), t(lens), t(rids), bv, block, 0.25)
    np.testing.assert_allclose(rrec.numpy(), np.asarray(JQ.attention_recall(
        j(q), j(k), j(lens), j(rids), jbv, block, 0.25)), rtol=1e-5,
        atol=1e-5)
    assert float(rec.mean()) > float(rrec.mean())


@pytest.mark.parametrize("topb", [2, 4])
def test_quest_attention_matches_reference(topb):
    """gqa_sparse_attention at 1e-5 of the reference's; with every block
    selected, equal to full attention over the valid positions."""
    q, k, v = _mk(S=32)
    block = 8
    lens = np.array([32, 24])
    meta = Q.build_block_meta(t(k), block)
    ids, bv = Q.quest_topk_blocks(t(q), meta, t(lens), block, topb)
    out = Q.gqa_sparse_attention(t(q), t(k), t(v), ids, bv, t(lens), block,
                                 0.25)
    jmeta = JQ.build_block_meta(j(k), block)
    jids, jbv = JQ.quest_topk_blocks(j(q), jmeta, j(lens), block, topb)
    jout = JQ.gqa_sparse_attention(j(q), j(k), j(v), jids, jbv, j(lens),
                                   block, 0.25)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-5)
    if topb == 4:                                # all 4 blocks
        g = q.shape[1] // k.shape[2]
        kk, vv = np.repeat(k, g, axis=2), np.repeat(v, g, axis=2)
        s = np.einsum("bhd,bshd->bhs", q, kk) * 0.25
        s = np.where((np.arange(32)[None] < lens[:, None])[:, None], s,
                     -2e38)
        w = np.exp(s - s.max(-1, keepdims=True))
        ref = np.einsum("bhs,bshd->bhd", w / w.sum(-1, keepdims=True), vv)
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4)


def test_quest_blocks_pool_roundtrip():
    """The selected blocks through the LRU pool (a block is a page):
    misses on the first lookup, none on the second, as the reference's."""
    B, S, KV_, D, block = 1, 64, 2, 16, 8
    q, k, _ = _mk(B=B, S=S, KV_=KV_, D=D)
    lens = np.array([64])
    ids, bv = Q.quest_topk_blocks(t(q), Q.build_block_meta(t(k), block),
                                  t(lens), block, 4)
    dim = block * KV_ * D * 2
    pool = LP.init_pool(B, 6, S // block, dim, torch.float32, "cpu")
    pool, lk, st1 = LP.lookup(pool, ids, bv, max_misses=4, slot_mask=None)
    pool = LP.admit(pool, lk.miss_ids, torch.zeros((B, 4, dim)),
                    slot_mask=None)
    pool = LP.tick(pool)
    pool, lk2, st2 = LP.lookup(pool, ids, bv, max_misses=4, slot_mask=None)
    assert int(st1.misses[0]) > 0 and int(st2.misses[0]) == 0
    jids, jbv = JQ.quest_topk_blocks(j(q), JQ.build_block_meta(j(k), block),
                                     j(lens), block, 4)
    jpool = JLP.init_pool(B, 6, S // block, dim)
    jpool, jlk, js1 = JLP.lookup(jpool, jids, jbv, max_misses=4,
                                 slot_mask=None)
    eq(lk.miss_ids, jlk.miss_ids)
    eq(st1.misses, js1.misses)
    eq(st1.hits, js1.hits)


def test_incremental_meta_update_matches_rebuild():
    """The update widens the meta in place to the min / max of the old
    meta and a rebuild with the new keys (two tokens inside existing
    blocks), exactly, as the reference's update."""
    q, k, _ = _mk(S=32)
    block = 8
    k_new = np.random.default_rng(7).standard_normal((2, 2, 16)).astype(
        np.float32)
    pos = np.array([32 - 8, 16])
    meta = Q.build_block_meta(t(k), block)
    old = Q.BlockMeta(meta.kmin.clone(), meta.kmax.clone())
    upd = Q.update_block_meta(meta, t(k_new), t(pos), block)
    assert upd.kmin is meta.kmin                   # in place
    k2 = k.copy()
    k2[np.arange(2), pos] = k_new
    reb = Q.build_block_meta(t(k2), block)
    eq(upd.kmin, torch.minimum(old.kmin, reb.kmin))
    eq(upd.kmax, torch.maximum(old.kmax, reb.kmax))
    jupd = JQ.update_block_meta(JQ.build_block_meta(j(k), block), j(k_new),
                                j(pos), block)
    eq(upd.kmin, jupd.kmin)
    eq(upd.kmax, jupd.kmax)


def test_intra_layer_similarity_eq1():
    a, b, c = t([[1, 2, 3, 4]]), t([[3, 4, 5, 6]]), t([[7, 8, 9, 10]])
    r = SIM.intra_layer_similarity(a, b)
    assert r.dtype == torch.float32
    np.testing.assert_allclose(r.numpy(), [0.5])
    np.testing.assert_allclose(SIM.intra_layer_similarity(a, a).numpy(),
                               [1.0])
    np.testing.assert_allclose(SIM.intra_layer_similarity(a, c).numpy(),
                               [0.0])
    tr = SIM.similarity_trace(torch.stack([a, b, c]))
    assert tr.shape == (2, 1)
    np.testing.assert_allclose(tr.numpy(), [[0.5], [0.0]])


def test_intra_layer_similarity_matches_reference_with_masks():
    """Random top-k-like rows (unique ids) over [layers, batch], with
    validity masks on either side, and a trace over 5 steps."""
    rng = np.random.default_rng(5)
    ids = np.stack([[[rng.permutation(40)[:12] for _ in range(3)]
                     for _ in range(2)] for _ in range(5)])     # [5,2,3,12]
    pv = rng.random((2, 3, 12)) < 0.8
    cv = rng.random((2, 3, 12)) < 0.7
    cv[0, 0] = False                               # an all-invalid row
    got = SIM.intra_layer_similarity(t(ids[0]), t(ids[1]), t(pv), t(cv))
    want = JS.intra_layer_similarity(j(ids[0]), j(ids[1]), j(pv), j(cv))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    np.testing.assert_allclose(SIM.similarity_trace(t(ids)).numpy(),
                               np.asarray(JS.similarity_trace(j(ids))),
                               rtol=1e-6)


def test_paged_kv_append_and_gather():
    """Six appends over 4-row pages (the reference's case): the pages,
    table, lengths and allocator equal the reference's bit for bit; the
    gather and its mask; release clears one slot only."""
    kv = KV.init_paged(npages=16, page=4, kv_heads=2, head_dim=8, batch=2,
                       max_blocks=4, dtype=torch.float32, device="cpu")
    jkv = JKV.init_paged(npages=16, page=4, kv_heads=2, head_dim=8,
                         batch=2, max_blocks=4, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    ks = []
    for _ in range(6):
        k = rng.standard_normal((2, 2, 8)).astype(np.float32)
        assert KV.append_token(kv, t(k), t(k + 1)) is kv
        jkv = JKV.append_token(jkv, j(k), j(k + 1))
        ks.append(k)
    for a, b in zip(kv, jkv):
        eq(a, b)
    kk, vv, valid = KV.gather_kv(kv, max_seq=8)
    jk, jv, jvalid = JKV.gather_kv(jkv, max_seq=8)
    assert kk.shape == (2, 8, 2, 8)
    eq(kk, jk)
    eq(vv, jv)
    eq(valid, jvalid)
    assert valid[:, :6].all() and not valid[:, 6:].any()
    for i in range(6):
        np.testing.assert_array_equal(kk[:, i].numpy(), ks[i])
    KV.release_sequence(kv, 0)
    jkv = JKV.release_sequence(jkv, 0)
    assert kv.lens.tolist() == [0, 6]
    for a, b in zip(kv, jkv):
        eq(a, b)
