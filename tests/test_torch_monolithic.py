"""The port's monolithic DeepSeek-V3.2 model (``models/{mla,blocks,
transformer}``, the generic serve path) against the reference on the CPU,
at smoke scale; the card's routes run here through the kernel wrappers'
plain versions.

The same numpy-seeded inputs and the reference's own parameters
(``from_jax_params``) go through both packages.  The reference runs its
plain path (``use_kernel=False``), jitted once per mode with XLA's
``xla_allow_excess_precision`` off: by default XLA keeps some bf16
intermediates in fp32 inside its fusions (its default jit and its
op-by-op run then differ by 0.086 in the bf16 logits on these inputs),
while every torch op rounds to bf16.  Tolerances:
logits and caches 1e-4 (fp32) and 2e-2 (bf16); the card's prefill route
(indexer, top-k by ids, gather-attend) within the reference's own
cross-route bound, 5e-2 max and 2e-3 mean (``test_ess.py``); the ESS
engine against the monolithic model as the reference holds it.

Reference tests this file counts as covered:

* ``test_ess::test_engine_prefill_decode_matches_monolithic``
* ``test_ess::test_overlap_modes_exact_vs_monolithic`` (its monolithic
  side, :func:`sparse_mla_decode`, on its ``setup`` shapes; the ESS side
  is ``test_torch_ess.py``'s)
* ``test_system::test_ess_greedy_continuation_matches_monolithic``
* ``test_models::test_train_forward_shapes_no_nan[deepseek-v32-exp-ess-smoke]``
* ``test_kernels::test_fused_gather_attend_matches_dense``
* ``test_kernels::test_indexer_topk_selects_valid_only``
"""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import mla as JM
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.kernels.indexer import ops as iops
from repro_torch.kernels.sparse_mla import ops as sops
from repro_torch.models import mla as M
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as T
from repro_torch.models.params import from_jax_params
from repro_torch.serving import engine as E

ARCH = "deepseek-v32-exp-ess-smoke"
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
B, S, SMAX, ROUNDS = 2, 24, 40, 4


def f32(t):
    return t.detach().float().numpy()


def close(t, j, dt):
    np.testing.assert_allclose(f32(t), np.asarray(j, np.float32), **TOL[dt])


def configs(dt):
    jdt, tdt = DT[dt]
    return (dataclasses.replace(jget(ARCH), param_dtype=jdt),
            dataclasses.replace(tget(ARCH), param_dtype=tdt))


def ref_compiled(fn, *args):
    """``fn`` jitted for ``args``, every op rounded to its dtype."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})


@functools.lru_cache(maxsize=None)
def ref_params(dt):
    """The reference's parameters at ``dt`` (jitted init, once) and the
    same tree in the port."""
    jcfg = configs(dt)[0]
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module", params=["f32", "bf16"])
def model(request):
    """Both packages' parameters and the reference's three modes, each
    jitted once: train and prefill on S tokens, then ROUNDS teacher-forced
    decode steps from the padded prefill caches."""
    dt = request.param
    jcfg, tcfg = configs(dt)
    jp, tp = ref_params(dt)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (B, S + ROUNDS))
    pos = np.broadcast_to(np.arange(S + ROUNDS)[None], (B, S + ROUNDS))
    def mode_fn(mode):
        return lambda p, t, q, c: JT.forward(p, jcfg, t, q, mode=mode,
                                             caches=c)
    jt, jpos = jnp.asarray(toks[:, :S]), jnp.asarray(pos[:, :S])
    train = ref_compiled(mode_fn("train"), jp, jt, jpos, None)(
        jp, jt, jpos, None)
    pf = ref_compiled(mode_fn("prefill"), jp, jt, jpos, None)(
        jp, jt, jpos, None)
    cm = dict(pf.caches)
    cm["mla"] = jax.tree.map(
        lambda a: jnp.pad(a, ((0, 0), (0, 0), (0, SMAX - S), (0, 0))),
        cm["mla"])
    dec, step = [], None
    for r in range(ROUNDS):
        args = (jp, jnp.asarray(toks[:, S + r:S + r + 1]),
                cm["lens"][:, None], cm)
        step = step or ref_compiled(mode_fn("decode"), *args)
        o = step(*args)
        cm = o.caches
        dec.append(np.asarray(o.logits))
    return dict(dt=dt, jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp, toks=toks,
                pos=pos, train=train, prefill=pf, decode=dec, dcaches=cm)


def tt(a):
    return torch.tensor(np.ascontiguousarray(a)).long()


# ---------------------------------------------------------------------------
# forward, each mode against the reference's
# ---------------------------------------------------------------------------

def test_forward_train_matches_reference(model):
    out = T.forward(model["tp"], model["tcfg"], tt(model["toks"][:, :S]),
                    tt(model["pos"][:, :S]), mode="train")
    ref = model["train"]
    assert out.caches is None and out.logits.shape == (B, S, 256)
    assert bool(torch.isfinite(out.logits).all())
    close(out.logits, ref.logits, model["dt"])
    # the MoE aux of the train mode: the MoE layers' means
    for k in ("moe_lb", "moe_dropped"):
        np.testing.assert_allclose(float(out.aux[k]), float(ref.aux[k]),
                                   rtol=1e-4, atol=1e-6)


def test_forward_prefill_matches_reference(model):
    out = T.forward(model["tp"], model["tcfg"], tt(model["toks"][:, :S]),
                    tt(model["pos"][:, :S]), mode="prefill", use_kernel=False)
    ref = model["prefill"]
    close(out.logits, ref.logits, model["dt"])
    close(out.caches["mla"].latent, ref.caches["mla"].latent, model["dt"])
    close(out.caches["mla"].ikeys, ref.caches["mla"].ikeys, model["dt"])
    assert out.caches["lens"].tolist() == [S] * B


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel-route"])
def test_forward_decode_teacher_forced_matches_reference(model, use_kernel):
    """Prefill, then ROUNDS decode steps fed the same tokens: each step's
    logits, and the caches after the last, in place (``lens`` too)."""
    tcfg, tp, toks = model["tcfg"], model["tp"], model["toks"]
    pf = T.forward(tp, tcfg, tt(toks[:, :S]), tt(model["pos"][:, :S]),
                   mode="prefill", use_kernel=use_kernel)
    caches = T.pad_caches(pf.caches, SMAX)
    lat = caches["mla"].latent
    for r in range(ROUNDS):
        o = E.generic_decode(tp, tcfg, tt(toks[:, S + r:S + r + 1]),
                             caches["lens"][:, None], caches, device="cpu",
                             use_kernel=use_kernel)
        assert o.caches is caches and caches["mla"].latent is lat
        close(o.logits, model["decode"][r], model["dt"])
    ref = model["dcaches"]
    close(caches["mla"].latent, ref["mla"].latent, model["dt"])
    close(caches["mla"].ikeys, ref["mla"].ikeys, model["dt"])
    assert caches["lens"].tolist() == [S + ROUNDS] * B


# ---------------------------------------------------------------------------
# The card's prefill route (by ids) against the reference's chunked flash
# ---------------------------------------------------------------------------

def _layer_inputs(seed, S_, jcfg):
    """The fp32 model's first layer's MLA and indexer, and x [B,S_,d]."""
    lp = jax.tree.map(lambda a: a[0], ref_params("f32")[0]["dense_layers"])
    mla_p, idx_p = lp["mla"], lp["indexer"]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S_, jcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(S_)[None], (B, S_)).copy()
    return mla_p, idx_p, x, pos


@pytest.mark.parametrize("route,chunk", [("ids", 7), ("ids", 256),
                                         ("dense", None)])
def test_prefill_attend_routes_match_reference(route, chunk, monkeypatch):
    """One layer's ``mla_prefill_attend`` (S = 40, top-8): the port's plain
    version (dense) against the reference's at kv_block 16 (ragged: a
    padded last block), the kernel route (by ids) in ragged query chunks
    of 7 and in one chunk."""
    jcfg, tcfg = configs("f32")
    mla_p, idx_p, x, pos = _layer_inputs(11, 40, jcfg)
    ref, jlat, jik = jax.jit(JM.mla_prefill_attend, static_argnums=(2, 5))(
        mla_p, idx_p, jcfg, jnp.asarray(x), jnp.asarray(pos), 16)
    tm = from_jax_params(jax.tree.map(np.asarray, mla_p))
    ti = from_jax_params(jax.tree.map(np.asarray, idx_p))
    kw = dict(kv_block=16) if route == "dense" else {}
    if chunk is not None:
        monkeypatch.setattr(M, "PREFILL_QUERY_CHUNK", chunk)
    out, lat, ik = M.mla_prefill_attend(tm, ti, tcfg, torch.tensor(x),
                                        torch.tensor(pos),
                                        use_kernel=route == "ids", **kw)
    np.testing.assert_allclose(f32(out), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(f32(lat), np.asarray(jlat), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(f32(ik), np.asarray(jik), rtol=1e-5,
                               atol=1e-6)


def test_prefill_ids_route_topk_sets_and_logits(model):
    """The ids route's top-k sets (the indexer kernel's plain version, then
    the stable top-k) equal the reference's ``dsa_keep_mask`` wherever its
    k-th and (k+1)-th scores differ by more than 1e-6 relative (the other
    rows are counted and printed), and the whole prefill's logits stay
    within the reference's cross-route bound."""
    jcfg, tcfg, dt = model["jcfg"], model["tcfg"], model["dt"]
    lp = jax.tree.map(lambda a: a[0], model["jp"]["dense_layers"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S)[None], (B, S))
    jx = jnp.asarray(x).astype(jcfg.param_dtype)
    iq = JM.indexer_query(lp["indexer"], jx)
    sc = JM.indexer_scores(iq, JM.indexer_keys(lp["indexer"], jx))
    causal = jnp.asarray(pos[:, None, :] <= pos[:, :, None])
    k = jcfg.dsa.index_topk
    keep = np.asarray(JM.dsa_keep_mask(sc, k, causal))
    # the port's selection on the same layer's inputs
    ti = from_jax_params(jax.tree.map(np.asarray, lp["indexer"]))
    tx = torch.tensor(x).to(tcfg.param_dtype)
    tq = M.indexer_query(ti, tx)
    _, ids = iops.topk_select(tq.q, tq.w, M.indexer_keys(ti, tx),
                              torch.tensor(np.asarray(causal)), k)
    mine = torch.zeros((B, S, S), dtype=torch.bool).scatter_(
        -1, ids, True).numpy() & np.asarray(causal)
    sv = np.sort(np.where(np.asarray(causal), np.asarray(sc), -np.inf),
                 -1)[..., ::-1]
    kth, nxt = sv[..., k - 1], sv[..., k]
    with np.errstate(invalid="ignore"):         # rows with <= k valid keys
        decided = ~np.isfinite(nxt) | (
            np.abs(kth - nxt) > 1e-6 * np.maximum(np.abs(kth), 1e-30))
    assert (mine == keep)[decided].all()
    print(f"near-tie rows (gap <= 1e-6 relative): {int((~decided).sum())} "
          f"of {decided.size}; sets differ in "
          f"{int((mine != keep).any(-1).sum())}")
    # the whole prefill through the card's route against the reference
    out = T.forward(model["tp"], tcfg, tt(model["toks"][:, :S]),
                    tt(model["pos"][:, :S]), mode="prefill", use_kernel=True)
    diff = np.abs(f32(out.logits) - np.asarray(model["prefill"].logits))
    assert diff.max() < 5e-2 and diff.mean() < 2e-3, (diff.max(),
                                                      diff.mean())


# ---------------------------------------------------------------------------
# sparse_mla_decode, sparse_mla_gather_attend, topk_select
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel-route"])
def test_sparse_mla_decode_matches_reference(use_kernel):
    """``test_ess.py``'s ``setup`` shapes: B, S, ctx = 3, 64, 40 with the
    smoke config's MLA and indexer (fp32), one query at ctx - 1."""
    jcfg, tcfg = configs("f32")
    mla_p, idx_p = _layer_inputs(5, 1, jcfg)[:2]
    rng = np.random.default_rng(5)
    Bq, Sq, ctx = 3, 64, 40
    lat = (rng.standard_normal((Bq, Sq, jcfg.mla.latent_dim)) * 0.5
           ).astype(np.float32)
    ikeys = rng.standard_normal((Bq, Sq, jcfg.dsa.index_dim)
                                ).astype(np.float32)
    x = (rng.standard_normal((Bq, 1, jcfg.d_model)) * 0.3).astype(np.float32)
    pos = np.full((Bq, 1), ctx - 1)
    lens = np.array([ctx, ctx - 7, ctx + 9])
    ref, rids = jax.jit(JM.sparse_mla_decode, static_argnums=(2,))(
        mla_p, idx_p, jcfg, jnp.asarray(x), jnp.asarray(pos),
        jnp.asarray(lat), jnp.asarray(ikeys), jnp.asarray(lens))
    out, ids = M.sparse_mla_decode(
        from_jax_params(jax.tree.map(np.asarray, mla_p)),
        from_jax_params(jax.tree.map(np.asarray, idx_p)), tcfg,
        torch.tensor(x), torch.tensor(pos), torch.tensor(lat),
        torch.tensor(ikeys), torch.tensor(lens), use_kernel=use_kernel)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(rids))
    np.testing.assert_allclose(f32(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("Q,per_query", [(1, False), (2, True)])
def test_fused_gather_attend_matches_dense(Q, per_query):
    """``test_kernels.py``'s shapes (B, H, D, K, S, R = 2, 8, 96, 16, 64,
    64; Q = 1, valid by slot), and Q = 2 with a per-query mask."""
    Bq, H, D, K, Sq, R = 2, 8, 96, 16, 64, 64
    rng = np.random.default_rng(9)
    q = rng.standard_normal((Bq, Q, H, D)).astype(np.float32)
    lat = rng.standard_normal((Bq, Sq, D)).astype(np.float32)
    ids = rng.integers(0, 48, (Bq, Q, K))
    valid = np.arange(Sq)[None] < np.array([48, 40])[:, None]
    vq = np.broadcast_to(valid[:, None], (Bq, Q, Sq)).copy()
    if per_query:
        vq[:, 1, 30:] = False
    out = sops.sparse_mla_gather_attend(
        torch.tensor(q), torch.tensor(lat), torch.tensor(ids),
        torch.tensor(vq if per_query else valid), 0.1, R)
    gl = lat[np.arange(Bq)[:, None, None], ids]                 # [B,Q,K,D]
    gv = np.take_along_axis(vq, ids, axis=2)
    s = np.einsum("bqhd,bqkd->bqhk", q, gl) * 0.1
    s = np.where(gv[:, :, None], s, -2e38)
    w = np.exp(s - s.max(-1, keepdims=True))
    w = np.where(gv[:, :, None], w, 0.0)
    ref = np.einsum("bqhk,bqkv->bqhv", w / w.sum(-1, keepdims=True),
                    gl[..., :R])
    np.testing.assert_allclose(f32(out), ref, rtol=1e-4, atol=1e-4)


def test_gather_route_reads_device_memory_directly():
    """The row gather's rule: ids outnumbering a host tier's rows stage;
    a device-resident source (the monolithic cache) always reads
    directly; a named route overrides the rule."""
    from repro_torch.kernels.gather_cache import ops as gops
    assert gops.staged_route(2 * 4 * 8224, 4 * 8224)
    assert not gops.staged_route(256 * 4 * 2048, 4 * 8224, host=False)
    cache = torch.randn((12, 8))
    ids = torch.tensor([[3, -1, 11, 3, 40] * 6])
    fetched = torch.zeros(1, dtype=torch.int32)
    for route, n in ((None, 2), ("direct", 24), ("staged", 2)):
        fetched.zero_()
        rows = gops.gather_rows(cache, ids, fetched=fetched, route=route)
        assert int(fetched) == n          # distinct rows once if staged
        assert torch.equal(rows[0, 1], torch.zeros(8))
        assert torch.equal(rows[0, 4], cache[11])     # clipped to the end
    with pytest.raises(ValueError, match="route"):
        gops.gather_rows(cache, ids, route="fast")


def test_indexer_topk_selects_valid_only():
    """``test_kernels.py``'s case: only valid ids, and the values are the
    scores at the ids, descending."""
    rng = np.random.default_rng(2)
    q = torch.tensor(rng.standard_normal((1, 1, 4, 16)), dtype=torch.float32)
    w = torch.tensor(np.abs(rng.standard_normal((1, 1, 4))),
                     dtype=torch.float32)
    keys = torch.tensor(rng.standard_normal((1, 50, 16)),
                        dtype=torch.float32)
    valid = torch.arange(50)[None, :] < 30
    vals, ids = iops.topk_select(q, w, keys, valid, k=8)
    assert int(ids.max()) < 30
    sc = iops.indexer_scores(q, w, keys, valid)
    assert torch.equal(vals, sc.gather(-1, ids))
    assert bool((vals[..., :-1] >= vals[..., 1:]).all())


def test_topk_select_ties_follow_lax_top_k():
    """Scores full of exact ties (keys that ReLU to 0, repeated keys) and
    invalid keys: ids and values equal ``lax.top_k`` of the reference's
    scores, the lowest index first among equal ones."""
    rng = np.random.default_rng(4)
    Bq, Q, Hi, Di, Sq, k = 2, 3, 4, 16, 60, 24
    q = rng.standard_normal((Bq, Q, Hi, Di)).astype(np.float32)
    w = np.abs(rng.standard_normal((Bq, Q, Hi))).astype(np.float32)
    keys = rng.standard_normal((Bq, Sq, Di)).astype(np.float32)
    keys[:, ::3] = keys[:, 1:2]                     # repeated keys: ties
    keys[:, 5::4] = 0.0                             # zero scores: ties
    valid = np.arange(Sq)[None] < np.array([50, 41])[:, None]
    sc = JM.indexer_scores(JM.IndexerQuery(jnp.asarray(q), jnp.asarray(w)),
                           jnp.asarray(keys))
    sc = jnp.where(jnp.asarray(valid)[:, None], sc, JM.NEG_INF)
    rv, ri = jax.lax.top_k(sc, k)
    vals, ids = iops.topk_select(torch.tensor(q), torch.tensor(w),
                                 torch.tensor(keys), torch.tensor(valid), k)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ri))
    np.testing.assert_allclose(vals.numpy(), np.asarray(rv), rtol=1e-6)


def test_dsa_threshold_and_keep_mask_match_reference():
    """On scores full of exact ties (repeated values, zeros) with a causal
    mask: the k-th score and the exact top-k membership mask equal the
    reference's (``lax.top_k``'s ties: the lowest index wins)."""
    rng = np.random.default_rng(6)
    sc = rng.integers(-2, 3, (2, 30, 30)).astype(np.float32) * 0.5
    sc[:, :, ::4] = 0.0
    valid = np.arange(30)[None, None] <= np.arange(30)[None, :, None]
    valid = np.broadcast_to(valid, sc.shape).copy()
    for k in (5, 8):
        np.testing.assert_array_equal(
            M.dsa_threshold(torch.tensor(sc), k, torch.tensor(valid)).numpy(),
            np.asarray(JM.dsa_threshold(jnp.asarray(sc), k,
                                        jnp.asarray(valid))))
        np.testing.assert_array_equal(
            M.dsa_keep_mask(torch.tensor(sc), k, torch.tensor(valid)).numpy(),
            np.asarray(JM.dsa_keep_mask(jnp.asarray(sc), k,
                                        jnp.asarray(valid))))


def test_partial_sparse_attend_matches_reference():
    """The plain oracle over latents shared by the queries (bf16 rows,
    fp32 partials), with an all-invalid batch row."""
    jcfg, tcfg = configs("bf16")
    rng = np.random.default_rng(12)
    D = jcfg.mla.latent_dim
    q = rng.standard_normal((2, 3, 4, D)).astype(np.float32)
    lat = rng.standard_normal((2, 20, D)).astype(np.float32)
    valid = rng.random((2, 20)) < 0.7
    valid[1] = False
    jq, jl = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, lat))
    ref = JM.partial_sparse_attend(jq, jl, jnp.asarray(valid), jcfg)
    got = M.partial_sparse_attend(
        torch.tensor(q).bfloat16(), torch.tensor(lat).bfloat16(),
        torch.tensor(valid), tcfg)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(f32(a), np.asarray(b, np.float32),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The MoE aux
# ---------------------------------------------------------------------------

def test_moe_aux_matches_reference():
    """``moe_apply(train=True)``: the output and the load-balance loss,
    router entropy and dropped fraction (capacity binding: drops > 0)."""
    jcfg, tcfg = configs("f32")
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    p = ref_params("f32")[0]["layers"]["ffn"]
    p = jax.tree.map(lambda a: a[0], p)
    x = np.random.default_rng(8).standard_normal(
        (2, 10, jcfg.d_model)).astype(np.float32)
    jy, ja = jax.jit(JMoE.moe_apply, static_argnums=(1,),
                     static_argnames=("train",))(p, jcfg, jnp.asarray(x),
                                                 train=True)
    tp = from_jax_params(jax.tree.map(np.asarray, p))
    y, a = MoE.moe_apply(tp, tcfg, torch.tensor(x), train=True)
    np.testing.assert_allclose(f32(y), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for mine, ref in zip(a, ja):
        np.testing.assert_allclose(float(mine), float(ref), rtol=1e-5,
                                   atol=1e-6)
    assert float(a.dropped_fraction) > 0
    assert torch.equal(MoE.moe_apply(tp, tcfg, torch.tensor(x)), y)


# ---------------------------------------------------------------------------
# The port's ESS engine against the port's monolithic model
# ---------------------------------------------------------------------------

def _ess_cfg(tcfg):
    return dataclasses.replace(tcfg, ess=dataclasses.replace(
        tcfg.ess, max_miss_ratio=1.0, warmup_windows=0))


def test_engine_prefill_decode_matches_monolithic():
    """The reference's case (B, S, Smax = 2, 24, 40; exact envelope, cold
    pool): one decode's logits within 5e-2 max and 5e-3 mean."""
    tcfg = configs("bf16")[1]
    tp = ref_params("bf16")[1]
    rng = np.random.default_rng(1)
    toks = tt(rng.integers(0, tcfg.vocab_size, (2, 25)))
    pos = torch.arange(25)[None].expand(2, 25)
    pf = E.generic_prefill(tp, tcfg, toks[:, :24], pos[:, :24], device="cpu")
    dm = E.generic_decode(tp, tcfg, toks[:, 24:], pos[:, 24:],
                          T.pad_caches(pf.caches, 40), device="cpu")
    cfg_x = _ess_cfg(tcfg)
    _, ce = E.ess_prefill(tp, cfg_x, toks[:, :24], pos[:, :24], 40)
    oe = E.ess_decode(tp, cfg_x, toks[:, 24:], pos[:, 24:], ce)
    diff = np.abs(f32(oe.logits[:, -1]) - f32(dm.logits[:, -1]))
    assert diff.max() < 5e-2 and diff.mean() < 5e-3


def test_ess_greedy_continuation_matches_monolithic():
    """B, S, Smax, NEW = 2, 20, 48, 5 at ``max_miss_ratio = 1.0``: equal
    greedy streams, and the last step misses no more than the first."""
    tcfg = configs("bf16")[1]
    tp = ref_params("bf16")[1]
    Bs, Ss, Smax, NEW = 2, 20, 48, 5
    toks = tt(np.random.default_rng(1).integers(0, tcfg.vocab_size,
                                                (Bs, Ss)))
    pos = torch.arange(Ss)[None].expand(Bs, Ss)
    pf = E.generic_prefill(tp, tcfg, toks, pos, device="cpu")
    cm = T.pad_caches(pf.caches, Smax)
    tok_m = pf.logits[:, -1].argmax(-1)
    mono = [tok_m]
    for _ in range(NEW - 1):
        o = E.generic_decode(tp, tcfg, tok_m[:, None], cm["lens"][:, None],
                             cm, device="cpu")
        tok_m = o.logits[:, -1].argmax(-1)
        mono.append(tok_m)
    cfg_x = _ess_cfg(tcfg)
    lg, caches = E.ess_prefill(tp, cfg_x, toks, pos, Smax)
    tok = lg[:, -1].argmax(-1)
    ess, miss = [tok], []
    for _ in range(NEW - 1):
        o = E.ess_decode(tp, cfg_x, tok[:, None], caches.lens[:, None],
                         caches)
        caches = o.caches
        tok = o.logits[:, -1].argmax(-1)
        ess.append(tok)
        miss.append(int(o.stats["misses"].sum()))
    assert torch.equal(torch.stack(mono), torch.stack(ess))
    assert miss[-1] <= miss[0]


def test_quickstart_mirror_runs_on_cpu():
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "quickstart_torch.py"
    spec = importlib.util.spec_from_file_location("quickstart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu"])
