"""The port's model math against ``repro.models`` on the CPU.

Parameters come from the reference's ``init_params`` and cross through
``from_jax_params``; activations come from seeded numpy.  Model math runs
in fp32 (the reference config with ``param_dtype=float32``) and is held at
rtol/atol 1e-5 unless a test says otherwise; index outputs are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import layers as JL
from repro.models import mla as JM
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.models import layers as L
from repro_torch.models import mla as M
from repro_torch.models import moe as MoE
from repro_torch.models import params as P

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def f32():
    jcfg = dataclasses.replace(jget("deepseek-v32-exp-ess-smoke"),
                               param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget("deepseek-v32-exp-ess-smoke"),
                               param_dtype=torch.float32)
    jp = jax.tree.map(jnp.asarray, numpy_params(jcfg, 0))
    tp = P.from_jax_params(jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def numpy_params(cfg, seed):
    """The reference's parameter tree (shapes, dtypes, keys from its
    ``init_params``) filled from seeded numpy: cheaper than running the
    JAX initializers, which compile every leaf's ops."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jinit(jax.random.key(0),
                                          JT.model_def(cfg)))
    return jax.tree.map(
        lambda a: (rng.standard_normal(a.shape, dtype=np.float32)
                   * 0.2).astype(a.dtype), shapes)


def layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


def tlayer(tree, i):
    return {k: tlayer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def x_in(shape, seed=0, scale=0.5):
    a = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return a * scale


def close(t, j, **kw):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **(kw or TOL))


def test_from_jax_params_bf16_bit_for_bit():
    cfg = jget("deepseek-v32-exp-ess-smoke")
    jp = numpy_params(cfg, 1)
    tp = P.from_jax_params(jax.tree.map(np.asarray, jp))
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == sum(1 for _ in _leaves(tp))
    for path, a in jl:
        keys = [k.key for k in path]
        t = tp
        for k in keys:
            t = t[k]
        assert tuple(t.shape) == a.shape, keys
        if a.dtype == jnp.bfloat16:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy(),
                np.asarray(a).view(np.int16))
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
    assert "mtp" in tp                      # unused leaves convert too


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_fp8_leaf_crosses_bit_for_bit():
    a = np.asarray(jnp.linspace(-3, 3, 17).astype(jnp.float8_e4m3fn))
    t = P.array_to_torch(a)
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.view(torch.uint8).numpy(),
                                  a.view(np.uint8))


def test_torch_init_matches_reference_tree_and_families():
    jcfg = jget("deepseek-v32-exp-ess-smoke")
    tcfg = tget("deepseek-v32-exp-ess-smoke")
    defs = jax.eval_shape(lambda: jinit(jax.random.key(0),
                                        JT.model_def(jcfg)))
    tp = P.init_params(tcfg, 0, device="cpu")
    want = {tuple(k.key for k in path): (a.shape, str(a.dtype))
            for path, a in jax.tree_util.tree_leaves_with_path(defs)}

    def walk(t, pre=()):
        for k, v in t.items():
            if isinstance(v, dict):
                yield from walk(v, pre + (k,))
            else:
                yield pre + (k,), v
    got = dict(walk(tp))
    assert set(got) == set(want)
    for k, v in got.items():
        shape, dt = want[k]
        assert tuple(v.shape) == shape, k
        assert str(v.dtype).replace("torch.", "") == dt, k
    assert float(tp["final_norm"].abs().max()) == 0.0          # zero-centred
    assert tp["layers"]["ffn"]["router"].dtype == torch.float32
    assert abs(float(tp["embed"].float().std()) - 0.02) < 0.002
    w = tp["dense_layers"]["mla"]["w_dq"].float()
    assert abs(float(w.std()) * np.sqrt(np.prod(w.shape[:-1])) - 1) < 0.05
    iw = tp["layers"]["indexer"]["w_iw"].float()
    assert abs(float(iw.std()) - 0.02) < 0.004


def test_rmsnorm_and_rope(f32):
    x = x_in((2, 5, 64), 1)
    w = x_in((64,), 2)
    close(L.rmsnorm(torch.tensor(w), torch.tensor(x)),
          JL.rmsnorm(jnp.asarray(w), jnp.asarray(x)))
    pos = np.arange(10).reshape(2, 5) * 7
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 8, 10000.0)
    ct, st = L.rope_cos_sin(torch.tensor(pos), 8, 10000.0)
    close(ct, cj)
    close(st, sj)
    y = x_in((2, 5, 3, 8), 3)
    close(L.apply_rope(torch.tensor(y), ct[:, :, None], st[:, :, None]),
          JL.apply_rope(jnp.asarray(y), cj[:, :, None], sj[:, :, None]))


def test_mla_projections(f32):
    jcfg, tcfg, jp, tp = f32
    jm, tm = layer(jp["dense_layers"], 0)["mla"], tlayer(
        tp["dense_layers"], 0)["mla"]
    x = x_in((2, 3, 64), 4)
    pos = np.array([[3, 4, 5], [9, 10, 11]])
    close(M.latent_entries(tm, tcfg, torch.tensor(x), torch.tensor(pos)),
          JM.latent_entries(jm, jcfg, jnp.asarray(x), jnp.asarray(pos)))
    close(M.absorbed_query(tm, tcfg, torch.tensor(x), torch.tensor(pos)),
          JM.absorbed_query(jm, jcfg, jnp.asarray(x), jnp.asarray(pos)))
    o = x_in((2, 3, 4, 32), 5)
    close(M.output_proj(tm, tcfg, torch.tensor(o)),
          JM.output_proj(jm, jcfg, jnp.asarray(o)))


def test_indexer_query_keys_scores(f32):
    jcfg, tcfg, jp, tp = f32
    ji, ti = layer(jp["layers"], 0)["indexer"], tlayer(
        tp["layers"], 0)["indexer"]
    x = x_in((2, 3, 64), 6)
    keys_src = x_in((2, 11, 64), 7)
    jk = JM.indexer_keys(ji, jnp.asarray(keys_src))
    tk = M.indexer_keys(ti, torch.tensor(keys_src))
    close(tk, jk)
    jq = JM.indexer_query(ji, jnp.asarray(x))
    tq = M.indexer_query(ti, torch.tensor(x))
    close(tq.q, jq.q)
    close(tq.w, jq.w)
    close(M.indexer_scores(tq, tk), JM.indexer_scores(jq, jk))


def test_topk_ids_tie_order_matches_lax_top_k():
    # all-zero scores (the ReLU'd indexer's exact 0.0 ties) and repeated
    # values: the lowest index must win among equal scores
    sc = np.zeros((2, 3, 40), np.float32)
    sc[0, 1, [5, 17, 30]] = 1.5
    sc[1, 2, ::3] = -0.25
    valid = np.arange(40)[None, None, :] < np.array([40, 23])[:, None, None]
    want = JM.topk_ids(jnp.asarray(sc), 12, jnp.asarray(valid))
    got = M.topk_ids(torch.tensor(sc), 12, torch.tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [8, 2048])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_topk_desc_keyed_cpu_matches_lax_top_k(k, dt):
    """The CPU top-k (one ``torch.topk`` over index-tiebroken keys) against
    the stable sort, the card's route, run here on the same CPU tensors,
    and both against ``lax.top_k``: ReLU'd indexer scores with many exact
    0.0 ties (rows of negative head weights score -0.0 wherever the ReLU
    is 0, so their top is nearly all ties), the -2e38 sentinel, a row of
    one repeated value, a row where 0.0 and -0.0 tie, and a row block
    boundary.  The two routes agree on every row; ``lax.top_k`` agrees
    with them but on the row where 0.0 and -0.0 meet, which it ranks
    apart and they take as equal."""
    rng = np.random.default_rng(k)
    R, S = 1 + M._TOPK_BLOCK // 4100, 4100
    w = np.where(rng.random((R, 1)) < 0.5, -1.0, 1.0)
    sc = (np.maximum(rng.standard_normal((R, S)), 0.0) * w).astype(np.float32)
    sc[:, ::7] = -2.0e38
    sc[3] = 0.5
    sc[4] = 0.0
    sc[4, ::3] = -0.0
    x = torch.tensor(sc).to({"f32": torch.float32,
                             "bf16": torch.bfloat16}[dt])
    got = M.topk_desc(x, k)
    srt = torch.sort(x, dim=-1, descending=True, stable=True).indices[:, :k]
    np.testing.assert_array_equal(got.numpy(), srt.numpy())
    want = np.asarray(jax.lax.top_k(jnp.asarray(x.float().numpy()), k)[1])
    same = np.arange(R) != 4
    np.testing.assert_array_equal(srt.numpy()[same], want[same])
    # the +-0 row: lax.top_k takes the 0.0s first, the sort in index order
    np.testing.assert_array_equal(srt.numpy()[4], np.arange(k))
    np.testing.assert_array_equal(
        want[4], np.flatnonzero(np.arange(S) % 3)[:k])


def test_mlp_and_moe(f32):
    jcfg, tcfg, jp, tp = f32
    x = x_in((3, 7, 64), 8)
    jd, td = layer(jp["dense_layers"], 0)["ffn"], tlayer(
        tp["dense_layers"], 0)["ffn"]
    close(L.mlp(td, torch.tensor(x)), JL.mlp(jd, jnp.asarray(x)))
    je, te = layer(jp["layers"], 1)["ffn"], tlayer(tp["layers"], 1)["ffn"]
    want, aux = JMoE.moe_apply(je, jcfg, jnp.asarray(x))
    close(MoE.moe_apply(te, tcfg, torch.tensor(x)), want)


def test_moe_capacity_drops_the_same_tokens(f32):
    # a tight capacity (cf 0.5) makes the token-major cumsum drop tokens
    jcfg, tcfg, jp, tp = f32
    jc = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    tc = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.5))
    x = x_in((2, 9, 64), 9)
    je, te = layer(jp["layers"], 0)["ffn"], tlayer(tp["layers"], 0)["ffn"]
    want, aux = JMoE.moe_apply(je, jc, jnp.asarray(x))
    assert float(aux.dropped_fraction) > 0
    close(MoE.moe_apply(te, tc, torch.tensor(x)), want)


def test_unembed_fp32_accumulation():
    rng = np.random.default_rng(10)
    w = rng.standard_normal((50, 16), dtype=np.float32).astype(jnp.bfloat16)
    x = rng.standard_normal((2, 3, 16), dtype=np.float32).astype(jnp.bfloat16)
    want = JL.unembed(jnp.asarray(w), jnp.asarray(x))
    got = L.unembed(P.array_to_torch(w), P.array_to_torch(x))
    assert got.dtype == torch.float32
    close(got, want)
