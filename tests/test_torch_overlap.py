"""The overlap strategies of the port against ``repro.core.overlap`` and
``repro.core.policy`` on the CPU (smoke widths; on the CPU the fork onto a
side stream is a no-op, so these hold the numbers and the pool state, the
card tests the streams).

* one layer of ESS sparse attention in modes ``none``, ``da`` and ``dba``
  at Q = 1 and Q = 2, batch 1 (DBA degrades to DA), 3 (uneven halves) and
  4, over 3 steps from a cold pool with a frozen slot on the second: the
  output at rtol/atol 1e-5 (fp32) or 2e-2 (bf16), the hit / miss /
  overflow counts and the pool's ``ids``, ``last_use``, ``slot_of``,
  ``step`` and ``data`` **equal** after every step (the counterpart of
  ``test_ess.py::test_overlap_modes_exact_vs_monolithic``);
* DBA against DA on the port alone (``test_dba_equals_da_results``);
* ``ess_decode`` with ``overlap="layerwise"`` and a mixed
  ``layerwise_policy`` against the reference's, teacher-forced;
* ``core/policy.py`` equal to the reference's on a grid of
  ``OverlapCosts`` (``test_system.py::
  test_layerwise_policy_picks_dba_for_heavy_layers`` and the chooser part
  of ``test_paper_numbers.py::test_fig7_da_dba_crossover``);
* the fork helper and the gathers' ``out=`` on CPU tensors.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lru_pool as JLP
from repro.core import overlap as JOV
from repro.core import policy as JPOL
from repro.models import mla as JM
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import lru_pool as LP
from repro_torch.core import offload as OF
from repro_torch.core import overlap as OV
from repro_torch.core import policy as POL
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.models.params import from_jax_params
from repro_torch.serving import engine as TE

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file
# the reference's many eager compiles at XLA's quick settings
pytestmark = pytest.mark.usefixtures("quick_xla")

CFG = "deepseek-v32-exp-ess-smoke"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def eq(t, j, what=""):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j), what)


def close(t, j, dt):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **TOL[dt])


def assert_pool_equal(tp, jp, rows_exact=True):
    """Maps, stamps and clock equal; rows bit for bit, or at 1e-5 where
    the model computed them (``rows_exact=False``)."""
    for f in ("ids", "last_use", "slot_of", "step"):
        eq(getattr(tp, f), getattr(jp, f), f)
    if rows_exact:
        eq(tp.data.float(), np.asarray(jp.data, np.float32), "data")
    else:
        close(tp.data, jp.data, "f32")


# ---------------------------------------------------------------------------
# One layer of ESS sparse attention, every mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def layer_params():
    jcfg = jget(CFG)
    defs = {"mla": JM.mla_def(jcfg), "indexer": JM.indexer_def(jcfg)}
    jp = jax.jit(lambda k: jinit(k, defs))(jax.random.key(0))
    return jax.tree.map(np.asarray, jp)


def _inputs(dt, B, Q, seed):
    jcfg = dataclasses.replace(jget(CFG), param_dtype=JDT[dt])
    tcfg = dataclasses.replace(tget(CFG), param_dtype=TDT[dt])
    rng = np.random.default_rng(seed)
    S, D = 64, jcfg.mla.latent_dim
    lat = rng.standard_normal((B, S, D), dtype=np.float32) * 0.5
    ikeys = rng.standard_normal((B, S, jcfg.dsa.index_dim), dtype=np.float32)
    x = rng.standard_normal((B, Q, jcfg.d_model), dtype=np.float32) * 0.3
    ctx = rng.integers(Q + 12, S - 4, B)
    return jcfg, tcfg, lat, ikeys, x, ctx


def _run_steps(layer_params, dt, mode, B, Q, seed=0, steps=3):
    """``steps`` steps of one layer in both packages; yields the outputs,
    stats and pools of each."""
    jcfg, tcfg, lat, ikeys, x, ctx = _inputs(dt, B, Q, seed)
    jdt, tdt = JDT[dt], TDT[dt]
    jpar = jax.tree.map(lambda a: jnp.asarray(a, jdt), layer_params)
    tpar = {k: {n: v.to(tdt) for n, v in d.items()}
            for k, d in from_jax_params(layer_params).items()}
    S, D = lat.shape[1:]
    P = 16
    jst = JOV.ESSLayerState(JLP.init_pool(B, P, S, D, jdt),
                            jnp.asarray(lat, jdt))
    tst = OV.ESSLayerState(LP.init_pool(B, P, S, D, tdt, "cpu"),
                           torch.tensor(lat).to(tdt))
    for step in range(steps):
        lens = ctx + step
        if Q > 1:
            lens = lens[:, None] - (Q - 1) + np.arange(Q)[None]
            pos = lens - 1
        else:
            pos = (lens - 1)[:, None]
        mask = None
        if step == 1 and B > 1:
            mask = np.ones(B, bool)
            mask[B // 2] = False
        xs = np.roll(x, step, axis=-1)
        jo, jst, js = JOV.ess_sparse_attention(
            jpar["mla"], jpar["indexer"], jcfg, jnp.asarray(xs, jdt),
            jnp.asarray(pos), jst, jnp.asarray(ikeys, jdt), jnp.asarray(lens),
            overlap=mode, slot_mask=None if mask is None
            else jnp.asarray(mask))
        to, tst, ts = OV.ess_sparse_attention(
            tpar["mla"], tpar["indexer"], tcfg, torch.tensor(xs).to(tdt),
            torch.tensor(pos), tst, torch.tensor(ikeys).to(tdt),
            torch.tensor(lens), overlap=mode,
            slot_mask=None if mask is None else torch.tensor(mask))
        yield (to, ts, tst.pool), (jo, js, jst.pool)


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("Q", [1, 2])
@pytest.mark.parametrize("mode", ["none", "da", "dba"])
def test_overlap_modes_match_reference(layer_params, mode, Q, B):
    misses = 0
    for (to, ts, tp), (jo, js, jp) in _run_steps(layer_params, "f32", mode,
                                                 B, Q):
        close(to, jo, "f32")
        for a, b in zip(ts, js):
            eq(a, b)
        assert_pool_equal(tp, jp)
        assert LP.check_consistent(tp)
        misses += int(ts.misses.sum())
    assert misses > 0


@pytest.mark.parametrize("Q", [1, 2])
@pytest.mark.parametrize("mode", ["none", "da", "dba"])
def test_overlap_modes_bf16_match_reference(layer_params, mode, Q):
    for (to, ts, tp), (jo, js, jp) in _run_steps(layer_params, "bf16", mode,
                                                 3, Q, seed=1):
        close(to, jo, "bf16")
        for a, b in zip(ts, js):
            eq(a, b)
        assert_pool_equal(tp, jp)


@pytest.mark.parametrize("Q", [1, 2])
@pytest.mark.parametrize("B", [3, 4])
def test_dba_equals_da_results(layer_params, B, Q):
    """DBA changes the schedule, not the numbers: from the same inputs,
    the port's DBA output equals its DA output at 1e-5 and the pool state
    after 3 steps exactly."""
    runs = [list(_run_steps(layer_params, "f32", m, B, Q, seed=2))
            for m in ("da", "dba")]
    for (da, _), (dba, _) in zip(*runs):
        np.testing.assert_allclose(dba[0].numpy(), da[0].numpy(),
                                   **TOL["f32"])
        for a, b in zip(dba[1], da[1]):
            assert torch.equal(a, b)
        for f in LP.PoolState._fields:
            assert torch.equal(getattr(dba[2], f), getattr(da[2], f)), f


def test_unknown_overlap_mode_raises(layer_params):
    with pytest.raises(ValueError, match="overlap"):
        next(_run_steps(layer_params, "f32", "layerwise", 2, 1))


# ---------------------------------------------------------------------------
# ess_decode with a layer-wise plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def decode_setup():
    """The smoke model in fp32 (``overlap="layerwise"``), the reference's
    prefill of 3 prompts (uneven DBA halves) into ``max_seq`` 32."""
    B, S, max_seq = 3, 14, 32
    jcfg, tcfg = (dataclasses.replace(
        c, param_dtype=dt, ess=dataclasses.replace(c.ess,
                                                   overlap="layerwise"))
        for c, dt in ((jget(CFG), jnp.float32), (tget(CFG), torch.float32)))
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    prefill = jax.jit(JE.ess_prefill, static_argnums=(1, 4),
                      static_argnames=("prefill_chunk",))
    logits, caches = prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             max_seq, prefill_chunk=8)
    return (jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp)),
            jax.tree.map(np.asarray, caches),
            np.asarray(jnp.argmax(logits[:, -1], -1)))


POLICIES = {"mixed": ("da", "dba", "none", "dba"), "none": None}
# jit'd: the reference's eager decode compiles every op
JDECODE = jax.jit(JE.ess_decode, static_argnums=(1,),
                  static_argnames=("layerwise_policy",))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_layerwise_policy_through_ess_decode(decode_setup, policy):
    """3 teacher-forced decode steps, slot 1 frozen in the second: logits
    at 1e-5, stats equal, every layer's pool maps, stamps and clock equal
    after each step, and the rows the model computed (pool rows, indexer
    keys, host tier) at 1e-5.  Without a
    policy ``layerwise`` is DA in both packages."""
    jcfg, tcfg, jp, tp, jcaches, tok = decode_setup
    plan = POLICIES[policy]
    jc = jax.tree.map(jnp.asarray, jcaches)
    tc = LC.from_jax_caches(jcaches)
    for step in range(3):
        mask = np.array([True, step != 1, True])
        pos = np.asarray(jc.lens)[:, None]
        jo = JDECODE(jp, jcfg, jnp.asarray(tok[:, None]), jnp.asarray(pos),
                     jc, layerwise_policy=plan, slot_mask=jnp.asarray(mask))
        to = TE.ess_decode(tp, tcfg, torch.tensor(tok[:, None]).long(),
                           torch.tensor(pos).long(), tc,
                           layerwise_policy=plan,
                           slot_mask=torch.tensor(mask))
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                                   **TOL["f32"])
        for k in ("hits", "misses", "overflow"):
            eq(to.stats[k], jo.stats[k], k)
        jc, tc = jo.caches, to.caches
        eq(tc.lens, jc.lens)
        for a, b in zip(tc.pools, jc.pools):
            assert_pool_equal(a, b, rows_exact=False)
        for a, b in zip(tc.ikeys, jc.ikeys):
            close(a, b, "f32")
        close(tc.host_latent, jc.host_latent, "f32")
        tok = np.asarray(jnp.argmax(jo.logits[:, 0], -1))


# ---------------------------------------------------------------------------
# The layer-wise chooser
# ---------------------------------------------------------------------------

# a grid around the paper's operating point (test_system.py's costs:
# 160 sequences x 656 B a miss at 37 GB/s)
GRID = list(itertools.product((1e-4, 3e-4), (2e-4,), (1e-4, 8e-4, 3e-3),
                              (0.0, 5e-5), (12e9, 37e9), (656 * 160, 656)))


@pytest.mark.parametrize("i", range(0, len(GRID), 6))
def test_policy_equal_to_reference(i):
    for args in GRID[i:i + 6]:
        jc, tc = JPOL.OverlapCosts(*args), POL.OverlapCosts(*args)
        for miss in (0, 7, 8, 100, 512, 4096):
            assert POL.exposed_da(tc, miss) == JPOL.exposed_da(jc, miss)
            assert POL.exposed_dba(tc, miss) == JPOL.exposed_dba(jc, miss)
        assert POL.dba_threshold(tc) == JPOL.dba_threshold(jc)
        assert POL.dba_threshold(tc, 64) == JPOL.dba_threshold(jc, 64)
        profile = np.array([0, 16, 300, 1000, 4000])
        assert POL.choose_layerwise(profile, tc) == \
            JPOL.choose_layerwise(profile, jc)


def test_layerwise_policy_picks_dba_for_heavy_layers():
    c = POL.OverlapCosts(t_attn0=3e-4, t_preattn=2e-4, t_indexer=8e-4,
                         t_split_overhead=5e-5, fetch_bw=37e9,
                         block_bytes=656 * 160)
    thr = POL.dba_threshold(c)
    assert 0 < thr < 4096
    assert POL.choose_layerwise(np.array([thr // 2, thr * 2, 16, 4000]),
                                c) == ["da", "dba", "da", "dba"]
    assert POL.exposed_da(c, 0) == 0.0
    assert POL.exposed_dba(c, 4096) < POL.exposed_da(c, 4096) \
        + c.t_split_overhead
    # the Figure 7 crossover: DA at least as good at low misses, DBA below
    # it at high ones
    assert POL.exposed_da(c, 32) <= POL.exposed_dba(c, 32)
    assert POL.exposed_dba(c, 512) < POL.exposed_da(c, 512)


# ---------------------------------------------------------------------------
# The fork helper and the gathers' out= on the CPU
# ---------------------------------------------------------------------------

def test_fork_is_a_no_op_on_cpu_tensors():
    t = torch.zeros(4)
    stream = object()           # never touched: the tensors decide
    with OV.Fork(stream, t) as f:
        t.add_(1)
    assert not f.active
    f.join()
    assert torch.equal(t, torch.ones(4))
    assert OV.side_stream("cpu") is None


@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("paged", [True, False])
def test_gather_tier_rows_into_out(tier, paged):
    """``out=`` receives exactly the rows the wrapper would return."""
    cfg = dataclasses.replace(tget(CFG), ess=dataclasses.replace(
        tget(CFG).ess, host_cache_dtype=tier, paged_host=paged))
    c = LC.init_ess_caches(cfg, 2, 32, torch.float32, device="cpu")
    g = torch.Generator().manual_seed(0)
    if c.host_scales is None:
        c.host_latent.copy_(torch.randn(c.host_latent.shape, generator=g))
    else:
        c.host_latent.copy_(torch.randint(-100, 100, c.host_latent.shape,
                                          generator=g))
        c.host_scales.copy_(torch.rand(c.host_scales.shape, generator=g))
    ids = torch.tensor([[0, 5, -1, 31], [7, -1, 2, 30]])
    kw = dict(layer=1, block_table=c.block_tables)
    want = OF.gather_tier_rows(c.host_latent, c.host_scales, ids, **kw)
    out = torch.full_like(want, 7.0)
    got = OF.gather_tier_rows(c.host_latent, c.host_scales, ids, out=out,
                              **kw)
    assert torch.equal(out, want) and torch.equal(got, want)
    assert out.dtype == OF.tier_rows_dtype(c.host_latent, c.host_scales)
    with pytest.raises(ValueError, match="out must be"):
        gops.gather_rows(torch.zeros(5, 4), torch.zeros(3, dtype=torch.long),
                         out=torch.zeros(2, 4))
