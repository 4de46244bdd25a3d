"""Two-Batch Overlap of the port against ``repro.serving.tbo`` on the CPU
(smoke config, fp32, the reference's parameters carried across with
``from_jax_params``; on the CPU half B's stream is the current one, so
these hold the numbers and the state, the card tests the streams).

* ``split_caches`` / ``two_batch_step`` / ``merge_caches`` from the
  reference's prefilled caches, paged and dense tiers (a dense int8 tier
  with its scale plane too), 2 and 3 slots:
  logits at rtol/atol 1e-5 against the reference's TBO step (its Pallas
  path for the int8 tier, which the port's kernels follow; and at 2e-2
  against the port's own whole-batch step: the halves' MoE capacities
  differ), ``lens``, block tables and every pool's maps, stamps and clock
  equal, each slot's appended row in the shared tier, masked halves left
  as they were (``test_serving.py::test_two_batch_overlap_split_merge``);
* whole ``ServeSession(tbo=True)`` runs on a paged bf16 tier, an int8
  tier and at MTP depth 1: streams, events, counters and the pools'
  stamps and clocks equal to the reference's
  (``test_compiled_serve.py::test_compiled_eager_stream_parity[tbo]``,
  ``test_mtp_serve.py::test_serve_mtp_tbo_stream_parity``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro.serving import tbo as JTBO
from repro.serving.scheduler import Request as JReq
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.models.params import from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving import tbo as TTBO
from repro_torch.serving.scheduler import Request as TReq

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

CFG = "deepseek-v32-exp-ess-smoke"
TOL = dict(rtol=1e-5, atol=1e-5)

# the reference's functions jitted once for the whole module (static
# configs hash by value, so cases of one config share the compile)
JPREFILL = jax.jit(JE.ess_prefill, static_argnums=(1, 4),
                   static_argnames=("prefill_chunk",))


def configs(**ess):
    jc, tc = jget(CFG), tget(CFG)
    ess = dict(max_miss_ratio=1.0, **ess)
    return (dataclasses.replace(jc, param_dtype=jnp.float32,
                                ess=dataclasses.replace(jc.ess, **ess)),
            dataclasses.replace(tc, param_dtype=torch.float32,
                                ess=dataclasses.replace(tc.ess, **ess)))


@pytest.fixture(scope="module")
def params():
    jcfg, _ = configs()
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def eq(t, j, what=""):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j), what)


def assert_pools_equal(tps, jps):
    for tp, jp in zip(tps, jps):
        for f in ("ids", "last_use", "slot_of", "step"):
            eq(getattr(tp, f), getattr(jp, f), f)


# ---------------------------------------------------------------------------
# split -> two half steps -> merge
# ---------------------------------------------------------------------------

def _half_step(use_kernel):
    """The reference's half step: its Pallas path for a quantized tier,
    whose bf16 miss rows the port's kernels attend as the Pallas kernel
    does (the plain path rounds Attn1's weights to bf16)."""
    def step(p_, c_, t_, po_, ch_, slot_mask=None):
        return JE.ess_decode(p_, c_, t_, po_, ch_, slot_mask=slot_mask,
                             use_kernel=use_kernel)
    return step


@pytest.mark.parametrize("B,paged,tier", [
    (2, True, "bf16"), (3, True, "bf16"), (2, False, "bf16"),
    (3, False, "bf16"), (3, False, "int8")],
    ids=["2-paged", "3-paged", "2-dense", "3-dense", "3-dense-int8"])
def test_two_batch_step_split_merge(params, B, paged, tier):
    jcfg, tcfg = configs(paged_host=paged, host_cache_dtype=tier)
    jp, tp = params
    S, Smax = 12, 32
    rng = np.random.default_rng(B)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    _, jc = JPREFILL(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), Smax,
                    prefill_chunk=8)
    host = jax.tree.map(np.asarray, jc)
    nxt = rng.integers(0, 256, (B, 1))
    npos = host.lens[:, None]

    # the reference's TBO step and merge
    ja, jb = JTBO.split_caches(jc, B // 2)
    jl, ja2, jb2, jst = JTBO.two_batch_step(
        _half_step(tier != "bf16"), jp, jcfg, jnp.asarray(nxt, jnp.int32),
        jnp.asarray(npos), ja, jb)
    jm = JTBO.merge_caches(ja2, jb2)
    # the port's, over the same caches; and its whole-batch step
    tc = LC.from_jax_caches(host)
    whole = TE.ess_decode(tp, tcfg, torch.tensor(nxt), torch.tensor(npos),
                          LC.from_jax_caches(host))
    ta, tb = TTBO.split_caches(tc, B // 2)
    tl, ta2, tb2, tst = TTBO.two_batch_step(
        TE.ess_decode, tp, tcfg, torch.tensor(nxt), torch.tensor(npos),
        ta, tb)
    tm = TTBO.merge_caches(tc, ta2, tb2)

    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(tl.numpy(), whole.logits.numpy(), atol=2e-2)
    for k in ("hits", "misses", "overflow"):
        eq(tst[k], jst[k], k)
    assert tst["hidden"].shape[0] == B
    assert tm is tc
    eq(tm.lens, jm.lens)
    eq(tm.lens, whole.caches.lens)
    if paged:
        eq(tm.block_tables, jm.block_tables)
    assert_pools_equal(tm.pools, jm.pools)
    for a, b in zip(tm.ikeys, jm.ikeys):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(tm.host_latent.float().numpy(),
                               np.asarray(jm.host_latent, np.float32),
                               **TOL)
    if tier != "bf16":
        eq(tm.host_scales.view(torch.int16),
           np.asarray(jm.host_scales).view(np.int16))
    # every slot's append landed in the shared tier
    for b in range(B):
        row = LC.slot_latents(tm, b)[:, S].float()
        assert row.abs().sum() > 0
        np.testing.assert_allclose(row.numpy(),
                                   LC.slot_latents(whole.caches, b)[:, S]
                                   .float().numpy(), atol=2e-2)

    # masked halves stay untouched
    tc2 = LC.from_jax_caches(host)
    ta, tb = TTBO.split_caches(tc2, B // 2)
    _, ta3, tb3, _ = TTBO.two_batch_step(
        TE.ess_decode, tp, tcfg, torch.tensor(nxt), torch.tensor(npos),
        ta, tb, slot_mask=torch.zeros(B, dtype=torch.bool))
    eq(TTBO.merge_caches(tc2, ta3, tb3).lens, host.lens)
    for p, hp in zip(tc2.pools, host.pools):
        eq(p.ids, hp.ids)
        eq(p.last_use, hp.last_use)


def test_tbo_step_clock_ticks_once_per_layer(params):
    """Halves that shared the pool's clock would tick it twice a layer;
    half B steps on a copy, so after 3 steps the clock and stamps equal
    the whole-batch step's."""
    jcfg, tcfg = configs()
    _, tp = params
    c1 = LC.init_ess_caches(tcfg, 2, 32, torch.float32, device="cpu")
    c2 = LC.init_ess_caches(tcfg, 2, 32, torch.float32, device="cpu")
    tok = torch.tensor([[3], [5]])
    for _ in range(3):
        o1 = TE.ess_decode(tp, tcfg, tok, c1.lens[:, None].clone(), c1)
        c1.lens.copy_(o1.caches.lens)
        TTBO.tbo_step(TE.ess_decode, tp, tcfg, tok,
                      c2.lens[:, None].clone(), c2)
    for a, b in zip(c1.pools, c2.pools):
        assert int(a.step) == int(b.step) == 3
        assert torch.equal(a.last_use, b.last_use)
        assert torch.equal(a.ids, b.ids)
    assert torch.equal(c1.lens, c2.lens)


# ---------------------------------------------------------------------------
# The TBO serve session
# ---------------------------------------------------------------------------

def prompt_fn(req):
    rng = np.random.default_rng(100 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


def mix(R):
    """``test_compiled_serve._requests()``: three greedy, one sampled."""
    return [R(rid=0, prompt_len=10, max_new_tokens=5),
            R(rid=1, prompt_len=8, max_new_tokens=3),
            R(rid=2, prompt_len=13, max_new_tokens=6),
            R(rid=3, prompt_len=9, max_new_tokens=4, temperature=0.8,
              top_k=64, top_p=0.95, seed=123)]


SESSIONS = {"bf16": dict(tier="bf16", depth=0),
            "int8": dict(tier="int8", depth=0),
            "mtp-depth-1": dict(tier="bf16", depth=1)}


@pytest.mark.parametrize("case", list(SESSIONS))
def test_tbo_session_streams_match_reference(params, case):
    tier, depth = SESSIONS[case]["tier"], SESSIONS[case]["depth"]
    jcfg, tcfg = configs(host_cache_dtype=tier)
    jp, tp = params
    kw = dict(num_slots=2, max_seq=32, prompt_fn=prompt_fn,
              prefill_chunk=8, mtp_depth=depth, tbo=True)
    js = JE.ServeSession(jp, jcfg, **kw)
    ts = TE.ServeSession(tp, tcfg, compiled=False, device="cpu", **kw)
    assert ts.tbo and ts.programs.tbo
    jr = js.run(mix(JReq), max_rounds=120)
    tr = ts.run(mix(TReq), max_rounds=120)
    assert ts.outputs == js.outputs
    for f in ("rounds", "spec_rounds", "drafted_tokens", "accepted_tokens",
              "decode_tokens", "prefill_chunks", "h2d_rows", "d2h_rows",
              "ttft_rounds", "finish_reasons"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert sorted(tr.finished_rids) == sorted(jr.finished_rids)
    assert [(e.rid, e.token, e.index, e.finish_reason)
            for e in ts.token_events] == \
        [(e.rid, e.token, e.index, e.finish_reason) for e in js.token_events]
    eq(ts.caches.lens, js.caches.lens)
    eq(ts.caches.block_tables, js.caches.block_tables)
    assert_pools_equal(ts.caches.pools, js.caches.pools)
