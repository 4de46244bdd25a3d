"""The pipelined round (plan -> compute -> commit) of the port against the
reference's on the CPU: smoke config in fp32, its own ``max_miss_ratio``
0.5 (so the slab has ``P = 4`` rows a layer and slot and the pool
misses), the reference's parameters carried across with
``from_jax_params``, the same ``prompt_fn`` given to both packages; the
port's sessions run eagerly (the CPU has no graphs).

* ``ess_decode(staged=)`` teacher-forced against the reference's (jitted)
  for 4 rounds, a paged bf16-option tier at Q = 1 and a dense int8 tier at
  Q = 2, one slot frozen: logits at rtol/atol 1e-5; the slab's ids, the
  prefetch counters, the per-slot hits / misses / overflow, ``lens`` and
  every pool's ids, stamps, map and clock exact; an int8 tier's payload,
  scales and slab exact.  Under fp32 parameters the "bf16" option stores
  fp32 latents, which the two packages' matmuls round differently in the
  last bits, so there the tier, the pools' rows and the slab's rows are
  held at 1e-5 to the reference's and the slab's rows **bit for bit** to
  the port's own tier at the staged ids (what the gather would read); and
  the pipelined logits equal the port's synchronous step's bit for bit.
* ``ServeSession(overlap=True)`` against the reference's
  ``ServeSession(overlap=True)`` and against the port's synchronous
  session: token streams, events, the prefetch counters and the other
  report counters, ``lens``, the pools' maps and the final slab ids equal;
  cases greedy + sampled requests, paged bf16 at ``mtp_depth`` 0, a dense
  int8 tier at depth 1, TBO at depth 1 (``test_overlap_pipeline.py::
  test_overlap_stream_parity``).
* The reference's lifecycle tests, on the port: a preemption cancels the
  victim's staged ids and replays as the synchronous session does; an
  abort cancels them and the slot's next occupant streams as in the
  synchronous session; a stop token inside a verify round rolls the
  staged ids back with ``lens`` and the pools; fill rounds are counted
  alike in both modes (``test_overlap_pipeline.py:202-329``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import transfer as JTR
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro.serving.scheduler import Request as JReq
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import offload as TO
from repro_torch.core import transfer as TTR
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import Request as TReq

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

CFG = "deepseek-v32-exp-ess-smoke"
TOL = dict(rtol=1e-5, atol=1e-5)

# the reference's functions jitted once for the whole module (static
# configs hash by value, so cases of one config share the compile)
JPREFILL = jax.jit(JE.ess_prefill, static_argnums=(1, 4),
                   static_argnames=("prefill_chunk",))
JSTEP = jax.jit(JE.ess_decode, static_argnums=(1,))


def configs(**ess):
    jc, tc = jget(CFG), tget(CFG)
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


def tt(a):
    return array_to_torch(np.asarray(a))


def assert_pools_equal(tps, jps, data_exact=True):
    for tp, jp in zip(tps, jps):
        for f in ("ids", "last_use", "slot_of", "step"):
            eq(getattr(tp, f), getattr(jp, f), f)
        if data_exact:
            eq(tp.data, jp.data, "data")
        else:
            np.testing.assert_allclose(tp.data.numpy(), np.asarray(jp.data),
                                       **TOL)


# ---------------------------------------------------------------------------
# ess_decode(staged=) teacher-forced against the reference's
# ---------------------------------------------------------------------------

TF_CASES = {"paged-bf16-q1": (True, "bf16", 1),
            "dense-int8-q2": (False, "int8", 2)}


@pytest.mark.parametrize("case", list(TF_CASES))
def test_ess_decode_staged_teacher_forced(params, case):
    paged, tier, Q = TF_CASES[case]
    jcfg, tcfg = configs(paged_host=paged, host_cache_dtype=tier)
    jp, tp = params
    B, S, Smax, P = 3, 20, 48, 4
    rng = np.random.default_rng(1)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    _, jc = JPREFILL(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), Smax,
                    prefill_chunk=8)
    tc = LC.from_jax_caches(jax.tree.map(np.asarray, jc))
    sync = LC.from_jax_caches(jax.tree.map(np.asarray, jc))
    hs = jc.host_scales
    jslab = JTR.empty_slab(jcfg.num_layers, B, P, jc.host_latent.shape[-1],
                           jc.host_latent.dtype,
                           None if hs is None else hs.dtype)
    slab = tuple(None if a is None else tt(a).clone() for a in jslab)
    keep = [t.data_ptr() for t in slab if t is not None]
    mask = np.asarray([True, True, False])
    tok = rng.integers(0, 256, (B, Q)).astype(np.int32)
    hits = 0
    for _ in range(4):
        jpos = np.asarray(jc.lens)[:, None] + np.arange(Q)[None]
        jo = JSTEP(jp, jcfg, jnp.asarray(tok), jnp.asarray(jpos), jc,
                  slot_mask=jnp.asarray(mask), staged=jslab)
        to = TE.ess_decode(tp, tcfg, torch.tensor(tok).long(),
                           torch.tensor(jpos).long(), tc,
                           slot_mask=torch.tensor(mask), staged=slab)
        jc, tc, st = jo.caches, to.caches, jo.stats
        jslab = (st["staged_ids"], st["staged_rows"], st.get("staged_scales"))
        np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                                   **TOL)
        for k in ("hits", "misses", "overflow", "pf_hits", "pf_misses",
                  "pf_wasted"):
            eq(to.stats[k], st[k], k)
        assert "land_slab" not in to.stats
        assert [t.data_ptr() for t in slab if t is not None] == keep
        eq(slab[0], jslab[0], "staged_ids")
        eq(tc.lens, jc.lens)
        if tier == "bf16":
            np.testing.assert_allclose(slab[1].numpy(), np.asarray(jslab[1]),
                                       **TOL)
            own, _ = TO.gather_into_slab(tc.host_latent, None, slab[0],
                                         slot_mask=None,
                                         block_table=tc.block_tables)
            assert torch.equal(slab[1], own)
            np.testing.assert_allclose(tc.host_latent.numpy(),
                                       np.asarray(jc.host_latent), **TOL)
            # the synchronous step on its own copy: the same logits
            so = TE.ess_decode(tp, tcfg, torch.tensor(tok).long(),
                               torch.tensor(jpos).long(), sync,
                               slot_mask=torch.tensor(mask))
            sync = so.caches
            assert torch.equal(so.logits, to.logits)
        else:
            eq(slab[1], jslab[1], "staged_rows")
            eq(slab[2].view(torch.int16), np.asarray(jslab[2]).view(np.int16))
            eq(tc.host_latent, jc.host_latent)
            eq(tc.host_scales.view(torch.int16),
               np.asarray(jc.host_scales).view(np.int16))
        assert_pools_equal(tc.pools, jc.pools, data_exact=tier != "bf16")
        hits += int(to.stats["pf_hits"].sum())
        tok = np.asarray(jo.logits).argmax(-1).astype(np.int32)
    assert hits > 0                     # the slab served misses


# ---------------------------------------------------------------------------
# The pipelined serve session
# ---------------------------------------------------------------------------

def prompt_fn(req):
    rng = np.random.default_rng(100 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


def mix(R):
    """``test_overlap_pipeline._PARITY_WORKLOAD``: three greedy, one
    sampled."""
    return [R(rid=0, prompt_len=10, max_new_tokens=5),
            R(rid=1, prompt_len=8, max_new_tokens=3),
            R(rid=2, prompt_len=13, max_new_tokens=6),
            R(rid=3, prompt_len=9, max_new_tokens=4, temperature=0.8,
              top_k=64, top_p=0.95, seed=123)]


SESSIONS = {"paged-bf16": dict(paged=True, tier="bf16", depth=0, tbo=False),
            "dense-int8-mtp1": dict(paged=False, tier="int8", depth=1,
                                    tbo=False),
            "tbo-mtp1": dict(paged=True, tier="bf16", depth=1, tbo=True)}


def session(cfg, tp, overlap, depth=0, tbo=False, **kw):
    return TE.ServeSession(tp, cfg, num_slots=2, max_seq=32,
                           prompt_fn=prompt_fn, prefill_chunk=8,
                           mtp_depth=depth, tbo=tbo, overlap=overlap,
                           compiled=False, device="cpu", **kw)


@pytest.mark.parametrize("case", list(SESSIONS))
def test_pipelined_session_matches_reference_and_sync(params, case):
    c = SESSIONS[case]
    jcfg, tcfg = configs(paged_host=c["paged"], host_cache_dtype=c["tier"])
    jp, tp = params
    # the reference's eager glue over its jitted units: the same streams
    # as its compiled rounds, by its own construction, and faster here
    js = JE.ServeSession(jp, jcfg, num_slots=2, max_seq=32,
                         prompt_fn=prompt_fn, prefill_chunk=8,
                         mtp_depth=c["depth"], tbo=c["tbo"], overlap=True,
                         compiled=False)
    ts = session(tcfg, tp, True, c["depth"], c["tbo"])
    base = session(tcfg, tp, False, c["depth"], c["tbo"])
    assert ts.prefetch_rows == js.prefetch_rows == 4
    assert ts.transfer is not None and base.transfer is None
    jr = js.run(mix(JReq), max_rounds=120)
    tr = ts.run(mix(TReq), max_rounds=120)
    br = base.run(mix(TReq), max_rounds=120)
    assert ts.outputs == js.outputs == base.outputs
    assert tr.prefetch_hits + tr.prefetch_misses > 0     # engaged
    for f in ("prefetch_hits", "prefetch_misses", "prefetch_wasted_rows",
              "rounds", "fill_rounds", "spec_rounds", "drafted_tokens",
              "accepted_tokens", "decode_tokens", "prefill_chunks",
              "h2d_rows", "d2h_rows", "ttft_rounds", "finish_reasons"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.prefetch_hit_rate == jr.prefetch_hit_rate
    # against the synchronous session: the same rounds; with a raw tier the
    # same miss rows too (the slab holds the gather's bits).  A quantized
    # tier under fp32 parameters admits fp32 dequantized rows where the
    # synchronous round admits bf16 ones, in both packages, so a near tie
    # in a later top-k may move one miss while the streams stay equal
    same = ("rounds", "fill_rounds", "decode_tokens") + (
        ("h2d_rows", "hit_rows") if c["tier"] == "bf16" else ())
    for f in same:
        assert getattr(tr, f) == getattr(br, f), f
    assert [(e.rid, e.token, e.index, e.finish_reason)
            for e in ts.token_events] == \
        [(e.rid, e.token, e.index, e.finish_reason) for e in js.token_events]
    eq(ts.caches.lens, js.caches.lens)
    assert_pools_equal(ts.caches.pools, js.caches.pools,
                       data_exact=c["tier"] != "bf16")
    eq(ts.state.staged_ids, js.state.staged_ids)


# ---------------------------------------------------------------------------
# Lifecycle edges against the staged slab (the port's two modes)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port():
    _, tcfg = configs()
    return tcfg, params_of(tcfg)


def params_of(tcfg):
    from repro_torch.models.params import init_params
    return init_params(tcfg, 3, device="cpu")


def _drive_with_preempt(cfg, tp, overlap, preempt_round=3):
    s = session(cfg, tp, overlap)
    for i, p in enumerate((8, 9, 10, 11)):
        s.submit(TReq(rid=i, prompt_len=p, max_new_tokens=6))
    rnd, cancelled = 0, None
    while s.sched.running or s.sched.queue:
        s.step_round()
        if rnd == preempt_round and s.sched.slots[1].active:
            armed = overlap and bool((s.state.staged_ids[:, 1] >= 0).any())
            s.preempt(1)
            if overlap:
                cancelled = armed and \
                    bool((s.state.staged_ids[:, 1] == -1).all())
        rnd += 1
        assert rnd < 200
    return s.outputs, cancelled


def test_preemption_cancels_staged_and_replays_identically(port):
    cfg, tp = port
    base, _ = _drive_with_preempt(cfg, tp, False)
    over, cancelled = _drive_with_preempt(cfg, tp, True)
    assert cancelled              # armed before, all -1 right after
    assert over == base


def _abort_run(cfg, tp, overlap):
    s = TE.ServeSession(tp, cfg, num_slots=1, max_seq=32, prefill_chunk=8,
                        prompt_fn=prompt_fn, overlap=overlap,
                        compiled=False, device="cpu")
    s.submit(TReq(rid=0, prompt_len=10, max_new_tokens=8))
    s.submit(TReq(rid=1, prompt_len=9, max_new_tokens=5))
    for _ in range(4):
        s.step_round()
    armed = overlap and bool((s.state.staged_ids >= 0).any())
    assert s.abort(0)
    if overlap:
        assert armed and bool((s.state.staged_ids[:, 0] == -1).all())
    while s.sched.running or s.sched.queue:
        s.step_round()
    assert s.report.finish_reasons[0] == "abort"
    return s.outputs[1], s.report.prefetch_hits + s.report.prefetch_misses


def test_abort_and_admission_reuse_slab_slot(port):
    cfg, tp = port
    over, engaged = _abort_run(cfg, tp, True)
    base, _ = _abort_run(cfg, tp, False)
    assert over == base and engaged > 0


def _echo(tp, d):
    """Zero parameters but the embeddings, and the MTP module's ``proj``
    passing the token's normed embedding through: every draft is accepted
    on a stream that is not constant."""
    z = {k: (_echo_tree(v) if isinstance(v, dict) else torch.zeros_like(v))
         for k, v in tp.items()}
    z["embed"], z["unembed"] = tp["embed"], tp["unembed"]
    eye = torch.cat([torch.zeros((d, d)), torch.eye(d)])
    z["mtp"]["proj"] = eye.expand_as(tp["mtp"]["proj"]).to(
        tp["mtp"]["proj"].dtype).clone()
    return z


def _echo_tree(tree):
    return {k: (_echo_tree(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def test_stop_truncation_rolls_back_staged_state(port):
    """A stop token at the second position of a fully accepted depth-1
    verify round: under overlap the rollback also cancels the staged ids
    beyond the cut (checked at the release), and the released ``lens`` and
    pool ids equal the synchronous run's."""
    cfg, tp = port
    te = _echo(tp, cfg.d_model)

    def run(overlap, stop=(), snap=None):
        s = TE.ServeSession(te, cfg, num_slots=1, max_seq=48,
                            prefill_chunk=8, prompt_fn=prompt_fn,
                            mtp_depth=1, overlap=overlap, compiled=False,
                            device="cpu")
        if snap is not None:
            hook = s.sched.release_hook

            def release(slot):
                snap["lens"] = int(s.caches.lens[slot])
                snap["ids"] = [np.sort(p.ids[slot][p.ids[slot] >= 0].numpy())
                               for p in s.caches.pools]
                if s.state.staged_ids is not None:
                    snap["staged"] = s.state.staged_ids[:, slot].clone()
                hook(slot)
            s.sched.release_hook = release
        s.run([TReq(rid=0, prompt_len=10, max_new_tokens=9,
                    stop_token_ids=stop)], max_rounds=60)
        return s

    free = run(False)
    stream = free.outputs[0]
    assert free.report.accept_rate == 1.0
    stop = stream[1]                      # round 1 emits stream[1:3]
    assert stop != stream[0]
    snap_sync, snap_over = {}, {}
    out_sync = run(False, (stop,), snap_sync).outputs[0]
    over = run(True, (stop,), snap_over)
    assert out_sync == over.outputs[0] == stream[:2]
    assert snap_sync["lens"] == snap_over["lens"] == 10 + 1
    assert bool((snap_over["staged"] < snap_over["lens"]).all())
    for a, b in zip(snap_sync["ids"], snap_over["ids"]):
        np.testing.assert_array_equal(a, b)


def test_fill_rounds_counted_alike_in_both_modes(port):
    """``rounds_per_s`` leaves each slot's first PIPELINE_FILL_ROUNDS
    rounds out, and the same rounds are fill rounds with and without the
    slab (the window depends on the admissions alone)."""
    cfg, tp = port
    reps = {}
    for overlap in (False, True):
        s = session(cfg, tp, overlap)
        reps[overlap] = s.run(mix(TReq), max_rounds=120)
    sync, over = reps[False], reps[True]
    assert sync.fill_rounds == over.fill_rounds > 0
    assert sync.rounds == over.rounds > sync.fill_rounds
    assert over.prefetch_hits + over.prefetch_misses > 0
    assert sync.prefetch_hits == sync.prefetch_misses == 0
    for rep in (sync, over):
        got = rep.rounds_per_s * rep.decode_wall_s
        assert abs(got - (rep.rounds - rep.fill_rounds)) < 1e-6
    assert TE.PIPELINE_FILL_ROUNDS == JE.PIPELINE_FILL_ROUNDS
    rep = TE.ServeReport(rounds=10, fill_rounds=4, decode_wall_s=2.0)
    assert rep.rounds_per_s == pytest.approx(3.0)
    rep2 = TE.ServeReport(rounds=3, fill_rounds=3, wall_s=1.0)
    assert rep2.rounds_per_s == 0.0
