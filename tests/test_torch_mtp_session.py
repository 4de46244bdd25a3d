"""The MTP speculative serve session of the port against the reference's
on the CPU (smoke config, fp32, ``mtp_depth`` 2, ``max_miss_ratio`` 1,
2 slots, ``max_seq`` 32, prefill chunks of 8, the reference's parameters
carried across with ``from_jax_params``, the same ``prompt_fn`` given to
both packages; the port's session eager).

* whole ``ServeSession.run``s with greedy and sampled requests, bf16 and
  int8 tiers, bucketed and warmup prefill: streams, events and the
  speculative counters (``spec_rounds``, ``drafted_tokens``,
  ``accepted_tokens``) equal to the reference's, and the same streams as
  the port's ``mtp_depth`` 0 session (``test_compiled_serve.py``);
* sampled streams keyed by their seed alone, full acceptance with the
  budget clamp, the freed slot left untouched by later rounds, and a stop
  token inside a verify round rolled back as the reference does
  (``test_mtp_serve.py``).

The draft, the speculative step and the Q > 1 verify step alone are in
``tests/test_torch_mtp.py``.
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
from repro.serving.scheduler import Request as JReq
from repro_torch.configs import get_config as tget
from repro_torch.models.params import from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import Request as TReq

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

CFG = "deepseek-v32-exp-ess-smoke"
DEPTH = 2


def configs():
    jc, tc = jget(CFG), tget(CFG)
    return (dataclasses.replace(jc, param_dtype=jnp.float32, mtp_depth=DEPTH,
                                ess=dataclasses.replace(jc.ess,
                                                        max_miss_ratio=1.0)),
            dataclasses.replace(tc, param_dtype=torch.float32,
                                mtp_depth=DEPTH,
                                ess=dataclasses.replace(tc.ess,
                                                        max_miss_ratio=1.0)))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jcfg, tcfg, jp, to_port(jp)


def to_port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


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


def with_tier(cfg, tier):
    return dataclasses.replace(cfg, ess=dataclasses.replace(
        cfg.ess, host_cache_dtype=tier))


def run_pair(jp, tp, jcfg, tcfg, reqs, *, depth=DEPTH, tier="bf16",
             max_rounds=120, **kw):
    js = JE.ServeSession(jp, with_tier(jcfg, tier), num_slots=2, max_seq=32,
                         prompt_fn=prompt_fn, prefill_chunk=8,
                         mtp_depth=depth, **kw)
    ts = TE.ServeSession(tp, with_tier(tcfg, tier), num_slots=2, max_seq=32,
                         prompt_fn=prompt_fn, prefill_chunk=8,
                         mtp_depth=depth, compiled=False, device="cpu", **kw)
    jr = js.run(reqs(JReq), max_rounds=max_rounds)
    tr = ts.run(reqs(TReq), max_rounds=max_rounds)
    return js, jr, ts, tr


def assert_same_run(js, jr, ts, tr):
    assert ts.outputs == js.outputs
    for f in ("rounds", "spec_rounds", "drafted_tokens", "accepted_tokens",
              "decode_tokens", "prefill_chunks", "h2d_rows", "d2h_rows",
              "fill_rounds", "ttft_rounds", "finish_reasons"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert tr.accept_rate == jr.accept_rate
    assert sorted(tr.finished_rids) == sorted(jr.finished_rids)
    assert [(e.rid, e.token, e.index, e.finish_reason)
            for e in ts.token_events] == \
        [(e.rid, e.token, e.index, e.finish_reason) for e in js.token_events]
    np.testing.assert_array_equal(ts.caches.lens.numpy(),
                                  np.asarray(js.caches.lens))


@pytest.mark.parametrize(
    "do_warmup,tier", [(False, "bf16"), (True, "bf16"), (False, "int8"),
                       (True, "int8")],
    ids=["bucketed-bf16", "warmup-bf16", "bucketed-int8", "warmup-int8"])
def test_spec_session_streams_match_reference(model, do_warmup, tier):
    """Counterpart of ``test_compiled_eager_stream_parity`` at depth 2 (the
    port's session eager): greedy and sampled streams, the speculative
    counters and the events equal the reference's; the port's Q = 1
    session emits the same streams (sampling slots draw with the same
    keys in both round kinds)."""
    jcfg, tcfg, jp, tp = model
    js, jr, ts, tr = run_pair(jp, tp, jcfg, tcfg, mix, tier=tier,
                              do_warmup=do_warmup)
    assert sorted(tr.finished_rids) == [0, 1, 2, 3]
    assert tr.spec_rounds == tr.rounds > 0 and tr.drafted_tokens > 0
    assert_same_run(js, jr, ts, tr)
    q1 = TE.ServeSession(tp, with_tier(tcfg, tier), num_slots=2, max_seq=32,
                         prompt_fn=prompt_fn, prefill_chunk=8,
                         do_warmup=do_warmup, compiled=False, device="cpu")
    q1.run(mix(TReq), max_rounds=120)
    assert q1.outputs == ts.outputs
    assert q1.report.spec_rounds == 0


def test_sampled_stream_depends_on_seed_only(model):
    """Counterpart of ``test_serve_sampling_deterministic_and_mode_
    invariant``: the sampled stream repeats run to run and differs from
    the greedy one; the greedy slot beside it is unaffected."""
    _, tcfg, _, tp = model

    def run(sampled):
        s = TE.ServeSession(tp, tcfg, num_slots=2, max_seq=32,
                            prompt_fn=prompt_fn, prefill_chunk=8,
                            mtp_depth=DEPTH, compiled=False, device="cpu")
        s.run([TReq(rid=0, prompt_len=10, max_new_tokens=5),
               TReq(rid=1, prompt_len=8, max_new_tokens=6,
                    temperature=0.8 if sampled else 0.0, top_k=64,
                    seed=123)], max_rounds=60)
        return s.outputs
    a, b, g = run(True), run(True), run(False)
    assert a == b
    assert a[0] == g[0] and a[1] != g[1]


def test_spec_full_acceptance_and_budget_clamp(model):
    """Zero parameters make every argmax token 0, so every draft is
    accepted: 3 tokens per live slot per round, ``accept_rate`` 1.0, a
    budget that is not a multiple of 3 clamped inside the round, and the
    Q = 1 session's streams (``test_mtp_serve.py``'s case)."""
    jcfg, tcfg, jp, _ = model
    jz = jax.tree.map(jnp.zeros_like, jp)
    tz = to_port(jz)

    def reqs(R):
        return [R(rid=0, prompt_len=8, max_new_tokens=4),
                R(rid=1, prompt_len=8, max_new_tokens=7)]
    js, jr, ts, tr = run_pair(jz, tz, jcfg, tcfg, reqs)
    assert_same_run(js, jr, ts, tr)
    base = TE.ServeSession(tz, tcfg, num_slots=2, max_seq=32,
                           prompt_fn=prompt_fn, prefill_chunk=8,
                           compiled=False, device="cpu")
    br = base.run(reqs(TReq), max_rounds=120)
    assert tr.accept_rate == 1.0 and tr.rounds < br.rounds
    assert base.outputs == ts.outputs
    for r in ts.sched.finished:
        assert len(ts.outputs[r.rid]) == r.max_new_tokens == r.generated + 1


def test_spec_round_mid_finish_leaves_freed_slot_untouched(model):
    """A slot finishing during a speculative round frees its pages and pool;
    the later rounds of the surviving slot leave the freed slot's state
    and its released pages as they were."""
    _, tcfg, _, tp = model
    s = TE.ServeSession(tp, tcfg, num_slots=2, max_seq=32,
                        prompt_fn=prompt_fn, mtp_depth=DEPTH,
                        compiled=False, device="cpu")
    for r in (TReq(rid=0, prompt_len=8, max_new_tokens=2),
              TReq(rid=1, prompt_len=8, max_new_tokens=12)):
        s.submit(r)
    for _ in range(30):
        s.step()
        if any(rq.rid == 0 for rq in s.sched.finished):
            break
    assert any(rq.rid == 0 for rq in s.sched.finished) and s.sched.running
    freed = [i for i, st in enumerate(s.sched.slots) if not st.active]
    assert len(freed) == 1
    f = freed[0]
    host_before = s.caches.host_latent.clone()
    live_pages = s.caches.block_tables[1 - f]
    live_pages = set(live_pages[live_pages >= 0].tolist())
    for _ in range(3):
        s.step()
    assert int(s.caches.lens[f]) == 0
    for p in s.caches.pools:
        assert (p.ids[f] == -1).all()
    assert (s.caches.block_tables[f] == -1).all()
    for pg in range(s.caches.host_latent.shape[1]):
        if pg not in live_pages:
            assert torch.equal(s.caches.host_latent[:, pg],
                               host_before[:, pg]), f"page {pg} touched"


def _echo(jp, d):
    """Zero parameters but the embeddings, and each MTP module's ``proj``
    passing the token's normed embedding through: the model's next token
    and every draft are then the same function of the current token, so
    every draft is accepted on a stream that is not constant."""
    z = jax.tree.map(jnp.zeros_like, jp)
    z["embed"], z["unembed"] = jp["embed"], jp["unembed"]
    eye = jnp.concatenate([jnp.zeros((d, d)), jnp.eye(d)])
    z["mtp"]["proj"] = jnp.broadcast_to(eye, jp["mtp"]["proj"].shape).astype(
        jp["mtp"]["proj"].dtype)
    return z


def test_stop_token_inside_verify_round(model):
    """A stop token at the second position of a fully accepted verify
    round: the stream ends at it, and ``_truncate_slot_tail`` rolls the
    slot's ``lens`` and pools back past the drafted suffix before the slot
    is released, as the reference's does."""
    jcfg, tcfg, jp, _ = model
    je = _echo(jp, jcfg.d_model)
    te = to_port(je)

    def reqs(stop):
        return lambda R: [R(rid=0, prompt_len=8, max_new_tokens=12,
                            stop_token_ids=stop)]
    _, _, free, _ = run_pair(je, te, jcfg, tcfg, reqs(()))
    stream = free.outputs[0]
    assert free.report.accept_rate == 1.0
    stop = stream[2]              # round 1 emits stream[1:4]
    assert stop not in stream[:2]

    snaps = {}

    def watch(s, tag):
        hook = s.sched.release_hook

        def release(slot):
            snaps[tag] = (np.array(s.caches.lens[slot]),
                          [np.array(p.ids[slot]) for p in s.caches.pools],
                          [np.array(p.slot_of[slot]) for p in s.caches.pools])
            hook(slot)
        s.sched.release_hook = release
    js = JE.ServeSession(je, jcfg, num_slots=2, max_seq=32,
                         prompt_fn=prompt_fn, prefill_chunk=8,
                         mtp_depth=DEPTH)
    ts = TE.ServeSession(te, tcfg, num_slots=2, max_seq=32,
                         prompt_fn=prompt_fn, prefill_chunk=8,
                         mtp_depth=DEPTH, compiled=False, device="cpu")
    watch(js, "ref")
    watch(ts, "port")
    jr = js.run(reqs((stop,))(JReq), max_rounds=60)
    tr = ts.run(reqs((stop,))(TReq), max_rounds=60)
    assert ts.outputs[0] == stream[:3] == js.outputs[0]
    assert tr.finish_reasons == {0: "stop"} == jr.finish_reasons
    lens, ids, slot_of = snaps["port"]
    assert int(lens) == 8 + 2       # prompt + the tokens fed before the stop
    for a, b in zip(snaps["port"][1:], snaps["ref"][1:]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert int(snaps["ref"][0]) == int(lens)
    for x in ids:
        assert (x < int(lens)).all()
