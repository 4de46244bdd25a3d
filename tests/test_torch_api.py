"""The port's public serving API (``repro_torch.serving.api``) against the
reference's on the CPU (counterparts of ``tests/test_api.py``).

Smoke config in fp32, ``mtp_depth`` 2 stacked, ``max_miss_ratio`` 1, the
reference's parameters carried across with ``from_jax_params`` and the
same ``prompt_fn`` given to both packages (the port's session eager):

* ``EssEngine.generate`` streams equal to the reference ``EssEngine``'s
  over the parity workload (greedy + sampled) at Q = 1, MTP depth 2 and
  TBO, eager, and on the dense tier; ``stream()`` the same tokens;
* abort mid-prefill and mid-decode restores pages and pool entries, and
  the recycled slot replays a fresh engine's stream;
* a stop token inside a speculative round ends the stream there, as the
  reference's does; rejected requests and budget terminals; one terminal
  event per rid;
* ``latency_stats`` equal to the reference's on the same events, and the
  scheduler's priority admission and abort against the reference's.
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
from repro.serving import api as JA
from repro.serving import scheduler as JS
from repro_torch.configs import get_config as tget
from repro_torch.models.params import from_jax_params
from repro_torch.serving import api as TA
from repro_torch.serving import scheduler as TS

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file
# the reference's many eager compiles at XLA's quick settings
pytestmark = pytest.mark.usefixtures("quick_xla")

CFG = "deepseek-v32-exp-ess-smoke"
MAX_SEQ = 32

# the parity workload of tests/test_api.py: 3 greedy + 1 sampled request
WORKLOAD = [(10, dict(max_tokens=5)),
            (8, dict(max_tokens=3)),
            (13, dict(max_tokens=6)),
            (9, dict(max_tokens=4, temperature=0.8, top_k=64, top_p=0.95,
                     seed=123))]


def configs(**ess):
    jc, tc = jget(CFG), tget(CFG)
    ess = dict(max_miss_ratio=1.0, **ess)
    return (dataclasses.replace(jc, param_dtype=jnp.float32, mtp_depth=2,
                                ess=dataclasses.replace(jc.ess, **ess)),
            dataclasses.replace(tc, param_dtype=torch.float32, mtp_depth=2,
                                ess=dataclasses.replace(tc.ess, **ess)))


def to_port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jcfg, tcfg, jp, to_port(jp)


def prompt_fn(req):
    rng = np.random.default_rng(100 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


def workload(SP):
    return [p for p, _ in WORKLOAD], [SP(**kw) for _, kw in WORKLOAD]


def engine_pair(jp, tp, jcfg, tcfg, *, jkw=None, **kw):
    je = JA.EssEngine(jp, jcfg, num_slots=2, max_seq=MAX_SEQ,
                      prompt_fn=prompt_fn, **dict(kw, **(jkw or {})))
    te = TA.EssEngine(tp, tcfg, num_slots=2, max_seq=MAX_SEQ,
                      prompt_fn=prompt_fn, compiled=False, device="cpu",
                      **kw)
    return je, te


def streams(outs):
    return [(o.rid, o.prompt_len, o.tokens, o.finish_reason) for o in outs]


# ---------------------------------------------------------------------------
# generate() against the reference EssEngine, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mtp_depth,tbo", [(0, False), (2, False),
                                           (0, True), (2, True)])
def test_generate_streams_match_reference(model, mtp_depth, tbo):
    """Counterpart of ``test_generate_stream_parity_vs_run``: the port's
    ``generate`` emits the reference ``generate``'s streams (greedy and
    sampled) and counters, each rid with one terminal event."""
    jcfg, tcfg, jp, tp = model
    je, te = engine_pair(jp, tp, jcfg, tcfg, mtp_depth=mtp_depth, tbo=tbo)
    jo = je.generate(*workload(JA.SamplingParams), max_rounds=120)
    to = te.generate(*workload(TA.SamplingParams), max_rounds=120)
    assert streams(to) == streams(jo)
    assert [o.finish_reason for o in to] == ["length"] * 4
    assert sorted(te.session._terminal) == [0, 1, 2, 3]
    jm, tm = je.metrics(), te.metrics()
    for k in ("rounds", "spec_rounds", "decode_tokens", "prefill_tokens",
              "prefill_chunks", "accept_rate", "rejected", "aborted",
              "finish_reasons", "admissions_blocked", "peak_pages_in_use",
              "num_pages", "n_token_events"):
        assert tm[k] == jm[k], k
    assert all(o.ttft_s is not None and o.ttft_s > 0 for o in to)


def test_generate_eager_matches_reference_eager(model):
    """Counterpart of ``test_generate_stream_parity_eager``: the reference's
    op-by-op engine (``compiled=False``) and the port's eager one."""
    jcfg, tcfg, jp, tp = model
    je, te = engine_pair(jp, tp, jcfg, tcfg, mtp_depth=2,
                         jkw=dict(compiled=False))
    jo = je.generate(*workload(JA.SamplingParams), max_rounds=120)
    to = te.generate(*workload(TA.SamplingParams), max_rounds=120)
    assert streams(to) == streams(jo)


def test_generate_dense_tier_matches_reference(model):
    """Counterpart of ``test_generate_stream_parity_dense_host_tier``."""
    _, _, jp, tp = model
    jcfg, tcfg = configs(paged_host=False)
    je, te = engine_pair(jp, tp, jcfg, tcfg, mtp_depth=2)
    assert te.session.caches.block_tables is None
    jo = je.generate(*workload(JA.SamplingParams), max_rounds=120)
    to = te.generate(*workload(TA.SamplingParams), max_rounds=120)
    assert streams(to) == streams(jo)


def test_explicit_prompts_and_stream_generator(model):
    """An explicit token prompt (an int32 tensor on the session's device)
    serves as the same prompt through ``prompt_fn``; ``stream(rid)`` yields
    the tokens, then the single terminal event, then nothing."""
    _, tcfg, _, tp = model
    toks = [int(t) for t in prompt_fn(TS.Request(rid=0, prompt_len=10,
                                                 max_new_tokens=1))[0]]
    e = TA.EssEngine(tp, tcfg, num_slots=2, max_seq=MAX_SEQ,
                     compiled=False, device="cpu")
    r0 = e.submit(toks, TA.SamplingParams(max_tokens=5))
    assert e._prompts[r0].dtype == torch.int32
    assert e._prompts[r0].shape == (1, 10)
    r1 = e.submit(8, TA.SamplingParams(max_tokens=3))
    evs = list(e.stream(r0))
    assert [ev.index for ev in evs] == [0, 1, 2, 3, 4, 5]
    assert evs[-1].is_terminal and evs[-1].finish_reason == "length"
    assert [ev.token for ev in evs[:-1]] == e.output(r0).tokens
    assert all(a.t <= b.t for a, b in zip(evs, evs[1:]))
    assert list(e.stream(r0)) == []
    ref = TA.EssEngine(tp, tcfg, num_slots=2, max_seq=MAX_SEQ,
                       prompt_fn=prompt_fn, compiled=False, device="cpu")
    [o] = ref.generate([10], TA.SamplingParams(max_tokens=5))
    assert o.tokens == e.output(r0).tokens
    while e.has_work():
        e.step()
    assert e.finish_reason(r1) == "length"


# ---------------------------------------------------------------------------
# abort: resources restored, the recycled slot replays a fresh engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mtp_depth", [0, 2])
def test_abort_restores_resources_and_recycled_slot_replays(model,
                                                            mtp_depth):
    """Counterpart of the reference's test of the same name: abort mid-
    prefill and mid-decode return free pages and pool entries to their
    values before admission and reset the slot; a request on the recycled
    slot gives a fresh engine's stream."""
    _, tcfg, _, tp = model
    rng = np.random.default_rng(21)
    prompt_a = [int(t) for t in rng.integers(0, tcfg.vocab_size, 16)]
    prompt_b = [int(t) for t in rng.integers(0, tcfg.vocab_size, 8)]

    def engine():
        return TA.EssEngine(tp, tcfg, num_slots=2, max_seq=MAX_SEQ,
                            mtp_depth=mtp_depth, prefill_chunk=4,
                            compiled=False, device="cpu")
    eng = engine()
    s = eng.session
    free0, pool0 = s.allocator.free_pages, s.free_pool_entries

    r0 = eng.submit(prompt_a, TA.SamplingParams(max_tokens=4))
    eng.step()                        # admit + the first chunk of four
    slot = s.sched.running[r0].slot
    assert 0 < s._prefill[slot].cursor < len(prompt_a)
    assert s.allocator.free_pages < free0
    assert eng.abort(r0)
    assert (s.allocator.free_pages, s.free_pool_entries) == (free0, pool0)
    assert slot not in s._prefill
    assert (s.caches.block_tables[slot] == -1).all()
    assert int(s.caches.lens[slot]) == 0
    assert eng.finish_reason(r0) == "abort" and eng.output(r0).tokens == []

    r1 = eng.submit(prompt_b, TA.SamplingParams(max_tokens=20))
    for _ in range(40):
        eng.step()
        if len(s.outputs.get(r1, [])) >= 3:
            break
    slot1 = s.sched.running[r1].slot
    assert eng.abort(r1)
    assert (s.allocator.free_pages, s.free_pool_entries) == (free0, pool0)
    for p in s.caches.pools:
        assert (p.ids[slot1] == -1).all() and (p.slot_of[slot1] == -1).all()
    assert eng.finish_reason(r1) == "abort"
    assert 3 <= eng.output(r1).n_generated < 20

    r2 = eng.submit(prompt_b, TA.SamplingParams(max_tokens=6))
    while not eng.is_finished(r2):
        eng.step()
    [fresh] = engine().generate([prompt_b], TA.SamplingParams(max_tokens=6),
                                max_rounds=60)
    assert eng.output(r2).tokens == fresh.tokens
    assert eng.output(r2).finish_reason == "length"


# ---------------------------------------------------------------------------
# stop inside a speculative round; rejected and budget terminals
# ---------------------------------------------------------------------------

def _echo(jp, d):
    """Zero parameters but the embeddings, each MTP module's ``proj``
    passing the normed embedding through: every draft is accepted on a
    stream that is not constant."""
    z = jax.tree.map(jnp.zeros_like, jp)
    z["embed"], z["unembed"] = jp["embed"], jp["unembed"]
    eye = jnp.concatenate([jnp.zeros((d, d)), jnp.eye(d)])
    z["mtp"]["proj"] = jnp.broadcast_to(eye, jp["mtp"]["proj"].shape).astype(
        jp["mtp"]["proj"].dtype)
    return z


def test_stop_token_inside_spec_round_matches_reference(model):
    """Counterpart of ``test_stop_token_truncates_within_spec_round``: on
    fully accepted drafts, a stop at the stream's third token ends the
    stream there (inside the first verify round) in both packages, with
    one terminal event at index 3."""
    jcfg, tcfg, jp, _ = model
    je_p = _echo(jp, jcfg.d_model)
    te_p = to_port(je_p)
    je, te = engine_pair(je_p, te_p, jcfg, tcfg, mtp_depth=2)
    [free] = te.generate([10], TA.SamplingParams(max_tokens=9))
    assert te.metrics()["accept_rate"] == 1.0
    stream = free.tokens
    stop = stream[2]
    assert stop not in stream[:2]
    je, te = engine_pair(je_p, te_p, jcfg, tcfg, mtp_depth=2)
    [jo] = je.generate([10], JA.SamplingParams(max_tokens=9,
                                               stop_token_ids=(stop,)))
    [to] = te.generate([10], TA.SamplingParams(max_tokens=9,
                                               stop_token_ids=(stop,)))
    assert to.tokens == stream[:3] == jo.tokens
    assert to.finish_reason == "stop" == jo.finish_reason
    term = [e for e in te.session.token_events if e.is_terminal]
    assert len(term) == 1 and term[0].index == 3
    # EOS at the first token ends the stream at index 0
    je, te = engine_pair(je_p, te_p, jcfg, tcfg, mtp_depth=2)
    [to] = te.generate([10], TA.SamplingParams(max_tokens=9,
                                               eos_token_ids=(stream[0],)))
    assert to.tokens == stream[:1] and to.finish_reason == "stop"
    assert te.metrics()["decode_tokens"] == 0


def test_rejected_requests_surface_with_terminal_events(model):
    """Counterpart of the reference's test: a request needing more pages
    than the pool has is rejected at submit, an oversize one at admission;
    both end with a ``rejected`` terminal event and count as rejected."""
    _, tcfg, _, tp = model
    eng = TA.EssEngine(tp, tcfg, num_slots=1, max_seq=MAX_SEQ,
                       num_host_pages=1, compiled=False, device="cpu")
    r_pages = eng.submit(20, TA.SamplingParams(max_tokens=8))
    assert eng.finish_reason(r_pages) == "rejected"
    r_big = eng.submit(30, TA.SamplingParams(max_tokens=8))
    r_ok = eng.submit(8, TA.SamplingParams(max_tokens=2))
    for _ in range(40):
        if not eng.has_work():
            break
        eng.step()
    assert eng.finish_reason(r_big) == "rejected"
    assert eng.finish_reason(r_ok) == "length"
    assert eng.session.report.rejected == 2
    assert eng.output(r_big).tokens == []
    terms = [e for e in eng.session.token_events if e.is_terminal]
    assert sorted(e.rid for e in terms) == sorted([r_pages, r_big, r_ok])


def test_generate_budget_ends_unfinished_with_budget(model):
    """Counterpart of ``test_run_budget_exhaustion_emits_budget_terminals``
    through the API: ``generate(max_rounds=)`` ends every unfinished rid
    (running and queued) with ``budget``; pages return."""
    _, tcfg, _, tp = model
    eng = TA.EssEngine(tp, tcfg, num_slots=1, max_seq=MAX_SEQ,
                       compiled=False, device="cpu")
    outs = eng.generate([8, 8], TA.SamplingParams(max_tokens=12),
                        max_rounds=4)
    assert [o.finish_reason for o in outs] == ["budget", "budget"]
    assert 0 < outs[0].n_generated < 12 and outs[1].tokens == []
    assert eng.metrics()["aborted"] == 2
    terms = [e for e in eng.session.token_events if e.is_terminal]
    assert sorted(e.rid for e in terms) == [0, 1]
    s = eng.session
    assert s.allocator.free_pages == s.num_pages
    assert not eng.has_work()


# ---------------------------------------------------------------------------
# latency stats, scheduler policy (host only)
# ---------------------------------------------------------------------------

def test_latency_stats_match_reference():
    rng = np.random.default_rng(3)
    evs, subs = [], {}
    for rid in range(5):
        subs[rid] = float(rng.uniform(0, 1))
        t = subs[rid]
        for i in range(int(rng.integers(1, 6))):
            t += float(rng.uniform(0, 0.1))
            evs.append((rid, int(rng.integers(0, 99)), i, None, t))
        evs.append((rid, None, i + 1, "length", t))
    evs.sort(key=lambda e: e[4])
    got = TA.latency_stats([TA.TokenEvent(*e) for e in evs], subs)
    want = JA.latency_stats([JA.TokenEvent(*e) for e in evs], subs)
    assert got == want and got["n_token_events"] > 0
    assert TA.latency_stats([], {})["ttft_p50_s"] is None
    assert TA.FINISH_REASONS == JA.FINISH_REASONS
    for q in (0.0, 0.5, 0.95, 1.0):
        vals = list(rng.uniform(0, 1, 7))
        assert TA._pctl(vals, q) == JA._pctl(vals, q)


def _admit_order(mod):
    s = mod.Scheduler(num_slots=1, max_seq=64)
    order = []

    def finish():
        s.promote(0)
        assert s.record_tokens({0: 1})
    s.submit(mod.Request(rid=0, prompt_len=4, max_new_tokens=2))
    order += [r.rid for _, r in s.admit()]
    s.submit(mod.Request(rid=1, prompt_len=4, max_new_tokens=2))
    s.submit(mod.Request(rid=2, prompt_len=4, max_new_tokens=2, priority=5))
    s.submit(mod.Request(rid=3, prompt_len=4, max_new_tokens=2, priority=5))
    for _ in range(2):
        finish()
        order += [r.rid for _, r in s.admit()]
    s.submit(mod.Request(rid=4, prompt_len=4, max_new_tokens=2))
    s.preempt(0)
    order += [r.rid for _, r in s.admit()]
    for _ in range(2):
        finish()
        order += [r.rid for _, r in s.admit()]
    return order


def test_priority_admission_matches_reference():
    """Counterpart of ``test_priority_admission_fifo_within_class``."""
    assert _admit_order(TS) == _admit_order(JS) == [0, 2, 3, 3, 1, 4]


def test_scheduler_abort_queued_and_running():
    s = TS.Scheduler(num_slots=1, max_seq=64)
    s.submit(TS.Request(rid=0, prompt_len=4, max_new_tokens=4))
    s.submit(TS.Request(rid=1, prompt_len=4, max_new_tokens=4))
    s.admit()
    assert s.abort(1) and s.abort(0) and not s.abort(7)
    assert sorted(r.rid for r in s.finished) == [0, 1]
    assert all(r.finish_reason == "abort" for r in s.finished)
    assert not s.running and not s.queue and not s.slots[0].active


def test_sampling_params_request_fields():
    sp = TA.SamplingParams(max_tokens=7, temperature=0.5, top_k=3,
                           top_p=0.9, seed=11, eos_token_ids=[1],
                           stop_token_ids=[2, 3], priority=4)
    r = sp.request(5, 12)
    assert (r.rid, r.prompt_len, r.max_new_tokens, r.temperature, r.top_k,
            r.top_p, r.seed, r.priority) == (5, 12, 7, 0.5, 3, 0.9, 11, 4)
    assert r.stop_set == frozenset({1, 2, 3}) and r.sampling
    assert [f.name for f in dataclasses.fields(TA.SamplingParams)] == \
        [f.name for f in dataclasses.fields(JA.SamplingParams)]
