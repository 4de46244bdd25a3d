"""The continuous-batching serve session against the reference's on the
CPU (smoke config, fp32, paged host tier, 2 slots, ``max_seq`` 32, prefill
chunks of 8, the same ``prompt_fn`` given to both packages).

* whole ``ServeSession.run``s, bucketed and warmup prefill on bf16 and
  int8 tiers: the emitted streams, finished rids, rounds, decode tokens,
  miss rows, page counts and pool stamps **equal** to the reference's —
  the counterparts of ``test_compiled_serve`` / ``test_paged_cache``'s
  serve-loop tests (the ``_requests()`` mix, its sampled request
  included);
* the decode and prefill round functions from one state against the
  reference's ``_decode_round_fn`` / ``_prefill_round_fn``: tokens equal,
  state leaves equal (floats at rtol/atol 1e-5);
* one host fetch per decode round (the fetch monkeypatched);
* the port's step modules hold no host sync (ESS002 of
  ``repro_torch.analysis.lint``, over the cluster and the API too; the
  card's own check, under ``torch.cuda.set_sync_debug_mode("error")``, is in
  ``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro.serving import step as JSP
from repro.serving.scheduler import Request as JReq
from repro_torch.analysis.lint import ess002_modules, host_syncs
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import lru_pool as LP
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving import state as TES
from repro_torch.serving.scheduler import Request as TReq

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file
# the reference's many eager compiles at XLA's quick settings
pytestmark = pytest.mark.usefixtures("quick_xla")

CFG = "deepseek-v32-exp-ess-smoke"
NUM_SLOTS, MAX_SEQ, CHUNK = 2, 32, 8
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    jcfg = dataclasses.replace(jget(CFG), param_dtype=jnp.float32)
    tcfg = dataclasses.replace(tget(CFG), param_dtype=torch.float32)
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def prompt_fn(req):
    rng = np.random.default_rng(100 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


def requests(R):
    """``test_compiled_serve._requests()``: rid 3 samples."""
    return [R(rid=0, prompt_len=10, max_new_tokens=5),
            R(rid=1, prompt_len=8, max_new_tokens=3),
            R(rid=2, prompt_len=13, max_new_tokens=6),
            R(rid=3, prompt_len=9, max_new_tokens=4, temperature=0.8,
              top_k=64, top_p=0.95, seed=123)]


def with_tier(cfg, tier):
    return dataclasses.replace(cfg, ess=dataclasses.replace(
        cfg.ess, host_cache_dtype=tier))


def sessions(model, tier="bf16", **kw):
    jcfg, tcfg, jp, tp = model
    jcfg, tcfg = with_tier(jcfg, tier), with_tier(tcfg, tier)
    js = JE.ServeSession(jp, jcfg, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                         prompt_fn=prompt_fn, prefill_chunk=CHUNK, **kw)
    ts = TE.ServeSession(tp, tcfg, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                         prompt_fn=prompt_fn, prefill_chunk=CHUNK,
                         compiled=False, device="cpu", **kw)
    return js, ts


def assert_reports(ts, tr, js, jr):
    assert ts.outputs == js.outputs
    assert tr.finished_rids == jr.finished_rids
    for f in ("rounds", "decode_tokens", "prefill_chunks", "prefill_tokens",
              "h2d_rows", "d2h_rows", "fill_rounds", "admissions_blocked",
              "peak_pages_in_use", "num_pages", "ttft_rounds",
              "finish_reasons", "rejected", "aborted"):
        assert getattr(tr, f) == getattr(jr, f), f
    assert [(e.rid, e.token, e.index, e.finish_reason)
            for e in ts.token_events] == \
        [(e.rid, e.token, e.index, e.finish_reason) for e in js.token_events]
    np.testing.assert_array_equal(ts.caches.lens.numpy(),
                                  np.asarray(js.caches.lens))


def assert_cache_state(ts, js):
    """Block tables and every layer's pool maps and LRU stamps equal."""
    np.testing.assert_array_equal(ts.caches.block_tables.numpy(),
                                  np.asarray(js.caches.block_tables))
    for tp, jp in zip(ts.caches.pools, js.caches.pools):
        for f in ("ids", "last_use", "slot_of", "step"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          np.asarray(getattr(jp, f)), f)


def pool_stamps(s) -> list[np.ndarray]:
    """Every layer's resident ``(id, LRU stamp)`` pairs per slot, sorted,
    and its clock, copied to the host.  Which pool entry an id lands in is
    left out: on the int8 tier two ids admitted in one tick can trade
    entries between the packages (their stamps and the set agree)."""
    out = []
    for p in s.caches.pools:
        ids, lu = np.array(p.ids), np.array(p.last_use)
        order = np.lexsort((lu, ids), axis=-1)
        out += [np.take_along_axis(ids, order, -1),
                np.take_along_axis(lu, order, -1), np.array(p.step)]
    return out


# the session's two prefill modes (bucketed chunks with the first token on
# the device; ragged chunks with the LRU-warmup replay grafted into the
# shared pool and the first token on the host), on both tier dtypes
MODES = pytest.mark.parametrize(
    "do_warmup,tier", [(False, "bf16"), (True, "bf16"), (False, "int8"),
                       (True, "int8")],
    ids=["bucketed-bf16", "warmup-bf16", "bucketed-int8", "warmup-int8"])


@MODES
def test_serve_run_streams_match_reference(model, do_warmup, tier):
    """Counterpart of ``test_compiled_eager_stream_parity`` (Q = 1, TBO
    off): the same mix, the same streams, counts and cache state."""
    js, ts = sessions(model, tier, do_warmup=do_warmup)
    jtrace, ttrace = [], []
    jr = js.run(requests(JReq), max_rounds=120,
                on_round=lambda s, r: jtrace.append(pool_stamps(s)))
    tr = ts.run(requests(TReq), max_rounds=120,
                on_round=lambda s, r: ttrace.append(pool_stamps(s)))
    assert sorted(tr.finished_rids) == [0, 1, 2, 3]
    assert_reports(ts, tr, js, jr)
    assert_cache_state(ts, js)
    # the pools after every round: released slots are reset by the end, so
    # the warmup's window order and clamped stamps show only mid-run
    assert len(ttrace) == len(jtrace)
    for rnd, (t, j) in enumerate(zip(ttrace, jtrace)):
        for f, (a, b) in enumerate(zip(t, j)):
            np.testing.assert_array_equal(a, b, f"round {rnd} field {f}")
    assert tr.pool_hit_rate > 0 and tr.hit_rows > 0


def test_serve_loop_streams_requests_page_gated(model):
    """Counterpart of ``test_paged_cache``'s: 4 requests through 2 slots on
    3 host pages; the byte gate engages, every page returns."""
    js, ts = sessions(model, num_host_pages=3)
    reqs = [(0, 12, 4), (1, 12, 4), (2, 24, 8), (3, 24, 8)]
    samples = []

    def on_round(s, rnd):
        samples.append(s.num_pages - s.allocator.free_pages)
    jr = js.run([JReq(rid=r, prompt_len=p, max_new_tokens=m)
                 for r, p, m in reqs], max_rounds=80)
    tr = ts.run([TReq(rid=r, prompt_len=p, max_new_tokens=m)
                 for r, p, m in reqs], max_rounds=80, on_round=on_round)
    assert sorted(tr.finished_rids) == [0, 1, 2, 3]
    assert tr.admissions_blocked > 0
    assert tr.peak_pages_in_use <= tr.num_pages == 3
    assert tr.peak_pages_in_use >= max(samples)
    assert ts.allocator.free_pages == 3
    assert (ts.caches.block_tables == -1).all()
    assert_reports(ts, tr, js, jr)


def test_host_byte_budget_gates_admission(model):
    """Admission counted in bytes: a budget of 3 pages' bytes gives the
    same pool and the same run as ``num_host_pages=3``."""
    _, tcfg, _, tp = model
    page = LC.host_page_bytes(tcfg, torch.float32)
    ts = TE.ServeSession(tp, tcfg, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                         prompt_fn=prompt_fn, prefill_chunk=CHUNK,
                         compiled=False, device="cpu",
                         host_byte_budget=3 * page + page - 1)
    tr = ts.run([TReq(rid=0, prompt_len=24, max_new_tokens=8),
                 TReq(rid=1, prompt_len=24, max_new_tokens=8),
                 TReq(rid=2, prompt_len=40, max_new_tokens=8)])
    assert ts.num_pages == 3 and tr.admissions_blocked > 0
    assert tr.finish_reasons == {0: "length", 1: "length", 2: "rejected"}


@MODES
def test_preempt_readmit_no_stale_pool_entries(model, do_warmup, tier):
    """Counterpart of ``test_paged_cache``'s: a preempted slot is fully
    reset (pool maps, lens), the re-admission serves only its own latents,
    and the whole run matches the reference's step for step."""
    js, ts = sessions(model, tier, do_warmup=do_warmup)
    for s, R in ((js, JReq), (ts, TReq)):
        for i in range(3):
            s.submit(R(rid=i, prompt_len=12, max_new_tokens=4))
        s.admit()
        s.prefill_round()
        s.prefill_round()
        s.decode_round()
        s.preempt(1)
    for p in ts.caches.pools:
        assert (p.ids[1] == -1).all() and (p.slot_of[1] == -1).all()
    assert int(ts.caches.lens[1]) == 0
    assert [(s, r.rid) for s, r in ts.admit()] == \
        [(s, r.rid) for s, r in js.admit()] == [(1, 1)]
    for s in (js, ts):
        s.prefill_round()
        s.prefill_round()
        s.decode_round()
    assert_cache_state(ts, js)
    host = LC.slot_latents(ts.caches, 1)
    for layer, p in enumerate(ts.caches.pools):
        live = p.ids[1] >= 0
        assert live.any()
        assert torch.equal(p.data[1][live],
                           host[layer, p.ids[1][live]].to(p.data.dtype))
        assert LP.check_consistent(p)
    jr, tr = js.run(max_rounds=60), ts.run(max_rounds=60)
    assert sorted(tr.finished_rids) == [0, 1, 2]
    assert_reports(ts, tr, js, jr)
    assert_cache_state(ts, js)


def test_max_new_tokens_one_finishes_at_promotion(model):
    """The first token is the whole budget: one decode round (the one whose
    fetch carries it) runs and delivers nothing more."""
    js, ts = sessions(model)
    jr = js.run([JReq(rid=0, prompt_len=8, max_new_tokens=1)],
                max_rounds=10)
    tr = ts.run([TReq(rid=0, prompt_len=8, max_new_tokens=1)],
                max_rounds=10)
    assert tr.finished_rids == [0] and len(ts.outputs[0]) == 1
    assert tr.rounds == 1 and tr.decode_tokens == 0
    assert_reports(ts, tr, js, jr)


def test_stop_token_abort_and_reject_lifecycle(model):
    """A stop token ends a stream at its position, an abort and an
    oversize request each end with one terminal event — as the
    reference's session does."""
    out = []
    for R, s in zip((JReq, TReq), sessions(model)):
        s.submit(R(rid=0, prompt_len=10, max_new_tokens=8))
        s.submit(R(rid=1, prompt_len=9, max_new_tokens=8))
        s.submit(R(rid=2, prompt_len=30, max_new_tokens=8))
        s.step()
        s.step()
        s.abort(1)
        first = s.outputs[0]
        s.submit(R(rid=3, prompt_len=10, max_new_tokens=8,
                   eos_token_ids=tuple(first[:1])))
        s.run(max_rounds=60)
        out.append(({k: v for k, v in s.outputs.items()},
                    s.report.finish_reasons,
                    [(e.rid, e.finish_reason) for e in s.token_events
                     if e.is_terminal]))
    assert out[0] == out[1]
    assert sorted(r for r, _ in out[1][2]) == [0, 1, 2, 3]


def test_sampled_request_served(model):
    """A sampled request is served (the port once refused it): its stream
    is the reference's, first token included (the prefill's device draw
    at emission index 0); ``compiled=True`` still needs the card."""
    js, ts = sessions(model)
    for s, R in ((js, JReq), (ts, TReq)):
        s.run([R(rid=9, prompt_len=8, max_new_tokens=4, temperature=0.8,
                 seed=1)], max_rounds=20)
    assert ts.outputs == js.outputs and len(ts.outputs[9]) == 4
    assert ts.report.finish_reasons == {9: "length"}
    with pytest.raises(ValueError, match="CUDA"):
        TE.ServeSession(model[3], model[1], num_slots=1, max_seq=MAX_SEQ,
                        device="cpu").run([TReq(0, 8, 2)])


def test_default_prompt_is_seeded():
    tcfg = dataclasses.replace(tget(CFG), param_dtype=torch.float32)
    s = TE.ServeSession({}, tcfg, num_slots=1, max_seq=MAX_SEQ,
                        compiled=False, device="cpu")
    a = s._default_prompt(TReq(rid=5, prompt_len=7, max_new_tokens=1))
    b = s._default_prompt(TReq(rid=5, prompt_len=7, max_new_tokens=1))
    assert a.shape == (1, 7) and torch.equal(a, b)
    assert int(a.max()) < tcfg.vocab_size


def test_decode_round_single_fetch(model, monkeypatch):
    """Counterpart of ``test_compiled_decode_round_single_device_get``."""
    _, ts = sessions(model)
    for r in (TReq(rid=0, prompt_len=8, max_new_tokens=8),
              TReq(rid=1, prompt_len=8, max_new_tokens=8)):
        ts.submit(r)
    ts.step()
    ts.step()
    calls = []
    real = TE.device_get
    monkeypatch.setattr(TE, "device_get",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    for _ in range(3):
        ts.decode_round()
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# Round functions from one state
# ---------------------------------------------------------------------------

def _to_port_state(jstate, tcfg):
    """The reference's EngineState as the port's (numpy leaves)."""
    js = jax.tree.map(np.asarray, jstate)
    caches = LC.from_jax_caches(js.caches)
    return TES.EngineState(
        caches=caches, tok=array_to_torch(js.tok).long(),
        hidden=array_to_torch(js.hidden),
        temperature=array_to_torch(js.temperature),
        top_k=array_to_torch(js.top_k), top_p=array_to_torch(js.top_p),
        seed=array_to_torch(js.seed),
        emit_index=array_to_torch(js.emit_index),
        slot_mask=array_to_torch(js.slot_mask),
        sample_mask=array_to_torch(js.sample_mask))


def _assert_state(ts, js):
    js = jax.tree.map(np.asarray, js)
    for f in ("tok", "emit_index", "slot_mask"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), getattr(js, f),
                                      f)
    np.testing.assert_allclose(ts.hidden.numpy(), js.hidden, **TOL)
    tc, jc = ts.caches, js.caches
    np.testing.assert_array_equal(tc.lens.numpy(), jc.lens)
    np.testing.assert_allclose(tc.host_latent.numpy(), jc.host_latent, **TOL)
    for layer, (tp, jp) in enumerate(zip(tc.pools, jc.pools)):
        np.testing.assert_allclose(tc.ikeys[layer].numpy(), jc.ikeys[layer],
                                   **TOL)
        for f in ("ids", "last_use", "slot_of", "step"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          getattr(jp, f), f)
        np.testing.assert_allclose(tp.data.numpy(), jp.data, **TOL)


def test_round_functions_match_reference(model):
    """From the reference session's state after a few rounds (one slot
    decoding, one mid-prefill): the port's decode round and last prefill
    chunk against the reference's round functions on the same state."""
    jcfg, tcfg, jp, tp = model
    js, _ = sessions(model)
    js.submit(JReq(rid=0, prompt_len=9, max_new_tokens=8))
    js.submit(JReq(rid=1, prompt_len=12, max_new_tokens=8))
    for _ in range(3):
        js.step()
    progs = JSP.get_programs(jcfg, NUM_SLOTS, MAX_SEQ, False, False, 0)
    tprogs = TE.SP.StepPrograms(tcfg, device="cpu")

    # a decode round: slot 0 live, slot 1 mid-prefill (frozen); the
    # reference's compiled program (already built by the runs above)
    # donates the state, so the port's copy is taken first
    ts = _to_port_state(js.state, tcfg)
    jstate, jout = progs.decode(True)(jp, js.state)
    tout = TES.init_round_out(NUM_SLOTS, 1, "cpu")
    tprogs.decode(False)(tp, ts, tout)
    np.testing.assert_array_equal(tout.tokens.numpy(), np.asarray(jout.tokens))
    np.testing.assert_array_equal(tout.n_emit.numpy(), np.asarray(jout.n_emit))
    assert int(tout.h2d_rows) == int(jout.h2d_rows)
    _assert_state(ts, jstate)

    # slot 1's last chunk: 4 valid of a bucket of 4 after 8 prefilled
    task = js._prefill[1]
    ck = 12 - task.cursor
    C = JSP.chunk_bucket(ck, CHUNK)
    toks = np.zeros((1, C), np.int32)
    toks[:, :ck] = np.asarray(task.tokens)[:, task.cursor:]
    jstate, jt0 = progs.prefill(C, True, True)(
        jp, jstate, jnp.asarray(toks), jnp.asarray(1, jnp.int32),
        jnp.asarray(ck, jnp.int32))
    tt0 = tprogs.prefill(C, True)(tp, ts, torch.tensor(toks).long(), 1, ck)
    assert int(tt0) == int(jt0)
    _assert_state(ts, jstate)

    # teacher-forced: the logits of the next decode step from both states
    jo = jax.jit(JE.ess_decode, static_argnums=(1,))(
        jp, jcfg, jstate.tok[:, None], jstate.caches.lens[:, None],
        jstate.caches, slot_mask=jstate.slot_mask)
    to = TE.ess_decode(tp, tcfg, ts.tok[:, None], ts.caches.lens[:, None],
                       ts.caches, slot_mask=ts.slot_mask)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               **TOL)


# ---------------------------------------------------------------------------
# No host sync in the step modules (ESS002, repro_torch.analysis.lint)
# ---------------------------------------------------------------------------

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
# the modules a round, a prefill chunk, a pack or an install runs through
# (the cluster and the API included); the host-side definitions
# (check_consistent, generate_batch, ServeSession) are exempt
STEP_MODULES = ess002_modules(PKG)


@pytest.mark.parametrize("path", STEP_MODULES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_step_modules_hold_no_host_sync(path):
    assert host_syncs(path.read_text(), str(path)) == []


def test_host_sync_check_flags_each_form():
    src = ("def step(x, t):\n"
           "    a = torch.tensor(1.0, device=x.device)\n"
           "    b = t.item() + len(t.tolist())\n"
           "    t[0] = -1\n"
           "    t[1].fill_(-1)\n"
           "    return t.cpu()\n"
           "def check_consistent(p):\n"
           "    return p.ids.cpu()\n")
    assert host_syncs(src) == ["step:2", "step:3", "step:3", "step:4",
                               "step:6"]
