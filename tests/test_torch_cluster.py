"""The port's PD-disaggregated cluster (``repro_torch.cluster``) against the
reference on the CPU (counterparts of the 10 tests of
``tests/test_cluster.py``).

Smoke config in fp32, ``mtp_depth`` 2 stacked, ``max_miss_ratio`` 1, the
reference's parameters carried across with ``from_jax_params`` and one
``prompt_fn`` given to both packages (the port's sessions eager):

* the port's ``EssCluster`` (1 prefill + 1 decode worker) gives the
  reference ``EssEngine``'s streams bit for bit, greedy and seeded
  sampled, bf16 and int8 tiers, MTP depth 0 and 2 (the reference's own
  test proves its cluster equals its engine);
* the port's migration packet equals the reference ``pack_migration``'s
  (pages, scales, keys, hidden, first token) bit for bit, and the decode
  worker's tier holds the packet's bits verbatim; one host wait per pack;
* ``Scheduler.adopt`` / ``release_migrated`` against the reference
  scheduler; abort mid-handoff, preemption on a decode worker, routing
  around a full worker; the channel and the link model; ``wire_nbytes``;
  the LRU warmup's tails shipped to and replayed on the decode side.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import kv_transfer as JKT
from repro.cluster import workers as JW
from repro.configs import get_config as jget
from repro.distributed import compression as jcmp
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import api as JA
from repro.serving import scheduler as JS
from repro.simulator import costmodel as JCM
from repro_torch.cluster import EssCluster, InterNodeChannel
from repro_torch.cluster import kv_transfer as TKT
from repro_torch.cluster import workers as TW
from repro_torch.configs import get_config as tget
from repro_torch.distributed import compression as tcmp
from repro_torch.models.params import from_jax_params
from repro_torch.serving import api as TA
from repro_torch.serving import scheduler as TS
from repro_torch.simulator import costmodel as TCM

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

CFG = "deepseek-v32-exp-ess-smoke"
MAX_SEQ = 32
PROMPTS = [11, 8, 9, 10]


def params_for(SP):
    return [SP(max_tokens=5), SP(max_tokens=4),
            SP(max_tokens=3, temperature=0.9, seed=5), SP(max_tokens=4)]


def configs(tier="bf16"):
    jc, tc = jget(CFG), tget(CFG)
    ess = dict(max_miss_ratio=1.0, host_cache_dtype=tier)
    return (dataclasses.replace(jc, param_dtype=jnp.float32, mtp_depth=2,
                                ess=dataclasses.replace(jc.ess, **ess)),
            dataclasses.replace(tc, param_dtype=torch.float32, mtp_depth=2,
                                ess=dataclasses.replace(tc.ess, **ess)))


def prompt_fn(req):
    rng = np.random.default_rng(100 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    jcfg, _ = configs()
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


@pytest.fixture(scope="module")
def reference_streams(model):
    """The reference ``EssEngine``'s streams of the workload, by (tier,
    MTP depth), computed once each."""
    jp, _ = model
    done = {}

    def get(tier, depth):
        if (tier, depth) not in done:
            eng = JA.EssEngine(jp, configs(tier)[0], num_slots=2,
                               max_seq=MAX_SEQ, prompt_fn=prompt_fn,
                               mtp_depth=depth)
            outs = eng.generate(PROMPTS, params_for(JA.SamplingParams),
                                max_rounds=300)
            done[tier, depth] = streams(outs)
        return done[tier, depth]
    return get


def streams(outs):
    return [(o.tokens, o.finish_reason) for o in outs]


def cluster(tp, tier="bf16", **kw):
    kw = dict(dict(num_prefill=1, num_decode=1, num_slots=2), **kw)
    return EssCluster(tp, configs(tier)[1], max_seq=MAX_SEQ,
                      prompt_fn=prompt_fn, compiled=False, device="cpu",
                      **kw)


# ---------------------------------------------------------------------------
# streams: the port's cluster against the reference engine, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", ["bf16", "int8"])
@pytest.mark.parametrize("mtp_depth", [0, 2])
def test_pd_stream_parity_bitwise(model, reference_streams, tier,
                                  mtp_depth):
    """Counterpart of the reference's test: 1 prefill + 1 decode worker
    give the reference single engine's streams (greedy and sampled); every
    request migrates once and is installed once."""
    _, tp = model
    clu = cluster(tp, tier, mtp_depth=mtp_depth)
    got = streams(clu.generate(PROMPTS, params_for(TA.SamplingParams),
                               max_rounds=300))
    assert got == reference_streams(tier, mtp_depth)
    m = clu.metrics()
    assert m["migrations"] == len(PROMPTS) == m["installed"]
    assert m["wire_bytes"] > 0 and m["rejected"] == 0
    assert m["finish_reasons"] == {i: "length" for i in range(4)}


def test_pd_warmup_tails_replayed_on_decode_side(model):
    """``do_warmup``: the prefill worker ships the LRU-warmup tails in the
    packet instead of replaying them, the decode worker replays them into
    its own pool; the streams equal the port's single engine's with the
    same warmup (the two decode slots' pool clocks start equal here)."""
    _, tp = model
    clu = cluster(tp, "int8", do_warmup=True, num_decode=2)
    seen = []
    send = clu.channel.send
    clu.channel.send = lambda pkt: (seen.append(pkt), send(pkt))[1]
    got = streams(clu.generate(PROMPTS[:2], params_for(TA.SamplingParams)[:2],
                               max_rounds=300))
    eng = TA.EssEngine(tp, configs("int8")[1], num_slots=2,
                       max_seq=MAX_SEQ, prompt_fn=prompt_fn,
                       do_warmup=True, compiled=False, device="cpu")
    want = streams(eng.generate(PROMPTS[:2],
                                params_for(TA.SamplingParams)[:2],
                                max_rounds=300))
    assert got == want
    tcfg = configs()[1]
    W = tcfg.ess.warmup_windows
    assert len(seen) == 2
    assert all(p.tails is not None and len(p.tails) == tcfg.num_layers
               for p in seen)
    assert all(t.shape[1] == W for p in seen for t in p.tails)
    assert not getattr(clu.prefill[0].session, "migration_tails", {})


# ---------------------------------------------------------------------------
# the packet: bit for bit the reference's; bits land verbatim
# ---------------------------------------------------------------------------

def _promote(session, req):
    """Admit ``req`` and run its prefill chunks until it promotes; returns
    ``(slot, t0)`` from ``_pending_first``."""
    session.submit(req)
    session.admit()
    while not session._pending_first:
        session.prefill_round()
    [(slot, _, t0)] = session._pending_first
    session._pending_first = []
    return slot, t0


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_packet_matches_reference_pack(model, tier, monkeypatch):
    """One prompt prefilled on a port and a reference prefill session (the
    port's prompt rows, keys and hidden within fp32 rounding of the
    reference's); the reference's state is then copied into the port's
    session, and the two ``pack_migration`` packets must agree bit for
    bit: pages, scales, keys, hidden, first token, wire bytes.  The
    port's pack waits on the host exactly once."""
    jp, tp = model
    jcfg, tcfg = configs(tier)
    kw = dict(num_slots=2, max_seq=MAX_SEQ, prompt_fn=prompt_fn,
              prefill_chunk=4)
    js = JW.make_prefill_session()(jp, jcfg, **kw)
    ts = TW.make_prefill_session()(tp, tcfg, compiled=False, device="cpu",
                                   **kw)
    jslot, jt0 = _promote(js, JS.Request(rid=3, prompt_len=11,
                                         max_new_tokens=4))
    slot, t0 = _promote(ts, TS.Request(rid=3, prompt_len=11,
                                       max_new_tokens=4))
    assert slot == jslot and int(t0) == int(jt0)
    assert ts.allocator.owned(slot) == js.allocator.owned(slot)
    tc, jc = ts.caches, js.caches
    pairs = [(tc.host_latent, jc.host_latent), (ts.state.hidden,
                                                js.state.hidden)]
    pairs += list(zip(tc.ikeys, jc.ikeys))
    if tier != "bf16":
        pairs.append((tc.host_scales, jc.host_scales))
    for t, j in pairs:
        if tier == "bf16" or t is tc.host_latent:
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32),
                                       rtol=1e-4, atol=1e-4)
        t.copy_(torch.from_numpy(np.array(j)))
    waits = []
    wait = TKT.host_wait
    monkeypatch.setattr(TKT, "host_wait", lambda d: (waits.append(d),
                                                     wait(d)))
    jreq = js.sched.running[3]
    treq = ts.sched.running[3]
    jpk = JKT.pack_migration(js, slot, jreq, jt0)
    tpk = TKT.pack_migration(ts, slot, treq, torch.tensor([int(jt0)]))
    assert len(waits) == 1
    assert (tpk.rid, tpk.prompt_len, tpk.n_pages, tpk.t0) == \
        (jpk.rid, jpk.prompt_len, jpk.n_pages, jpk.t0)
    np.testing.assert_array_equal(tpk.pages.numpy(), np.asarray(jpk.pages))
    if tier == "bf16":
        assert tpk.scales is None and jpk.scales is None
    else:
        assert tpk.pages.dtype == torch.int8
        np.testing.assert_array_equal(tpk.scales.numpy(),
                                      np.asarray(jpk.scales))
    assert len(tpk.ikeys) == len(jpk.ikeys)
    for a, b in zip(tpk.ikeys, jpk.ikeys):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tpk.hidden.numpy(), np.asarray(jpk.hidden))
    assert tpk.wire_bytes == jpk.wire_bytes
    # the slot's pages return to the allocator at release
    free = ts.allocator.free_pages
    ts.sched.release_migrated(slot)
    assert ts.allocator.free_pages == free + len(js.allocator.owned(slot))


def test_migration_moves_quantized_pages_verbatim(model):
    """Counterpart of the reference's test: no dequant / requant round
    trip; the decode worker's prompt rows and scales are the packet's
    bits; the prefill side released everything at pack."""
    _, tp = model
    clu = cluster(tp, "int8", channel=InterNodeChannel(delay_steps=1))
    captured = []
    send = clu.channel.send
    clu.channel.send = lambda pkt: (captured.append(pkt), send(pkt))[1]
    pre = clu.prefill[0].session.allocator
    total = pre.free_pages
    rid = clu.submit(11, TA.SamplingParams(max_tokens=4))
    for _ in range(50):
        if clu.decode[0].installed:
            break
        clu.step()
    assert captured and clu.decode[0].installed
    pkt = captured[0]
    assert pkt.pages.dtype == torch.int8 and pkt.scales is not None
    assert pre.free_pages == total
    s = clu.decode[0].session
    slot = next(i for i, sl in enumerate(s.sched.slots)
                if sl.active and sl.rid == rid)
    ids = s.allocator.owned(slot)[:pkt.n_pages]
    host = s.caches.host_latent[:, ids]
    scales = s.caches.host_scales[:, ids]
    R = pkt.pages.shape[2]
    for p in range(pkt.n_pages):
        rows = min(max(pkt.prompt_len - p * R, 0), R)
        assert torch.equal(host[:, p, :rows], pkt.pages[:, p, :rows])
        assert torch.equal(scales[:, p, :rows], pkt.scales[:, p, :rows])


def test_install_writes_state_in_place(model):
    """``install_migration`` rebinds nothing the decode round's graph
    reads: ``lens``, keys, block tables, token and hidden are the same
    tensors after the install, holding the packet's values."""
    _, tp = model
    clu = cluster(tp)
    pw, dw = clu.prefill[0], clu.decode[0]
    s = dw.session
    before = (s.caches.lens, s.caches.block_tables, s.state.tok,
              s.state.hidden, *s.caches.ikeys)
    pw.submit(TS.Request(rid=0, prompt_len=11, max_new_tokens=4))
    pkts = []
    while not pkts:
        pkts = pw.step()[1]
    [pkt] = pkts
    slot = dw.install(pkt)
    after = (s.caches.lens, s.caches.block_tables, s.state.tok,
             s.state.hidden, *s.caches.ikeys)
    assert all(a is b for a, b in zip(before, after))
    assert int(s.caches.lens[slot]) == 11
    assert int(s.state.tok[slot]) == pkt.t0 == s.outputs[0][0]
    assert torch.equal(s.state.hidden[slot], pkt.hidden)
    for k, ik in zip(s.caches.ikeys, pkt.ikeys):
        assert torch.equal(k[slot, :11], ik)
    assert bool(s.state.slot_mask[slot])


# ---------------------------------------------------------------------------
# the handoff edges of the scheduler, against the reference's
# ---------------------------------------------------------------------------

def _handoff(mod):
    released = []
    s = mod.Scheduler(num_slots=2, max_seq=64,
                      release_hook=released.append)
    s.submit(mod.Request(rid=0, prompt_len=5, max_new_tokens=3))
    s.admit()
    s.promote(0)
    req = s.release_migrated(0)
    got = [(req.rid, req.slot, req.finished, s.slots[0].active,
            list(s.running), list(released))]
    d = mod.Scheduler(num_slots=2, max_seq=64)
    d.slots[0].active = True
    d.adopt(req, 1)
    st = d.slots[1]
    got.append((req.slot, req.finished, st.rid, st.active, st.len, st.phase,
                st.first_emitted, list(d.running), d.budget_left(1)))
    got.append([r.rid for r in d.record_tokens({1: 1})] + [d.remaining(1)])
    got.append([r.rid for r in d.record_tokens({1: 1})])
    return got


def test_adopt_and_release_migrated_match_reference():
    assert _handoff(TS) == _handoff(JS)


# ---------------------------------------------------------------------------
# lifecycle: abort mid-handoff, preempt on the decode worker
# ---------------------------------------------------------------------------

def test_abort_mid_handoff_frees_both_workers(model):
    _, tp = model
    clu = cluster(tp, channel=InterNodeChannel(delay_steps=3))
    pa = clu.prefill[0].session.allocator
    da = clu.decode[0].session.allocator
    total_p, total_d = pa.free_pages, da.free_pages
    rid = clu.submit(11, TA.SamplingParams(max_tokens=4))
    for _ in range(50):
        if clu.channel.in_flight:
            break
        clu.step()
    assert clu.channel.in_flight
    assert pa.free_pages == total_p      # released at pack, not at abort
    assert clu.abort(rid)
    assert not clu.channel.in_flight
    assert clu.is_finished(rid) and clu.finish_reason(rid) == "abort"
    assert pa.free_pages == total_p and da.free_pages == total_d
    assert clu.decode[0].installed == 0 and not clu.has_work()
    evs = list(clu.stream(rid))
    assert evs and evs[-1].is_terminal
    assert clu.output(rid).finish_reason == "abort"
    assert clu.metrics()["aborted"] == 1


def test_preempt_on_decode_worker_replays_stream(model, reference_streams):
    """A preemption inside a decode worker requeues and re-prefills there;
    the stream restarts from index 0 and still equals the reference
    engine's for that request."""
    _, tp = model
    clu = cluster(tp)
    rid = clu.submit(11, params_for(TA.SamplingParams)[0])
    for _ in range(50):
        if len(clu._outputs.get(rid, [])) >= 3:
            break
        clu.step()
    assert clu.decode[0].owns(rid)
    s = clu.decode[0].session
    slot = next(i for i, sl in enumerate(s.sched.slots)
                if sl.active and sl.rid == rid)
    s.preempt(slot)
    for _ in range(100):
        if clu.is_finished(rid):
            break
        clu.step()
    out = clu.output(rid)
    assert (out.tokens, out.finish_reason) == reference_streams("bf16", 0)[0]


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def test_pick_decode_worker_policy():
    def loads(mod, rows):
        return [mod.WorkerLoad(worker=i, free_host_bytes=b, free_slots=f,
                               queued=q) for i, (b, f, q) in enumerate(rows)]
    cases = [([(100, 1, 0), (500, 1, 3), (500, 1, 1)], 50),
             ([(10, 1, 0), (900, 0, 0)], 50), ([], 1),
             ([(64, 1, 2), (64, 1, 2)], 1)]
    got = [TS.pick_decode_worker(loads(TS, r), n) for r, n in cases]
    assert got == [JS.pick_decode_worker(loads(JS, r), n) for r, n in cases]
    assert got == [2, None, None, 0]


def test_router_routes_around_full_worker(model):
    _, tp = model
    clu = cluster(tp, num_decode=2,
                  decode_overrides=[{"num_host_pages": 1}, None])
    outs = clu.generate([9, 10], TA.SamplingParams(max_tokens=3),
                        max_rounds=300)
    assert all(o.finish_reason == "length" for o in outs)
    assert clu.decode[0].installed == 0 and clu.decode[1].installed == 2
    assert clu.metrics()["rejected"] == 0


# ---------------------------------------------------------------------------
# the simulated channel and the link model
# ---------------------------------------------------------------------------

class _FakePacket:
    def __init__(self, rid, nbytes):
        self.rid = rid
        self.wire_bytes = nbytes


def test_channel_delay_order_and_cancel():
    ch = InterNodeChannel(delay_steps=2)
    ch.send(_FakePacket(0, 10))
    ch.send(_FakePacket(1, 10))
    assert ch.tick() == []
    assert [p.rid for p in ch.tick()] == [0, 1]
    ch.send(_FakePacket(5, 10))
    assert ch.cancel(5) and not ch.in_flight
    assert ch.tick() == [] and ch.tick() == []
    assert ch.packets_sent == 3 and ch.payload_bytes == 30


def test_channel_costmodel_delay_quantizes_to_steps():
    model = TCM.InterNodeModel(bandwidth=1e9, latency_s=0.0, row_bytes=1)
    ch = InterNodeChannel(model=model, step_time_s=1e-3)
    assert ch.delay_for(_FakePacket(0, 2_000_000)) == 2
    assert ch.delay_for(_FakePacket(0, 1)) == 1
    ch.send(_FakePacket(0, 2_000_000))
    assert ch.sim_transfer_s == pytest.approx(2e-3)
    jch = JKT.InterNodeChannel(
        model=JCM.InterNodeModel(bandwidth=1e9, latency_s=0.0, row_bytes=1),
        step_time_s=1e-3)
    for n in (1, 999_999, 1_000_001, 7_777_777):
        assert ch.delay_for(_FakePacket(0, n)) == \
            jch.delay_for(_FakePacket(0, n))


def test_internode_costmodel_terms():
    from repro.simulator.hardware import H800_EP32 as hw
    jm = JCM.internode_model(hw)
    tm = TCM.InterNodeModel(bandwidth=jm.bandwidth, latency_s=jm.latency_s,
                            row_bytes=jm.row_bytes)
    assert (TCM.N_LAYERS, TCM.LATENT_BYTES, TCM.IDX_BYTES) == \
        (JCM.N_LAYERS, JCM.LATENT_BYTES, JCM.IDX_BYTES)
    for rows in (1.0, 2048.0, 0.43 * 32768):
        assert tm.packet_bytes(rows) == jm.packet_bytes(rows)
        assert tm.transfer_time(rows) == jm.transfer_time(rows)
        assert tm.packet_bytes(rows, 4) == jm.packet_bytes(rows, 4)
    assert 0 < tm.transfer_time(0.43 * 32768) < 1.0


def test_wire_nbytes_skips_missing_planes():
    a = np.zeros((2, 3), np.int8)
    s = np.zeros((2, 1), np.float16)
    ta, ts = torch.zeros((2, 3), dtype=torch.int8), torch.zeros(
        (2, 1), dtype=torch.float16)
    assert tcmp.wire_nbytes(ta, None, ts) == jcmp.wire_nbytes(a, None, s) \
        == a.nbytes + s.nbytes


# ---------------------------------------------------------------------------
# the migration's page copies (plain versions) against the reference's
# indexing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["f32", "int8", "fp8"])
@pytest.mark.parametrize("n", [1, 3])
def test_tier_page_copies_match_reference_indexing(name, n):
    """``offload.gather_tier_pages`` is the reference pack's
    ``host_latent[:, ids]`` (and ``host_scales[:, ids]``) and
    ``put_tier_pages`` its install's ``.at[:, new_ids].set``, bit for bit,
    on both planes of a tier [L, NP, R, D]; ``gather_pages`` with
    ``scales=`` and ``put_pages`` agree with ``gather_pages_ref``."""
    from repro_torch.core import offload
    from repro_torch.kernels.gather_cache import ops as gops
    from repro_torch.kernels.gather_cache import ref as gref
    rng = np.random.default_rng(7)
    Lh, NP, R, D = 3, 6, 8, 32
    x = rng.standard_normal((Lh, NP, R, D)).astype(np.float32)
    if name == "f32":
        tier, sc = torch.from_numpy(x), None
    else:
        q, s = tcmp.quantize_rows(torch.from_numpy(x),
                                  tcmp.CACHE_QUANT_DTYPES[name])
        tier, sc = q, s
    ids = rng.permutation(NP)[:n]
    pages = torch.empty((Lh, n, R, D), dtype=tier.dtype)
    scales = None if sc is None else torch.empty((Lh, n, R, 1),
                                                 dtype=torch.float16)
    offload.gather_tier_pages(tier, sc, torch.from_numpy(ids), pages, scales)

    def bits(t):
        return t.view(torch.uint8 if t.element_size() == 1
                      else torch.int16 if t.element_size() == 2
                      else torch.int32).numpy()

    # the reference pack's indexing, in jnp, of the tier's stored bits
    jt = jnp.asarray(bits(tier))
    np.testing.assert_array_equal(bits(pages),
                                  np.asarray(jt[:, jnp.asarray(ids)]))
    if sc is not None:
        np.testing.assert_array_equal(
            bits(scales), np.asarray(jnp.asarray(bits(sc))[:, ids]))
    # the install: the packet's pages into fresh page ids of another tier
    dst = torch.zeros_like(tier)
    dsc = None if sc is None else torch.zeros_like(sc)
    new = rng.permutation(NP)[:n]
    offload.put_tier_pages(dst, dsc, torch.from_numpy(new), pages, scales)
    want = np.zeros_like(bits(tier))
    want[:, new] = bits(pages)
    np.testing.assert_array_equal(bits(dst), want)
    if sc is not None:
        wsc = np.zeros_like(bits(sc))
        wsc[:, new] = bits(scales)
        np.testing.assert_array_equal(bits(dsc), wsc)
    # the wrappers alone: scales ride along; out-of-range ids clip / drop
    flat, fsc = tier.view(Lh, NP * R, D), None if sc is None else \
        sc.view(Lh, NP * R, 1)
    pid = torch.tensor([NP + 3, -2, 1])
    got = gops.gather_pages(flat, pid, R, scales=fsc)
    want_p = gref.gather_pages_ref(flat, pid[None].expand(Lh, -1), R)
    if sc is None:
        assert torch.equal(got, want_p)
    else:
        assert np.array_equal(bits(got[0]), bits(want_p))
        assert torch.equal(got[1], gref.gather_pages_ref(
            fsc, pid[None].expand(Lh, -1), R))
    before = dst.clone()
    gops.put_pages(dst.view(Lh, NP * R, D), torch.tensor([-1, NP]),
                   torch.ones((Lh, 2 * R, D)).to(tier.dtype), R)
    assert torch.equal(dst.view(torch.uint8), before.view(torch.uint8))
