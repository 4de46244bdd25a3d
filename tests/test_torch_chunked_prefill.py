"""Chunked prefill, masked decode slots and long-prompt admission on the
port, against the reference (counterparts of ``tests/test_chunked_prefill.py``
and of ``test_compiled_serve.py::test_ttft_submit_stamp_unconditional``).

Parameters come from the reference's ``init_params`` through
``from_jax_params``; prompts and decode tokens from seeded numpy, the same
arrays for both packages.  The port's prefill updates its caches in place,
so every test that compares a state before and after works on clones.

* ``ess_prefill`` in chunks of 7 and 64 is **bit for bit** the one-shot
  prefill (host rows, indexer keys, lens, logits, the first token) at the
  reference's bf16 parameters; the one-shot prefill is held against the
  reference's (fp32 at rtol/atol 1e-5, bf16 logits at 5e-2 and the first
  token equal, as ``tests/test_torch_serving.py`` holds them).  At fp32
  the CPU's products of other shapes sum in another order, so there the
  chunked prefill is held to the one-shot one at 1e-5.
* A ``ServeSession``'s in-place chunked prefill (chunk 7, warmup path)
  reproduces the one-shot prefill's host rows and first token bit for bit
  (bf16), and its first token is the reference session's.
* A masked slot writes nothing: a fully masked decode leaves host tier,
  lens, pools and indexer keys unchanged; a freed slot whose block table
  aliases a live slot's pages writes nothing through it (and, unmasked,
  does: the phantom write the mask prevents); a freed slot of the serve
  loop stays reset through later rounds.
* A 32K-token prompt admits in 4096-token chunks while the other slot
  keeps decoding (the reference test's nano config, port alone).
* The LRU warmup's pools do not depend on the prefill chunk; the TTFT
  stamp is the submit's, and a request never submitted raises at delivery.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import latent_cache as JLC
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro.serving.scheduler import Request as JReq
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.configs.base import DSAConfig
from repro_torch.core import lru_pool as LP
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import Request as TReq

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file
# the reference's many eager compiles at XLA's quick settings
pytestmark = pytest.mark.usefixtures("quick_xla")

CFG = "deepseek-v32-exp-ess-smoke"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=5e-2, atol=5e-2)}
JPREFILL = jax.jit(JE.ess_prefill, static_argnums=(1, 4),
                   static_argnames=("do_warmup", "prefill_chunk"))
JDECODE = jax.jit(JE.ess_decode, static_argnums=(1,))


def cfgs(dt, **ess):
    out = []
    for get, d in ((jget, JDT[dt]), (tget, TDT[dt])):
        cfg = dataclasses.replace(get(CFG), param_dtype=d)
        out.append(dataclasses.replace(cfg, ess=dataclasses.replace(
            cfg.ess, **ess)) if ess else cfg)
    return out


@pytest.fixture(scope="module")
def models():
    """dtype -> ``(jcfg, tcfg, jax params, port params)``, seed 0."""
    out = {}
    for dt in JDT:
        jcfg, tcfg = cfgs(dt)
        jp = jax.jit(lambda k, c=jcfg: jinit(k, JT.model_def(c)))(
            jax.random.key(0))
        out[dt] = (jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray,
                                                                jp)))
    return out


def tokens(seed, B, S, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)) \
        .astype(np.int32)


def positions(B, S):
    return np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)


def T(a):
    return array_to_torch(np.asarray(a)).long()


def prompt_fn(req):
    rng = np.random.default_rng(1000 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


def clone(c: LC.ESSCaches) -> LC.ESSCaches:
    def cp(t):
        return None if t is None else t.clone()
    return c._replace(lens=c.lens.clone(), host_latent=c.host_latent.clone(),
                      ikeys=[k.clone() for k in c.ikeys],
                      pools=[LP.PoolState(*(t.clone() for t in p))
                             for p in c.pools],
                      block_tables=cp(c.block_tables),
                      host_scales=cp(c.host_scales))


def bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes (bf16 and fp32 compared bit for bit)."""
    return t.detach().contiguous().view(torch.uint8).numpy()


def assert_caches_bitwise(a: LC.ESSCaches, b: LC.ESSCaches) -> None:
    np.testing.assert_array_equal(bits(a.host_latent), bits(b.host_latent))
    np.testing.assert_array_equal(a.lens.numpy(), b.lens.numpy())
    for ka, kb in zip(a.ikeys, b.ikeys):
        np.testing.assert_array_equal(bits(ka), bits(kb))
    for pa, pb in zip(a.pools, b.pools):
        for f in ("ids", "last_use", "slot_of", "data"):
            np.testing.assert_array_equal(bits(getattr(pa, f)),
                                          bits(getattr(pb, f)), f)


def close(t, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


# ---------------------------------------------------------------------------
# parity: chunked == one-shot, bit for bit
# ---------------------------------------------------------------------------

PB, PS, PSMAX = 2, 24, 64


@pytest.fixture(scope="module")
def oneshot(models):
    """dtype -> the port's and the reference's one-shot prefill (no
    warmup) of the parity prompt."""
    out = {}
    toks, pos = tokens(1, PB, PS), positions(PB, PS)
    for dt, (jcfg, tcfg, jp, tp) in models.items():
        jl, jc = JPREFILL(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                          PSMAX, do_warmup=False)
        tl, tc = TE.ess_prefill(tp, tcfg, T(toks), T(pos), PSMAX,
                                do_warmup=False)
        out[dt] = (tl, tc, np.asarray(jl), jax.tree.map(np.asarray, jc))
    return out


@pytest.mark.parametrize("chunk", [7, 64])
def test_chunked_prefill_bitwise_parity(models, oneshot, chunk):
    """At the reference's bf16 parameters, host rows, indexer keys, lens,
    the first greedy token and the full prefill logits of the chunked
    prefill equal the one-shot prefill's bit for bit.  The one-shot
    prefill equals the reference's: bf16 logits at 5e-2 and the first
    token; fp32 at 1e-5 in logits, host rows and keys, where the chunked
    prefill is held to the one-shot one at 1e-5 too (fp32 products of
    other shapes sum in another order on the CPU, so not bit for bit)."""
    toks, pos = tokens(1, PB, PS), positions(PB, PS)
    for dt in ("bf16", "f32"):
        _, tcfg, _, tp = models[dt]
        lg1, c1, jl, jc = oneshot[dt]
        lgc, cc = TE.ess_prefill(tp, tcfg, T(toks), T(pos), PSMAX,
                                 do_warmup=False, prefill_chunk=chunk)
        np.testing.assert_array_equal(c1.lens.numpy(), cc.lens.numpy())
        np.testing.assert_array_equal(lg1[:, -1].argmax(-1).numpy(),
                                      lgc[:, -1].argmax(-1).numpy())
        if dt == "bf16":
            np.testing.assert_array_equal(bits(c1.host_latent),
                                          bits(cc.host_latent))
            for layer in range(tcfg.num_layers):
                np.testing.assert_array_equal(bits(c1.ikeys[layer]),
                                              bits(cc.ikeys[layer]))
            np.testing.assert_array_equal(bits(lg1), bits(lgc))
        else:
            close(cc.host_latent, c1.host_latent.numpy(), TOL[dt])
            close(lgc, lg1.numpy(), TOL[dt])
        # the one-shot prefill against the reference's
        close(lg1, jl, TOL[dt])
        np.testing.assert_array_equal(lg1[:, -1].argmax(-1).numpy(),
                                      jl[:, -1].argmax(-1))
        np.testing.assert_array_equal(c1.lens.numpy(), jc.lens)
        np.testing.assert_array_equal(c1.block_tables.numpy(),
                                      jc.block_tables)
        if dt == "f32":
            close(c1.host_latent, jc.host_latent, TOL[dt])
            for layer in range(tcfg.num_layers):
                close(c1.ikeys[layer], jc.ikeys[layer], TOL[dt])


def session_prefill(make, params, cfg, req, **kw):
    """A session of ``make`` with ``req`` admitted and prefilled, no
    decode round run."""
    s = make(params, cfg, prompt_fn=prompt_fn, **kw)
    s.submit(req)
    s.admit()
    while s._prefill:
        s.prefill_round()
    return s


def test_serve_session_chunked_prefill_matches_oneshot_first_token(models):
    """At bf16 the session's in-place chunked prefill (chunk 7,
    ``do_warmup``: ragged chunks on the host-resolved path) gives the
    one-shot prefill's host rows and first token bit for bit (the warmup
    replay touches only the pools).  At fp32 its first token is the
    reference session's and its rows are within 1e-5 of them."""
    PROMPT, SMAX = 20, 48
    toks = prompt_fn(TReq(rid=0, prompt_len=PROMPT, max_new_tokens=4))
    pos = np.arange(PROMPT, dtype=np.int32)[None]
    for dt in ("bf16", "f32"):
        jcfg, tcfg, jp, tp = models[dt]
        session = session_prefill(
            TE.ServeSession, tp, tcfg,
            TReq(rid=0, prompt_len=PROMPT, max_new_tokens=4), num_slots=2,
            max_seq=SMAX, prefill_chunk=7, do_warmup=True, compiled=False,
            device="cpu")
        assert session.report.prefill_chunks == -(-PROMPT // 7)
        lg, donor = TE.ess_prefill(tp, tcfg, T(toks), T(pos), SMAX,
                                   do_warmup=False)
        t0 = int(lg[0, -1].argmax())
        got = LC.slot_latents(session.caches, 0)[:, :PROMPT]
        if dt == "bf16":
            assert int(session.state.tok[0]) == t0
            np.testing.assert_array_equal(
                bits(got), bits(LC.slot_latents(donor, 0)[:, :PROMPT]))
            continue
        js = session_prefill(
            JE.ServeSession, jp, jcfg,
            JReq(rid=0, prompt_len=PROMPT, max_new_tokens=4), num_slots=2,
            max_seq=SMAX, prefill_chunk=7, do_warmup=True)
        assert int(session.state.tok[0]) == int(js.tok[0]) == t0
        close(got, JLC.slot_latents(js.caches, 0)[:, :PROMPT], TOL[dt])


# ---------------------------------------------------------------------------
# long-prompt admission: decode keeps running between chunks
# ---------------------------------------------------------------------------

def test_32k_prompt_admits_without_decode_stall():
    """A 32768-token prompt streams through 4096-token chunks while the
    other slot keeps decoding (the reference test's nano config: 2 layers,
    a one-head 8-dim indexer with top-8)."""
    base = jget(CFG)
    jcfg = dataclasses.replace(base, num_layers=2, dsa=dataclasses.replace(
        base.dsa, index_heads=1, index_dim=8, index_topk=8))
    tcfg = dataclasses.replace(tget(CFG), num_layers=2,
                               dsa=DSAConfig(index_heads=1, index_dim=8,
                                             index_topk=8))
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    params = from_jax_params(jax.tree.map(np.asarray, jp))
    LONG, SHORT = 32768, 8
    session = TE.ServeSession(params, tcfg, num_slots=2, max_seq=LONG + 8,
                              prefill_chunk=4096, prompt_fn=prompt_fn,
                              compiled=False, device="cpu")
    reqs = [TReq(rid=0, prompt_len=SHORT, max_new_tokens=24),
            TReq(rid=1, prompt_len=LONG, max_new_tokens=2)]
    decode_during_prefill = []

    def on_round(s, rnd):
        if s._prefill:                            # rid=1 still prefilling
            decode_during_prefill.append(s.report.decode_tokens)

    report = session.run(reqs, max_rounds=64, on_round=on_round)
    assert sorted(report.finished_rids) == [0, 1]
    assert report.prefill_chunks >= LONG // 4096 + 1
    assert report.prefill_tokens == LONG + SHORT
    # decode rounds continued between rid=1's chunks
    assert decode_during_prefill and \
        decode_during_prefill[-1] > decode_during_prefill[0]
    chunk_evs = [e for e in report.events if "prefill chunk" in e]
    assert len(chunk_evs) == report.prefill_chunks
    assert report.ttft_rounds[1] >= LONG // 4096  # one chunk per round
    assert [len(session.outputs[r]) for r in (0, 1)] == [24, 2]


# ---------------------------------------------------------------------------
# masked slots write nothing
# ---------------------------------------------------------------------------

MB, MS, MSMAX = 2, 12, 32


@pytest.fixture(scope="module")
def prefilled(models):
    """fp32: both packages' prefill (no warmup) of a 2 x 12 prompt at
    ``max_seq`` 32 and the next tokens; the port's caches held against the
    reference's."""
    jcfg, tcfg, jp, tp = models["f32"]
    toks, pos = tokens(1, MB, MS), positions(MB, MS)
    _, jc = JPREFILL(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), MSMAX,
                     do_warmup=False)
    _, tc = TE.ess_prefill(tp, tcfg, T(toks), T(pos), MSMAX, do_warmup=False)
    np.testing.assert_array_equal(tc.block_tables.numpy(),
                                  np.asarray(jc.block_tables))
    close(tc.host_latent, jc.host_latent, TOL["f32"])
    nxt = tokens(2, MB, 1)
    return jc, tc, nxt


def test_masked_decode_writes_nothing(models, prefilled):
    """Every slot masked: host tier, lens, every pool's maps and rows and
    the indexer keys stay bit for bit; no hits, no misses (the reference's
    masked step leaves its caches as they were too)."""
    jcfg, tcfg, jp, tp = models["f32"]
    jc, tc0, nxt = prefilled
    caches = clone(tc0)
    before = clone(tc0)
    out = TE.ess_decode(tp, tcfg, T(nxt), caches.lens[:, None].clone(),
                        caches, slot_mask=torch.zeros((MB,), dtype=torch.bool))
    assert_caches_bitwise(out.caches, before)
    assert int(out.stats["hits"].sum()) == 0
    assert int(out.stats["misses"].sum()) == 0
    jo = JDECODE(jp, jcfg, jnp.asarray(nxt), jc.lens[:, None], jc,
                 slot_mask=jnp.zeros((MB,), bool))
    np.testing.assert_array_equal(np.asarray(jo.caches.host_latent),
                                  np.asarray(jc.host_latent))
    np.testing.assert_array_equal(np.asarray(jo.caches.lens),
                                  out.caches.lens.numpy())


def test_freed_slot_does_not_alias_live_slot_pages(models, prefilled):
    """Slot 1 reset with ``reset_slot`` and its block table set to slot
    0's: a decode masked to slot 0 changes only slot 0's append row in
    each layer, slot 1's pools stay empty and its lens 0, and the host
    tier equals the reference's after the same step.  Unmasked, the same
    step writes slot 1's phantom row into slot 0's page 0."""
    jcfg, tcfg, jp, tp = models["f32"]
    jc, tc0, nxt = prefilled
    caches = clone(tc0)
    LC.reset_slot(caches, 1)
    caches.block_tables[1].copy_(caches.block_tables[0])
    buggy = clone(caches)
    before = caches.host_latent.clone().numpy()
    mask = torch.tensor([True, False])
    out = TE.ess_decode(tp, tcfg, T(nxt), caches.lens[:, None].clone(),
                        caches, slot_mask=mask)
    after = out.caches.host_latent.numpy()
    R = tcfg.ess.host_page_rows
    bt0 = caches.block_tables[0].numpy()
    pg, rw = bt0[MS // R], MS % R
    changed = (after != before).any(axis=-1)          # [L, NP, R]
    expect = np.zeros_like(changed)
    expect[:, pg, rw] = True
    np.testing.assert_array_equal(changed, changed & expect)
    assert changed[:, pg, rw].all()                   # the append happened
    for p in out.caches.pools:
        assert (p.ids[1].numpy() == -1).all()
    assert int(out.caches.lens[1]) == 0
    # the reference's same step
    jc1 = JLC.reset_slot(jc, 1)
    jc1 = jc1._replace(
        block_tables=jc1.block_tables.at[1].set(jc1.block_tables[0]))
    jo = JDECODE(jp, jcfg, jnp.asarray(nxt), jc1.lens[:, None], jc1,
                 slot_mask=jnp.asarray([True, False]))
    close(out.caches.host_latent, jo.caches.host_latent, TOL["f32"])
    close(out.logits[0], jo.logits[0], TOL["f32"])
    np.testing.assert_array_equal(out.caches.lens.numpy(),
                                  np.asarray(jo.caches.lens))
    # without the mask, the freed slot's phantom step lands in slot 0's
    # page 0: the write the mask prevents
    ob = TE.ess_decode(tp, tcfg, T(nxt), buggy.lens[:, None].clone(), buggy)
    after_buggy = ob.caches.host_latent.numpy()
    assert (after_buggy[:, bt0[0], 0] != before[:, bt0[0], 0]).any()


def test_serve_loop_freed_slot_rounds_leave_it_untouched(models):
    """The serve loop runs rid 1 to the end (slot 1 frees), then four more
    rounds: slot 1's lens, pool maps and block table stay reset, with no
    fix-up after the rounds; the streams are the reference session's."""
    jcfg, tcfg, jp, tp = models["f32"]

    def reqs(R):
        return [R(rid=0, prompt_len=12, max_new_tokens=20),
                R(rid=1, prompt_len=12, max_new_tokens=2)]
    session = TE.ServeSession(tp, tcfg, num_slots=2, max_seq=48,
                              prompt_fn=prompt_fn, compiled=False,
                              device="cpu")
    js = JE.ServeSession(jp, jcfg, num_slots=2, max_seq=48,
                         prompt_fn=prompt_fn)
    for s, R in ((session, TReq), (js, JReq)):
        for r in reqs(R):
            s.submit(r)
        for _ in range(8):            # rid=1 finishes, slot 1 frees
            s.step()
        assert not s.sched.slots[1].active
    for _ in range(4):                # decode rounds with a freed slot
        session.step()
        js.step()
    assert int(session.caches.lens[1]) == 0
    for p in session.caches.pools:
        assert (p.ids[1].numpy() == -1).all()
        assert (p.last_use[1].numpy() == -1).all()
    assert (session.caches.block_tables[1].numpy() == -1).all()
    assert session.outputs == js.outputs
    np.testing.assert_array_equal(session.caches.lens.numpy(),
                                  np.asarray(js.caches.lens))


def test_serve_warmup_depth_independent_of_chunking(models):
    """A 17-token prompt at chunk 16 (a 1-token last chunk) and at chunk
    64: the warmup replay covers the same windows, so at bf16 every pool's
    maps, rows and stamps are equal bit for bit and so is the first token.
    At fp32 the chunk-16 pools equal the reference session's (maps, stamps
    and first token equal, rows at 1e-5)."""
    req = dict(rid=0, prompt_len=17, max_new_tokens=2)
    kw = dict(num_slots=1, max_seq=32, do_warmup=True)
    jcfg, tcfg, jp, tp = models["bf16"]
    a, b = (session_prefill(TE.ServeSession, tp, tcfg, TReq(**req),
                            prefill_chunk=c, compiled=False, device="cpu",
                            **kw) for c in (16, 64))
    for pa, pb in zip(a.caches.pools, b.caches.pools):
        for f in ("ids", "data", "last_use"):
            np.testing.assert_array_equal(bits(getattr(pa, f)),
                                          bits(getattr(pb, f)), f)
    assert any((p.ids[0].numpy() >= 0).sum() > 0 for p in a.caches.pools)
    assert int(a.state.tok[0]) == int(b.state.tok[0])
    jcfg, tcfg, jp, tp = models["f32"]
    a = session_prefill(TE.ServeSession, tp, tcfg, TReq(**req),
                        prefill_chunk=16, compiled=False, device="cpu", **kw)
    j = session_prefill(JE.ServeSession, jp, jcfg, JReq(**req),
                        prefill_chunk=16, **kw)
    for pa, pj in zip(a.caches.pools, j.caches.pools):
        for f in ("ids", "last_use", "slot_of"):
            np.testing.assert_array_equal(getattr(pa, f).numpy(),
                                          np.asarray(getattr(pj, f)), f)
        close(pa.data, pj.data, TOL["f32"])
    assert int(a.state.tok[0]) == int(j.tok[0])


# ---------------------------------------------------------------------------
# the TTFT stamp
# ---------------------------------------------------------------------------

def test_ttft_submit_stamp_unconditional(models):
    """Counterpart of ``test_compiled_serve.py``'s test: ``submit`` stamps
    the request, its TTFT is measured from that stamp (and its TTFT in
    rounds is the reference's), and a request put straight into the
    scheduler, never stamped, raises ``KeyError`` at delivery rather than
    reporting a TTFT near 0, in both packages."""
    jcfg, tcfg = cfgs("f32", max_miss_ratio=1.0)
    _, _, jp, tp = models["f32"]
    session = TE.ServeSession(tp, tcfg, num_slots=1, max_seq=32,
                              prompt_fn=prompt_fn, compiled=False,
                              device="cpu")
    session.run([TReq(rid=7, prompt_len=8, max_new_tokens=2)], max_rounds=20)
    assert 7 in session._submit_time
    assert session.report.ttft_s[7] > 0.0
    js = JE.ServeSession(jp, jcfg, num_slots=1, max_seq=32,
                         prompt_fn=prompt_fn)
    js.run([JReq(rid=7, prompt_len=8, max_new_tokens=2)], max_rounds=20)
    assert session.report.ttft_rounds == js.report.ttft_rounds
    assert session.outputs == js.outputs
    for make, R, kw in ((TE.ServeSession, TReq,
                         dict(compiled=False, device="cpu")),
                        (JE.ServeSession, JReq, {})):
        s2 = make(tp if R is TReq else jp, tcfg if R is TReq else jcfg,
                  num_slots=1, max_seq=32, prompt_fn=prompt_fn, **kw)
        s2.sched.submit(R(rid=9, prompt_len=8, max_new_tokens=2))
        with pytest.raises(KeyError):
            s2.run(max_rounds=20)
