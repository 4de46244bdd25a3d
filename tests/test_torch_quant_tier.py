"""The quantized (int8) host tier's bounds on the port against the
reference's (counterparts of ``tests/test_quant_cache.py``'s serve-level
tests).

The configs are the reference's ``_cfgs()``: the smoke config with two
stacked MTP modules, a bf16 tier against ``host_cache_dtype="int8"``.
Parameters are fp32 (the reference's ``init_params`` carried across with
``from_jax_params``), so the two packages' streams can be held equal: the
port's attend follows the Pallas kernels' math, which the reference runs
with ``use_kernel=True`` on the quantized tier (its miss rows are bf16
there); at bf16 parameters the reference's plain attend rounds the softmax
weights to bf16 and near-ties flip.  Prompts come from numpy, seeded with
``1000 + rid``, and go to both packages.

* ``EssEngine.generate([10] * 4)`` at Q = 1 (6 tokens) and MTP depth 2
  (8 tokens), each tier, in both packages: streams, rounds, speculative
  rounds and accept rates equal, and the int8 tier's bytes per row below
  the bf16 tier's.  The reference's claim that the int8 streams equal the
  bf16 ones fails in both packages on random weights (a near-tie); the
  tests hold that both packages diverge at the same (rid, token), and do
  not assert the claim.
* The host rows: a freed slot's (what the reference's test reads: zero)
  within two int8 steps of bf16's, as it asserts; the rows each request
  leaves in its slot equal the reference's on both tiers, and layer 0's
  sit within one int8 step of bf16's where the streams agree.  Deeper
  layers drift past two steps in both packages.
* The engine state of a quantized session gains exactly its scale planes;
  a byte budget floors pages by the tier's storage dtype; ESS106 flags a
  bf16 tier as unquantized.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import jaxpr_audit as JAUD
from repro.cache import latent_cache as JLC
from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import api as JA
from repro.serving import engine as JE
from repro_torch.analysis import audit as A
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.models.params import from_jax_params
from repro_torch.serving import api as TA
from repro_torch.serving import engine as TE
from repro_torch.serving import state as TES

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file
# the reference's many eager compiles at XLA's quick settings
pytestmark = pytest.mark.usefixtures("quick_xla")

CFG = "deepseek-v32-exp-ess-smoke"
NUM_SLOTS, MAX_SEQ = 2, 32
PROMPTS = [10] * 4
RUNS = {0: 6, 2: 8}                    # MTP depth -> max_tokens (the
TIERS = ("bf16", "int8")               # reference's _run calls)


def cfgs(tier):
    """The reference's ``_cfgs()`` for one tier, fp32 params."""
    out = []
    for get, dt in ((jget, jnp.float32), (tget, torch.float32)):
        cfg = dataclasses.replace(get(CFG), mtp_depth=2, param_dtype=dt)
        out.append(dataclasses.replace(cfg, ess=dataclasses.replace(
            cfg.ess, host_cache_dtype=tier)))
    return out


@pytest.fixture(scope="module")
def model():
    jcfg, _ = cfgs("bf16")
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def prompt_fn(req):
    rng = np.random.default_rng(1000 + req.rid)
    return rng.integers(0, 256, (1, req.prompt_len)).astype(np.int32)


def watch_releases(session, slot_latents, rows: dict) -> None:
    """Keep each finished request's host rows (``[L, lens, D]`` fp32, read
    by the package's ``slot_latents``) as its slot releases, before the
    reset."""
    release = session.sched.release_hook

    def hook(slot):
        rid = session.sched.finished[-1].rid
        n = int(np.asarray(session.caches.lens)[slot])
        got = slot_latents(session.caches, slot)[:, :n]
        rows[rid] = got.float().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got, np.float32)
        release(slot)
    session.sched.release_hook = hook


@pytest.fixture(scope="module")
def runs(model):
    """Each tier at each MTP depth through both packages' ``EssEngine``:
    ``{(tier, depth): {"ref": ..., "port": ...}}`` with the streams, the
    report counters and (Q = 1) the slot-0 rows after the run and each
    request's rows at release."""
    jp, tp = model
    out = {}
    for depth, max_tokens in RUNS.items():
        for tier in TIERS:
            jcfg, tcfg = cfgs(tier)
            je = JA.EssEngine(jp, jcfg, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                              mtp_depth=depth, prompt_fn=prompt_fn,
                              use_kernel=tier != "bf16")
            te = TA.EssEngine(tp, tcfg, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                              mtp_depth=depth, prompt_fn=prompt_fn,
                              compiled=False, device="cpu")
            released = {"ref": {}, "port": {}}
            watch_releases(je.session, JLC.slot_latents, released["ref"])
            watch_releases(te.session, LC.slot_latents, released["port"])
            jo = je.generate(PROMPTS, JA.SamplingParams(max_tokens=max_tokens),
                             max_rounds=200)
            to = te.generate(PROMPTS, TA.SamplingParams(max_tokens=max_tokens),
                             max_rounds=200)
            pair = {}
            for side, outs, sess in (("ref", jo, je.session),
                                     ("port", to, te.session)):
                rep = sess.report
                pair[side] = dict(
                    tokens=[o.tokens for o in outs],
                    reasons=[o.finish_reason for o in outs],
                    rounds=rep.rounds, spec_rounds=rep.spec_rounds,
                    accept_rate=rep.accept_rate,
                    host_bytes_per_row=rep.host_bytes_per_row)
            pair["ref"]["slot0"] = np.asarray(
                JLC.slot_latents(je.session.caches, 0), np.float32)
            pair["port"]["slot0"] = LC.slot_latents(te.session.caches, 0) \
                .float().numpy()
            for side in ("ref", "port"):
                pair[side]["released"] = released[side]
            out[(tier, depth)] = pair
    return out


def first_divergence(a: list, b: list):
    """The first ``(rid, token index)`` where two runs' streams differ."""
    for rid, (x, y) in enumerate(zip(a, b)):
        for i, (s, t) in enumerate(zip(x, y)):
            if s != t:
                return rid, i
    return None


# ---------------------------------------------------------------------------
# serve parity (greedy streams + MTP acceptance)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tier", TIERS)
def test_tier_streams_and_rounds_match_reference(runs, tier):
    """Counterpart of ``test_greedy_streams_match_bf16``: each tier's
    streams and rounds equal the reference's, every request ends at its
    length, and the int8 tier's bytes per row sit below the bf16 tier's
    (both packages' accounting equal).  Where the bf16 and int8 streams
    part (the claim the reference asserts, failing on random weights),
    they part at the same (rid, token) in both packages."""
    ref, port = runs[(tier, 0)]["ref"], runs[(tier, 0)]["port"]
    assert port["tokens"] == ref["tokens"]
    assert port["reasons"] == ref["reasons"] == ["length"] * len(PROMPTS)
    assert port["rounds"] == ref["rounds"]
    assert port["host_bytes_per_row"] == ref["host_bytes_per_row"]
    q, b = runs[("int8", 0)]["port"], runs[("bf16", 0)]["port"]
    assert q["host_bytes_per_row"] < b["host_bytes_per_row"]
    assert first_divergence(b["tokens"], q["tokens"]) == first_divergence(
        runs[("bf16", 0)]["ref"]["tokens"], runs[("int8", 0)]["ref"]["tokens"])


@pytest.mark.parametrize("tier", TIERS)
def test_mtp_spec_rounds_and_accept_rate_match_reference(runs, tier):
    """Counterpart of ``test_mtp_acceptance_within_2pct_of_bf16``: at MTP
    depth 2, each tier's streams, rounds, speculative rounds and accept
    rate equal the reference's, and every round was speculative.  The
    bf16-vs-int8 claims are held only as the two packages' agreement on
    where (and whether) the tiers' streams part."""
    ref, port = runs[(tier, 2)]["ref"], runs[(tier, 2)]["port"]
    assert port["tokens"] == ref["tokens"]
    assert port["reasons"] == ref["reasons"] == ["length"] * len(PROMPTS)
    assert (port["rounds"], port["spec_rounds"]) == \
        (ref["rounds"], ref["spec_rounds"])
    assert port["spec_rounds"] == port["rounds"] > 0
    assert port["accept_rate"] == ref["accept_rate"]
    assert first_divergence(runs[("bf16", 2)]["port"]["tokens"],
                            runs[("int8", 2)]["port"]["tokens"]) == \
        first_divergence(runs[("bf16", 2)]["ref"]["tokens"],
                         runs[("int8", 2)]["ref"]["tokens"])


def test_host_tier_rows_drift_is_scale_bounded(runs):
    """Counterpart of ``test_host_tier_rows_drift_is_scale_bounded``: slot
    0's rows after the run sit within ``amax * 2/127 + 1e-5`` of the bf16
    tier's, and equal the reference's.  That read finds the slot freed,
    its pages unmapped: zero rows in both packages.  The rows each request
    left in its slot as it released equal the reference's (fp32 at 1e-5)
    on both tiers; over the positions whose tokens both tiers' streams
    share, layer 0's rows (the same projection of the same tokens) sit
    within one int8 step of the bf16 tier's.  The deeper layers' rows
    drift further, as far in the reference: the bound the reference
    states does not hold on live rows in either package (the first
    decoded row's drift is the largest: it attends over dequantized prompt
    rows, which the prefill read unquantized), so it is not asserted
    there."""
    b, q = runs[("bf16", 0)], runs[("int8", 0)]
    for run in (b, q):
        np.testing.assert_array_equal(run["port"]["slot0"],
                                      run["ref"]["slot0"])

    def within(rows_b, rows_q, steps):
        amax = np.abs(rows_b).max(axis=-1, keepdims=True)
        err = np.abs(rows_b - rows_q)
        assert (err <= amax * (steps / 127.0) + 1e-5).all(), \
            float((err / np.maximum(amax, 1e-9)).max())
    within(b["port"]["slot0"], q["port"]["slot0"], 2.0)
    for run in (b, q):
        got, want = run["port"]["released"], run["ref"]["released"]
        assert sorted(got) == sorted(want) == list(range(len(PROMPTS)))
        for rid in got:
            np.testing.assert_allclose(got[rid], want[rid], rtol=1e-5,
                                       atol=1e-5)
    rb, rq = b["port"]["released"], q["port"]["released"]
    for rid, plen in enumerate(PROMPTS):
        tb, tq = b["port"]["tokens"][rid], q["port"]["tokens"][rid]
        same = next((i for i, (x, y) in enumerate(zip(tb, tq)) if x != y),
                    len(tb))
        n = plen + same                  # token i lands at position plen + i
        assert n > plen
        within(rb[rid][:1, :n], rq[rid][:1, :n], 1.0)


# ---------------------------------------------------------------------------
# the state's leaves, byte-denominated admission, ESS106
# ---------------------------------------------------------------------------

def test_engine_state_gains_only_scale_leaves():
    """Counterpart of ``test_engine_state_gains_only_scale_leaves``: over
    ``init_ess_caches`` as a session builds it, the int8 state holds
    exactly one more tensor than the bf16 one (the tier's scale plane),
    and two with a staging slab (its scales too), as the reference's
    state; the slab's rows are int8 and 4-D (the reference's last leaf,
    the port's ``staged_rows``)."""
    def port_state(tcfg, prefetch):
        paged = LC.uses_paged_host(tcfg)
        caches = LC.init_ess_caches(
            tcfg, NUM_SLOTS, MAX_SEQ, tcfg.param_dtype, device="cpu",
            num_pages=NUM_SLOTS * LC.num_blocks(tcfg, MAX_SEQ)
            if paged else None, map_slots=not paged)
        return TES.init_engine_state(tcfg, caches, NUM_SLOTS,
                                     prefetch_rows=prefetch)

    (jb, tb), (jq, tq) = cfgs("bf16"), cfgs("int8")
    for prefetch, extra in ((0, 1), (4, 2)):
        nb = len(A.state_leaves(port_state(tb, prefetch)))
        nq = len(A.state_leaves(port_state(tq, prefetch)))
        assert nq == nb + extra
        assert len(jax.tree.leaves(JAUD._abstract_state(jq, NUM_SLOTS,
                                                        MAX_SEQ, prefetch))) \
            == len(jax.tree.leaves(JAUD._abstract_state(jb, NUM_SLOTS,
                                                        MAX_SEQ, prefetch))) \
            + extra
    leaves = dict(A.state_leaves(port_state(tq, 4)))
    rows = leaves["state.staged_rows"]
    assert rows.dtype == torch.int8 and rows.ndim == 4
    want = jax.tree.leaves(JAUD._abstract_state(jq, NUM_SLOTS, MAX_SEQ, 4))[-1]
    assert want.dtype == jnp.int8 and tuple(rows.shape) == want.shape


def test_byte_budget_floors_pages_by_storage_dtype(model):
    """Counterpart of ``test_byte_budget_floors_pages_by_storage_dtype``:
    four int8 pages' bytes give the int8 session 4 pages and the bf16 one
    the budget over its page bytes (as the reference's sessions), at least
    twice as many for int8, both under the byte ceiling."""
    jp, tp = model
    (jb, tb), (jq, tq) = cfgs("bf16"), cfgs("int8")
    budget = 4 * LC.host_page_bytes(tq, tq.param_dtype)
    assert budget == 4 * JLC.host_page_bytes(jq, jq.param_dtype)
    sb, sq = (TE.ServeSession(tp, c, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                              host_byte_budget=budget, compiled=False,
                              device="cpu") for c in (tb, tq))
    rb, rq = (JE.ServeSession(jp, c, num_slots=NUM_SLOTS, max_seq=MAX_SEQ,
                              host_byte_budget=budget) for c in (jb, jq))
    assert sb.num_pages == budget // LC.host_page_bytes(tb, tb.param_dtype)
    assert sq.num_pages == 4
    assert sq.num_pages >= 2 * sb.num_pages
    assert (sq.num_pages * sq.host_page_bytes <= budget
            and sb.num_pages * sb.host_page_bytes <= budget)
    assert (sb.num_pages, sq.num_pages) == (rb.num_pages, rq.num_pages)
    assert (sb.host_page_bytes, sq.host_page_bytes) == \
        (rb.host_page_bytes, rq.host_page_bytes)


def test_ess106_flags_bf16_tier_as_unquantized():
    """Counterpart of ``test_ess106_flags_bf16_tier_as_unquantized``: a
    smoke session on a bf16 tier audited for ESS106 (its first decode
    round to profile) is flagged, as the reference flags a bf16 tier's
    programs, and not profiled; every finding is ESS106, the first "no
    quantized state leaf", scoped as the session's other findings."""
    w = A.audit_session(A.smoke_session(A.smoke_cfg("bf16"), device="cpu"),
                        name="bf16", profile_decode=0)
    fs = w.findings()
    assert fs and all(f.rule == "ESS106" for f in fs)
    assert "no quantized state leaf" in fs[0].message
    assert fs[0].scope == "bf16/bf16"
    assert w.profiled_ops is None
    # the same session unaudited for ESS106 has no finding at all
    w = A.audit_session(A.smoke_session(A.smoke_cfg("bf16"), device="cpu"),
                        name="bf16")
    assert w.findings() == []
