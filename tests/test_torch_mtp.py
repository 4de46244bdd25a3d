"""MTP speculative decode in the port against the reference on the CPU
(smoke config, fp32, ``mtp_depth`` 2, ``max_miss_ratio`` 1, the
reference's own parameters carried across with ``from_jax_params``).

* ``mtp_draft``: the drafts equal and each module's logits at 1e-5, with
  the MoE capacity ample and at one token per expert (drops);
* ``speculative_step`` from one state: tokens, acceptance, the in-place
  rollback of ``lens`` and the pools, the hidden at the last accepted
  position; with the rollback gated on ``slot_mask`` and the drafts of
  sampling slots force-rejected
  (``test_serving.test_mtp_speculative_rollback_semantics`` /
  ``test_mtp_spec_rollback_gated_on_slot_mask``);
* a Q = 3 verify step against three Q = 1 steps, and against the
  reference's Q = 3 step
  (``test_mtp_serve.test_q3_decode_matches_three_q1_steps``).

The speculative serve session is in ``tests/test_torch_mtp_session.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import lru_pool as JLP
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro.serving import mtp as JMTP
from repro.serving.sampling import greedy as jgreedy
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import lru_pool as LP
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving import mtp as TMTP

CFG = "deepseek-v32-exp-ess-smoke"
DEPTH = 2
TOL = dict(rtol=1e-5, atol=1e-5)


def configs(**ess):
    ess = dict(max_miss_ratio=1.0, **ess)
    jc, tc = jget(CFG), tget(CFG)
    return (dataclasses.replace(jc, param_dtype=jnp.float32, mtp_depth=DEPTH,
                                ess=dataclasses.replace(jc.ess, **ess)),
            dataclasses.replace(tc, param_dtype=torch.float32,
                                mtp_depth=DEPTH,
                                ess=dataclasses.replace(tc.ess, **ess)))


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = configs()
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def to_port(tree):
    return from_jax_params(jax.tree.map(np.asarray, tree))


# ---------------------------------------------------------------------------
# mtp_draft and speculative_step from one state
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cf", [2.0, 0.5], ids=["ample", "capacity-1"])
def test_mtp_draft_matches_reference(model, monkeypatch, cf):
    """4 draft tokens through both modules; at ``cf`` 0.5 the MoE capacity
    is ceil(4 x 2 / 4 x 0.5) = 1 token per expert, so the token-major drop
    rule decides which tokens keep their experts."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cf))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=cf))
    rng = np.random.default_rng(3)
    hid = rng.standard_normal((4, tcfg.d_model)).astype(np.float32)
    tok = rng.integers(0, tcfg.vocab_size, (4,))
    jl, tl = [], []
    monkeypatch.setattr(JMTP, "greedy",
                        lambda lg: (jl.append(np.asarray(lg)),
                                    jgreedy(lg))[1])
    tgreedy = TMTP.greedy
    monkeypatch.setattr(TMTP, "greedy",
                        lambda lg: (tl.append(lg.numpy()), tgreedy(lg))[1])
    want = JMTP.mtp_draft(jp, jcfg, jnp.asarray(hid),
                          jnp.asarray(tok, jnp.int32))
    got = TMTP.mtp_draft(tp, tcfg, torch.from_numpy(hid),
                         torch.from_numpy(tok))
    assert len(jl) == len(tl) == DEPTH
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, **TOL)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="depth"):
        TMTP.mtp_draft(tp, tcfg, torch.from_numpy(hid),
                       torch.from_numpy(tok), depth=DEPTH + 1)


@pytest.fixture(scope="module")
def decoded(model):
    """The reference's caches after a 16-token prefill and one Q = 1 step
    (``test_serving``'s setup), with the step's hidden and next token, as
    numpy trees (each test converts its own copies)."""
    jcfg, _, jp, _ = model
    B, S, Smax = 2, 16, 48
    toks = jax.random.randint(jax.random.key(1), (B, S), 0, jcfg.vocab_size)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    logits, caches = JE.ess_prefill(jp, jcfg, toks, pos, Smax,
                                    do_warmup=False)
    tok = jgreedy(logits[:, -1])
    out = JE.ess_decode(jp, jcfg, tok[:, None], caches.lens[:, None], caches)
    return jax.tree.map(np.asarray, (out.caches, out.stats["hidden"][:, -1],
                                     jgreedy(out.logits[:, -1])))


MASKS = {"all-live": (None, None), "slot-gated": ([True, False], None),
         "sample-forced": (None, [False, True])}


@pytest.mark.parametrize("case", list(MASKS))
def test_speculative_step_matches_reference(model, decoded, case):
    jcfg, tcfg, jp, tp = model
    tc = LC.from_jax_caches(decoded[0])
    thid, ttok = array_to_torch(decoded[1]), array_to_torch(decoded[2]).long()
    jc, jhid, jtok = jax.tree.map(jnp.asarray, decoded)
    sm, smp = MASKS[case]
    jm = None if sm is None else jnp.asarray(sm)
    tm = None if sm is None else torch.tensor(sm)
    lens_before = tc.lens.clone()
    ids_before = [p.ids.clone() for p in tc.pools]

    spec_j = JMTP.speculative_step(
        lambda p_, c_, t_, po_, ca_: JE.ess_decode(p_, c_, t_, po_, ca_,
                                                   slot_mask=jm),
        jp, jcfg, jc, jtok, jhid, slot_mask=jm,
        sample_mask=None if smp is None else jnp.asarray(smp))
    spec_t = TMTP.speculative_step(
        tp, tcfg, tc, ttok, thid, slot_mask=tm,
        sample_mask=None if smp is None else torch.tensor(smp))

    np.testing.assert_array_equal(spec_t.tokens.numpy(),
                                  np.asarray(spec_j.tokens))
    np.testing.assert_array_equal(spec_t.n_accepted.numpy(),
                                  np.asarray(spec_j.n_accepted))
    np.testing.assert_allclose(spec_t.hidden.numpy(),
                               np.asarray(spec_j.hidden), **TOL)
    np.testing.assert_allclose(spec_t.logits.numpy(),
                               np.asarray(spec_j.logits), **TOL)
    # the rollback happened in place, on the caches passed in
    assert spec_t.caches.lens is tc.lens
    np.testing.assert_array_equal(tc.lens.numpy(),
                                  np.asarray(spec_j.caches.lens))
    for a, b in zip(tc.pools, spec_j.caches.pools):
        for f in ("ids", "last_use", "slot_of", "step"):
            np.testing.assert_array_equal(getattr(a, f).numpy(),
                                          np.asarray(getattr(b, f)), f)
        assert LP.check_consistent(a) and JLP.check_consistent(b)
    n = spec_t.n_accepted
    live = torch.ones(2, dtype=torch.bool) if tm is None else tm
    assert ((1 <= n) & (n <= DEPTH + 1)).all()
    assert torch.equal(tc.lens, torch.where(live, lens_before + n,
                                            lens_before))
    for p, before in zip(tc.pools, ids_before):
        ids = p.ids
        assert ((ids < tc.lens[:, None]) | (ids < 0)).all()
        if tm is not None:                 # the frozen slot kept its pool
            assert torch.equal(ids[1], before[1])
    if smp is not None:
        assert int(n[1]) == 1


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_q3_decode_matches_three_q1_steps(paged):
    """One Q = 3 step leaves ``lens``, the indexer caches and the host tier
    bit-identical to three Q = 1 steps, with per-position logits at 2e-2
    and the same argmax (``overlap='none'``: one union attention); and it
    equals the reference's Q = 3 step from the same state at 1e-5."""
    jcfg, tcfg = configs(overlap="none", paged_host=paged)
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    tp = to_port(jp)
    B, S, Smax, Q = 2, 14, 40, 3
    toks = jax.random.randint(jax.random.key(1), (B, S), 0, jcfg.vocab_size)
    pos = jnp.broadcast_to(jnp.arange(S)[None], (B, S))
    _, jc = JE.ess_prefill(jp, jcfg, toks, pos, Smax, do_warmup=False)
    nxt = np.asarray(jax.random.randint(jax.random.key(2), (B, Q), 0,
                                        jcfg.vocab_size))
    jflat = JE.ess_decode(jp, jcfg, jnp.asarray(nxt),
                          jc.lens[:, None] + jnp.arange(Q)[None], jc)

    def port_caches():
        return LC.from_jax_caches(jax.tree.map(np.asarray, jc))
    t_nxt = torch.from_numpy(nxt).long()
    c = port_caches()
    flat = TE.ess_decode(tp, tcfg, t_nxt,
                         c.lens[:, None] + torch.arange(Q)[None], c)
    fc = flat.caches
    np.testing.assert_allclose(flat.logits.numpy(),
                               np.asarray(jflat.logits), **TOL)
    np.testing.assert_array_equal(fc.lens.numpy(),
                                  np.asarray(jflat.caches.lens))

    c = port_caches()
    seq = []
    for q in range(Q):
        o = TE.ess_decode(tp, tcfg, t_nxt[:, q:q + 1], c.lens[:, None], c)
        seq.append(o.logits[:, 0])
        c = o.caches
    assert torch.equal(fc.lens, c.lens)
    for a, b in zip(fc.ikeys, c.ikeys):
        assert torch.equal(a, b)
    assert torch.equal(fc.host_latent, c.host_latent)
    for q in range(Q):
        np.testing.assert_allclose(flat.logits[:, q].numpy(),
                                   seq[q].numpy(), atol=2e-2)
        assert torch.equal(flat.logits[:, q].argmax(-1), seq[q].argmax(-1))
    for p in fc.pools:
        assert LP.check_consistent(p)
