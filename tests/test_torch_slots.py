"""The serve loop's slot machinery against the reference on the CPU: slot
state (``reset_slot`` / ``map_slot`` / ``unmap_slot`` / ``pages_owned_mask``
/ ``HostPageAllocator``), ``invalidate_beyond``, the per-slot prefill chunk
(``slot``, a ragged ``n_valid``, ``collect_tail``, ``hidden_last``),
``lru_warmup``, the scheduler's copy and ``chunk_bucket``.

Maps, block tables, ``lens`` and pool state are held **equal**; float
outputs in fp32 at rtol/atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import latent_cache as JLC
from repro.configs import get_config as jget
from repro.core import lru_pool as JLP
from repro.core import warmup as JWU
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro.serving import scheduler as JS
from repro.serving import step as JSP
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import lru_pool as LP
from repro_torch.core import warmup as WU
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE
from repro_torch.serving import scheduler as TS
from repro_torch.serving import step as TSP

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = "deepseek-v32-exp-ess-smoke"


def eq(t, j, msg=""):
    np.testing.assert_array_equal(t.detach().numpy(), np.asarray(j),
                                  err_msg=msg)


def close(t, j, msg=""):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), err_msg=msg, **TOL)


def cfgs():
    return (dataclasses.replace(jget(CFG), param_dtype=jnp.float32),
            dataclasses.replace(tget(CFG), param_dtype=torch.float32))


def assert_pools(tpools, jpools):
    for tp, jp in zip(tpools, jpools):
        for f in ("ids", "last_use", "slot_of", "step"):
            eq(getattr(tp, f), getattr(jp, f), f)
        close(tp.data, jp.data, "data")


def _fill_pools(rng, jc, tc, rounds=3):
    """The same random lookups + admissions on every layer's pool."""
    jpools, tpools = list(jc.pools), tc.pools
    B, P, D = tpools[0].data.shape
    S = tpools[0].slot_of.shape[1]
    for layer in range(len(jpools)):
        for _ in range(rounds):
            ids = np.stack([rng.choice(S, 6, replace=False)
                            for _ in range(B)]).astype(np.int32)
            valid = rng.random(ids.shape) < 0.9
            jp, jl, _ = JLP.lookup(jpools[layer], jnp.asarray(ids),
                                   jnp.asarray(valid), 4, slot_mask=None,
                                   dedup=False)
            tp, tl, _ = LP.lookup(tpools[layer], torch.tensor(ids).long(),
                                  torch.tensor(valid), 4, slot_mask=None,
                                  dedup=False)
            rows = rng.standard_normal((B, 4, D), dtype=np.float32)
            jpools[layer] = JLP.tick(JLP.admit(jp, jl.miss_ids,
                                               jnp.asarray(rows),
                                               slot_mask=None))
            tpools[layer] = LP.tick(LP.admit(tp, tl.miss_ids,
                                             torch.tensor(rows),
                                             slot_mask=None))
    return jc._replace(pools=tuple(jpools))


# ---------------------------------------------------------------------------
# Slot state
# ---------------------------------------------------------------------------

def test_slot_lifecycle_matches_reference():
    """Unmapped caches, two slots mapped from an allocator, pools filled,
    slot 1 reset and unmapped, slot 0 remapped: equal at every edge.
    Every edit is in place (the tensors a captured graph reads)."""
    jcfg, tcfg = cfgs()
    B, S, NP = 3, 40, 6
    jc = JLC.init_ess_caches(jcfg, B, S, jnp.float32, num_pages=NP,
                             map_slots=False)
    tc = LC.init_ess_caches(tcfg, B, S, torch.float32, device="cpu",
                            num_pages=NP, map_slots=False)
    eq(tc.block_tables, jc.block_tables)
    ja, ta = JLC.HostPageAllocator(NP), LC.HostPageAllocator(NP)
    bt0, lens0 = tc.block_tables, tc.lens
    for slot, n in ((0, 2), (1, 3)):
        pages = ta.alloc(slot, n)
        assert pages == ja.alloc(slot, n)
        jc = JLC.map_slot(jc, slot, pages)
        assert LC.map_slot(tc, slot, pages) is tc
    eq(tc.block_tables, jc.block_tables)
    for ow in (0, 1, 2):
        assert ta.owned(ow) == ja.owned(ow)
    eq(LC.pages_owned_mask(tc.block_tables, NP),
       JLC.pages_owned_mask(jc.block_tables, NP))
    jc = _fill_pools(np.random.default_rng(0), jc, tc)
    tc.lens[:] = torch.tensor([7, 11, 0])
    jc = jc._replace(lens=jnp.asarray([7, 11, 0], jnp.int32))
    assert_pools(tc.pools, jc.pools)

    jc = JLC.unmap_slot(JLC.reset_slot(jc, 1), 1)
    LC.unmap_slot(LC.reset_slot(tc, 1), 1)
    assert ta.release(1) == ja.release(1)
    assert ta.free_pages == ja.free_pages and not ta.can_alloc(5)
    pages = ta.alloc(2, 3)
    assert pages == ja.alloc(2, 3)
    jc = JLC.map_slot(jc, 2, pages)
    LC.map_slot(tc, 2, pages)
    eq(tc.lens, jc.lens)
    eq(tc.block_tables, jc.block_tables)
    eq(LC.pages_owned_mask(tc.block_tables, NP),
       JLC.pages_owned_mask(jc.block_tables, NP))
    assert_pools(tc.pools, jc.pools)
    assert tc.block_tables is bt0 and tc.lens is lens0
    with pytest.raises(RuntimeError):
        ta.alloc(0, 1)                       # slot 0 already owns pages
    with pytest.raises(ValueError):
        LC.map_slot(tc, 0, list(range(LC.num_blocks(tcfg, S) + 1)))


def test_identity_map_needs_enough_pages():
    _, tcfg = cfgs()
    with pytest.raises(ValueError, match="map_slots=False"):
        LC.init_ess_caches(tcfg, 3, 40, torch.float32, device="cpu",
                           num_pages=4)


@pytest.mark.parametrize("lens", [[10, 0], [3, 40]])
def test_invalidate_beyond_matches_reference(lens):
    """Counterpart of ``test_lru_pool::test_invalidate_beyond_removes_stale
    _entries``, on pools filled by random lookups and admissions."""
    B, P, S, D = 2, 8, 40, 4
    jp = JLP.init_pool(B, P, S, D, jnp.float32)
    tp = LP.init_pool(B, P, S, D, torch.float32, "cpu")
    jc = JLC.ESSCaches(jnp.zeros((B,), jnp.int32), None, (), (jp,))
    tc = LC.ESSCaches(torch.zeros(B, dtype=torch.long), None, [], [tp])
    jc = _fill_pools(np.random.default_rng(1), jc, tc, rounds=4)
    jp = JLP.invalidate_beyond(jc.pools[0], jnp.asarray(lens, jnp.int32))
    tp = LP.invalidate_beyond(tc.pools[0], torch.tensor(lens))
    assert_pools([tp], [jp])
    assert LP.check_consistent(tp)
    assert not (tp.ids >= torch.tensor(lens)[:, None]).any()


# ---------------------------------------------------------------------------
# Per-slot prefill chunk, LRU warmup
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = cfgs()
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    return jcfg, tcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def _slot_caches(jcfg, tcfg, B, S):
    """Paged caches with slots 0 and 2 mapped onto scattered pages."""
    NP = B * LC.num_blocks(tcfg, S)
    jc = JLC.init_ess_caches(jcfg, B, S, jnp.float32, num_pages=NP,
                             map_slots=False)
    tc = LC.init_ess_caches(tcfg, B, S, torch.float32, device="cpu",
                            num_pages=NP, map_slots=False)
    for slot, pages in ((2, [5, 1, 3]), (0, [0, 4, 2])):
        jc = JLC.map_slot(jc, slot, pages)
        LC.map_slot(tc, slot, pages)
    return jc, tc


def test_prefill_chunk_per_slot_ragged_matches_reference(model):
    """Slot 2 of a 3-slot cache: a full chunk, then a ragged one (5 valid
    positions padded to 8) with ``collect_tail`` and ``hidden_last``.
    Valid positions' logits, the tails, ``hidden_last``, ``lens``, the
    slot's indexer keys and host rows against the reference's
    ``ess_prefill_chunk``; the other slots untouched."""
    jcfg, tcfg, jp, tp = model
    B, S, C, slot = 3, 40, 8, 2
    jc, tc = _slot_caches(jcfg, tcfg, B, S)
    toks = np.random.default_rng(2).integers(0, 256, (1, 2 * C))
    chunk = jax.jit(JE.ess_prefill_chunk, static_argnums=(1,),
                    static_argnames=("want_logits", "collect_tail",
                                     "use_kernel"))
    for c0, nv in ((0, C), (C, 5)):
        t = np.zeros((1, C), np.int64)
        t[:, :nv] = toks[:, c0:c0 + nv]
        pos = np.arange(c0, c0 + C)[None]
        jl, jc, jtails, jh = chunk(
            jp, jcfg, jnp.asarray(t, jnp.int32), jnp.asarray(pos, jnp.int32),
            jc, slot=slot, want_logits=True, collect_tail=3, n_valid=nv)
        tl, new, ttails, th = TE.ess_prefill_chunk(
            tp, tcfg, torch.tensor(t), torch.tensor(pos), tc, slot=slot,
            want_logits=True, collect_tail=3, n_valid=nv)
        tc = new
        close(tl[:, :nv], np.asarray(jl)[:, :nv], "logits")
        close(th, jh, "hidden_last")
        assert len(ttails) == tcfg.num_layers
        for a, b in zip(ttails, jtails):
            close(a, b, "tails")
        eq(tc.lens, jc.lens)
    assert tc.lens.tolist() == [0, 0, 2 * C - 3]
    for layer in range(tcfg.num_layers):
        close(tc.ikeys[layer], jc.ikeys[layer], "ikeys")
    close(tc.host_latent, jc.host_latent, "host tier")
    assert not tc.ikeys[0][:2].any() and not tc.ikeys[0][2, 2 * C - 3:].any()


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_lru_warmup_pool_matches_reference(model, tier):
    """One layer's LRU warmup of slot 2 (W windows over a prefilled paged
    tier) into a fresh batch-1 pool: pool maps, stamps and step equal, the
    rows equal (exact gathers)."""
    jcfg, tcfg, jp, tp = model
    jcfg = dataclasses.replace(jcfg, ess=dataclasses.replace(
        jcfg.ess, host_cache_dtype=tier))
    tcfg = dataclasses.replace(tcfg, ess=dataclasses.replace(
        tcfg.ess, host_cache_dtype=tier))
    B, S, C, slot, n = 3, 40, 16, 2, 14
    jc, tc = _slot_caches(jcfg, tcfg, B, S)
    toks = np.random.default_rng(3).integers(0, 256, (1, C))
    toks[:, n:] = 0
    pos = np.arange(C)[None]
    _, jc, jtails, _ = jax.jit(
        JE.ess_prefill_chunk, static_argnums=(1,),
        static_argnames=("want_logits", "collect_tail"))(
        jp, jcfg, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
        jc, slot=slot, want_logits=False, collect_tail=C, n_valid=n)
    jc = jax.tree.map(np.asarray, jc)
    tc = LC.from_jax_caches(jc)
    W = tcfg.ess.warmup_windows
    layer = 1
    x_tail = np.asarray(jtails[layer])[:, n - W:n]
    P = tc.pools[layer].data.shape[1]
    D = tc.pools[layer].data.shape[2]
    jlp, _ = JE._layer_params(jp, jcfg, layer)
    jpool = jax.jit(JWU.lru_warmup, static_argnums=(6,),
                    static_argnames=("layer", "batch_offset"))(
        JLP.init_pool(1, P, S, D, jnp.float32), jc.host_latent,
        jnp.asarray(x_tail), jlp["indexer"],
        jnp.asarray(jc.ikeys[layer][slot:slot + 1]),
        jnp.asarray([n], jnp.int32), jcfg, slot_mask=None, layer=layer,
        batch_offset=slot, block_table=jnp.asarray(jc.block_tables),
        host_scales=None if jc.host_scales is None
        else jnp.asarray(jc.host_scales))
    lp, _ = TE._layer_params(tp, tcfg, layer)
    tpool = WU.lru_warmup(
        LP.init_pool(1, P, S, D, torch.float32, "cpu"), tc.host_latent,
        array_to_torch(x_tail), lp["indexer"], tc.ikeys[layer][slot:slot + 1],
        torch.tensor([n]), tcfg, slot_mask=None, layer=layer,
        batch_offset=slot, block_table=tc.block_tables,
        host_scales=tc.host_scales)
    for f in ("ids", "last_use", "slot_of", "step"):
        eq(getattr(tpool, f), getattr(jpool, f), f)
    eq(tpool.data, jpool.data, "data")
    assert int(tpool.step) == W and LP.check_consistent(tpool)


# ---------------------------------------------------------------------------
# Scheduler copy, chunk buckets
# ---------------------------------------------------------------------------

SCHED = [JS, TS]


@pytest.mark.parametrize("S", SCHED, ids=["reference", "port"])
def test_scheduler_admission_completion_preemption(S):
    s = S.Scheduler(num_slots=2, max_seq=64)
    for i in range(3):
        s.submit(S.Request(rid=i, prompt_len=8,
                           max_new_tokens=4 if i == 0 else 16))
    admitted = s.admit()
    assert [r.rid for _, r in admitted] == [0, 1]
    assert s.occupancy() == 1.0
    for _ in range(4):
        done = s.record_tokens({0: 1, 1: 1})
    assert any(r.rid == 0 for r in done)
    admitted2 = s.admit()
    assert [r.rid for _, r in admitted2] == [2]
    s.preempt(1)
    assert s.queue[0].rid == 1
    assert s.queue[0].preempted_count == 1


@pytest.mark.parametrize("S", SCHED, ids=["reference", "port"])
def test_scheduler_rejects_oversize(S):
    s = S.Scheduler(num_slots=1, max_seq=16)
    s.submit(S.Request(rid=0, prompt_len=20, max_new_tokens=4))
    assert s.admit() == []
    assert s.finished[0].rid == 0


@pytest.mark.parametrize("S", SCHED, ids=["reference", "port"])
def test_feasible_batch_size_formula(S):
    b = S.feasible_batch_size(hbm_bytes=80_000_000_000,
                              weight_bytes_per_dev=41_000_000_000,
                              cache_bytes_per_seq=600_000_000)
    assert 40 <= b <= 60


def test_scheduler_copy_decides_as_the_reference():
    """A mixed trace (priorities, a gate, stop, abort, preemption, a
    router pick) drives both schedulers to the same decisions."""
    out = []
    for S in SCHED:
        gate_calls = []

        def gate(req):
            gate_calls.append(req.rid)
            return req.rid != 4 or len(gate_calls) > 6
        s = S.Scheduler(num_slots=2, max_seq=40, admission_gate=gate)
        for i, (pl, pr) in enumerate([(8, 0), (30, 1), (12, 2), (50, 0),
                                      (9, 3), (10, 0)]):
            s.submit(S.Request(rid=i, prompt_len=pl, max_new_tokens=6,
                               priority=pr))
        trace = []
        for step in range(12):
            trace.append([(i, r.rid) for i, r in s.admit()])
            if step == 2:
                s.preempt(0)
            if step == 3 and s.running:
                s.abort(min(s.running))
            for i in s.active_slots() + s.prefill_slots():
                s.promote(i)
            done = s.record_tokens({i: 1 for i in s.active_slots()})
            trace.append(sorted(r.rid for r in done))
        trace.append([(r.rid, r.finish_reason, r.generated,
                       r.preempted_count) for r in s.finished])
        loads = [S.WorkerLoad(0, 100, 1, 3), S.WorkerLoad(1, 100, 2, 1),
                 S.WorkerLoad(2, 10, 4, 0)]
        trace.append(S.pick_decode_worker(loads, 50))
        out.append((trace, gate_calls))
    assert out[0] == out[1]


@pytest.mark.parametrize("ck,pc", [(1, 64), (3, 8), (8, 8), (9, 64),
                                   (100, 64)])
def test_chunk_bucket_matches_reference(ck, pc):
    assert TSP.chunk_bucket(ck, pc) == JSP.chunk_bucket(ck, pc)
