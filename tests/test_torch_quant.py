"""The quantized (int8 / fp8) host tier and the slot page path of the port
against the JAX package, on the CPU, at smoke size.

* The row quantizer (``repro_torch.distributed.compression``) bit for bit,
  edge cases included, against the reference's as its compiled serve path
  runs it (under ``jax.jit``: XLA computes ``amax / qmax`` as
  ``amax * (1 / qmax)``, which the port follows).
* The plain versions of the three new gather kernels bit for bit against
  the reference's Pallas kernels in interpret mode.
* ``gather_tier_rows`` / ``scatter_tier_rows(_stacked)``, ``slot_latents``
  and ``graft_slot``, paged and dense, bf16 and quantized tiers: equal.
* Prefill + teacher-forced decode with an int8 / fp8 tier against the
  reference's quantized tier at the same chunk size.  fp32: logits at
  rtol/atol 1e-5; lens, block tables, pool maps, tier payload and scales
  equal.  bf16: logits at 5e-2 and the first greedy token equal.  The fp32
  reference runs its Pallas kernels (interpret mode): a quantized tier's
  miss rows are bf16 even under fp32 params, and the reference's plain
  attend then rounds the softmax weights to bf16 (``p.astype(rows.dtype)``)
  while its Pallas kernel, which the port's sparse-MLA kernel follows,
  keeps them in fp32 (a 1e-3 difference in the logits).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cache import latent_cache as JLC
from repro.configs import get_config as jget
from repro.core import offload as JOF
from repro.distributed import compression as JC
from repro.kernels.gather_cache import ops as jgops
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.core import offload as OF
from repro_torch.distributed import compression as TC
from repro_torch.kernels.gather_cache import ops as gops
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

CFG = "deepseek-v32-exp-ess-smoke"
QNAMES = ["int8", "fp8"]
TIERS = ["bf16", "int8", "fp8"]
jquant = jax.jit(JC.quantize_rows, static_argnums=1)
jdequant = jax.jit(JC.dequantize_rows, static_argnums=2)


def T(a):
    return array_to_torch(np.asarray(a))


def bits(x):
    """Raw bytes of an array or tensor (bitwise comparison, -0 and NaN
    included)."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.uint8).numpy() if x.dtype.itemsize == 1 \
            else x.view(torch.int16 if x.dtype.itemsize == 2
                        else torch.int32).numpy().view(np.uint8)
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(np.uint8)


def assert_bits(got, want):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def cfgs(tier="bf16", dt="f32", paged=True):
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dt]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[dt]
    j, t = jget(CFG), tget(CFG)
    j = dataclasses.replace(j, param_dtype=jdt, ess=dataclasses.replace(
        j.ess, host_cache_dtype=tier, paged_host=paged))
    t = dataclasses.replace(t, param_dtype=tdt, ess=dataclasses.replace(
        t.ess, host_cache_dtype=tier, paged_host=paged))
    return j, t


# ---------------------------------------------------------------------------
# the row quantizer
# ---------------------------------------------------------------------------

def edge_rows():
    """All-zero rows, a zero row between live rows (sentinel), rows that
    hit the rail, negative-only rows, rows whose f16 scale is subnormal,
    and plain normal rows."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((40, 64)).astype(np.float32)
    x[0] = 0.0
    x[2] = 0.0
    x[3] = [1000.0, -1000.0, 999.9, 0.25] * 16
    x[4:9] = -np.abs(x[4:9]) - 0.1
    x[9:20] *= 1e-5 * rng.random((11, 1))
    x[20:24] *= 1e4
    return x


@pytest.mark.parametrize("name", QNAMES)
@pytest.mark.parametrize("src", ["f32", "bf16"])
def test_quantize_rows_bitwise_with_edge_cases(name, src):
    x = edge_rows()
    rng = np.random.default_rng(1)
    x = np.concatenate([x, (rng.standard_normal((500, 64)) * 10.0
                            ** rng.uniform(-6, 3, (500, 1))).astype(
                                np.float32)])
    xin = x if src == "f32" else x.astype(jnp.bfloat16)
    jq, js = jquant(jnp.asarray(xin), JC.CACHE_QUANT_DTYPES[name])
    tq, ts = TC.quantize_rows(T(xin), TC.CACHE_QUANT_DTYPES[name])
    assert tq.dtype == TC.CACHE_QUANT_DTYPES[name]
    assert ts.dtype == TC.SCALE_DTYPE and tuple(ts.shape) == (len(x), 1)
    assert_bits(tq, jq)
    assert_bits(ts, js)
    # the edge cases themselves
    assert float(ts[0]) == 0.0 and float(ts[2]) == 0.0
    assert (tq[0].float() == 0).all() and (tq[2].float() == 0).all()
    assert tq[3].float().abs().max() == TC.quant_max(tq.dtype)
    for out in ("bf16", "f32"):
        jd = jdequant(jq, js, {"bf16": jnp.bfloat16,
                               "f32": jnp.float32}[out])
        td = TC.dequantize_rows(tq, ts, {"bf16": torch.bfloat16,
                                         "f32": torch.float32}[out])
        assert_bits(td, jd)
    assert (TC.dequantize_rows(tq, ts)[4:9] <= 0).all()


def test_wire_nbytes_and_row_bytes_match_reference():
    for tier in TIERS:
        jcfg, tcfg = cfgs(tier, "bf16")
        assert LC.host_row_bytes(tcfg) == JLC.host_row_bytes(jcfg)
        assert LC.host_page_bytes(tcfg) == JLC.host_page_bytes(jcfg)
        assert LC.pages_for_len(tcfg, 33) == JLC.pages_for_len(jcfg, 33)
        jc = JLC.init_ess_caches(jcfg, 2, 40, jnp.bfloat16)
        tc = LC.init_ess_caches(tcfg, 2, 40, torch.bfloat16, device="cpu")
        assert LC.tier_nbytes(tc) == JC.wire_nbytes(jc.host_latent,
                                                    jc.host_scales)
    full = tget("deepseek-v32-exp-ess")
    q8 = dataclasses.replace(full, ess=dataclasses.replace(
        full.ess, host_cache_dtype="int8"))
    assert (LC.host_row_bytes(full), LC.host_row_bytes(q8)) == (1152, 578)


# ---------------------------------------------------------------------------
# plain versions of the gather kernels vs the Pallas kernels (interpret)
# ---------------------------------------------------------------------------

def quantized(rng, shape, name):
    rows = rng.standard_normal(shape).astype(np.float32)
    q, s = jquant(jnp.asarray(rows.astype(jnp.bfloat16)),
                  JC.CACHE_QUANT_DTYPES[name])
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize("name", QNAMES)
@pytest.mark.parametrize("S,D,M", [(64, 80, 16), (33, 40, 7),
                                   (100, 576, 33)])
@pytest.mark.parametrize("out", ["bf16", "f32"])
def test_gather_rows_dequant_plain_matches_pallas_bitwise(name, S, D, M,
                                                          out):
    rng = np.random.default_rng(2)
    q, s = quantized(rng, (S, D), name)
    ids = rng.integers(-3, S + 2, (M,)).astype(np.int32)
    ids[0] = -1
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f32": (jnp.float32, torch.float32)}[out]
    want = jgops.gather_rows_dequant(jnp.asarray(q), jnp.asarray(s),
                                     jnp.asarray(ids), jdt)
    got = gops.gather_rows_dequant(T(q), T(s), T(ids).long(), tdt)
    assert got.dtype == tdt
    assert_bits(got, want)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_gather_pages_plain_matches_pallas_bitwise(page, dt):
    rng = np.random.default_rng(3)
    np_dt = {"f32": np.float32, "bf16": jnp.bfloat16}[dt]
    cache = rng.standard_normal((3, 64, 32)).astype(np_dt)
    pids = rng.integers(-1, 64 // page + 2, (3, 5)).astype(np.int32)
    want = jgops.gather_pages(jnp.asarray(cache), jnp.asarray(pids), page)
    assert_bits(gops.gather_pages(T(cache), T(pids).long(), page), want)
    want0 = jgops.gather_pages(jnp.asarray(cache[1]), jnp.asarray(pids[1]),
                               page)
    assert_bits(gops.gather_pages(T(cache[1]), T(pids[1]).long(), page),
                want0)


@pytest.mark.parametrize("name", QNAMES)
@pytest.mark.parametrize("page", [4, 8])
def test_gather_pages_dequant_plain_matches_pallas_bitwise(name, page):
    rng = np.random.default_rng(4)
    q, s = quantized(rng, (2, 64, 32), name)
    pids = rng.integers(0, 64 // page + 1, (2, 5)).astype(np.int32)
    for out in (jnp.bfloat16, jnp.float32):
        want = jgops.gather_pages_dequant(jnp.asarray(q), jnp.asarray(s),
                                          jnp.asarray(pids), page, out)
        got = gops.gather_pages_dequant(
            T(q), T(s), T(pids).long(), page,
            torch.bfloat16 if out == jnp.bfloat16 else torch.float32)
        assert_bits(got, want)


def test_scatter_rows_refuses_unquantized_rows_into_a_quantized_tier():
    for qdt in (torch.int8, torch.float8_e4m3fn):
        dst = torch.zeros((4, 16), dtype=qdt)
        with pytest.raises(TypeError, match="quantize"):
            gops.scatter_rows(dst, torch.tensor([1]),
                              torch.ones((1, 16), dtype=torch.bfloat16))
    # float rows still cast into a float tier; scale rows (f16) scatter
    dst = torch.zeros((4, 1), dtype=torch.float16)
    gops.scatter_rows(dst, torch.tensor([2, -1]),
                      torch.tensor([[0.5], [9.0]], dtype=torch.float16))
    assert dst[:, 0].tolist() == [0.0, 0.0, 0.5, 0.0]


# ---------------------------------------------------------------------------
# tier transfers, slot pages and the graft
# ---------------------------------------------------------------------------

def tier_setup(tier, paged):
    jcfg, tcfg = cfgs(tier, "f32", paged)
    B, S = 3, 40
    jc = JLC.init_ess_caches(jcfg, B, S, jnp.float32)
    rng = np.random.default_rng(5)
    bt = None
    if paged:
        NP = jc.host_latent.shape[1]
        bt = rng.permutation(NP).reshape(B, -1).astype(np.int32)
        bt[2, 1] = -1                                  # an unmapped page
        jc = jc._replace(block_tables=jnp.asarray(bt))
    tc = LC.from_jax_caches(jax.tree.map(np.asarray, jc))
    return jcfg, tcfg, jc, tc, rng


jscatter = jax.jit(JOF.scatter_tier_rows, static_argnames=("layer",))
jscatter_stacked = jax.jit(JOF.scatter_tier_rows_stacked,
                           static_argnames=("batch_offset",))
jgraft = jax.jit(JLC.graft_slot, static_argnums=(1, 3))


@pytest.mark.parametrize("tier", QNAMES)
@pytest.mark.parametrize("paged", [True, False])
def test_tier_scatter_and_gather_match_reference(tier, paged):
    jcfg, tcfg, jc, tc, rng = tier_setup(tier, paged)
    D, Lh = jcfg.mla.latent_dim, jcfg.num_layers
    bt_j, bt_t = jc.block_tables, tc.block_tables
    jh, js = jc.host_latent, jc.host_scales
    th, ts = tc.host_latent, tc.host_scales
    ids = np.array([[0, 5, 17, 39], [1, 2, 3, -1], [38, 0, 20, 45]],
                   np.int32)
    mask = np.array([True, False, True])
    for layer in (0, Lh - 1):
        rows = rng.standard_normal((3, 4, D)).astype(np.float32)
        jh, js = jscatter(jh, js, jnp.asarray(ids), jnp.asarray(rows),
                          slot_mask=jnp.asarray(mask), layer=layer,
                          block_table=bt_j)
        th, ts = OF.scatter_tier_rows(th, ts, T(ids).long(), T(rows),
                                      slot_mask=T(mask), layer=layer,
                                      block_table=bt_t)
        assert_bits(th, jh)
        assert_bits(ts, js)
        for out in (None, jnp.float32):
            want = JOF.gather_tier_rows(jh, js, jnp.asarray(ids), layer=layer,
                                        block_table=bt_j, out_dtype=out)
            got = OF.gather_tier_rows(
                th, ts, T(ids).long(), layer=layer, block_table=bt_t,
                out_dtype=None if out is None else torch.float32)
            assert got.dtype == (torch.bfloat16 if out is None
                                 else torch.float32)
            assert_bits(got, want)
    rows_l = rng.standard_normal((Lh, 1, 4, D)).astype(np.float32)
    ids1 = ids[2:3]
    jh, js = jscatter_stacked(jh, js, jnp.asarray(ids1), jnp.asarray(rows_l),
                              slot_mask=None, batch_offset=2,
                              block_table=bt_j)
    OF.scatter_tier_rows_stacked(th, ts, T(ids1).long(), T(rows_l),
                                 slot_mask=None, batch_offset=2,
                                 block_table=bt_t)
    assert_bits(th, jh)
    assert_bits(ts, js)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("paged", [True, False])
def test_init_slot_latents_and_graft_match_reference(tier, paged):
    jcfg, tcfg = cfgs(tier, "bf16", paged)
    Lh, D, S = jcfg.num_layers, jcfg.mla.latent_dim, 40
    rng = np.random.default_rng(6)
    # a donor (batch 1) with written rows, a live pool and indexer keys
    jd = JLC.init_ess_caches(jcfg, 1, S, jnp.bfloat16)
    assert LC.init_ess_caches(tcfg, 1, S, torch.bfloat16, device="cpu") \
        .host_latent.shape == jd.host_latent.shape
    n = 27
    rows = rng.standard_normal((Lh, 1, n, D)).astype(np.float32)
    ids = np.arange(n, dtype=np.int32)[None]
    h, s = jscatter_stacked(jd.host_latent, jd.host_scales, jnp.asarray(ids),
                            jnp.asarray(rows).astype(jnp.bfloat16),
                            slot_mask=None, batch_offset=0,
                            block_table=jd.block_tables)
    pools = tuple(p._replace(
        data=jnp.asarray(rng.standard_normal(p.data.shape), jnp.bfloat16),
        ids=p.ids.at[0, :3].set(jnp.array([4, 9, 2])),
        last_use=p.last_use.at[0, :3].set(jnp.array([7, 2, 0])),
        slot_of=p.slot_of.at[0, jnp.array([4, 9, 2])].set(
            jnp.arange(3)), step=p.step + 5) for p in jd.pools)
    ikeys = tuple(jnp.asarray(rng.standard_normal(k.shape), k.dtype)
                  for k in jd.ikeys)
    jd = jd._replace(lens=jnp.array([n], jnp.int32), host_latent=h,
                     host_scales=s, pools=pools, ikeys=ikeys)
    td = LC.from_jax_caches(jax.tree.map(np.asarray, jd))
    assert (td.host_scales is None) == (tier == "bf16")
    assert_bits(LC.slot_latents(td, 0), JLC.slot_latents(jd, 0))

    jf = JLC.init_ess_caches(jcfg, 4, S, jnp.bfloat16)
    if paged:                        # a permuted table, one page unmapped
        bt = rng.permutation(jf.host_latent.shape[1]).reshape(4, -1)
        bt[1, -1] = -1
        jf = jf._replace(block_tables=jnp.asarray(bt, jnp.int32))
    jf = jf._replace(pools=tuple(p._replace(step=p.step + 3)
                                 for p in jf.pools))
    tf = LC.from_jax_caches(jax.tree.map(np.asarray, jf))
    for slot in (2, 1):
        jf = jgraft(jf, slot, jd, n)
        tf = LC.graft_slot(tf, slot, td, n)
        assert_bits(tf.host_latent, jf.host_latent)
        if tier != "bf16":
            assert_bits(tf.host_scales, jf.host_scales)
        np.testing.assert_array_equal(tf.lens.numpy(), np.asarray(jf.lens))
        for a, b in zip(tf.ikeys, jf.ikeys):
            assert_bits(a, b)
        for a, b in zip(tf.pools, jf.pools):
            for f in ("ids", "last_use", "slot_of", "step"):
                np.testing.assert_array_equal(getattr(a, f).numpy(),
                                              np.asarray(getattr(b, f)))
            assert_bits(a.data, b.data)
        assert_bits(LC.slot_latents(tf, slot),
                    JLC.slot_latents(jf, slot))
    if tier != "bf16":
        # the grafted rows are the donor's, dequantized and requantized
        want = TC.dequantize_rows(*TC.quantize_rows(
            LC.slot_latents(td, 0)[:, :n], tf.host_latent.dtype),
            torch.bfloat16)
        assert_bits(LC.slot_latents(tf, 2)[:, :n], want)


# ---------------------------------------------------------------------------
# prefill + teacher-forced decode against the reference's quantized tier
# ---------------------------------------------------------------------------

B, S, MAX_SEQ, CHUNK, STEPS = 2, 20, 32, 8, 3
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=5e-2, atol=5e-2)}


def prompts():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    return toks, np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)


@pytest.fixture(scope="module",
                params=[("f32", "int8"), ("f32", "fp8"), ("bf16", "int8")],
                ids=lambda p: "-".join(p))
def reference(request):
    """The reference's prefill + STEPS teacher-forced decode steps with a
    quantized tier (jit'd, as its serve path runs)."""
    dt, tier = request.param
    jcfg, tcfg = cfgs(tier, dt)
    jp = jax.jit(lambda k: jinit(k, JT.model_def(jcfg)))(jax.random.key(0))
    toks, pos = prompts()
    uk = dt == "f32"
    prefill = jax.jit(functools.partial(JE.ess_prefill, use_kernel=uk),
                      static_argnums=(1, 4),
                      static_argnames=("prefill_chunk",))
    decode = jax.jit(functools.partial(JE.ess_decode, use_kernel=uk),
                     static_argnums=(1,))
    logits, caches = prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             MAX_SEQ, prefill_chunk=CHUNK)
    out = {"dt": dt, "tcfg": tcfg, "jp": jp,
           "prefill": (np.asarray(logits), jax.tree.map(np.asarray, caches)),
           "steps": []}
    tok = np.asarray(jnp.argmax(logits[:, -1], -1))
    for _ in range(STEPS):
        p = np.asarray(caches.lens)[:, None]
        o = decode(jp, jcfg, jnp.asarray(tok[:, None]), jnp.asarray(p),
                   caches)
        caches = o.caches
        out["steps"].append((tok, p, np.asarray(o.logits),
                             jax.tree.map(np.asarray, caches)))
        tok = np.asarray(jnp.argmax(o.logits[:, 0], -1))
    return out


def assert_quant_caches(tc, jc, dt):
    np.testing.assert_array_equal(tc.lens.numpy(), jc.lens)
    np.testing.assert_array_equal(tc.block_tables.numpy(), jc.block_tables)
    assert tc.host_latent.dtype != torch.float32
    if dt != "f32":
        return
    assert_bits(tc.host_latent, jc.host_latent)
    assert_bits(tc.host_scales, jc.host_scales)
    for layer, (tp, jp) in enumerate(zip(tc.pools, jc.pools)):
        for f in ("ids", "last_use", "slot_of", "step"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          getattr(jp, f), err_msg=f)
        np.testing.assert_allclose(tp.data.numpy(), jp.data, **TOL[dt])
        np.testing.assert_allclose(tc.ikeys[layer].numpy(), jc.ikeys[layer],
                                   **TOL[dt])


def test_quantized_prefill_and_decode_match_reference(reference):
    dt, tcfg = reference["dt"], reference["tcfg"]
    tp = from_jax_params(jax.tree.map(np.asarray, reference["jp"]))
    toks, pos = prompts()
    logits, caches = TE.ess_prefill(tp, tcfg, T(toks).long(), T(pos).long(),
                                    MAX_SEQ, prefill_chunk=CHUNK)
    want, jc = reference["prefill"]
    np.testing.assert_allclose(logits.float().numpy(),
                               want.astype(np.float32), **TOL[dt])
    np.testing.assert_array_equal(logits[:, -1].float().argmax(-1).numpy(),
                                  want[:, -1].astype(np.float32).argmax(-1))
    assert_quant_caches(caches, jc, dt)
    for tok, p, jlogits, jc in reference["steps"]:
        o = TE.ess_decode(tp, tcfg, T(tok[:, None]).long(), T(p).long(),
                          caches)
        caches = o.caches
        np.testing.assert_allclose(o.logits.float().numpy(),
                                   jlogits.astype(np.float32), **TOL[dt])
        assert_quant_caches(caches, jc, dt)


def test_generate_batch_reports_quantized_tier_bytes():
    _, tcfg = cfgs("int8", "bf16")
    _, bcfg = cfgs("bf16", "bf16")
    from repro_torch.models.params import init_params
    params = init_params(tcfg, 0, device="cpu")
    toks, _ = prompts()
    res = TE.generate_batch(params, tcfg, toks, 3, MAX_SEQ, prefill_chunk=8,
                            device="cpu")
    assert res.logits_finite and res.misses.sum() > 0
    D = tcfg.mla.latent_dim
    assert res.tier_bytes == LC.tier_nbytes(res.caches)
    assert res.tier_bytes * 2 * D == LC.tier_nbytes(LC.init_ess_caches(
        bcfg, B, MAX_SEQ, device="cpu")) * (D + 2)
    np.testing.assert_array_equal(
        res.miss_bytes, (res.misses - res.overflow).sum(1) * (D + 2))
