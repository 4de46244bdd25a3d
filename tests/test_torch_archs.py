"""The GQA family and DeepSeek-V3's dense-MLA branch on the port's generic
path (``models/{attention,blocks,transformer,params,layers}``,
``generic_prefill`` / ``generic_decode``) against the reference on the
CPU, at smoke scale.

The same numpy-seeded inputs and the reference's own parameters
(``from_jax_params``) go through both packages.  The reference runs
jitted once per mode with XLA's ``xla_allow_excess_precision`` off (every
op rounded to its dtype, as torch's; ``test_torch_monolithic.py`` says
why).  Tolerances: logits and caches 1e-4 (fp32) and 2e-2 (bf16); the
port's prefill + decode against its own train logits within the
reference's bound, ``2e-2 + 2e-2 * max|ref|``.

Reference tests this file counts as covered:

* ``test_models::test_train_forward_shapes_no_nan`` and
  ``test_models::test_prefill_decode_consistent_with_train`` for
  qwen3-0.6b, gemma2-27b, gemma3-27b, qwen1.5-110b, dbrx-132b,
  deepseek-v3-671b and qwen2-vl-7b (their ``-smoke`` configs)
* ``test_models::test_sliding_window_masks_differ``
* ``test_models::test_moe_routing_invariants``
* ``test_models::test_deepseek_router_bias_selection_only``
* ``test_models::test_full_config_param_counts``: its entries for the
  seven configs above
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import moe as JMoE
from repro.models import transformer as JT
from repro.models.params import count_params as jcount
from repro.models.params import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MoE
from repro_torch.models import transformer as T
from repro_torch.models.params import (count_params, from_jax_params,
                                       init_params, model_def)
from repro_torch.serving import engine as E

SMOKES = ["qwen3-0.6b-smoke", "gemma2-27b-smoke", "gemma3-27b-smoke",
          "qwen1.5-110b-smoke", "dbrx-132b-smoke", "deepseek-v3-671b-smoke",
          "qwen2-vl-7b-smoke"]
TOL = {"f32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=2e-2, atol=2e-2)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}
# the reference test's sizes: prefill S, decode into Smax; ROUNDS
# teacher-forced decode steps after the prefill
B, S, SMAX, ROUNDS = 2, 16, 24, 3


def f32(t):
    return t.detach().float().numpy()


def close(t, j, dt):
    np.testing.assert_allclose(f32(t), np.asarray(j, np.float32), **TOL[dt])


def close_cache(t, j, dt):
    """A cache plane: fp32 at 1e-4; bf16 within 2e-2 of the plane's scale
    (``max|ref|``, at least 1), as the reference's own bounds measure:
    summation orders of bf16 products differ between XLA and torch, and a
    flipped last bit of the residual (one ulp is 0.0625 at gemma's
    embedding scale) moves the next layers' normalized keys by a few
    hundredths."""
    j = np.asarray(j, np.float32)
    tol = TOL[dt] if dt == "f32" else dict(
        rtol=2e-2, atol=2e-2 * max(1.0, float(np.abs(j).max())))
    np.testing.assert_allclose(f32(t), j, **tol)


def ref_compiled(fn, *args):
    """``fn`` jitted for ``args``, every op rounded to its dtype (LLVM's
    expensive passes off: a third of the compile time, the same float
    operations)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False,
                          "xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})


def configs(name, dt):
    jdt, tdt = DT[dt]
    return (dataclasses.replace(jget(name), param_dtype=jdt),
            dataclasses.replace(tget(name), param_dtype=tdt))


@functools.lru_cache(maxsize=None)
def _ref_params_f32(name):
    jcfg = configs(name, "f32")[0]
    key = jax.random.key(0)
    return ref_compiled(lambda k: jinit(k, JT.model_def(jcfg)), key)(key)


@functools.lru_cache(maxsize=None)
def ref_params(name, dt):
    """The reference's parameters at ``dt`` (jitted init, once per config:
    its bf16 leaves are its fp32 draws rounded, ``normal * std`` cast to
    the leaf's dtype) and the same tree in the port."""
    jdefs = JT.model_def(configs(name, dt)[0])
    jp = jax.tree.map(lambda a, d: a.astype(d.dtype), _ref_params_f32(name),
                      jdefs, is_leaf=lambda x: hasattr(x, "init"))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def inputs(jcfg, n):
    """Token ids, or bf16 embeddings (the same bits in both packages),
    positions and, for M-RoPE, t = h = w = position (the reference's)."""
    rng = np.random.default_rng(1)
    if jcfg.embedding_inputs:
        e = jnp.asarray(rng.standard_normal((B, n, jcfg.d_model)),
                        jnp.bfloat16)
        ins = (e, from_jax_params(np.asarray(e)))
    else:
        t = rng.integers(0, jcfg.vocab_size, (B, n))
        ins = (jnp.asarray(t), torch.tensor(t))
    pos = np.broadcast_to(np.arange(n)[None], (B, n)).copy()
    mrope = None
    if jcfg.mrope_sections is not None:
        mrope = np.broadcast_to(pos[..., None], (B, n, 3)).copy()
    return ins, pos, mrope


@pytest.fixture(scope="module", params=[(n, d) for n in SMOKES
                                        for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """Both packages' parameters; the reference's train forward over S + 1
    tokens, its prefill over S and ROUNDS teacher-forced decode steps from
    the padded prefill caches, each mode jitted once."""
    name, dt = request.param
    jcfg, tcfg = configs(name, dt)
    jp, tp = ref_params(name, dt)
    (jin, tin), pos, mrope = inputs(jcfg, S + ROUNDS)
    jpos = jnp.asarray(pos)
    jm = None if mrope is None else jnp.asarray(mrope)
    key = "mla" if jcfg.attn_kind == "mla" else "kv"

    def mode_fn(mode):
        return lambda p, t, q, c, mr: JT.forward(
            p, jcfg, t, q, mode=mode, caches=c, mrope_positions=mr)
    args = (jp, jin[:, :S + 1], jpos[:, :S + 1], None,
            None if jm is None else jm[:, :S + 1])
    train = ref_compiled(mode_fn("train"), *args)(*args)
    args = (jp, jin[:, :S], jpos[:, :S], None,
            None if jm is None else jm[:, :S])
    pf = ref_compiled(mode_fn("prefill"), *args)(*args)
    cm = dict(pf.caches)
    cm[key] = jax.tree.map(
        lambda a: jnp.pad(a, [(0, 0), (0, 0), (0, SMAX - S)]
                          + [(0, 0)] * (a.ndim - 3)), cm[key])
    dec, step = [], None
    for r in range(ROUNDS):
        args = (jp, jin[:, S + r:S + r + 1], jpos[:, S + r:S + r + 1], cm,
                None)
        step = step or ref_compiled(mode_fn("decode"), *args)
        o = step(*args)
        cm = o.caches
        dec.append(np.asarray(o.logits))
    return dict(name=name, dt=dt, jcfg=jcfg, tcfg=tcfg, tp=tp, tin=tin,
                pos=pos, mrope=mrope, key=key, train=train, prefill=pf,
                decode=dec, dcaches=cm)


def tt(a):
    return None if a is None else torch.tensor(np.ascontiguousarray(a))


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled():
    """Free the reference's executables after this file: each XLA CPU
    executable holds memory maps, and a worker that runs many files nears
    the kernel's per-process limit (ROADMAP Queue 3 item 2)."""
    yield
    ref_params.cache_clear()
    _ref_params_f32.cache_clear()
    _moe_params.cache_clear()
    jax.clear_caches()


def test_train_forward_matches_reference(model):
    """``test_train_forward_shapes_no_nan``: shapes, finite logits; and
    the logits (and the MoE statistics) against the reference's."""
    n = S + 1
    mr = model["mrope"]
    out = T.forward(model["tp"], model["tcfg"], model["tin"][:, :n],
                    tt(model["pos"][:, :n]), mode="train",
                    mrope_positions=None if mr is None else tt(mr[:, :n]))
    ref = model["train"]
    assert out.caches is None
    assert out.logits.shape == (B, n, model["tcfg"].vocab_size)
    assert bool(torch.isfinite(out.logits).all())
    close(out.logits, ref.logits, model["dt"])
    for k in ("moe_lb", "moe_dropped"):
        np.testing.assert_allclose(float(out.aux[k]), float(ref.aux[k]),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel-route"])
def test_generic_prefill_decode_matches_reference(model, use_kernel):
    """``generic_prefill`` on S tokens, then ROUNDS ``generic_decode``
    steps fed the same tokens from the padded caches (written in place):
    the logits of each, the caches after prefill and after the last step.
    ``use_kernel`` takes MLA's kernel routes' plain versions (GQA has no
    kernel: both ids run the same path)."""
    tcfg, tp, tin, key = model["tcfg"], model["tp"], model["tin"], model["key"]
    mr = model["mrope"]
    pos = tt(model["pos"])
    pf = E.generic_prefill(tp, tcfg, tin[:, :S], pos[:, :S], device="cpu",
                           mrope_positions=None if mr is None
                           else tt(mr[:, :S]), use_kernel=use_kernel)
    close(pf.logits, model["prefill"].logits, model["dt"])
    for a, j in zip(pf.caches[key], model["prefill"].caches[key]):
        close_cache(a, j, model["dt"])
    assert pf.caches["lens"].tolist() == [S] * B
    caches = T.pad_caches(pf.caches, SMAX)
    first = caches[key][0]
    for r in range(ROUNDS):
        o = E.generic_decode(tp, tcfg, tin[:, S + r:S + r + 1],
                             caches["lens"][:, None], caches, device="cpu",
                             use_kernel=use_kernel)
        assert o.caches is caches and caches[key][0] is first
        close(o.logits, model["decode"][r], model["dt"])
    for a, j in zip(caches[key], model["dcaches"][key]):
        close_cache(a, j, model["dt"])
    assert caches["lens"].tolist() == [S + ROUNDS] * B


def test_prefill_decode_consistent_with_train(model):
    """The reference's own bound on the port alone: a prefill over S
    tokens and one decode step give the last position's logits of a train
    forward over S + 1, within ``2e-2 + 2e-2 * max|ref|``."""
    tcfg, tp, tin = model["tcfg"], model["tp"], model["tin"]
    mr = model["mrope"]
    pos = tt(model["pos"])
    ref = T.forward(tp, tcfg, tin[:, :S + 1], pos[:, :S + 1], mode="train",
                    mrope_positions=None if mr is None
                    else tt(mr[:, :S + 1])).logits[:, -1]
    pf = E.generic_prefill(tp, tcfg, tin[:, :S], pos[:, :S], device="cpu",
                           mrope_positions=None if mr is None
                           else tt(mr[:, :S]))
    caches = T.pad_caches(pf.caches, SMAX)
    dec = E.generic_decode(tp, tcfg, tin[:, S:S + 1], pos[:, S:S + 1],
                           caches, device="cpu")
    err = float((dec.logits[:, -1] - ref).abs().max())
    scale = float(ref.abs().max())
    assert err < 2e-2 + 2e-2 * scale, (model["name"], err, scale)


def test_sliding_window_masks_differ():
    """gemma2's local layers do not attend past the window (16): a token
    far outside the last position's window still moves its logits (the
    global layers), and no earlier position's."""
    cfg = dataclasses.replace(tget("gemma2-27b-smoke"),
                              param_dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    n = 32
    rng = np.random.default_rng(1)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (1, n)))
    pos = torch.arange(n)[None]
    base = T.forward(params, cfg, toks, pos, mode="train").logits
    toks2 = toks.clone()
    toks2[0, 2] = (toks2[0, 2] + 1) % cfg.vocab_size
    pert = T.forward(params, cfg, toks2, pos, mode="train").logits
    assert float((pert[0, -1] - base[0, -1]).abs().max()) > 0
    torch.testing.assert_close(pert[0, 1], base[0, 1], rtol=0, atol=0)
    # the mask itself: a local query sees exactly its last 16 positions
    bias = A.causal_mask_bias(pos, pos, 16)
    ok = bias[0] == 0
    assert ok[31].nonzero().flatten().tolist() == list(range(16, 32))
    assert bool(ok[5, :6].all()) and not bool(ok[5, 6:].any())


@functools.lru_cache(maxsize=None)
def _moe_params(name):
    """The reference's MoE parameters in fp32 (the port's MoE multiplies
    operands of one dtype; the reference's test feeds fp32 inputs)."""
    jcfg = configs(name, "f32")[0]
    key = jax.random.key(0)
    jp = ref_compiled(lambda k: jinit(k, JMoE.moe_def(jcfg)), key)(key)
    return jcfg, jp, from_jax_params(jax.tree.map(np.asarray, jp))


def ref_moe(p, jcfg, x, train=False):
    return ref_compiled(lambda q, v: JMoE.moe_apply(q, jcfg, v, train=train),
                        p, x)(p, x)


def test_moe_routing_invariants():
    """dbrx's softmax top-4 of 16 (smoke: top-2 of 4): the output matches
    the reference's; some tokens drop at capacity factor 2, none at 8."""
    jcfg, jp, tp = _moe_params("dbrx-132b-smoke")
    tcfg = configs("dbrx-132b-smoke", "f32")[1]
    x = (np.random.default_rng(1).standard_normal((2, 16, jcfg.d_model))
         * 0.5).astype(np.float32)
    y, aux = MoE.moe_apply(tp, tcfg, torch.tensor(x), train=True)
    jy, jaux = ref_moe(jp, jcfg, jnp.asarray(x), train=True)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    np.testing.assert_allclose(f32(y), np.asarray(jy), rtol=1e-4, atol=1e-5)
    assert 0.0 <= float(aux.dropped_fraction) < 1.0
    assert float(aux.dropped_fraction) == float(jaux.dropped_fraction)
    big = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=8.0))
    assert float(MoE.moe_apply(tp, big, torch.tensor(x),
                               train=True)[1].dropped_fraction) == 0.0


@pytest.mark.parametrize("name", ["dbrx-132b-smoke",
                                  "deepseek-v3-671b-smoke"])
def test_moe_unbound_capacity_runs_in_token_chunks(name, monkeypatch):
    """With the capacity unbound (``top_k * capacity_factor >= E``) no
    token drops, so a batch over ``DISPATCH_ELEMS`` runs in chunks of
    tokens: equal to the whole batch at once, and to the reference's
    ``moe_apply`` at that capacity."""
    jcfg, jp, tp = _moe_params(name)
    unbound = jcfg.moe.num_experts / jcfg.moe.top_k
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=unbound))
    tcfg = configs(name, "f32")[1]
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=unbound))
    x = (np.random.default_rng(2).standard_normal((3, 37, jcfg.d_model))
         * 0.5).astype(np.float32)
    whole = MoE.moe_apply(tp, tcfg, torch.tensor(x))
    width = max(tcfg.d_model, tcfg.moe.d_expert)
    monkeypatch.setattr(MoE, "DISPATCH_ELEMS",
                        tcfg.moe.num_experts * width * 8)
    chunked = MoE.moe_apply(tp, tcfg, torch.tensor(x))
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
    np.testing.assert_allclose(
        f32(chunked), np.asarray(ref_moe(jp, jcfg, jnp.asarray(x))[0]),
        rtol=1e-4, atol=1e-5)


def test_deepseek_router_bias_selection_only():
    """V3's aux-loss-free bias moves the selection, not the combine
    weights: a huge bias on expert 0 changes the output; the port's
    output equals the reference's with and without it."""
    jcfg, jp, tp = _moe_params("deepseek-v3-671b-smoke")
    tcfg = configs("deepseek-v3-671b-smoke", "f32")[1]
    x = (np.random.default_rng(1).standard_normal((1, 8, jcfg.d_model))
         * 0.5).astype(np.float32)
    y1 = MoE.moe_apply(tp, tcfg, torch.tensor(x))
    bias = np.array([1e3] + [0.0] * (jcfg.moe.num_experts - 1), np.float32)
    tp2 = {**tp, "router_bias": tp["router_bias"] + torch.tensor(bias)}
    jp2 = {**jp, "router_bias": jp["router_bias"] + jnp.asarray(bias)}
    y2 = MoE.moe_apply(tp2, tcfg, torch.tensor(x))
    assert float((y1 - y2).abs().max()) > 0
    for y, p in ((y1, jp), (y2, jp2)):
        np.testing.assert_allclose(
            f32(y), np.asarray(ref_moe(p, jcfg, jnp.asarray(x))[0]),
            rtol=1e-4, atol=1e-5)


PARAM_RANGES = {"qwen3-0.6b": (0.4e9, 1.2e9),
                "qwen1.5-110b": (95e9, 125e9),
                "gemma2-27b": (22e9, 32e9),
                "gemma3-27b": (22e9, 32e9),
                "dbrx-132b": (115e9, 145e9),
                "deepseek-v3-671b": (600e9, 720e9),
                "qwen2-vl-7b": (6e9, 9e9)}


@pytest.mark.parametrize("name", sorted(PARAM_RANGES))
def test_full_config_param_counts(name):
    """The full configs' parameter counts, from the definitions alone:
    the reference's range, and its count to the element."""
    n = count_params(model_def(tget(name)))
    lo, hi = PARAM_RANGES[name]
    assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B not in [{lo}, {hi}]"
    assert n == jcount(JT.model_def(jget(name)))


def test_mrope_cos_sin_image_grid_matches_reference():
    """M-RoPE on an image grid: a text prefix (t = h = w), then a 2 x 3 x 4
    (t, h, w) patch grid, then text again; qwen2-vl's sections at full
    width (16, 24, 24) and smoke width (2, 3, 3)."""
    text = [(i, i, i) for i in range(5)]
    grid = [(5 + t, 5 + h, 5 + w) for t in range(2) for h in range(3)
            for w in range(4)]
    tail = [(9 + i, 9 + i, 9 + i) for i in range(3)]
    pos = np.array([text + grid + tail] * 2)                  # [2, 32, 3]
    for hd, sec in ((128, (16, 24, 24)), (16, (2, 3, 3))):
        c, s = L.mrope_cos_sin(torch.tensor(pos), hd, sec, 1e6)
        jc, js = JL.mrope_cos_sin(jnp.asarray(pos), hd, sec, 1e6)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                                   atol=1e-6)
        # text positions: plain RoPE
        rc, rs = L.rope_cos_sin(torch.tensor(pos[..., 0]), hd, 1e6)
        torch.testing.assert_close(c[:, :5], rc[:, :5], rtol=0, atol=0)


@pytest.mark.parametrize("interleaved", [False, True])
def test_apply_rope_matches_reference(interleaved):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    c, s = L.rope_cos_sin(torch.tensor(pos), 16, 1e4)
    jc, js = JL.rope_cos_sin(jnp.asarray(pos), 16, 1e4)
    got = L.apply_rope(torch.tensor(x), c[:, :, None], s[:, :, None],
                       interleaved)
    want = JL.apply_rope(jnp.asarray(x), jc[:, :, None], js[:, :, None],
                         interleaved)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_activations_and_plain_mlp_match_reference(act, dt):
    """Each activation through the plain (``wi``) and the gated MLP, with
    the reference's roundings (bf16: bit for bit)."""
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 5, 8)), jdt)
    ws = {k: jnp.asarray(rng.standard_normal(sh) * 0.4, jdt)
          for k, sh in (("wi", (8, 12)), ("wi_gate", (8, 12)),
                        ("wi_up", (8, 12)), ("wo", (12, 8)))}
    tx = from_jax_params(np.asarray(x))
    tw = from_jax_params(jax.tree.map(np.asarray, ws))
    for keys in (("wi", "wo"), ("wi_gate", "wi_up", "wo")):
        jp = {k: ws[k] for k in keys}
        tp = {k: tw[k] for k in keys}
        want = ref_compiled(lambda p, v: JL.mlp(p, v, act), jp, x)(jp, x)
        got = L.mlp(tp, tx, act)
        close(got, want, dt)
    want = ref_compiled(lambda v: JL._act(act, v), x)(x)
    got = L.act(act, tx)
    if dt == "bf16":
        np.testing.assert_array_equal(f32(got), np.asarray(want, np.float32))
    else:
        close(got, want, dt)


@pytest.mark.parametrize("window,cap", [(None, None), (5, 50.0)])
def test_mha_chunked_matches_reference(window, cap):
    """The prefill's online softmax at a ragged key length (two 8-key
    blocks, the last padded), GQA groups of 2, with a window and a soft
    cap, against the reference's on repeated k / v."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 13, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(13)[None], (2, 13)).copy()
    want = JA.mha_chunked(jnp.asarray(q), JA.repeat_kv(jnp.asarray(k), 2),
                          JA.repeat_kv(jnp.asarray(v), 2), jnp.asarray(pos),
                          jnp.asarray(pos), 0.3, cap, window, kv_block=8)
    got = A.mha_chunked(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        torch.tensor(pos), torch.tensor(pos), 0.3, cap,
                        window, kv_block=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["gemma2-27b-smoke", "qwen1.5-110b-smoke"])
def test_attention_modes_match_reference(name):
    """``attention`` itself in its three modes (its decode: q against a
    given cache, weights in fp32; the GQA block's decode casts them to
    the cache's dtype) against the reference's, fp32, a local window."""
    jcfg, tcfg = configs(name, "f32")
    jp = ref_params(name, "f32")[0]
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = from_jax_params(jax.tree.map(np.asarray, jl))
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((B, 12, jcfg.d_model)) * 0.5).astype(np.float32)
    pos = np.broadcast_to(np.arange(12)[None], (B, 12)).copy()
    ck = rng.standard_normal((B, 20, jcfg.num_kv_heads, jcfg.head_dim)
                             ).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    cpos = np.broadcast_to(np.arange(20)[None], (B, 20)).copy()
    for mode in ("train", "prefill", "decode"):
        n = 1 if mode == "decode" else 12
        p = pos[:, :n] + (13 if mode == "decode" else 0)
        kw = dict(kind="local", mode=mode)
        if mode == "decode":
            kw.update(cache_k=ck, cache_v=cv, cache_positions=cpos)
        arrs = {k: jnp.asarray(v) for k, v in kw.items()
                if isinstance(v, np.ndarray)}
        opts = {k: v for k, v in kw.items() if not isinstance(v, np.ndarray)}
        args = (jl, jnp.asarray(x[:, :n]), jnp.asarray(p), arrs)
        want = ref_compiled(lambda w, xx, pp, a: JA.attention(
            w, jcfg, xx, pp, **a, **opts), *args)(*args)
        got = A.attention(tl, tcfg, torch.tensor(x[:, :n]), torch.tensor(p),
                          **{k: torch.tensor(v) if isinstance(v, np.ndarray)
                             else v for k, v in kw.items()})
        np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got.k.numpy(), np.asarray(want.k),
                                   rtol=1e-5, atol=1e-6)
