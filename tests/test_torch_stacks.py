"""The SSM, hybrid and encoder-decoder stacks on the port's generic path
(``models/{ssm,blocks,attention,transformer,params,layers}``,
``generic_prefill`` / ``generic_decode``) against the reference on the
CPU, at smoke scale: mamba2-780m, zamba2-7b and whisper-large-v3.

The same numpy-seeded inputs (whisper: seeded bf16 frame embeddings, the
stubbed front end's output) and the reference's own parameters
(``from_jax_params``) go through both packages.  The reference runs
jitted once per mode with the compile options of
``test_torch_archs.py`` (every op rounded to its dtype).  Tolerances:
1e-4 at fp32 and 2e-2 at bf16 (cache planes: 2e-2 of the plane's scale);
the port's prefill + decode against its own train logits within the
reference's bound, ``2e-2 + 2e-2 * max|ref|``.

Reference tests this file counts as covered (with
``tests/test_torch_archs.py`` they cover all of ``tests/test_models.py``):

* ``test_models::test_train_forward_shapes_no_nan`` and
  ``test_models::test_prefill_decode_consistent_with_train`` for
  mamba2-780m, zamba2-7b and whisper-large-v3 (their ``-smoke`` configs)
* ``test_models::test_full_config_param_counts``: its entries for the
  three configs above
* ``test_models::test_mamba2_chunked_matches_sequential``
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.params import count_params as jcount
from repro.models.params import init_params as jinit
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as A
from repro_torch.models import blocks as TB
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.params import count_params, from_jax_params, model_def
from repro_torch.serving import engine as E
from test_torch_archs import (DT, TOL, close, close_cache, configs, f32,
                              jget, ref_compiled, tt)

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

SMOKES = ["mamba2-780m-smoke", "zamba2-7b-smoke", "whisper-large-v3-smoke"]
# the reference test's sizes: prefill S, decode into Smax; ROUNDS
# teacher-forced decode steps after the prefill
B, S, SMAX, ROUNDS = 2, 16, 24, 4
# the self-attention planes a prefill returns with S positions
PADDED = ("kv", "shared_kv")


def same_dtype(t, j):
    assert str(t.dtype).removeprefix("torch.") == str(j.dtype), \
        (t.dtype, j.dtype)


def close_tree(t, j, dt):
    """A cache entry (a NamedTuple or tuple of planes), plane by plane,
    dtypes included."""
    assert len(t) == len(j)
    for a, b in zip(t, j):
        same_dtype(a, b)
        close_cache(a, b, dt)


@functools.lru_cache(maxsize=None)
def _ref_params_f32(name):
    jcfg = configs(name, "f32")[0]
    key = jax.random.key(0)
    return ref_compiled(lambda k: jinit(k, JT.model_def(jcfg)), key)(key)


@functools.lru_cache(maxsize=None)
def ref_params(name, dt):
    """The reference's parameters at ``dt`` (its fp32 draws rounded) and
    the same tree in the port."""
    jdefs = JT.model_def(configs(name, dt)[0])
    jp = jax.tree.map(lambda a, d: a.astype(d.dtype), _ref_params_f32(name),
                      jdefs, is_leaf=lambda x: hasattr(x, "init"))
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def inputs(jcfg, n):
    """Token ids [B,n], positions and, for whisper, bf16 frame embeddings
    [B,Se,d] (the same bits in both packages; else None)."""
    rng = np.random.default_rng(1)
    t = rng.integers(0, jcfg.vocab_size, (B, n))
    pos = np.broadcast_to(np.arange(n)[None], (B, n)).copy()
    enc = None
    if jcfg.encdec is not None:
        e = jnp.asarray(rng.standard_normal(
            (B, jcfg.encdec.encoder_seq, jcfg.d_model)), jnp.bfloat16)
        enc = (e, from_jax_params(np.asarray(e)))
    return (jnp.asarray(t), torch.tensor(t)), pos, enc


def pad_ref(caches):
    """The reference test's padding: the self-attention planes to SMAX."""
    out = dict(caches)
    for k in PADDED:
        if k in out:
            out[k] = jax.tree.map(lambda a: jnp.pad(
                a, [(0, 0), (0, 0), (0, SMAX - S)] + [(0, 0)] * (a.ndim - 3)),
                out[k])
    return out


@pytest.fixture(scope="module", params=[(n, d) for n in SMOKES
                                        for d in ("f32", "bf16")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """Both packages' parameters; the reference's train forward over
    S + 1 tokens, its prefill over S and ROUNDS teacher-forced decode
    steps from the padded prefill caches, each mode jitted once."""
    name, dt = request.param
    jcfg, tcfg = configs(name, dt)
    jp, tp = ref_params(name, dt)
    (jin, tin), pos, enc = inputs(jcfg, S + ROUNDS)
    jpos = jnp.asarray(pos)
    jenc = None if enc is None else enc[0]

    def mode_fn(mode):
        return lambda p, t, q, c, e: JT.forward(p, jcfg, t, q, mode=mode,
                                                caches=c, enc_inputs=e)
    args = (jp, jin[:, :S + 1], jpos[:, :S + 1], None, jenc)
    train = ref_compiled(mode_fn("train"), *args)(*args)
    args = (jp, jin[:, :S], jpos[:, :S], None, jenc)
    pf = ref_compiled(mode_fn("prefill"), *args)(*args)
    cm = pad_ref(pf.caches)
    dec, step = [], None
    for r in range(ROUNDS):
        args = (jp, jin[:, S + r:S + r + 1], jpos[:, S + r:S + r + 1], cm,
                None)
        step = step or ref_compiled(mode_fn("decode"), *args)
        o = step(*args)
        cm = o.caches
        dec.append(np.asarray(o.logits))
    return dict(name=name, dt=dt, tcfg=tcfg, tp=tp, tin=tin, pos=pos,
                tenc=None if enc is None else enc[1], train=train,
                prefill=pf, decode=dec, dcaches=cm)


@pytest.fixture(scope="module", autouse=True)
def _drop_params():
    """Drop the cached parameters after this file (``_torch_cpu`` then
    frees JAX's programs)."""
    yield
    ref_params.cache_clear()
    _ref_params_f32.cache_clear()
    _ssm_params.cache_clear()


def cache_keys(caches):
    return sorted(k for k in caches if k != "lens")


def test_train_forward_matches_reference(model):
    """``test_train_forward_shapes_no_nan``: shapes, finite logits; and
    the logits against the reference's."""
    n = S + 1
    out = T.forward(model["tp"], model["tcfg"], model["tin"][:, :n],
                    tt(model["pos"][:, :n]), mode="train",
                    enc_inputs=model["tenc"])
    assert out.caches is None
    assert out.logits.shape == (B, n, model["tcfg"].vocab_size)
    assert bool(torch.isfinite(out.logits).all())
    close(out.logits, model["train"].logits, model["dt"])


def test_generic_prefill_decode_matches_reference(model):
    """``generic_prefill`` on S tokens (whisper: and the frames), then
    ROUNDS ``generic_decode`` steps fed the same tokens from the padded
    caches (written in place): the logits of each, every cache entry
    after prefill (the SSM state's dtypes: ``h`` fp32, the conv windows
    in the activation dtype) and after the last step."""
    tcfg, tp, tin, dt = model["tcfg"], model["tp"], model["tin"], model["dt"]
    pos = tt(model["pos"])
    pf = E.generic_prefill(tp, tcfg, tin[:, :S], pos[:, :S], device="cpu",
                           enc_inputs=model["tenc"])
    ref = model["prefill"]
    close(pf.logits, ref.logits, dt)
    keys = cache_keys(pf.caches)
    assert keys == cache_keys(ref.caches)
    for k in keys:
        close_tree(pf.caches[k], ref.caches[k], dt)
    if "ssm" in keys:
        assert pf.caches["ssm"].h.dtype == torch.float32
        assert pf.caches["ssm"].conv_x.dtype == tcfg.param_dtype
    assert pf.caches["lens"].tolist() == [S] * B
    caches = T.pad_caches(pf.caches, SMAX)
    planes = {k: list(caches[k]) for k in keys}
    for r in range(ROUNDS):
        o = E.generic_decode(tp, tcfg, tin[:, S + r:S + r + 1],
                             caches["lens"][:, None], caches, device="cpu")
        assert o.caches is caches
        close(o.logits, model["decode"][r], dt)
    for k in keys:
        # written in place: the same tensors, the same dtypes
        assert all(a is b for a, b in zip(caches[k], planes[k])), k
        close_tree(caches[k], model["dcaches"][k], dt)
    assert caches["lens"].tolist() == [S + ROUNDS] * B


def test_prefill_decode_consistent_with_train(model):
    """The reference's own bound on the port alone: a prefill over S
    tokens and one decode step give the last position's logits of a train
    forward over S + 1, within ``2e-2 + 2e-2 * max|ref|``."""
    tcfg, tp, tin = model["tcfg"], model["tp"], model["tin"]
    pos = tt(model["pos"])
    ref = T.forward(tp, tcfg, tin[:, :S + 1], pos[:, :S + 1], mode="train",
                    enc_inputs=model["tenc"]).logits[:, -1]
    pf = E.generic_prefill(tp, tcfg, tin[:, :S], pos[:, :S], device="cpu",
                           enc_inputs=model["tenc"])
    caches = T.pad_caches(pf.caches, SMAX)
    dec = E.generic_decode(tp, tcfg, tin[:, S:S + 1], pos[:, S:S + 1],
                           caches, device="cpu")
    err = float((dec.logits[:, -1] - ref).abs().max())
    scale = float(ref.abs().max())
    assert err < 2e-2 + 2e-2 * scale, (model["name"], err, scale)


@pytest.mark.parametrize("name", SMOKES)
def test_cache_spec_and_pad_caches(name):
    """``stack_plan`` takes the kind; ``cache_spec`` has the reference's
    entries, shapes and dtypes (the SSM state fp32 whatever the cache
    dtype); ``pad_caches`` grows the self-attention planes only."""
    jcfg, tcfg = jget(name), tget(name)
    assert T.stack_plan(tcfg) == T.StackPlan(**dataclasses.asdict(
        JT.stack_plan(jcfg)))
    got = T.cache_spec(tcfg, B, SMAX, device="cpu")
    want = JT.cache_spec(jcfg, B, SMAX)
    assert cache_keys(got) == cache_keys(want)
    for k in cache_keys(got):
        assert len(got[k]) == len(want[k])
        for a, b in zip(got[k], want[k]):
            assert tuple(a.shape) == b.shape, k
            same_dtype(a, b)
    short = {k: type(v)(*(a[:, :, :S] if k in PADDED else a for a in v))
             for k, v in got.items() if k != "lens"}
    padded = T.pad_caches(short, SMAX)
    for k in short:
        for a, b in zip(padded[k], got[k]):
            assert a.shape == b.shape, k
        if k not in PADDED:
            assert all(a is b for a, b in zip(padded[k], short[k])), k


PARAM_RANGES = {"mamba2-780m": (0.6e9, 1.0e9),
                "zamba2-7b": (6e9, 9e9),
                "whisper-large-v3": (1.2e9, 2.2e9)}


@pytest.mark.parametrize("name", sorted(PARAM_RANGES))
def test_full_config_param_counts(name):
    """The full configs' parameter counts, from the definitions alone:
    the reference's range, and its count to the element."""
    n = count_params(model_def(tget(name)))
    lo, hi = PARAM_RANGES[name]
    assert lo <= n <= hi, f"{name}: {n / 1e9:.2f}B not in [{lo}, {hi}]"
    assert n == jcount(JT.model_def(jget(name)))


# ---------------------------------------------------------------------------
# The SSM's pieces
# ---------------------------------------------------------------------------

def ssd_inputs(s, h, p, g, n, seed=0):
    """The reference test's distributions: x, B, C normal; a_dt = -|normal|
    * 0.1; an h0 [b,h,p,n]."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, s, h, p)).astype(np.float32)
    a = (-np.abs(rng.standard_normal((2, s, h))) * 0.1).astype(np.float32)
    Bm = rng.standard_normal((2, s, g, n)).astype(np.float32)
    Cm = rng.standard_normal((2, s, g, n)).astype(np.float32)
    h0 = rng.standard_normal((2, h, p, n)).astype(np.float32)
    return x, a, Bm, Cm, h0


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_ssd_chunked_matches_reference(g, with_h0):
    """``ssd_chunked`` (64 tokens, chunks of 16, one or two B / C groups)
    against the reference's, fp32 at 1e-4: y and the final state."""
    x, a, Bm, Cm, h0 = ssd_inputs(64, 4, 8, g, 16)
    h0 = h0 if with_h0 else None
    args = [jnp.asarray(v) for v in (x, a, Bm, Cm)]
    jh0 = None if h0 is None else jnp.asarray(h0)
    want = ref_compiled(lambda *v: JS.ssd_chunked(*v[:4], 16, v[4]),
                        *args, jh0)(*args, jh0)
    got = SSM.ssd_chunked(*map(torch.tensor, (x, a, Bm, Cm)), 16,
                          None if h0 is None else torch.tensor(h0))
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_ssd_sequential_matches_reference():
    """``ssd_sequential`` at a length that is no multiple of a chunk (37),
    from an h0, two groups, against the reference's."""
    x, a, Bm, Cm, h0 = ssd_inputs(37, 4, 8, 2, 16, seed=1)
    args = [jnp.asarray(v) for v in (x, a, Bm, Cm, h0)]
    want = ref_compiled(JS.ssd_sequential, *args)(*args)
    got = SSM.ssd_sequential(*map(torch.tensor, (x, a, Bm, Cm, h0)))
    for t, j in zip(got, want):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


def test_mamba2_chunked_matches_sequential():
    """``test_mamba2_chunked_matches_sequential`` in the port alone: the
    reference test's sizes (b 2, s 64, h 4, p 8, n 16, chunk 16), 1e-4."""
    x, a, Bm, Cm, _ = ssd_inputs(64, 4, 8, 1, 16, seed=2)
    ins = [torch.tensor(v) for v in (x, a, Bm, Cm)]
    y1, h1 = SSM.ssd_chunked(*ins, chunk=16)
    y2, h2 = SSM.ssd_sequential(*ins)
    torch.testing.assert_close(y1, y2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h1, h2, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_causal_conv_matches_reference(dt):
    """The depthwise causal convolution: fp32 sums, the result in x's
    dtype (bf16: bit for bit)."""
    jdt, _ = DT[dt]
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((2, 9, 6)), jdt)
    w = jnp.asarray(rng.standard_normal((4, 6)) * 0.5, jdt)
    want = ref_compiled(JS._causal_conv, x, w)(x, w)
    got = SSM._causal_conv(from_jax_params(np.asarray(x)),
                           from_jax_params(np.asarray(w)))
    same_dtype(got, want)
    if dt == "bf16":
        np.testing.assert_array_equal(f32(got), np.asarray(want, np.float32))
    else:
        close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_conv_step_sums_in_fp32(dt):
    """A decode token through a convolution gives, bit for bit, ``silu``
    of the fp32 sum over its window (the reference's decode: no rounding
    to the activation dtype before ``silu``, unlike the prefill), and the
    window slides by one in the tail's dtype."""
    tdt = DT[dt][1]
    g = torch.Generator().manual_seed(10)
    seq = torch.randn((2, 7, 12), generator=g).to(tdt)
    w = (torch.randn((4, 12), generator=g) * 0.5).to(tdt)
    want = L.silu(SSM._causal_conv(seq.float(), w.float()))[:, -1]
    got, win = SSM._conv_step(seq[:, 3:6], seq[:, 6], w)
    assert got.dtype == torch.float32 and win.dtype == tdt
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(win, seq[:, 3:], rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _ssm_params(dt):
    """mamba2-780m-smoke's mixer from the reference's init, with A_log and
    dt_bias drawn (the init's zeros give every head A = -1) so each head
    decays at its own rate."""
    jcfg = configs("mamba2-780m-smoke", dt)[0]
    jp = jinit(jax.random.key(3), JS.ssm_def(jcfg))
    rng = np.random.default_rng(4)
    H = jcfg.ssm.nheads(jcfg.d_model)
    jp = {**jp, "A_log": jnp.asarray(rng.standard_normal(H) * 0.5,
                                     jnp.float32),
          "dt_bias": jnp.asarray(rng.standard_normal(H), jnp.float32)}
    return jp, from_jax_params(jax.tree.map(np.asarray, jp))


def ref_ssm(jcfg, mode, jp, u, st):
    return ref_compiled(lambda p, v, s: JS.ssm_forward(p, jcfg, v, s,
                                                       mode=mode),
                        jp, u, st)(jp, u, st)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_ssm_forward_matches_reference(dt):
    """The mixer in its three modes against the reference's: train over
    20 tokens (chunk 16: the zero-padded branch), a prefill over 20 (its
    state: ``h`` fp32, the conv windows in the activation dtype), two
    decode tokens from that state and two from ``init_state`` (fp32
    throughout); outputs and every state field with its dtype.  A decode
    updates the state in place."""
    jcfg, tcfg = configs("mamba2-780m-smoke", dt)
    jp, tp = _ssm_params(dt)
    jdt, tdt = DT[dt]
    rng = np.random.default_rng(5)
    u = jnp.asarray(rng.standard_normal((2, 22, jcfg.d_model)), jdt)
    tu = from_jax_params(np.asarray(u))
    y, st = SSM.ssm_forward(tp, tcfg, tu[:, :20], mode="train")
    jy, _ = ref_ssm(jcfg, "train", jp, u[:, :20], None)
    assert st is None
    close(y, jy, dt)
    y, st = SSM.ssm_forward(tp, tcfg, tu[:, :20], mode="prefill")
    jy, jst = ref_ssm(jcfg, "prefill", jp, u[:, :20], None)
    close(y, jy, dt)
    close_tree(st, jst, dt)
    # the windows are copies, not views keeping the [B,S,C] projections
    for a in st[1:]:
        assert a.untyped_storage().nbytes() == a.numel() * a.element_size()
    for name, t0, j0 in (
            ("prefill", st, jst),
            ("init", SSM.init_state(tcfg, 2, device="cpu"),
             JS.init_state(jcfg, 2))):
        t_in = SSM.SSMState(*(a.clone() for a in t0))
        y, st2 = SSM.ssm_forward(tp, tcfg, tu[:, 20:], t_in, mode="decode")
        jy, jst2 = ref_ssm(jcfg, "decode", jp, u[:, 20:], j0)
        assert st2 is t_in, name
        close(y, jy, dt)
        close_tree(st2, jst2, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_cross_attention_matches_reference(dt):
    """``cross_kv`` over an encoder output and ``cross_attention`` of a
    decoder's queries over it (whisper-smoke's widths, qkv biases drawn)."""
    jcfg, tcfg = configs("whisper-large-v3-smoke", dt)
    jdt, _ = DT[dt]
    jp = jinit(jax.random.key(5), JA.attn_def(jcfg, cross=True))
    rng = np.random.default_rng(6)
    jp = {k: (jnp.asarray(rng.standard_normal(v.shape) * 0.1, jdt)
              if k.startswith("b") else v) for k, v in jp.items()}
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    enc = jnp.asarray(rng.standard_normal((2, 32, jcfg.d_model)), jdt)
    x = jnp.asarray(rng.standard_normal((2, 5, jcfg.d_model)), jdt)
    jk, jv = ref_compiled(lambda p, e: JA.cross_kv(p, jcfg, e), jp, enc)(
        jp, enc)
    k, v = A.cross_kv(tp, tcfg, from_jax_params(np.asarray(enc)))
    close(k, jk, dt)
    close(v, jv, dt)
    want = ref_compiled(lambda p, q, a, b: JA.cross_attention(
        p, jcfg, q, a, b), jp, x, jk, jv)(jp, x, jk, jv)
    got = A.cross_attention(tp, tcfg, from_jax_params(np.asarray(x)),
                            from_jax_params(np.asarray(jk)),
                            from_jax_params(np.asarray(jv)))
    same_dtype(got, want)
    close(got, want, dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_layernorm_matches_reference(dt):
    """``layernorm`` (and its definitions: w ones, b zeros) against the
    reference's, with drawn w and b."""
    jdt, tdt = DT[dt]
    defs = L.layernorm_def(24, tdt)
    jdefs = JL.layernorm_def(24, jdt)
    assert {k: (d.shape, d.init) for k, d in defs.items()} == \
        {k: (d.shape, d.init) for k, d in jdefs.items()}
    rng = np.random.default_rng(7)
    jp = {k: jnp.asarray(rng.standard_normal(24) * 0.3 + (k == "w"), jdt)
          for k in ("w", "b")}
    x = jnp.asarray(rng.standard_normal((3, 5, 24)) * 2 + 1, jdt)
    want = ref_compiled(JL.layernorm, jp, x)(jp, x)
    got = L.layernorm(from_jax_params(jax.tree.map(np.asarray, jp)),
                      from_jax_params(np.asarray(x)))
    same_dtype(got, want)
    close(got, want, dt)


def test_ssm_block_and_hybrid_alternation():
    """The SSM block is ``x + mixer(rmsnorm(x))``; zamba2-smoke's two
    groups take the shared blocks 0 then 1: swapping them changes the
    logits, and making them equal makes the order immaterial."""
    tcfg = configs("zamba2-7b-smoke", "f32")[1]
    tp = ref_params("zamba2-7b-smoke", "f32")[1]
    lp = T.pick(tp["layers"], 0)
    x = torch.tensor(np.random.default_rng(8).standard_normal(
        (2, 6, tcfg.d_model)).astype(np.float32))
    y, _ = TB.ssm_block(lp, tcfg, x, mode="train")
    mix, _ = SSM.ssm_forward(lp["ssm"], tcfg,
                             L.rmsnorm(lp["ln"], x, tcfg.norm_eps))
    torch.testing.assert_close(y, x + mix, rtol=0, atol=0)
    toks = torch.tensor(np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (2, 8)))
    pos = torch.arange(8)[None].expand(2, 8)

    def run(shared):
        return T.forward({**tp, "shared_attn": shared}, tcfg, toks, pos,
                         mode="train").logits
    sa = tp["shared_attn"]
    assert float((run(_map(lambda a: a.flip(0), sa)) - run(sa)).abs().max()) > 0
    same = _map(lambda a: a[:1].expand_as(a), sa)
    torch.testing.assert_close(run(same), run(_map(
        lambda a: a.flip(0), same)), rtol=0, atol=0)


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}
