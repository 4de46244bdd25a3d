"""The port's training stack (``repro_torch.training``,
``launch/steps.py``, the gradient half of ``distributed/compression.py``)
against the reference on the CPU, on the same inputs.

* ``make_batch``: the same tokens for several steps and host splits;
* ``lr_at``, ``global_norm``, ``clip_by_global_norm`` and ``adamw_update``
  on the same fp32 trees within 1e-6 relative (each leaf's scale);
* checkpoints: each package's save restores in the other, fp32, bf16 and
  int32 leaves bit for bit, the same manifest and file bytes, a corrupted
  shard raising ``IOError`` in both;
* qwen3-0.6b-smoke's ``make_train_step`` (accumulation 1 and 4) against
  the reference's jitted step on its own parameters (``from_jax_params``):
  loss within 1e-5, gradients within 1e-4 of each leaf's max, parameters
  after the step within 1e-6;
* the int8 gradient compression with error feedback.

The reference runs jitted once per module (``ref_compiled``: every op
rounded to its dtype, LLVM's expensive passes off).

Reference tests this file counts as covered (all nine of
``tests/test_training.py``): ``test_adamw_decreases_loss``,
``test_grad_accumulation_matches_full_batch``, ``test_lr_schedule``,
``test_checkpoint_roundtrip_and_integrity``,
``test_checkpoint_gc_keeps_latest``,
``test_train_loop_resumes_from_checkpoint``,
``test_elastic_restore_resharding`` (``restore``'s ``device_fn``),
``test_data_pipeline_determinism_and_host_sharding`` and
``test_int8_compression_error_feedback``.
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as JC
from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.training import checkpoint as jckpt
from repro.training import data as JD
from repro.training import optimizer as JO
from repro_torch.distributed import compression as C
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.params import init_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, make_batch
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_update, clip_by_global_norm,
                                            global_norm, init_opt_state,
                                            lr_at)
from repro_torch.training.train_loop import LoopConfig, train_loop
from repro_torch.training.tree import flatten, leaves, tree_map
from test_torch_archs import _ref_params_f32, ref_compiled, ref_params

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

SMOKE = "qwen3-0.6b-smoke"
OPT = dict(lr=1e-3, total_steps=50, warmup_steps=5)


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled():
    yield
    ref_params.cache_clear()
    _ref_params_f32.cache_clear()
    jax.clear_caches()


def f32(t):
    return np.asarray(t.detach().float().numpy() if isinstance(
        t, torch.Tensor) else t, np.float32)


def close_scaled(got, want, tol):
    """``|got - want| <= tol * max(1, max|want|)`` leaf by leaf."""
    for g, w in zip(leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        err = float(np.abs(f32(g) - w).max()) if w.size else 0.0
        assert err <= tol * max(1.0, float(np.abs(w).max()) if w.size
                                else 0.0), err


def torch_batch(jb):
    return {k: torch.tensor(np.asarray(v), dtype=torch.int64)
            for k, v in jb.items()}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step,host,hosts", [(0, 0, 1), (3, 0, 1), (7, 0, 1),
                                             (3, 0, 2), (3, 1, 2),
                                             (5, 2, 4)])
def test_make_batch_matches_reference(step, host, hosts):
    """``test_data_pipeline_determinism_and_host_sharding``: the same
    tokens as the reference for each step and host split (int64 tensors),
    deterministic, host slices differ, labels the shifted inputs."""
    dc = DataConfig(vocab_size=100, global_batch=8, seq_len=16, seed=2)
    jb = JD.make_batch(JD.DataConfig(100, 8, 16, seed=2), step, host, hosts)
    b = make_batch(dc, step, host, hosts)
    for k in ("inputs", "labels", "positions"):
        assert b[k].dtype == torch.int64
        np.testing.assert_array_equal(b[k].numpy(), np.asarray(jb[k]))
    assert b["inputs"].shape == (8 // hosts, 16)
    assert torch.equal(make_batch(dc, step, host, hosts)["inputs"],
                       b["inputs"])
    assert torch.equal(b["inputs"][:, 1:], b["labels"][:, :-1])
    if hosts > 1:
        other = make_batch(dc, step, (host + 1) % hosts, hosts)
        assert not torch.equal(other["inputs"], b["inputs"])


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_lr_schedule_matches_reference():
    """``test_lr_schedule``, and ``lr_at`` at every step of warmup, decay
    and past the end against the reference within 1e-6 relative."""
    c = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                    min_lr_frac=0.1)
    jc = JO.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                        min_lr_frac=0.1)
    assert float(lr_at(c, torch.tensor(0))) < 0.2
    assert float(lr_at(c, torch.tensor(10))) == pytest.approx(1.0, abs=0.1)
    assert float(lr_at(c, torch.tensor(100))) == pytest.approx(0.1, abs=0.02)
    s = np.arange(0, 120, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda t: JO.lr_at(jc, t)))(s))
    got = lr_at(c, torch.tensor(s)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def _tree(seed, zero_leaf=True):
    """A nested fp32 tree (a zero leaf among them: the gradient of a leaf
    the loss does not reach)."""
    rng = np.random.default_rng(seed)
    t = {"a": rng.standard_normal((16, 24)).astype(np.float32),
         "b": {"c": rng.standard_normal((40,)).astype(np.float32) * 3,
               "d": rng.standard_normal((3, 5, 7)).astype(np.float32)},
         "e": rng.standard_normal((8,)).astype(np.float32) * 1e-3}
    if zero_leaf:
        t["b"]["z"] = np.zeros((6, 4), np.float32)
    return t


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("max_norm", [1.0, 100.0], ids=["clipped", "free"])
def test_norm_clip_and_adamw_match_reference(max_norm):
    """``global_norm``, ``clip_by_global_norm`` and three ``adamw_update``
    steps (functional, then in place) on the same fp32 trees as the
    reference: each leaf within 1e-6 of its scale; the step counter int32;
    a zero-gradient leaf decayed as the reference decays it."""
    jc = JO.AdamWConfig(lr=3e-2, warmup_steps=2, total_steps=6,
                        grad_clip=max_norm)
    c = AdamWConfig(lr=3e-2, warmup_steps=2, total_steps=6,
                    grad_clip=max_norm)
    jp, tp = _tree(0), _to_torch(_tree(0))
    jo, to = JO.init_opt_state(jp), init_opt_state(tp)
    ti = jax.tree.map(lambda a: a.clone(), tp)
    to_i = init_opt_state(ti)
    upd = jax.jit(lambda p, g, o: JO.adamw_update(jc, p, g, o))
    for k in range(3):
        jg = _tree(10 + k)
        tg = _to_torch(jg)
        np.testing.assert_allclose(float(global_norm(tg)),
                                   float(JO.global_norm(jg)), rtol=1e-6)
        cg, cn = clip_by_global_norm(tg, max_norm)
        jcg, jcn = JO.clip_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(cn), float(jcn), rtol=1e-6)
        close_scaled(cg, jcg, 1e-6)
        jp, jo, jm = upd(jp, jg, jo)
        tp, to, m = adamw_update(c, tp, tg, to)
        ti2, to_i2, _ = adamw_update(c, ti, tg, to_i, inplace=True)
        assert ti2["a"] is ti["a"] and to_i2.m["a"] is to_i.m["a"]
        for got in ((tp, to), (ti, to_i)):
            close_scaled(got[0], jp, 1e-6)
            close_scaled(got[1].m, jo.m, 1e-6)
            close_scaled(got[1].v, jo.v, 1e-6)
            assert got[1].step.dtype == torch.int32
            assert int(got[1].step) == int(jo.step) == k + 1
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
    assert float(tp["b"]["z"].abs().max()) == 0.0     # 0 decays to 0
    jz = _tree(0)["e"]
    assert not np.allclose(f32(tp["e"]), jz)           # stepped


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_trees():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 4)).astype(np.float32)
    c = rng.standard_normal((5, 2)).astype(np.float32)
    d = np.arange(6, dtype=np.int32)
    w = rng.standard_normal((2, 3)).astype(np.float32)
    jt = {"params": {"a": jnp.asarray(a),
                     "b": {"c": jnp.asarray(c, jnp.bfloat16),
                           "d": jnp.asarray(d)}},
          "opt": JO.OptState(m={"w": jnp.asarray(w)},
                             v={"w": jnp.asarray(w * 2)},
                             step=jnp.asarray(7, jnp.int32))}
    tt = {"params": {"a": torch.tensor(a),
                     "b": {"c": torch.tensor(c).to(torch.bfloat16),
                           "d": torch.tensor(d)}},
          "opt": OptState(m={"w": torch.tensor(w)},
                          v={"w": torch.tensor(w * 2)},
                          step=torch.tensor(7, dtype=torch.int32))}
    return jt, tt


def _bits(x):
    """A leaf's raw bytes (bf16 as its 16-bit patterns) and its width."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), x.shape
    x = np.asarray(x)
    return x.tobytes(), x.shape


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_read(tmp_path, writer):
    """A checkpoint written by either package restores in the other (and
    in itself), bf16, fp32 and int32 leaves bit for bit; the two packages
    write the same manifest and the same file bytes; a corrupted shard
    raises ``IOError`` in both."""
    jt, tt = _ckpt_trees()
    d_ref = jckpt.save(str(tmp_path / "ref"), 7, jt)
    d_port = ckpt.save(str(tmp_path / "port"), 7, tt)
    assert os.path.basename(d_port) == "step_00000007"
    with open(os.path.join(d_ref, "manifest.json")) as f:
        m_ref = f.read()
    with open(os.path.join(d_port, "manifest.json")) as f:
        m_port = f.read()
    assert m_ref == m_port
    for fn in sorted(os.listdir(d_ref)):
        with open(os.path.join(d_ref, fn), "rb") as a, \
                open(os.path.join(d_port, fn), "rb") as b:
            assert a.read() == b.read(), fn
    src = str(tmp_path / ("ref" if writer == "reference" else "port"))
    in_port = ckpt.restore(src, None, tt)
    in_ref = jckpt.restore(src, 7, jt)
    assert isinstance(in_port["opt"], OptState)
    assert in_port["params"]["b"]["c"].dtype == torch.bfloat16
    for want, a, b in zip(leaves(tt), leaves(in_port),
                          jax.tree.leaves(in_ref)):
        assert _bits(a) == _bits(want)
        assert _bits(b)[0] == _bits(want)[0]
    shard = sorted(glob.glob(os.path.join(src, "step_00000007", "*.npy")))[0]
    arr = np.load(shard)
    np.save(shard, arr.view(np.uint8) ^ np.uint8(1) if arr.dtype.kind == "V"
            else arr + 1)
    with pytest.raises(IOError):
        ckpt.restore(src, 7, tt)
    with pytest.raises(IOError):
        jckpt.restore(src, 7, jt)


def test_checkpoint_roundtrip_integrity_and_gc(tmp_path):
    """``test_checkpoint_roundtrip_and_integrity`` and
    ``test_checkpoint_gc_keeps_latest`` on the port's own saves."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones((2,), dtype=torch.int32)}}
    d = ckpt.save(str(tmp_path / "rt"), 7, tree)
    assert d.endswith("step_00000007")
    back = ckpt.restore(str(tmp_path / "rt"), None, tree)
    assert torch.equal(back["a"], tree["a"])
    assert back["b"]["c"].dtype == torch.int32
    shard = glob.glob(os.path.join(d, "*.npy"))[0]
    np.save(shard, np.load(shard) + 1)
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path / "rt"), 7, tree)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), None, tree)
    with pytest.raises(KeyError):
        ckpt.restore(str(tmp_path / "rt"), 7, {"x": torch.zeros(1)})
    gc_dir = str(tmp_path / "gc")
    for s in [1, 2, 3, 4, 5]:
        ckpt.save(gc_dir, s, {"x": torch.zeros(3)}, keep=2)
    assert ckpt.latest_step(gc_dir) == 5
    assert sorted(os.listdir(gc_dir)) == ["step_00000004", "step_00000005"]
    saver = ckpt.AsyncSaver()
    saver.save(gc_dir, 6, {"x": torch.ones(3)}, keep=2)
    saver.wait()
    assert ckpt.latest_step(gc_dir) == 6


def test_async_save_snapshots_cpu_leaves_before_in_place_update(tmp_path):
    """A CPU tree saved by ``AsyncSaver`` and then updated in place (as a
    donated train step's AdamW does) restores its pre-save values bit for
    bit: the snapshot owns its memory before the writer thread starts."""
    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn((512, 1024), generator=g),
            "b": torch.randn((4096,), generator=g).to(torch.bfloat16),
            "t": torch.randn((64, 96), generator=g).t(),   # non-contiguous
            "n": torch.arange(4096, dtype=torch.int32),
            "opt": {"m": torch.randn((256, 256), generator=g),
                    "step": torch.tensor(7, dtype=torch.int32)}}
    before = tree_map(lambda t: t.clone(), tree)
    saver = ckpt.AsyncSaver()
    saver.save(str(tmp_path), 1, tree)
    for leaf in flatten(tree):
        leaf[1].add_(1)
    saver.wait()
    back = ckpt.restore(str(tmp_path), 1, tree)
    for (p, want), (_, got) in zip(flatten(before), flatten(back)):
        assert got.dtype == want.dtype, p
        assert torch.equal(got, want), p


def test_restore_places_leaves_by_device_fn(tmp_path):
    """``test_elastic_restore_resharding``: a leaf goes where ``device_fn``
    says (here the meta device), else to the device of ``like``'s leaf."""
    tree = {"w": torch.arange(64.0).reshape(8, 8), "u": torch.ones(2)}
    ckpt.save(str(tmp_path), 1, tree)
    seen = []

    def place(key, shape):
        seen.append((key, shape))
        return "meta" if key == "w" else None
    out = ckpt.restore(str(tmp_path), 1, tree, device_fn=place)
    assert out["w"].device.type == "meta" and out["w"].shape == (8, 8)
    assert out["u"].device.type == "cpu" and torch.equal(out["u"],
                                                          tree["u"])
    assert sorted(seen) == [("u", (2,)), ("w", (8, 8))]


# ---------------------------------------------------------------------------
# the train step against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """qwen3-0.6b-smoke in fp32: the reference's own parameters in both
    packages, a batch of 8 x 32 from the data pipeline; the reference's
    jitted steps at accumulation 1 and 4, its loss and gradients (over the
    batch, and summed over 4 microbatches then divided, as its scan does)
    and its AdamW update."""
    jp, tp = ref_params(SMOKE, "f32")
    jcfg = dataclasses.replace(_jcfg(), param_dtype=jnp.float32)
    tcfg = dataclasses.replace(_tcfg(), param_dtype=torch.float32)
    jb = JD.make_batch(JD.DataConfig(jcfg.vocab_size, 8, 32), 0)

    def loss_fn(p, b):
        out = JT.forward(p, jcfg, b["inputs"], b["positions"], mode="train")
        return JS.lm_loss(out.logits, b["labels"]) + \
            0.01 * out.aux.get("moe_lb", 0.0)
    grads = {1: ref_compiled(jax.value_and_grad(loss_fn), jp, jb)(jp, jb)}
    micro = [jax.tree.map(lambda a: a[2 * i:2 * i + 2], jb)
             for i in range(4)]
    vg = ref_compiled(jax.value_and_grad(loss_fn), jp, micro[0])
    outs = [vg(jp, mb) for mb in micro]
    loss, acc = np.float32(0.0), [np.asarray(g) for g in
                                  jax.tree.leaves(outs[0][1])]
    for i, (li, gi) in enumerate(outs):
        loss = loss + np.float32(li)
        if i:
            acc = [a + np.asarray(g) for a, g in
                   zip(acc, jax.tree.leaves(gi))]
    grads[4] = (loss / np.float32(4), jax.tree.unflatten(
        jax.tree.structure(outs[0][1]), [a / np.float32(4) for a in acc]))
    jo = JO.init_opt_state(jp)
    steps = {}
    for accum in (1, 4):
        fn = JS.make_train_step(jcfg, JO.AdamWConfig(**OPT), accum_steps=accum)
        steps[accum] = ref_compiled(fn, jp, jo, jb)(jp, jo, jb)
    adamw = ref_compiled(lambda p, g, o: JO.adamw_update(
        JO.AdamWConfig(**OPT), p, g, o), jp, grads[1][1], jo)
    return dict(jp=jp, jo=jo, tp=tp, tcfg=tcfg, batch=torch_batch(jb),
                grads=grads, steps=steps, adamw=adamw)


def _jcfg():
    from repro.configs import get_config
    return get_config(SMOKE)


def _tcfg():
    from repro_torch.configs import get_config
    return get_config(SMOKE)


# the first AdamW step moves an element by lr * c g / (|c g| + eps): about
# lr times the sign of its clipped gradient c g, so where |c g| is near
# eps a gradient difference at fp32 rounding (1e-7 of the leaf's largest)
# moves it by up to lr; from WELL_POSED * eps on, by under 1e-8
WELL_POSED = 100


def close_where_well_posed(got, want, g_ref, g_port, scale, eps, tol):
    """Parameters after a first AdamW step against the reference's at the
    elements where that step is well posed: ``|scale * g| >= WELL_POSED *
    eps`` for the reference's gradient ``g``, or a gradient exactly zero in
    both packages (a pure decay); each leaf within ``tol`` of its scale
    there.  Returns the share of elements left out (the caller bounds it);
    the step at every element is held by the reference's AdamW on the
    port's own gradients."""
    left = total = 0
    for a, w, g, gp in zip(leaves(got), jax.tree.leaves(want),
                           jax.tree.leaves(g_ref), leaves(g_port)):
        g = np.asarray(g)
        well = (np.abs(scale * g) >= WELL_POSED * eps) | (
            (g == 0) & (f32(gp) == 0))
        err = np.abs(f32(a) - np.asarray(w))[well]
        assert float(err.max(initial=0.0)) <= \
            tol * max(1.0, float(np.abs(w).max(initial=0.0)))
        left += int((~well).sum())
        total += g.size
    return left / total


def close_grads(got, want):
    """Each leaf's gradient within 1e-4 of its largest entry.  A leaf
    whose gradient is zero in exact arithmetic (whisper's cross-attention
    key bias: softmax ignores a shift shared by every key) is rounding
    noise in both packages: where the reference's largest entry is below
    ``1e-7`` of the tree's largest, both sides are held below that."""
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    noise = 1e-7 * max(float(np.abs(w).max(initial=0.0)) for w in want)
    for (path, g), w in zip(flatten(got), want):
        assert g.dtype == torch.float32 and g.shape == w.shape, path
        top = float(np.abs(w).max(initial=0.0))
        if 0 < top < noise:
            assert float(g.abs().max()) < noise, path
            continue
        assert float(np.abs(f32(g) - w).max(initial=0.0)) <= \
            1e-4 * top, path


def test_loss_and_grads_match_reference(smoke):
    """The loss within 1e-5 and every leaf's gradient within 1e-4 of its
    max against ``jax.value_and_grad`` of the reference's train loss."""
    for accum in (1, 4):
        loss, grads = loss_and_grads(smoke["tp"], smoke["tcfg"],
                                     smoke["batch"], accum_steps=accum)
        jl, jg = smoke["grads"][accum]
        np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
        close_grads(grads, jg)


@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_reference(smoke, accum):
    """``make_train_step`` against the reference's jitted step: loss and
    grad norm within 1e-5; the parameters and moments after the step
    within 1e-6 of each leaf's scale of the reference's AdamW applied to
    the port's own gradients (every element), and of the reference's step
    wherever that is well posed (:func:`close_where_well_posed`: at least
    95 % of the elements); the caller's parameters untouched."""
    c = AdamWConfig(**OPT)
    tp = smoke["tp"]
    before = [t.clone() for t in leaves(tp)]
    _, grads = loss_and_grads(tp, smoke["tcfg"], smoke["batch"],
                              accum_steps=accum)
    p2, o2, m = make_train_step(smoke["tcfg"], c, accum_steps=accum)(
        tp, init_opt_state(tp), smoke["batch"])
    jp2, jo2, jm = smoke["steps"][accum]
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    rp, ro, _ = smoke["adamw"](smoke["jp"], jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), grads), smoke["jo"])
    close_scaled(p2, rp, 1e-6)
    close_scaled(o2.m, ro.m, 1e-6)
    close_scaled(o2.v, ro.v, 1e-6)
    scale = min(1.0, c.grad_clip / float(jm["grad_norm"]))
    assert close_where_well_posed(p2, jp2, smoke["grads"][accum][1], grads,
                                  scale, c.eps, 1e-6) < 0.05
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(tp)))


def test_grad_accumulation_matches_full_batch(smoke):
    """``test_grad_accumulation_matches_full_batch`` in the port: the same
    batch at accumulation 1 and 4 (the port's donated step, in place on
    copies)."""
    c = AdamWConfig(**OPT)
    out = {}
    for accum in (1, 4):
        p = jax.tree.map(lambda t: t.clone(), smoke["tp"])
        p2, _, m = make_train_step(smoke["tcfg"], c, accum_steps=accum,
                                   donate=True)(p, init_opt_state(p),
                                                smoke["batch"])
        assert p2["embed"] is p["embed"]
        out[accum] = (p2, float(m["loss"]))
    np.testing.assert_allclose(out[1][1], out[4][1], rtol=1e-4)
    assert max(float((a - b).abs().max()) for a, b in
               zip(leaves(out[1][0]), leaves(out[4][0]))) < 5e-3


def test_adamw_decreases_loss():
    """``test_adamw_decreases_loss``: 12 steps on the data pipeline."""
    cfg = dataclasses.replace(_tcfg(), param_dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    step = make_train_step(cfg, AdamWConfig(**OPT), donate=True)
    opt = init_opt_state(params)
    dc = DataConfig(cfg.vocab_size, global_batch=8, seq_len=64)
    losses = []
    for i in range(12):
        params, opt, m = step(params, opt, make_batch(dc, i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    assert np.isfinite(losses).all()


def test_train_loop_resumes_from_checkpoint(tmp_path):
    """``test_train_loop_resumes_from_checkpoint``: 6 steps saving every 3,
    a fresh loop resumes to 10, equal to 10 straight steps within 1e-5."""
    cfg = dataclasses.replace(_tcfg(), param_dtype=torch.float32)
    params = init_params(cfg, 0, device="cpu")
    step = make_train_step(cfg, AdamWConfig(**OPT))
    opt = init_opt_state(params)
    dc = DataConfig(cfg.vocab_size, global_batch=4, seq_len=32)
    quiet = dict(log=lambda *_: None)
    _, _, st1 = train_loop(step, params, opt, dc, LoopConfig(
        total_steps=6, ckpt_every=3, ckpt_dir=str(tmp_path), log_every=100),
        **quiet)
    assert st1.step == 6
    assert ckpt.latest_step(str(tmp_path)) == 6
    p2, o2, st2 = train_loop(step, params, opt, dc, LoopConfig(
        total_steps=10, ckpt_every=100, ckpt_dir=str(tmp_path),
        log_every=100), **quiet)
    assert st2.step == 10 and int(o2.step) == 10
    pX, _, _ = train_loop(step, params, opt, dc, LoopConfig(
        total_steps=10, ckpt_every=100, ckpt_dir=str(tmp_path / "x"),
        log_every=100), **quiet)
    assert max(float((a - b).abs().max())
               for a, b in zip(leaves(p2), leaves(pX))) < 1e-5


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def test_int8_compression_error_feedback_matches_reference():
    """``test_int8_compression_error_feedback`` in the port, and each
    round's payload equal to the reference's (scales and residuals within
    1e-6 relative) over 8 rounds of error feedback."""
    w = np.asarray(jax.random.normal(jax.random.key(0), (64, 64)))
    jg = {"w": jnp.asarray(w), "b": jnp.asarray(w[0] * 1e-3)}
    g = {"w": torch.tensor(w), "b": torch.tensor(w[0] * 1e-3)}
    ef = C.init_ef(g)
    err = float(C.compression_error(g, ef))
    assert err < 0.02
    np.testing.assert_allclose(err, float(JC.compression_error(
        jg, JC.init_ef(jg))), rtol=1e-5)
    q, s, ef2 = C.compress_grads(g, ef)
    deq = C.decompress_grads(q, s)
    torch.testing.assert_close(ef2.residual["w"], g["w"] - deq["w"],
                               rtol=1e-5, atol=1e-6)
    total = torch.zeros_like(g["w"])
    ef, jef = C.init_ef(g), JC.init_ef(jg)
    for _ in range(8):
        q, s, ef = C.compress_grads(g, ef)
        jq, js, jef = JC.compress_grads(jg, jef)
        for k in g:
            assert q[k].dtype == torch.int8
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(jq[k]))
            np.testing.assert_allclose(float(s[k]), float(js[k]), rtol=1e-6)
            close_scaled({k: ef.residual[k]}, {k: jef.residual[k]}, 1e-6)
        total = total + C.decompress_grads(q, s)["w"]
    torch.testing.assert_close(total / 8, g["w"], rtol=0, atol=0.02)


def test_prefill_and_decode_steps():
    """``make_prefill_step`` is ``forward(mode="prefill")``;
    ``make_decode_step`` runs ``forward(mode="decode")`` for a GQA config
    and, for the ESS-enabled DSA config, ``ess_decode`` on its
    ``ESSCaches`` (the same logits as a direct call on a second prefill
    of the same prompt)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    toks = torch.randint(0, 200, (2, 9),
                         generator=torch.Generator().manual_seed(3))
    pos = torch.arange(9)[None].expand(2, 9)
    cfg = dataclasses.replace(_tcfg(), param_dtype=torch.float32)
    p = init_params(cfg, 0, device="cpu")
    logits, caches = make_prefill_step(cfg)(
        p, {"inputs": toks[:, :8], "positions": pos[:, :8]})
    want = T.forward(p, cfg, toks[:, :8], pos[:, :8], mode="prefill")
    assert torch.equal(logits, want.logits)
    caches = T.pad_caches(caches, 12)
    dl, dc = make_decode_step(cfg)(p, {"inputs": toks[:, 8:],
                                       "positions": pos[:, 8:],
                                       "caches": caches})
    assert dc["lens"].tolist() == [9, 9]
    full = T.forward(p, cfg, toks, pos, mode="prefill")
    torch.testing.assert_close(dl[:, -1], full.logits[:, -1], rtol=1e-4,
                               atol=1e-4)
    ess = get_config("deepseek-v32-exp-ess-smoke")
    pe = init_params(ess, 0, device="cpu")
    out = []
    for direct in (False, True):
        _, c = E.ess_prefill(pe, ess, toks[:, :8], pos[:, :8], 16)
        if direct:
            out.append(E.ess_decode(pe, ess, toks[:, 8:], pos[:, 8:], c,
                                    slot_mask=None).logits)
        else:
            step = make_decode_step(ess)
            out.append(step(pe, {"inputs": toks[:, 8:],
                                 "positions": pos[:, 8:], "caches": c})[0])
    assert torch.equal(out[0], out[1])
