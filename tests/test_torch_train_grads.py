"""The port's train step on the SSM, hybrid and encoder-decoder stacks
against the reference on the CPU, fp32, from the reference's own
parameters (``from_jax_params``): mamba2-780m, zamba2-7b and
whisper-large-v3 at smoke widths (deepseek-v32-exp-ess, its DSA mask,
MoE and MTP head: ``test_torch_train_grads_dsa.py``, the same tests on
its own fixture).

For each: the loss within 1e-5 and every leaf's gradient within 1e-4 of
its max against ``jax.value_and_grad`` of the reference's train loss
(``lm_loss + 0.01 * moe_lb``, its ``make_train_step``'s); the leaves the
loss does not reach (V3.2's MTP head and its indexer, behind the boolean
DSA mask) exactly zero in both; the parameters after one AdamW step
within 1e-6 of the reference's ``adamw_update`` on the port's gradients,
and of the reference's step wherever that step is well posed
(``test_torch_training.close_where_well_posed``: at least 95 % of the
elements), the zero-gradient leaves decayed exactly as there.  In the port, the gradients are the same bit for bit
under remat ``"none"``, ``"full"`` and ``"dots"``, and each mode
recomputes what it should.

The reference runs jitted once per config (``ref_compiled``: every op
rounded to its dtype, LLVM's expensive passes off).
"""

import _torch_cpu  # noqa: F401  (one torch thread: see the module)
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.launch import steps as JS
from repro.models import transformer as JT
from repro.training import data as JD
from repro.training import optimizer as JO
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models.params import init_params
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.tree import flatten, leaves
from test_torch_archs import _ref_params_f32, configs, ref_compiled, ref_params
from test_torch_training import (close_grads, close_scaled,
                                 close_where_well_posed)

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

CONFIGS = ["mamba2-780m-smoke", "zamba2-7b-smoke", "whisper-large-v3-smoke"]
OPT = dict(lr=1e-3, total_steps=50, warmup_steps=5)
B, S = 2, 32


@pytest.fixture(scope="module", autouse=True)
def _drop_compiled():
    yield
    ref_params.cache_clear()
    _ref_params_f32.cache_clear()
    jax.clear_caches()


def make_case(name):
    """Both packages' parameters and batch; the reference's loss, its
    gradients and its step (``value_and_grad`` then ``adamw_update``: its
    ``make_train_step`` at accumulation 1) in one jitted program, and its
    AdamW alone."""
    jcfg, tcfg = configs(name, "f32")
    jp, tp = ref_params(name, "f32")
    jb = dict(JD.make_batch(JD.DataConfig(jcfg.vocab_size, B, S), 0))
    if jcfg.encdec is not None:
        e = np.random.default_rng(5).standard_normal(
            (B, jcfg.encdec.encoder_seq, jcfg.d_model)).astype(np.float32)
        jb["enc_inputs"] = jnp.asarray(e)
    opt = JO.AdamWConfig(**OPT)

    def loss_fn(p, b):
        out = JT.forward(p, jcfg, b["inputs"], b["positions"], mode="train",
                         enc_inputs=b.get("enc_inputs"))
        return JS.lm_loss(out.logits, b["labels"]) + \
            0.01 * out.aux.get("moe_lb", 0.0)

    def step(p, o, b):
        loss, g = jax.value_and_grad(loss_fn)(p, b)
        p2, o2, om = JO.adamw_update(opt, p, g, o)
        return loss, g, p2, om
    jo = JO.init_opt_state(jp)
    ref = ref_compiled(step, jp, jo, jb)(jp, jo, jb)
    adamw = ref_compiled(lambda p, g, o: JO.adamw_update(opt, p, g, o),
                         jp, ref[1], jo)
    batch = {k: torch.tensor(np.asarray(v)) for k, v in jb.items()}
    for k in ("inputs", "labels", "positions"):
        batch[k] = batch[k].long()
    return dict(name=name, tcfg=tcfg, tp=tp, jp=jp, jo=jo, batch=batch,
                ref=ref, adamw=adamw)


@pytest.fixture(scope="module", params=CONFIGS)
def case(request):
    return make_case(request.param)


def test_loss_and_grads_match_reference(case):
    """Loss within 1e-5, each leaf's gradient within 1e-4 of its max; the
    same leaves exactly zero in both packages (V3.2: the MTP head and the
    indexer, and only those)."""
    loss, grads = loss_and_grads(case["tp"], case["tcfg"], case["batch"])
    jl, jg = case["ref"][:2]
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    close_grads(grads, jg)
    zero = []
    for (path, g), w in zip(flatten(grads), jax.tree.leaves(jg)):
        w = np.asarray(w)
        assert (float(g.abs().max()) == 0.0) == (not np.abs(w).any()), path
        if not np.abs(w).any():
            zero.append(path)
    if case["name"].startswith("deepseek-v32"):
        assert zero and all(p[0] == "mtp" or "indexer" in p for p in zero)
        assert any(p[0] == "mtp" for p in zero)
        assert sum("indexer" in p for p in zero) == \
            sum("indexer" in p for p, _ in flatten(grads))
    else:
        assert not zero


def test_train_step_matches_reference(case):
    """One ``make_train_step`` step: loss and grad norm within 1e-5; the
    parameters and moments within 1e-6 of each leaf's scale of the
    reference's AdamW on the port's gradients; the parameters within 1e-6
    of the reference's step wherever it is well posed, every element of
    the zero-gradient leaves (decayed alike) among them."""
    c = AdamWConfig(**OPT)
    tp = case["tp"]
    _, grads = loss_and_grads(tp, case["tcfg"], case["batch"])
    p2, o2, m = make_train_step(case["tcfg"], c)(tp, init_opt_state(tp),
                                                 case["batch"])
    jl, jg, jp2, jm = case["ref"]
    np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    rp, ro, _ = case["adamw"](case["jp"], jax.tree.map(
        lambda t: jnp.asarray(t.numpy()), grads), case["jo"])
    close_scaled(p2, rp, 1e-6)
    close_scaled(o2.m, ro.m, 1e-6)
    close_scaled(o2.v, ro.v, 1e-6)
    scale = min(1.0, c.grad_clip / float(jm["grad_norm"]))
    assert close_where_well_posed(p2, jp2, jg, grads, scale, c.eps,
                                  1e-6) < 0.05


def test_grads_equal_across_remat(case):
    """``"none"``, ``"full"`` and ``"dots"`` give the same loss and
    gradients bit for bit (remat recomputes, it changes no value)."""
    out = {}
    for r in ("none", "full", "dots"):
        cfg = dataclasses.replace(case["tcfg"], remat=r)
        out[r] = loss_and_grads(case["tp"], cfg, case["batch"])
    for r in ("full", "dots"):
        assert torch.equal(out[r][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(leaves(out[r][1]), leaves(out["none"][1])))


class _OpCount(TorchDispatchMode):
    """Counts the matrix products (``mm`` / ``addmm`` and ``bmm`` apart)
    and the softmaxes that run."""

    def __init__(self):
        super().__init__()
        self.n = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func in (aten.mm.default, aten.addmm.default):
            self.n["mm"] += 1
        elif func is aten.bmm.default:
            self.n["bmm"] += 1
        elif func is aten._softmax.default:
            self.n["softmax"] += 1
        return func(*args, **(kwargs or {}))


def _backward_counts(name, b, s):
    """The products and softmaxes of the backward alone, under each remat
    mode, of ``name``'s train loss at batch ``b`` x seq ``s`` (fp32, the
    port's own parameters)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import train_loss
    base = get_config(name, param_dtype=torch.float32)
    params = init_params(base, 0, device="cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    toks = torch.randint(0, base.vocab_size, (b, s),
                         generator=torch.Generator().manual_seed(0))
    batch = {"inputs": toks, "labels": toks,
             "positions": torch.arange(s)[None].expand(b, s)}
    counts = {}
    for r in ("none", "full", "dots"):
        loss, _ = train_loss(params, dataclasses.replace(base, remat=r),
                             batch)
        with _OpCount() as c:
            loss.backward()
        counts[r] = c.n
    # "none" recomputes nothing; "full" reruns every product of the
    # forward; "dots" reruns the batched ones but takes the projections'
    # outputs (mm) from what the forward kept
    assert counts["none"]["softmax"] == 0
    assert counts["full"]["mm"] > counts["none"]["mm"] == counts["dots"]["mm"]
    assert counts["none"]["bmm"] < counts["dots"]["bmm"] == \
        counts["full"]["bmm"]
    return base, counts


def test_remat_modes_recompute_what_they_should():
    """qwen3-0.6b-smoke (3 layers) at batch 2, the backward alone
    counted: ``"none"`` recomputes nothing; ``"full"`` reruns each layer's
    forward (its softmax and its products); ``"dots"`` reruns the softmax
    and the batched products but takes the projections' outputs from what
    the forward kept."""
    base, counts = _backward_counts("qwen3-0.6b-smoke", 2, 16)
    L = base.num_layers
    assert counts["full"]["softmax"] == counts["dots"]["softmax"] == L


def test_remat_dots_recomputes_mla_attention_at_batch_1():
    """deepseek-v32-exp-ess-smoke at batch 1 (the usual long-sequence
    micro-batch) over its top-k, so the DSA mask is live: MLA's train
    attention products (``bqhd,bkd->bhqk``, ``bhqk,bkv->bqhv``) run as a
    ``bmm`` over a batch of 1, and ``"dots"`` recomputes them, as the
    reference's ``dots_with_no_batch_dims_saveable`` does (``b`` is a
    batch dim whatever its size), while keeping every projection."""
    base, counts = _backward_counts("deepseek-v32-exp-ess-smoke", 1, 32)
    assert base.dsa.index_topk < 32
    assert counts["full"]["softmax"] == counts["dots"]["softmax"] >= \
        base.num_layers
