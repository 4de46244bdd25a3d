"""The slice end to end on the CPU: the port's ``ess_prefill`` (chunked
prefill + LRU warmup) and teacher-forced ``ess_decode`` steps against the
reference's, at smoke size and the same prefill chunk size (the reference
is not chunk-size invariant on every JAX version).

* fp32: logits of every step at rtol/atol 1e-5; lens, indexer keys, host
  tier, block tables and pool state after every step; pool maps, block
  tables and lens **equal**.
* bf16: logits at rtol/atol 5e-2 — the reference's plain attend rounds the
  softmax weights to bf16 while the port follows the Pallas kernel's fp32
  math, and the deeper layers' top-k selections may differ at near-ties —
  and the first greedy token equal.  One decode step from identical caches
  is also held against the reference's ``use_kernel=True`` path (Pallas in
  interpret mode), whose attention math the port's kernels follow.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.models.params import init_params as jinit
from repro.serving import engine as JE
from repro_torch.cache import latent_cache as LC
from repro_torch.configs import get_config as tget
from repro_torch.launch import serve as SV
from repro_torch.models.params import array_to_torch, from_jax_params
from repro_torch.serving import engine as TE

pytest_plugins = ("_torch_cpu",)  # one torch thread; JAX freed per file

B, S, MAX_SEQ, CHUNK, STEPS = 2, 20, 32, 8, 3
CFG = "deepseek-v32-exp-ess-smoke"
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=5e-2, atol=5e-2)}


def cfgs(dt):
    return (dataclasses.replace(jget(CFG), param_dtype=JDT[dt]),
            dataclasses.replace(tget(CFG), param_dtype=TDT[dt]))


def prompts():
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    return toks, np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)


def snapshot(c):
    return jax.tree.map(np.asarray, c)


@pytest.fixture(scope="module", params=["f32", "bf16"])
def reference(request):
    """The reference's prefill + STEPS teacher-forced decode steps (jit'd:
    the eager path compiles every op and is several times slower)."""
    dt = request.param
    jcfg, tcfg = cfgs(dt)
    defs = JT.model_def(jcfg)
    jp = jax.jit(lambda k: jinit(k, defs))(jax.random.key(0))
    toks, pos = prompts()
    prefill = jax.jit(JE.ess_prefill, static_argnums=(1, 4),
                      static_argnames=("prefill_chunk",))
    decode = jax.jit(JE.ess_decode, static_argnums=(1,),
                     static_argnames=("use_kernel",))
    logits, caches = prefill(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                             MAX_SEQ, prefill_chunk=CHUNK)
    out = {"dt": dt, "jcfg": jcfg, "tcfg": tcfg, "jp": jp,
           "decode": decode, "prefill_logits": np.asarray(logits),
           "prefill_caches": snapshot(caches), "caches_live": caches,
           "steps": []}
    tok = np.asarray(jnp.argmax(logits[:, -1], -1))
    for _ in range(STEPS):
        p = np.asarray(caches.lens)[:, None]
        o = decode(jp, jcfg, jnp.asarray(tok[:, None]), jnp.asarray(p),
                   caches)
        caches = o.caches
        out["steps"].append((tok, p, np.asarray(o.logits),
                             snapshot(caches)))
        tok = np.asarray(jnp.argmax(o.logits[:, 0], -1))
    return out


def T(a):
    return array_to_torch(a)


def assert_caches(tc, jc, dt, exact_maps):
    np.testing.assert_array_equal(tc.lens.numpy(), jc.lens)
    np.testing.assert_array_equal(tc.block_tables.numpy(), jc.block_tables)
    if not exact_maps:
        return
    tol = TOL[dt]
    np.testing.assert_allclose(tc.host_latent.float().numpy(),
                               np.asarray(jc.host_latent, np.float32), **tol)
    for layer, (tp, jp) in enumerate(zip(tc.pools, jc.pools)):
        np.testing.assert_allclose(tc.ikeys[layer].float().numpy(),
                                   np.asarray(jc.ikeys[layer], np.float32),
                                   **tol)
        for f in ("ids", "last_use", "slot_of", "step"):
            np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                          getattr(jp, f), err_msg=f)
        np.testing.assert_allclose(tp.data.float().numpy(),
                                   np.asarray(jp.data, np.float32), **tol)


def test_prefill_and_teacher_forced_decode_match_reference(reference):
    dt, tcfg = reference["dt"], reference["tcfg"]
    tp = from_jax_params(jax.tree.map(np.asarray, reference["jp"]))
    toks, pos = prompts()
    logits, caches = TE.ess_prefill(tp, tcfg, T(toks).long(),
                                    T(pos).long(), MAX_SEQ,
                                    prefill_chunk=CHUNK)
    want = reference["prefill_logits"]
    np.testing.assert_allclose(logits.numpy(), want, **TOL[dt])
    assert_caches(caches, reference["prefill_caches"], dt, dt == "f32")
    # the first greedy token is equal
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(),
                                  want[:, -1].argmax(-1))
    for tok, p, jlogits, jcaches in reference["steps"]:
        o = TE.ess_decode(tp, tcfg, T(tok[:, None]).long(), T(p).long(),
                          caches)
        caches = o.caches
        np.testing.assert_allclose(o.logits.numpy(), jlogits, **TOL[dt])
        assert_caches(caches, jcaches, dt, dt == "f32")


def test_decode_step_matches_reference_use_kernel(reference):
    """From the reference's own post-prefill caches, one decode step of the
    port against the reference with its Pallas kernels (interpret mode):
    fp32 at 1e-5, bf16 at the kernels' 2e-2."""
    jcfg, tcfg, jp = reference["jcfg"], reference["tcfg"], reference["jp"]
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    jc = reference["caches_live"]
    tok, p = reference["steps"][0][:2]
    jo = reference["decode"](jp, jcfg, jnp.asarray(tok[:, None]),
                             jnp.asarray(p), jc, use_kernel=True)
    to = TE.ess_decode(tp, tcfg, T(tok[:, None]).long(), T(p).long(),
                       LC.from_jax_caches(reference["prefill_caches"]))
    tol = TOL["f32"] if reference["dt"] == "f32" else dict(rtol=2e-2,
                                                           atol=2e-2)
    np.testing.assert_allclose(to.logits.numpy(), np.asarray(jo.logits),
                               **tol)
    np.testing.assert_array_equal(to.stats["misses"].numpy(),
                                  np.asarray(jo.stats["misses"]))
    for tpl, jpl in zip(to.caches.pools, jo.caches.pools):
        np.testing.assert_array_equal(tpl.slot_of.numpy(),
                                      np.asarray(jpl.slot_of))


def test_generate_batch_on_cpu_serves_and_counts():
    tcfg = tget(CFG)
    from repro_torch.models.params import init_params
    params = init_params(tcfg, 0, device="cpu")
    toks, _ = prompts()
    res = TE.generate_batch(params, tcfg, toks, 5, MAX_SEQ, prefill_chunk=8,
                            device="cpu")
    assert res.tokens.shape == (B, 5) and res.logits_finite
    assert res.misses.shape == (4, B) and res.misses.sum() > 0
    assert res.evicted > 0
    assert int(res.caches.lens[0]) == S + 4
    # greedy decode is the teacher-forced stream of its own tokens
    logits, caches = TE.ess_prefill(params, tcfg, T(toks).long(),
                                    T(prompts()[1]).long(), MAX_SEQ,
                                    prefill_chunk=8, last_logits_only=True)
    np.testing.assert_array_equal(logits[:, -1].argmax(-1).numpy(),
                                  res.tokens[:, 0])


def test_serve_cli_runs_on_cpu(capsys):
    assert SV.main(["--device", "cpu", "--requests", "2", "--prompt-len",
                    "24", "--new-tokens", "3", "--prefill-chunk", "8"]) == 0
    out = capsys.readouterr().out
    assert "tok/s" in out and "pool hit rate" in out
    # MTP speculative rounds with sampled requests
    assert SV.main(["--device", "cpu", "--requests", "2", "--prompt-len",
                    "24", "--new-tokens", "3", "--prefill-chunk", "8",
                    "--mtp-depth", "1", "--temperature", "0.8",
                    "--top-k", "16"]) == 0
    out = capsys.readouterr().out
    assert "speculative rounds" in out and "pool hit rate" in out
    assert " 0 speculative" not in out


def test_serve_cli_session_flags_on_cpu():
    """The launcher's other session flags: ``--slots`` and ``--max-seq``
    size the session, ``--stop-token`` ends a stream at that token,
    ``--top-p`` samples, ``--eager`` keeps the rounds eager (on the CPU
    they always are)."""
    base = ["--device", "cpu", "--requests", "2", "--prompt-len", "24",
            "--new-tokens", "4", "--prefill-chunk", "8", "--slots", "1",
            "--max-seq", "40", "--eager"]
    out = SV.run(SV.build_parser().parse_args(base))
    s, rep = out["session"], out["report"]
    assert (s.num_slots, s.max_seq, s.compiled) == (1, 40, False)
    assert sorted(rep.finished_rids) == [0, 1]
    stream = s.outputs[0]
    assert all(len(s.outputs[r]) == 4 for r in (0, 1))
    stop = stream[1]
    cut = SV.run(SV.build_parser().parse_args(
        base + ["--stop-token", str(stop)]), params=out["params"])
    first = stream.index(stop)
    assert cut["session"].outputs[0] == stream[:first + 1]
    assert cut["report"].finish_reasons[0] == "stop"
    sampled = SV.run(SV.build_parser().parse_args(
        base + ["--temperature", "0.9", "--top-p", "0.5"]),
        params=out["params"])
    assert all(len(sampled["session"].outputs[r]) == 4 for r in (0, 1))
