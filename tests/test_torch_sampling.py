"""The port's sampler against the reference's on the CPU.

* ``serving/prng.py`` — JAX's threefry2x32 keys, ``fold_in``, random bits
  and uniforms **bit for bit** at seeds 0, 1, 123 and 2**31 - 1, fold-in
  indices 0, 1 and 2**20, an odd length and the model's vocabulary
  (V = 129280); the Gumbel noise within 2 ulp.  The layout pinned here is
  the partitionable one (``jax_threefry_partitionable``); a JAX that
  changes it fails the first test instead of mismatching silently.
* ``serving/sampling.py`` — ``sample``, ``sample_one`` and
  ``sample_batch`` against the reference's on
  ``test_compiled_serve.test_sample_batch_matches_host_sample``'s cases
  and on V = 129280 rows: equal tokens on every draw.  The rule for a
  draw that differs (none does on these inputs): it passes only where its
  top two perturbed scores, or its top-p cumulative sum at the cutoff,
  lie within 4 ulp, and it is printed.

The noise is ``-log(-log(u))``: ``log`` is XLA:CPU's in the reference and
torch's here, each within about an ulp of the truth.  Near the noise's
zero (``u`` near 1/e) the outer log's argument sits near 1, whose own
rounding is an ulp of 1, so the noise's ulp is taken at ``max(|g|, 1)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampling as JS
from repro_torch.serving import prng
from repro_torch.serving import sampling as TS

SEEDS = [0, 1, 123, 2**31 - 1]
INDICES = [0, 1, 2**20]
V_FULL = 129280


def test_threefry_partitionable_layout_pinned():
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


def _jkey(seed, index=None):
    k = jax.random.key(seed)
    return k if index is None else jax.random.fold_in(k, index)


def _words(jk) -> np.ndarray:
    return np.asarray(jax.random.key_data(jk)).astype(np.int64)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.astype(np.float64) - b.astype(np.float64)) / np.spacing(
        np.maximum(np.abs(a), 1.0).astype(np.float32))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_uniforms_bit_for_bit(seed):
    tk = prng.key(seed)
    np.testing.assert_array_equal(tk.numpy(), _words(_jkey(seed)))
    for index in INDICES:
        jk = _jkey(seed, index)
        tf = TS.request_key(seed, index)
        np.testing.assert_array_equal(tf.numpy(), _words(jk))
        np.testing.assert_array_equal(
            _words(JS.request_key(seed, index)), tf.numpy())
        for n in (129, V_FULL):
            bits = np.asarray(jax.random.bits(jk, (n,), jnp.uint32))
            np.testing.assert_array_equal(prng.random_bits(tf, n).numpy(),
                                          bits.astype(np.int64))
            u = np.asarray(jax.random.uniform(jk, (n,)))
            np.testing.assert_array_equal(
                prng.uniform(tf, n).numpy().view(np.int32), u.view(np.int32))
            tiny = float(np.finfo(np.float32).tiny)
            u = np.asarray(jax.random.uniform(jk, (n,), minval=tiny))
            np.testing.assert_array_equal(
                prng.uniform(tf, n, tiny, 1.0).numpy().view(np.int32),
                u.view(np.int32))
            g = np.asarray(jax.random.gumbel(jk, (n,)))
            assert _ulps(prng.gumbel(tf, n).numpy(), g).max() <= 2.0


def test_batched_keys_match_per_row_keys():
    """Tensor seeds and indices (the serve state's ``[B]`` int32 knobs)
    give each row the key of its own Python-int call."""
    seeds = torch.tensor([0, 5, -7, 2**31 - 1], dtype=torch.int32)
    index = torch.tensor([3, 0, 2**20, 1], dtype=torch.int32)
    keys = TS.request_key(seeds, index)
    assert keys.shape == (4, 2)
    for i in range(4):
        np.testing.assert_array_equal(
            keys[i].numpy(), _words(_jkey(int(seeds[i]), int(index[i]))))
    bits = prng.random_bits(keys, 129)
    for i in range(4):
        np.testing.assert_array_equal(
            bits[i].numpy(), np.asarray(jax.random.bits(
                _jkey(int(seeds[i]), int(index[i])), (129,),
                jnp.uint32)).astype(np.int64))


def test_categorical_matches_reference():
    logits = np.asarray(jax.random.normal(jax.random.key(9), (V_FULL,)))
    for seed in SEEDS:
        jk = _jkey(seed, 4)
        want = int(jax.random.categorical(jk, logits))
        got = int(prng.categorical(TS.request_key(seed, 4),
                                   torch.from_numpy(logits.copy())))
        assert got == want


def _near_tie(seed, index, logits, temp, k, p) -> bool:
    """The port's draw for a case whose token differs: True where its top
    two perturbed scores, or its top-p cumulative sum at the cutoff, lie
    within 4 ulp (the rule for floats that are not bit-exact)."""
    lg = torch.from_numpy(logits).float().reshape(1, -1) / temp
    V = lg.shape[-1]
    kk = torch.tensor([0 if k is None or k >= V else k])
    pp = torch.tensor([1.0 if p is None else p])
    masked = TS._truncate(lg, kk, pp)
    sc = (prng.gumbel(TS.request_key(seed, index), V) + masked)[0]
    top2 = sc.topk(2).values.numpy()
    tie = _ulps(top2[:1], top2[1:])[0] <= 4
    if p is not None and p < 1.0:
        srt = torch.where(masked > float("-inf"), masked, lg).sort(
            descending=True).values
        e = torch.exp(srt - srt[:, :1])
        cum = torch.cumsum(e / e.sum(-1, keepdim=True), -1)[0].numpy()
        i = int((cum < p).sum())
        near = [c for c in cum[max(i - 1, 0):i + 1]
                if abs(c - p) <= 4 * np.spacing(np.float32(p))]
        tie = tie or bool(near)
    print(f"draw differs: seed {seed} index {index} T {temp} top_k {k} "
          f"top_p {p}: top two {top2}, within 4 ulp: {tie}")
    return tie


def _check_draws(cases, logits):
    """``cases`` rows ``(seed, index, temp, k, p)`` over ``logits [B,V]``:
    the reference's ``sample`` (eager and jitted ``sample_batch``) against
    the port's ``sample``, ``sample_one`` and ``sample_batch``."""
    seeds, idxs, temps, ks, ps = (list(c) for c in zip(*cases))
    ref = [int(JS.sample(JS.request_key(s, i), logits[r], t, k, p))
           for r, (s, i, t, k, p) in enumerate(cases)]
    kk = [0 if k is None else k for k in ks]
    pp = [1.0 if p is None else p for p in ps]
    jb = jax.jit(JS.sample_batch)(
        jnp.asarray(seeds, jnp.int32), jnp.asarray(idxs, jnp.int32), logits,
        jnp.asarray(temps, jnp.float32), jnp.asarray(kk, jnp.int32),
        jnp.asarray(pp, jnp.float32))
    assert [int(t) for t in jb] == ref
    tl = torch.from_numpy(logits.copy())
    host = [int(TS.sample(TS.request_key(s, i), tl[r], t, k, p))
            for r, (s, i, t, k, p) in enumerate(cases)]
    knobs = (torch.tensor(seeds, dtype=torch.int32),
             torch.tensor(idxs, dtype=torch.int32), tl,
             torch.tensor(temps), torch.tensor(kk, dtype=torch.int32),
             torch.tensor(pp))
    batch = TS.sample_batch(*knobs).tolist()
    one = [int(TS.sample_one(*(x[r] for x in knobs[:2]), tl[r],
                             *(x[r] for x in knobs[3:])))
           for r in range(len(cases))]
    assert host == batch == one
    for r, c in enumerate(cases):
        if batch[r] != ref[r]:
            assert _near_tie(*c[:2], logits[r], *c[2:])


def test_sample_matches_reference_small_vocab():
    """``test_compiled_serve.test_sample_batch_matches_host_sample``'s
    cases (V = 64; top_k = 64 = V is off, like None)."""
    logits = np.asarray(jax.random.normal(jax.random.key(0), (4, 64),
                                          jnp.float32))
    _check_draws([(3, 0, 0.7, 8, None), (11, 4, 1.3, None, 0.9),
                  (7, 2, 0.9, 64, 0.6), (5, 9, 1.0, 3, None)], logits)


@pytest.mark.parametrize("draw", range(4))
def test_sample_matches_reference_full_vocab(draw):
    """V = 129280 rows, the serve session's knobs (chip_smoke's session C:
    top-k 64 at T 0.8, top-p 0.9 at T 1.0) and both truncations at once."""
    logits = np.asarray(jax.random.normal(jax.random.key(100 + draw),
                                          (4, V_FULL), jnp.float32)) * 3
    _check_draws([(123, draw, 0.8, 64, None), (7, draw + 1, 1.0, None, 0.9),
                  (2**31 - 1, 2**20 + draw, 0.6, 1000, 0.95),
                  (draw, 5, 1.2, None, None)], logits)


def test_greedy_and_temperature_zero():
    """``test_serving.test_sampling_greedy_and_temperature``: temperature
    0 is the argmax; a top-2 draw picks one of the top two."""
    logits = torch.tensor([0.1, 3.0, -1.0])
    assert int(TS.greedy(logits)) == 1
    assert int(TS.sample(TS.request_key(0, 0), logits, 0.0)) == 1
    assert int(TS.sample(TS.request_key(0, 0), logits, 1.0, top_k=2)) \
        in (0, 1)
