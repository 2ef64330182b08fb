"""Seeded sampling: the port draws JAX's threefry stream.

- Threefry-2x32 known answers (Random123's vectors, which JAX's own tests
  use) and JAX's `PRNGKey`, `fold_in`, `bits` and `uniform` reproduced bit
  for bit; the Gumbel noise within a few float32 ulps (-log(-log(u)) through
  another log implementation than XLA's).
- Seeded `sample_tokens` ids identical to `llmlb_tpu.ops.sampling`'s over a
  grid of seeds, steps, temperatures, top-k and top-p.

Seeded engine streams against the JAX engine: tests/test_torch_quant_engine.py.
"""

import jax
import jax.extend.random as jrandom
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.ops import sampling as jsampling
from llmlb_tpu_torch.ops import _threefry, sampling

SEEDS = (0, 1, 7, 12345, 2**31 - 1)
STEPS = (0, 1, 5, 1000, 2**31 - 1, 2**32 - 1)


def _i64(x):
    return torch.tensor(x, dtype=torch.int64)


@pytest.mark.parametrize("key,count,want", [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
     (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
])
def test_threefry2x32_known_answers(key, count, want):
    got = _threefry.threefry2x32(*(_i64(v) for v in key + count))
    assert (int(got[0]), int(got[1])) == want
    ref = jrandom.threefry_2x32(np.array(key, np.uint32),
                                np.array(count, np.uint32))
    assert np.asarray(ref).tolist() == list(want)


def test_keys_bits_and_uniforms_match_jax():
    tiny = np.finfo(np.float32).tiny
    for seed in SEEDS:
        base = jax.random.PRNGKey(seed)
        assert np.asarray(base).tolist() == [0, seed]
        for step in STEPS:
            key = jax.random.fold_in(base, np.uint32(step))
            k1, k2 = _threefry.row_keys(_i64([seed]), _i64([step]))
            assert [int(k1), int(k2)] == np.asarray(key).tolist()
            bits = _threefry.random_bits(k1, k2, 64)[0].numpy()
            np.testing.assert_array_equal(
                bits, np.asarray(jax.random.bits(key, (64,))))
            u = _threefry.uniform_tiny_to_one(_threefry.random_bits(k1, k2, 64))
            np.testing.assert_array_equal(
                u[0].numpy(), np.asarray(jax.random.uniform(
                    key, (64,), minval=tiny, maxval=1.0)))
            g = _threefry.gumbel(_i64([seed]), _i64([step]), 64)[0].numpy()
            np.testing.assert_allclose(
                g, np.asarray(jax.random.gumbel(key, (64,))), rtol=1e-6,
                atol=1e-6)


@pytest.mark.parametrize("trial", range(4))
def test_seeded_sample_tokens_identical_to_jax(trial):
    """Every row seeded, over a grid of seeds, steps, temperatures, top-k
    (0 = the 64-wide window) and top-p; the shared key / generator does not
    matter for seeded rows."""
    rng = np.random.default_rng(100 + trial)
    b, v = 24, 300
    logits = (rng.normal(size=(b, v)) * 3).astype(np.float32)
    temps = np.resize(np.array([0.0, 0.3, 0.8, 1.0, 1.7], np.float32), b)
    top_p = np.resize(np.array([1.0, 0.95, 0.6], np.float32), b)
    top_k = np.resize(np.array([0, 1, 5, 40, 100], np.int32), b)
    seeds = np.resize(np.array(SEEDS, np.int32), b)
    steps = rng.integers(0, 2**31 - 1, size=(b,)).astype(np.int32)
    steps[:4] = [0, 1, 2, 3]
    rng.shuffle(temps)
    rng.shuffle(top_k)
    want = jsampling.sample_tokens(
        jnp.asarray(logits), jax.random.PRNGKey(trial), jnp.asarray(temps),
        jnp.asarray(top_p), jnp.asarray(top_k), None, jnp.asarray(seeds),
        jnp.asarray(steps))
    got = sampling.sample_tokens(
        torch.from_numpy(logits), torch.Generator().manual_seed(trial),
        torch.from_numpy(temps), torch.from_numpy(top_p),
        torch.from_numpy(top_k), seeds=torch.from_numpy(seeds),
        steps=torch.from_numpy(steps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_unseeded_rows_keep_the_generator():
    """Rows with seed < 0 draw from the caller's generator, unchanged by the
    seeded rows beside them; host lists and tensors give the same draws."""
    logits = torch.from_numpy(
        (np.random.default_rng(9).normal(size=(4, 200)) * 3).astype(np.float32))
    ones, k0 = torch.ones(4), torch.zeros(4, dtype=torch.int32)
    plain = sampling.sample_tokens(logits, torch.Generator().manual_seed(5),
                                   ones, ones, k0)
    mixed = sampling.sample_tokens(logits, torch.Generator().manual_seed(5),
                                   ones, ones, k0, seeds=[-1, 3, -1, 4],
                                   steps=[0, 7, 0, 8])
    assert mixed[0] == plain[0] and mixed[2] == plain[2]
    again = sampling.sample_tokens(logits, torch.Generator().manual_seed(77),
                                   ones, ones, k0,
                                   seeds=torch.tensor([-1, 3, -1, 4]),
                                   steps=torch.tensor([0, 7, 0, 8]))
    assert again[1] == mixed[1] and again[3] == mixed[3]
