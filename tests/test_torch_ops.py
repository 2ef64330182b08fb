"""The port's norm, rope and sampling ops against the JAX reference.

Inputs are made from a seed with numpy and handed to both sides. fp32
tolerance 1e-5 absolute for rms_norm and apply_rope (same fp32 formulas,
sin/cos and rsqrt from different libraries). Greedy sampling must be
identical; unseeded stochastic draws use torch generators and are checked
for their contract here (seeded rows draw JAX's threefry stream:
tests/test_torch_sampling.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.ops import norms as jnorms
from llmlb_tpu.ops import rope as jrope
from llmlb_tpu.ops import sampling as jsampling
from llmlb_tpu_torch.ops import norms, rope, sampling


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(3, 5, 64)) * 3).astype(np.float32)
    w = rng.normal(size=(64,)).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("scaled", [False, True])
def test_apply_rope_matches_jax(scaled):
    rng = np.random.default_rng(1)
    d = 128
    x = rng.normal(size=(2, 7, 4, d)).astype(np.float32)
    pos = rng.integers(0, 8192, size=(2, 7)).astype(np.int32)
    jscale = jrope.RopeScaling() if scaled else None
    tscale = rope.RopeScaling() if scaled else None
    jfreq = jrope.rope_frequencies(d, 500000.0, jscale)
    tfreq = rope.rope_frequencies(d, 500000.0, tscale)
    np.testing.assert_allclose(tfreq.numpy(), np.asarray(jfreq), rtol=1e-6)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jfreq)
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tfreq)
    # the frequencies agree, so both sides rotate by the same fp32 angle
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_apply_rope_small_positions_tight():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16, 2, 16)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)[None]
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                            jrope.rope_frequencies(16))
    got = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          rope.rope_frequencies(16))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def _sampling_inputs(b=6, v=300, seed=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(b, v)).astype(np.float32) * 4
    logits[1, 17] = logits[1, 42] = logits[1].max() + 1.0  # tie: first index
    return logits


def test_greedy_sampling_identical_to_jax():
    logits = _sampling_inputs()
    b = logits.shape[0]
    zeros = np.zeros((b,), np.float32)
    ones = np.ones((b,), np.float32)
    topk = np.zeros((b,), np.int32)
    want = jsampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                                   zeros, ones, topk)
    got = sampling.sample_tokens(torch.from_numpy(logits), torch.Generator(),
                                 torch.from_numpy(zeros),
                                 torch.from_numpy(ones), torch.from_numpy(topk))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[1]) == 17


def test_mask_bias_applies_before_argmax_and_prefilter():
    """An allowed set wholly outside the unconstrained top-64 is still what
    greedy and stochastic rows pick."""
    logits = _sampling_inputs(b=4, v=300)
    bias = np.full(logits.shape, -1e30, np.float32)
    order = np.argsort(-logits, axis=1)
    allowed = order[:, 100:103]  # far outside the top-64 window
    for r in range(4):
        bias[r, allowed[r]] = 0.0
    temps = np.array([0.0, 0.0, 1.0, 1.0], np.float32)
    ones = np.ones((4,), np.float32)
    topk = np.zeros((4,), np.int32)
    want = jsampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                                   jnp.zeros(4), ones, topk, jnp.asarray(bias))
    got = sampling.sample_tokens(torch.from_numpy(logits),
                                 torch.Generator().manual_seed(0),
                                 torch.from_numpy(temps),
                                 torch.from_numpy(ones), torch.from_numpy(topk),
                                 torch.from_numpy(bias))
    np.testing.assert_array_equal(got[:2].numpy(), np.asarray(want)[:2])
    for r in range(4):
        assert int(got[r]) in allowed[r]


def test_stochastic_rows_with_top_k_1_or_tiny_top_p_are_argmax():
    logits = _sampling_inputs(b=4)
    argmax = logits.argmax(axis=1)
    temps = torch.full((4,), 1.5)
    top_p = torch.tensor([1.0, 1.0, 1e-6, 1e-6])
    top_k = torch.tensor([1, 1, 0, 0], dtype=torch.int32)
    gen = torch.Generator().manual_seed(123)
    for _ in range(5):
        got = sampling.sample_tokens(torch.from_numpy(logits), gen, temps,
                                     top_p, top_k)
        np.testing.assert_array_equal(got.numpy(), argmax)


def test_same_seed_and_generator_reproduce():
    logits = torch.from_numpy(_sampling_inputs(b=5, v=200))
    temps = torch.ones(5)
    top_p = torch.full((5,), 0.95)
    top_k = torch.zeros(5, dtype=torch.int32)

    def draw(gen_seed, seeds, steps):
        return sampling.sample_tokens(
            logits, torch.Generator().manual_seed(gen_seed), temps, top_p,
            top_k, seeds=seeds, steps=steps)

    a = draw(0, None, None)
    assert torch.equal(a, draw(0, None, None))
    draws = {tuple(draw(s, None, None).tolist()) for s in range(6)}
    assert len(draws) > 1  # the generator actually drives the draw
    # a seeded row reproduces whatever the shared generator does
    seeds, steps = [-1, 7, -1, 7, 9], [0, 4, 0, 5, 4]
    s1 = draw(1, seeds, steps)
    s2 = draw(99, seeds, steps)
    assert s1[1] == s2[1] and s1[3] == s2[3] and s1[4] == s2[4]
