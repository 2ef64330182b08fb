"""The port's `uniform` and `normal` (ops/_threefry.py) against
jax.random on PRNGKey(seed).

The uniforms are held bit for bit (the threefry bits, the mantissa trick
and the float32 scaling are the same integer and float operations). The
normals go through XLA's erf_inv polynomial computed with torch's log1p
and sqrt, whose last bits differ from XLA's on some inputs: a draw is held
within 1e-6 absolute (a float32 ulp is 4.8e-7 at the largest |x| near
5.4), and at least 90% of draws bit for bit (95% were, at every seed and
shape tried).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu_torch.ops import _threefry

NORMAL_ATOL = 1e-6
SHAPES = [(3,), (4, 5, 6), (2, 16, 16, 3), (300, 201)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2 * np.pi),
                                   (-3.5, 0.25)])
def test_uniform_is_jax_bit_for_bit(seed, shape, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                         jnp.float32, lo, hi))
    got = _threefry.uniform(seed, shape, lo, hi, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("draw", ["uniform", "normal"])
def test_draws_default_to_the_card(draw, monkeypatch):
    """No device means the card, as at every entry point of the port: on
    a host without one the draw raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(_threefry, draw)(0, (4,))


@pytest.mark.parametrize("seed", [0, 7, 123456])
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_within_its_stated_tolerance(seed, shape):
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    got = _threefry.normal(seed, shape, device="cpu").numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=NORMAL_ATOL)
    if got.size >= 100:
        assert (got == want).mean() >= 0.9


def test_erf_inv_edges_and_torch():
    """±1 map to ±inf as XLA's; inside, the polynomial is erf's inverse to
    float32 accuracy (torch.special.erfinv as the yardstick)."""
    x = torch.tensor([-1.0, 1.0, 0.0])
    out = _threefry.erf_inv(x)
    assert out[0] == -torch.inf and out[1] == torch.inf and out[2] == 0
    u = torch.linspace(-0.9999, 0.9999, 10001)
    np.testing.assert_allclose(_threefry.erf_inv(u).numpy(),
                               torch.special.erfinv(u).numpy(), atol=1e-4)
