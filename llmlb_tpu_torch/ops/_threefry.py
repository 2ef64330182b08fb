"""JAX's counter-based threefry2x32 key stream, reproduced in torch.

A seeded sampling row in the JAX package draws
`jax.random.categorical(fold_in(PRNGKey(seed), step), scaled)`, with JAX's
default `jax_threefry_partitionable=True`. The functions here compute the
same bits, the same uniforms and the same Gumbel noise, vectorised over rows,
so a seeded request samples the same token ids in both packages:

- `threefry2x32`: the Threefry-2x32 block cipher, 20 rounds in 5 groups of
  4 (JAX's `jax/_src/prng.py` `_threefry2x32_lowering`);
- `row_keys`: `fold_in(PRNGKey(seed), step)` per row: the key of an int32
  seed s >= 0 is (0, s), and folding in d hashes the count pair (0, d);
- `random_bits`: `jax.random.bits(key, (n,))`, partitionable form: counter
  i hashes to the pair (x1, x2) and the word is x1 ^ x2;
- `gumbel`: `jax.random.gumbel(key, (n,), mode="low")`: the top 23 bits of
  each word become a float in [1, 2), minus 1, scaled into [tiny, 1), then
  -log(-log(u)).

uint32 arithmetic runs in int64 tensors masked to 32 bits (shifts stay
below 2^63), so it runs on any device and needs no host loop. It is plain
tensor code, as the JAX package's is XLA and not a Pallas kernel.
"""

from __future__ import annotations

import torch

from llmlb_tpu_torch.device import resolve_device

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_FLOAT_ONE_BITS = 0x3F800000  # 1.0f
_MANTISSA_SHIFT = 32 - 23  # keep the top 23 bits as the mantissa


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 of the count pairs (x1, x2) under the key (k1, k2).
    All int64 tensors holding uint32 values; shapes broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def row_keys(seeds: torch.Tensor,
             steps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fold_in(PRNGKey(max(seed, 0)), step) for each row: ([B], [B]) int64.
    Seeds are int32 values (the engine masks them to 31 bits); steps wrap to
    uint32 as JAX's astype(uint32) does."""
    seeds = torch.clamp(seeds.to(torch.int64), min=0) & _MASK
    steps = steps.to(device=seeds.device, dtype=torch.int64) & _MASK
    zero = torch.zeros_like(seeds)
    return threefry2x32(zero, seeds, zero, steps)


def random_bits(k1: torch.Tensor, k2: torch.Tensor, n: int) -> torch.Tensor:
    """jax.random.bits(key, (n,)) for each row's key: [B, n] int64 uint32s."""
    counts = torch.arange(n, device=k1.device, dtype=torch.int64)[None, :]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(counts),
                          counts)
    return b1 ^ b2


def uniform_tiny_to_one(bits: torch.Tensor) -> torch.Tensor:
    """JAX's `_uniform(minval=tiny, maxval=1)` in float32 from 32-bit words."""
    mant = ((bits >> _MANTISSA_SHIFT) | _FLOAT_ONE_BITS).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    # filled on the device (no host-to-device copy, so a CUDA graph can
    # capture it)
    tiny = torch.full((), torch.finfo(torch.float32).tiny,
                      dtype=torch.float32, device=bits.device)
    span = torch.full((), 1.0, dtype=torch.float32,
                      device=bits.device) - tiny  # in float32, as JAX
    return torch.maximum(tiny, floats * span + tiny)


def gumbel(seeds: torch.Tensor, steps: torch.Tensor, n: int) -> torch.Tensor:
    """The Gumbel noise jax.random.categorical adds for each seeded row:
    [B, n] float32."""
    k1, k2 = row_keys(seeds, steps)
    u = uniform_tiny_to_one(random_bits(k1, k2, n))
    return -torch.log(-torch.log(u))


# XLA's float32 erf_inv (Giles' single-precision approximation), the
# polynomial `jax.lax.erf_inv` lowers to: w = -log1p(-x^2); below 5 the
# first set of coefficients in w - 2.5, else the second in sqrt(w) - 3.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def _key(seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """PRNGKey(seed) of an int32 seed: (0, seed as uint32), on `device`
    (the card unless "cpu")."""
    k2 = torch.tensor([int(seed) & _MASK], dtype=torch.int64,
                      device=resolve_device(device))
    return torch.zeros_like(k2), k2


def uniform(seed: int, shape: tuple[int, ...], lo: float = 0.0,
            hi: float = 1.0, device=None) -> torch.Tensor:
    """jax.random.uniform(PRNGKey(seed), shape, float32, lo, hi), bit for
    bit: the flat counter over prod(shape), the top 23 bits of each word as
    a float in [1, 2) minus 1, then scaled into [lo, hi) as XLA on the CPU
    computes it, with one fused multiply-add: the product of two float32
    is exact in float64, so it is formed there and the sum rounded once."""
    n = 1
    for s in shape:
        n *= int(s)
    k1, k2 = _key(seed, device)
    bits = random_bits(k1, k2, n)[0]
    mant = ((bits >> _MANTISSA_SHIFT) | _FLOAT_ONE_BITS).to(torch.int32)
    floats = mant.view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32, device=bits.device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=bits.device)
    fused = (floats.double() * (hi_t - lo_t).double() + lo_t.double()).float()
    out = torch.maximum(lo_t, fused)
    return out.reshape(tuple(int(s) for s in shape))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv polynomial (±inf at ±1)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    edge = x.abs() == 1.0
    return torch.where(edge, x * torch.inf, p * x)


def normal(seed: int, shape: tuple[int, ...], device=None) -> torch.Tensor:
    """jax.random.normal(PRNGKey(seed), shape, float32): sqrt(2) *
    erf_inv(u) over the uniforms in [nextafter(-1, 0), 1). The uniforms
    are JAX's bit for bit; erf_inv is XLA's polynomial computed with
    torch's log1p and sqrt, whose last bits may differ from XLA's, so a
    draw agrees with JAX's within a few float32 ulps
    (tests/test_torch_multimodal_rng.py pins the bound)."""
    lo = float(torch.nextafter(torch.tensor(-1.0), torch.tensor(0.0)))
    u = uniform(seed, shape, lo, 1.0, device=device)
    return erf_inv(u) * torch.tensor(2.0 ** 0.5, dtype=torch.float32)
