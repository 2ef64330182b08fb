"""The port's ops/moe.py against `llmlb_tpu/ops/moe.py`.

Same numpy inputs from a seed on both sides, fp32 on the CPU. Outputs within
1e-5 absolute (fp32 products summed in another order); the set of dropped
(token, choice) pairs equal exactly, to a per-pair loop over the capacity
rule written out here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.ops import moe as jmoe
from llmlb_tpu_torch.ops import moe
from llmlb_tpu_torch.quant import quantize_channelwise

ATOL = 1e-5


def _inputs(seed, s, m, f, e):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((s, m)).astype(np.float32)
    logits = rng.standard_normal((s, e)).astype(np.float32)
    wg = (rng.standard_normal((e, m, f)) * m**-0.5).astype(np.float32)
    wu = (rng.standard_normal((e, m, f)) * m**-0.5).astype(np.float32)
    wd = (rng.standard_normal((e, f, m)) * f**-0.5).astype(np.float32)
    return x, logits, wg, wu, wd


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _kept_by_loop(idx, e, capacity, valid):
    """The capacity rule, pair by pair: choice 0 of every token before any
    choice 1, then token order; padding takes no slot."""
    s, k = idx.shape
    used = [0] * e
    kept = np.zeros((s, k), bool)
    for j in range(k):
        for t in range(s):
            if valid is not None and not valid[t]:
                continue
            ex = idx[t, j]
            if used[ex] < capacity:
                kept[t, j] = True
            used[ex] += 1
    return kept


@pytest.mark.parametrize("k,capacity,with_valid", [
    (1, 64, False), (2, 64, False),   # room for every pair
    (1, 4, False), (2, 4, False),     # most pairs dropped
    (2, 12, True), (1, 8, True),      # padding kept out of the contest
])
def test_dispatch_combine_matches_jax(k, capacity, with_valid):
    s, m, f, e = 32, 16, 24, 4
    x, logits, wg, wu, wd = _inputs(k * 100 + capacity, s, m, f, e)
    valid = None
    if with_valid:
        valid = np.arange(s) % 8 < 5  # 4 rows of 8 positions, 5 real each
    want = jmoe.moe_dispatch_combine(
        x, logits, wg, wu, wd, num_selected=k, capacity=capacity,
        token_valid=None if valid is None else jnp.asarray(valid))
    tv = None if valid is None else torch.from_numpy(valid)
    args = _t(x, logits, wg, wu, wd)
    got = moe.moe_dispatch_combine(*args, num_selected=k, capacity=capacity,
                                   token_valid=tv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the dropped set, against the rule written out pair by pair
    _, idx = moe.top_k_routing(args[1], k)
    _, in_cap = moe.capacity_slots(idx, e, capacity, tv)
    kept = in_cap.any(-1).numpy()
    loop = _kept_by_loop(idx.numpy(), e, capacity, valid)
    assert (kept == loop).all()
    routed = s * k if valid is None else int(valid.sum()) * k
    assert moe.capacity_drops(args[1], k, capacity, tv) == routed - loop.sum()
    if capacity == 4:
        assert routed - loop.sum() > 0  # the case really drops
    # the card's index form: fp32 products round, so a sum of two may
    # round otherwise than the one-hot product's fused sums
    ind = moe.moe_dispatch_combine(*args, num_selected=k, capacity=capacity,
                                   token_valid=tv, indexed=True)
    np.testing.assert_allclose(ind.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("k,capacity", [(1, 8), (2, 8), (2, 64)])
def test_indexed_dispatch_gives_the_one_hot_bits_in_bf16(k, capacity):
    """In the model dtype of the card every combine product (bf16 x bf16)
    is exact in fp32 and a token sums at most two: the index copies and
    gathers give the one-hot products' bits."""
    s, m, f, e = 32, 16, 24, 4
    x, logits, wg, wu, wd = _inputs(31 + k, s, m, f, e)
    args = [a.to(torch.bfloat16) for a in _t(x, logits, wg, wu, wd)]
    tv = torch.from_numpy(np.arange(s) % 8 < 6)
    plain, ind = (moe.moe_dispatch_combine(*args, num_selected=k,
                                           capacity=capacity, token_valid=tv,
                                           indexed=i) for i in (False, True))
    assert plain.dtype == torch.bfloat16
    assert torch.equal(ind, plain)


def test_padding_takes_no_capacity():
    """A bucket of padding routed like its real tokens would evict them;
    token_valid keeps every real pair when the real tokens alone fit."""
    s, m, f, e, k = 32, 8, 12, 2, 2
    x, logits, wg, wu, wd = _inputs(7, s, m, f, e)
    valid = np.zeros(s, bool)
    valid[:4] = True
    args = _t(x, logits, wg, wu, wd)
    tv = torch.from_numpy(valid)
    assert moe.capacity_drops(args[1], k, 4, tv) == 0
    assert moe.capacity_drops(args[1], k, 4, None) > 0
    want = jmoe.moe_dispatch_combine(x, logits, wg, wu, wd, num_selected=k,
                                     capacity=4,
                                     token_valid=jnp.asarray(valid))
    got = moe.moe_dispatch_combine(*args, num_selected=k, capacity=4,
                                   token_valid=tv)
    np.testing.assert_allclose(got.numpy()[:4], np.asarray(want)[:4],
                               atol=ATOL)


@pytest.mark.parametrize("k", [1, 2])
def test_dense_exact_matches_jax_and_full_capacity(k):
    s, m, f, e = 24, 16, 20, 4
    x, logits, wg, wu, wd = _inputs(11 + k, s, m, f, e)
    want = jmoe.moe_dense_exact(x, logits, wg, wu, wd, num_selected=k)
    args = _t(x, logits, wg, wu, wd)
    got = moe.moe_dense_exact(*args, num_selected=k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # exact = dispatch with a capacity that drops nothing
    full = moe.moe_dispatch_combine(*args, num_selected=k, capacity=s)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=ATOL)


@pytest.mark.parametrize("exact", [True, False])
def test_int8_experts_match_jax(exact):
    """int8 codes with per-output-channel scales [E, out], the scale on the
    fp32 output, as the reference."""
    s, m, f, e, k = 32, 16, 24, 4, 2
    x, logits, wg, wu, wd = _inputs(21, s, m, f, e)
    q = {n: quantize_channelwise(w) for n, w in
         (("gate", wg), ("up", wu), ("down", wd))}
    jscales = {f"w_{n}_scale": jnp.asarray(q[n][1]) for n in q}
    scales = {f"w_{n}_scale": torch.from_numpy(q[n][1]) for n in q}
    jw = [jnp.asarray(q[n][0]) for n in ("gate", "up", "down")]
    tw = [torch.from_numpy(q[n][0]) for n in ("gate", "up", "down")]
    if exact:
        want = jmoe.moe_dense_exact(x, logits, *jw, num_selected=k, **jscales)
        got = moe.moe_dense_exact(*_t(x, logits), *tw, num_selected=k,
                                  **scales)
    else:
        want = jmoe.moe_dispatch_combine(x, logits, *jw, num_selected=k,
                                         capacity=12, **jscales)
        got = moe.moe_dispatch_combine(*_t(x, logits), *tw, num_selected=k,
                                       capacity=12, **scales)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    with pytest.raises(TypeError, match="_scale"):
        moe.moe_dense_exact(*_t(x, logits), *tw, num_selected=k)


def test_ties_break_to_the_lower_index_as_lax_top_k():
    """Constructed ties (the bf16 router ties often): the lower expert index
    comes first, as lax.top_k orders them, and the weights agree."""
    logits = np.array([
        [1.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 2.0, 0.5, 2.0, 2.0, 0.5, 0.0, 0.0],
        [0.25, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25, 0.25],
        [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 3.0, 3.0],
        [-1.0, 5.0, -1.0, -1.0, 5.0, -1.0, 5.0, -1.0],
    ], np.float32)
    for k in (1, 2, 3):
        jw, jidx = jmoe.top_k_routing(jnp.asarray(logits), k)
        w, idx = moe.top_k_routing(torch.from_numpy(logits), k)
        assert idx.tolist() == np.asarray(jidx).tolist()
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    _, idx = moe.top_k_routing(torch.from_numpy(logits), 2)
    assert idx.tolist()[:4] == [[0, 1], [1, 3], [0, 1], [6, 7]]


@pytest.mark.parametrize("tokens,e,k", [(4096, 8, 2), (16, 4, 2), (3, 8, 2),
                                        (512, 8, 2), (100, 4, 1)])
def test_default_capacity_matches_jax(tokens, e, k):
    assert (moe.default_capacity(tokens, e, k)
            == jmoe.default_capacity(tokens, e, k))
