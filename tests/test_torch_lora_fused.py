"""The clustered LoRA kernel's contract, on the CPU.

`csrc/lora_bgmv.cu` computes every LoRA projection as one launch of a
thread block cluster kernel: block i of a cluster shrinks slice i of IN,
the cluster sums the partials through distributed shared memory, and
block i expands slice i of OUT, writing either the fp32 delta
(`lora_delta`) or the projection's output with the delta added
(`lora_delta_add`, which `models/llama.py` `_proj` calls). The kernel runs
only on the card, where chip_smoke.py holds both modes against the plain
versions; here:

- the plain version against the Pallas kernel in interpret mode at ranks 8
  and 16, T 1 and 32, and an IN that is not a multiple of the cluster's
  slice, in fp32 (within 1e-5: fp32 sums in another order) and on bf16
  inputs (within 1e-5 of the element and its row's RMS: the products are
  exact in fp32, only the order of the sums differs);
- `_proj` with adapters equals `y + lora_delta_reference(...).to(y.dtype)`
  bit for bit, for bf16 and int8 weights, with adapter-free rows (pool row
  0) beside rows with adapters, and leaves adapter-free rows exactly as a
  LoRA-free projection gives them;
- how the kernel cuts the work (`lora_plan`, the cluster size passed to
  the entry point) is a function of the shapes alone: the same for B = 1
  and B = 8, slices that tile IN and OUT, and constants that equal the
  CUDA source's;
- the wrappers' refusals and the entry point's two modes.
"""

import re

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu.ops.lora import lora_delta_pallas
from llmlb_tpu_torch.kernels import build
from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.ops import lora
from llmlb_tpu_torch.quant import SCALE_SUFFIX, quantize_params

SOURCE = build.CSRC_DIR / "lora_bgmv.cu"


def _pools(rng, n, in_dim, r, out_dim):
    a = (rng.normal(size=(n, in_dim, r)) * in_dim**-0.5).astype(np.float32)
    b = (rng.normal(size=(n, r, out_dim)) * r**-0.5).astype(np.float32)
    a[0] = 0.0  # row 0 is the identity adapter
    b[0] = 0.0
    return a, b


def _bf16(x):
    """Round to bf16 and back to float32: the same values in both
    frameworks."""
    return torch.from_numpy(x).bfloat16().float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 32])
@pytest.mark.parametrize("r", [8, 16])
def test_reference_matches_pallas_off_the_slice_grid(dtype, t, r):
    """IN 200 is no multiple of the slice (16 elements at clusters of 16):
    the last block's slice is short and some are empty."""
    in_dim, out_dim = 200, 96
    plan = lora.lora_plan(t, in_dim, out_dim, getattr(torch, dtype))
    slice_len = plan["in"][0][1]
    assert in_dim % slice_len, (in_dim, slice_len)
    rng = np.random.default_rng(100 * r + t)
    a, b = _pools(rng, 4, in_dim, r, out_dim)
    x = rng.normal(size=(5, t, in_dim)).astype(np.float32)
    idx = np.asarray([0, 1, 3, 1, 2], np.int32)
    if dtype == "bfloat16":
        x, a, b = _bf16(x), _bf16(a), _bf16(b)
    td = getattr(torch, dtype)
    got = lora.lora_delta(*(torch.from_numpy(v).to(td) for v in (x, a, b)),
                          torch.from_numpy(idx))
    assert got.dtype == torch.float32 and got.shape == (5, t, out_dim)
    jd = jax.numpy.bfloat16 if dtype == "bfloat16" else jax.numpy.float32
    with jax.default_matmul_precision("highest"):
        want = np.asarray(lora_delta_pallas(
            *(jax.numpy.asarray(v, jd) for v in (x, a, b)), idx,
            interpret=True))
    g = got.numpy()
    if dtype == "float32":
        np.testing.assert_allclose(g, want, atol=1e-5, rtol=0)
    else:
        rms = np.sqrt((want * want).mean(axis=-1, keepdims=True))
        assert np.all(np.abs(g - want) <= 1e-5 * (np.abs(want) + rms))
    assert np.all(g[0] == 0.0)  # the identity row


def _layer(rng, quantized: bool, dtype=torch.bfloat16):
    """One projection's layer slice: W [64, 48] (int8 with a scale, or
    bf16) and a 3-row adapter pool at rank 8."""
    w = torch.from_numpy(rng.normal(size=(64, 48)).astype(np.float32) * 0.125)
    a, b = _pools(rng, 3, 64, 8, 48)
    lp = {"wq": w.to(dtype)}
    if quantized:
        lp = {k: v[0] for k, v in quantize_params(
            {"wq": lp["wq"][None]}).items()}
        assert lp["wq"].dtype == torch.int8 and "wq" + SCALE_SUFFIX in lp
    lp["wq_lora_a"] = torch.from_numpy(a).to(dtype)
    lp["wq_lora_b"] = torch.from_numpy(b).to(dtype)
    return lp


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("t", [1, 16])
def test_proj_adds_the_rounded_delta_bit_for_bit(quantized, t):
    rng = np.random.default_rng(7 + t + 100 * quantized)
    lp = _layer(rng, quantized)
    x = torch.from_numpy(rng.normal(size=(4, t, 64)).astype(np.float32))
    x = x.bfloat16()
    idx = torch.tensor([0, 2, 1, 0], dtype=torch.int32)
    base = {k: v for k, v in lp.items() if "lora" not in k}
    y = llama._proj(base, "wq", x)
    want = y + lora.lora_delta_reference(x, lp["wq_lora_a"], lp["wq_lora_b"],
                                         idx).to(y.dtype)
    got = llama._proj(lp, "wq", x, idx)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
    # adapter-free rows are the LoRA-free projection's, bit for bit, and
    # the adapters move the others
    assert torch.equal(got[[0, 3]], y[[0, 3]])
    assert not torch.equal(got[1], y[1]) and not torch.equal(got[2], y[2])


def test_delta_add_turns_negative_zero_like_the_unfused_add():
    """y + (+0.0) is +0.0 for y = -0.0: the identity row's add is not
    skipped, so the fused form keeps the unfused form's bits."""
    y = torch.tensor([[[-0.0, 1.5, -2.0, 0.0]]], dtype=torch.bfloat16)
    x = torch.ones((1, 1, 8), dtype=torch.bfloat16)
    a = torch.zeros((1, 8, 4), dtype=torch.bfloat16)
    b = torch.zeros((1, 4, 4), dtype=torch.bfloat16)
    idx = torch.zeros(1, dtype=torch.int32)
    got = lora.lora_delta_add(y.clone(), x, a, b, idx)
    assert torch.equal(got, y + torch.zeros(1, 1, 4, dtype=torch.bfloat16))
    assert got[0, 0, 0] == 0 and not torch.signbit(got[0, 0, 0])


def _header_int(name: str) -> int:
    found = re.findall(rf"constexpr int {name} = (\d+);", SOURCE.read_text())
    assert len(found) == 1, (name, found)
    return int(found[0])


def test_plan_constants_equal_the_source():
    assert lora._TILE_T == _header_int("kTileT")
    assert lora._CLUSTER_MAX == _header_int("kClusterMax")
    assert lora._CLUSTER_MIN == _header_int("kClusterMin")
    assert lora._ROW_BLOCKS == _header_int("kRowBlocks")
    assert lora._MAX_RANK == _header_int("kMaxRank")
    # cluster sizes past 8 are non-portable: the source asks for them
    assert "cudaFuncAttributeNonPortableClusterSizeAllowed" in SOURCE.read_text()


@pytest.mark.parametrize("t,cluster", [(1, 16), (16, 16), (128, 16),
                                       (256, 8), (512, 4), (1024, 4)])
def test_cluster_spreads_a_lone_row_over_128_blocks(t, cluster):
    """16 blocks a cluster up to T = 128, then fewer as the tiles grow, so
    one row's call covers about kRowBlocks blocks; never fewer than 4."""
    assert lora.lora_cluster(t) == cluster
    tiles = -(-t // lora.lora_plan(t, 4096, 4096)["tile"])
    assert cluster * tiles >= min(128, 4 * tiles) or cluster == 16


@pytest.mark.parametrize("t,in_dim,out_dim", [
    (1, 4096, 4096), (1, 4096, 1024), (1, 4096, 14336), (1, 14336, 4096),
    (32, 4096, 4096), (512, 14336, 4096), (7, 200, 96)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plan_slices_tile_in_and_out(t, in_dim, out_dim, dtype):
    plan = lora.lora_plan(t, in_dim, out_dim, dtype)
    v = 16 // torch.empty((), dtype=dtype).element_size()
    assert plan["cluster"] == lora.lora_cluster(t)
    assert plan["tile"] == min(16, 1 << (t - 1).bit_length())
    for key, n, step in (("in", in_dim, v), ("out", out_dim, 4)):
        bounds = plan[key]
        assert len(bounds) == plan["cluster"]
        assert bounds[0][0] == 0 and bounds[-1][1] == n
        for (lo, hi), (lo2, _) in zip(bounds, bounds[1:]):
            assert hi == lo2 and lo % step == 0 and lo <= hi
        assert max(hi - lo for lo, hi in bounds) % step == 0


def test_plan_depends_on_the_shapes_alone(monkeypatch):
    """No batch argument in the plan, and the entry point gets the same
    cluster size and shapes for a row alone as in a batch of 8."""
    assert "b" not in lora.lora_plan.__code__.co_varnames[:4]
    seen = []

    def launch(name, entry, device, *args):
        seen.append((name, entry, [getattr(a, "value", a) for a in args]))

    monkeypatch.setattr(lora, "_route", lambda name, x: True)
    monkeypatch.setattr(lora.build, "launch", launch)
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(v).bfloat16() for v in _pools(rng, 3, 64, 8, 48))
    for bsz in (1, 8):
        for t in (1, 32):
            x = torch.zeros((bsz, t, 64), dtype=torch.bfloat16)
            idx = torch.zeros(bsz, dtype=torch.int32)
            lora.lora_delta(x, a, b, idx)
            lora.lora_delta_add(torch.zeros((bsz, t, 48),
                                            dtype=torch.bfloat16), x, a, b, idx)
    assert all(s[:2] == ("lora_delta", "llmlb_lora_bgmv") for s in seen)
    # args: x, a, b, idx, out, y, B, T, IN, R, OUT, cluster, dtype
    by_t = {}
    for _, _, args in seen:
        out, y = args[4], args[5]
        assert (out is None) != (y is None)  # exactly one mode
        key = (args[7], out is None)
        by_t.setdefault(key, set()).add(tuple(args[7:]))
    for (t, _), calls in by_t.items():
        assert len(calls) == 1, calls  # the same for B = 1 and B = 8
        (t_len, in_dim, r, out_dim, cluster, code), = calls
        assert (in_dim, r, out_dim, code) == (64, 8, 48, 1)
        assert cluster == lora.lora_cluster(t) == 16
    assert len(build.SIGNATURES["llmlb_lora_bgmv"]) == 14


@pytest.mark.parametrize("case,match", [
    ("rank", "rank 65 not supported"),
    ("in", "IN 60 must be a multiple of 8"),
    ("out", "OUT 50 must be a multiple of 4"),
    ("y_dtype", "y is torch.float32"),
    ("y_shape", "shapes"),
])
def test_wrappers_refuse_what_the_kernel_is_not_built_for(monkeypatch, case,
                                                          match):
    monkeypatch.setattr(lora, "_route", lambda name, x: True)
    monkeypatch.setattr(lora.build, "launch", lambda *args: None)
    in_dim, r, out_dim = {"rank": (64, 65, 48), "in": (60, 8, 48),
                          "out": (64, 8, 50)}.get(case, (64, 8, 48))
    bf = torch.bfloat16
    x = torch.zeros((2, 1, in_dim), dtype=bf)
    a = torch.zeros((3, in_dim, r), dtype=bf)
    b = torch.zeros((3, r, out_dim), dtype=bf)
    idx = torch.zeros(2, dtype=torch.int32)
    y = torch.zeros((2, 1, out_dim), dtype=bf)
    if case == "y_dtype":
        y = y.float()
    if case == "y_shape":
        y = torch.zeros((2, 2, out_dim), dtype=bf)
    call = (lambda: lora.lora_delta_add(y, x, a, b, idx)) if case.startswith(
        "y") else (lambda: lora.lora_delta(x, a, b, idx))
    with pytest.raises((ValueError, TypeError), match=match):
        call()
