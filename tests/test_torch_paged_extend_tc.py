"""The tensor-core paged extends' contract, on the CPU.

`paged_flash_extend` and `paged_flash_extend_quant` run in bf16 on the
tensor-core block body (llmlb_tpu_torch/csrc/attention_tc.cuh: 64 query rows,
64-key tiles, head_dim 64 or 128) with a staging policy that reads the block
table once per 64-key tile when 64 divides the page size (else once per key
row), and for int8 pools dequantizes each tile into bf16 in shared memory.
The kernels themselves are held against their plain versions on the card by
chip_smoke.py; here:

- the plain versions against the Pallas kernels run in interpret mode IN
  BF16 on the new body's edges: pages of 16 (four to a tile) and of 64 (one
  tile), starts inside a tile and on a page edge, GQA groups of 4 and 7, a
  shuffled block table, a row whose query tiles past the first are all
  padding;
- the int8 extend's plain version equals the bf16 one over the pools
  dequantized with dequantize_kv (exact), and the paged bf16 one equals
  flash_extend's over a dense row holding the same keys (exact): the
  identities the kernels keep on the card;
- both sources include the tensor-core body and route bf16 to it, fp32 to
  the CUDA-core attend_block;
- the wrappers refuse a bf16 head_dim the body is not built for, before a
  launch, and send fp32 at any head_dim to the launch;
- profile_step counts the new kernels' time as attention.

Tolerance: 2^-6 (|pallas| + RMS of its (query, head) row), the limit of
tests/test_torch_tc_shapes.py and chip_smoke.py: both sides round the
probabilities (and the int8 side the dequantized cells) to bf16, against
different running maxima, and both round the output to bf16.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.ops import pallas_attention as pallas
from llmlb_tpu_torch import profile_step
from llmlb_tpu_torch.kernels import build
from llmlb_tpu_torch.ops import cuda_attention
from llmlb_tpu_torch.quant import dequantize_kv, quantize_kv

BF16_REL = 2.0**-6
SOURCES = {"paged_flash_extend": ("paged_extend.cu", "StageTcPaged"),
           "paged_flash_extend_quant": ("paged_extend_quant.cu",
                                        "StageTcInt8")}


def _bf16(rng, shape):
    """Normal values rounded to bf16, as numpy float32 (exactly
    representable in both frameworks)."""
    x = rng.normal(size=shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _pools(rng, b, kv, d, ps, ppn):
    """bf16-valued pools and per-row tables of distinct shuffled pages
    (page 0 left out, as the engine's trash page)."""
    n = b * ppn + 1
    perm = rng.permutation(np.arange(1, n)).reshape(b, ppn).astype(np.int32)
    return _bf16(rng, (n, ps, kv, d)), _bf16(rng, (n, ps, kv, d)), perm


def _assert_within(got: torch.Tensor, want, rows):
    """Every defined element within BF16_REL (|want| + row RMS)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    for b, n in enumerate(rows):
        w, g = want[b, :n], got[b, :n]
        rms = np.sqrt((w * w).mean(axis=-1, keepdims=True))
        bad = np.abs(g - w) > BF16_REL * (np.abs(w) + rms)
        assert not bad.any(), (
            f"row {b}: {int(bad.sum())} elements outside the limit, max |err| "
            f"{np.abs(g - w).max():.3e}")


# (page size, heads, KV heads, starts, chunk_lens) at T = 128, head_dim 64,
# 256 keys a row: pages of 16 are four to a 64-key tile, pages of 64 one.
EDGES = [
    # starts inside a tile; row 0's queries 50.. are padding (its second
    # 64-query block, and in the kernel its tiles of 16 positions from 64)
    (16, 8, 2, [37, 100], [50, 128]),
    # a start on a page (and tile) edge; row 1 has 10 queries: every
    # kernel query tile past the first is padding
    (64, 8, 2, [64, 0], [128, 10]),
    # G = 7 (Qwen2.5-0.5B's 14 heads over 2): 9 positions a 63-row tile
    (16, 14, 2, [64, 45], [7, 128]),
    (64, 14, 2, [5, 128], [128, 70]),
]


@pytest.mark.parametrize("kernel", ["bf16", "int8"])
@pytest.mark.parametrize("ps,h,kv,starts,chunks", EDGES)
def test_paged_extend_references_match_pallas_bf16_on_tile_edges(
        kernel, ps, h, kv, starts, chunks):
    rng = np.random.default_rng(ps * 100 + h)
    b, t, d, ppn = 2, 128, 64, 256 // ps
    kp, vp, tables = _pools(rng, b, kv, d, ps, ppn)
    q = _bf16(rng, (b, t, h, d))
    start, chunk = np.array(starts, np.int32), np.array(chunks, np.int32)
    qj = jnp.asarray(q, jnp.bfloat16)
    qt = torch.from_numpy(q).bfloat16()
    tab, st, ch = (torch.from_numpy(x) for x in (tables, start, chunk))
    if kernel == "bf16":
        want = pallas.paged_flash_extend(
            qj, jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
            tables, start, chunk, block_q=64, interpret=True)
        got = cuda_attention.paged_flash_extend_reference(
            qt, torch.from_numpy(kp).bfloat16(),
            torch.from_numpy(vp).bfloat16(), tab, st, ch)
    else:
        (kq, ks), (vq, vs) = quantize_kv(kp), quantize_kv(vp)
        want = pallas.paged_flash_extend_quant(
            qj, kq, ks, vq, vs, tables, start, chunk, block_q=64,
            interpret=True)
        got = cuda_attention.paged_flash_extend_quant_reference(
            qt, *(torch.from_numpy(x) for x in (kq, ks, vq, vs)), tab, st, ch)
    assert got.dtype == torch.bfloat16
    _assert_within(got, want, chunks)


@pytest.mark.parametrize("ps", [16, 64, 128])
def test_int8_extend_is_the_bf16_extend_over_dequantized_pools(ps):
    """Bit for bit: the int8 extend reads what dequantize_kv(codes, scales,
    bf16) gives, the tiles the kernel's StageTcInt8 writes."""
    rng = np.random.default_rng(ps)
    b, t, h, kv, d, ppn = 2, 64, 8, 2, 64, 512 // ps
    kp, vp, tables = _pools(rng, b, kv, d, ps, ppn)
    (kq, ks), (vq, vs) = (quantize_kv(torch.from_numpy(x)) for x in (kp, vp))
    q = torch.from_numpy(_bf16(rng, (b, t, h, d))).bfloat16()
    tab = torch.from_numpy(tables)
    start = torch.tensor([100, 448], dtype=torch.int32)
    chunk = torch.tensor([64, 20], dtype=torch.int32)
    int8 = cuda_attention.paged_flash_extend_quant_reference(
        q, kq, ks, vq, vs, tab, start, chunk)
    deq = cuda_attention.paged_flash_extend_reference(
        q, dequantize_kv(kq, ks, torch.bfloat16),
        dequantize_kv(vq, vs, torch.bfloat16), tab, start, chunk)
    assert torch.equal(int8, deq)


@pytest.mark.parametrize("ps", [16, 64])
def test_paged_extend_is_flash_extend_over_the_same_keys(ps):
    """Bit for bit: the paged extend over shuffled pages equals the dense
    extend over a row that holds the same keys in the same order."""
    rng = np.random.default_rng(ps + 1)
    b, t, h, kv, d, s = 2, 64, 14, 2, 64, 256
    rows_k, rows_v = _bf16(rng, (b, s, kv, d)), _bf16(rng, (b, s, kv, d))
    perm = rng.permutation(np.arange(1, b * s // ps + 1))
    tables = perm.reshape(b, s // ps).astype(np.int32)
    pk = np.zeros((b * s // ps + 1, ps, kv, d), np.float32)
    pv = np.zeros_like(pk)
    pk[perm] = rows_k.reshape(-1, ps, kv, d)
    pv[perm] = rows_v.reshape(-1, ps, kv, d)
    q = torch.from_numpy(_bf16(rng, (b, t, h, d))).bfloat16()
    start = torch.tensor([37, 190], dtype=torch.int32)
    chunk = torch.tensor([64, 9], dtype=torch.int32)
    paged = cuda_attention.paged_flash_extend_reference(
        q, torch.from_numpy(pk).bfloat16(), torch.from_numpy(pv).bfloat16(),
        torch.from_numpy(tables), start, chunk)
    dense = cuda_attention.flash_extend_reference(
        q, torch.from_numpy(rows_k).bfloat16(),
        torch.from_numpy(rows_v).bfloat16(), start, chunk)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("kernel", sorted(SOURCES))
def test_paged_extend_sources_route_bf16_to_the_tensor_core_body(kernel):
    source, stage = SOURCES[kernel]
    assert source in build.SOURCES and "attention_tc.cuh" in build.HEADERS
    text = (build.CSRC_DIR / source).read_text()
    assert '#include "attention_tc.cuh"' in text
    assert f"tc::attend_block_tc<D, tc::{stage}>(" in text
    header = (build.CSRC_DIR / "attention_tc.cuh").read_text()
    assert f"struct {stage} {{" in header
    # the C entry point: fp32 to the CUDA-core body, bf16 at head_dim 64
    # and 128 to the tensor-core one, anything else refused
    entry = text[text.index('extern "C" int'):]
    assert "if (dtype == 0)\n    return llmlb::run_fp32(" in entry
    assert "if (dtype == 1 && d == 64)\n    return llmlb::run_bf16<64>(" in entry
    assert ("if (dtype == 1 && d == 128)\n    return llmlb::run_bf16<128>("
            in entry)
    assert entry.rstrip().endswith(
        "return (int)cudaErrorInvalidValue;\n}")
    assert "attend_block<" in text  # the fp32 route stays


def _call(kernel, d, dtype):
    """The wrapper on CPU tensors of head_dim d, driven past its device
    check; the pool is int8 codes with scales for the quant kernel."""
    b, t, h, kv, ps = 1, 4, 4, 2, 16
    q = torch.zeros((b, t, h, d), dtype=dtype)
    tables = torch.tensor([[1]], dtype=torch.int32)
    start = torch.zeros(b, dtype=torch.int32)
    chunk = torch.full((b,), t, dtype=torch.int32)
    if kernel == "paged_flash_extend":
        pool = torch.zeros((2, ps, kv, d), dtype=dtype)
        return cuda_attention.paged_flash_extend(q, pool, pool, tables, start,
                                                 chunk)
    codes = torch.zeros((2, ps, kv, d), dtype=torch.int8)
    scales = torch.ones((2, ps, kv))
    return cuda_attention.paged_flash_extend_quant(q, codes, scales, codes,
                                                   scales, tables, start,
                                                   chunk)


@pytest.mark.parametrize("kernel", sorted(SOURCES))
@pytest.mark.parametrize("d", [16, 32, 80])
def test_wrappers_refuse_bf16_head_dims_off_the_tensor_core_body(
        monkeypatch, kernel, d):
    monkeypatch.setattr(cuda_attention, "_route", lambda name, q: True)
    launched = []
    monkeypatch.setattr(build, "launch", lambda *a: launched.append(a))
    with pytest.raises(ValueError, match=f"head_dim {d} not supported"):
        _call(kernel, d, torch.bfloat16)
    assert launched == []


@pytest.mark.parametrize("kernel", sorted(SOURCES))
@pytest.mark.parametrize("d,dtype,code", [(64, torch.bfloat16, 1),
                                          (128, torch.bfloat16, 1),
                                          (16, torch.float32, 0)])
def test_wrappers_launch_bf16_tc_head_dims_and_fp32(monkeypatch, kernel, d,
                                                    dtype, code):
    """bf16 at 64 and 128 and fp32 at debug-tiny's 16 reach the launch with
    their dtype code (the C entry point's route) and one count."""
    monkeypatch.setattr(cuda_attention, "_route", lambda name, q: True)
    launched = []
    monkeypatch.setattr(build, "launch", lambda *a: launched.append(a))
    _call(kernel, d, dtype)
    (name, entry, _dev, *args), = launched
    assert name == kernel and entry == f"llmlb_{kernel}"
    assert args[-1] == code
    assert isinstance(args[-2], ctypes.c_float)


@pytest.mark.parametrize("name", [
    "void llmlb::(anonymous namespace)::paged_extend_tc_kernel<128>"
    "(__nv_bfloat16 const*, ...)",
    "void llmlb::(anonymous namespace)::paged_extend_quant_tc_kernel<128>"
    "(__nv_bfloat16 const*, signed char const*, ...)",
    "void llmlb::(anonymous namespace)::paged_extend_tc_kernel<64>(...)",
])
def test_profile_step_counts_the_tc_extends_as_attention(name):
    assert profile_step._category(name) == "attention"
