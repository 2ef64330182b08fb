"""Plain versions of the port's attention kernels against the Pallas kernels.

Each `*_reference` in llmlb_tpu_torch/ops/cuda_attention.py is the function
its CUDA kernel computes; here it is held against the JAX package's Pallas
kernel run in interpret mode, as tests/ops/test_pallas_attention.py runs it,
over ragged lengths, page boundaries, the `pages` bound and GQA groups
G in {1, 2, 4}. Only defined rows are compared (prefill rows < prompt_lens,
extend rows < chunk_lens, decode rows within the swept pages). fp32 inputs;
tolerance 1e-5 absolute (online vs two-pass softmax, same fp32 math).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu.ops import attention as jattention
from llmlb_tpu.ops import pallas_attention as pallas
from llmlb_tpu_torch.ops import attention, cuda_attention

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _pool(rng, b, kv, d, ps, ppn):
    """Random pools plus per-row tables of DISTINCT scattered pages (page 0
    reserved as the trash page)."""
    num_pages = b * ppn * 2 + 1
    k = rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32)
    v = rng.normal(size=(num_pages, ps, kv, d)).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))[: b * ppn]
    return k, v, perm.reshape(b, ppn).astype(np.int32)


@pytest.mark.parametrize(
    "b,t,h,kv,d,block",
    [
        (2, 64, 8, 8, 32, 32),   # G=1, several q/k blocks
        # T a multiple of the block: interpret mode pads a partial
        # block with NaN, which its PV product carries into valid rows
        (3, 32, 4, 2, 16, 16),   # G=2
        (2, 48, 8, 2, 16, 16),   # G=4
        (1, 128, 8, 2, 64, 128),  # G=4, single block
    ],
)
def test_flash_prefill_reference_matches_pallas(b, t, h, kv, d, block):
    rng = np.random.default_rng(b * 1000 + t)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    lens[0] = t  # one full-length row
    want = pallas.flash_prefill(q, k, v, lens, block_q=block, block_k=block,
                                interpret=True)
    got = cuda_attention.flash_prefill_reference(_t(q), _t(k), _t(v), _t(lens))
    for bi in range(b):
        np.testing.assert_allclose(got[bi, :lens[bi]].numpy(),
                                   np.asarray(want)[bi, :lens[bi]], atol=ATOL)


@pytest.mark.parametrize(
    "b,h,kv,d,ps,ppn,pages",
    [
        (2, 8, 8, 32, 16, 4, None),  # G=1
        (3, 8, 4, 16, 32, 3, None),  # G=2
        (2, 8, 2, 16, 16, 4, 2),     # G=4, pages bound
        (3, 4, 1, 32, 8, 5, 3),      # MQA, pages bound, small pages
    ],
)
def test_paged_flash_decode_reference_matches_pallas(b, h, kv, d, ps, ppn,
                                                     pages):
    rng = np.random.default_rng(ps * 100 + ppn)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v, tables = _pool(rng, b, kv, d, ps, ppn)
    sweep = ppn if pages is None else pages
    # lengths inside the swept pages, with page-boundary values
    lens = rng.integers(1, sweep * ps + 1, size=(b,)).astype(np.int32)
    lens[0] = ps  # exactly one full page
    lens[-1] = sweep * ps  # every swept cell
    want = pallas.paged_flash_decode(q, k, v, tables, lens, pages=pages,
                                     interpret=True)
    got = cuda_attention.paged_flash_decode_reference(
        _t(q), _t(k), _t(v), _t(tables), _t(lens), pages=pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_paged_flash_decode_reference_rows_past_the_bound():
    """Rows longer than the swept pages are garbage in both, but the same
    garbage: attention over the swept pages only."""
    rng = np.random.default_rng(7)
    b, h, kv, d, ps, ppn = 2, 4, 2, 16, 8, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v, tables = _pool(rng, b, kv, d, ps, ppn)
    lens = np.array([3 * ps + 2, ppn * ps], np.int32)
    want = pallas.paged_flash_decode(q, k, v, tables, lens, pages=2,
                                     interpret=True)
    got = cuda_attention.paged_flash_decode_reference(
        _t(q), _t(k), _t(v), _t(tables), _t(lens), pages=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize(
    "b,t,h,kv,d,ps,ppn,block_q",
    [
        (2, 16, 8, 8, 32, 16, 4, 16),  # G=1
        (2, 12, 8, 4, 16, 8, 5, 4),    # G=2, chunk crosses pages
        (2, 8, 8, 2, 16, 32, 2, 4),    # G=4
        (1, 12, 4, 1, 32, 16, 3, 8),   # MQA, ragged T
    ],
)
def test_paged_flash_extend_reference_matches_pallas(b, t, h, kv, d, ps, ppn,
                                                     block_q):
    rng = np.random.default_rng(t * 100 + ps)
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    k, v, tables = _pool(rng, b, kv, d, ps, ppn)
    start = rng.integers(0, ps * ppn - t, size=(b,)).astype(np.int32)
    chunk_lens = rng.integers(1, t + 1, size=(b,)).astype(np.int32)
    want = pallas.paged_flash_extend(q, k, v, tables, start, chunk_lens,
                                     block_q=block_q, interpret=True)
    got = cuda_attention.paged_flash_extend_reference(
        _t(q), _t(k), _t(v), _t(tables), _t(start), _t(chunk_lens))
    for bi in range(b):
        n = chunk_lens[bi]
        np.testing.assert_allclose(got[bi, :n].numpy(),
                                   np.asarray(want)[bi, :n], atol=ATOL)


def test_bf16_reference_rounds_probabilities_like_pallas():
    """In bf16 the probabilities are rounded to bf16 before the PV product
    on both sides; tolerance one bf16 ulp of O(1) outputs."""
    rng = np.random.default_rng(3)
    b, h, kv, d, ps, ppn = 2, 8, 2, 32, 16, 3
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    k, v, tables = _pool(rng, b, kv, d, ps, ppn)
    lens = np.array([20, 48], np.int32)
    want = pallas.paged_flash_decode(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), tables, lens, interpret=True)
    got = cuda_attention.paged_flash_decode_reference(
        _t(q).bfloat16(), _t(k).bfloat16(), _t(v).bfloat16(), _t(tables),
        _t(lens))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2)


def test_public_functions_take_the_plain_path_on_cpu():
    """ops/attention.py on CPU tensors matches the reference's
    ops/attention.py (its einsum path on the CPU) on defined rows, and
    launches no kernel."""
    cuda_attention.reset_launch_counts()
    rng = np.random.default_rng(5)
    b, t, h, kv, d, ps, ppn = 2, 12, 8, 2, 16, 8, 4
    q = rng.normal(size=(b, t, h, d)).astype(np.float32)
    kf = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    vf = rng.normal(size=(b, t, kv, d)).astype(np.float32)
    lens = np.array([7, 12], np.int32)
    got = attention.gqa_attention_prefill(_t(q), _t(kf), _t(vf), _t(lens))
    want = jattention.gqa_attention_prefill(q, kf, vf, lens)
    for bi in range(b):
        np.testing.assert_allclose(got[bi, :lens[bi]].numpy(),
                                   np.asarray(want)[bi, :lens[bi]], atol=ATOL)

    k, v, tables = _pool(rng, b, kv, d, ps, ppn)
    kv_lens = np.array([9, 30], np.int32)
    for window in (None, 16):  # 16 bounds the sweep to row 0's two pages
        got = attention.paged_attention_decode(_t(q[:, :1]), _t(k), _t(v),
                                               _t(tables), _t(kv_lens),
                                               window=window)
        want = jattention.paged_attention_decode(q[:, :1], k, v, tables,
                                                 kv_lens, window=window)
        rows = 1 if window else b  # row 1 is past the window: garbage
        np.testing.assert_allclose(got[:rows].numpy(),
                                   np.asarray(want)[:rows], atol=ATOL)

    start = np.array([3, 17], np.int32)
    chunk = np.array([12, 5], np.int32)
    pos = start[:, None] + np.arange(t, dtype=np.int32)[None, :]
    got = attention.paged_attention_extend(_t(q), _t(k), _t(v), _t(tables),
                                           _t(pos), _t(chunk))
    want = jattention.paged_attention_extend(q, k, v, tables, pos, chunk)
    for bi in range(b):
        np.testing.assert_allclose(got[bi, :chunk[bi]].numpy(),
                                   np.asarray(want)[bi, :chunk[bi]], atol=ATOL)
    assert all(n == 0 for n in cuda_attention.LAUNCHES.values())


def test_dense_decode_is_plain_on_cpu_and_refused_elsewhere():
    """gqa_attention_decode matches the reference's einsum path on CPU
    tensors (rows within the window); CUDA tensors go to the flash_decode
    kernel, and tensors on any other device are refused rather than run
    through the plain version."""
    rng = np.random.default_rng(11)
    b, s, h, kv, d = 3, 24, 8, 2, 16
    q = rng.normal(size=(b, 1, h, d)).astype(np.float32)
    kc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    vc = rng.normal(size=(b, s, kv, d)).astype(np.float32)
    kv_lens = np.array([1, 9, 24], np.int32)
    for window in (None, 16):  # 16 leaves row 2 past the window: garbage
        got = attention.gqa_attention_decode(_t(q), _t(kc), _t(vc),
                                             _t(kv_lens), window=window)
        want = jattention.gqa_attention_decode(q, kc, vc, kv_lens,
                                               window=window)
        rows = 2 if window else b
        np.testing.assert_allclose(got[:rows].numpy(),
                                   np.asarray(want)[:rows], atol=ATOL)
    meta = torch.empty((b, 1, h, d), device="meta")
    cache = torch.empty((b, s, kv, d), device="meta")
    with pytest.raises(ValueError, match="flash_decode: unsupported device"):
        attention.gqa_attention_decode(meta, cache, cache,
                                       torch.empty(b, device="meta"))


def test_wrappers_refuse_other_devices():
    """A wrapper runs its kernel on CUDA tensors, its plain version on CPU
    tensors, and refuses anything else rather than guessing."""
    q = torch.empty((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_attention.flash_prefill(q, q[:, :, :1], q[:, :, :1],
                                     torch.empty(1, device="meta"))
