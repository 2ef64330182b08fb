"""The split-K decode kernels' contract, on the CPU.

`flash_decode`, `paged_flash_decode` and `paged_flash_decode_quant` run on
the split-K decode body
(llmlb_tpu_torch/csrc/attention_decode.cuh): each row's keys are cut into
splits of kSplitKeys absolute positions, and a combine kernel merges them
when the sweep holds more than one split. The kernels themselves are held
against their plain versions on the card by chip_smoke.py (split edges,
a lost partial, bitwise invariance across batch and window); here:

- the host-side split count (`decode_splits`): ceil(sweep / kSplitKeys),
  from the sweep alone, with the constant the header compiles;
- the header is part of the build (its hash names the library);
- the plain versions against the Pallas kernels in interpret mode at kv_lens
  on the split edges (kSplitKeys - 1, kSplitKeys, kSplitKeys + 1, 0), with a
  window (or a `pages` bound) that ends inside a split and a row past the
  sweep, which is left out of the comparison as the kernels' contract
  leaves it undefined;
- the C entry points' argument lists (`build.SIGNATURES`): both paged
  decodes take the split scratch and the split count;
- the wrappers' refusals of what the kernels are not built for: GQA groups
  past 8, head_dim not a multiple of 16, and caches of 2^32 (position, KV
  head) cells or more (the body caches cell indices as 32-bit ints).

Tolerances: fp32 within 1e-5 (online against two-pass softmax, as
tests/test_torch_dense.py); bf16 within 2^-6 (|pallas| + RMS of its (row,
head) vector), the limit of tests/test_torch_tc_shapes.py and chip_smoke.py:
both sides round the probabilities (and the int8 side the dequantized cells)
to bf16, against different running maxima.
"""

import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llmlb_tpu import quant as jquant
from llmlb_tpu.ops import pallas_attention as pallas
from llmlb_tpu_torch.kernels import build
from llmlb_tpu_torch.ops import cuda_attention

HEADER = "attention_decode.cuh"
SPLIT = cuda_attention.DECODE_SPLIT_KEYS
BF16_REL = 2.0**-6
FP32_ATOL = 1e-5
# kv_lens on the split edges, an empty row, and one past the second edge
EDGE_LENS = [SPLIT - 1, SPLIT, SPLIT + 1, 0, 2 * SPLIT + 3]
# the paged bf16 decode's: the split edges, an empty row, a few keys into
# the fourth split, one key, two whole splits
PAGED_EDGE_LENS = [SPLIT - 1, SPLIT, SPLIT + 1, 0, 3 * SPLIT + 7, 1, 2 * SPLIT]


def _header_split_keys() -> int:
    text = (build.CSRC_DIR / HEADER).read_text()
    found = re.findall(r"constexpr int kSplitKeys = (\d+);", text)
    assert len(found) == 1, found
    return int(found[0])


@pytest.mark.parametrize("sweep", [1, 128, 255, 256, 511, 512, 513, 1024,
                                   1500, 4095, 4096, 4097])
def test_decode_splits_is_the_ceiling_of_the_sweep(sweep):
    assert cuda_attention.decode_splits(sweep) == max(1, -(-sweep // SPLIT))
    # one split at the smallest window bucket: one launch, no combine
    if sweep <= 256:
        assert cuda_attention.decode_splits(sweep) == 1


def test_decode_splits_depends_on_the_sweep_alone():
    """No batch, row or length argument: the split boundaries of a row
    cannot move with the rest of the batch."""
    params = list(inspect.signature(cuda_attention.decode_splits).parameters)
    assert params == ["sweep"]


def test_split_keys_constant_equals_the_header():
    split = _header_split_keys()
    assert split == SPLIT
    assert split % 64 == 0 and split >= 256  # whole key tiles; one split at 256


def test_decode_header_is_built_by_every_decode_kernel():
    assert HEADER in build.HEADERS
    for source in ("flash_decode.cu", "paged_decode.cu",
                   "paged_decode_quant.cu"):
        assert source in build.SOURCES
        text = (build.CSRC_DIR / source).read_text()
        assert f'#include "{HEADER}"' in text, source


def test_paged_decode_is_on_the_split_body_alone():
    """paged_decode.cu runs decode_split, not the first design's
    attend_block, and reaches attention_common.cuh only through the
    split-K header."""
    text = (build.CSRC_DIR / "paged_decode.cu").read_text()
    assert "dec::decode_split<" in text and "dec::launch_split<" in text
    assert "attend_block" not in text
    assert '#include "attention_common.cuh"' not in text


_P, _I, _F = build._P, build._I, build._F
# q, k, v (or codes and scales), tables, kv_lens, out, part; B, H, K, D, PS,
# PPN, pages, splits; scale; dtype; stream
PAGED_DECODE_SIGNATURES = {
    "llmlb_paged_flash_decode": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
    "llmlb_paged_flash_decode_quant": [_P] * 9 + [_I] * 8 + [_F, _I, _P],
}


@pytest.mark.parametrize("entry", sorted(PAGED_DECODE_SIGNATURES))
def test_paged_decode_entry_points_take_the_split_scratch(entry):
    assert build.SIGNATURES[entry] == PAGED_DECODE_SIGNATURES[entry]
    source = {"llmlb_paged_flash_decode": "paged_decode.cu",
              "llmlb_paged_flash_decode_quant": "paged_decode_quant.cu"}[entry]
    text = (build.CSRC_DIR / source).read_text()
    decl = text[text.index(f'extern "C" int {entry}('):]
    decl = decl[:decl.index(")")]
    assert "void* part" in decl and "int splits" in decl
    # one C parameter per ctypes argument, the stream included
    assert decl.count(",") + 1 == len(PAGED_DECODE_SIGNATURES[entry])


@pytest.mark.parametrize("splits", [1, 3])
def test_split_scratch_holds_every_partial(splits):
    """fp32 [B, K, splits, G] x (acc[D], m, l); none for one split."""
    q = torch.zeros((3, 8, 16))
    part = cuda_attention._split_scratch(q, 2, splits)
    if splits == 1:
        assert part is None
    else:
        assert part.dtype == torch.float32
        assert part.numel() == 3 * 2 * splits * 4 * (16 + 2)


def _assert_close(got: torch.Tensor, want, rows, dtype):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    for b in rows:
        w, g = want[b], got[b]
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=FP32_ATOL, err_msg=f"row {b}")
            continue
        rms = np.sqrt((w * w).mean(axis=-1, keepdims=True))
        bad = np.abs(g - w) > BF16_REL * (np.abs(w) + rms)
        assert not bad.any(), (
            f"row {b}: {int(bad.sum())} elements outside the limit, max |err| "
            f"{np.abs(g - w).max():.3e}")


def _normal(rng, shape, dtype):
    """Normal values, rounded to bf16 for a bf16 case (exact in both
    frameworks), as numpy float32."""
    x = rng.normal(size=shape).astype(np.float32)
    if dtype == "bfloat16":
        x = torch.from_numpy(x).bfloat16().float().numpy()
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, SPLIT + SPLIT // 2])
def test_flash_decode_reference_matches_pallas_on_split_edges(dtype, window):
    """Dense cache of 2 * kSplitKeys + 128 cells (whole 128-cell blocks of
    the Pallas kernel); with the window the sweep ends half way into the
    second split and the last row lies past it."""
    rng = np.random.default_rng(5 if window is None else 6)
    b, s, h, kv, d = len(EDGE_LENS), 2 * SPLIT + 128, 8, 2, 16
    q = _normal(rng, (b, h, d), dtype)
    kc, vc = _normal(rng, (b, s, kv, d), dtype), _normal(rng, (b, s, kv, d), dtype)
    lens = np.array(EDGE_LENS, np.int32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = pallas.flash_decode(*(jnp.asarray(x, jd) for x in (q, kc, vc)), lens,
                               block_k=128, interpret=True, window=window)
    td = getattr(torch, dtype)
    got = cuda_attention.flash_decode(
        *(torch.from_numpy(x).to(td) for x in (q, kc, vc)),
        torch.from_numpy(lens), window=window)
    assert got.dtype == td
    sweep = cuda_attention.dense_decode_sweep(s, window)
    rows = [i for i, n in enumerate(EDGE_LENS) if n <= sweep]
    assert len(rows) == len(EDGE_LENS) - (window is not None)
    _assert_close(got, want, rows, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", [None, (SPLIT + SPLIT // 2) // 64])
def test_paged_flash_decode_quant_reference_matches_pallas_on_split_edges(
        dtype, pages):
    """int8 pools of 64-token pages, 17 pages a row (2 * kSplitKeys + 64
    keys); the `pages` bound ends half way into the second split."""
    rng = np.random.default_rng(7 if pages is None else 8)
    b, h, kv, d, ps = len(EDGE_LENS), 8, 2, 16, 64
    ppn = (2 * SPLIT + 64) // ps
    n_pages = b * ppn + 1
    kq, ks = jquant.quantize_kv(rng.normal(size=(n_pages, ps, kv, d)).astype(np.float32))
    vq, vs = jquant.quantize_kv(rng.normal(size=(n_pages, ps, kv, d)).astype(np.float32))
    pools = [np.asarray(x) for x in (kq, ks, vq, vs)]
    tables = (rng.permutation(np.arange(1, n_pages))[: b * ppn]
              .reshape(b, ppn).astype(np.int32))
    lens = np.array(EDGE_LENS, np.int32)
    q = _normal(rng, (b, h, d), dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = pallas.paged_flash_decode_quant(jnp.asarray(q, jd), *pools, tables,
                                           lens, pages=pages, interpret=True)
    got = cuda_attention.paged_flash_decode_quant(
        torch.from_numpy(q).to(getattr(torch, dtype)),
        *(torch.from_numpy(x) for x in pools), torch.from_numpy(tables),
        torch.from_numpy(lens), pages=pages)
    sweep = (ppn if pages is None else pages) * ps
    rows = [i for i, n in enumerate(EDGE_LENS) if n <= sweep]
    assert len(rows) == len(EDGE_LENS) - (pages is not None)
    _assert_close(got, want, rows, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pages", [None, (SPLIT + SPLIT // 2) // 64])
def test_paged_flash_decode_reference_matches_pallas_on_split_edges(dtype,
                                                                    pages):
    """bf16/fp32 pools of 64-token pages, 13 pages a row (3 * kSplitKeys +
    64 keys, past the 3 * kSplitKeys + 7 row); the `pages` bound ends half
    way into the second split, past which two rows lie."""
    rng = np.random.default_rng(9 if pages is None else 10)
    b, h, kv, d, ps = len(PAGED_EDGE_LENS), 8, 2, 16, 64
    ppn = (3 * SPLIT + 64) // ps
    n_pages = b * ppn + 1
    kp = _normal(rng, (n_pages, ps, kv, d), dtype)
    vp = _normal(rng, (n_pages, ps, kv, d), dtype)
    tables = (rng.permutation(np.arange(1, n_pages))[: b * ppn]
              .reshape(b, ppn).astype(np.int32))
    lens = np.array(PAGED_EDGE_LENS, np.int32)
    q = _normal(rng, (b, h, d), dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = pallas.paged_flash_decode(*(jnp.asarray(x, jd) for x in (q, kp, vp)),
                                     tables, lens, pages=pages, interpret=True)
    td = getattr(torch, dtype)
    got = cuda_attention.paged_flash_decode(
        *(torch.from_numpy(x).to(td) for x in (q, kp, vp)),
        torch.from_numpy(tables), torch.from_numpy(lens), pages=pages)
    assert got.dtype == td
    sweep = (ppn if pages is None else pages) * ps
    rows = [i for i, n in enumerate(PAGED_EDGE_LENS) if n <= sweep]
    assert len(rows) == len(PAGED_EDGE_LENS) - (2 if pages is not None else 0)
    _assert_close(got, want, rows, dtype)


@pytest.mark.parametrize("pages", [None, 5])
def test_paged_decode_split_scratch_follows_the_sweep(monkeypatch, pages):
    """The paged bf16 decode allocates [B, K, splits, G] x (D + 2) fp32
    partials for splits = ceil(pages * PS / kSplitKeys), none for one split,
    and passes both to the entry point (captured, not launched)."""
    seen = {}

    def launch(name, entry, device, *args):
        seen.update(name=name, entry=entry, args=args)

    monkeypatch.setattr(cuda_attention, "_route", lambda name, q: True)
    monkeypatch.setattr(cuda_attention.build, "launch", launch)
    b, h, kv, d, ps, ppn = 3, 8, 2, 16, 64, 12
    q = torch.zeros((b, h, d))
    pool = torch.zeros((b * ppn + 1, ps, kv, d))
    tables = torch.arange(1, b * ppn + 1, dtype=torch.int32).reshape(b, ppn)
    lens = torch.full((b,), 100, dtype=torch.int32)
    cuda_attention.paged_flash_decode(q, pool, pool, tables, lens, pages=pages)
    assert (seen["name"], seen["entry"]) == ("paged_flash_decode",
                                             "llmlb_paged_flash_decode")
    splits = cuda_attention.decode_splits((ppn if pages is None else pages)
                                          * ps)
    assert splits == (3 if pages is None else 2)
    part, n_splits = seen["args"][6], seen["args"][14]
    assert n_splits == splits
    assert part.value is not None  # more than one split: scratch passed
    want = cuda_attention._split_scratch(q, kv, splits)
    assert want.numel() == b * kv * splits * (h // kv) * (d + 2)


@pytest.mark.parametrize("kernel,h,kv,d,match", [
    ("flash_decode", 8, 2, 8, "head_dim 8 not supported"),
    ("flash_decode", 32, 2, 16, "16 query heads per KV head"),
    ("paged_flash_decode", 32, 2, 16, "16 query heads per KV head"),
    ("paged_flash_decode", 8, 2, 8, "head_dim 8 not supported"),
    ("paged_flash_decode_quant", 32, 2, 16, "16 query heads per KV head"),
])
def test_wrappers_refuse_what_the_kernels_are_not_built_for(
        monkeypatch, kernel, h, kv, d, match):
    """The split-K kernels are built for 4- and 8-row groups and for
    head_dim multiples of 16; anything else raises before a launch (the
    wrapper is driven past its device check with CPU tensors)."""
    monkeypatch.setattr(cuda_attention, "_route", lambda name, q: True)
    q = torch.zeros((2, h, d))
    lens = torch.ones(2, dtype=torch.int32)
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    if kernel == "flash_decode":
        cache = torch.zeros((2, 64, kv, d))
        call = lambda: cuda_attention.flash_decode(q, cache, cache, lens)  # noqa: E731
    elif kernel == "paged_flash_decode":
        pool = torch.zeros((3, 16, kv, d))
        call = lambda: cuda_attention.paged_flash_decode(  # noqa: E731
            q, pool, pool, tables, lens)
    else:
        codes = torch.zeros((3, 16, kv, d), dtype=torch.int8)
        scales = torch.ones((3, 16, kv))
        call = lambda: cuda_attention.paged_flash_decode_quant(  # noqa: E731
            q, codes, scales, codes, scales, tables, lens)
    with pytest.raises(ValueError, match=match):
        call()


@pytest.mark.parametrize("kernel", ["paged_flash_decode",
                                    "paged_flash_decode_quant"])
def test_paged_decodes_refuse_a_pool_past_32_bit_cells(monkeypatch, kernel):
    """P * PS * K >= 2^32 cells cannot be cached as unsigned cell indices.
    The pool is an expanded view (no memory behind its 2^32 cells), which
    the shape check reads before anything touches the data."""
    monkeypatch.setattr(cuda_attention, "_route", lambda name, q: True)
    kv, d, ps = 8, 16, 128
    n_pages = 2**32 // (ps * kv)  # exactly 2^32 cells
    q = torch.zeros((2, 32, d))
    lens = torch.ones(2, dtype=torch.int32)
    tables = torch.tensor([[1], [2]], dtype=torch.int32)
    if kernel == "paged_flash_decode":
        pool = torch.zeros((1, ps, kv, d)).expand(n_pages, ps, kv, d)
        call = lambda: cuda_attention.paged_flash_decode(  # noqa: E731
            q, pool, pool, tables, lens)
    else:
        codes = torch.zeros((1, ps, kv, d), dtype=torch.int8).expand(
            n_pages, ps, kv, d)
        scales = torch.ones((1, ps, kv)).expand(n_pages, ps, kv)
        call = lambda: cuda_attention.paged_flash_decode_quant(  # noqa: E731
            q, codes, scales, codes, scales, tables, lens)
    with pytest.raises(ValueError, match="2\\^32"):
        call()
    cuda_attention._check_decode(kernel, 32, kv, d, 2**32 - 1)  # the last fit
