"""Hand-written Hopper attention kernels: counterpart of
`llmlb_tpu/ops/pallas_attention.py`.

Seven kernels, each a CUDA C++ source under `llmlb_tpu_torch/csrc/` built by
`kernels/build.py`:

- `flash_prefill`: causal ragged GQA prefill over a fresh bucketed prompt
  (`csrc/flash_prefill.cu`).
- `paged_flash_decode`: one-token GQA decode through the block tables
  (`csrc/paged_decode.cu`).
- `paged_flash_extend`: a chunk of contiguous queries attending causally over
  a row's pages (`csrc/paged_extend.cu`).
- `paged_flash_decode_quant`, `paged_flash_extend_quant`: the same two over
  int8 pools with one float32 scale per (token, head) vector
  (`csrc/paged_decode_quant.cu`, `csrc/paged_extend_quant.cu`). Each cell is
  dequantized in fp32 and rounded to q.dtype before the dot, as the Pallas
  kernels do.
- `flash_decode`, `flash_extend`: the decode and the chunk over the dense
  slot cache [B, S, K, D], whose row b is slot b's cells in order
  (`csrc/flash_decode.cu`, `csrc/flash_extend.cu`).

The three decodes (`flash_decode`, `paged_flash_decode`,
`paged_flash_decode_quant`) run on the split-K decode body
(`csrc/attention_decode.cuh`): each row's keys are cut into splits of
DECODE_SPLIT_KEYS absolute positions, one block per (split, KV head, row),
and a combine kernel merges the splits when the sweep holds more than one
(`decode_splits`). The wrapper allocates the fp32 scratch of the partials.
The split boundaries depend on no other row and not on the sweep, so a row
gives the same bits alone or in a batch, under any window that covers it,
and the same bits through the pages as through the dense cache. The body
caches a split's cell indices as 32-bit unsigned ints, so the wrappers
refuse a cache of 2^32 (position, KV head) cells or more.

In bf16, `flash_prefill`, `flash_extend`, `paged_flash_extend` and
`paged_flash_extend_quant` (bf16 q over int8 pools) run on the tensor cores
(`csrc/attention_tc.cuh`), built for head_dim 64 and 128 only: any other
bf16 head_dim raises (`check_tc_head_dim`) instead of reaching another
kernel. The paged extends read the block table once per 64-key tile when 64
divides the page size, else once per key row; the int8 one dequantizes each
tile into bf16 in shared memory with `dequantize_kv`'s rounding, so it gives
the bf16 extend's bits over the dequantized pools, and the paged bf16 extend
gives `flash_extend`'s bits over a dense row holding the same keys. In
float32 all four run on the CUDA cores at any head_dim the others take.

Each wrapper takes the JAX kernel's signature. On CUDA tensors it checks
device, dtype, shape, contiguity and alignment, allocates the output with
`torch.empty`, launches on the current stream, raises if the launch is
refused, and adds one to `LAUNCHES[name]` (kernels/build.py). On CPU tensors
it returns its plain PyTorch version (`*_reference`, beside it here), which
the tests hold against the Pallas kernels in interpret mode and
`chip_smoke.py` holds against the kernel on the card. Any other device
raises.

Defined outputs, as in the Pallas kernels: prefill rows t < prompt_lens[b];
decode rows with kv_lens[b] <= the swept cells (pages * PS, or the dense
decode's sweep); extend rows i < chunk_lens[b].
"""

from __future__ import annotations

import ctypes

import torch

from llmlb_tpu_torch.kernels import build
# the launch counts of every kernel of the port, public here too
from llmlb_tpu_torch.kernels.build import (  # noqa: F401
    LAUNCHES,
    reset_launch_counts,
)
from llmlb_tpu_torch.quant import dequantize_kv

_NEG_INF = -1e30  # finite: keeps fully-masked rows NaN-free

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# query heads per KV head the decode kernels take: the split-K body's
# largest build (4 and 8 rows)
_DECODE_MAX_GROUP = 8
# (position, KV head) cells a decode may address: the body caches their
# indices as 32-bit unsigned ints
_DECODE_MAX_CELLS = 2**32
DECODE_SPLIT_KEYS = 256  # kSplitKeys in csrc/attention_decode.cuh
_DENSE_DECODE_BLOCK = 128  # the Pallas flash_decode's default block_k
# head_dims of the bf16 tensor-core body's instantiations (attention_tc.cuh)
TC_HEAD_DIMS = (64, 128)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def masked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Masked GQA attention with the kernels' numerics: fp32 scores scaled
    after the dot, fp32 softmax with finite -1e30 masking, probabilities
    rounded to v.dtype before the fp32 PV product, and 0 for a row with no
    visible key. GQA folds into the einsum; the KV heads are not repeated.

    q [B, T, H, D]; k, v [B, S, K, D]; mask [B, T, S] bool -> [B, T, H, D]."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    qg = q.float().reshape(b, t, kh, h // kh, d)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * d**-0.5
    m = mask[:, None, None]  # [B, 1, 1, T, S]
    scores = scores.masked_fill(~m, _NEG_INF)
    probs = torch.softmax(scores, dim=-1) * m.any(dim=-1, keepdim=True)
    out = torch.einsum("bkgts,bskd->btkgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(b, t, h, d).to(q.dtype)


def gather_kv_pages(pages, tables: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Materialize contiguous per-row KV from the page pool: [P, PS, K, D]
    gathered by block tables [B, N] -> [B, N*PS, K, D]. The plain versions
    only: the kernels read the pool through the table and build no copy.

    An int8 pool is a {"q": int8 [P, PS, K, D], "s": float32 [P, PS, K]}
    pair: both members gather through the same table, and the cells are
    dequantized in fp32 and rounded to `dtype`, the attention's compute
    dtype, as the Pallas quant kernels do before their dots."""
    b, n = tables.shape
    idx = tables.long()
    if isinstance(pages, dict):
        _, ps, kh, d = pages["q"].shape
        return dequantize_kv(pages["q"][idx].reshape(b, n * ps, kh, d),
                             pages["s"][idx].reshape(b, n * ps, kh), dtype)
    _, ps, kh, d = pages.shape
    return pages[idx].reshape(b, n * ps, kh, d)


def pool_shape(pages) -> torch.Size:
    """Shape of a pool's values (the codes of an int8 pair)."""
    return (pages["q"] if isinstance(pages, dict) else pages).shape


def flash_prefill_reference(q, k, v, prompt_lens):
    """Plain version of flash_prefill: key j visible to query t iff
    j <= t and j < prompt_lens[b]."""
    t = q.shape[1]
    pos = torch.arange(t, device=q.device)
    mask = ((pos[None, :, None] >= pos[None, None, :])
            & (pos[None, None, :] < prompt_lens.to(q.device)[:, None, None]))
    return masked_attention(q, k, v, mask)


def paged_flash_decode_reference(q, k_pages, v_pages, block_tables, kv_lens,
                                 *, pages: int | None = None):
    """Plain version of paged_flash_decode: the first `pages` logical pages
    are swept and keys j < kv_lens[b] are visible. q [B, H, D]. The pools
    may be int8 {"q", "s"} pairs (see gather_kv_pages)."""
    ps = pool_shape(k_pages)[1]
    ppn = block_tables.shape[1]
    sweep = ppn if pages is None else max(1, min(pages, ppn))
    tables = block_tables[:, :sweep]
    k_cache = gather_kv_pages(k_pages, tables, q.dtype)
    v_cache = gather_kv_pages(v_pages, tables, q.dtype)
    cols = torch.arange(sweep * ps, device=q.device)
    mask = cols[None, None, :] < kv_lens.to(q.device)[:, None, None]
    return masked_attention(q[:, None], k_cache, v_cache, mask)[:, 0]


def paged_flash_extend_reference(q, k_pages, v_pages, block_tables,
                                 start_pos, chunk_lens):
    """Plain version of paged_flash_extend: query i of row b at position
    start_pos[b] + i sees keys j <= its position. Every row is computed;
    rows i >= chunk_lens[b] are undefined in the kernel's contract. The
    pools may be int8 {"q", "s"} pairs (see gather_kv_pages)."""
    del chunk_lens  # only decides which rows are defined
    t = q.shape[1]
    k_cache = gather_kv_pages(k_pages, block_tables, q.dtype)
    v_cache = gather_kv_pages(v_pages, block_tables, q.dtype)
    q_pos = (start_pos.to(q.device)[:, None]
             + torch.arange(t, device=q.device)[None, :])
    cols = torch.arange(k_cache.shape[1], device=q.device)
    mask = cols[None, None, :] <= q_pos[:, :, None]
    return masked_attention(q, k_cache, v_cache, mask)


def paged_flash_decode_quant_reference(q, k_pages, k_scales, v_pages,
                                       v_scales, block_tables, kv_lens, *,
                                       pages: int | None = None):
    """Plain version of paged_flash_decode_quant: paged_flash_decode over
    int8 pools [P, PS, K, D] with float32 scales [P, PS, K]."""
    return paged_flash_decode_reference(
        q, {"q": k_pages, "s": k_scales}, {"q": v_pages, "s": v_scales},
        block_tables, kv_lens, pages=pages)


def paged_flash_extend_quant_reference(q, k_pages, k_scales, v_pages,
                                       v_scales, block_tables, start_pos,
                                       chunk_lens):
    """Plain version of paged_flash_extend_quant: paged_flash_extend over
    int8 pools [P, PS, K, D] with float32 scales [P, PS, K]."""
    return paged_flash_extend_reference(
        q, {"q": k_pages, "s": k_scales}, {"q": v_pages, "s": v_scales},
        block_tables, start_pos, chunk_lens)


def dense_decode_sweep(s: int, window: int | None) -> int:
    """Cells of the dense cache the decode sweeps: the Pallas flash_decode's
    max(block, min(window, S)) with its 128-cell block (S without a
    window)."""
    blk = min(_DENSE_DECODE_BLOCK, s)
    return s if window is None else max(blk, min(int(window), s))


def flash_decode_reference(q, k_cache, v_cache, kv_lens, *,
                           window: int | None = None):
    """Plain version of flash_decode: the first dense_decode_sweep cells of
    each row are swept and keys j < kv_lens[b] are visible. q [B, H, D],
    caches [B, S, K, D]."""
    sweep = dense_decode_sweep(k_cache.shape[1], window)
    cols = torch.arange(sweep, device=q.device)
    mask = cols[None, None, :] < kv_lens.to(q.device)[:, None, None]
    return masked_attention(q[:, None], k_cache[:, :sweep], v_cache[:, :sweep],
                            mask)[:, 0]


def flash_extend_reference(q, k_cache, v_cache, start_pos, chunk_lens):
    """Plain version of flash_extend: query i of row b at position
    start_pos[b] + i sees cells j <= its position of the row. Every row is
    computed; rows i >= chunk_lens[b] are undefined in the kernel's
    contract."""
    del chunk_lens  # only decides which rows are defined
    t = q.shape[1]
    q_pos = (start_pos.to(q.device)[:, None]
             + torch.arange(t, device=q.device)[None, :])
    cols = torch.arange(k_cache.shape[1], device=q.device)
    mask = cols[None, None, :] <= q_pos[:, :, None]
    return masked_attention(q, k_cache, v_cache, mask)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check(name: str, main: torch.Tensor, floats: dict, ints: dict,
           codes: dict | None = None, scales: dict | None = None) -> int:
    """Validate what the kernel takes; returns the dtype code. `floats` share
    q's dtype; `codes` are int8 pools and `scales` their float32 scales."""
    dev = main.device
    codes, scales = codes or {}, scales or {}
    if main.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {main.dtype} not supported "
                        "(float32 or bfloat16)")
    d = main.shape[-1]
    if d > 128 or d % 8 or 256 % d:
        raise ValueError(f"{name}: head_dim {d} not supported "
                         "(a divisor of 256, multiple of 8, at most 128)")
    if codes and d % 16:
        raise ValueError(f"{name}: head_dim {d} not supported for int8 pools "
                         "(a multiple of 16: one 16-byte load per 16 codes)")
    for arg, t in {**floats, **ints, **codes, **scales}.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, q on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    for arg, t in floats.items():
        if t.dtype != main.dtype:
            raise TypeError(f"{name}: {arg} is {t.dtype}, q is {main.dtype}")
    for arg, t in {**floats, **codes}.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must be 16-byte aligned")
    for arg, t in codes.items():
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {arg} must be int8, got {t.dtype}")
    for arg, t in scales.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {arg} must be float32, got {t.dtype}")
    for arg, t in ints.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {arg} must be int32, got {t.dtype}")
    return _DTYPE_CODES[main.dtype]


def check_tc_head_dim(name: str, d: int) -> None:
    """Raise unless the bf16 tensor-core kernels are built for head_dim `d`
    (TC_HEAD_DIMS: the bf16 presets' 64 and 128)."""
    if d not in TC_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not supported in bfloat16 "
                         f"(the tensor-core kernel is built for {TC_HEAD_DIMS})")


def _route(name: str, q: torch.Tensor) -> bool:
    """True for the CUDA launch, False for the plain version on the CPU."""
    if q.device.type == "cuda":
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {q.device}")


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def decode_splits(sweep: int) -> int:
    """Key splits of a split-K decode over `sweep` keys: ceil(sweep /
    DECODE_SPLIT_KEYS), at least 1. It depends on the sweep alone (not on
    the batch), as the kernel's split boundaries do."""
    return max(1, -(-int(sweep) // DECODE_SPLIT_KEYS))


def _check_decode(name: str, h: int, kh: int, d: int, cells: int) -> None:
    """Raise unless the split-K decode body is built for this GQA group and
    head_dim, and can address every (position, KV head) cell of the cache
    (`cells` of them) with a 32-bit index."""
    if h // kh > _DECODE_MAX_GROUP:
        raise ValueError(f"{name}: {h // kh} query heads per KV head; the "
                         f"kernel takes at most {_DECODE_MAX_GROUP}")
    if d % 16:
        raise ValueError(f"{name}: head_dim {d} not supported (a multiple "
                         "of 16: four columns a thread in P V)")
    if cells >= _DECODE_MAX_CELLS:
        raise ValueError(f"{name}: a cache of {cells} (position, KV head) "
                         "cells; the kernel indexes at most 2^32 - 1")


def _split_scratch(q: torch.Tensor, kv_heads: int,
                   splits: int) -> torch.Tensor | None:
    """fp32 scratch of the split-K partials, [B, K, splits, G] x (D + 2)
    floats (acc, m, l), or None for one split (the kernel writes out)."""
    if splits == 1:
        return None
    b, h, d = q.shape
    return torch.empty(b * kv_heads * splits * (h // kv_heads) * (d + 2),
                       dtype=torch.float32, device=q.device)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  prompt_lens: torch.Tensor) -> torch.Tensor:
    """Causal ragged GQA prefill attention. q [B, T, H, D], k/v [B, T, K, D],
    prompt_lens [B] int32 -> [B, T, H, D] in q.dtype."""
    if not _route("flash_prefill", q):
        return flash_prefill_reference(q, k, v, prompt_lens)
    b, t, h, d = q.shape
    kh = k.shape[2]
    if k.shape != (b, t, kh, d) or v.shape != k.shape or h % kh:
        raise ValueError(f"flash_prefill: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if prompt_lens.shape != (b,):
        raise ValueError("flash_prefill: prompt_lens must be [B]")
    code = _check("flash_prefill", q, {"q": q, "k": k, "v": v},
                  {"prompt_lens": prompt_lens})
    if q.dtype == torch.bfloat16:
        check_tc_head_dim("flash_prefill", d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build.launch("flash_prefill", "llmlb_flash_prefill", q.device,
                 _ptr(q), _ptr(k), _ptr(v), _ptr(prompt_lens), _ptr(out),
                 b, t, h, kh, d, ctypes.c_float(d**-0.5), code)
    return out


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       kv_lens: torch.Tensor, *,
                       pages: int | None = None) -> torch.Tensor:
    """Ragged paged one-token GQA decode. q [B, H, D], pools [P, PS, K, D],
    block_tables [B, PPN] int32, kv_lens [B] int32 -> [B, H, D]. `pages`
    (static) bounds the sweep to the first `pages` logical pages. On the
    card: the split-K kernel over decode_splits(pages * PS) splits, and the
    combine kernel when there is more than one; LAUNCHES counts the call
    once."""
    if not _route("paged_flash_decode", q):
        return paged_flash_decode_reference(q, k_pages, v_pages, block_tables,
                                            kv_lens, pages=pages)
    b, h, d = q.shape
    _, ps, kh, _ = k_pages.shape
    ppn = block_tables.shape[1]
    if (k_pages.shape[-1] != d or v_pages.shape != k_pages.shape or h % kh
            or block_tables.shape != (b, ppn) or kv_lens.shape != (b,)):
        raise ValueError("paged_flash_decode: shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}, kv_lens "
                         f"{tuple(kv_lens.shape)}")
    _check_decode("paged_flash_decode", h, kh, d, k_pages.shape[0] * ps * kh)
    sweep = ppn if pages is None else max(1, min(int(pages), ppn))
    code = _check("paged_flash_decode", q,
                  {"q": q, "k_pages": k_pages, "v_pages": v_pages},
                  {"block_tables": block_tables, "kv_lens": kv_lens})
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    splits = decode_splits(sweep * ps)
    part = _split_scratch(q, kh, splits)
    build.launch("paged_flash_decode", "llmlb_paged_flash_decode", q.device,
                 _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(block_tables),
                 _ptr(kv_lens), _ptr(out), _ptr(part), b, h, kh, d, ps, ppn,
                 sweep, splits, ctypes.c_float(d**-0.5), code)
    return out


def paged_flash_extend(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       start_pos: torch.Tensor,
                       chunk_lens: torch.Tensor) -> torch.Tensor:
    """Paged chunked-prefill attention. q [B, T, H, D], pools [P, PS, K, D],
    block_tables [B, PPN], start_pos / chunk_lens [B] int32 -> [B, T, H, D]."""
    if not _route("paged_flash_extend", q):
        return paged_flash_extend_reference(q, k_pages, v_pages, block_tables,
                                            start_pos, chunk_lens)
    b, t, h, d = q.shape
    _, ps, kh, _ = k_pages.shape
    ppn = block_tables.shape[1]
    if (k_pages.shape[-1] != d or v_pages.shape != k_pages.shape or h % kh
            or block_tables.shape != (b, ppn) or start_pos.shape != (b,)
            or chunk_lens.shape != (b,)):
        raise ValueError("paged_flash_extend: shapes q "
                         f"{tuple(q.shape)}, pools {tuple(k_pages.shape)}, "
                         f"tables {tuple(block_tables.shape)}")
    code = _check("paged_flash_extend", q,
                  {"q": q, "k_pages": k_pages, "v_pages": v_pages},
                  {"block_tables": block_tables, "start_pos": start_pos,
                   "chunk_lens": chunk_lens})
    if q.dtype == torch.bfloat16:
        check_tc_head_dim("paged_flash_extend", d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build.launch("paged_flash_extend", "llmlb_paged_flash_extend", q.device,
                 _ptr(q), _ptr(k_pages), _ptr(v_pages), _ptr(block_tables),
                 _ptr(start_pos), _ptr(chunk_lens), _ptr(out), b, t, h, kh, d,
                 ps, ppn, ctypes.c_float(d**-0.5), code)
    return out


def _check_quant_pools(name: str, k_pages, k_scales, v_pages, v_scales) -> None:
    if (v_pages.shape != k_pages.shape or k_scales.shape != k_pages.shape[:-1]
            or v_scales.shape != k_scales.shape):
        raise ValueError(f"{name}: pools {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} with scales "
                         f"{tuple(k_scales.shape)} / {tuple(v_scales.shape)}; "
                         "expected [P, PS, K, D] codes and [P, PS, K] scales")


def paged_flash_decode_quant(q: torch.Tensor, k_pages: torch.Tensor,
                             k_scales: torch.Tensor, v_pages: torch.Tensor,
                             v_scales: torch.Tensor, block_tables: torch.Tensor,
                             kv_lens: torch.Tensor, *,
                             pages: int | None = None) -> torch.Tensor:
    """paged_flash_decode over int8 pools: q [B, H, D], codes [P, PS, K, D]
    int8, scales [P, PS, K] float32, block_tables [B, PPN] int32, kv_lens
    [B] int32 -> [B, H, D] in q.dtype. On the card: the split-K kernel over
    decode_splits(pages * PS) splits, and the combine kernel when there is
    more than one; LAUNCHES counts the call once."""
    name = "paged_flash_decode_quant"
    if not _route(name, q):
        return paged_flash_decode_quant_reference(
            q, k_pages, k_scales, v_pages, v_scales, block_tables, kv_lens,
            pages=pages)
    b, h, d = q.shape
    _, ps, kh, _ = k_pages.shape
    ppn = block_tables.shape[1]
    _check_quant_pools(name, k_pages, k_scales, v_pages, v_scales)
    if (k_pages.shape[-1] != d or h % kh or block_tables.shape != (b, ppn)
            or kv_lens.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(block_tables.shape)}, kv_lens "
                         f"{tuple(kv_lens.shape)}")
    _check_decode(name, h, kh, d, k_pages.shape[0] * ps * kh)
    sweep = ppn if pages is None else max(1, min(int(pages), ppn))
    code = _check(name, q, {"q": q},
                  {"block_tables": block_tables, "kv_lens": kv_lens},
                  codes={"k_pages": k_pages, "v_pages": v_pages},
                  scales={"k_scales": k_scales, "v_scales": v_scales})
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    splits = decode_splits(sweep * ps)
    part = _split_scratch(q, kh, splits)
    build.launch(name, "llmlb_paged_flash_decode_quant", q.device,
                 _ptr(q), _ptr(k_pages), _ptr(k_scales), _ptr(v_pages),
                 _ptr(v_scales), _ptr(block_tables), _ptr(kv_lens), _ptr(out),
                 _ptr(part), b, h, kh, d, ps, ppn, sweep, splits,
                 ctypes.c_float(d**-0.5), code)
    return out


def paged_flash_extend_quant(q: torch.Tensor, k_pages: torch.Tensor,
                             k_scales: torch.Tensor, v_pages: torch.Tensor,
                             v_scales: torch.Tensor, block_tables: torch.Tensor,
                             start_pos: torch.Tensor,
                             chunk_lens: torch.Tensor) -> torch.Tensor:
    """paged_flash_extend over int8 pools: q [B, T, H, D], codes [P, PS, K,
    D] int8, scales [P, PS, K] float32, block_tables [B, PPN], start_pos /
    chunk_lens [B] int32 -> [B, T, H, D] in q.dtype."""
    name = "paged_flash_extend_quant"
    if not _route(name, q):
        return paged_flash_extend_quant_reference(
            q, k_pages, k_scales, v_pages, v_scales, block_tables, start_pos,
            chunk_lens)
    b, t, h, d = q.shape
    _, ps, kh, _ = k_pages.shape
    ppn = block_tables.shape[1]
    _check_quant_pools(name, k_pages, k_scales, v_pages, v_scales)
    if (k_pages.shape[-1] != d or h % kh or block_tables.shape != (b, ppn)
            or start_pos.shape != (b,) or chunk_lens.shape != (b,)):
        raise ValueError(f"{name}: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pages.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    code = _check(name, q, {"q": q},
                  {"block_tables": block_tables, "start_pos": start_pos,
                   "chunk_lens": chunk_lens},
                  codes={"k_pages": k_pages, "v_pages": v_pages},
                  scales={"k_scales": k_scales, "v_scales": v_scales})
    if q.dtype == torch.bfloat16:
        check_tc_head_dim(name, d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build.launch(name, "llmlb_paged_flash_extend_quant", q.device,
                 _ptr(q), _ptr(k_pages), _ptr(k_scales), _ptr(v_pages),
                 _ptr(v_scales), _ptr(block_tables), _ptr(start_pos),
                 _ptr(chunk_lens), _ptr(out), b, t, h, kh, d, ps, ppn,
                 ctypes.c_float(d**-0.5), code)
    return out


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 kv_lens: torch.Tensor, *,
                 window: int | None = None) -> torch.Tensor:
    """Ragged one-token GQA decode over the dense slot cache. q [B, H, D],
    caches [B, S, K, D], kv_lens [B] int32 -> [B, H, D]. `window` (static)
    bounds the sweep (dense_decode_sweep); the input is not sliced. On the
    card: the split-K kernel over decode_splits(sweep) splits, and the
    combine kernel when there is more than one; LAUNCHES counts the call
    once."""
    if not _route("flash_decode", q):
        return flash_decode_reference(q, k_cache, v_cache, kv_lens,
                                      window=window)
    b, h, d = q.shape
    _, s, kh, _ = k_cache.shape
    if (k_cache.shape != (b, s, kh, d) or v_cache.shape != k_cache.shape
            or h % kh or kv_lens.shape != (b,)):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"kv_lens {tuple(kv_lens.shape)}")
    _check_decode("flash_decode", h, kh, d, b * s * kh)
    code = _check("flash_decode", q,
                  {"q": q, "k_cache": k_cache, "v_cache": v_cache},
                  {"kv_lens": kv_lens})
    out = torch.empty_like(q)
    if q.numel() == 0 or s == 0:
        return out
    sweep = dense_decode_sweep(s, window)
    splits = decode_splits(sweep)
    part = _split_scratch(q, kh, splits)
    build.launch("flash_decode", "llmlb_flash_decode", q.device,
                 _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(kv_lens),
                 _ptr(out), _ptr(part), b, h, kh, d, s, sweep, splits,
                 ctypes.c_float(d**-0.5), code)
    return out


def flash_extend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                 start_pos: torch.Tensor,
                 chunk_lens: torch.Tensor) -> torch.Tensor:
    """Chunked-prefill attention over the dense slot cache. q [B, T, H, D],
    caches [B, S, K, D] (the chunk's rows), start_pos / chunk_lens [B] int32
    -> [B, T, H, D]."""
    if not _route("flash_extend", q):
        return flash_extend_reference(q, k_cache, v_cache, start_pos,
                                      chunk_lens)
    b, t, h, d = q.shape
    _, s, kh, _ = k_cache.shape
    if (k_cache.shape != (b, s, kh, d) or v_cache.shape != k_cache.shape
            or h % kh or start_pos.shape != (b,) or chunk_lens.shape != (b,)):
        raise ValueError(f"flash_extend: shapes q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}")
    code = _check("flash_extend", q,
                  {"q": q, "k_cache": k_cache, "v_cache": v_cache},
                  {"start_pos": start_pos, "chunk_lens": chunk_lens})
    if q.dtype == torch.bfloat16:
        check_tc_head_dim("flash_extend", d)
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    build.launch("flash_extend", "llmlb_flash_extend", q.device,
                 _ptr(q), _ptr(k_cache), _ptr(v_cache), _ptr(start_pos),
                 _ptr(chunk_lens), _ptr(out), b, t, h, kh, d, s,
                 ctypes.c_float(d**-0.5), code)
    return out
