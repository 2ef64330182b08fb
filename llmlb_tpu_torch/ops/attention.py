"""Grouped-query attention for serving: counterpart of
`llmlb_tpu/ops/attention.py`.

The public functions keep the reference's signatures (q [B, T, H, D], the
decode `window`, the extend `q_positions`) and map them onto the kernel
wrappers of `ops/cuda_attention.py`. The tensors' device decides what runs:
CUDA tensors launch the hand-written kernels, CPU tensors take their plain
PyTorch versions (fp32 scores scaled after the dot, fp32 softmax with finite
-1e30 masking, GQA folded into the einsum with no repeated KV copy). There is
no switch, and nothing on the card takes the plain path.

A paged pool is a tensor [P, PS, K, D] or an int8 {"q": codes [P, PS, K, D],
"s": float32 scales [P, PS, K]} pair; a pair goes to the quant kernels, as
in the reference. The dense slot cache's rows [B, S, K, D] go to
`flash_decode` and `flash_extend`.
"""

from __future__ import annotations

import torch

from llmlb_tpu_torch.ops import cuda_attention
# gather_kv_pages is public here too, as in the reference module
from llmlb_tpu_torch.ops.cuda_attention import (  # noqa: F401
    gather_kv_pages,
    masked_attention,
    pool_shape,
)


def gqa_attention_prefill(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,  # [B, T, K, D]
    prompt_lens: torch.Tensor,  # [B] int32 — tokens beyond this are padding
) -> torch.Tensor:
    """Causal self-attention over a freshly-prefilled prompt. Returns [B, T, H, D]."""
    return cuda_attention.flash_prefill(q, k, v, prompt_lens)


def gqa_attention_decode(
    q: torch.Tensor,  # [B, 1, H, D]
    k_cache: torch.Tensor,  # [B, S, K, D] — incl. the current token
    v_cache: torch.Tensor,  # [B, S, K, D]
    kv_lens: torch.Tensor,  # [B] — valid length per row (incl. current)
    window: int | None = None,  # read only the first `window` cells
) -> torch.Tensor:
    """One-token decode attention against the dense slot cache. Returns
    [B, 1, H, D]. `window` bounds the sweep without slicing the cache; rows
    with kv_lens > window produce garbage the caller discards."""
    out = cuda_attention.flash_decode(
        q[:, 0].contiguous(), k_cache, v_cache,
        kv_lens.to(torch.int32).contiguous(), window=window)
    return out[:, None]


def gqa_attention_extend(
    q: torch.Tensor,  # [B, T, H, D] — chunk of queries
    k_cache: torch.Tensor,  # [B, S, K, D] — slot rows incl. this chunk's keys
    v_cache: torch.Tensor,  # [B, S, K, D]
    q_positions: torch.Tensor,  # [B, T] — global position of each query
    chunk_lens: torch.Tensor | None = None,  # [B] int32 — valid queries
) -> torch.Tensor:
    """Chunked-prefill attention: query i at global position p sees cache
    positions <= p. With `chunk_lens` it is flash_extend, which assumes the
    engine's contiguous chunk positions (q_positions[b] = start + iota).
    Without, it is the reference's general einsum, computed on CPU tensors
    only: on the card such a call raises rather than run the plain way."""
    if chunk_lens is None:
        if q.device.type != "cpu":
            raise ValueError("gqa_attention_extend: chunk_lens is required on "
                             f"{q.device} (the flash_extend kernel's form)")
        cols = torch.arange(k_cache.shape[1], device=q.device)
        mask = cols[None, None, :] <= q_positions.to(q.device)[:, :, None]
        return masked_attention(q, k_cache, v_cache, mask)
    start = q_positions[:, 0].to(torch.int32).contiguous()
    return cuda_attention.flash_extend(q, k_cache, v_cache, start,
                                       chunk_lens.to(torch.int32).contiguous())


def paged_attention_decode(
    q: torch.Tensor,  # [B, 1, H, D]
    k_pages,  # [P, PS, K, D] pool, or an int8 {"q", "s"} pair
    v_pages,  # [P, PS, K, D]
    block_tables: torch.Tensor,  # [B, PPN] int32
    kv_lens: torch.Tensor,  # [B] int32 — valid logical length per row
    window: int | None = None,  # read only the first `window` cells
) -> torch.Tensor:
    """One-token decode attention against the PAGED KV pool. `window`
    bounds the logical sweep, rounded up to whole pages; rows with kv_lens
    beyond the swept pages produce garbage the caller must discard."""
    ps = pool_shape(k_pages)[1]
    ppn = block_tables.shape[1]
    pages = ppn if window is None else max(1, min(ppn, -(-window // ps)))
    q1 = q[:, 0].contiguous()
    if isinstance(k_pages, dict):
        out = cuda_attention.paged_flash_decode_quant(
            q1, k_pages["q"], k_pages["s"], v_pages["q"], v_pages["s"],
            block_tables, kv_lens, pages=pages)
    else:
        out = cuda_attention.paged_flash_decode(
            q1, k_pages, v_pages, block_tables, kv_lens, pages=pages)
    return out[:, None]


def paged_attention_extend(
    q: torch.Tensor,  # [B, T, H, D] — chunk of queries
    k_pages,  # [P, PS, K, D] pool, or an int8 {"q", "s"} pair
    v_pages,  # [P, PS, K, D]
    block_tables: torch.Tensor,  # [B, PPN] int32
    q_positions: torch.Tensor,  # [B, T] — global position of each query
    chunk_lens: torch.Tensor,  # [B] int32 — valid queries in the chunk
) -> torch.Tensor:
    """Chunked-prefill attention against the PAGED KV pool: the chunk's
    queries attend causally over row b's pages. Assumes contiguous chunk
    positions (q_positions[b] = start + iota), as the engine builds them."""
    start = q_positions[:, 0].to(torch.int32).contiguous()
    if isinstance(k_pages, dict):
        return cuda_attention.paged_flash_extend_quant(
            q, k_pages["q"], k_pages["s"], v_pages["q"], v_pages["s"],
            block_tables, start, chunk_lens)
    return cuda_attention.paged_flash_extend(
        q, k_pages, v_pages, block_tables, start, chunk_lens,
    )
