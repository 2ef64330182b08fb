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
in the reference.

`gqa_attention_decode` reads the dense slot cache, whose kernel
(`flash_decode`) is not ported yet: it computes on CPU tensors only and
raises on any other device rather than run the plain version there.
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
    """One-token decode attention against materialized rows. Returns
    [B, 1, H, D]. Rows with kv_lens > window produce garbage the caller
    discards. CPU tensors only, until the dense-layout kernel is ported."""
    if q.device.type != "cpu":
        raise NotImplementedError(
            "gqa_attention_decode: the dense-cache decode kernel (flash_decode) "
            f"is not ported; tensors on {q.device} are refused")
    s = k_cache.shape[1]
    if window is not None and window < s:
        k_cache, v_cache, s = k_cache[:, :window], v_cache[:, :window], window
    b, t = q.shape[:2]
    valid = torch.arange(s, device=q.device)[None, :] < kv_lens[:, None]
    return masked_attention(q, k_cache, v_cache,
                            valid[:, None, :].expand(b, t, s))


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
