"""Llama-family decoder (Llama-2/3, Qwen-2/2.5, Mistral): counterpart of
`llmlb_tpu/models/llama.py`, the serving entry points of both KV layouts.

Layouts match the reference at every public function so the two compare
like with like: params are a flat dict with layers stacked on the leading
axis (`wq` [L, E, H*D], ...); the KV page pool is [L, P, PS, K, D] with page
0 as the engine's trash page; the dense slot cache is [L, slots, cap, K, D];
q/k/v are [B, T, H|K, D].

JAX donates the cache buffers and returns new ones; here every entry point
writes the caches IN PLACE (index_put_ on the layer slice) and returns the
same tensors, so callers can keep the reference's `logits, ck, cv = f(...)`
shape. Each write is issued on the current stream before the attention that
reads it, so the kernel sees it.

Multi-LoRA (`llmlb_tpu_torch/lora`): a projection may carry adapter pools
`<name>_lora_a` [L, N, in, R] / `<name>_lora_b` [L, N, R, out]; with
`lora_idx` ([B] int32 pool rows) every entry point adds each row's delta
(ops/lora.py) to that projection's output, after any int8 dequant: on the
card one kernel launch adds it in place, beside the product.

Batch invariance on the card: a row's logits do not depend on the rows it
shares a dispatch with. cuBLAS picks its kernel, and with it the order of a
product's sums, by the product's shape, so every product that a batch size
could reshape takes a shape of the row's own: a prefill group (B > 1 rows of
T > 1 positions) runs each projection once per row (M = T, the bucket), and
the vocab projection runs over blocks of UNEMBED_ROWS rows. A decode step
always runs every slot (M fixed) and a chunk one row. The attention and
LoRA kernels cut their work by shape alone, and the elementwise ops and
norms are per row.

int8 quantization (`llmlb_tpu_torch/quant`), as in the reference: a pool
may be a {"q": int8 [L, P, PS, K, D], "s": float32 [L, P, PS, K]} pair,
quantized on write and dequantized by the attention on read; a projection
weight may be int8 with a float32 `<name>_scale` [L, out] companion, applied
to the product's fp32 output.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from llmlb_tpu_torch.lora.manager import LORA_A, LORA_B
from llmlb_tpu_torch.ops.attention import (
    gqa_attention_decode,
    gqa_attention_extend,
    gqa_attention_prefill,
    paged_attention_decode,
    paged_attention_extend,
    pool_shape,
)
from llmlb_tpu_torch.ops.lora import lora_delta_add
from llmlb_tpu_torch.ops.norms import rms_norm
from llmlb_tpu_torch.ops.rope import RopeScaling, apply_rope, rope_frequencies
from llmlb_tpu_torch.quant import SCALE_SUFFIX, quantize_kv

Params = dict[str, torch.Tensor]

# rows of one vocab-projection product on the card (the engine's 8 slots:
# a decode step is one block; a prefill group's last rows are padded to it)
UNEMBED_ROWS = 8


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: int | None = None  # default hidden_size // num_heads
    rope_theta: float = 10000.0
    rope_scaling: RopeScaling | None = None
    rms_eps: float = 1e-5
    attention_bias: bool = False  # Qwen-2/2.5 use qkv bias
    tie_word_embeddings: bool = False
    max_position_embeddings: int = 8192
    dtype: Any = torch.bfloat16

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------

def param_shapes(cfg: LlamaConfig, quantized: tuple[str, ...] = ()
                 ) -> dict[str, tuple[tuple[int, ...], int]]:
    """Leaf name -> (shape, fan_in) for the random init; fan_in 0 marks the
    ones-initialized norms and zero-initialized biases. Each name in
    `quantized` (int8 weights) also names its `<name>_scale` leaf, one
    float32 per layer and output channel (the init makes none of these)."""
    d = cfg.head_dim_
    h, kv, e, f, n = (cfg.num_heads, cfg.num_kv_heads, cfg.hidden_size,
                      cfg.intermediate_size, cfg.num_layers)
    shapes = {
        "embed": ((cfg.vocab_size, e), e),
        "wq": ((n, e, h * d), e),
        "wk": ((n, e, kv * d), e),
        "wv": ((n, e, kv * d), e),
        "wo": ((n, h * d, e), h * d),
        "wg": ((n, e, f), e),
        "wu": ((n, e, f), e),
        "wd": ((n, f, e), f),
        "ln_attn": ((n, e), 0),
        "ln_mlp": ((n, e), 0),
        "ln_final": ((e,), 0),
    }
    if cfg.attention_bias:
        shapes["bq"] = ((n, h * d), 0)
        shapes["bk"] = ((n, kv * d), 0)
        shapes["bv"] = ((n, kv * d), 0)
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = ((e, cfg.vocab_size), e)
    for name in quantized:
        shape = shapes[name][0]
        shapes[name + SCALE_SUFFIX] = (shape[:-2] + shape[-1:], 0)
    return shapes


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str) -> Params:
    """Random init with the reference's scheme: normal * fan_in**-0.5 for
    the matrices, ones for the norms, zeros for the biases. Stacked leaves
    are filled one layer (or, for the vocab matrices, one row block) at a
    time on `device`, so the fp32 temporaries stay small at 8B. The numbers
    differ from JAX's (another generator): tests carry the reference's
    weights across with engine.weights.params_from_numpy instead."""
    params: Params = {}
    for name, (shape, fan_in) in param_shapes(cfg).items():
        if fan_in == 0:
            fill = torch.zeros if name.startswith("b") else torch.ones
            params[name] = fill(shape, dtype=cfg.dtype, device=device)
            continue
        out = torch.empty(shape, dtype=cfg.dtype, device=device)
        rows = out.view(-1, shape[-1]) if len(shape) == 2 else out
        step = 8192 if len(shape) == 2 else 1
        for i in range(0, rows.shape[0], step):
            block = rows[i:i + step]
            noise = torch.randn(block.shape, generator=generator,
                                dtype=torch.float32, device=device)
            block.copy_(noise * fan_in**-0.5)
        params[name] = out
    return params


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, num_slots: int, capacity: int,
                  device: torch.device | str):
    """The dense slot cache: one contiguous row of `capacity` positions per
    slot, [L, slots, capacity, K, D] for K and for V, in cfg.dtype."""
    shape = (cfg.num_layers, num_slots, capacity, cfg.num_kv_heads,
             cfg.head_dim_)
    return (torch.zeros(shape, dtype=cfg.dtype, device=device),
            torch.zeros(shape, dtype=cfg.dtype, device=device))


def init_kv_pages(cfg: LlamaConfig, num_pages: int, page_size: int,
                  device: torch.device | str, dtype=None,
                  quantized: bool = False):
    """Global page pool shared by every slot: a slot's logical row is the
    concatenation of the pool pages its block table names. Page 0 is the
    engine's trash page (see engine/paging.py).

    `quantized` makes each pool an int8 {"q", "s"} pair: codes [L, P, PS, K,
    D] int8 and one float32 scale per written (token, head) vector
    [L, P, PS, K], indexed by the same page ids."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim_)
    if quantized:
        def pool():
            return {"q": torch.zeros(shape, dtype=torch.int8, device=device),
                    "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                     device=device)}

        return pool(), pool()
    dtype = dtype or cfg.dtype
    return (torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device))


def _pool_layer(pool, i: int):
    """One layer's slice of the pool (both members of an int8 pair)."""
    if isinstance(pool, dict):
        return {"q": pool["q"][i], "s": pool["s"][i]}
    return pool[i]


def _write_pool(pool_layer, page: torch.Tensor, off: torch.Tensor,
                kv: torch.Tensor) -> None:
    """Scatter K/V rows into cells [page, off] of one layer's pool, in place
    (the reference returns an updated copy of a donated buffer). An int8
    pair takes the codes and the per-vector scales of quantize_kv at the
    same cells: quantize on write."""
    idx = (page.long(), off.long())
    if isinstance(pool_layer, dict):
        codes, scales = quantize_kv(kv)
        pool_layer["q"].index_put_(idx, codes)
        pool_layer["s"].index_put_(idx, scales)
        return
    pool_layer.index_put_(idx, kv.to(pool_layer.dtype))


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _layer(params: Params, cfg: LlamaConfig, i: int) -> Params:
    """Layer i of every stacked leaf, with the companions the params carry:
    `<name>_scale` of int8 weights and `<name>_lora_a` / `<name>_lora_b`
    adapter pools (the reference's _with_scales)."""
    names = ["wq", "wk", "wv", "wo", "wg", "wu", "wd", "ln_attn", "ln_mlp"]
    if cfg.attention_bias:
        names += ["bq", "bk", "bv"]
    names += [n + suffix for n in names
              for suffix in (SCALE_SUFFIX, LORA_A, LORA_B)
              if n + suffix in params]
    return {n: params[n][i] for n in names}


def _rowwise(x: torch.Tensor, product, n_out: int,
             dtype: torch.dtype) -> torch.Tensor:
    """The product of x [B, T, IN] with a weight -> [B, T, n_out] in
    `dtype`; `product(x2, out)` multiplies rows x2 [M, IN] into `out` (a new
    tensor when out is None). On the card a prefill group (B > 1, T > 1)
    takes one product per batch row, written into that row of the output,
    so each row's sums run in the order cuBLAS picks for M = T alone,
    whatever the group's size; a decode step (T = 1, every slot), a chunk
    (B = 1) and the CPU take one product of all rows."""
    b, t, e = x.shape
    if x.device.type == "cuda" and b > 1 and t > 1:
        y = torch.empty((b, t, n_out), dtype=dtype, device=x.device)
        for i in range(b):
            product(x[i], y[i])
        return y
    return product(x.reshape(b * t, e), None).reshape(b, t, n_out)


def _proj(lp: Params, name: str, x: torch.Tensor,
          lora_idx: torch.Tensor | None = None) -> torch.Tensor:
    """`x @ W` (rows as `_rowwise` groups them). An int8 W takes its
    per-output-channel scale on the fp32 output, as the reference does: the
    operand is W widened to x's dtype (exact: |code| <= 127), the product
    accumulates and returns fp32, then `* scale` and a round to x's dtype.
    On the card a bf16 x takes cuBLAS's bf16-in/fp32-out product; elsewhere
    the operands widen to fp32 (the same values).

    With `lora_idx` and this projection's adapter pools in the layer slice,
    each row's fp32 LoRA delta, rounded to the output's dtype, is added to
    the output after the dequant (`lora_delta_add`: in place, one launch on
    the card); row 0 adds exactly 0.0."""
    w = lp[name]
    scale = lp.get(name + SCALE_SUFFIX)
    if scale is None:
        if w.dtype == torch.int8:
            raise TypeError(f"param {name!r} is int8 but its {name}"
                            f"{SCALE_SUFFIX} companion is missing from the "
                            "layer slice")
        y = _rowwise(x, lambda x2, out: torch.mm(x2, w, out=out), w.shape[-1],
                     x.dtype)
    else:
        if x.device.type == "cuda" and x.dtype != torch.float32:
            wx = w.to(x.dtype)

            def product(x2, out):
                y32 = torch.mm(x2, wx, out_dtype=torch.float32)
                return y32 if out is None else out.copy_(y32)
        else:
            wf = w.float()

            def product(x2, out):
                return torch.mm(x2.float(), wf, out=out)
        y32 = _rowwise(x, product, w.shape[-1], torch.float32)
        y = (y32 * scale).to(x.dtype)
    if lora_idx is not None and name + LORA_A in lp:
        y = lora_delta_add(y, x, lp[name + LORA_A], lp[name + LORA_B],
                           lora_idx)
    return y


def _qkv(cfg: LlamaConfig, lp: Params, x: torch.Tensor, lora_idx=None):
    b, t, _ = x.shape
    d = cfg.head_dim_
    q = _proj(lp, "wq", x, lora_idx)
    k = _proj(lp, "wk", x, lora_idx)
    v = _proj(lp, "wv", x, lora_idx)
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(b, t, cfg.num_heads, d),
            k.reshape(b, t, cfg.num_kv_heads, d),
            v.reshape(b, t, cfg.num_kv_heads, d))


def _mlp(lp: Params, x: torch.Tensor, lora_idx=None) -> torch.Tensor:
    return _proj(lp, "wd", F.silu(_proj(lp, "wg", x, lora_idx))
                 * _proj(lp, "wu", x, lora_idx), lora_idx)


def _attn_block(cfg: LlamaConfig, lp: Params, x: torch.Tensor, positions,
                inv_freq, attn_fn, lora_idx=None):
    """Pre-norm attention sub-block: norm -> qkv -> rope -> attn_fn -> wo
    residual. `attn_fn(q, k, v)` writes the KV and attends."""
    b, t, _ = x.shape
    h = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    q, k, v = _qkv(cfg, lp, h, lora_idx)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = attn_fn(q, k, v)
    return x + _proj(lp, "wo", attn.reshape(b, t, -1), lora_idx)


def _layer_step(cfg: LlamaConfig, lp: Params, x: torch.Tensor, positions,
                inv_freq, attn_fn, lora_idx) -> torch.Tensor:
    """One decoder layer: the attention sub-block, then the MLP residual."""
    x = _attn_block(cfg, lp, x, positions, inv_freq, attn_fn, lora_idx)
    return x + _mlp(lp, rms_norm(x, lp["ln_mlp"], cfg.rms_eps), lora_idx)


def _lora_rows(lora_idx, dev) -> torch.Tensor | None:
    return None if lora_idx is None else lora_idx.to(device=dev,
                                                     dtype=torch.int32)


def _unembed(cfg: LlamaConfig, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and vocab projection -> fp32 logits [B, V]: model-dtype
    inputs, fp32 accumulation and fp32 output, as the reference's
    preferred_element_type=float32. On the card a bf16 model takes cuBLAS's
    bf16-in/fp32-out product, so the logits are never rounded to bf16 and no
    fp32 copy of the vocab matrix is made; the CPU has no such product and
    widens the operands instead (the same values). On the card the rows go
    through the product in blocks of UNEMBED_ROWS (the last one padded with
    zero rows), so a row's logits do not depend on how many rows came with
    it."""
    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    if x.device.type != "cuda":
        return x.float() @ head.float()
    n = x.shape[0]
    rows = x if n % UNEMBED_ROWS == 0 else F.pad(x, (0, 0, 0, -n % UNEMBED_ROWS))
    if x.dtype == torch.float32:
        head = head.float()
        blocks = [blk @ head for blk in rows.split(UNEMBED_ROWS)]
    else:
        blocks = [torch.mm(blk, head, out_dtype=torch.float32)
                  for blk in rows.split(UNEMBED_ROWS)]
    return (blocks[0] if len(blocks) == 1 else torch.cat(blocks))[:n]


def _last_rows(x: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """x [B, T, E] -> row lens[b]-1 of each batch entry, [B, E]."""
    last = torch.clamp(lens.long() - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), last]


def _rope_freqs(cfg: LlamaConfig, device) -> torch.Tensor:
    return rope_frequencies(cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling,
                            device=device)


def _page_cells(block_tables: torch.Tensor, positions: torch.Tensor,
                page_size: int):
    """Physical (page, offset) of logical positions [B, T]. Table columns
    past the end clamp to the last, as the reference's gather does."""
    col = torch.clamp(positions // page_size, max=block_tables.shape[1] - 1)
    return torch.gather(block_tables, 1, col.long()), positions % page_size


def prefill_into_pages(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, T] int, right-padded
    prompt_lens: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, PPN] int32 — target pages per prompt
    cache_k,  # [L, P, PS, K, D] — the engine's live page pool, or int8 pair
    cache_v,
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
):
    """Prefill B prompts and scatter their KV through the block tables into
    the global page pool. Returns (last_logits [B, V] fp32, cache_k,
    cache_v), the pools updated in place.

    HANDOFF CONTRACT (kept from the reference): row i of `last_logits` is the
    FINAL-position logits of prompt i, and every KV row lands at its absolute
    token position. The first token samples from exactly this logits row,
    and position-exact KV is what lets a later chunk or decode step continue
    the sequence token-identically."""
    b, t = input_ids.shape
    dev = input_ids.device
    inv_freq = _rope_freqs(cfg, dev)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    page, off = _page_cells(block_tables, positions,
                            pool_shape(cache_k)[2])
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    lora_idx = _lora_rows(lora_idx, dev)

    x = params["embed"][input_ids.long()]  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_pool(_pool_layer(cache_k, i), page, off, k)
            _write_pool(_pool_layer(cache_v, i), page, off, v)
            return gqa_attention_prefill(q, k, v, prompt_lens)

        x = _layer_step(cfg, _layer(params, cfg, i), x, positions, inv_freq,
                        attn_fn, lora_idx)

    logits = _unembed(cfg, params, _last_rows(x, prompt_lens))
    return logits, cache_k, cache_v


def prefill_extend_pages(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, T] int, right-padded chunk
    chunk_lens: torch.Tensor,  # [B] int32 — valid tokens in this chunk
    start_pos: torch.Tensor,  # [B] int32 — tokens already in the row's pages
    block_tables: torch.Tensor,  # [B, PPN] int32
    cache_k,  # [L, P, PS, K, D], or an int8 {"q", "s"} pair
    cache_v,
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
):
    """Paged chunked prefill: append a chunk of prompt tokens to rows that
    already hold `start_pos` tokens, attending over everything so far
    through the block tables. Padding tokens write garbage past the chunk —
    into the row's own later pages or the trash page, never another row's
    cells. Returns (chunk-last logits [B, V] fp32, cache_k, cache_v)."""
    b, t = input_ids.shape
    dev = input_ids.device
    ps = pool_shape(cache_k)[2]
    capacity = block_tables.shape[1] * ps
    inv_freq = _rope_freqs(cfg, dev)
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    chunk_lens = chunk_lens.to(device=dev, dtype=torch.int32)
    positions = start_pos[:, None] + torch.arange(t, device=dev,
                                                  dtype=torch.int32)[None, :]
    page, off = _page_cells(block_tables,
                            torch.clamp(positions, max=capacity - 1), ps)
    lora_idx = _lora_rows(lora_idx, dev)

    x = params["embed"][input_ids.long()]  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            ck, cv = _pool_layer(cache_k, i), _pool_layer(cache_v, i)
            _write_pool(ck, page, off, k)
            _write_pool(cv, page, off, v)
            return paged_attention_extend(q, ck, cv, block_tables, positions,
                                          chunk_lens)

        x = _layer_step(cfg, _layer(params, cfg, i), x, positions, inv_freq,
                        attn_fn, lora_idx)

    logits = _unembed(cfg, params, _last_rows(x, chunk_lens))
    return logits, cache_k, cache_v


def decode_step_paged(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B] int — previous sampled token per row
    seq_lens: torch.Tensor,  # [B] int32 — tokens already in the row's pages
    cache_k,  # [L, P, PS, K, D], or an int8 {"q", "s"} pair
    cache_v,
    block_tables: torch.Tensor,  # [B, PPN] int32
    window: int | None = None,  # context-window bucket (>= max seq + 1)
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
):
    """One paged decode step across all rows. Returns (logits [B, V] fp32,
    cache_k, cache_v). Each layer's one-token KV lands at page
    block_tables[b, pos // PS], offset pos % PS, before attention reads the
    pool; freed or parked rows clamp into their own last cell or the trash
    page (their table rows are zeroed on free), so garbage writes never land
    in a page another row owns."""
    dev = input_ids.device
    ps = pool_shape(cache_k)[2]
    capacity = block_tables.shape[1] * ps
    inv_freq = _rope_freqs(cfg, dev)
    write_pos = torch.clamp(seq_lens.to(device=dev, dtype=torch.int32),
                            max=capacity - 1)
    positions = write_pos[:, None]  # [B, 1]
    page, off = _page_cells(block_tables, positions, ps)
    kv_lens = (write_pos + 1).to(torch.int32)
    lora_idx = _lora_rows(lora_idx, dev)

    x = params["embed"][input_ids.long()][:, None, :]  # [B, 1, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            ck, cv = _pool_layer(cache_k, i), _pool_layer(cache_v, i)
            _write_pool(ck, page, off, k)
            _write_pool(cv, page, off, v)
            return paged_attention_decode(q, ck, cv, block_tables, kv_lens,
                                          window=window)

        x = _layer_step(cfg, _layer(params, cfg, i), x, positions, inv_freq,
                        attn_fn, lora_idx)

    logits = _unembed(cfg, params, x[:, 0])
    return logits, cache_k, cache_v


# ---------------------------------------------------------------------------
# Dense slot layout: row s of the cache [L, slots, cap, K, D] is slot s
# ---------------------------------------------------------------------------

def _write_slots(cache_layer: torch.Tensor, rows: torch.Tensor,
                 cols: torch.Tensor, kv: torch.Tensor) -> None:
    """Scatter K/V into cells [rows, cols] of one layer's slot cache, in
    place (the reference's `.at[slot_ids[:, None], positions].set`)."""
    cache_layer.index_put_((rows.long(), cols.long()),
                           kv.to(cache_layer.dtype))


def prefill_into_slots(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, T] int, right-padded
    prompt_lens: torch.Tensor,  # [B] int32
    slot_ids: torch.Tensor,  # [B] int — target rows in the slot cache
    cache_k: torch.Tensor,  # [L, NUM_SLOTS, CAP, K, D] — the live cache
    cache_v: torch.Tensor,
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
):
    """Prefill B prompts (flash_prefill over their fresh K/V) and scatter
    their KV into rows `slot_ids` of the live slot cache, positions 0..T-1.
    Returns (last_logits [B, V] fp32, cache_k, cache_v), the caches updated
    in place. Padding rows that repeat a slot write identical cells."""
    b, t = input_ids.shape
    dev = input_ids.device
    inv_freq = _rope_freqs(cfg, dev)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    rows = slot_ids.to(dev)[:, None].expand(b, t)
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    lora_idx = _lora_rows(lora_idx, dev)

    x = params["embed"][input_ids.long()]  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_slots(cache_k[i], rows, positions, k)
            _write_slots(cache_v[i], rows, positions, v)
            return gqa_attention_prefill(q, k, v, prompt_lens)

        x = _layer_step(cfg, _layer(params, cfg, i), x, positions, inv_freq,
                        attn_fn, lora_idx)

    logits = _unembed(cfg, params, _last_rows(x, prompt_lens))
    return logits, cache_k, cache_v


def prefill_extend_slots(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, T] int, right-padded chunk
    chunk_lens: torch.Tensor,  # [B] int32 — valid tokens in this chunk
    start_pos: torch.Tensor,  # [B] int32 — tokens already in the slot's row
    slot_ids: torch.Tensor,  # [B] int — target rows in the slot cache
    cache_k: torch.Tensor,  # [L, NUM_SLOTS, CAP, K, D]
    cache_v: torch.Tensor,
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
):
    """Dense chunked prefill: append a chunk of prompt tokens to slots that
    already hold `start_pos` tokens. Each layer writes the chunk's K/V into
    the slot rows (positions clamped into the row, as the reference), gathers
    those rows (`ck[slot_ids]`) and runs flash_extend over them. Padding
    tokens write garbage past the chunk, in cells later attention masks and
    the sequence overwrites as it grows. Returns (chunk-last logits [B, V]
    fp32, cache_k, cache_v)."""
    b, t = input_ids.shape
    dev = input_ids.device
    capacity = cache_k.shape[2]
    inv_freq = _rope_freqs(cfg, dev)
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    chunk_lens = chunk_lens.to(device=dev, dtype=torch.int32)
    positions = start_pos[:, None] + torch.arange(t, device=dev,
                                                  dtype=torch.int32)[None, :]
    write_pos = torch.clamp(positions, max=capacity - 1)
    slots = slot_ids.to(dev).long()
    rows = slots[:, None].expand(b, t)
    lora_idx = _lora_rows(lora_idx, dev)

    x = params["embed"][input_ids.long()]  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_slots(cache_k[i], rows, write_pos, k)
            _write_slots(cache_v[i], rows, write_pos, v)
            return gqa_attention_extend(q, cache_k[i][slots],
                                        cache_v[i][slots], positions,
                                        chunk_lens)

        x = _layer_step(cfg, _layer(params, cfg, i), x, positions, inv_freq,
                        attn_fn, lora_idx)

    logits = _unembed(cfg, params, _last_rows(x, chunk_lens))
    return logits, cache_k, cache_v


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B] int — previous sampled token per slot
    seq_lens: torch.Tensor,  # [B] int32 — tokens already in the slot's row
    cache_k: torch.Tensor,  # [L, B, CAP, K, D] — row b is slot b
    cache_v: torch.Tensor,
    window: int | None = None,  # context-window bucket (>= max seq + 1)
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
):
    """One dense decode step across all slots. Returns (logits [B, V] fp32,
    cache_k, cache_v). Each layer writes slot b's one-token KV at
    min(seq_lens[b], cap - 1) (freed slots keep counting; the clamp keeps
    their garbage in their own row) before flash_decode reads the row over
    `window` cells."""
    b = input_ids.shape[0]
    dev = input_ids.device
    capacity = cache_k.shape[2]
    inv_freq = _rope_freqs(cfg, dev)
    write_pos = torch.clamp(seq_lens.to(device=dev, dtype=torch.int32),
                            max=capacity - 1)
    positions = write_pos[:, None]  # [B, 1]
    rows = torch.arange(b, device=dev)
    kv_lens = (write_pos + 1).to(torch.int32)
    lora_idx = _lora_rows(lora_idx, dev)

    x = params["embed"][input_ids.long()][:, None, :]  # [B, 1, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_slots(cache_k[i], rows, write_pos, k[:, 0])
            _write_slots(cache_v[i], rows, write_pos, v[:, 0])
            return gqa_attention_decode(q, cache_k[i], cache_v[i], kv_lens,
                                        window=window)

        x = _layer_step(cfg, _layer(params, cfg, i), x, positions, inv_freq,
                        attn_fn, lora_idx)

    logits = _unembed(cfg, params, x[:, 0])
    return logits, cache_k, cache_v
