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
T positions) runs each projection once per row (M = T, the bucket), and the
vocab projection runs over blocks of UNEMBED_ROWS rows. Which entry points
split is said by each one (`per_row`), not read from the input's shape: the
prefill entry points split, while a decode step (every slot, M fixed) and a
speculative verify step (every slot's K+1 positions, M = slots * (K+1)
fixed) take one product of all their rows, so a verify reads each weight
matrix once, as a decode step does. The attention and LoRA kernels cut their
work by shape alone, and the elementwise ops and norms are per row.

Every entry point takes the family's feed-forward as `ffn` (a
`FeedForward`: the layer's leaves and `mlp_fn(lp, h, token_valid, lora_idx,
per_row, mesh)`, the reference's mlp_fn seam): the dense SwiGLU by default,
routed experts for `models/mixtral.py`. `token_valid` marks the prompt or
chunk tokens of a prefill or extend (None in decode), so routing can keep
padding out.

Multi-rank (parallel/): every entry point takes the rank's `mesh` (None
on one rank: nothing below changes) with the rank's shard of the params
(`shard_params`, by the reference's `param_logical_axes`) and its local
view of the config (`local_config`: its heads and ffn width). On a tp mesh
wq / wk / wv / wg / wu are column-parallel and wo / wd row-parallel, their
fp32 partials summed over tp before the one round; the embedding and the
vocab projection are vocab-sharded (rows summed, fp32 logits gathered).
`make_context_parallel_prefill` runs a long prompt split over sp. On a dp
mesh the entry points take `dp_rows` (parallel/mesh.py `DpRows`): each
dp group computes only its own rows of the batch, and one collective over
dp (`dp_exchange`) gives every rank the whole batch's fp32 logits and, in
the paged layout, copies the KV cells each group wrote into every rank's
pool (the pool is replicated over dp, as the reference's). The dense slot
cache holds only the group's slots (the slot axis over dp), so nothing is
exchanged there. A feed-forward may couple the rows (models/mixtral.py's
capacity dispatch gathers them over dp); a group with none of the rows
then joins its collectives (`FeedForward.join`). Adapter pools shard like
their weights: on a row-parallel target (wo, wd) a rank's partial delta
(x_s A_s) B joins the fp32 partial product before the tp sum that follows
it.

int8 quantization (`llmlb_tpu_torch/quant`), as in the reference: a pool
may be a {"q": int8 [L, P, PS, K, D], "s": float32 [L, P, PS, K]} pair,
quantized on write and dequantized by the attention on read; a projection
weight may be int8 with a float32 `<name>_scale` [L, out] companion, applied
to the product's fp32 output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

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
from llmlb_tpu_torch.ops.lora import lora_delta, lora_delta_add
from llmlb_tpu_torch.ops.norms import rms_norm
from llmlb_tpu_torch.ops.rope import RopeScaling, apply_rope, rope_frequencies
from llmlb_tpu_torch.parallel.mesh import DpRows, Mesh, validate_tp
from llmlb_tpu_torch.parallel.sharding import ShardingRules, shard_leaf
from llmlb_tpu_torch.quant import SCALE_SUFFIX, WEIGHT_QUANT_NAMES, quantize_kv
from llmlb_tpu_torch.quant.core import absmax_int8

Params = dict[str, torch.Tensor]

# rows of one vocab-projection product on the card (the engine's 8 slots:
# a decode step is one block; a prefill group's last rows are padded to it)
UNEMBED_ROWS = 8

# The family's facts that the engine, the loader and the adapter pools read
# through models.family_for: the projections an engine pools adapters for
# (every one), the feed-forward's HF tensors under a layer's prefix, and
# whether the rows of one prefill group shape each other's output (no: a
# row's tokens are its own).
LORA_TARGETS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
HF_FFN_NAMES = {"wg": "mlp.gate_proj.weight", "wu": "mlp.up_proj.weight",
                "wd": "mlp.down_proj.weight"}
PREFILL_COUPLES_ROWS = False


def hf_config_fields(cfg: "LlamaConfig") -> dict:
    """The keys of a HF `config.json` this family adds to the dense ones
    (`engine.weights.hf_config`): none."""
    return {}


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

    @classmethod
    def from_hf_config(cls, hf: dict, dtype=torch.bfloat16) -> "LlamaConfig":
        """Build from a HF `config.json` dict (llama / qwen2 / mistral
        archs), as the reference reads it: `llama3` rope scaling is taken,
        any other scaling type is refused (its logits past the original
        context would be silently wrong), and `attention_bias` defaults to
        true for qwen2."""
        scaling = None
        rs = hf.get("rope_scaling")
        rope_type = rs.get("rope_type", rs.get("type")) if rs else None
        if rope_type not in (None, "default", "llama3"):
            raise NotImplementedError(
                f"rope_scaling type {rope_type!r} is not supported yet; "
                "refusing to load a checkpoint that would generate silently "
                "wrong logits beyond its original context window")
        if rope_type == "llama3":
            scaling = RopeScaling(
                factor=rs.get("factor", 8.0),
                low_freq_factor=rs.get("low_freq_factor", 1.0),
                high_freq_factor=rs.get("high_freq_factor", 4.0),
                original_max_position=rs.get(
                    "original_max_position_embeddings", 8192))
        model_type = hf.get("model_type", "llama")
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_layers=hf["num_hidden_layers"],
            num_heads=hf["num_attention_heads"],
            num_kv_heads=hf.get("num_key_value_heads",
                                hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling=scaling,
            rms_eps=hf.get("rms_norm_eps", 1e-5),
            attention_bias=hf.get("attention_bias",
                                  model_type in ("qwen2", "qwen2_moe")),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            max_position_embeddings=hf.get("max_position_embeddings", 8192),
            dtype=dtype,
        )


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
                device: torch.device | str,
                quantize_weights: bool = False,
                mesh: Mesh | None = None) -> Params:
    """Random init with the reference's scheme: normal * fan_in**-0.5 for
    the matrices, ones for the norms, zeros for the biases. Stacked leaves
    are filled one layer (or, for the vocab matrices, one row block) at a
    time on `device`, so the fp32 temporaries stay small at 8B. The numbers
    differ from JAX's (another generator): tests carry the reference's
    weights across with engine.weights.params_from_numpy instead.
    `quantize_weights` gives the projections as int8 with their scales,
    each block quantized right after its round to cfg.dtype: the codes of
    quantize_params over the cfg.dtype init, without the cfg.dtype leaf.
    With a `mesh` every rank draws the same full leaves and keeps its shard
    of each as it is filled (shard_params' slices), so at most one full
    leaf exists at a time."""
    return fill_params(param_shapes, cfg, generator, device, quantize_weights,
                       keep=_sharder(cfg, mesh, param_logical_axes(cfg)))


def fill_params(shapes_fn, cfg: LlamaConfig, generator: torch.Generator,
                device: torch.device | str,
                quantize_weights: bool = False, keep=None) -> Params:
    """init_params of a family whose `shapes_fn(cfg, quantized)` gives its
    leaves (param_shapes' contract): a stacked matrix leaf [..., in, out]
    is filled one [in, out] block at a time (a layer, or a layer's expert),
    which with `quantize_weights` quantizes per output channel at once.
    `keep(name, leaf)`, when given, replaces each leaf once it is whole (a
    rank's shard)."""
    keep = keep or (lambda name, x: x)
    quantized = tuple(n for n in WEIGHT_QUANT_NAMES if quantize_weights
                      and n in shapes_fn(cfg))
    params: Params = {}
    for name, (shape, fan_in) in shapes_fn(cfg, quantized).items():
        if name.endswith(SCALE_SUFFIX) and name[:-len(SCALE_SUFFIX)] in quantized:
            continue  # made beside its weight
        if fan_in == 0:
            fill = torch.zeros if name.startswith("b") else torch.ones
            params[name] = keep(name, fill(shape, dtype=cfg.dtype,
                                           device=device))
            continue
        q = name in quantized
        out = torch.empty(shape, dtype=torch.int8 if q else cfg.dtype,
                          device=device)
        if len(shape) == 2:
            rows, step = out.view(-1, shape[-1]), 8192
        else:
            rows, step = out.view(-1, *shape[-2:]), 1
        if q:
            scale = torch.empty(shape[:-2] + shape[-1:], dtype=torch.float32,
                                device=device)
            params[name + SCALE_SUFFIX] = scale
            scale_rows = scale.view(-1, shape[-1])
        for i in range(0, rows.shape[0], step):
            block = rows[i:i + step]
            noise = torch.randn(block.shape, generator=generator,
                                dtype=torch.float32, device=device)
            if q:
                codes, s = absmax_int8((noise * fan_in**-0.5).to(cfg.dtype),
                                       -2)
                block.copy_(codes)
                scale_rows[i:i + step].copy_(s)
            else:
                block.copy_(noise * fan_in**-0.5)
        params[name] = keep(name, out)
        if q:
            params[name + SCALE_SUFFIX] = keep(name + SCALE_SUFFIX, scale)
    return params


# ---------------------------------------------------------------------------
# Sharding over a mesh (parallel/): the reference's logical axes and rules
# ---------------------------------------------------------------------------

def param_logical_axes(cfg: LlamaConfig) -> dict[str, tuple]:
    """Logical sharding axes per param leaf (parallel/sharding.py), the
    reference's: int8 scales take their weight's axes less the input one,
    adapter pools keep the weight's input (A) or output (B) axis."""
    axes = {
        "embed": ("vocab", "embed"),
        "wq": ("layers", "embed", "heads"),
        "wk": ("layers", "embed", "kv_heads"),
        "wv": ("layers", "embed", "kv_heads"),
        "wo": ("layers", "heads", "embed"),
        "wg": ("layers", "embed", "ffn"),
        "wu": ("layers", "embed", "ffn"),
        "wd": ("layers", "ffn", "embed"),
        "ln_attn": ("layers", "embed"),
        "ln_mlp": ("layers", "embed"),
        "ln_final": ("embed",),
    }
    if cfg.attention_bias:
        axes["bq"] = ("layers", "heads")
        axes["bk"] = ("layers", "kv_heads")
        axes["bv"] = ("layers", "kv_heads")
    if not cfg.tie_word_embeddings:
        axes["lm_head"] = ("embed", "vocab")
    for name in ("wq", "wk", "wv", "wo", "wg", "wu", "wd"):
        axes[name + SCALE_SUFFIX] = (axes[name][0], axes[name][2])
    for name in LORA_TARGETS:
        w_axes = axes[name]
        axes[name + LORA_A] = (w_axes[0], None, w_axes[1], None)
        axes[name + LORA_B] = (w_axes[0], None, None, w_axes[2])
    return axes


def shard_rules_for(cfg: LlamaConfig, tp: int) -> ShardingRules:
    """Default rules; kv heads replicate when tp exceeds the kv head count."""
    validate_tp(cfg.num_heads, cfg.num_kv_heads, tp)
    if cfg.intermediate_size % tp != 0:
        raise ValueError(
            f"intermediate_size={cfg.intermediate_size} not divisible by tp={tp}"
        )
    kv_shardable = cfg.num_kv_heads % tp == 0
    return ShardingRules(kv_heads="tp" if kv_shardable else None)


def param_shardings(cfg: LlamaConfig, mesh: Mesh,
                    rules: ShardingRules | None = None
                    ) -> dict[str, tuple[str | None, ...]]:
    """Leaf name -> the mesh axis of each dim (the reference's
    NamedShardings, as PartitionSpec tuples)."""
    rules = rules or shard_rules_for(cfg, mesh.shape["tp"])
    return {name: rules.spec(*axes)
            for name, axes in param_logical_axes(cfg).items()}


def local_config(cfg: LlamaConfig, mesh: Mesh) -> LlamaConfig:
    """The config a rank computes with: its share of the heads, the KV
    heads it holds (one when tp exceeds their count: the one its q heads
    read) and its share of the ffn width. A rank's KV caches are made from
    it, so they hold its KV heads: the reference's cache and pool
    shardings (kv heads over tp, replicated over sp). head_dim is pinned, so rope and
    the attention scale keep the full model's; the vocab, the layers and
    the experts keep their global counts."""
    tp = mesh.shape["tp"]
    if tp == 1:
        return cfg
    shard_rules_for(cfg, tp)
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // tp,
        num_kv_heads=max(1, cfg.num_kv_heads // tp), head_dim=cfg.head_dim_,
        intermediate_size=cfg.intermediate_size // tp)


_KV_LEAVES = ("wk", "wv", "bk", "bv", "wk" + SCALE_SUFFIX, "wv" + SCALE_SUFFIX,
              "wk" + LORA_B, "wv" + LORA_B)


def shard_params(params: Params, cfg: LlamaConfig, mesh: Mesh,
                 logical_axes: dict[str, tuple] | None = None) -> Params:
    """This rank's params from the full ones: each leaf's `rank_slice` by
    its logical axes (the block JAX places on the device at this mesh
    coordinate), copied so the full leaf can go. Where tp exceeds the KV
    head count the reference replicates wk / wv; a rank here keeps only
    the KV head its own q heads read (local q head i reads local KV head
    i // group in the kernels)."""
    keep = _sharder(cfg, mesh, logical_axes or param_logical_axes(cfg))
    if keep is None:
        return params
    return {name: keep(name, full) for name, full in params.items()}


def _sharder(cfg: LlamaConfig, mesh: Mesh | None, axes: dict[str, tuple]):
    """`(name, full leaf) -> this rank's copy of its shard` (shard_params'
    rule), or None on one rank."""
    if mesh is None or mesh.trivial:
        return None
    rules = shard_rules_for(cfg, mesh.shape["tp"])
    tp = mesh.shape["tp"]
    replicated_kv = tp > 1 and cfg.num_kv_heads % tp != 0

    def keep(name: str, full: torch.Tensor) -> torch.Tensor:
        x = shard_leaf(full, axes[name], rules, mesh)
        if replicated_kv and name in _KV_LEAVES:
            d = cfg.head_dim_
            head = mesh.kv_heads(cfg.num_kv_heads).start
            x = x.narrow(x.dim() - 1, head * d, d)
        return x.clone()

    return keep


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

def _layer(params: Params, cfg: LlamaConfig, i: int,
           ffn_names: tuple[str, ...] = ("wg", "wu", "wd")) -> Params:
    """Layer i of every stacked leaf (the attention's, the norms and the
    family's feed-forward leaves `ffn_names`), with the companions the
    params carry: `<name>_scale` of int8 weights and `<name>_lora_a` /
    `<name>_lora_b` adapter pools (the reference's _with_scales)."""
    names = ["wq", "wk", "wv", "wo", *ffn_names, "ln_attn", "ln_mlp"]
    if cfg.attention_bias:
        names += ["bq", "bk", "bv"]
    names += [n + suffix for n in names
              for suffix in (SCALE_SUFFIX, LORA_A, LORA_B)
              if n + suffix in params]
    return {n: params[n][i] for n in names}


def _rowwise(x: torch.Tensor, product, n_out: int, dtype: torch.dtype,
             per_row: bool) -> torch.Tensor:
    """The product of x [B, T, IN] with a weight -> [B, T, n_out] in
    `dtype`; `product(x2, out)` multiplies rows x2 [M, IN] into `out` (a new
    tensor when out is None). With `per_row` (the prefill entry points) and
    B > 1 on the card, each batch row takes a product of its own, written
    into that row of the output, so its sums run in the order cuBLAS picks
    for M = T alone, whatever the group's size. Without it (a decode or a
    verify step: every slot, so M is fixed), for one row, and on the CPU,
    one product takes all rows."""
    b, t, e = x.shape
    if per_row and x.device.type == "cuda" and b > 1:
        y = torch.empty((b, t, n_out), dtype=dtype, device=x.device)
        for i in range(b):
            product(x[i], y[i])
        return y
    return product(x.reshape(b * t, e), None).reshape(b, t, n_out)


def _proj(lp: Params, name: str, x: torch.Tensor,
          lora_idx: torch.Tensor | None = None, *,
          per_row: bool = False, reduce=None) -> torch.Tensor:
    """`x @ W` (rows as `_rowwise` groups them, by `per_row`). An int8 W
    takes its per-output-channel scale on the fp32 output, as the reference
    does: the
    operand is W widened to x's dtype (exact: |code| <= 127), the product
    accumulates and returns fp32, then `* scale` and a round to x's dtype.
    On the card a bf16 x takes cuBLAS's bf16-in/fp32-out product; elsewhere
    the operands widen to fp32 (the same values).

    With `lora_idx` and this projection's adapter pools in the layer slice,
    each row's fp32 LoRA delta, rounded to the output's dtype, is added to
    the output after the dequant (`lora_delta_add`: in place, one launch on
    the card); row 0 adds exactly 0.0.

    `reduce` (a row-parallel product on a tp mesh: this rank holds a slice
    of W's input rows) sums the ranks' fp32 partials before the scale and
    the one round to x's dtype, so a tp mesh rounds once, as one card
    does. With an adapter on such a product (A holds the same input rows)
    each rank's partial delta (x_s A_s) B is added to its scaled partial
    and the sum is rounded once: no collective of its own. The reference
    all-reduces the rank-R middle x A instead, and one card rounds the
    delta and the product apart; the sums' order differs, not the
    function."""
    w = lp[name]
    scale = lp.get(name + SCALE_SUFFIX)
    if scale is None and w.dtype == torch.int8:
        raise TypeError(f"param {name!r} is int8 but its {name}"
                        f"{SCALE_SUFFIX} companion is missing from the "
                        "layer slice")
    lora = lora_idx is not None and name + LORA_A in lp
    if scale is None and reduce is None:
        y = _rowwise(x, lambda x2, out: torch.mm(x2, w, out=out), w.shape[-1],
                     x.dtype, per_row)
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
        y32 = _rowwise(x, product, w.shape[-1], torch.float32, per_row)
        if reduce is not None and lora:
            # a row-parallel target: this rank's partial delta (x_s A_s) B
            # joins its partial product, scaled, before the one tp sum
            part = y32 if scale is None else y32 * scale
            return reduce(part + lora_delta(x, lp[name + LORA_A],
                                            lp[name + LORA_B], lora_idx)
                          ).to(x.dtype)
        if reduce is not None:
            y32 = reduce(y32)
        y = (y32 if scale is None else y32 * scale).to(x.dtype)
    if lora:
        y = lora_delta_add(y, x, lp[name + LORA_A], lp[name + LORA_B],
                           lora_idx)
    return y


def _qkv(cfg: LlamaConfig, lp: Params, x: torch.Tensor, lora_idx,
         per_row: bool):
    b, t, _ = x.shape
    d = cfg.head_dim_
    q = _proj(lp, "wq", x, lora_idx, per_row=per_row)
    k = _proj(lp, "wk", x, lora_idx, per_row=per_row)
    v = _proj(lp, "wv", x, lora_idx, per_row=per_row)
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    return (q.reshape(b, t, cfg.num_heads, d),
            k.reshape(b, t, cfg.num_kv_heads, d),
            v.reshape(b, t, cfg.num_kv_heads, d))


def _tp_reduce(mesh: Mesh | None):
    """The row-parallel products' reduction over tp (None: one rank)."""
    if mesh is None or mesh.shape["tp"] == 1:
        return None
    return lambda y: mesh.all_reduce(y, "tp")


def _mlp(lp: Params, x: torch.Tensor, token_valid, lora_idx,
         per_row: bool, mesh: Mesh | None = None) -> torch.Tensor:
    """The dense SwiGLU feed-forward (`token_valid` is not needed: every
    token's product is its own). On a tp mesh wg / wu are column-parallel
    and wd row-parallel, reduced over tp."""
    gate = _proj(lp, "wg", x, lora_idx, per_row=per_row)
    up = _proj(lp, "wu", x, lora_idx, per_row=per_row)
    return _proj(lp, "wd", F.silu(gate) * up, lora_idx, per_row=per_row,
                 reduce=_tp_reduce(mesh))


class FeedForward(NamedTuple):
    """A family's feed-forward: the stacked leaves it adds to a layer, and
    `mlp_fn(lp, h, token_valid, lora_idx, per_row, mesh)` -> [B, T, E] (the
    reference's mlp_fn; `token_valid` [B, T] bool marks the non-padding
    tokens of a prefill or extend and is None in decode; `mesh` is the
    rank's mesh, None on one rank). `join()`, where set, takes a dp
    group's part in the collectives `mlp_fn` makes over dp when the group
    has none of a dispatch's rows (`_on_dp_rows`)."""

    names: tuple[str, ...]
    mlp_fn: Callable
    join: Callable | None = None


DENSE_FFN = FeedForward(("wg", "wu", "wd"), _mlp)


def _attn_block(cfg: LlamaConfig, lp: Params, x: torch.Tensor, positions,
                inv_freq, attn_fn, lora_idx, per_row: bool,
                mesh: Mesh | None = None):
    """Pre-norm attention sub-block: norm -> qkv -> rope -> attn_fn -> wo
    residual. `attn_fn(q, k, v)` writes the KV and attends. On a tp mesh
    `cfg` is the rank's local view (its heads), wq / wk / wv are
    column-parallel and wo row-parallel, reduced over tp."""
    b, t, _ = x.shape
    h = rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    q, k, v = _qkv(cfg, lp, h, lora_idx, per_row)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = attn_fn(q, k, v)
    return x + _proj(lp, "wo", attn.reshape(b, t, -1), lora_idx,
                     per_row=per_row, reduce=_tp_reduce(mesh))


def _layer_step(cfg: LlamaConfig, lp: Params, x: torch.Tensor, positions,
                inv_freq, attn_fn, lora_idx, per_row: bool, ffn: FeedForward,
                token_valid=None, mesh: Mesh | None = None) -> torch.Tensor:
    """One decoder layer: the attention sub-block, then the feed-forward
    residual (`ffn.mlp_fn`). `per_row`: each batch row's projections run
    alone on the card (the prefill entry points), or all rows in one
    product (decode, verify)."""
    x = _attn_block(cfg, lp, x, positions, inv_freq, attn_fn, lora_idx,
                    per_row, mesh)
    return x + ffn.mlp_fn(lp, rms_norm(x, lp["ln_mlp"], cfg.rms_eps),
                          token_valid, lora_idx, per_row, mesh)



def _lora_rows(lora_idx, dev) -> torch.Tensor | None:
    return None if lora_idx is None else lora_idx.to(device=dev,
                                                     dtype=torch.int32)


def _embed(params: Params, input_ids: torch.Tensor,
           mesh: Mesh | None = None) -> torch.Tensor:
    """The embedding rows of `input_ids`. On a tp mesh the table is
    vocab-sharded, as the reference's: a rank looks up the ids in its
    slice, zeros elsewhere, and the sum over tp (one nonzero row a token)
    gives every rank the exact rows."""
    emb = params["embed"]
    ids = input_ids.long()
    if mesh is None or mesh.shape["tp"] == 1:
        return emb[ids]
    n = emb.shape[0]
    local = ids - mesh.coord["tp"] * n
    hit = (local >= 0) & (local < n)
    rows = emb[torch.clamp(local, 0, n - 1)]
    return mesh.all_reduce(torch.where(hit[..., None], rows,
                                       torch.zeros_like(rows)), "tp")


def _unembed(cfg: LlamaConfig, params: Params, x: torch.Tensor,
             mesh: Mesh | None = None) -> torch.Tensor:
    """Final norm and vocab projection -> fp32 logits [B, V]: model-dtype
    inputs, fp32 accumulation and fp32 output, as the reference's
    preferred_element_type=float32. On the card a bf16 model takes cuBLAS's
    bf16-in/fp32-out product, so the logits are never rounded to bf16 and no
    fp32 copy of the vocab matrix is made; the CPU has no such product and
    widens the operands instead (the same values). On the card the rows go
    through the product in blocks of UNEMBED_ROWS (the last one padded with
    zero rows), so a row's logits do not depend on how many rows came with
    it. On a tp mesh the vocab matrix is this rank's vocab slice; the
    fp32 logit slices are all-gathered over tp, so every rank holds the
    same logits, bit for bit."""
    x = rms_norm(x, params["ln_final"], cfg.rms_eps)
    head = params["embed"].T if cfg.tie_word_embeddings else params["lm_head"]
    if mesh is not None and mesh.shape["tp"] > 1:
        return mesh.all_gather(_vocab_product(x, head), "tp", dim=-1)
    return _vocab_product(x, head)


def _vocab_product(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
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


def _chunk_logits(cfg: LlamaConfig, params: Params, x: torch.Tensor,
                  chunk_lens: torch.Tensor, all_logits: bool,
                  mesh: Mesh | None = None) -> torch.Tensor:
    """An extend's logits: at every chunk position [B, T, V] (a verify:
    B * T rows through the unembed's blocks), or at each chunk's last valid
    position [B, V]."""
    if all_logits:
        b, t, e = x.shape
        return _unembed(cfg, params, x.reshape(b * t, e),
                        mesh).reshape(b, t, -1)
    return _unembed(cfg, params, _last_rows(x, chunk_lens), mesh)


def _rope_freqs(cfg: LlamaConfig, device) -> torch.Tensor:
    return rope_frequencies(cfg.head_dim_, cfg.rope_theta, cfg.rope_scaling,
                            device=device)


def page_cells(block_tables: torch.Tensor, positions: torch.Tensor,
               page_size: int):
    """Physical (page, offset) of logical positions [B, T]. Table columns
    past the end clamp to the last, as the reference's gather does."""
    col = torch.clamp(positions // page_size, max=block_tables.shape[1] - 1)
    return torch.gather(block_tables, 1, col.long()), positions % page_size


# ---------------------------------------------------------------------------
# Data parallel: each dp group computes its own rows (parallel/mesh.py)
# ---------------------------------------------------------------------------

def _pool_members(pool) -> list[torch.Tensor]:
    """The tensors of a pool or slot cache (both of an int8 pair)."""
    return [pool["q"], pool["s"]] if isinstance(pool, dict) else [pool]


def _on_dp_rows(run, rows: DpRows, mesh: Mesh, batch: dict, *, tail: tuple,
                pools: tuple, cells=None, join=None):
    """An entry point at dp: `run(**batch)` on this group's rows (every
    batch tensor, or None, indexed by them; not called when the group has
    none: then `join()`, the feed-forward's, where it has one), then
    `dp_exchange`. `tail` is a row's logits shape, `cells` the (page,
    offset) [B, T] the dispatch writes in the paged layout (None in the
    dense one). Returns (the whole batch's logits, *pools)."""
    dev = next(v for v in batch.values() if v is not None).device
    if rows.mine:
        idx = rows.index(dev)
        logits, _, _ = run(**{k: None if v is None else v.to(dev)[idx]
                              for k, v in batch.items()})
    else:
        if join is not None:
            join()
        logits = torch.zeros((0, *tail), dtype=torch.float32, device=dev)
    return (dp_exchange(rows, mesh, logits, pools, cells), *pools)


def dp_exchange(rows: DpRows, mesh: Mesh, logits: torch.Tensor,
                pools: tuple = (), cells=None) -> torch.Tensor:
    """The dp exchange of one dispatch, one collective over dp: this group's
    fp32 logits [rows.mine, ...] and, with `cells` (page, offset) [B, T] of
    the dispatch's paged writes, the values its rows wrote there in every
    pool tensor (int8 codes with their scales: a copy, not a recompute).
    Every other group's cells are written into this rank's pools, so each
    rank's pool holds every page. Returns the whole batch's logits [B, ...]
    in batch order, the same bits on every rank."""
    dev = logits.device
    parts = [logits.float()]
    if cells is not None:
        page, off = (c.long() for c in cells)
        mine = rows.index(dev)
        for pool in pools:
            for t in _pool_members(pool):
                parts.append(t[:, page[mine], off[mine]].movedim(1, 0))
    got = mesh.gather_rows(parts, rows)
    full = torch.empty((len(rows.groups), *logits.shape[1:]),
                       dtype=torch.float32, device=dev)
    for g, members in enumerate(rows.members):
        if not members:
            continue
        at = rows.index(dev, g)
        full[at] = got[g][0]
        if cells is None or g == rows.me:
            continue
        vals = iter(got[g][1:])
        for pool in pools:
            for t in _pool_members(pool):
                t[:, page[at], off[at]] = next(vals).movedim(0, 1)
    return full


def dp_slot_offset(cache: torch.Tensor, mesh: Mesh | None) -> int:
    """The first slot of this rank's rows of a dense slot cache (which holds
    its dp group's slots only: slot s is local row s - offset)."""
    if mesh is None or mesh.shape["dp"] == 1:
        return 0
    return mesh.coord["dp"] * cache.shape[1]


def copy_slot_prefix(cache_k: torch.Tensor, cache_v: torch.Tensor, dst: int,
                     src: int, n: int, mesh: Mesh | None = None) -> None:
    """Copy positions [0, n) of slot `src` into slot `dst` of the dense slot
    cache (a prefix-cache hit). On a dp mesh a rank holds its group's
    slots only; a copy across groups goes over dp: the source group's rows
    reach every rank in one collective, and the target group writes
    them."""
    caches = (cache_k, cache_v)
    if mesh is None or mesh.shape["dp"] == 1:
        for c in caches:
            c[:, dst, :n].copy_(c[:, src, :n])
        return
    per, me = cache_k.shape[1], mesh.coord["dp"]
    gd, gs = dst // per, src // per
    if gd == gs:
        if me == gd:
            for c in caches:
                c[:, dst - gd * per, :n].copy_(c[:, src - gs * per, :n])
        return
    rows = DpRows([gs], mesh.shape["dp"], me)
    parts = [c[:, src - gs * per, :n][None] if me == gs
             else c.new_empty((0, c.shape[0], n, *c.shape[3:]))
             for c in caches]
    got = mesh.gather_rows(parts, rows)[gs]
    if me == gd:
        for c, v in zip(caches, got):
            c[:, dst - gd * per, :n].copy_(v[0])


def prefill_into_pages(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, T] int, right-padded
    prompt_lens: torch.Tensor,  # [B] int32
    block_tables: torch.Tensor,  # [B, PPN] int32 — target pages per prompt
    cache_k,  # [L, P, PS, K, D] — the engine's live page pool, or int8 pair
    cache_v,
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """Prefill B prompts and scatter their KV through the block tables into
    the global page pool. Returns (last_logits [B, V] fp32, cache_k,
    cache_v), the pools updated in place. `dp_rows`: this dp group's rows
    only, then the dp exchange (`_on_dp_rows`).

    HANDOFF CONTRACT (kept from the reference): row i of `last_logits` is the
    FINAL-position logits of prompt i, and every KV row lands at its absolute
    token position. The first token samples from exactly this logits row,
    and position-exact KV is what lets a later chunk or decode step continue
    the sequence token-identically."""
    b, t = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    page, off = page_cells(block_tables, positions,
                           pool_shape(cache_k)[2])
    if dp_rows is not None:
        return _on_dp_rows(
            lambda ids, lens, tables, lora: prefill_into_pages(
                params, cfg, ids, lens, tables, cache_k, cache_v, lora,
                ffn=ffn, mesh=mesh),
            dp_rows, mesh, dict(ids=input_ids, lens=prompt_lens,
                                tables=block_tables, lora=lora_idx),
            tail=(cfg.vocab_size,), pools=(cache_k, cache_v),
            cells=(page, off), join=ffn.join)
    inv_freq = _rope_freqs(cfg, dev)
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    token_valid = positions < prompt_lens[:, None]
    lora_idx = _lora_rows(lora_idx, dev)

    x = _embed(params, input_ids, mesh)  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_pool(_pool_layer(cache_k, i), page, off, k)
            _write_pool(_pool_layer(cache_v, i), page, off, v)
            return gqa_attention_prefill(q, k, v, prompt_lens)

        x = _layer_step(cfg, _layer(params, cfg, i, ffn.names), x, positions,
                        inv_freq, attn_fn, lora_idx, True, ffn, token_valid,
                        mesh)

    logits = _unembed(cfg, params, _last_rows(x, prompt_lens), mesh)
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
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """Paged chunked prefill: append a chunk of prompt tokens to rows that
    already hold `start_pos` tokens, attending over everything so far
    through the block tables. Padding tokens write garbage past the chunk —
    into the row's own later pages or the trash page, never another row's
    cells. Returns (chunk-last logits [B, V] fp32, cache_k, cache_v)."""
    return _extend_pages(params, cfg, input_ids, chunk_lens, start_pos,
                         block_tables, cache_k, cache_v, lora_idx,
                         all_logits=False, per_row=True, ffn=ffn,
                         mesh=mesh, dp_rows=dp_rows)


def verify_step_paged(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, K+1] int — last committed token + drafts
    chunk_lens: torch.Tensor,  # [B] int32 — 1 + draft count per row
    start_pos: torch.Tensor,  # [B] int32 — committed tokens in its pages
    block_tables: torch.Tensor,  # [B, PPN] int32
    cache_k,  # [L, P, PS, K, D], or an int8 {"q", "s"} pair
    cache_v,
    window: int | None = None,  # context-window bucket (>= max start + K + 1)
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """Paged speculative verification: one extend over every row scores the
    last committed token plus up to K drafts and returns the logits at EVERY
    chunk position, [B, K+1, V] fp32, so the scheduler can sample each
    position and accept the longest matching draft prefix. The KV of every
    chunk position is written; a rejected suffix's cells become garbage past
    the rolled-back length. The attention is paged_flash_extend (int8 pools:
    paged_flash_extend_quant) at T = K+1, and the projections take one
    product of all B * (K+1) rows, as a decode step does. `window` is the
    reference's static bucket: the extend kernel sweeps each row only to its
    chunk's last position, so on the card it bounds nothing more."""
    del window
    return _extend_pages(params, cfg, input_ids, chunk_lens, start_pos,
                         block_tables, cache_k, cache_v, lora_idx,
                         all_logits=True, per_row=False, ffn=ffn,
                         mesh=mesh, dp_rows=dp_rows)


def _extend_pages(params, cfg, input_ids, chunk_lens, start_pos, block_tables,
                  cache_k, cache_v, lora_idx, *, all_logits: bool,
                  per_row: bool, ffn: FeedForward, mesh: Mesh | None = None,
                  dp_rows: DpRows | None = None):
    """The body of prefill_extend_pages and verify_step_paged:
    `all_logits` returns [B, T, V] (every chunk position) in place of the
    chunk-last [B, V]; `per_row` groups the projections (`_rowwise`)."""
    b, t = input_ids.shape
    dev = input_ids.device
    ps = pool_shape(cache_k)[2]
    capacity = block_tables.shape[1] * ps
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    chunk_lens = chunk_lens.to(device=dev, dtype=torch.int32)
    offs = torch.arange(t, device=dev, dtype=torch.int32)[None, :]
    positions = start_pos[:, None] + offs
    page, off = page_cells(block_tables,
                           torch.clamp(positions, max=capacity - 1), ps)
    if dp_rows is not None:
        return _on_dp_rows(
            lambda ids, lens, start, tables, lora: _extend_pages(
                params, cfg, ids, lens, start, tables, cache_k, cache_v, lora,
                all_logits=all_logits, per_row=per_row, ffn=ffn, mesh=mesh),
            dp_rows, mesh, dict(ids=input_ids, lens=chunk_lens,
                                start=start_pos, tables=block_tables,
                                lora=lora_idx),
            tail=((t, cfg.vocab_size) if all_logits else (cfg.vocab_size,)),
            pools=(cache_k, cache_v), cells=(page, off), join=ffn.join)
    inv_freq = _rope_freqs(cfg, dev)
    token_valid = offs < chunk_lens[:, None]
    lora_idx = _lora_rows(lora_idx, dev)

    x = _embed(params, input_ids, mesh)  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            ck, cv = _pool_layer(cache_k, i), _pool_layer(cache_v, i)
            _write_pool(ck, page, off, k)
            _write_pool(cv, page, off, v)
            return paged_attention_extend(q, ck, cv, block_tables, positions,
                                          chunk_lens)

        x = _layer_step(cfg, _layer(params, cfg, i, ffn.names), x, positions,
                        inv_freq, attn_fn, lora_idx, per_row, ffn, token_valid,
                        mesh)

    logits = _chunk_logits(cfg, params, x, chunk_lens, all_logits, mesh)
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
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
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
    write_pos = torch.clamp(seq_lens.to(device=dev, dtype=torch.int32),
                            max=capacity - 1)
    positions = write_pos[:, None]  # [B, 1]
    page, off = page_cells(block_tables, positions, ps)
    if dp_rows is not None:
        return _on_dp_rows(
            lambda ids, lens, tables, lora: decode_step_paged(
                params, cfg, ids, lens, cache_k, cache_v, tables, window,
                lora, ffn=ffn, mesh=mesh),
            dp_rows, mesh, dict(ids=input_ids, lens=seq_lens,
                                tables=block_tables, lora=lora_idx),
            tail=(cfg.vocab_size,), pools=(cache_k, cache_v),
            cells=(page, off), join=ffn.join)
    inv_freq = _rope_freqs(cfg, dev)
    kv_lens = (write_pos + 1).to(torch.int32)
    lora_idx = _lora_rows(lora_idx, dev)

    x = _embed(params, input_ids, mesh)[:, None, :]  # [B, 1, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            ck, cv = _pool_layer(cache_k, i), _pool_layer(cache_v, i)
            _write_pool(ck, page, off, k)
            _write_pool(cv, page, off, v)
            return paged_attention_decode(q, ck, cv, block_tables, kv_lens,
                                          window=window)

        x = _layer_step(cfg, _layer(params, cfg, i, ffn.names), x, positions,
                        inv_freq, attn_fn, lora_idx, False, ffn, None, mesh)

    logits = _unembed(cfg, params, x[:, 0], mesh)
    return logits, cache_k, cache_v


def encode(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, T] int, right-padded
    prompt_lens: torch.Tensor,  # [B] int32
    *,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Text-embedding forward (/v1/embeddings), the reference's `encode`: a
    full pass that writes no KV (attention through gqa_attention_prefill,
    flash_prefill on the card), the final norm in fp32, a mean over each
    row's valid positions, then an L2 normalisation. Returns [B, E] fp32.
    Each row's mean and norm are reduced over that row alone (a reduction
    over [B, E] rounds by B on the card), so, with the products per row
    (`_rowwise`), a row's vector does not depend on the other rows of the
    batch."""
    b, t = input_ids.shape
    dev = input_ids.device
    inv_freq = _rope_freqs(cfg, dev)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)

    def attn_fn(q, k, v):
        return gqa_attention_prefill(q, k, v, prompt_lens)

    x = _embed(params, input_ids, mesh)  # [B, T, E]
    for i in range(cfg.num_layers):
        x = _layer_step(cfg, _layer(params, cfg, i, DENSE_FFN.names), x,
                        positions, inv_freq, attn_fn, None, True, DENSE_FFN,
                        None, mesh)
    x = rms_norm(x, params["ln_final"], cfg.rms_eps).float()
    out = []
    for r, n in enumerate(prompt_lens.tolist()):
        pooled = x[r, :n].sum(0) / max(n, 1)
        out.append(pooled / torch.clamp(torch.linalg.vector_norm(pooled),
                                        min=1e-9))
    return torch.stack(out)


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
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """Prefill B prompts (flash_prefill over their fresh K/V) and scatter
    their KV into rows `slot_ids` of the live slot cache, positions 0..T-1.
    Returns (last_logits [B, V] fp32, cache_k, cache_v), the caches updated
    in place. Padding rows that repeat a slot write identical cells.
    `dp_rows`: this group's rows only, into its own slots' rows."""
    if dp_rows is not None:
        base = dp_slot_offset(cache_k, mesh)
        return _on_dp_rows(
            lambda ids, lens, slots, lora: prefill_into_slots(
                params, cfg, ids, lens, slots - base, cache_k, cache_v, lora,
                ffn=ffn, mesh=mesh),
            dp_rows, mesh, dict(ids=input_ids, lens=prompt_lens,
                                slots=slot_ids.to(input_ids.device),
                                lora=lora_idx),
            tail=(cfg.vocab_size,), pools=(cache_k, cache_v), join=ffn.join)
    b, t = input_ids.shape
    dev = input_ids.device
    inv_freq = _rope_freqs(cfg, dev)
    positions = torch.arange(t, device=dev)[None, :].expand(b, t)
    rows = slot_ids.to(dev)[:, None].expand(b, t)
    prompt_lens = prompt_lens.to(device=dev, dtype=torch.int32)
    token_valid = positions < prompt_lens[:, None]
    lora_idx = _lora_rows(lora_idx, dev)

    x = _embed(params, input_ids, mesh)  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_slots(cache_k[i], rows, positions, k)
            _write_slots(cache_v[i], rows, positions, v)
            return gqa_attention_prefill(q, k, v, prompt_lens)

        x = _layer_step(cfg, _layer(params, cfg, i, ffn.names), x, positions,
                        inv_freq, attn_fn, lora_idx, True, ffn, token_valid,
                        mesh)

    logits = _unembed(cfg, params, _last_rows(x, prompt_lens), mesh)
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
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """Dense chunked prefill: append a chunk of prompt tokens to slots that
    already hold `start_pos` tokens. Each layer writes the chunk's K/V into
    the slot rows (positions clamped into the row, as the reference), gathers
    those rows (`ck[slot_ids]`) and runs flash_extend over them. Padding
    tokens write garbage past the chunk, in cells later attention masks and
    the sequence overwrites as it grows. Returns (chunk-last logits [B, V]
    fp32, cache_k, cache_v)."""
    return _extend_slots(params, cfg, input_ids, chunk_lens, start_pos,
                         slot_ids, cache_k, cache_v, lora_idx,
                         all_logits=False, per_row=True, ffn=ffn,
                         mesh=mesh, dp_rows=dp_rows)


def verify_step(
    params: Params,
    cfg: LlamaConfig,
    input_ids: torch.Tensor,  # [B, K+1] int — last committed token + drafts
    chunk_lens: torch.Tensor,  # [B] int32 — 1 + draft count per row
    start_pos: torch.Tensor,  # [B] int32 — committed tokens in its row
    slot_ids: torch.Tensor | None,  # [B] int — rows; None: row b is slot b
    cache_k: torch.Tensor,  # [L, NUM_SLOTS, CAP, K, D]
    cache_v: torch.Tensor,
    window: int | None = None,  # context-window bucket (>= max start + K + 1)
    lora_idx: torch.Tensor | None = None,  # [B] int32 adapter pool rows
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """Speculative verification over the dense slot cache: verify_step_paged's
    contract with flash_extend at T = K+1 over the slot rows. The engine
    passes every slot in order (`slot_ids=None`, the reference's arange), so
    the kernel reads the cache's own rows and no row is gathered. `window`
    bounds nothing more on the card (flash_extend sweeps each row to its
    chunk's last position)."""
    del window
    return _extend_slots(params, cfg, input_ids, chunk_lens, start_pos,
                         slot_ids, cache_k, cache_v, lora_idx,
                         all_logits=True, per_row=False, ffn=ffn,
                         mesh=mesh, dp_rows=dp_rows)


def _extend_slots(params, cfg, input_ids, chunk_lens, start_pos, slot_ids,
                  cache_k, cache_v, lora_idx, *, all_logits: bool,
                  per_row: bool, ffn: FeedForward, mesh: Mesh | None = None,
                  dp_rows: DpRows | None = None):
    """The body of prefill_extend_slots and verify_step (see
    `_extend_pages`); `slot_ids=None` takes the cache rows in order (at
    dp: this group's rows are its slots, the local rows in order)."""
    b, t = input_ids.shape
    if dp_rows is not None:
        base = dp_slot_offset(cache_k, mesh)
        return _on_dp_rows(
            lambda ids, lens, start, slots, lora: _extend_slots(
                params, cfg, ids, lens, start,
                None if slots is None else slots - base, cache_k, cache_v,
                lora, all_logits=all_logits, per_row=per_row, ffn=ffn,
                mesh=mesh),
            dp_rows, mesh, dict(ids=input_ids, lens=chunk_lens,
                                start=start_pos,
                                slots=(None if slot_ids is None else
                                       slot_ids.to(input_ids.device).long()),
                                lora=lora_idx),
            tail=((t, cfg.vocab_size) if all_logits else (cfg.vocab_size,)),
            pools=(cache_k, cache_v), join=ffn.join)
    dev = input_ids.device
    capacity = cache_k.shape[2]
    inv_freq = _rope_freqs(cfg, dev)
    start_pos = start_pos.to(device=dev, dtype=torch.int32)
    chunk_lens = chunk_lens.to(device=dev, dtype=torch.int32)
    offs = torch.arange(t, device=dev, dtype=torch.int32)[None, :]
    positions = start_pos[:, None] + offs
    token_valid = offs < chunk_lens[:, None]
    write_pos = torch.clamp(positions, max=capacity - 1)
    slots = (torch.arange(b, device=dev) if slot_ids is None
             else slot_ids.to(dev).long())
    rows = slots[:, None].expand(b, t)
    lora_idx = _lora_rows(lora_idx, dev)

    def cache_rows(cache):
        return cache if slot_ids is None else cache[slots]

    x = _embed(params, input_ids, mesh)  # [B, T, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_slots(cache_k[i], rows, write_pos, k)
            _write_slots(cache_v[i], rows, write_pos, v)
            return gqa_attention_extend(q, cache_rows(cache_k[i]),
                                        cache_rows(cache_v[i]), positions,
                                        chunk_lens)

        x = _layer_step(cfg, _layer(params, cfg, i, ffn.names), x, positions,
                        inv_freq, attn_fn, lora_idx, per_row, ffn, token_valid,
                        mesh)

    logits = _chunk_logits(cfg, params, x, chunk_lens, all_logits, mesh)
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
    *,
    ffn: FeedForward = DENSE_FFN,
    mesh: Mesh | None = None,
    dp_rows: DpRows | None = None,
):
    """One dense decode step across all slots. Returns (logits [B, V] fp32,
    cache_k, cache_v). Each layer writes slot b's one-token KV at
    min(seq_lens[b], cap - 1) (freed slots keep counting; the clamp keeps
    their garbage in their own row) before flash_decode reads the row over
    `window` cells. At dp a rank's rows are its group's slots, which its
    cache holds in order."""
    if dp_rows is not None:
        return _on_dp_rows(
            lambda ids, lens, lora: decode_step(
                params, cfg, ids, lens, cache_k, cache_v, window, lora,
                ffn=ffn, mesh=mesh),
            dp_rows, mesh, dict(ids=input_ids, lens=seq_lens, lora=lora_idx),
            tail=(cfg.vocab_size,), pools=(cache_k, cache_v), join=ffn.join)
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

    x = _embed(params, input_ids, mesh)[:, None, :]  # [B, 1, E]
    for i in range(cfg.num_layers):
        def attn_fn(q, k, v, i=i):
            _write_slots(cache_k[i], rows, write_pos, k[:, 0])
            _write_slots(cache_v[i], rows, write_pos, v[:, 0])
            return gqa_attention_decode(q, cache_k[i], cache_v[i], kv_lens,
                                        window=window)

        x = _layer_step(cfg, _layer(params, cfg, i, ffn.names), x, positions,
                        inv_freq, attn_fn, lora_idx, False, ffn, None, mesh)

    logits = _unembed(cfg, params, x[:, 0], mesh)
    return logits, cache_k, cache_v


# ---------------------------------------------------------------------------
# Context-parallel prefill: the sequence split over the mesh's sp axis
# ---------------------------------------------------------------------------

def scatter_prefill_kv(cache_k, cache_v, k_all: torch.Tensor,
                       v_all: torch.Tensor, *,
                       block_table: torch.Tensor | None = None,
                       slot: int | None = None) -> None:
    """Write one prompt's K/V [L, 1, n, K, D] (positions 0..n-1) into the
    caches in place: through a slot's block-table row [PPN] into the page
    pool (an int8 pair quantizes on write), or into row `slot` of the dense
    slot cache."""
    n = k_all.shape[2]
    if block_table is not None:
        pos = torch.arange(n, device=k_all.device)[None]
        page, off = page_cells(block_table[None], pos,
                               pool_shape(cache_k)[2])
        for i in range(k_all.shape[0]):
            _write_pool(_pool_layer(cache_k, i), page, off, k_all[i])
            _write_pool(_pool_layer(cache_v, i), page, off, v_all[i])
        return
    cache_k[:, slot, :n] = k_all[:, 0].to(cache_k.dtype)
    cache_v[:, slot, :n] = v_all[:, 0].to(cache_v.dtype)


def make_context_parallel_prefill(cfg: LlamaConfig, mesh: Mesh):
    """Long-context prefill with the token axis split over `sp` ranks
    (ring attention, ops/ring_attention.py): the reference's
    `make_context_parallel_prefill`. `cfg` is the rank's local view (a tp
    mesh's share of the heads).

    Returns `fn(params, input_ids [B, T], prompt_lens [B]) -> (last_logits
    [B, V] fp32, k_all [L, B, T, K, D], v_all)`, T a multiple of sp. Each
    rank embeds, projects and normalises its own T/sp tokens; attention
    runs through the ring; each layer's K/V chunks are all-gathered over
    sp, since the engine's cache is replicated over sp. The last token's
    hidden row comes from the rank that holds position n - 1 (the sum over
    sp of one nonzero row: exact), and every rank unembeds it."""
    from llmlb_tpu_torch.ops.ring_attention import ring_prefill_attention

    sp = mesh.shape["sp"]

    def fn(params: Params, input_ids: torch.Tensor, prompt_lens: torch.Tensor):
        b, t = input_ids.shape
        if t % sp:
            raise ValueError(f"seq len {t} not divisible by sp={sp}")
        c = t // sp
        dev = input_ids.device
        r = mesh.coord["sp"]
        lens = prompt_lens.to(device=dev, dtype=torch.int32)
        inv_freq = _rope_freqs(cfg, dev)
        positions = (r * c + torch.arange(c, device=dev))[None, :].expand(b, c)
        ids = input_ids[:, r * c:(r + 1) * c]
        token_valid = positions < lens[:, None]
        ks, vs = [], []
        x = _embed(params, ids, mesh)  # [B, C, E]
        for i in range(cfg.num_layers):
            def attn_fn(q, k, v):
                ks.append(mesh.all_gather(k, "sp", dim=1))
                vs.append(mesh.all_gather(v, "sp", dim=1))
                return ring_prefill_attention(q, k, v, lens, mesh, seq_len=t)

            x = _layer_step(cfg, _layer(params, cfg, i), x, positions,
                            inv_freq, attn_fn, None, True, DENSE_FFN,
                            token_valid, mesh)
        last = lens.long() - 1 - r * c
        mine = (last >= 0) & (last < c)
        rows = x[torch.arange(b, device=dev), torch.clamp(last, 0, c - 1)]
        x_last = mesh.all_reduce(
            torch.where(mine[:, None], rows, torch.zeros_like(rows)), "sp")
        logits = _unembed(cfg, params, x_last, mesh)
        return (logits, torch.stack(ks).to(cfg.dtype),
                torch.stack(vs).to(cfg.dtype))

    return fn
