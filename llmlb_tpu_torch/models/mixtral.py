"""Mixtral-family sparse-MoE decoder (Mixtral-8x7B, Qwen-MoE-class):
counterpart of `llmlb_tpu/models/mixtral.py`.

The Llama skeleton of `models/llama.py` (the same attention, KV layouts and
entry points) with the dense SwiGLU swapped for top-k routed experts
(`ops/moe.py`), passed to llama's entry points as their `ffn`. Leaves as the
reference's: `router` [L, E, X], `we_gate` / `we_up` [L, X, E, F], `we_down`
[L, X, F, E], and with int8 experts `<name>_scale` [L, X, out].

Two regimes, chosen per call from the padded shape, as the reference
chooses them:

- exact (every expert on every token, `moe_dense_exact`) when B * T <= 4 *
  num_experts, and ALWAYS in decode and verify: a row's tokens then never
  depend on which other rows share the batch;
- capacity dispatch (`moe_dispatch_combine`) for larger prefill and extend
  groups, at default_capacity of the padded B * T, with `token_valid`
  keeping padding out of the capacity contest. The router and the expert
  buffers see the whole group, so a row prefilled alone and in a group (or
  a prefix hit's suffix and its cold run) may differ where a token was
  dropped, as in the reference.

At dp > 1 a dp group computes only its own rows of a dispatch (llama.py
`_on_dp_rows`), but the regime and the capacity dispatch stay the whole
dispatch's, as the reference's GSPMD program runs its capacity scan over
the flattened B * T whatever shards the batch (its expert buffers are
sharded over ep only, so replicated over dp). When a capacity dispatch's
rows span more than one dp group, each MoE layer gathers every group's
normed hidden rows and `token_valid` over dp in batch order (one
collective, `Mesh.gather_batch`), every rank runs the whole batch's
dispatch at the whole batch's capacity, and keeps its own rows of the
output; a group with no rows of the dispatch joins those gathers with none
(`_join_gathers`). When every row is in one group that group's rows are
the whole batch, so it runs alone as on one rank. Which (token, choice)
pairs are dropped is then the one-rank engine's, whatever the split.

The router product runs in the model dtype (bf16 on the card, then fp32
for the top-k), per row in a prefill group like the projections
(`_rowwise`). Adapters (LoRA) apply to the attention projections only: the
expert FFNs carry no pools. There is no `encode`: the family serves no
embeddings.

On a mesh the experts are split over `ep` and each expert's ffn width over
`tp` (the reference's `param_logical_axes`); the router is replicated, so
every rank routes every token and runs its own experts' share, and the
partial sums are reduced over ep and tp (ops/moe.py).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from llmlb_tpu_torch.models import llama
from llmlb_tpu_torch.models.llama import (  # noqa: F401  (the family's API)
    FeedForward,
    LlamaConfig,
    Params,
    _rowwise,
    copy_slot_prefix,
    fill_params,
    init_kv_cache,
    init_kv_pages,
    local_config,
    scatter_prefill_kv,
    shard_rules_for,
)
from llmlb_tpu_torch.ops.moe import (
    default_capacity,
    moe_dense_exact,
    moe_dispatch_combine,
)
from llmlb_tpu_torch.parallel.mesh import DpRows, Mesh
from llmlb_tpu_torch.parallel.sharding import ShardingRules
from llmlb_tpu_torch.quant import SCALE_SUFFIX

EXPERT_NAMES = ("we_gate", "we_up", "we_down")
# the leaves a layer adds to the attention's (llama._layer's ffn_names)
FFN_NAMES = ("router",) + EXPERT_NAMES
# The family's facts (llama.py's contract): adapters pool the attention's
# projections only, as the reference's MoE engine; the HF names of the
# router and the experts (`{e}`: per expert; w1 / w3 / w2 are gate / up /
# down); the capacity dispatch couples the rows of a prefill group.
LORA_TARGETS = ("wq", "wk", "wv", "wo")
HF_FFN_NAMES = {
    "router": "block_sparse_moe.gate.weight",
    "we_gate": "block_sparse_moe.experts.{e}.w1.weight",
    "we_up": "block_sparse_moe.experts.{e}.w3.weight",
    "we_down": "block_sparse_moe.experts.{e}.w2.weight",
}
PREFILL_COUPLES_ROWS = True


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25

    @classmethod
    def from_hf_config(cls, hf: dict, dtype=torch.bfloat16) -> "MixtralConfig":
        base = LlamaConfig.from_hf_config(hf, dtype)
        fields = {f.name: getattr(base, f.name)
                  for f in dataclasses.fields(base)}
        return cls(
            **fields,
            num_experts=hf.get("num_local_experts", hf.get("num_experts", 8)),
            experts_per_token=hf.get("num_experts_per_tok", 2),
        )


def hf_config_fields(cfg: MixtralConfig) -> dict:
    """The keys of a HF `config.json` this family adds to the dense ones,
    which from_hf_config reads back."""
    return {"architectures": ["MixtralForCausalLM"], "model_type": "mixtral",
            "num_local_experts": cfg.num_experts,
            "num_experts_per_tok": cfg.experts_per_token}


def param_shapes(cfg: MixtralConfig, quantized: tuple[str, ...] = ()
                 ) -> dict[str, tuple[tuple[int, ...], int]]:
    """Leaf name -> (shape, fan_in), llama.param_shapes' contract: the
    attention, norm and vocab leaves of the dense family, the router and
    the stacked experts in place of wg / wu / wd. A quantized expert's
    scale is [L, X, out]."""
    shapes = llama.param_shapes(cfg)
    for name in ("wg", "wu", "wd"):
        del shapes[name]
    e, f, n, x = (cfg.hidden_size, cfg.intermediate_size, cfg.num_layers,
                  cfg.num_experts)
    shapes.update({
        "router": ((n, e, x), e),
        "we_gate": ((n, x, e, f), e),
        "we_up": ((n, x, e, f), e),
        "we_down": ((n, x, f, e), f),
    })
    for name in quantized:
        shape = shapes[name][0]
        shapes[name + SCALE_SUFFIX] = (shape[:-2] + shape[-1:], 0)
    return shapes


def init_params(cfg: MixtralConfig, generator: torch.Generator,
                device: torch.device | str,
                quantize_weights: bool = False,
                mesh: Mesh | None = None) -> Params:
    """Random init, llama.init_params' scheme, one [in, out] matrix (a
    layer's expert) at a time. With `quantize_weights` every projection and
    expert is int8 from its first block on, so Mixtral-8x7B's 93 GB of bf16
    never exists on the card: its int8 leaves are ~47 GB. With a `mesh`
    each rank keeps its shard of each leaf as it is filled."""
    if mesh is not None and not mesh.trivial:
        _check_ep(cfg, mesh)
    return fill_params(param_shapes, cfg, generator, device,
                       quantize_weights,
                       keep=llama._sharder(cfg, mesh, param_logical_axes(cfg)))


def param_logical_axes(cfg: MixtralConfig) -> dict[str, tuple]:
    """Logical sharding axes per leaf, the reference's: the dense family's
    attention, norm and vocab leaves, the router replicated, the experts
    over `experts` (ep) and their width over `ffn` (tp)."""
    axes = llama.param_logical_axes(cfg)
    for name in ("wg", "wu", "wd"):
        for suffix in ("", SCALE_SUFFIX, "_lora_a", "_lora_b"):
            axes.pop(name + suffix, None)
    axes.update({
        "router": ("layers", "embed", None),
        "we_gate": ("layers", "experts", "embed", "ffn"),
        "we_up": ("layers", "experts", "embed", "ffn"),
        "we_down": ("layers", "experts", "ffn", "embed"),
    })
    for name in EXPERT_NAMES:
        w_axes = axes[name]
        axes[name + SCALE_SUFFIX] = (w_axes[0], w_axes[1], w_axes[3])
    return axes


def param_shardings(cfg: MixtralConfig, mesh: Mesh,
                    rules: ShardingRules | None = None
                    ) -> dict[str, tuple[str | None, ...]]:
    """Leaf name -> the mesh axis of each dim (llama.param_shardings)."""
    rules = rules or shard_rules_for(cfg, mesh.shape["tp"])
    return {name: rules.spec(*axes)
            for name, axes in param_logical_axes(cfg).items()}


def shard_params(params: Params, cfg: MixtralConfig, mesh: Mesh) -> Params:
    """This rank's leaves (llama.shard_params, by this family's axes)."""
    _check_ep(cfg, mesh)
    return llama.shard_params(params, cfg, mesh, param_logical_axes(cfg))


def _check_ep(cfg: MixtralConfig, mesh: Mesh) -> None:
    if cfg.num_experts % mesh.shape["ep"]:
        raise ValueError(f"num_experts={cfg.num_experts} not divisible by "
                         f"ep={mesh.shape['ep']}")


def _moe_mlp(cfg: MixtralConfig, lp: Params, h: torch.Tensor, token_valid,
             lora_idx, per_row: bool, mesh: Mesh | None = None, *,
             exact: bool, dp: DpRows | None = None) -> torch.Tensor:
    """h [B, T, E] -> [B, T, E] through the routed experts (`lora_idx` is
    not used: the experts carry no adapter pools), inside a profiler range
    named "moe" (profile_step's `moe` kind). `dp`: the rows of a capacity
    dispatch that spans dp groups (h holds this group's)."""
    with torch.profiler.record_function("moe"):
        return _moe_layer(cfg, lp, h, token_valid, per_row, exact, mesh, dp)


def _moe_layer(cfg: MixtralConfig, lp: Params, h: torch.Tensor, token_valid,
               per_row: bool, exact: bool, mesh: Mesh | None = None,
               dp: DpRows | None = None) -> torch.Tensor:
    if dp is not None:
        # every group's rows in batch order: the one-rank dispatch's tokens,
        # capacity and priority on every rank; this group keeps its rows
        h_all, valid_all = mesh.gather_batch([h, token_valid], dp)
        out = _moe_layer(cfg, lp, h_all, valid_all, per_row, exact, mesh)
        return out[dp.index(h.device)]
    b, t, m = h.shape
    s = b * t
    router = lp["router"]
    logits = _rowwise(h, lambda x2, out: torch.mm(x2, router, out=out),
                      cfg.num_experts, h.dtype, per_row).reshape(s, -1)
    scales = {f"w_{k}_scale": lp.get(f"we_{k}{SCALE_SUFFIX}")
              for k in ("gate", "up", "down")}
    flat = h.reshape(s, m)
    split = {}
    if mesh is not None and not mesh.trivial:
        split["expert_offset"] = mesh.coord["ep"] * lp["we_gate"].shape[0]
        axes = ("ep", "tp") if exact else "ep"
        split["reduce"] = lambda y: mesh.all_reduce(y, axes)
        if not exact:
            split["reduce_ffn"] = lambda y: mesh.all_reduce(y, "tp")
    if exact:
        out = moe_dense_exact(flat, logits, lp["we_gate"], lp["we_up"],
                              lp["we_down"],
                              num_selected=cfg.experts_per_token, **scales,
                              **split)
    else:
        cap = default_capacity(s, cfg.num_experts, cfg.experts_per_token,
                               cfg.capacity_factor)
        out = moe_dispatch_combine(
            flat, logits, lp["we_gate"], lp["we_up"], lp["we_down"],
            num_selected=cfg.experts_per_token, capacity=cap,
            token_valid=token_valid.reshape(s), **scales, **split)
    return out.reshape(b, t, m)


def moe_ffn(cfg: MixtralConfig, exact: bool) -> FeedForward:
    """The family's feed-forward for llama's entry points, in one regime."""
    return FeedForward(FFN_NAMES, partial(_moe_mlp, cfg, exact=exact))


def _group_ffn(cfg: MixtralConfig, params: Params, input_ids: torch.Tensor,
               dp_rows: DpRows | None, mesh: Mesh | None) -> FeedForward:
    """A prefill or extend group's regime, from the whole dispatch's padded
    B * T (`input_ids` before any dp group takes its rows): exact when it
    is at most 4 * num_experts, capacity dispatch otherwise. A capacity
    dispatch whose rows span dp groups gathers each layer's tokens over dp
    (the module's docstring); one whose rows are all in one group runs on
    that group alone, its rows being the whole batch."""
    b, t = input_ids.shape
    exact = b * t <= 4 * cfg.num_experts
    if exact or dp_rows is None or sum(map(bool, dp_rows.members)) < 2:
        return moe_ffn(cfg, exact)
    return FeedForward(
        FFN_NAMES, partial(_moe_mlp, cfg, exact=False, dp=dp_rows),
        join=partial(_join_gathers, cfg, mesh, dp_rows, t,
                     params["embed"].dtype, input_ids.device))


def _join_gathers(cfg: MixtralConfig, mesh: Mesh, dp: DpRows, t: int, dtype,
                  device) -> None:
    """A dp group with none of a spanning capacity dispatch's rows: its
    part, with no rows, in each MoE layer's gather of hidden rows [0, T, M]
    (the model's dtype) and token_valid [0, T], so the other groups'
    collectives complete."""
    h = torch.empty((0, t, cfg.hidden_size), dtype=dtype, device=device)
    valid = torch.empty((0, t), dtype=torch.bool, device=device)
    for _ in range(cfg.num_layers):
        mesh.gather_rows([h, valid], dp)


# ---------------------------------------------------------------------------
# Entry points: llama's contracts, see there
# ---------------------------------------------------------------------------

def prefill_into_pages(params, cfg: MixtralConfig, input_ids, prompt_lens,
                       block_tables, cache_k, cache_v, lora_idx=None, *,
                       mesh=None, dp_rows=None):
    return llama.prefill_into_pages(
        params, cfg, input_ids, prompt_lens, block_tables, cache_k, cache_v,
        lora_idx, ffn=_group_ffn(cfg, params, input_ids, dp_rows, mesh),
        mesh=mesh, dp_rows=dp_rows)


def prefill_extend_pages(params, cfg: MixtralConfig, input_ids, chunk_lens,
                         start_pos, block_tables, cache_k, cache_v,
                         lora_idx=None, *, mesh=None, dp_rows=None):
    return llama.prefill_extend_pages(
        params, cfg, input_ids, chunk_lens, start_pos, block_tables, cache_k,
        cache_v, lora_idx,
        ffn=_group_ffn(cfg, params, input_ids, dp_rows, mesh), mesh=mesh,
        dp_rows=dp_rows)


def verify_step_paged(params, cfg: MixtralConfig, input_ids, chunk_lens,
                      start_pos, block_tables, cache_k, cache_v, window=None,
                      lora_idx=None, *, mesh=None, dp_rows=None):
    """Exact MoE, as decode: capacity drops would make a draft's acceptance
    depend on which other rows share the step."""
    return llama.verify_step_paged(params, cfg, input_ids, chunk_lens,
                                   start_pos, block_tables, cache_k, cache_v,
                                   window, lora_idx,
                                   ffn=moe_ffn(cfg, exact=True), mesh=mesh,
                                   dp_rows=dp_rows)


def decode_step_paged(params, cfg: MixtralConfig, input_ids, seq_lens,
                      cache_k, cache_v, block_tables, window=None,
                      lora_idx=None, *, mesh=None, dp_rows=None):
    """Always exact MoE: a row's tokens do not depend on the batch."""
    return llama.decode_step_paged(params, cfg, input_ids, seq_lens, cache_k,
                                   cache_v, block_tables, window, lora_idx,
                                   ffn=moe_ffn(cfg, exact=True), mesh=mesh,
                                   dp_rows=dp_rows)


def prefill_into_slots(params, cfg: MixtralConfig, input_ids, prompt_lens,
                       slot_ids, cache_k, cache_v, lora_idx=None, *,
                       mesh=None, dp_rows=None):
    return llama.prefill_into_slots(
        params, cfg, input_ids, prompt_lens, slot_ids, cache_k, cache_v,
        lora_idx, ffn=_group_ffn(cfg, params, input_ids, dp_rows, mesh),
        mesh=mesh, dp_rows=dp_rows)


def prefill_extend_slots(params, cfg: MixtralConfig, input_ids, chunk_lens,
                         start_pos, slot_ids, cache_k, cache_v,
                         lora_idx=None, *, mesh=None, dp_rows=None):
    return llama.prefill_extend_slots(
        params, cfg, input_ids, chunk_lens, start_pos, slot_ids, cache_k,
        cache_v, lora_idx,
        ffn=_group_ffn(cfg, params, input_ids, dp_rows, mesh), mesh=mesh,
        dp_rows=dp_rows)


def verify_step(params, cfg: MixtralConfig, input_ids, chunk_lens, start_pos,
                slot_ids, cache_k, cache_v, window=None, lora_idx=None, *,
                mesh=None, dp_rows=None):
    """Exact MoE, as verify_step_paged."""
    return llama.verify_step(params, cfg, input_ids, chunk_lens, start_pos,
                             slot_ids, cache_k, cache_v, window, lora_idx,
                             ffn=moe_ffn(cfg, exact=True), mesh=mesh,
                             dp_rows=dp_rows)


def decode_step(params, cfg: MixtralConfig, input_ids, seq_lens, cache_k,
                cache_v, window=None, lora_idx=None, *, mesh=None,
                dp_rows=None):
    """Always exact MoE, as decode_step_paged."""
    return llama.decode_step(params, cfg, input_ids, seq_lens, cache_k,
                             cache_v, window, lora_idx,
                             ffn=moe_ffn(cfg, exact=True), mesh=mesh,
                             dp_rows=dp_rows)
