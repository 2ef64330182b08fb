"""Mixture-of-experts layer: the port's own copy of `llmlb_tpu/ops/moe.py`.

Top-k routing with the GShard capacity dispatch, and the exact form that
runs every expert on every token. The reference computes all of it with
einsums outside any Pallas kernel, so here the products are library calls
(cuBLAS on the card); no hand-written kernel belongs to this module.

- `top_k_routing`: the k largest router logits per token, LOWER expert index
  first on ties (as `lax.top_k`; a bf16 router ties often), and a softmax
  over the k selected logits (Mixtral's normalisation).
- `moe_dispatch_combine`: each (token, choice) takes the next slot of its
  expert's buffer of `capacity` slots, choice 0 of every token before any
  choice 1, then token order; pairs past the capacity are dropped
  (contribute zero), and `token_valid` keeps padding out of the contest.
  The plain form is the reference's one-hot einsums step by step; on the
  card the dispatch and the combine are index copies and gathers
  (`indexed`), which give the same bits: every buffer slot holds at most one
  token, and a token sums at most k products of bf16 values, each exact in
  fp32 (for k = 2 the order of the one addition does not matter).
- `moe_dense_exact`: every expert on every token, the combine weights zero
  for the unselected ones, kept in fp32. No token is ever dropped, so a
  row's result does not depend on the rows beside it (decode and verify).

int8 experts carry per-output-channel scales [E, out], applied to the fp32
output of the product (`_expert_mm`), as the reference applies them.

On an expert-parallel mesh a rank holds experts [expert_offset,
expert_offset + E_local) (and, on a tp mesh, a slice of each one's ffn
width). The router is replicated, so every rank routes every token over
all experts and computes every capacity slot; it runs only its own
experts' products and returns its partial sum, which `reduce` (over ep,
and over tp in the exact form) sums across ranks in fp32 before the round
to x's dtype. The sum equals the reference's dispatch/combine all-to-alls.
In the capacity form an expert's down product is a sum over the ffn
width, so on a tp mesh `reduce_ffn` sums it across tp before its round to
x's dtype, where the reference rounds it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _expert_mm(a: torch.Tensor, w: torch.Tensor,
               scale: torch.Tensor | None) -> torch.Tensor:
    """a [E, N, IN] @ w [E, IN, OUT] per expert -> [E, N, OUT] fp32, times
    the int8 scale [E, OUT] when there is one. On the card a bf16 `a` takes
    one cuBLAS bf16-in/fp32-out product per expert, the int8 weight widened
    to bf16 an expert at a time (exact: |code| <= 127); elsewhere the
    operands widen to fp32 (the same values)."""
    if w.dtype == torch.int8 and scale is None:
        raise TypeError("an int8 expert weight needs its _scale companion")
    if a.device.type == "cuda" and a.dtype != torch.float32:
        y = torch.stack([torch.mm(a[e], w[e].to(a.dtype),
                                  out_dtype=torch.float32)
                         for e in range(w.shape[0])])
    else:
        y = torch.bmm(a.float(), w.float())
    return y if scale is None else y * scale[:, None, :]


def top_k_routing(router_logits: torch.Tensor, num_selected: int):
    """router_logits [S, E] -> (weights [S, k] fp32 summing to 1, indices
    [S, k] int64), the larger logit first and the lower index first among
    equal logits (a stable descending sort)."""
    vals, idx = torch.sort(router_logits.float(), dim=-1, descending=True,
                           stable=True)
    vals, idx = vals[:, :num_selected], idx[:, :num_selected]
    return torch.softmax(vals, dim=-1), idx


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """[..., n] one-hot rows; an index outside [0, n) gives a row of zeros
    (jax.nn.one_hot's contract)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def capacity_slots(gate_idx: torch.Tensor, num_experts: int, capacity: int,
                   token_valid: torch.Tensor | None = None):
    """The slot of each (token, choice) in its expert's buffer: (pos [S, k,
    E] int64, the running count of earlier assignments to that expert with
    choice 0 of every token before any choice 1; in_cap [S, k, E] bool, the
    pairs that got a slot below `capacity`). Padding (token_valid False)
    takes no slot."""
    s, k = gate_idx.shape
    one_hot = _one_hot(gate_idx, num_experts, torch.int64)  # [S, k, E]
    if token_valid is not None:
        one_hot = one_hot * token_valid.to(torch.int64)[:, None, None]
    flat = one_hot.transpose(0, 1).reshape(k * s, num_experts)  # k-major
    pos = (torch.cumsum(flat, dim=0) - flat).reshape(k, s, num_experts)
    pos = pos.transpose(0, 1)
    return pos, (pos < capacity) & (one_hot == 1)


def capacity_drops(router_logits: torch.Tensor, num_selected: int,
                   capacity: int,
                   token_valid: torch.Tensor | None = None) -> int:
    """The (token, choice) pairs of valid tokens that the capacity dispatch
    drops for these router logits (a host read)."""
    _, gate_idx = top_k_routing(router_logits, num_selected)
    _, in_cap = capacity_slots(gate_idx, router_logits.shape[-1], capacity,
                               token_valid)
    routed = gate_idx.numel() if token_valid is None else (
        int(token_valid.sum()) * num_selected)
    return routed - int(in_cap.sum())


def moe_dispatch_combine(
    x: torch.Tensor,  # [S, M] tokens (S = B*T)
    router_logits: torch.Tensor,  # [S, E]
    w_gate: torch.Tensor,  # [E, M, F] (silu branch)
    w_up: torch.Tensor,  # [E, M, F]
    w_down: torch.Tensor,  # [E, F, M]
    *,
    num_selected: int,
    capacity: int,
    token_valid: torch.Tensor | None = None,  # [S] bool; False = padding
    w_gate_scale: torch.Tensor | None = None,  # [E, F] int8 dequant scales
    w_up_scale: torch.Tensor | None = None,  # [E, F]
    w_down_scale: torch.Tensor | None = None,  # [E, M]
    indexed: bool | None = None,
    expert_offset: int = 0,  # the first of this rank's experts
    reduce=None,  # fp32 [S, M] partial -> its sum over the expert ranks
    reduce_ffn=None,  # fp32 [E, C, M] partial -> its sum over tp
) -> torch.Tensor:
    """SwiGLU expert MLPs over the tokens the capacity dispatch keeps.
    Returns [S, M] in x's dtype. The dtypes follow the reference's casts:
    the combine weights are rounded to x's dtype, the expert buffers
    accumulate in fp32 and round to x's dtype, and so do the gate, up and
    down outputs; the combine sums in fp32. `indexed` (default: on the card)
    runs the dispatch and combine as index copies and gathers, else as the
    reference's one-hot products."""
    s, m = x.shape
    e = w_gate.shape[0]
    e_all = router_logits.shape[-1]
    weights, gate_idx = top_k_routing(router_logits, num_selected)
    pos, in_cap = capacity_slots(gate_idx, e_all, capacity, token_valid)
    if indexed is None:
        indexed = x.device.type == "cuda"

    if indexed:
        sel = gate_idx[..., None]
        kept = in_cap.gather(2, sel)[..., 0]  # [S, k]
        local_idx = gate_idx - expert_offset
        if e != e_all:  # only this rank's experts
            kept = kept & (local_idx >= 0) & (local_idx < e)
        # slot e * C + pos of a kept pair, the trash row e * C otherwise
        dest = torch.where(kept, local_idx * capacity
                           + pos.gather(2, sel)[..., 0],
                           e * capacity).reshape(-1)
        buf = x.new_zeros((e * capacity + 1, m))
        buf.index_copy_(0, dest, x[:, None, :].expand(s, num_selected, m)
                        .reshape(-1, m))
        expert_in = buf[:-1].view(e, capacity, m)
    else:
        slot_oh = _one_hot(torch.where(in_cap, pos, capacity), capacity,
                           x.dtype)  # [S, k, E, C]; dropped pairs: zeros
        slot_oh = slot_oh[:, :, expert_offset:expert_offset + e]
        dispatch = slot_oh.sum(dim=1)  # [S, E, C]
        combine = (slot_oh * weights[:, :, None, None].to(x.dtype)).sum(dim=1)
        expert_in = torch.einsum("sec,sm->ecm", dispatch.float(),
                                 x.float()).to(x.dtype)

    h = (F.silu(_expert_mm(expert_in, w_gate, w_gate_scale).to(x.dtype))
         * _expert_mm(expert_in, w_up, w_up_scale).to(x.dtype))
    expert_out = _expert_mm(h, w_down, w_down_scale)  # [E, C, M] fp32
    if reduce_ffn is not None:
        expert_out = reduce_ffn(expert_out)
    expert_out = expert_out.to(x.dtype)

    if indexed:
        rows = torch.cat([expert_out.reshape(e * capacity, m),
                          expert_out.new_zeros((1, m))])
        cw = torch.where(kept, weights.to(x.dtype), 0).float()  # [S, k]
        picked = rows[dest].view(s, num_selected, m).float()
        out = (cw[..., None] * picked).sum(dim=1)
    else:
        out = torch.einsum("sec,ecm->sm", combine.float(),
                           expert_out.float())
    if reduce is not None:
        out = reduce(out)
    return out.to(x.dtype)


def moe_dense_exact(
    x: torch.Tensor,  # [S, M]
    router_logits: torch.Tensor,  # [S, E]
    w_gate: torch.Tensor,  # [E, M, F]
    w_up: torch.Tensor,  # [E, M, F]
    w_down: torch.Tensor,  # [E, F, M]
    *,
    num_selected: int,
    w_gate_scale: torch.Tensor | None = None,
    w_up_scale: torch.Tensor | None = None,
    w_down_scale: torch.Tensor | None = None,
    expert_offset: int = 0,  # the first of this rank's experts
    reduce=None,  # fp32 [S, M] partial -> its sum over the ep and tp ranks
) -> torch.Tensor:
    """Exact top-k MoE: every expert runs on every token and the combine
    masks the rest, in fp32 (E/k times the routed products: the right trade
    for decode, which streams every expert's weights either way). Static
    shapes and no host read, so a decode step holding it is one CUDA graph.
    Returns [S, M] in x's dtype."""
    weights, gate_idx = top_k_routing(router_logits, num_selected)
    e = w_gate.shape[0]
    combine = (_one_hot(gate_idx, router_logits.shape[-1], torch.float32)
               * weights[..., None]).sum(dim=1)  # [S, E]
    combine = combine[:, expert_offset:expert_offset + e]
    xe = x.unsqueeze(0).expand(e, -1, -1)
    h = (F.silu(_expert_mm(xe, w_gate, w_gate_scale).to(x.dtype))
         * _expert_mm(xe, w_up, w_up_scale).to(x.dtype))
    expert_out = _expert_mm(h, w_down, w_down_scale)  # [E, S, M] fp32
    out = torch.einsum("se,esm->sm", combine, expert_out)
    if reduce is not None:
        out = reduce(out)
    return out.to(x.dtype)


def default_capacity(tokens: int, num_experts: int, num_selected: int,
                     capacity_factor: float = 1.25) -> int:
    """GShard-style capacity: factor x the even split, at least 4, a
    multiple of 4."""
    cap = int(tokens * num_selected / num_experts * capacity_factor)
    return max(4, (cap + 3) // 4 * 4)
