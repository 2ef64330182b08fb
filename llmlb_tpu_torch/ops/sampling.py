"""Token sampling: greedy / temperature / top-k / top-p in one batched op.

Counterpart of `llmlb_tpu/ops/sampling.py`. Sampling parameters are
per-row tensors ([B]) so one call serves every request mix, and the
stochastic path runs inside a static top-K=64 prefilter window (a full
128k-vocab sort per step would spend memory bandwidth for no quality gain).
The steps run in the reference's order: additive `mask_bias` on the full
logits (before both the greedy argmax and the prefilter), top-k inside the
window, temperature, then top-p over the sorted window.

Randomness: rows without a seed draw from the caller's `torch.Generator`
(never the global RNG), which makes no promise across engines. A row with
seed >= 0 draws the Gumbel noise of JAX's
`categorical(fold_in(PRNGKey(seed), step), scaled)` (`ops/_threefry.py`),
so it samples the token ids the JAX package samples, whatever else shares
the batch. Greedy rows are exact (argmax, first index on ties). Nothing
here syncs with the host, so a decode burst can sample step after step on
the card.
"""

from __future__ import annotations

from typing import Sequence

import torch

from llmlb_tpu_torch.ops import _threefry

TOPK_PREFILTER = 64


def sample_tokens(
    logits: torch.Tensor,  # [B, V] float32
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B] float32; 0 => greedy
    top_p: torch.Tensor,  # [B] float32 in (0, 1]
    top_k: torch.Tensor,  # [B] int; 0 => disabled (the window caps it at 64)
    mask_bias: torch.Tensor | None = None,  # [B, V] float32 additive, or None
    seeds: torch.Tensor | Sequence[int] | None = None,  # [B]; < 0 => generator
    steps: torch.Tensor | Sequence[int] | None = None,  # [B] position folded in
) -> torch.Tensor:
    """Returns sampled token ids [B] int32 on the logits' device."""
    logits = logits.float()
    if mask_bias is not None:
        logits = logits + mask_bias
    b, v = logits.shape
    greedy_ids = torch.argmax(logits, dim=-1).to(torch.int32)

    k = min(TOPK_PREFILTER, v)
    top_logits, top_ids = torch.topk(logits, k, dim=-1)
    # order the window by value descending, ties by lower token id first (as
    # the reference's top_k does), so top_k=1 is exactly the greedy argmax
    top_ids, order = torch.sort(top_ids, dim=-1)
    top_logits = torch.gather(top_logits, 1, order)
    top_logits, order = torch.sort(top_logits, dim=-1, descending=True,
                                   stable=True)
    top_ids = torch.gather(top_ids, 1, order)

    # top-k restriction inside the prefilter window
    ranks = torch.arange(k, device=logits.device)[None, :]
    top_k = top_k.to(logits.device)
    eff_top_k = torch.where(top_k <= 0, k, torch.clamp(top_k, max=k))[:, None]
    top_logits = top_logits.masked_fill(ranks >= eff_top_k, float("-inf"))

    scaled = top_logits / torch.clamp(temperature, min=1e-6)[:, None]

    # top-p over the sorted window: keep tokens whose mass before them is
    # < top_p (rank 0 always kept)
    probs = torch.softmax(scaled, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    scaled = scaled.masked_fill(~(before < top_p[:, None]), float("-inf"))

    # Gumbel-max over the window: argmax(scaled + Gumbel noise)
    u = torch.rand((b, k), generator=generator, device=logits.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    gumbel = -torch.log(-torch.log(u))
    if seeds is not None:
        seeds = torch.as_tensor(seeds, dtype=torch.int64, device=logits.device)
        steps = (torch.zeros_like(seeds) if steps is None else
                 torch.as_tensor(steps, dtype=torch.int64, device=logits.device))
        gumbel = torch.where((seeds >= 0)[:, None],
                             _threefry.gumbel(seeds, steps, k), gumbel)
    sampled_idx = torch.argmax(scaled + gumbel, dim=-1)
    sampled_ids = torch.gather(top_ids, 1, sampled_idx[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy_ids,
                       sampled_ids.to(torch.int32))


def sample_chunk(
    logits: torch.Tensor,  # [B, T, V] float32
    generator: torch.Generator | None,
    temperature: torch.Tensor,  # [B] float32
    top_p: torch.Tensor,  # [B] float32
    top_k: torch.Tensor,  # [B] int
    mask_bias: torch.Tensor | None,  # [B * T, V] float32 additive, or None
    seeds: torch.Tensor | None,  # [B]; < 0 => generator; None: no seeded row
    start_pos: torch.Tensor,  # [B] global position of each row's column 0
) -> torch.Tensor:
    """Per-position sampling of a verify chunk (the reference's
    `_sample_chunk`): the B * T rows are sampled as independent rows, each
    with its slot's parameters, and the seed fold steps by GLOBAL position
    (start_pos[b] + j), so a seeded row draws the same key at position p in
    a verify chunk as in plain decode. Returns [B, T] int32. No host sync:
    safe in a graph."""
    b, t, v = logits.shape
    dev = logits.device
    steps = (start_pos.to(device=dev, dtype=torch.int64)[:, None]
             + torch.arange(t, device=dev)[None, :]).reshape(-1)

    def rep(x):
        return x.repeat_interleave(t)

    toks = sample_tokens(logits.reshape(b * t, v), generator, rep(temperature),
                         rep(top_p), rep(top_k), mask_bias=mask_bias,
                         seeds=None if seeds is None else rep(seeds),
                         steps=steps)
    return toks.reshape(b, t)
