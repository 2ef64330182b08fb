"""Ring attention: sequence-parallel causal prefill over a mesh's `sp`
axis, counterpart of `llmlb_tpu/ops/ring_attention.py`.

The token axis of a long prompt is split over `sp` ranks; each rank keeps
its query chunk and passes its K/V chunk around the ring (`sp - 1` hops
of `Mesh.ppermute`), merging every block into an fp32 online softmax
(running max, running sum, accumulator). The result equals dense causal
attention over the whole sequence up to float associativity, while no
rank ever holds the T x T scores.

The reference computes the block products with einsums (not Pallas), so
here they are plain PyTorch products too: no hand-written kernel belongs
to this module. `dense_prefill_attention` is the plain version the tests
hold the ring against: dense causal GQA over the gathered sequence.
"""

from __future__ import annotations

import torch

from llmlb_tpu_torch.parallel.mesh import Mesh

_NEG_INF = -1e30  # finite: fully-masked rows must still produce softmax-able sums


def ring_attention_local(
    q: torch.Tensor,  # [B, C, H, D] this rank's query chunk (C = T / sp)
    k: torch.Tensor,  # [B, C, K, D] this rank's key chunk
    v: torch.Tensor,  # [B, C, K, D]
    prompt_lens: torch.Tensor,  # [B] int32 — global valid lengths
    mesh: Mesh,
    axis: str = "sp",
) -> torch.Tensor:
    """The per-rank ring body: at hop s a rank holds the K/V chunk of rank
    (rank - s) mod sp, masks it causally and by `prompt_lens` at global
    positions, and folds it into the fp32 softmax state. Returns [B, C, H,
    D] in q's dtype; fully masked rows (padding queries) divide by 1e-30,
    not by 0."""
    b, c, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = d**-0.5
    n = mesh.shape[axis]
    rank = mesh.coord[axis]
    dev = q.device
    offs = torch.arange(c, device=dev, dtype=torch.int32)
    q_pos = rank * c + offs  # [C] global query positions
    lens = prompt_lens.to(device=dev, dtype=torch.int32)
    qg = q.reshape(b, c, kh, g, d).float()

    m = torch.full((b, kh, g, c), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, kh, g, c), dtype=torch.float32, device=dev)
    o = torch.zeros((b, c, kh, g, d), dtype=torch.float32, device=dev)
    for s in range(n):
        src = (rank - s) % n
        k_pos = src * c + offs  # [C] global key positions
        scores = torch.einsum("bckgd,bskd->bkgcs", qg, k.float()) * scale
        causal = q_pos[:, None] >= k_pos[None, :]  # [C, Ck]
        valid = k_pos[None, :] < lens[:, None]  # [B, Ck]
        mask = causal[None] & valid[:, None, :]  # [B, C, Ck]
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, _NEG_INF))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])  # [B, K, G, C, Ck]
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgcs,bskd->bckgd", p.to(v.dtype).float(),
                          v.float())
        o = o * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
        if s != n - 1:  # the last block needs no forwarding
            k = mesh.ppermute(k, axis)
            v = mesh.ppermute(v, axis)
    l_safe = torch.clamp(l.permute(0, 3, 1, 2)[..., None], min=1e-30)
    return (o / l_safe).reshape(b, c, h, d).to(q.dtype)


def ring_prefill_attention(
    q: torch.Tensor,  # [B, C, H, D] — this rank's chunk of T = C * sp
    k: torch.Tensor,  # [B, C, K, D]
    v: torch.Tensor,  # [B, C, K, D]
    prompt_lens: torch.Tensor,  # [B] int32
    mesh: Mesh,
    *,
    seq_len: int,
    seq_axis: str = "sp",
) -> torch.Tensor:
    """Causal GQA prefill attention with the sequence split over
    `seq_axis`: gqa_attention_prefill's contract on this rank's chunk of a
    `seq_len`-token sequence (which must divide by the axis's size). Heads
    are whatever this rank holds (a tp mesh's share)."""
    sp = mesh.shape[seq_axis]
    if seq_len % sp:
        raise ValueError(f"seq len {seq_len} not divisible by sp={sp}")
    if q.shape[1] * sp != seq_len:
        raise ValueError(f"chunk of {q.shape[1]} tokens is not 1/{sp} of "
                         f"{seq_len}")
    return ring_attention_local(q, k, v, prompt_lens, mesh, seq_axis)


def dense_prefill_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k: torch.Tensor,  # [B, T, K, D]
    v: torch.Tensor,  # [B, T, K, D]
    prompt_lens: torch.Tensor,  # [B] int32
) -> torch.Tensor:
    """The plain version: dense causal GQA over the whole sequence, fp32
    scores and softmax with the same finite mask. Returns [B, T, H, D]."""
    b, t, h, d = q.shape
    kh = k.shape[2]
    g = h // kh
    pos = torch.arange(t, device=q.device)
    lens = prompt_lens.to(device=q.device)
    mask = ((pos[:, None] >= pos[None, :])[None]
            & (pos[None, None, :] < lens[:, None, None]))  # [B, T, T]
    qg = q.reshape(b, t, kh, g, d).float()
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.float()) * d**-0.5
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, _NEG_INF))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    return out.reshape(b, t, h, d).to(q.dtype)
