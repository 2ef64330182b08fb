"""Rotary position embeddings (split-half convention, HF-compatible).

Counterpart of `llmlb_tpu/ops/rope.py`: plain RoPE (Llama-2/Qwen/Mistral)
and Llama-3 frequency scaling, with frequencies computed from integer
positions on each call.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """Llama-3-style rope scaling (factor-based NTK with wavelength thresholds)."""

    factor: float = 8.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position: int = 8192


def rope_frequencies(
    head_dim: int,
    theta: float = 10000.0,
    scaling: RopeScaling | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Per-pair inverse frequencies, shape [head_dim // 2], float32."""
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    inv_freq = 1.0 / (theta ** exponents)
    if scaling is not None:
        low_wl = scaling.original_max_position / scaling.low_freq_factor
        high_wl = scaling.original_max_position / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        smooth = (scaling.original_max_position / wavelen
                  - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor
        )
        smooth = smooth.clamp(0.0, 1.0)
        scaled = inv_freq / scaling.factor
        blended = (1.0 - smooth) * scaled + smooth * inv_freq
        inv_freq = torch.where(
            wavelen > low_wl, scaled,
            torch.where(wavelen < high_wl, inv_freq, blended),
        )
    return inv_freq


def apply_rope(
    x: torch.Tensor,  # [B, T, H, D]
    positions: torch.Tensor,  # [B, T] int
    inv_freq: torch.Tensor,  # [D // 2] float32
) -> torch.Tensor:
    """Rotate q or k by position (rotate_half layout, as HF Llama)."""
    angles = positions[..., None].float() * inv_freq  # [B, T, D/2]
    cos = torch.cos(angles)[:, :, None, :]  # [B, T, 1, D/2]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    rotated = torch.cat((x1 * cos - x2 * sin, x2 * cos + x1 * sin), dim=-1)
    return rotated.to(x.dtype)
