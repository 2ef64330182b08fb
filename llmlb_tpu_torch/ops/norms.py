"""Normalization ops. Computed in float32, cast back — bf16 accumulate drifts.

Counterpart of `llmlb_tpu/ops/norms.py`."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm: x * w / rms(x), with the variance in float32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * weight.float()).to(x.dtype)
