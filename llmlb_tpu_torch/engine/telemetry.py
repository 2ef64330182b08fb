"""Device memory telemetry and peak figures for the engine's /api/health.

Counterpart of `llmlb_tpu/engine/telemetry.py`: the same `ChipSpec`,
lookup, model cost helpers and `device_telemetry` fields, read through
torch. The gateway's health probe reads the block (under "gpu" here, the
key its parser already takes beside "tpu") for placement: chip count and
device-memory pressure.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-device peak figures for utilization math (bf16 and int8 dense
    operations, memory bandwidth). Spec-sheet numbers: the MFU and
    bandwidth-utilization gauges divide measured work by them."""

    generation: str
    peak_flops: float  # bf16 FLOP/s per device
    peak_hbm_bw: float  # bytes/s per device
    peak_flops_int8: float = 0.0  # int8 OP/s per device (0 -> same as bf16)

    @property
    def int8_flops(self) -> float:
        return self.peak_flops_int8 or self.peak_flops


# Keyed by a normalized torch.cuda.get_device_name substring (lowercase,
# spaces stripped), e.g. "NVIDIA H100 80GB HBM3" -> "nvidiah10080gbhbm3".
# NVIDIA's H100 SXM data sheet, dense (no sparsity): 989 TFLOP/s bf16,
# 1979 TOP/s int8, 3.35 TB/s HBM3. Only the card this port is built for.
CHIP_SPECS: tuple[tuple[str, ChipSpec], ...] = (
    ("h10080gbhbm3", ChipSpec("h100-sxm", 989e12, 3.35e12, 1979e12)),
)


def chip_spec_for(device_kind: str) -> ChipSpec | None:
    """Resolve a device name to its peak specs (None for the CPU and any
    other device: the utilization gauges are then absent, never wrong)."""
    key = str(device_kind).lower().replace(" ", "")
    for frag, spec in CHIP_SPECS:
        if frag in key:
            return spec
    return None


def model_flops_per_token(cfg, n_params: int) -> float:
    """Decode FLOPs per generated token: ~2 FLOPs per parameter touched
    (one multiply and one add per weight). MoE configs count the routed
    experts' share of the FFN weights only."""
    experts = getattr(cfg, "num_experts", 0) or 0
    if experts > 1:
        per_tok = getattr(cfg, "experts_per_token", 1) or 1
        ffn = (3 * cfg.hidden_size * cfg.intermediate_size
               * cfg.num_layers * experts)
        active = n_params - ffn + ffn * per_tok / experts
        return 2.0 * active
    return 2.0 * n_params


def model_bytes_per_token(cfg, n_params: int, mean_context: float,
                          batch: int = 1, *,
                          weight_bytes: float | None = None,
                          kv_cell_bytes: float | None = None) -> float:
    """Device-memory bytes read per decoded token: every weight once per
    step, amortized over the `batch` rows decoded together, plus the KV
    rows of the row's own context (never amortized).

    `weight_bytes` is the measured parameter footprint (int8 codes plus
    scales when weights are quantized), `kv_cell_bytes` the bytes of one
    cached (token, head) cell (D + a 4-byte scale under int8 KV, D x the
    itemsize otherwise). The defaults are the unquantized figures."""
    itemsize = cfg.dtype.itemsize
    if weight_bytes is None:
        weight_bytes = n_params * itemsize
    if kv_cell_bytes is None:
        kv_cell_bytes = cfg.head_dim_ * itemsize
    kv_bytes = (cfg.num_layers * mean_context * cfg.num_kv_heads
                * kv_cell_bytes * 2)
    return weight_bytes / max(1, batch) + kv_bytes


def device_kind(device: torch.device) -> str:
    """The device's name: torch.cuda.get_device_name on the card, "cpu"
    (JAX's CPU device_kind) on the host."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def device_telemetry(device: torch.device) -> dict[str, Any]:
    """The reference's telemetry block for the engine's own device. Used
    bytes are what torch's allocator holds in tensors
    (`memory_allocated`, the counterpart of XLA's bytes_in_use), the total
    the device's memory; the CPU reports 0 for both, as XLA's CPU client
    does. The device is always named, so no context opens on device 0."""
    device = torch.device(device)
    platform = "gpu" if device.type == "cuda" else "cpu"
    used = total = 0
    if device.type == "cuda":
        used = int(torch.cuda.memory_allocated(device))
        total = int(torch.cuda.get_device_properties(device).total_memory)
    chip = {
        "id": device.index or 0,
        "platform": platform,
        "device_kind": device_kind(device),
        "hbm_used_bytes": used,
        "hbm_total_bytes": total,
    }
    return {
        "accelerator": platform,
        "chip_count": 1,
        "hbm_used_bytes": used,
        "hbm_total_bytes": total,
        "chips": [chip],
    }
