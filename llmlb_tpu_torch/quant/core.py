"""Symmetric int8 quantization of weights and KV vectors: the port's own copy
of `llmlb_tpu/quant/core.py`, in torch (numpy arrays are accepted and
returned as numpy).

Scheme: absmax symmetric over a reduction group, `scale = max(|x|, eps) /
127` and `q = round(x / scale)` clipped to [-127, 127], no zero point. The
division is fp32 and the rounding is half to even, as `jnp.round` and
`np.round` do, so the codes are bit for bit the JAX package's.

- Weights: per OUTPUT channel (reduce over the input axis, axis=-2 of the
  [..., in, out] matmul layout). The scale is constant along the
  contraction, so it applies to the matmul output.
- KV: per written (token, head) vector (reduce over head_dim, axis=-1), so
  a decode step that appends one token never rescales cells already
  written.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

# Param names whose matmul weights quantize (names absent from a pytree are
# skipped). Embeddings, norms, lm_head and biases stay in the model dtype.
WEIGHT_QUANT_NAMES = (
    "wq", "wk", "wv", "wo",          # attention projections
    "wg", "wu", "wd",                # dense SwiGLU MLP
    "we_gate", "we_up", "we_down",   # MoE expert FFNs
)

SCALE_SUFFIX = "_scale"
KV_SCALE_DTYPE = torch.float32
_QMAX = 127.0
_EPS = 1e-8  # all-zero groups quantize to zeros with a harmless tiny scale


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Resolved quantization knobs for one engine."""

    weights: bool = False
    kv: bool = False

    @property
    def mode(self) -> str:
        if self.weights and self.kv:
            return "all"
        if self.weights:
            return "weights"
        if self.kv:
            return "kv"
        return "off"

    @property
    def enabled(self) -> bool:
        return self.weights or self.kv


def parse_quant_mode(mode: str | None = None) -> QuantConfig:
    """Resolve `--quantize` / LLMLB_QUANTIZE into a QuantConfig.

    Accepts off|weights|kv|all (case-insensitive; "0"/"false"/"none" alias
    off). Raises ValueError for anything else: a mistyped mode must not
    serve unquantized while the operator believes the bytes halved."""
    if mode is None:
        mode = os.environ.get("LLMLB_QUANTIZE", "off")
    key = str(mode).strip().lower()
    if key in ("off", "0", "false", "none", ""):
        return QuantConfig()
    if key == "weights":
        return QuantConfig(weights=True)
    if key == "kv":
        return QuantConfig(kv=True)
    if key == "all":
        return QuantConfig(weights=True, kv=True)
    raise ValueError(f"quantize mode must be off|weights|kv|all, got {mode!r}")


def _as_tensor(x):
    """(tensor, whether x was numpy). numpy dtypes torch lacks (bfloat16
    from ml_dtypes) widen to float32 first, which is exact."""
    if not isinstance(x, np.ndarray):
        return x, False
    x = np.ascontiguousarray(x)
    if not x.flags.writeable:  # e.g. a view of a JAX array
        x = x.copy()
    try:
        return torch.from_numpy(x), True
    except TypeError:
        return torch.from_numpy(x.astype(np.float32)), True


def _is_int8(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.dtype == torch.int8
    return np.dtype(x.dtype) == np.int8


def _absmax_int8(x: torch.Tensor, axis: int):
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=axis), min=_EPS) / _QMAX
    q = torch.clamp(torch.round(xf / scale.unsqueeze(axis)), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def _out(q, scale, was_numpy):
    return (q.numpy(), scale.numpy()) if was_numpy else (q, scale)


# --------------------------------------------------------------- weights


def quantize_channelwise(w, axis: int = -2):
    """Per-output-channel symmetric int8: reduce |w| over `axis` (the input
    axis of the [..., in, out] layout). Returns (int8 values with w's shape,
    float32 scales with `axis` removed)."""
    t, was_numpy = _as_tensor(w)
    return _out(*_absmax_int8(t, axis), was_numpy)


def dequantize_channelwise(q, scale, dtype=None, axis: int = -2):
    """Inverse of quantize_channelwise (tests and reference math: the
    serving matmuls scale the output instead)."""
    qt, was_numpy = _as_tensor(q)
    st, _ = _as_tensor(scale)
    out = qt.float() * st.unsqueeze(axis)
    if dtype is not None:
        out = out.to(dtype)
    return out.numpy() if was_numpy else out


def _quantize_by_layer(w: torch.Tensor):
    """quantize_channelwise of a stacked [L, in, out] tensor, one layer at a
    time on its device, so the fp32 temporaries stay one layer's size (a
    whole-leaf fp32 copy of Llama-3-8B's `wg` is 7.5 GB)."""
    codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scales = torch.empty(w.shape[:-2] + w.shape[-1:], dtype=torch.float32,
                         device=w.device)
    for i in range(w.shape[0]):
        codes[i], scales[i] = _absmax_int8(w[i], -2)
    return codes, scales


def quantize_params(params: dict, names=WEIGHT_QUANT_NAMES) -> dict:
    """Quantize the projection weights of a params dict, adding
    `<name>_scale` companions; returns a new dict. Stacked tensors quantize
    one layer at a time (the same codes). Idempotent: leaves that already
    carry a scale, or are already int8, pass through."""
    out = dict(params)
    for name in names:
        v = out.get(name)
        if v is None or f"{name}{SCALE_SUFFIX}" in out:
            continue
        if _is_int8(v):
            continue
        stacked = isinstance(v, torch.Tensor) and v.dim() > 2
        out[name], out[f"{name}{SCALE_SUFFIX}"] = (
            _quantize_by_layer(v) if stacked else quantize_channelwise(v))
    return out


# -------------------------------------------------------------------- KV


def quantize_kv(kv):
    """Quantize K or V vectors on write: absmax over the trailing head_dim
    axis. kv [..., D] -> (int8 [..., D], float32 [...])."""
    t, was_numpy = _as_tensor(kv)
    return _out(*_absmax_int8(t, -1), was_numpy)


def dequantize_kv(q, scale, dtype):
    """Dequantize cells on read: values [..., D] * scales [..., 1] in fp32,
    rounded to `dtype` (the attention's compute dtype)."""
    return (q.float() * scale.unsqueeze(-1)).to(dtype)


def kv_cell_bytes(head_dim: int, quantized: bool, itemsize: int = 2) -> int:
    """Device bytes per cached (token, head) cell: D values plus, when
    quantized, the vector's float32 scale."""
    if quantized:
        return head_dim + KV_SCALE_DTYPE.itemsize
    return head_dim * itemsize
