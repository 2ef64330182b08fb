"""Weights for the port's engine.

`params_from_numpy` carries a params pytree made by the JAX package (as
numpy arrays, leaf for leaf: `{name: np.asarray(leaf)}`) into the port's
tensors. The layouts are the same on both sides — stacked [L, in, out]
matrices, [L, E] norms — so each leaf converts as it is. A pytree quantized
by the JAX package (`quantize_params`) carries int8 weights with float32
`<name>_scale` leaves; those cross bit for bit. LoRA adapter pool leaves
(`<name>_lora_a` [L, N, in, R], `<name>_lora_b` [L, N, R, out]) pass through
in cfg.dtype. Loading HF checkpoints arrives in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from llmlb_tpu_torch.lora.manager import LORA_A, LORA_B
from llmlb_tpu_torch.lora.store import HF_TARGET_MAP, lora_target_dims
from llmlb_tpu_torch.models.llama import LlamaConfig, param_shapes
from llmlb_tpu_torch.quant import SCALE_SUFFIX, WEIGHT_QUANT_NAMES


def _quantized_names(np_params: dict[str, np.ndarray]) -> tuple[str, ...]:
    """Names whose weight is int8 with a scale; raises on a weight without
    its scale or a scale without an int8 weight."""
    names = []
    for name in WEIGHT_QUANT_NAMES:
        if name not in np_params:
            continue
        is_int8 = np.asarray(np_params[name]).dtype == np.int8
        has_scale = name + SCALE_SUFFIX in np_params
        if is_int8 != has_scale:
            raise ValueError(
                f"param {name!r}: " + ("int8 weight without its "
                                       f"{name}{SCALE_SUFFIX}" if is_int8 else
                                       f"{name}{SCALE_SUFFIX} beside a weight "
                                       "that is not int8"))
        if is_int8:
            names.append(name)
    return tuple(names)


def params_from_numpy(np_params: dict[str, np.ndarray], cfg: LlamaConfig,
                      device: torch.device | str) -> dict[str, torch.Tensor]:
    """Convert a numpy params dict to tensors on `device`: int8 weights stay
    int8, their scales float32, every other leaf (adapter pools included)
    becomes cfg.dtype. Raises on a missing, unexpected or misshaped leaf."""
    quantized = _quantized_names(np_params)
    expected = param_shapes(cfg, quantized)
    for name, (in_dim, out_dim) in lora_target_dims(
            cfg, tuple(HF_TARGET_MAP.values())).items():
        a = np_params.get(name + LORA_A)
        if a is not None and np.ndim(a) == 4:  # [L, N, in, R]
            n, r = np.shape(a)[1], np.shape(a)[3]
            expected[name + LORA_A] = ((cfg.num_layers, n, in_dim, r), 0)
            expected[name + LORA_B] = ((cfg.num_layers, n, r, out_dim), 0)
    missing = sorted(set(expected) - set(np_params))
    extra = sorted(set(np_params) - set(expected))
    if missing or extra:
        raise ValueError(f"params do not match the config: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for name, (shape, _fan_in) in expected.items():
        arr = np.asarray(np_params[name])
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"param {name!r} has shape {arr.shape}, "
                             f"expected {shape}")
        if name in quantized:
            out[name] = torch.from_numpy(arr.copy()).to(device)
        elif name.endswith(SCALE_SUFFIX):
            out[name] = torch.from_numpy(
                np.array(arr, dtype=np.float32)).to(device)
        else:
            # numpy has no bfloat16: widen to fp32 first, round on the device
            t = torch.from_numpy(np.array(arr, dtype=np.float32))
            out[name] = t.to(device=device, dtype=cfg.dtype)
    return out
