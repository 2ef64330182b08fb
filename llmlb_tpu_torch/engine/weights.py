"""Weights for the port's engine.

`params_from_numpy` carries a params pytree made by the JAX package (as
numpy arrays, leaf for leaf: `{name: np.asarray(leaf)}`) into the port's
tensors. The layouts are the same on both sides — stacked [L, in, out]
matrices, [L, E] norms — so each leaf converts as it is. Loading HF
checkpoints arrives in a later slice.
"""

from __future__ import annotations

import numpy as np
import torch

from llmlb_tpu_torch.models.llama import LlamaConfig, param_shapes


def params_from_numpy(np_params: dict[str, np.ndarray], cfg: LlamaConfig,
                      device: torch.device | str) -> dict[str, torch.Tensor]:
    """Convert a numpy params dict to tensors of cfg.dtype on `device`.
    Raises on a missing, unexpected or misshaped leaf."""
    expected = param_shapes(cfg)
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
        # numpy has no bfloat16: widen to fp32 first, round on the device
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        out[name] = t.to(device=device, dtype=cfg.dtype)
    return out
