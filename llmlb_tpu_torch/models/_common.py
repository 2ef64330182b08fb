"""What the multimodal families (whisper.py, tts.py, diffusion.py) share:
params trees built from shapes trees, the reference's flat safetensors
checkpoint, XLA's "SAME" padding, and fp32 convolutions on the card.

A shapes tree nests dicts, lists and (gain, bias) tuples of (shape, init)
leaves; `init` is a fan-in for a random matrix, or ZEROS (biases), ONES
(norm gains) or SINUSOIDS (Whisper's fixed positions). A params tree has
the same nesting with a tensor at each leaf; None stays None.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np
import torch

ZEROS, ONES, SINUSOIDS = "zeros", "ones", "sinusoids"


def sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's fixed sinusoidal embedding (sin | cos concatenation)."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(
        np.float32)


def is_spec(node) -> bool:
    """Whether a node of a shapes tree is one (shape, init) leaf."""
    return (isinstance(node, tuple) and len(node) == 2
            and isinstance(node[0], tuple)
            and all(isinstance(s, int) for s in node[0]))


def fill_tree(shapes, leaf: Callable[[tuple, Any], Any]):
    """Build a tree from a shapes tree: `leaf(shape, init)` makes each
    leaf, in the tree's order."""
    if shapes is None:
        return None
    if is_spec(shapes):
        return leaf(*shapes)
    if isinstance(shapes, dict):
        return {k: fill_tree(v, leaf) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [fill_tree(v, leaf) for v in shapes]
    return tuple(fill_tree(v, leaf) for v in shapes)


def init_tree(shapes, generator: torch.Generator, device, dtype):
    """A random params tree with the reference's scheme: normal *
    fan_in**-0.5 (drawn in fp32 on the generator's device), zeros for
    biases, ones for gains, the fixed sinusoids [length, channels]."""

    def leaf(shape, init):
        if init == ZEROS:
            return torch.zeros(shape, dtype=dtype, device=device)
        if init == ONES:
            return torch.ones(shape, dtype=dtype, device=device)
        if init == SINUSOIDS:
            return torch.from_numpy(sinusoids(*shape)).to(device, dtype)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (w * init ** -0.5).to(device=device, dtype=dtype)

    return fill_tree(shapes, leaf)


def params_from_numpy(np_params, cfg, device):
    """Carry a numpy pytree (a JAX params tree through np.asarray, or a
    converted checkpoint) or a tree of tensors to tensors of cfg.dtype on
    `device`, keeping its nesting."""
    if np_params is None:
        return None
    if isinstance(np_params, dict):
        return {k: params_from_numpy(v, cfg, device)
                for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return type(np_params)(params_from_numpy(v, cfg, device)
                               for v in np_params)
    if isinstance(np_params, torch.Tensor):
        return np_params.to(device=device, dtype=cfg.dtype)
    arr = np.array(np_params, dtype=np.float32)
    return torch.from_numpy(arr).to(device=device, dtype=cfg.dtype)


def param_bytes(params) -> int:
    """Bytes of every tensor of a params tree."""
    if params is None:
        return 0
    if isinstance(params, dict):
        return sum(param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(param_bytes(v) for v in params)
    return params.numel() * params.element_size()


# ---------------------------------------------------------------------------
# Convolutions
# ---------------------------------------------------------------------------

def same_pad(length: int, width: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding (low, high) of one axis: the output has
    ceil(length / stride) positions, the extra pad goes high."""
    out = -(-length // stride)
    total = max((out - 1) * stride + width - length, 0)
    return total // 2, total - total // 2


def fp32_convolutions(x: torch.Tensor) -> None:
    """Keep cuDNN's convolutions of x's device in true fp32, as the
    reference computes them. PyTorch lets cuDNN run fp32 convolutions in
    TF32 (10-bit mantissas) unless told otherwise, and a 20-step DDIM run
    multiplies a relative change of the UNet's output about a thousandfold
    in the image. The switch belongs to the process: it is turned off here,
    before each convolution, and never turned back on, so the server's
    request threads have no save-and-restore to race. fp32 matrix products
    keep PyTorch's own default, which is not TF32."""
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# The reference's flat safetensors checkpoint
# ---------------------------------------------------------------------------

def flatten(params, prefix: str = "") -> dict:
    """{"a.b.0": tensor} of a tree: dict keys and list / tuple indices
    joined with "." (None leaves are left out)."""
    flat = {}
    if params is None:
        return flat
    if isinstance(params, dict):
        items = params.items()
    elif isinstance(params, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(params))
    else:
        return {prefix: params}
    for k, v in items:
        flat.update(flatten(v, f"{prefix}.{k}" if prefix else k))
    return flat


def unflatten(flat: dict, shapes):
    """The tree of a shapes tree's nesting with each (shape, init) leaf
    taken from flat names; a leaf missing from `flat` raises KeyError."""

    def build(node, prefix):
        if is_spec(node):
            return flat[prefix]
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, f"{prefix}.{i}")
                              for i, v in enumerate(node))
        raise TypeError(f"{prefix}: not a shapes tree node")

    return build(shapes, "")


def save_flat_checkpoint(path: str, model_type: str, meta: dict,
                         params) -> None:
    """model.safetensors of the flattened tree (float32) and config.json
    `{"model_type": ..., **meta}`: the reference's format."""
    from llmlb_tpu_torch.engine.safetensors_io import save_file

    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().float() for k, v in flatten(params).items()}
    save_file(flat, os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_type": model_type, **meta}, f)


def load_flat_checkpoint(path: str) -> tuple[dict, dict]:
    """(config.json without model_type, {name: float32 numpy array})."""
    from llmlb_tpu_torch.engine.safetensors_io import SafetensorsFile

    with open(os.path.join(path, "config.json")) as f:
        meta = json.load(f)
    meta.pop("model_type", None)
    st = SafetensorsFile(os.path.join(path, "model.safetensors"))
    return meta, {k: st.get_tensor(k) for k in st.keys()}
