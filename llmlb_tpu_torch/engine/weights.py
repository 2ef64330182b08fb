"""Weights for the port's engine: HF checkpoints, and a JAX params pytree.

`load_checkpoint` reads a HF checkpoint directory (`config.json` through
`load_config`, one or more `*.safetensors` shards, with or without
`model.safetensors.index.json`) into the port's params on the card: the
counterpart of `llmlb_tpu/engine/weights.py`. HF names map onto the stacked
leaves as the reference maps them (`_param_builders`), each [out, in]
matrix transposed to the [in, out] layout. Loading streams PER LAYER into a
preallocated device tensor: one HF tensor is read on the host in its stored
dtype (a BF16 checkpoint is never widened to fp32 there), copied to the
device, transposed and cast to cfg.dtype into `out[i]`; peak host memory is
one HF tensor, not a stacked leaf. With `quantize_weights=True` each layer
of a projection quantizes on the device right after that cast, with the
same per-layer pass EngineCore's own quantization runs on cfg.dtype weights
(`quant.quantize_params`), so the int8 codes and scales are the ones the
core would make from the same checkpoint, bit for bit. (The reference
quantizes the stored dtype instead; the two differ only for a float32
checkpoint served in bf16.) A Mixtral checkpoint (`model_type` "mixtral")
loads as a MixtralConfig: `block_sparse_moe.gate` is the router and
`experts.{e}.w1` / `w3` / `w2` the gate / up / down experts, each expert
read, transposed and (with `quantize_weights`) quantized on its own, so the
largest temporary is one expert matrix.

`params_from_numpy` carries a params pytree made by the JAX package (as
numpy arrays, leaf for leaf: `{name: np.asarray(leaf)}`) into the port's
tensors. The layouts are the same on both sides — stacked [L, in, out]
matrices, [L, E] norms — so each leaf converts as it is. A pytree quantized
by the JAX package (`quantize_params`) carries int8 weights with float32
`<name>_scale` leaves; those cross bit for bit. LoRA adapter pool leaves
(`<name>_lora_a` [L, N, in, R], `<name>_lora_b` [L, N, R, out]) pass through
in cfg.dtype.
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from llmlb_tpu_torch.device import resolve_device
from llmlb_tpu_torch.engine.safetensors_io import INDEX_NAME, SafetensorsFile
from llmlb_tpu_torch.lora.manager import LORA_A, LORA_B
from llmlb_tpu_torch.lora.store import HF_TARGET_MAP, lora_target_dims
from llmlb_tpu_torch.models import config_from_hf, family_for
from llmlb_tpu_torch.models.llama import LlamaConfig
from llmlb_tpu_torch.quant import (
    SCALE_SUFFIX,
    WEIGHT_QUANT_NAMES,
    quantize_channelwise,
)

TensorGetter = Callable[[str], torch.Tensor]

def _param_builders(cfg: LlamaConfig) -> dict[str, tuple[str, bool, bool]]:
    """Leaf name -> (HF tensor name, with `{i}` for a per-layer tensor and
    `{e}` for a per-expert one; stacked over layers; transposed) in the
    reference's pytree order: the HF name map of
    `llmlb_tpu/engine/weights.py`, the feed-forward's from the family
    (Llama's mlp, Mixtral's `_moe_param_builders`)."""
    layer = "model.layers.{i}."
    names = {
        "embed": ("model.embed_tokens.weight", False, False),
        "wq": (layer + "self_attn.q_proj.weight", True, True),
        "wk": (layer + "self_attn.k_proj.weight", True, True),
        "wv": (layer + "self_attn.v_proj.weight", True, True),
        "wo": (layer + "self_attn.o_proj.weight", True, True),
    }
    names.update({leaf: (layer + hf, True, True)
                  for leaf, hf in family_for(cfg).HF_FFN_NAMES.items()})
    names.update({
        "ln_attn": (layer + "input_layernorm.weight", True, False),
        "ln_mlp": (layer + "post_attention_layernorm.weight", True, False),
        "ln_final": ("model.norm.weight", False, False),
    })
    if cfg.attention_bias:
        for leaf, proj in (("bq", "q"), ("bk", "k"), ("bv", "v")):
            names[leaf] = (layer + f"self_attn.{proj}_proj.bias", True, False)
    if not cfg.tie_word_embeddings:
        names["lm_head"] = ("lm_head.weight", False, True)
    return names


def _cells(cfg: LlamaConfig, fmt: str, stacked: bool):
    """(HF name, leaf index) of each tensor of one leaf: per layer when
    stacked, per (layer, expert) when the name has an `{e}`."""
    if not stacked:
        return [(fmt, ())]
    experts = range(cfg.num_experts) if "{e}" in fmt else (None,)
    return [(fmt.format(i=i, e=e), (i,) if e is None else (i, e))
            for i in range(cfg.num_layers) for e in experts]


def hf_tensors(params: dict, cfg: LlamaConfig) -> dict:
    """The inverse map: `{HF name: tensor}` of a params dict (torch tensors
    or numpy arrays), each a view of its leaf ([out, in] matrices as
    transposed views). Writing them with safetensors_io makes a checkpoint
    load_checkpoint reads back bit for bit."""
    out = {}
    for name, (fmt, stacked, transpose) in _param_builders(cfg).items():
        leaf = params[name]
        for hf_name, at in _cells(cfg, fmt, stacked):
            w = leaf[at]
            out[hf_name] = w.T if transpose else w
    return out


def hf_config(cfg: LlamaConfig, model_type: str = "llama") -> dict:
    """A HF `config.json` dict that load_config reads back as `cfg` (in
    its dtype): how a checkpoint is written from a preset."""
    out = {
        "architectures": ["Qwen2ForCausalLM" if model_type == "qwen2"
                          else "LlamaForCausalLM"],
        "model_type": model_type,
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "intermediate_size": cfg.intermediate_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "num_key_value_heads": cfg.num_kv_heads,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_eps,
        "attention_bias": cfg.attention_bias,
        "tie_word_embeddings": cfg.tie_word_embeddings,
        "max_position_embeddings": cfg.max_position_embeddings,
        "torch_dtype": str(cfg.dtype).replace("torch.", ""),
    }
    out.update(family_for(cfg).hf_config_fields(cfg))
    if cfg.head_dim is not None:
        out["head_dim"] = cfg.head_dim
    rs = cfg.rope_scaling
    if rs is not None:
        out["rope_scaling"] = {
            "rope_type": "llama3", "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings": rs.original_max_position}
    return out


def _safetensors_getter(model_dir: str) -> TensorGetter:
    """A name -> host tensor getter over every shard of a checkpoint: the
    index's weight_map when there is one, else every *.safetensors file."""
    index_path = os.path.join(model_dir, INDEX_NAME)
    name_to_file: dict[str, str] = {}
    if os.path.exists(index_path):
        with open(index_path) as f:
            name_to_file = json.load(f)["weight_map"]
    else:
        for fname in sorted(os.listdir(model_dir)):
            if fname.endswith(".safetensors"):
                for key in SafetensorsFile(os.path.join(model_dir,
                                                        fname)).keys():
                    name_to_file[key] = fname
    if not name_to_file:
        raise FileNotFoundError(f"{model_dir}: no safetensors checkpoint")
    handles: dict[str, SafetensorsFile] = {}

    def get(name: str) -> torch.Tensor:
        fname = name_to_file.get(name)
        if fname is None:
            raise KeyError(f"{model_dir}: the checkpoint has no tensor "
                           f"{name!r}")
        if fname not in handles:
            handles[fname] = SafetensorsFile(os.path.join(model_dir, fname))
        return handles[fname].get_torch(name)

    return get


def load_config(model_dir: str, dtype=None) -> LlamaConfig:
    """The config of a checkpoint's `config.json` (bf16 unless `dtype` says
    otherwise): a MixtralConfig for a Mixtral checkpoint, as the reference
    reads it, else a LlamaConfig."""
    with open(os.path.join(model_dir, "config.json")) as f:
        hf = json.load(f)
    return config_from_hf(hf, **({} if dtype is None else {"dtype": dtype}))


def load_checkpoint(model_dir: str, cfg: LlamaConfig,
                    device: torch.device | str | None = None,
                    quantize_weights: bool = False) -> dict[str, torch.Tensor]:
    """Load a HF checkpoint directory into params on `device` (the card
    unless "cpu"), streaming one HF tensor at a time into preallocated
    leaves; with `quantize_weights`, the projection matrices as int8 codes
    with float32 `<name>_scale` companions, quantized layer by layer on the
    device after the cast to cfg.dtype. A missing tensor or a shape that
    is not the config's raises."""
    dev = resolve_device(device)
    get = _safetensors_getter(model_dir)
    builders = _param_builders(cfg)
    quantized = tuple(n for n in WEIGHT_QUANT_NAMES
                      if quantize_weights and n in builders)
    shapes = family_for(cfg).param_shapes(cfg, quantized)
    params: dict[str, torch.Tensor] = {}
    for name, (fmt, stacked, transpose) in builders.items():
        shape = shapes[name][0]
        if name in quantized:
            out = torch.empty(shape, dtype=torch.int8, device=dev)
            scale = torch.empty(shapes[name + SCALE_SUFFIX][0],
                                dtype=torch.float32, device=dev)
        else:
            out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for hf_name, at in _cells(cfg, fmt, stacked):
            w = get(hf_name).to(dev)
            w = w.T if transpose else w
            dst = out[at]
            if tuple(w.shape) != tuple(dst.shape):
                raise ValueError(f"{hf_name}: shape "
                                 f"{tuple(w.shape)} for leaf {name!r}, the "
                                 f"config implies {tuple(dst.shape)}")
            if name in quantized:
                out[at], scale[at] = quantize_channelwise(w.to(cfg.dtype))
            else:
                dst.copy_(w)
            del w
        params[name] = out
        if name in quantized:
            params[name + SCALE_SUFFIX] = scale
    return params


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
    expected = family_for(cfg).param_shapes(cfg, quantized)
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
