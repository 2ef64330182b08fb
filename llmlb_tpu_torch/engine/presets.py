"""Named model presets for the port's engine, with torch dtypes.

The port's own copy of `llmlb_tpu/engine/presets.py` (that module imports
jax.numpy): the dense Llama class and the sparse-MoE Mixtral class. Shapes follow
the public model cards; presets let the engine start without a checkpoint
(random weights from a seed).
"""

from __future__ import annotations

import torch

from llmlb_tpu_torch.models.llama import LlamaConfig
from llmlb_tpu_torch.models.mixtral import MixtralConfig
from llmlb_tpu_torch.ops.rope import RopeScaling

PRESETS: dict[str, LlamaConfig] = {
    # sparse-MoE flagship (BASELINE.json config #5); on one 80 GB card it
    # serves with int8 experts (quantize="weights"): bf16 is 93 GB
    "mixtral-8x7b": MixtralConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=1000000.0,
        rms_eps=1e-5, max_position_embeddings=32768,
        num_experts=8, experts_per_token=2,
    ),
    # CI-sized MoE config for unit tests
    "debug-moe-tiny": MixtralConfig(
        vocab_size=512, hidden_size=64, intermediate_size=128,
        num_layers=2, num_heads=4, num_kv_heads=2, dtype=torch.float32,
        max_position_embeddings=128, num_experts=4, experts_per_token=2,
    ),
    # flagship serving target (BASELINE.json config #2)
    "llama-3-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        rms_eps=1e-5, max_position_embeddings=8192,
    ),
    "llama-3.1-8b": LlamaConfig(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_layers=32, num_heads=32, num_kv_heads=8, rope_theta=500000.0,
        rope_scaling=RopeScaling(factor=8.0, low_freq_factor=1.0,
                                 high_freq_factor=4.0, original_max_position=8192),
        rms_eps=1e-5, max_position_embeddings=131072,
    ),
    "tinyllama-1.1b": LlamaConfig(
        vocab_size=32000, hidden_size=2048, intermediate_size=5632,
        num_layers=22, num_heads=32, num_kv_heads=4, rope_theta=10000.0,
        rms_eps=1e-5, max_position_embeddings=2048,
    ),
    "qwen2.5-0.5b": LlamaConfig(
        vocab_size=151936, hidden_size=896, intermediate_size=4864,
        num_layers=24, num_heads=14, num_kv_heads=2, rope_theta=1000000.0,
        rms_eps=1e-6, attention_bias=True, tie_word_embeddings=True,
        max_position_embeddings=32768,
    ),
    # CI-sized config for unit tests
    "debug-tiny": LlamaConfig(
        vocab_size=512, hidden_size=128, intermediate_size=256,
        num_layers=2, num_heads=8, num_kv_heads=4, dtype=torch.float32,
        max_position_embeddings=512,
    ),
}


def get_preset(name: str) -> LlamaConfig:
    try:
        return PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown model preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
