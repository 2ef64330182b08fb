"""Multi-LoRA serving: counterpart of `llmlb_tpu/lora` (docs/lora.md).

- `store`: adapter discovery and safetensors loading (HF/PEFT layout) into
  the stacked tensors the pool rows take.
- `manager`: the device-resident adapter pool: LRU load and eviction,
  refcounts, row 0 the all-zero identity adapter.
- `api`: the `lora` field / `model:adapter` suffix parsing of the request
  surface.

The batched grouped matmul is ops/lora.py (the bgmv kernel); the model
reads the pools as `<name>_lora_a` / `<name>_lora_b` params
(models/llama.py).
"""

from llmlb_tpu_torch.lora.api import (
    LORA_NAME_RE,
    adapter_from_body,
    split_model_adapter,
)
from llmlb_tpu_torch.lora.manager import LoraManager
from llmlb_tpu_torch.lora.store import (
    AdapterInfo,
    discover_adapters,
    load_adapter_tensors,
    lora_target_dims,
    save_adapter,
)

__all__ = [
    "AdapterInfo",
    "LORA_NAME_RE",
    "LoraManager",
    "adapter_from_body",
    "discover_adapters",
    "load_adapter_tensors",
    "lora_target_dims",
    "save_adapter",
    "split_model_adapter",
]
