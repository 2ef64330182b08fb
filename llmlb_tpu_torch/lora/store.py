"""LoRA adapter files: counterpart of `llmlb_tpu/lora/store.py`.

Adapters live as subdirectories of `--lora-dir`, one per adapter, in the
HF/PEFT layout:

    <lora_dir>/<adapter-name>/
        adapter_config.json        # {"r": 8, "lora_alpha": 16,
                                   #  "target_modules": ["q_proj", ...]}
        adapter_model.safetensors  # base_model.model.model.layers.{i}.
                                   #   self_attn.q_proj.lora_A.weight [r, in]
                                   #   ...lora_B.weight [out, r]

Discovery reads only the configs; `load_adapter_tensors` reads the tensors
(through the port's own reader, engine/safetensors_io.py) into per-target
stacked CPU tensor pairs `a [L, in, R]` / `b [L, R, out]` in the model's
[in, out] layout, as the reference's numpy pairs:

- lora_A transposes to [in, r], lora_B to [r, out];
- the PEFT scale alpha/r folds into B: the float32 product of numpy, as the
  reference computes it, rounded to the model dtype by torch (both round to
  nearest even, so the rows are bit for bit the reference's);
- rank pads up to the pool rank R with zero columns/rows;
- a layer or target the adapter does not touch stays zero.

`save_adapter` writes the same layout from the reference's seed rule, so the
same (name, seed) gives the same files (tests and chip_smoke.py make their
adapters with it; it is not a training utility).
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from llmlb_tpu_torch.engine.safetensors_io import SafetensorsFile, save_file

# HF/PEFT module names -> the param dict's projection names.
HF_TARGET_MAP = {
    "q_proj": "wq",
    "k_proj": "wk",
    "v_proj": "wv",
    "o_proj": "wo",
    "gate_proj": "wg",
    "up_proj": "wu",
    "down_proj": "wd",
}
_REVERSE_TARGET_MAP = {v: k for k, v in HF_TARGET_MAP.items()}

CONFIG_FILE = "adapter_config.json"
WEIGHTS_FILE = "adapter_model.safetensors"


def lora_target_dims(cfg, targets: tuple[str, ...]) -> dict[str, tuple[int, int]]:
    """(in_dim, out_dim) per LoRA-targetable projection of a model config:
    the pool row shapes, in the [in, out] layout of models/llama.py."""
    e = cfg.hidden_size
    d = cfg.head_dim_
    h, k = cfg.num_heads, cfg.num_kv_heads
    f = cfg.intermediate_size
    dims = {
        "wq": (e, h * d),
        "wk": (e, k * d),
        "wv": (e, k * d),
        "wo": (h * d, e),
        "wg": (e, f),
        "wu": (e, f),
        "wd": (f, e),
    }
    return {t: dims[t] for t in targets}


@dataclasses.dataclass
class AdapterInfo:
    """One discovered adapter. `error` is None when servable; otherwise the
    reason the engine refuses it with a 400 naming the `lora` field."""

    name: str
    path: str
    rank: int = 0
    alpha: float = 0.0
    targets: tuple[str, ...] = ()
    error: str | None = None


def _read_config(path: str) -> dict:
    with open(os.path.join(path, CONFIG_FILE)) as f:
        return json.load(f)


def discover_adapters(
    lora_dir: str,
    *,
    rank_cap: int,
    allowed_targets: tuple[str, ...],
) -> dict[str, AdapterInfo]:
    """Scan `lora_dir` for adapter subdirectories. Config-only: invalid
    adapters (rank over the cap, unsupported target module, malformed
    config) are kept in the map WITH their error, so a request naming one
    gets a specific 400 instead of a generic "unknown adapter"."""
    out: dict[str, AdapterInfo] = {}
    if not lora_dir or not os.path.isdir(lora_dir):
        return out
    for name in sorted(os.listdir(lora_dir)):
        path = os.path.join(lora_dir, name)
        if not os.path.isdir(path) or not os.path.exists(
            os.path.join(path, WEIGHTS_FILE)
        ):
            continue
        info = AdapterInfo(name=name, path=path)
        try:
            cfg = _read_config(path)
            rank = int(cfg.get("r", 0))
            alpha = float(cfg.get("lora_alpha", rank))
            raw_targets = cfg.get("target_modules") or []
            targets = []
            for m in raw_targets:
                tgt = HF_TARGET_MAP.get(str(m))
                if tgt is None:
                    raise ValueError(
                        f"unsupported target module {m!r} (supported: "
                        f"{', '.join(sorted(HF_TARGET_MAP))})"
                    )
                targets.append(tgt)
            unsupported = [t for t in targets if t not in allowed_targets]
            if unsupported:
                raise ValueError(
                    "target module(s) "
                    + ", ".join(_REVERSE_TARGET_MAP[t] for t in unsupported)
                    + " are not servable for this model family"
                )
            if rank < 1:
                raise ValueError(f"rank must be >= 1, got {rank}")
            if rank > rank_cap:
                raise ValueError(
                    f"rank {rank} exceeds the engine's rank cap {rank_cap} "
                    "(--lora-rank-cap)"
                )
            info.rank = rank
            info.alpha = alpha
            info.targets = tuple(targets)
        except FileNotFoundError:
            info.error = f"missing {CONFIG_FILE}"
        except (ValueError, KeyError, json.JSONDecodeError) as e:
            info.error = str(e)
        out[name] = info
    return out


def load_adapter_tensors(
    info: AdapterInfo,
    cfg,
    *,
    pool_rank: int,
    dtype: torch.dtype,
) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Read one adapter's safetensors into stacked per-target CPU pairs
    `{target: (a [L, in, R], b [L, R, out])}` of `dtype` at the pool rank R.
    The PEFT alpha/r scale folds into B; absent layers/targets stay zero."""
    dims = lora_target_dims(cfg, info.targets)
    layers = cfg.num_layers
    scale = np.float32(info.alpha / info.rank if info.rank else 1.0)
    out: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
    shard = SafetensorsFile(os.path.join(info.path, WEIGHTS_FILE))
    # PEFT prefixes vary (base_model.model., base_model.model.model., plain
    # model.): index every key once by its `layers.{i}.<module>.lora_{A|B}.
    # weight` tail
    by_tail: dict[str, str] = {}
    for key in shard.keys():
        at = key.rfind("layers.")
        if at >= 0:
            by_tail.setdefault(key[at:], key)

    def find(layer: int, module: str, which: str) -> str | None:
        return by_tail.get(
            f"layers.{layer}.{module}.lora_{which}.weight"
        ) or by_tail.get(f"layers.{layer}.mlp.{module}.lora_{which}.weight")

    for tgt in info.targets:
        in_dim, out_dim = dims[tgt]
        module = _REVERSE_TARGET_MAP[tgt]
        if tgt in ("wq", "wk", "wv", "wo"):
            module = f"self_attn.{module}"
        a = torch.zeros((layers, in_dim, pool_rank), dtype=dtype)
        b = torch.zeros((layers, pool_rank, out_dim), dtype=dtype)
        for i in range(layers):
            ka = find(i, module, "A")
            kb = find(i, module, "B")
            if ka is None or kb is None:
                continue  # untouched layer: zero delta
            wa = shard.get_tensor(ka)  # [r, in] float32
            wb = shard.get_tensor(kb)  # [out, r] float32
            r = wa.shape[0]
            if r > pool_rank:
                raise ValueError(
                    f"adapter {info.name!r} layer {i} {module} rank {r} "
                    f"exceeds the pool rank {pool_rank}"
                )
            a[i, :, :r] = torch.from_numpy(np.ascontiguousarray(wa.T))
            b[i, :r, :] = torch.from_numpy(np.ascontiguousarray(wb.T * scale))
        out[tgt] = (a, b)
    shard.close()
    return out


def save_adapter(
    lora_dir: str,
    name: str,
    cfg,
    *,
    rank: int,
    alpha: float | None = None,
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo"),
    seed: int = 0,
    scale: float = 0.25,  # large enough that greedy streams visibly diverge
) -> str:
    """Write a synthetic adapter in the PEFT layout `discover_adapters`
    reads, float32, with the reference's draws: deterministic per
    (name, seed). Returns the adapter path."""
    dims = lora_target_dims(cfg, targets)
    alpha = float(alpha if alpha is not None else rank)
    rng = np.random.default_rng(
        seed + int.from_bytes(name.encode()[:4].ljust(4, b"\0"), "big")
    )
    tensors: dict[str, np.ndarray] = {}
    for tgt in targets:
        in_dim, out_dim = dims[tgt]
        module = _REVERSE_TARGET_MAP[tgt]
        prefix = "self_attn." if tgt in ("wq", "wk", "wv", "wo") else "mlp."
        for i in range(cfg.num_layers):
            key = f"base_model.model.model.layers.{i}.{prefix}{module}"
            tensors[f"{key}.lora_A.weight"] = (
                rng.standard_normal((rank, in_dim)) * scale
            ).astype(np.float32)
            tensors[f"{key}.lora_B.weight"] = (
                rng.standard_normal((out_dim, rank)) * scale
            ).astype(np.float32)
    path = os.path.join(lora_dir, name)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, CONFIG_FILE), "w") as f:
        json.dump({
            "r": rank,
            "lora_alpha": alpha,
            "target_modules": [_REVERSE_TARGET_MAP[t] for t in targets],
        }, f)
    save_file(tensors, os.path.join(path, WEIGHTS_FILE))
    return path
