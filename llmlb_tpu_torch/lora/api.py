"""The LoRA request surface of the engine server: the port's own copy of
`llmlb_tpu/lora/api.py`, the module the gateway validates with, unchanged,
so a body is refused alike at either layer.

An adapter is selected two ways (docs/lora.md):

- model-name suffix: `"model": "llama-3-8b:acme-support"` — the part after
  the LAST colon names the adapter;
- explicit field: `"lora": "acme-support"` with the bare base model name.

Both present and disagreeing is a 400 naming the `lora` field. Whether the
adapter exists is the engine's call (LoraManager.validate).
"""

from __future__ import annotations

import re

# Adapter names reach file paths (store.discover_adapters scans
# directories by name), metrics labels, and model-name suffixes — one
# conservative charset for all three.
LORA_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._\-]{0,63}$")


def split_model_adapter(model: str | None) -> tuple[str | None, str | None]:
    """Split `base:adapter` on the LAST colon. Returns (base, adapter) —
    (model, None) when there is no adapter-shaped suffix. Purely
    syntactic: the caller decides whether the suffix really is an adapter
    (a registry may know the full string as a literal model name)."""
    if not model or not isinstance(model, str) or ":" not in model:
        return model, None
    base, _, cand = model.rpartition(":")
    if not base or not LORA_NAME_RE.match(cand):
        return model, None
    return base, cand


def adapter_from_body(body: dict) -> tuple[str | None, str | None]:
    """Resolve (base_model, adapter) from a chat-shaped body: the explicit
    `lora` field and/or the model-name suffix. Raises ValueError naming the
    `lora` field for malformed values or a field/suffix conflict — both
    layers map it to a 400 in their own dialect's error shape."""
    explicit = body.get("lora")
    if explicit is not None:
        if not isinstance(explicit, str) or not explicit:
            raise ValueError("'lora' must be a non-empty string naming an "
                             "adapter")
        if not LORA_NAME_RE.match(explicit):
            raise ValueError(
                "'lora' must match [A-Za-z0-9][A-Za-z0-9._-]{0,63}"
            )
    base, suffix = split_model_adapter(body.get("model"))
    if explicit is not None and suffix is not None and explicit != suffix:
        raise ValueError(
            f"'lora' ({explicit!r}) conflicts with the model-name suffix "
            f"({suffix!r}); use one or make them agree"
        )
    adapter = explicit or suffix
    if adapter is None:
        return body.get("model"), None
    return (base if suffix is not None else body.get("model")), adapter
