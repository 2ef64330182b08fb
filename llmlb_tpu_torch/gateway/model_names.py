"""Canonical ↔ engine-local model name mapping.

Same job as reference models/mapping.rs:22-422 (resolve_canonical_any :422,
resolve_engine_name :302): runtimes name the same model differently ("llama3:8b"
on Ollama vs "meta-llama/Meta-Llama-3-8B-Instruct" as a HF repo vs a GGUF file
name on LM Studio). The gateway exposes one canonical name and rewrites the
`model` field to the engine-local alias before proxying. Table-driven with
quantization-suffix parsing; unknown names canonicalize to themselves.
"""

from __future__ import annotations

import re

# canonical -> {endpoint_type_value: engine alias}
_KNOWN: dict[str, dict[str, str]] = {
    "meta-llama/Meta-Llama-3-8B-Instruct": {
        "ollama": "llama3:8b",
        "lm_studio": "meta-llama-3-8b-instruct",
        "tpu": "llama-3-8b",
    },
    "meta-llama/Llama-3.1-8B-Instruct": {
        "ollama": "llama3.1:8b",
        "tpu": "llama-3.1-8b",
    },
    "Qwen/Qwen2.5-0.5B-Instruct": {
        "ollama": "qwen2.5:0.5b",
        "tpu": "qwen2.5-0.5b",
    },
    "mistralai/Mistral-7B-Instruct-v0.3": {
        "ollama": "mistral:7b",
    },
    "openai/whisper-large-v3": {
        "tpu": "whisper-large-v3",
    },
    "stabilityai/stable-diffusion-xl-base-1.0": {
        "tpu": "sdxl",
    },
    "openai/gpt-oss-20b": {
        "ollama": "gpt-oss:20b",
    },
    "meta-llama/Llama-3.2-1B-Instruct": {
        "ollama": "llama3.2:1b",
        "tpu": "llama-3.2-1b",
    },
    "meta-llama/Llama-3.2-3B-Instruct": {
        "ollama": "llama3.2:3b",
    },
    "meta-llama/Llama-2-7b-chat-hf": {
        "ollama": "llama2:7b",
    },
    "mistralai/Mixtral-8x7B-Instruct-v0.1": {
        "ollama": "mixtral:8x7b",
        "tpu": "mixtral-8x7b",
    },
    "Qwen/Qwen2.5-7B-Instruct": {
        "ollama": "qwen2.5:7b",
    },
    "Qwen/Qwen2.5-Coder-7B-Instruct": {
        "ollama": "qwen2.5-coder:7b",
    },
    "google/gemma-2-9b-it": {
        "ollama": "gemma2:9b",
    },
    "microsoft/Phi-3-mini-4k-instruct": {
        "ollama": "phi3:mini",
    },
    "deepseek-ai/DeepSeek-R1-Distill-Qwen-7B": {
        "ollama": "deepseek-r1:7b",
    },
    "TinyLlama/TinyLlama-1.1B-Chat-v1.0": {
        "ollama": "tinyllama:1.1b",
        "tpu": "tinyllama-1.1b",
    },
    "BAAI/bge-m3": {
        "ollama": "bge-m3",
    },
    "nomic-ai/nomic-embed-text-v1.5": {
        "ollama": "nomic-embed-text",
    },
}

_ALIAS_TO_CANONICAL: dict[str, str] = {}
for canonical, aliases in _KNOWN.items():
    _ALIAS_TO_CANONICAL[canonical.lower()] = canonical
    for alias in aliases.values():
        _ALIAS_TO_CANONICAL[alias.lower()] = canonical

# family token -> HF org, for repo guessing on unknown names
# (same job as the reference's HF-repo guess tables, models/mapping.rs)
_FAMILY_ORGS = [
    ("llama", "meta-llama"),
    ("tinyllama", "TinyLlama"),
    ("mixtral", "mistralai"),
    ("mistral", "mistralai"),
    ("qwen", "Qwen"),
    ("gemma", "google"),
    ("phi", "microsoft"),
    ("deepseek", "deepseek-ai"),
    ("whisper", "openai"),
    ("gpt-oss", "openai"),
    ("stable-diffusion", "stabilityai"),
    ("sdxl", "stabilityai"),
    ("bge", "BAAI"),
    ("nomic-embed", "nomic-ai"),
]

_ALIAS_TO_CANONICAL: dict[str, str] = {}
for canonical, aliases in _KNOWN.items():
    _ALIAS_TO_CANONICAL[canonical.lower()] = canonical
    for alias in aliases.values():
        _ALIAS_TO_CANONICAL[alias.lower()] = canonical

_QUANT_SUFFIX = re.compile(
    r"[-_.](q[2-8](_[a-z0-9_]+)?|fp16|f16|bf16|int[48]|awq|gptq|gguf)$", re.I
)


def strip_quant_suffix(name: str) -> str:
    prev = None
    while prev != name:
        prev = name
        name = _QUANT_SUFFIX.sub("", name)
    return name


def to_canonical(name: str) -> str:
    """Resolve any alias (exact, case-insensitive, quant-stripped) to canonical;
    unknown names are their own canonical form."""
    if not name:
        return name
    hit = _ALIAS_TO_CANONICAL.get(name.lower())
    if hit:
        return hit
    stripped = strip_quant_suffix(name)
    hit = _ALIAS_TO_CANONICAL.get(stripped.lower())
    return hit or name


def to_engine_name(canonical: str, endpoint_type: str) -> str:
    """Engine-local alias for an endpoint type; falls back to the canonical."""
    aliases = _KNOWN.get(canonical)
    if aliases and endpoint_type in aliases:
        return aliases[endpoint_type]
    return canonical


def parse_engine_tag(name: str) -> dict:
    """Decompose an engine-style name ('llama3.1:8b-instruct-q4_K_M' or a
    GGUF filename) into family / size / variant / quant — the shape the
    reference's quant-suffix parser produces (api/model_name.rs)."""
    base = name
    if base.lower().endswith(".gguf"):
        base = base[:-5]
    quant = None
    m = _QUANT_SUFFIX.search(base)
    if m:
        quant = m.group(1)
        base = strip_quant_suffix(base)
    family, _, tag = base.partition(":")
    size = None
    variant = []
    for part in re.split(r"[-_.]", tag) if tag else []:
        if re.fullmatch(r"\d+(\.\d+)?[bBmM]", part):
            size = part.lower()
        elif part:
            variant.append(part.lower())
    return {
        "family": family.lower(),
        "size": size,
        "variant": "-".join(variant) or None,
        "quant": quant.lower() if quant else None,
    }


def guess_hf_repo(name: str) -> str | None:
    """Best-effort HF repo id for a bare model name: exact/alias table first,
    then family→org heuristics (catalog + download-flow helper)."""
    canonical = to_canonical(name)
    if "/" in canonical:
        return canonical
    lowered = strip_quant_suffix(canonical.lower().removesuffix(".gguf"))
    for token, org in _FAMILY_ORGS:
        if lowered.startswith(token) or f"-{token}" in lowered:
            bare = lowered.replace(":", "-")
            return f"{org}/{bare}"
    return None
