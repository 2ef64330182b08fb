"""Model sync: pull an endpoint's model list and refresh the registry.

Parity with reference sync/ (sync_models_with_type sync/mod.rs:104, response
parsing sync/parser.rs:78, capability heuristics sync/capabilities.rs:47-57):
fetches /v1/models (OpenAI shape) or /api/tags (Ollama shape), maps engine
names to canonical names, detects capabilities from name heuristics, and
replaces the endpoint's model set in the registry.
"""

from __future__ import annotations

import logging

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.model_names import to_canonical
from llmlb_tpu_torch.gateway.registry import EndpointRegistry
from llmlb_tpu_torch.gateway.types import Capability, Endpoint, EndpointModel, EndpointType

log = logging.getLogger("llmlb_tpu_torch.gateway.sync")


def capabilities_from_meta(meta: dict) -> list[Capability] | None:
    """Explicit capability advertisement in a /v1/models entry (our tpu://
    engine emits this — engine/server.py list_models). Takes precedence over
    name heuristics; unknown capability strings are ignored."""
    raw = meta.get("capabilities")
    if not isinstance(raw, list):
        return None
    out = []
    for item in raw:
        try:
            out.append(Capability(str(item)))
        except ValueError:
            continue
    return out or None


def detect_capabilities(model_name: str) -> list[Capability]:
    """Name-based capability heuristics (parity: sync/capabilities.rs:47-57)."""
    lowered = model_name.lower()
    if "embed" in lowered or lowered.startswith("bge-") or "-bge" in lowered:
        return [Capability.EMBEDDINGS]
    if "whisper" in lowered:
        return [Capability.AUDIO_TRANSCRIPTION]
    if any(t in lowered for t in ("tts", "speech", "vibevoice", "bark")):
        return [Capability.AUDIO_SPEECH]
    if any(t in lowered for t in ("stable-diffusion", "sdxl", "sd-", "flux")):
        return [Capability.IMAGE_GENERATION]
    return [Capability.CHAT_COMPLETION]


def parse_models_response(body: dict) -> list[dict]:
    """Accept both OpenAI ({"data": [{"id": ...}]}) and Ollama ({"models":
    [{"name"|"model": ...}]}) shapes (parity: sync/parser.rs:78)."""
    models = []
    if isinstance(body.get("data"), list):
        for item in body["data"]:
            if isinstance(item, dict) and item.get("id"):
                models.append({"id": str(item["id"]), "meta": item})
    elif isinstance(body.get("models"), list):
        for item in body["models"]:
            if not isinstance(item, dict):
                continue
            name = item.get("name") or item.get("model")
            if name:
                models.append({"id": str(name), "meta": item})
    return models


async def fetch_endpoint_models(
    endpoint: Endpoint,
    session: http.ClientSession,
    timeout: float = 10.0,
) -> list[EndpointModel]:
    path = "/api/tags" if endpoint.endpoint_type == EndpointType.OLLAMA else "/v1/models"
    headers = {}
    if endpoint.api_key:
        headers["Authorization"] = f"Bearer {endpoint.api_key}"
    async with session.get(
        endpoint.url + path,
        headers=headers,
        timeout=http.ClientTimeout(total=timeout),
    ) as resp:
        if resp.status != 200:
            raise RuntimeError(f"{path} returned {resp.status}")
        body = await resp.json(content_type=None)
    if not isinstance(body, dict):
        raise RuntimeError(f"unexpected {path} payload")

    out = []
    for m in parse_models_response(body):
        engine_name = m["id"]
        context_length = None
        meta = m.get("meta") or {}
        for key in ("context_length", "max_context_length", "max_model_len"):
            if isinstance(meta.get(key), int):
                context_length = meta[key]
                break
        out.append(
            EndpointModel(
                endpoint_id=endpoint.id,
                model_id=engine_name,
                canonical_name=to_canonical(engine_name),
                capabilities=(
                    capabilities_from_meta(meta) or detect_capabilities(engine_name)
                ),
                context_length=context_length,
            )
        )
    return out


async def sync_endpoint_models(
    endpoint: Endpoint,
    registry: EndpointRegistry,
    session: http.ClientSession,
    timeout: float = 10.0,
) -> tuple[int, int]:
    """Returns (added, removed) vs the previous registry state."""
    from llmlb_tpu_torch.gateway.engine_metadata import enrich_context_lengths

    models = await fetch_endpoint_models(endpoint, session, timeout)
    # per-engine metadata probes (Ollama /api/show etc.) fill in context
    # lengths the /v1/models listing did not carry
    await enrich_context_lengths(endpoint, models, session)
    before = {m.model_id for m in registry.models_for(endpoint.id)}
    after = {m.model_id for m in models}
    registry.sync_models(endpoint.id, models)
    return len(after - before), len(before - after)
