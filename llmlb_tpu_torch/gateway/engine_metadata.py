"""Per-engine model metadata probes (context length and friends).

Parity with reference metadata/ (Ollama `/api/show` context-length extraction,
metadata/ollama.rs:221 and is_context_length_key :67-76; LM Studio model
listing fields). The sync path calls these to enrich models whose `/v1/models`
entry carried no context length — the dashboard and admission logic use it.
"""

from __future__ import annotations

import asyncio
import logging

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.types import Endpoint, EndpointType

log = logging.getLogger("llmlb_tpu_torch.gateway.metadata")


def _context_length_from(obj) -> int | None:
    """Search a metadata mapping for a context-length-ish key. Engines bury
    it under arch-prefixed keys ('llama.context_length'), plain keys, or
    nested dicts."""
    if not isinstance(obj, dict):
        return None
    for key, value in obj.items():
        k = str(key).lower()
        if (k in ("context_length", "max_context_length", "num_ctx",
                  "max_model_len", "loaded_context_length")
                or k.endswith(".context_length")
                or k.endswith("_context_length")):
            try:
                n = int(value)
            except (TypeError, ValueError):
                continue
            if n > 0:
                return n
    for value in obj.values():  # one level of nesting (model_info, details)
        if isinstance(value, dict):
            n = _context_length_from(value)
            if n:
                return n
    return None


async def fetch_context_length(
    ep: Endpoint,
    model_id: str,
    session: http.ClientSession,
    timeout: float = 5.0,
) -> int | None:
    """Engine-specific context-length probe; None when the engine doesn't
    expose one (or the probe fails — metadata must never break a sync)."""
    headers = {}
    if ep.api_key:
        headers["Authorization"] = f"Bearer {ep.api_key}"
    try:
        if ep.endpoint_type == EndpointType.OLLAMA:
            async with session.post(
                ep.url + "/api/show", json={"name": model_id},
                headers=headers,
                timeout=http.ClientTimeout(total=timeout),
            ) as resp:
                if resp.status != 200:
                    return None
                body = await resp.json(content_type=None)
            return _context_length_from(body if isinstance(body, dict) else {})
        if ep.endpoint_type == EndpointType.LM_STUDIO:
            listing = await _lm_studio_listing(ep, session, timeout)
            return _context_length_from(listing.get(model_id, {}))
    except (http.ClientError, asyncio.TimeoutError, OSError, ValueError):
        return None
    return None


async def _lm_studio_listing(
    ep: Endpoint, session: http.ClientSession, timeout: float = 5.0
) -> dict[str, dict]:
    """One fetch of LM Studio's /api/v1/models, indexed by model id — the
    listing carries every model's metadata, so per-model fetches are waste."""
    headers = {}
    if ep.api_key:
        headers["Authorization"] = f"Bearer {ep.api_key}"
    try:
        async with session.get(
            ep.url + "/api/v1/models", headers=headers,
            timeout=http.ClientTimeout(total=timeout),
        ) as resp:
            if resp.status != 200:
                return {}
            body = await resp.json(content_type=None)
    except (http.ClientError, asyncio.TimeoutError, OSError, ValueError):
        return {}
    entries = body.get("data") if isinstance(body, dict) else None
    return {
        e["id"]: e for e in entries or []
        if isinstance(e, dict) and "id" in e
    }


async def enrich_context_lengths(
    ep: Endpoint,
    models: list,
    session: http.ClientSession,
    *,
    concurrency: int = 4,
) -> None:
    """Fill missing context_length on EndpointModel entries in place."""
    targets = [m for m in models if m.context_length is None]
    if not targets or ep.endpoint_type not in (
        EndpointType.OLLAMA, EndpointType.LM_STUDIO
    ):
        return
    if ep.endpoint_type == EndpointType.LM_STUDIO:
        listing = await _lm_studio_listing(ep, session)
        for m in targets:
            m.context_length = _context_length_from(
                listing.get(m.model_id, {})
            )
        return
    sem = asyncio.Semaphore(concurrency)

    async def probe(m):
        async with sem:
            m.context_length = await fetch_context_length(
                ep, m.model_id, session
            )

    await asyncio.gather(*(probe(m) for m in targets))
