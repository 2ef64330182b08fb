"""Per-endpoint device/system probes for the admin API.

Parity with reference system_info/ (dispatch get_endpoint_system_info
mod.rs:31; llama.cpp /slots probe with /metrics fallback llamacpp.rs:40):
given an endpoint, ask ITS runtime what hardware/capacity sits behind it and
normalize the answer into one shape the dashboard can render. TPU engines
report chip/HBM telemetry (richer than the reference's GPU fields); llama.cpp
reports slot count and context sizes; Ollama reports loaded models and their
VRAM; xLLM-style engines report their /api/system body.

The port's copy of llmlb_tpu/gateway/system_info.py. For a `tpu` endpoint
the port's engine answers /api/health under the same keys.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.types import Endpoint, EndpointType

log = logging.getLogger("llmlb_tpu_torch.gateway.system_info")

PROBE_TIMEOUT_S = 5.0


async def _get_json(session: http.ClientSession, url: str,
                    headers: dict) -> Any | None:
    try:
        async with session.get(
            url, headers=headers,
            timeout=http.ClientTimeout(total=PROBE_TIMEOUT_S),
        ) as resp:
            if resp.status != 200:
                return None
            return await resp.json(content_type=None)
    except (http.ClientError, asyncio.TimeoutError, OSError, ValueError):
        return None


async def _get_text(session: http.ClientSession, url: str,
                    headers: dict) -> str | None:
    try:
        async with session.get(
            url, headers=headers,
            timeout=http.ClientTimeout(total=PROBE_TIMEOUT_S),
        ) as resp:
            if resp.status != 200:
                return None
            return await resp.text()
    except (http.ClientError, asyncio.TimeoutError, OSError):
        return None


async def _llama_cpp_info(ep: Endpoint, session, headers) -> dict | None:
    """/slots preferred (slot count + per-slot n_ctx), /metrics fallback —
    the reference's two-strategy probe (llamacpp.rs:40)."""
    slots = await _get_json(session, ep.url + "/slots", headers)
    if isinstance(slots, list) and slots:
        n_ctx = [s.get("n_ctx") for s in slots
                 if isinstance(s, dict) and isinstance(s.get("n_ctx"), int)]
        return {
            "device": "llama.cpp",
            "parallel_slots": len(slots),
            "n_ctx": max(n_ctx) if n_ctx else None,
            "busy_slots": sum(
                1 for s in slots
                if isinstance(s, dict) and s.get("is_processing")
            ),
            "source": "slots",
        }
    metrics = await _get_text(session, ep.url + "/metrics", headers)
    if metrics:
        kv_used = None
        for line in metrics.splitlines():
            if line.startswith("llamacpp:kv_cache_tokens"):
                try:
                    kv_used = float(line.split()[-1])
                except (ValueError, IndexError):
                    pass
        return {
            "device": "llama.cpp",
            "kv_cache_tokens": kv_used,
            "source": "metrics",
        }
    return None


async def _tpu_info(ep: Endpoint, session, headers) -> dict | None:
    body = await _get_json(session, ep.url + "/api/health", headers)
    if not isinstance(body, dict):
        return None
    tpu = body.get("tpu") if isinstance(body.get("tpu"), dict) else {}
    engine = body.get("engine") if isinstance(body.get("engine"), dict) else {}
    disagg = body.get("disagg") if isinstance(body.get("disagg"), dict) else {}
    return {
        "device": tpu.get("device_kind") or tpu.get("accelerator") or "tpu",
        "chip_count": tpu.get("chip_count"),
        "hbm_used_bytes": tpu.get("hbm_used_bytes"),
        "hbm_total_bytes": tpu.get("hbm_total_bytes"),
        "num_slots": engine.get("num_slots"),
        "active_slots": engine.get("active_slots"),
        "queued": engine.get("queued"),
        # disaggregation role + live handoff figures (docs/disaggregation.md)
        "role": disagg.get("role") or "both",
        "handoff_backlog": disagg.get("handoff_backlog"),
        "source": "api_health",
    }


async def _ollama_info(ep: Endpoint, session, headers) -> dict | None:
    version, ps = await asyncio.gather(
        _get_json(session, ep.url + "/api/version", headers),
        _get_json(session, ep.url + "/api/ps", headers),
    )
    if version is None and ps is None:
        return None
    loaded = []
    vram = 0
    vram_known = False
    models = (ps or {}).get("models") if isinstance(ps, dict) else None
    for m in models or []:
        if isinstance(m, dict):
            loaded.append(m.get("name"))
            if "size_vram" in m:
                vram_known = True
                vram += m.get("size_vram") or 0
    return {
        "device": "ollama",
        "version": (version or {}).get("version")
        if isinstance(version, dict) else None,
        "loaded_models": loaded,
        # 0 with the field present means "CPU-resident" (a real state);
        # None means the runtime never reported VRAM at all
        "vram_bytes": vram if vram_known else None,
        "source": "api_version+ps",
    }


async def _xllm_info(ep: Endpoint, session, headers) -> dict | None:
    body = await _get_json(session, ep.url + "/api/system", headers)
    if not isinstance(body, dict):
        return None
    return {"device": "xllm", "system": body, "source": "api_system"}


async def get_endpoint_system_info(
    ep: Endpoint, session: http.ClientSession
) -> dict | None:
    """Dispatch on endpoint type (system_info/mod.rs:31). None when the
    runtime exposes nothing usable."""
    headers = {}
    if ep.api_key:
        headers["Authorization"] = f"Bearer {ep.api_key}"
    if ep.endpoint_type == EndpointType.LLAMA_CPP:
        return await _llama_cpp_info(ep, session, headers)
    if ep.endpoint_type == EndpointType.TPU:
        return await _tpu_info(ep, session, headers)
    if ep.endpoint_type == EndpointType.OLLAMA:
        return await _ollama_info(ep, session, headers)
    if ep.endpoint_type == EndpointType.XLLM:
        return await _xllm_info(ep, session, headers)
    return None
