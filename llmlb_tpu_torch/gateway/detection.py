"""Endpoint type auto-detection by probe priority.

Parity with reference detection/mod.rs probe order, with `tpu` probed FIRST
(our in-tree engine marks itself via GET /api/system → {"tpu_engine": true}):

    tpu > xllm (/api/system w/ xllm_version) > lm_studio (/api/v1/models)
    > ollama (/api/tags) > vllm (Server header) > llama_cpp (Server header or
    /v1/version) > openai_compatible (/v1/models)

Distinguishes Unreachable (no TCP/HTTP at all) from UnsupportedType (answers,
but no probe matches) like the reference does.
"""

from __future__ import annotations

import asyncio

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.types import EndpointType


class DetectionError(Exception):
    pass


class Unreachable(DetectionError):
    pass


class UnsupportedType(DetectionError):
    pass


async def _get(
    session: http.ClientSession, url: str, timeout: float
) -> tuple[int, dict | None, dict]:
    """GET returning (status, json_or_none, headers). Raises on transport error."""
    async with session.get(
        url, timeout=http.ClientTimeout(total=timeout)
    ) as resp:
        try:
            body = await resp.json(content_type=None)
        except Exception:
            body = None
        return resp.status, body if isinstance(body, dict) else None, dict(resp.headers)


async def detect_endpoint_type(
    base_url: str,
    session: http.ClientSession,
    timeout: float = 5.0,
    api_key: str | None = None,
) -> EndpointType:
    base = base_url.rstrip("/")
    reachable = False

    async def probe(path: str):
        nonlocal reachable
        try:
            status, body, headers = await _get(session, base + path, timeout)
            reachable = True
            return status, body, headers
        except (http.ClientError, asyncio.TimeoutError, OSError):
            return None, None, {}

    # 1. tpu / xllm — both live on /api/system
    status, body, _ = await probe("/api/system")
    if status == 200 and body:
        if body.get("tpu_engine"):
            return EndpointType.TPU
        if "xllm_version" in body:
            return EndpointType.XLLM

    # 2. LM Studio
    status, body, _ = await probe("/api/v1/models")
    if status == 200 and body is not None:
        return EndpointType.LM_STUDIO

    # 3. Ollama
    status, body, _ = await probe("/api/tags")
    if status == 200 and body is not None and "models" in body:
        return EndpointType.OLLAMA

    # 4/5/6. /v1/models + Server header discrimination
    status, body, headers = await probe("/v1/models")
    if status == 200 and body is not None:
        server = headers.get("Server", "").lower()
        if "vllm" in server:
            return EndpointType.VLLM
        if "llama.cpp" in server or "llama-cpp" in server:
            return EndpointType.LLAMA_CPP
        vstatus, vbody, _ = await probe("/v1/version")
        if vstatus == 200 and vbody is not None and (
            "build" in vbody or "llama" in str(vbody.get("version", "")).lower()
        ):
            return EndpointType.LLAMA_CPP
        return EndpointType.OPENAI_COMPATIBLE

    if not reachable:
        raise Unreachable(f"no HTTP service responding at {base}")
    raise UnsupportedType(f"{base} answers HTTP but matches no known endpoint type")
