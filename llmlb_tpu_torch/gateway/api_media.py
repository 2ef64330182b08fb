"""Audio + image routes: capability-routed proxies.

Parity with reference api/audio.rs (:199-370 transcriptions multipart re-proxy,
:377 speech) and api/images.rs (:184/:284/:508 generations/edits/variations,
capability selection :158-182): the gateway validates, selects an endpoint
advertising the capability, and re-proxies JSON or multipart bodies.

The port's copy of llmlb_tpu/gateway/api_media.py. The client's form is read
by gateway/http.py's multipart reader and sent on as its FormData.
"""

from __future__ import annotations

import asyncio
import time

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway.api_openai import (
    QueueTimeout,
    _record,
    error_response,
)
from llmlb_tpu_torch.gateway.resilience import (
    RETRYABLE_EXCEPTIONS,
    FailoverController,
    retry_after_seconds,
    upstream_post,
)
from llmlb_tpu_torch.gateway.types import Capability, TpsApiKind


def _capability_pairs(state, capability: Capability, model: str | None):
    pairs = state.registry.list_online_by_capability(capability)
    if model:
        pairs = [
            (ep, m) for ep, m in pairs
            if m.canonical_name == model or m.model_id == model
        ]
    return pairs


async def _admit_by_capability(state, capability: Capability,
                               model: str | None,
                               exclude: set[str] | None = None,
                               queue_timeout_s: float | None = None):
    """Atomic admission on the capability-filtered pool; parks on the
    AdmissionQueue (same machinery as /v1/chat) when all slots are taken.
    `exclude` drops endpoints that already failed this request (failover)."""
    if not _capability_pairs(state, capability, model):
        return None
    schedule_key = model or capability.value

    def get_endpoints():
        return [
            ep for ep, _ in _capability_pairs(state, capability, model)
            if not exclude or ep.id not in exclude
        ]

    result = await state.admission.admit(
        get_endpoints, schedule_key, TpsApiKind.OTHER,
        timeout_s=queue_timeout_s,
    )
    if not result.admitted:
        raise QueueTimeout(result.queue_position, result.waited_s)
    pairs = _capability_pairs(state, capability, model)
    engine_model = next(
        (m.model_id for ep, m in pairs if ep.id == result.endpoint.id),
        model or "",
    )
    return result.endpoint, engine_model, result.lease


async def _read_multipart(request: web.Request) -> list[dict]:
    """Buffer the client's multipart form once so each failover attempt can
    re-emit a fresh FormData toward a different endpoint (the request body
    can only be read from the socket once)."""
    reader = await request.multipart()
    parts: list[dict] = []
    async for part in reader:
        name = part.name or "file"
        if part.filename:
            parts.append({
                "name": name,
                "data": await part.read(decode=False),
                "filename": part.filename,
                "content_type": part.headers.get("Content-Type"),
            })
        else:
            parts.append({
                "name": name,
                "value": (await part.read(decode=True)).decode(
                    errors="replace"
                ),
            })
    return parts


def _build_form(parts: list[dict], model_override: str | None) -> http.FormData:
    form = http.FormData()
    for p in parts:
        if "filename" in p:
            form.add_field(p["name"], p["data"], filename=p["filename"],
                           content_type=p["content_type"])
        else:
            value = p["value"]
            if p["name"] == "model" and model_override:
                value = model_override
            form.add_field(p["name"], value)
    return form


async def _media_proxy(
    request: web.Request, capability: Capability, path: str,
    multipart: bool,
) -> web.Response:
    state = request.app["state"]
    started = time.monotonic()
    model = None
    body = None
    if not multipart:
        try:
            body = await request.json()
        except Exception:
            return error_response(400, "invalid JSON body")
        model = body.get("model")
        if capability == Capability.IMAGE_GENERATION:
            prompt = body.get("prompt")
            if not prompt or not isinstance(prompt, str):
                return error_response(400, "'prompt' is required")
            n = body.get("n", 1)
            if not isinstance(n, int) or not 1 <= n <= 10:
                return error_response(400, "'n' must be between 1 and 10")
    else:
        if not (request.content_type or "").startswith("multipart/"):
            return error_response(400, "multipart/form-data body required")

    # Multipart bodies are buffered once up front so every failover attempt
    # can re-emit them (the client socket can only be read once). A client
    # aborting mid-upload is its failure, not ours — a clean 400, no
    # endpoint involved yet.
    parts = None
    if multipart:
        try:
            parts = await _read_multipart(request)
        except (http.ClientError, asyncio.TimeoutError, OSError,
                ConnectionResetError, ValueError) as e:
            return error_response(
                400, f"could not read multipart body: {type(e).__name__}"
            )
    schedule_key = model or capability.value
    fo = FailoverController(
        state, schedule_key,
        candidates_fn=lambda: [
            ep for ep, _ in _capability_pairs(state, capability, model)
        ],
    )
    while True:
        try:
            selection = await _admit_by_capability(
                state, capability, model, exclude=fo.failed_ids,
                queue_timeout_s=(fo.config.failover_queue_timeout_s
                                 if fo.failed_ids else None),
            )
        except QueueTimeout as qt:
            return error_response(
                503,
                f"all endpoints busy; queue timeout exceeded "
                f"(position {qt.queue_position})",
                "server_error",
                headers={"Retry-After": str(
                    retry_after_seconds(state, model, capability)
                )},
            )
        if selection is None:
            return error_response(
                404,
                f"no online endpoint provides capability {capability.value!r}"
                + (f" for model {model!r}" if model else ""),
            )
        endpoint, engine_model, lease = selection
        headers = {}
        if endpoint.api_key:
            headers["Authorization"] = f"Bearer {endpoint.api_key}"
        upstream = None
        try:
            if multipart:
                upstream = await upstream_post(
                    state, endpoint, path,
                    data=_build_form(parts, engine_model),
                    headers=headers,
                    timeout=http.ClientTimeout(
                        total=state.config.inference_timeout_s
                    ),
                )
            else:
                payload = dict(body)
                if model:
                    payload["model"] = engine_model
                upstream = await upstream_post(
                    state, endpoint, path, json=payload, headers=headers,
                    timeout=http.ClientTimeout(
                        total=state.config.inference_timeout_s
                    ),
                )
            raw = await upstream.read()
            ctype = upstream.headers.get("Content-Type", "application/json")
            status = upstream.status
            upstream.release()
        except RETRYABLE_EXCEPTIONS as e:
            if upstream is not None:  # failed mid-read: reclaim the pooled
                upstream.release()    # connection before retrying
            reason = ("timeout" if isinstance(e, asyncio.TimeoutError)
                      else "connect_error")
            fo.record_failure(endpoint, lease, reason)
            if await fo.should_retry(reason):
                continue
            _record(state, endpoint=endpoint, model=model or capability.value,
                    api_kind=TpsApiKind.OTHER, path=path, status=502,
                    started=started, client_ip=request.remote,
                    auth=request.get("auth"), error=str(e))
            return error_response(
                502, f"upstream endpoint unreachable: {type(e).__name__}",
                "server_error",
            )

        if status in fo.config.retryable_statuses:
            reason = f"http_{status}"
            fo.record_failure(endpoint, lease, reason)
            if await fo.should_retry(reason):
                continue
        elif status >= 400:
            # non-retryable upstream error: alive, not sick — resolves a
            # half-open probe
            lease.fail()
            fo.record_alive(endpoint)
        else:
            lease.complete()
            fo.record_success(endpoint)
        _record(state, endpoint=endpoint, model=model or capability.value,
                api_kind=TpsApiKind.OTHER, path=path, status=status,
                started=started, client_ip=request.remote,
                auth=request.get("auth"))
        return web.Response(
            body=raw, status=status, content_type=ctype.split(";")[0]
        )


async def audio_transcriptions(request: web.Request) -> web.Response:
    return await _media_proxy(
        request, Capability.AUDIO_TRANSCRIPTION, "/v1/audio/transcriptions",
        multipart=True,
    )


async def audio_speech(request: web.Request) -> web.Response:
    return await _media_proxy(
        request, Capability.AUDIO_SPEECH, "/v1/audio/speech", multipart=False
    )


async def images_generations(request: web.Request) -> web.Response:
    return await _media_proxy(
        request, Capability.IMAGE_GENERATION, "/v1/images/generations",
        multipart=False,
    )


async def images_edits(request: web.Request) -> web.Response:
    return await _media_proxy(
        request, Capability.IMAGE_GENERATION, "/v1/images/edits", multipart=True
    )


async def images_variations(request: web.Request) -> web.Response:
    return await _media_proxy(
        request, Capability.IMAGE_GENERATION, "/v1/images/variations",
        multipart=True,
    )
