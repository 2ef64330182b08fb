"""Cloud provider proxy: `openai:` / `google:` / `anthropic:` model prefixes.

Parity with reference api/cloud_proxy.rs (CloudProvider trait :34-60, impls
:207/:254/:346, proxy :62-180, env keys :187-204): each provider defines
request transform, auth injection, and response transform back to OpenAI shape.
Keys come from OPENAI_API_KEY / GEMINI_API_KEY|GOOGLE_API_KEY /
ANTHROPIC_API_KEY. Prometheus-style counters exposed at /api/metrics/cloud.

The port's copy of llmlb_tpu/gateway/api_cloud.py, on the standard library's
HTTP client (gateway/http.py). The providers' base URLs are read once, at
import, from LLMLB_OPENAI_BASE_URL, LLMLB_GOOGLE_BASE_URL and
LLMLB_ANTHROPIC_BASE_URL.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
import uuid
from collections import defaultdict

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway.api_openai import error_response
from llmlb_tpu_torch.gateway.resilience import RETRYABLE_EXCEPTIONS, backoff_delay

OPENAI_BASE = os.environ.get("LLMLB_OPENAI_BASE_URL", "https://api.openai.com")
GOOGLE_BASE = os.environ.get(
    "LLMLB_GOOGLE_BASE_URL", "https://generativelanguage.googleapis.com"
)
ANTHROPIC_BASE = os.environ.get(
    "LLMLB_ANTHROPIC_BASE_URL", "https://api.anthropic.com"
)


class CloudMetrics:
    """Process-global counters + latency histogram (cloud_metrics.rs:21-39)."""

    BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

    def __init__(self):
        self.requests: dict[tuple[str, str], int] = defaultdict(int)
        self.latency_buckets: dict[str, list[int]] = defaultdict(
            lambda: [0] * (len(self.BUCKETS) + 1)
        )
        self.latency_sum: dict[str, float] = defaultdict(float)
        self.latency_count: dict[str, int] = defaultdict(int)

    def observe(self, provider: str, status: str, latency_s: float) -> None:
        self.requests[(provider, status)] += 1
        buckets = self.latency_buckets[provider]
        for i, bound in enumerate(self.BUCKETS):
            if latency_s <= bound:
                buckets[i] += 1
                break
        else:
            buckets[-1] += 1
        self.latency_sum[provider] += latency_s
        self.latency_count[provider] += 1

    def render_prometheus(self) -> str:
        lines = [
            "# HELP llmlb_cloud_requests_total Cloud proxy requests",
            "# TYPE llmlb_cloud_requests_total counter",
        ]
        for (provider, status), count in sorted(self.requests.items()):
            lines.append(
                f'llmlb_cloud_requests_total{{provider="{provider}",'
                f'status="{status}"}} {count}'
            )
        lines += [
            "# HELP llmlb_cloud_latency_seconds Cloud request latency",
            "# TYPE llmlb_cloud_latency_seconds histogram",
        ]
        for provider, buckets in sorted(self.latency_buckets.items()):
            cumulative = 0
            for bound, n in zip(self.BUCKETS, buckets):
                cumulative += n
                lines.append(
                    f'llmlb_cloud_latency_seconds_bucket{{provider="{provider}",'
                    f'le="{bound}"}} {cumulative}'
                )
            cumulative += buckets[-1]
            lines.append(
                f'llmlb_cloud_latency_seconds_bucket{{provider="{provider}",'
                f'le="+Inf"}} {cumulative}'
            )
            lines.append(
                f'llmlb_cloud_latency_seconds_sum{{provider="{provider}"}} '
                f"{self.latency_sum[provider]:.6f}"
            )
            lines.append(
                f'llmlb_cloud_latency_seconds_count{{provider="{provider}"}} '
                f"{self.latency_count[provider]}"
            )
        return "\n".join(lines) + "\n"


METRICS = CloudMetrics()


def _api_key(provider: str) -> str | None:
    if provider == "openai":
        return os.environ.get("OPENAI_API_KEY")
    if provider == "google":
        return os.environ.get("GEMINI_API_KEY") or os.environ.get("GOOGLE_API_KEY")
    if provider == "anthropic":
        return os.environ.get("ANTHROPIC_API_KEY")
    return None


# ----------------------------------------------------- provider adaptations


def _openai_to_anthropic_request(body: dict, model: str) -> dict:
    """OpenAI chat body → Anthropic /v1/messages body."""
    messages = []
    system = None
    for m in body.get("messages") or []:
        role = m.get("role")
        if role == "system":
            system = m.get("content")
            continue
        messages.append({"role": role, "content": m.get("content") or ""})
    out = {
        "model": model,
        "messages": messages,
        "max_tokens": body.get("max_tokens")
        or body.get("max_completion_tokens") or 1024,
    }
    if system:
        out["system"] = system
    for k_src, k_dst in (("temperature", "temperature"), ("top_p", "top_p"),
                         ("stop", "stop_sequences"), ("stream", "stream")):
        if body.get(k_src) is not None:
            v = body[k_src]
            if k_dst == "stop_sequences" and isinstance(v, str):
                v = [v]
            out[k_dst] = v
    return out


def _anthropic_to_openai_response(body: dict, model: str) -> dict:
    text = "".join(
        b.get("text", "") for b in body.get("content") or []
        if isinstance(b, dict) and b.get("type") == "text"
    )
    usage = body.get("usage") or {}
    stop_reason = body.get("stop_reason")
    finish = {"end_turn": "stop", "max_tokens": "length",
              "stop_sequence": "stop"}.get(stop_reason, "stop")
    return {
        "id": body.get("id") or f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish,
        }],
        "usage": {
            "prompt_tokens": usage.get("input_tokens", 0),
            "completion_tokens": usage.get("output_tokens", 0),
            "total_tokens": usage.get("input_tokens", 0)
            + usage.get("output_tokens", 0),
        },
    }


def _openai_to_gemini_request(body: dict) -> dict:
    """OpenAI chat body → Gemini generateContent (generationConfig mapping
    parity: cloud_proxy.rs:254-343)."""
    contents = []
    system_instruction = None
    for m in body.get("messages") or []:
        role = m.get("role")
        text = m.get("content")
        if isinstance(text, list):
            text = "".join(
                p.get("text", "") for p in text if isinstance(p, dict)
            )
        if role == "system":
            system_instruction = {"parts": [{"text": text or ""}]}
            continue
        contents.append({
            "role": "user" if role == "user" else "model",
            "parts": [{"text": text or ""}],
        })
    cfg = {}
    if body.get("temperature") is not None:
        cfg["temperature"] = body["temperature"]
    if body.get("top_p") is not None:
        cfg["topP"] = body["top_p"]
    if body.get("max_tokens") is not None:
        cfg["maxOutputTokens"] = body["max_tokens"]
    stop = body.get("stop")
    if stop:
        cfg["stopSequences"] = [stop] if isinstance(stop, str) else stop
    out: dict = {"contents": contents}
    if system_instruction:
        out["systemInstruction"] = system_instruction
    if cfg:
        out["generationConfig"] = cfg
    return out


def _gemini_to_openai_response(body: dict, model: str) -> dict:
    text = ""
    finish = "stop"
    candidates = body.get("candidates") or []
    if candidates:
        cand = candidates[0]
        parts = (cand.get("content") or {}).get("parts") or []
        text = "".join(p.get("text", "") for p in parts if isinstance(p, dict))
        if cand.get("finishReason") == "MAX_TOKENS":
            finish = "length"
    meta = body.get("usageMetadata") or {}
    pt = meta.get("promptTokenCount", 0)
    ct = meta.get("candidatesTokenCount", 0)
    return {
        "id": f"chatcmpl-{uuid.uuid4().hex[:24]}",
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": {"role": "assistant", "content": text},
            "finish_reason": finish,
        }],
        "usage": {"prompt_tokens": pt, "completion_tokens": ct,
                  "total_tokens": pt + ct},
    }


async def cloud_post(state, provider: str, url: str, *, json=None,
                     headers=None, timeout=None):
    """POST to a cloud provider with bounded retry + capped backoff on
    connect errors and retryable statuses (5xx/429), spending the gateway's
    global retry budget. No circuit breaker: cloud providers are not
    registry endpoints, and there is no alternative to fail over to — this
    is same-target retry only."""
    resilience = state.resilience
    cfg = (resilience.config
           if resilience is not None and resilience.config.enabled else None)
    if cfg is not None:
        # fund the shared retry budget: cloud requests never build a
        # FailoverController, and a cloud-heavy deployment must not starve
        # local failover down to the budget's min floor
        resilience.budget.note_request()
    attempt = 1

    def spend_retry(reason: str) -> bool:
        nonlocal attempt
        if cfg is None or attempt >= cfg.max_attempts:
            return False
        if not resilience.budget.try_spend():
            # same bookkeeping as FailoverController: a budget-refused
            # retry must show up in the exhaustion counter/alert
            state.metrics.record_retry_budget_exhausted()
            return False
        state.metrics.record_failover_retry(f"cloud:{provider}", reason)
        attempt += 1
        return True

    while True:
        try:
            upstream = await state.http.post(
                url, json=json, headers=headers, timeout=timeout
            )
        except RETRYABLE_EXCEPTIONS:
            if spend_retry("connect_error"):
                await asyncio.sleep(backoff_delay(attempt - 1, cfg))
                continue
            raise
        if cfg is not None and upstream.status in cfg.retryable_statuses:
            reason = f"http_{upstream.status}"
            if spend_retry(reason):
                upstream.release()
                await asyncio.sleep(backoff_delay(attempt - 1, cfg))
                continue
        return upstream


# --------------------------------------------------------------- entry point


async def proxy_cloud_request(
    request: web.Request, provider: str, model: str, body: dict, path: str
) -> web.StreamResponse:
    state = request.app["state"]
    key = _api_key(provider)
    if not key:
        return error_response(
            401, f"no API key configured for cloud provider {provider!r} "
            f"(set {provider.upper()}_API_KEY)", "authentication_error",
        )
    start = time.monotonic()
    try:
        if provider == "openai":
            resp = await _proxy_openai_passthrough(
                request, state, key, model, body, path
            )
        elif provider == "anthropic":
            resp = await _proxy_anthropic(request, state, key, model, body)
        elif provider == "google":
            resp = await _proxy_google(request, state, key, model, body)
        else:
            return error_response(400, f"unknown cloud provider {provider!r}")
        METRICS.observe(provider, str(resp.status), time.monotonic() - start)
        return resp
    except (http.ClientError, asyncio.TimeoutError, OSError) as e:
        METRICS.observe(provider, "error", time.monotonic() - start)
        return error_response(
            502, f"cloud provider {provider} unreachable: {type(e).__name__}",
            "server_error",
        )


async def _proxy_openai_passthrough(
    request, state, key, model, body, path
) -> web.StreamResponse:
    """Same wire format: swap model + auth, stream or buffer verbatim."""
    payload = dict(body)
    payload["model"] = model
    upstream = await cloud_post(
        state, "openai", OPENAI_BASE + path,
        json=payload,
        headers={"Authorization": f"Bearer {key}"},
        timeout=http.ClientTimeout(total=state.config.inference_timeout_s),
    )
    if payload.get("stream") and "text/event-stream" in upstream.headers.get(
        "Content-Type", ""
    ):
        resp = web.StreamResponse(
            status=upstream.status,
            headers={"Content-Type": "text/event-stream"},
        )
        await resp.prepare(request)
        try:
            async for chunk in upstream.content.iter_any():
                await resp.write(chunk)
        finally:
            upstream.release()
        return resp
    raw = await upstream.read()
    upstream.release()
    return web.Response(
        body=raw, status=upstream.status,
        content_type="application/json",
    )


async def _proxy_anthropic(request, state, key, model, body) -> web.Response:
    payload = _openai_to_anthropic_request(body, model)
    payload.pop("stream", None)  # converted cloud path is non-streaming
    upstream = await cloud_post(
        state, "anthropic", ANTHROPIC_BASE + "/v1/messages",
        json=payload,
        headers={"x-api-key": key, "anthropic-version": "2023-06-01"},
        timeout=http.ClientTimeout(total=state.config.inference_timeout_s),
    )
    raw = await upstream.read()
    upstream.release()
    if upstream.status != 200:
        return web.Response(
            body=raw, status=upstream.status, content_type="application/json"
        )
    return web.json_response(
        _anthropic_to_openai_response(json.loads(raw), f"anthropic:{model}")
    )


async def _proxy_google(request, state, key, model, body) -> web.Response:
    payload = _openai_to_gemini_request(body)
    upstream = await cloud_post(
        state, "google", f"{GOOGLE_BASE}/v1beta/models/{model}:generateContent",
        json=payload,
        headers={"x-goog-api-key": key},
        timeout=http.ClientTimeout(total=state.config.inference_timeout_s),
    )
    raw = await upstream.read()
    upstream.release()
    if upstream.status != 200:
        return web.Response(
            body=raw, status=upstream.status, content_type="application/json"
        )
    return web.json_response(
        _gemini_to_openai_response(json.loads(raw), f"google:{model}")
    )


async def cloud_metrics_handler(request: web.Request) -> web.Response:
    return web.Response(
        text=METRICS.render_prometheus(),
        content_type="text/plain",
    )
