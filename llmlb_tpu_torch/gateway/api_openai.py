"""OpenAI-compatible proxy handlers: the gateway's hot path.

The port's copy of llmlb_tpu/gateway/api_openai.py, on the port's HTTP
client (gateway/http.py). Armed streams resume after a cut
(`_acquire_resume`), with the origin's KV pages when it can export them,
and move between two healthy engines when the rebalancer says so
(`_migrate_stream`, gateway/rebalance.py).

Parity with reference api/openai.rs (chat_completions :155, proxy_openai_post
:761-1341, list_models :261) and api/proxy.rs (SSE passthrough with TPS
tracking :120-270): validate model + capability, resolve aliases, TPS-select an
endpoint, rewrite the payload's `model` to the engine-local name, inject
stream_options.include_usage, forward with per-endpoint timeout/auth, stream
bytes through untouched while accounting tokens, normalize upstream failures to
502, and record history/stats fire-and-forget.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
import uuid

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway.app_state import AppState, record_daily_stat
from llmlb_tpu_torch.gateway.balancer import RequestRecord, prefix_affinity_hash
from llmlb_tpu_torch.gateway.model_names import to_canonical, to_engine_name
from llmlb_tpu_torch.gateway.replay import (
    REPLAY_OBJECT,
    RESUMABLE_ENDPOINT_TYPES,
    ChunkSplicer,
    FrameSplitter,
    ReplayState,
    encode_chunk_frame,
    is_done_frame,
    parse_data_frame,
)
from llmlb_tpu_torch.gateway.resilience import (
    RETRYABLE_EXCEPTIONS,
    FailoverController,
    PreStreamFailure,
    book_stream_outcome,
    retry_after_seconds,
    upstream_post,
)
from llmlb_tpu_torch.gateway.sanitize import sanitize_request_body
from llmlb_tpu_torch.gateway.token_accounting import (
    StreamingTokenAccumulator,
    estimate_tokens,
    extract_usage_from_response,
)
from llmlb_tpu_torch.gateway.tracing import (
    REQUEST_ID_HEADER,
    TokenTimeline,
    observe_first_token,
)
from llmlb_tpu_torch.gateway.types import (
    Capability,
    Endpoint,
    EndpointStatus,
    TpsApiKind,
)
from llmlb_tpu_torch.structured import inspect_request as inspect_structured

log = logging.getLogger("llmlb_tpu_torch.gateway.openai")

CLOUD_PREFIXES = ("openai:", "google:", "anthropic:")

def error_response(status: int, message: str,
                   err_type: str = "invalid_request_error",
                   headers: dict | None = None) -> web.Response:
    return web.json_response(
        {"error": {"message": message, "type": err_type, "code": None}},
        status=status,
        headers=headers,
    )


def parse_cloud_prefix(model: str) -> tuple[str | None, str]:
    for prefix in CLOUD_PREFIXES:
        if model.startswith(prefix):
            return prefix[:-1], model[len(prefix):]
    return None, model


def affinity_text_from_body(body: dict) -> str:
    """The prompt head used for prefix-affinity hashing: the request's
    LEADING SHARED BLOCK — explicit instructions/system when present,
    otherwise the first message (or the prompt/input string). The varying
    tail (this turn's user message) must stay out of the hash, or a short
    system prompt with per-request questions would hash every request
    differently and spray one warm prefix across the fleet. The hash
    itself caps the text at PREFIX_AFFINITY_CHARS, which also keeps long
    multi-turn histories hashing stably turn over turn. Best-effort —
    unknown shapes hash to nothing and simply skip affinity."""
    def text_of(content) -> str:
        if isinstance(content, str):
            return content
        if isinstance(content, list):  # multimodal / typed content blocks
            return "\n".join(
                b["text"] for b in content
                if isinstance(b, dict) and isinstance(b.get("text"), str)
            )
        return ""

    if isinstance(body.get("instructions"), str):  # responses API
        return body["instructions"]
    if body.get("system") is not None:  # anthropic: string or block list
        system = text_of(body["system"])
        if system:
            return system
    msgs = body.get("messages") or body.get("input")
    if isinstance(msgs, list):
        for m in msgs:
            if isinstance(m, dict):
                text = text_of(m.get("content"))
                if text:
                    return f"{m.get('role', 'user')}:{text}"
        return ""
    if isinstance(msgs, str):
        return msgs
    prompt = body.get("prompt")
    if isinstance(prompt, str):
        return prompt
    if isinstance(prompt, list) and prompt and isinstance(prompt[0], str):
        return prompt[0]
    return ""


def _tenant_id(auth: dict | None, client_ip: str | None) -> str:
    auth = auth or {}
    kid = auth.get("api_key_id")
    if kid:
        return str(kid)
    uid = auth.get("user_id")
    if uid:
        return f"user:{uid}"
    return f"ip:{client_ip or 'unknown'}"


def _key_name(auth: dict) -> str | None:
    """Human key name for per-key rate-limit overrides. Every RateLimiter
    call for a tenant must pass this — a bucket pair rebuilt after idle
    eviction with name=None would silently fall back to the global
    defaults, dropping the tenant's override."""
    if not auth.get("api_key_id"):
        return None
    actor = auth.get("actor") or ""
    return actor[4:] if actor.startswith("key:") else (actor or None)


def tenant_of(request: web.Request) -> tuple[str, str | None]:
    """(stable tenant id, human key name) for rate limiting and weighted
    fair queuing: the API key id when one authenticated, else the user id
    (dashboard JWT), else the client IP — so unauthenticated surfaces still
    bucket per source."""
    auth = request.get("auth") or {}
    return _tenant_id(auth, request.remote), _key_name(auth)


_PRIORITY_LABELS = {0: "high", 1: "normal", 2: "low"}


def priority_label(body: dict) -> str:
    """The request's priority class as a metrics label (goodput-by-priority;
    validation proper happens at the engine)."""
    p = body.get("priority")
    if isinstance(p, str) and p in ("high", "normal", "low"):
        return p
    if isinstance(p, int) and not isinstance(p, bool):
        return _PRIORITY_LABELS.get(p, "normal")
    return "normal"


def deadline_at_of(request: web.Request, state: AppState,
                   started: float) -> float | None:
    """Absolute monotonic deadline for this request: the client's
    X-Request-Deadline-Ms header, else LLMLB_REQUEST_DEADLINE_MS, else
    none. Work that cannot meet its deadline is shed before it burns a
    prefill, and the REMAINING budget propagates to the engine on the
    forwarded request (docs/scheduling.md). Raises ValueError (→ 400) on a
    malformed header."""
    raw = request.headers.get("X-Request-Deadline-Ms")
    ms: float | None = None
    if raw:
        try:
            ms = float(raw)
        except ValueError:
            raise ValueError("X-Request-Deadline-Ms must be a number")
        if ms <= 0:
            raise ValueError("X-Request-Deadline-Ms must be positive")
    if ms is None:
        default = state.config.request_deadline_ms
        ms = default if default > 0 else None
    return started + ms / 1000.0 if ms else None


def ratelimit_verdict(state: AppState, request: web.Request,
                      est_tokens: int) -> "tuple[str, int] | None":
    """Shared admission check for BOTH dialects (gateway/ratelimit.py):
    None when admitted, else (reason, retry_after_seconds) with the
    rejection already counted — each dialect shapes its own error body."""
    limiter = state.ratelimit
    if limiter is None or not limiter.enabled:
        return None
    tenant, name = tenant_of(request)
    verdict = limiter.acquire(tenant, name, est_tokens)
    if verdict.allowed:
        return None
    reason = verdict.reason or "requests"
    state.metrics.record_ratelimit_rejection(reason)
    return reason, max(1, int(verdict.retry_after_s + 0.999))


def check_ratelimit(state: AppState, request: web.Request,
                    est_tokens: int) -> "web.Response | None":
    """Per-API-key token buckets: a refused request gets 429 with
    Retry-After from the bucket's computed refill time. Returns the 429
    response (OpenAI error shape), or None when admitted."""
    refused = ratelimit_verdict(state, request, est_tokens)
    if refused is None:
        return None
    reason, retry_after = refused
    return error_response(
        429,
        f"rate limit exceeded ({reason}); retry after {retry_after}s",
        "rate_limit_error",
        headers={"Retry-After": str(retry_after)},
    )


async def select_endpoint_with_queue(
    state: AppState, model: str, capability: Capability, api_kind: TpsApiKind,
    trace=None, prefix_hash: str | None = None,
    exclude: set[str] | None = None, queue_timeout_s: float | None = None,
    tenant: str | None = None, weight: float = 1.0,
    prefill_heavy: bool | None = None,
) -> "tuple[Endpoint, str, RequestLease, object] | None":
    """Atomically TPS-select and lease an endpoint serving the model; if all
    are at the admission cap, park on the AdmissionQueue until a lease release
    wakes us or the queue timeout passes (notify-based, no polling — parity:
    balancer/mod.rs:2273-2427). `prefix_hash` steers toward the endpoint
    whose engine-side prefix KV cache is warm for this prompt. Records
    admission/queue_wait/endpoint_select spans on `trace` and feeds the
    gateway queue-wait histogram.

    `exclude` drops endpoints that already failed this request (failover
    re-selection); breaker-open endpoints are ejected inside the LoadManager
    itself. Both reduce the candidate set, never the 404 decision: a model
    whose endpoints are all excluded or breaker-open queues (and eventually
    503s with queue semantics), it does not 404. `queue_timeout_s` overrides
    the configured queue timeout (failover re-selection uses a short one).

    `prefill_heavy` engages disaggregation role steering
    (docs/disaggregation.md): True prefers prefill-capable endpoints, False
    prefers non-prefill-only ones, None (non-generation traffic) skips role
    filtering. The filter is soft — it falls back to the full candidate set
    rather than making a servable model unroutable — and prefix affinity
    composes with it (the hash steers within the filtered list)."""
    from llmlb_tpu_torch.disagg.gateway import role_filter

    if not state.registry.find_by_model(model, capability):
        return None

    def get_endpoints() -> list[Endpoint]:
        pairs = [
            (ep, m) for ep, m in state.registry.find_by_model(model,
                                                             capability)
            if not exclude or ep.id not in exclude
        ]
        eps = [ep for ep, _ in pairs]
        if prefill_heavy is not None:
            eps = role_filter(eps, prefill_heavy=prefill_heavy,
                              models=[m for _, m in pairs])
        return eps

    if trace is not None:
        trace.begin("admission")
    admit_start = time.monotonic()
    result = await state.admission.admit(get_endpoints, model, api_kind,
                                         timeout_s=queue_timeout_s,
                                         prefix_hash=prefix_hash,
                                         tenant=tenant, weight=weight)
    if not result.admitted:
        state.metrics.record_queue_timeout(model)
        state.metrics.record_queue_wait(model, "none", result.waited_s)
        if trace is not None:
            trace.end("admission")
            trace.add_span("queue_wait", start_monotonic=admit_start,
                           duration_s=result.waited_s)
        raise QueueTimeout(result.queue_position, result.waited_s)
    state.metrics.record_queue_wait(model, result.endpoint.name,
                                    result.waited_s)
    if trace is not None:
        trace.end("admission")
        trace.add_span("queue_wait", start_monotonic=admit_start,
                       duration_s=result.waited_s)
        trace.mark("endpoint_select", endpoint=result.endpoint.name)
        trace.set_endpoint(result.endpoint)
    pairs = state.registry.find_by_model(model, capability)
    model_rec = next(
        (m for ep, m in pairs if ep.id == result.endpoint.id), None,
    )
    engine_model = model_rec.model_id if model_rec is not None else model
    # model_rec rides along so callers can read the endpoint's capability
    # advertisement (disagg role fallback) without re-scanning the registry
    # on every attempt
    return result.endpoint, engine_model, result.lease, model_rec


class QueueTimeout(Exception):
    def __init__(self, queue_position: int = 0, waited_s: float = 0.0):
        super().__init__(f"queue timeout at position {queue_position} "
                         f"after {waited_s:.1f}s")
        self.queue_position = queue_position
        self.waited_s = waited_s


class HandoffOrchestrationError(Exception):
    """Phase-2 (adoption) failure of a two-phase disaggregated handoff:
    carries WHICH endpoint failed (the adopter — its lease has already been
    failed) so the retry loop can book the failure there instead of against
    the prefill endpoint that did its half of the work."""

    def __init__(self, endpoint: Endpoint, lease, reason: str):
        super().__init__(reason)
        self.endpoint = endpoint
        self.lease = lease
        self.reason = reason


async def _handoff_upstream(
    state: AppState, fo: "FailoverController", endpoint: Endpoint, lease,
    model: str, capability: Capability, api_kind: TpsApiKind,
    payload: dict, headers: dict, deadline_at: float | None, is_stream: bool,
    engine_model: str, trace=None,
):
    """The two-phase disaggregated handoff (docs/disaggregation.md):

    1. POST the chat body to the prefill-only endpoint's /v1/handoff/prefill
       — it admits, prefills, commits the first token(s), and answers with
       the wire payload (prompt + committed ids + full sampling block).
    2. POST the payload to a decode-capable adopter's /v1/handoff — it
       replays prompt+committed (the engine's park/resume path, so the
       continuation is token-identical) and streams the FULL completion in
       the normal chat-completions shape.

    Returns ``(upstream_response, serving_endpoint, serving_lease,
    engine_model)`` — the caller's existing status/stream/usage handling
    applies unchanged, now accounting against the adopter. Phase-1 failures
    surface exactly like a normal upstream failure on the prefill endpoint
    (non-200 responses are returned as-is; transport errors propagate).
    Phase-2 failures raise HandoffOrchestrationError with the adopter's
    identity. When no decode-capable endpoint has a free slot the prefill
    endpoint adopts its own payload — it keeps a combined step loop under
    ``--role prefill``, so the request never strands."""
    timeout = http.ClientTimeout(
        total=state.config.inference_timeout_s, sock_connect=10
    )
    resp1 = await upstream_post(
        state, endpoint, "/v1/handoff/prefill",
        json=payload, headers=headers, timeout=timeout,
    )
    if resp1.status != 200:
        return resp1, endpoint, lease, engine_model
    try:
        body1 = await resp1.json(content_type=None)
    except RETRYABLE_EXCEPTIONS + (ValueError,):
        raise http.ClientPayloadError(
            "handoff prefill response was not JSON"
        )
    finally:
        resp1.release()
    if not isinstance(body1, dict) or body1.get("object") != "llmlb.handoff":
        raise http.ClientPayloadError(
            "handoff prefill returned an unexpected shape"
        )

    # the prefill endpoint's half is done and successful: settle its lease
    # with the committed-token usage so its TPS EMA reflects real work
    usage = body1.get("usage") or {}
    lease.complete_with_tokens(
        int(usage.get("prompt_tokens") or 0),
        int(usage.get("completion_tokens") or 0),
    )
    fo.record_success(endpoint)

    from llmlb_tpu_torch.disagg.gateway import adopter_candidates

    adopter = None
    adopter_lease = None
    candidates = adopter_candidates(state, model, capability,
                                    exclude=fo.failed_ids)
    if candidates:
        got = state.load_manager.try_admit(candidates, model, api_kind)
        if got is not None:
            adopter, adopter_lease = got
    if adopter is None:
        # no decode pool has a free slot right now: the prefill engine
        # adopts its own payload rather than bouncing the request
        adopter = endpoint
        adopter_lease = state.load_manager.begin_request(
            endpoint, model, api_kind
        )
    state.metrics.record_handoff(
        "self" if adopter.id == endpoint.id else "adopted"
    )
    if trace is not None:
        # names the phase-2 engine so ?view=timeline knows to fetch its
        # flight record too (tracing.endpoints_touched)
        trace.mark("handoff_adopt", endpoint=adopter.name,
                   self_adopt=adopter.id == endpoint.id)

    adopt_headers = {"Content-Type": "application/json"}
    if adopter.api_key:
        adopt_headers["Authorization"] = f"Bearer {adopter.api_key}"
    rid = headers.get(REQUEST_ID_HEADER)
    if rid:
        adopt_headers[REQUEST_ID_HEADER] = rid
    if deadline_at is not None:
        # the wire carries the ORIGINAL (partly spent) deadline; the header
        # overrides it with what actually remains
        remaining_ms = (deadline_at - time.monotonic()) * 1000.0
        adopt_headers["X-Request-Deadline-Ms"] = str(
            max(1, int(remaining_ms))
        )
    pairs = state.registry.find_by_model(model, capability)
    adopt_model = next(
        (m.model_id for ep2, m in pairs if ep2.id == adopter.id),
        engine_model,
    )
    try:
        resp2 = await upstream_post(
            state, adopter, "/v1/handoff",
            json={
                "handoff": body1.get("handoff"),
                "stream": is_stream,
                "model": adopt_model,
                "tool_name": body1.get("tool_name"),
                # durable streams: the adopted stream carries replay frames
                # too, so a cut mid-continuation can resume elsewhere
                "llmlb_replay": bool(payload.get("llmlb_replay")),
            },
            headers=adopt_headers, timeout=timeout,
        )
    except RETRYABLE_EXCEPTIONS as e:
        adopter_lease.fail()
        raise HandoffOrchestrationError(
            adopter, adopter_lease,
            "adopt_timeout" if isinstance(e, asyncio.TimeoutError)
            else "adopt_connect_error",
        )
    return resp2, adopter, adopter_lease, adopt_model


def _record(
    state: AppState, *, endpoint: Endpoint | None, model: str,
    api_kind: TpsApiKind, path: str, status: int, started: float,
    prompt_tokens: int = 0, completion_tokens: int = 0,
    client_ip: str | None = None, auth: dict | None = None,
    error: str | None = None, stream: bool = False,
    request_body: str | None = None,
) -> None:
    duration_ms = (time.monotonic() - started) * 1000.0
    eid = endpoint.id if endpoint else None
    state.metrics.record_e2e(
        model, endpoint.name if endpoint else "none", duration_ms / 1000.0
    )
    state.load_manager.record_request(RequestRecord(
        ts=time.time(), endpoint_id=eid or "", model=model, api_kind=api_kind,
        status_code=status, duration_ms=duration_ms,
        prompt_tokens=prompt_tokens, completion_tokens=completion_tokens,
    ))
    auth = auth or {}
    state.history.add_history(
        (uuid.uuid4().hex, time.time(), eid,
         endpoint.name if endpoint else None, model, api_kind.value, path,
         status, duration_ms, prompt_tokens, completion_tokens, client_ip,
         auth.get("api_key_id"), auth.get("user_id"), int(stream), error,
         request_body),
    )
    if endpoint is not None:
        record_daily_stat(
            state, endpoint.id, model, api_kind,
            error=status >= 400, prompt_tokens=prompt_tokens,
            completion_tokens=completion_tokens, duration_ms=duration_ms,
        )
    if (state.ratelimit is not None and state.ratelimit.enabled
            and completion_tokens > 0):
        # post-paid token debit: the admission check could only estimate the
        # prompt; the completion throttles this tenant's NEXT request
        state.ratelimit.charge_tokens(
            _tenant_id(auth, client_ip), completion_tokens,
            name=_key_name(auth),
        )


async def proxy_openai_post(
    request: web.Request,
    path: str,
    api_kind: TpsApiKind,
    capability: Capability = Capability.CHAT_COMPLETION,
    prompt_text_fn=None,
) -> web.StreamResponse:
    """The generic select→rewrite→forward→account pipeline for /v1/* POSTs."""
    state: AppState = request.app["state"]
    started = time.monotonic()
    trace = request.get("trace")
    if trace is not None:
        trace.end("auth")
    try:
        body = await request.json()
    except Exception:
        return error_response(400, "invalid JSON body")
    if not isinstance(body, dict):
        return error_response(400, "body must be a JSON object")
    model = body.get("model")
    if not model or not isinstance(model, str):
        return error_response(400, "'model' is required")

    provider, bare_model = parse_cloud_prefix(model)
    if provider is not None:
        from llmlb_tpu_torch.gateway.api_cloud import proxy_cloud_request

        return await proxy_cloud_request(
            request, provider, bare_model, body, path
        )

    canonical = to_canonical(model)
    if trace is not None:
        trace.model = canonical
    # Multi-LoRA routing (docs/lora.md): a `lora` field or `model:adapter`
    # suffix steers to endpoints where the adapter is already HOT, falls
    # back to any lora-capable endpoint (triggering a hot-load), and 400s
    # naming the field when the fleet cannot serve the adapter — before a
    # blind proxy could turn it into an engine-side error. Malformed
    # values 400 here with the same message the engine would produce
    # (shared validator, llmlb_tpu/lora/api.py).
    lora_route = None
    if capability == Capability.CHAT_COMPLETION:
        from llmlb_tpu_torch.lora.gateway import lora_route_for

        try:
            lora_route = lora_route_for(state, body)
        except ValueError as e:
            state.metrics.record_lora_route("rejected")
            return error_response(400, str(e))
        if lora_route is not None:
            canonical = lora_route.canonical
            state.metrics.record_lora_route(lora_route.kind)
            if trace is not None:
                trace.model = canonical
    # Affinity only for generation traffic: embeddings (and other non-chat
    # capabilities) never touch the engine's prefix KV cache, and hashing
    # their inputs would churn the shared affinity map and pin their routing
    # for zero benefit. The adapter id folds into the hash — under LoRA the
    # prompt KV depends on the adapter, so two adapters sharing a system
    # prompt must pin to caches independently (docs/lora.md).
    prefix_hash = (
        prefix_affinity_hash(
            lora_route.base_canonical if lora_route is not None
            else canonical,
            affinity_text_from_body(body),
            lora=lora_route.adapter if lora_route is not None else None,
        )
        if capability == Capability.CHAT_COMPLETION else None
    )

    # Structured outputs (chat dialect only — /v1/responses spells these
    # fields differently and passes through untouched): validate
    # response_format / tool_choice HERE so malformed shapes and unsupported
    # JSON-Schema features 400 with the feature named instead of being
    # proxied blind, and steer compilable requests to endpoints advertising
    # the structured_outputs capability (tpu:// engines; an endpoint without
    # it would silently ignore the constraint). Cloud-prefixed models never
    # reach this point — they passed through above untouched.
    if path == "/v1/chat/completions":
        try:
            structured = inspect_structured(body)
        except ValueError as e:
            state.metrics.record_structured_rejected()
            return error_response(400, str(e))
        if structured is not None:
            state.metrics.record_structured_request(structured.kind)
            if state.registry.find_by_model(
                canonical, Capability.STRUCTURED_OUTPUTS
            ):
                capability = Capability.STRUCTURED_OUTPUTS
    if lora_route is not None and lora_route.capability is not None:
        # cold-load route: only endpoints WITH an adapter store are
        # eligible (a capability-blind pick would 400 at the engine).
        # Wins over structured steering — tpu lora engines advertise
        # structured_outputs too, so nothing is lost on a pure-TPU fleet.
        capability = lora_route.capability

    client_ip = request.remote
    auth = request.get("auth")
    prompt_text = prompt_text_fn(body) if prompt_text_fn else ""
    # stored for the dashboard request-detail view, inline media redacted
    # (the reference's sanitization contract, implemented)
    stored_body = sanitize_request_body(body)
    is_stream = bool(body.get("stream"))

    # ---- overload protection (docs/scheduling.md) ------------------------
    # Per-key token buckets first: a greedy tenant's excess load bounces
    # with 429 + honest Retry-After before it can queue in front of anyone.
    # Then the request deadline: the admission wait is capped at the
    # remaining budget, and expiry sheds the request (504) before it burns
    # a prefill — the remaining budget rides to the engine on the header.
    try:
        deadline_at = deadline_at_of(request, state, started)
    except ValueError as e:
        return error_response(400, str(e))
    refused = check_ratelimit(state, request, estimate_tokens(prompt_text))
    if refused is not None:
        return refused
    tenant, tenant_name = tenant_of(request)
    wfq_weight = state.admission.weight_for(tenant_name)
    prio = priority_label(body)

    # Disaggregation role steering (docs/disaggregation.md): long-prompt,
    # cold-prefix requests prefer prefill-capable endpoints; everything
    # else steers away from prefill-only ones, keeping their slots free
    # for prefill bursts. None for non-generation capabilities —
    # embeddings never touch the prefill/decode split.
    from llmlb_tpu_torch.disagg.gateway import endpoint_role, is_prefill_heavy

    prefill_heavy: bool | None = None
    if capability in (Capability.CHAT_COMPLETION,
                      Capability.STRUCTURED_OUTPUTS):
        prefill_heavy = is_prefill_heavy(
            state, canonical, estimate_tokens(prompt_text), prefix_hash
        )

    # Failover loop: each attempt re-selects (excluding endpoints that
    # already failed this request), and a failed attempt retries on another
    # endpoint with backoff while the attempt cap and global retry budget
    # allow. Streams are retryable only until the first byte reaches the
    # client (_forward_stream pulls the first upstream chunk before
    # preparing the client response for exactly this reason).
    fo = FailoverController(
        state, canonical, trace=trace,
        candidates_fn=lambda: [
            ep for ep, _ in state.registry.find_by_model(canonical, capability)
        ],
    )
    while True:
        queue_timeout = (fo.config.failover_queue_timeout_s
                         if fo.failed_ids else None)
        if deadline_at is not None:
            remaining = deadline_at - time.monotonic()
            if remaining <= 0:
                state.metrics.record_deadline_shed(canonical)
                return error_response(
                    504, "request deadline exceeded before an endpoint "
                    "was available", "timeout_error",
                )
            cap = (queue_timeout if queue_timeout is not None
                   else state.load_manager.queue_config.queue_timeout_s)
            queue_timeout = min(cap, remaining)
        try:
            selection = await select_endpoint_with_queue(
                state, canonical, capability, api_kind, trace=trace,
                prefix_hash=prefix_hash, exclude=fo.failed_ids,
                queue_timeout_s=queue_timeout,
                tenant=tenant, weight=wfq_weight,
                prefill_heavy=prefill_heavy,
            )
        except QueueTimeout as qt:
            if deadline_at is not None and time.monotonic() >= deadline_at:
                state.metrics.record_deadline_shed(canonical)
                return error_response(
                    504, "request deadline exceeded while queued for an "
                    "endpoint", "timeout_error",
                )
            return error_response(
                503,
                f"all endpoints busy; queue timeout exceeded "
                f"(position {qt.queue_position})",
                "server_error",
                headers={"Retry-After": str(
                    retry_after_seconds(state, canonical, capability)
                )},
            )
        if selection is None:
            return error_response(
                404, f"model {model!r} is not available on any online endpoint",
                "invalid_request_error",
            )
        endpoint, engine_model, lease, chosen_model = selection

        payload = dict(body)
        # registry knows the engine-local name; fall back to the static alias
        # table
        payload["model"] = engine_model or to_engine_name(
            canonical, endpoint.endpoint_type.value
        )
        if lora_route is not None:
            # the engine must see the adapter whichever route won: its own
            # hot `base:adapter` entry, or `base:adapter` synthesized so a
            # load-route engine hot-loads at admission; the explicit field
            # rides along (both dialects accept either — they must agree)
            from llmlb_tpu_torch.lora.gateway import forward_model_name

            payload["model"] = forward_model_name(
                lora_route, engine_model,
                to_engine_name(lora_route.base_canonical,
                               endpoint.endpoint_type.value),
            )
            payload["lora"] = lora_route.adapter
        if is_stream:
            # usage in the final chunk feeds the TPS tracker
            # (api/openai.rs:981-992)
            opts = dict(payload.get("stream_options") or {})
            opts["include_usage"] = True
            payload["stream_options"] = opts

        # Durable streams (gateway/replay.py, docs/resilience.md): arm
        # tpu:// engine streams with gateway-internal replay frames so a
        # mid-stream engine death becomes a token-identical resume on
        # another engine instead of a terminal error frame.
        arm_replay = (
            is_stream
            and path == "/v1/chat/completions"
            and state.config.stream_resume
            and state.config.stream_resume_attempts > 0
            and endpoint.endpoint_type.value in RESUMABLE_ENDPOINT_TYPES
        )
        if arm_replay:
            payload["llmlb_replay"] = True
        else:
            # a client-supplied flag must not reach the engine unarmed: the
            # byte-for-byte passthrough would forward the gateway-internal
            # replay frames straight to the client
            payload.pop("llmlb_replay", None)

        headers = {"Content-Type": "application/json"}
        if endpoint.api_key:
            headers["Authorization"] = f"Bearer {endpoint.api_key}"
        rid = request.get("request_id")
        if rid:
            # the engine scheduler adopts this id, joining the gateway trace
            headers[REQUEST_ID_HEADER] = rid
        if deadline_at is not None:
            remaining_ms = (deadline_at - time.monotonic()) * 1000.0
            if remaining_ms <= 0:
                lease.fail()
                state.metrics.record_deadline_shed(canonical)
                return error_response(
                    504, "request deadline exceeded before forwarding",
                    "timeout_error",
                )
            # the engine sheds the request if it is still queued there when
            # this remaining budget runs out (docs/scheduling.md)
            headers["X-Request-Deadline-Ms"] = str(max(1, int(remaining_ms)))

        if trace is not None:
            trace.begin("proxy")
        try:
            if (path == "/v1/chat/completions"
                    and endpoint_role(endpoint, chosen_model) == "prefill"):
                # Two-phase disaggregated handoff: the selected endpoint
                # only prefills — it commits the first token(s) and hands
                # the stream to a decode-capable adopter over the wire
                # (docs/disaggregation.md). Accounting moves with the
                # stream: the prefill lease completes at the payload, the
                # adopter's lease rides the continuation.
                upstream, endpoint, lease, engine_model = (
                    await _handoff_upstream(
                        state, fo, endpoint, lease, canonical, capability,
                        api_kind, payload, headers, deadline_at, is_stream,
                        engine_model, trace=trace,
                    )
                )
            else:
                upstream = await upstream_post(
                    state, endpoint, path,
                    json=payload,
                    headers=headers,
                    timeout=http.ClientTimeout(
                        total=state.config.inference_timeout_s,
                        sock_connect=10
                    ),
                )
        except HandoffOrchestrationError as e:
            # phase-2 (adoption) failure: the failure books against the
            # ADOPTER (its lease already failed inside the orchestrator);
            # the retry loop re-selects from scratch, excluding it.
            fo.record_failure(e.endpoint, e.lease, e.reason)
            if trace is not None:
                trace.end("proxy")
            if await fo.should_retry(e.reason):
                continue
            _record(state, endpoint=e.endpoint, model=canonical,
                    api_kind=api_kind, path=path, status=502, started=started,
                    client_ip=client_ip, auth=auth, error=e.reason,
                    request_body=stored_body)
            return error_response(
                502, f"handoff adoption failed: {e.reason}", "server_error",
            )
        except RETRYABLE_EXCEPTIONS as e:
            reason = ("timeout" if isinstance(e, asyncio.TimeoutError)
                      else "connect_error")
            fo.record_failure(endpoint, lease, reason)
            if trace is not None:
                trace.end("proxy")
            if await fo.should_retry(reason):
                continue
            _record(state, endpoint=endpoint, model=canonical,
                    api_kind=api_kind, path=path, status=502, started=started,
                    client_ip=client_ip, auth=auth,
                    error=f"{type(e).__name__}: {e}",
                    request_body=stored_body)
            return error_response(
                502, f"upstream endpoint unreachable: {type(e).__name__}",
                "server_error",
            )

        if upstream.status != 200:
            # normalize non-2xx upstream to 502 (api/openai.rs:1180)
            status_code = upstream.status
            try:
                detail = (await upstream.read())[:2048].decode(errors="replace")
            except RETRYABLE_EXCEPTIONS:
                detail = "<error body unreadable>"
            upstream.release()
            if trace is not None:
                trace.end("proxy")
            if status_code in fo.config.retryable_statuses:
                reason = f"http_{status_code}"
                fo.record_failure(endpoint, lease, reason)
                if await fo.should_retry(reason):
                    continue
            else:
                # a 4xx the endpoint rejected is not endpoint sickness; it
                # must not feed the breaker (or burn failover attempts) —
                # but it IS liveness evidence, which resolves a half-open
                # probe instead of leaking its slot
                lease.fail()
                fo.record_alive(endpoint)
            _record(state, endpoint=endpoint, model=canonical,
                    api_kind=api_kind, path=path, status=502, started=started,
                    client_ip=client_ip, auth=auth,
                    error=f"upstream HTTP {status_code}: {detail}",
                    request_body=stored_body)
            return error_response(
                502, f"upstream returned {status_code}: {detail}",
                "server_error",
            )

        content_type = upstream.headers.get("Content-Type", "")
        if is_stream and "text/event-stream" in content_type:
            replay = None
            if arm_replay:
                replay = ReplayState(
                    payload, capability=capability, api_kind=api_kind,
                    tenant=tenant, weight=wfq_weight,
                    deadline_at=deadline_at, rid=rid,
                    prefix_hash=prefix_hash,
                    max_attempts=state.config.stream_resume_attempts,
                )
                replay.origin = endpoint  # kv-export source if cut here
            result = await _forward_stream(
                request, state, upstream, endpoint, canonical, api_kind, path,
                started, lease, prompt_text, client_ip, auth, stored_body,
                trace=trace, failover=fo, priority=prio, replay=replay,
            )
            if isinstance(result, PreStreamFailure):
                fo.record_failure(endpoint, lease, "stream_pre_byte")
                if trace is not None:
                    trace.end("proxy")
                if await fo.should_retry("stream_pre_byte"):
                    continue
                _record(state, endpoint=endpoint, model=canonical,
                        api_kind=api_kind, path=path, status=502,
                        started=started, client_ip=client_ip, auth=auth,
                        error=result.error, stream=True,
                        request_body=stored_body)
                return error_response(
                    502,
                    f"upstream stream failed before first byte: "
                    f"{result.error}",
                    "server_error",
                )
            return result

        observe_first_token(state, trace, canonical, endpoint.name, started)
        try:
            raw = await upstream.read()
        except RETRYABLE_EXCEPTIONS as e:
            # endpoint died mid-body: nothing reached the client, so this
            # fails over like a connect failure (and must book an outcome,
            # or a half-open probe slot would wedge)
            upstream.release()
            fo.record_failure(endpoint, lease, "read_error")
            if trace is not None:
                trace.end("proxy")
            if await fo.should_retry("read_error"):
                continue
            _record(state, endpoint=endpoint, model=canonical,
                    api_kind=api_kind, path=path, status=502, started=started,
                    client_ip=client_ip, auth=auth,
                    error=f"response read failed: {type(e).__name__}: {e}",
                    request_body=stored_body)
            return error_response(
                502, f"upstream response read failed: {type(e).__name__}",
                "server_error",
            )
        upstream.release()
        if trace is not None:
            trace.end("proxy")
        try:
            parsed = json.loads(raw)
        except ValueError:
            parsed = None
        usage = (extract_usage_from_response(parsed)
                 if isinstance(parsed, dict) else None)
        if usage is None:
            completion_text = _extract_completion_text(parsed) if parsed else ""
            usage = (estimate_tokens(prompt_text),
                     estimate_tokens(completion_text))
        lease.complete_with_tokens(*usage)
        fo.record_success(endpoint)
        _record(state, endpoint=endpoint, model=canonical, api_kind=api_kind,
                path=path, status=200, started=started,
                prompt_tokens=usage[0], completion_tokens=usage[1],
                client_ip=client_ip, auth=auth, request_body=stored_body)
        # non-streaming goodput: the whole response IS the first token, so
        # only the TTFT target applies (generation APIs only — embeddings
        # and media have no latency SLO here)
        if api_kind in (TpsApiKind.CHAT, TpsApiKind.COMPLETION,
                        TpsApiKind.RESPONSES):
            state.metrics.record_slo(canonical,
                                     time.monotonic() - started, None,
                                     priority=prio)
        state.events.publish("MetricsUpdated", {"endpoint_id": endpoint.id})
        return web.Response(
            body=raw, status=200,
            content_type="application/json",
        )


def sse_error_frame(message: str, code: str = "stream_interrupted") -> bytes:
    """Final SSE `event: error` frame written before closing a cut stream,
    so clients can distinguish an interrupted stream from a completed one
    (a bare close is indistinguishable from normal EOF to most SSE
    consumers). Leads with a blank line: the passthrough is byte-for-byte,
    so the cut may land mid-line — the terminator ends any dangling partial
    event, otherwise `event: error` would be absorbed into it."""
    payload = {"error": {"message": message, "type": "server_error",
                         "code": code}}
    return (
        f"\n\nevent: error\ndata: "
        f"{json.dumps(payload, separators=(',', ':'))}\n\n"
    ).encode()


class StreamWriteTimeout(Exception):
    """A client write stalled past LLMLB_STREAM_WRITE_TIMEOUT: the reader
    stopped draining the SSE stream (slow-loris). The pump aborts — which
    releases the upstream response and thereby cancels the engine slot —
    instead of holding a decode slot hostage for the inference timeout."""


class StreamWriteGuard:
    """Slow-loris protection for the per-chunk SSE hot loop, shared by the
    OpenAI passthrough and the Anthropic transform (docs/scheduling.md).

    ONE watchdog timer per STREAM instead of an asyncio.wait_for per chunk:
    the guarded write costs two timestamp assignments on the fast path — no
    Task/TimerHandle allocation per chunk, so the per-chunk loop stays one
    scan and one socket write. The watchdog wakes every
    timeout/2; a write pending past the timeout cancels the pump task and
    `write` converts that cancellation into StreamWriteTimeout (worst-case
    detection latency 1.5x the configured timeout). A cancellation that
    lands after the write completed surfaces at the pump's next await —
    pumps must check `fired` in their CancelledError handler.

    The stalled_reader fault rule (gateway/faults.py) simulates a
    non-draining client as a deterministic sleep inside the guarded write,
    so the timeout is testable without real sockets."""

    __slots__ = ("_resp", "_timeout", "_stall_rules", "_loop", "_task",
                 "_handle", "_pending_since", "fired", "_sent")

    def __init__(self, resp, timeout: float, stall_rules=()):
        self._resp = resp
        self._timeout = timeout
        # Every fired rule applies (like upstream_post), each stalling once
        # when the stream passes its after_bytes threshold.
        self._stall_rules = sorted(stall_rules, key=lambda r: r.after_bytes)
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.current_task()
        self._pending_since: float | None = None
        self.fired = False
        self._sent = 0
        self._handle = (self._loop.call_later(timeout / 2, self._check)
                        if timeout > 0 else None)

    def active(self) -> bool:
        """False when neither timeout nor fault applies — callers then keep
        the raw resp.write bound method in the hot loop."""
        return self._timeout > 0 or bool(self._stall_rules)

    def _check(self) -> None:
        started = self._pending_since
        if (started is not None
                and self._loop.time() - started > self._timeout):
            self.fired = True
            self._handle = None
            self._task.cancel()
            return
        self._handle = self._loop.call_later(self._timeout / 2, self._check)

    def close(self) -> None:
        """Disarm the watchdog (call from the pump's finally)."""
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None

    def timeout_error(self) -> StreamWriteTimeout:
        return StreamWriteTimeout(
            f"client stopped reading for {self._timeout:.0f}s"
        )

    async def write(self, data: bytes) -> None:
        self._pending_since = self._loop.time()
        try:
            while (self._stall_rules
                   and self._sent >= self._stall_rules[0].after_bytes):
                rule = self._stall_rules.pop(0)
                await asyncio.sleep(rule.latency_ms / 1000.0)
            await self._resp.write(data)
        except asyncio.CancelledError:
            if self.fired:
                raise self.timeout_error() from None
            raise
        finally:
            self._pending_since = None
        self._sent += len(data)


def stream_write_guard(state: AppState, resp, endpoint,
                       path: str) -> StreamWriteGuard:
    """Build the guard for one stream: configured timeout + every matching
    stalled_reader fault rule (each counted as injected and applied)."""
    stall_rules = []
    if state.faults is not None:
        for rule in state.faults.decide(endpoint, path,
                                        kinds=("stalled_reader",)):
            state.metrics.record_fault_injected(rule.kind)
            stall_rules.append(rule)
    return StreamWriteGuard(resp, state.config.stream_write_timeout_s,
                            stall_rules)


async def _fetch_kv_export(state: AppState, replay: ReplayState,
                           park: bool = False):
    """Collect the cut stream's serialized KV pages from its origin engine
    (POST /v1/kv/export, docs/kv-cache.md) so the resume moves bytes
    instead of re-prefilling. Strictly best-effort with a short clock: a
    SIGKILL'd origin refuses the connect, an old build 404s, a finished
    drain holds nothing — every such case returns None fast and the
    token-identical replay path proceeds exactly as before.

    ``park=True`` is the proactive-migration variant (gateway/rebalance.py):
    the origin is LIVE, so the engine first parks the decoding slot (KV
    spilled, request requeued) and then serves the export. A refusal leaves
    the origin stream untouched — the parked copy re-inserts and keeps
    streaming on the same connection."""
    origin = replay.origin
    if origin is None or not replay.rid or not replay.committed:
        return None
    headers = {"Content-Type": "application/json"}
    if origin.api_key:
        headers["Authorization"] = f"Bearer {origin.api_key}"
    body_json = {"request_id": replay.rid}
    if park:
        body_json["park"] = True
    timeout = http.ClientTimeout(total=5, sock_connect=2)
    try:
        resp = await upstream_post(
            state, origin, "/v1/kv/export",
            json=body_json,
            headers=headers, timeout=timeout,
        )
    except Exception:
        return None
    try:
        if resp.status != 200:
            return None
        body = await resp.json()
    except Exception:
        return None
    finally:
        resp.release()
    pages = body.get("kv_pages") if isinstance(body, dict) else None
    return pages if isinstance(pages, dict) else None


async def _acquire_resume(
    state: AppState, fo: FailoverController, replay: ReplayState, model: str,
    trace=None,
):
    """Open a token-identical continuation stream for a cut armed stream
    (docs/resilience.md "mid-stream recovery"): re-run endpoint selection
    excluding every endpoint that already failed this request, POST the
    ORIGINAL chat body + the committed token ids to the new engine's
    /v1/resume, and pull its first chunk. Returns ``(upstream, endpoint,
    iterator, first_chunk)`` on success, or None when the gateway must give
    up and emit the terminal error frame instead — attempts capped by
    LLMLB_STREAM_RESUME_ATTEMPTS, each attempt spending the shared retry
    budget, each outcome counted in stream_resumes_total{outcome}."""
    timeout = http.ClientTimeout(
        total=state.config.inference_timeout_s, sock_connect=10
    )
    # one-shot pickup from the (possibly draining) origin; the payload is
    # reused across resume-attempt retries — the origin no longer holds it
    kv_pages = await _fetch_kv_export(state, replay)
    while True:
        if replay.attempts >= replay.max_attempts:
            state.metrics.record_stream_resume("exhausted")
            return None
        if (replay.deadline_at is not None
                and time.monotonic() >= replay.deadline_at):
            state.metrics.record_stream_resume("exhausted")
            return None
        try:
            selection = await select_endpoint_with_queue(
                state, model, replay.capability, replay.api_kind, trace=trace,
                prefix_hash=replay.prefix_hash, exclude=fo.failed_ids,
                queue_timeout_s=fo.config.failover_queue_timeout_s,
                tenant=replay.tenant, weight=replay.weight,
                prefill_heavy=False,
            )
        except QueueTimeout:
            state.metrics.record_stream_resume("no_endpoint")
            return None
        if selection is None:
            state.metrics.record_stream_resume("no_endpoint")
            return None
        endpoint, engine_model, lease, _rec = selection
        if endpoint.endpoint_type.value not in RESUMABLE_ENDPOINT_TYPES:
            # a live candidate that simply does not speak /v1/resume: not a
            # failure (no breaker, no interruption counters) — just not a
            # resume target for this stream
            lease.fail()
            fo.failed_ids.add(endpoint.id)
            continue
        resilience = state.resilience
        if resilience is not None and not resilience.budget.try_spend():
            lease.fail()
            state.metrics.record_retry_budget_exhausted()
            state.metrics.record_stream_resume("budget")
            return None
        replay.attempts += 1
        headers = {"Content-Type": "application/json"}
        if endpoint.api_key:
            headers["Authorization"] = f"Bearer {endpoint.api_key}"
        if replay.rid:
            headers[REQUEST_ID_HEADER] = replay.rid
        if replay.deadline_at is not None:
            remaining_ms = (replay.deadline_at - time.monotonic()) * 1000.0
            headers["X-Request-Deadline-Ms"] = str(max(1, int(remaining_ms)))
        try:
            resumed = await upstream_post(
                state, endpoint, "/v1/resume",
                json=replay.resume_body(engine_model, kv_pages=kv_pages),
                headers=headers, timeout=timeout,
            )
        except RETRYABLE_EXCEPTIONS as e:
            reason = ("timeout" if isinstance(e, asyncio.TimeoutError)
                      else "connect_error")
            fo.record_failure(endpoint, lease, reason)
            continue
        if resumed.status != 200:
            status_code = resumed.status
            resumed.release()
            if status_code in fo.config.retryable_statuses:
                fo.record_failure(endpoint, lease, f"http_{status_code}")
                continue
            # the engine answered (e.g. an old build 404ing /v1/resume):
            # alive, but this stream cannot resume there
            lease.fail()
            fo.record_alive(endpoint)
            state.metrics.record_stream_resume("failed")
            return None
        iterator = resumed.content.iter_any()
        try:
            first_chunk = await iterator.__anext__()
        except StopAsyncIteration:
            resumed.release()
            fo.record_failure(endpoint, lease, "stream_pre_byte")
            continue
        except (http.ClientError, asyncio.TimeoutError, OSError,
                ConnectionResetError):
            resumed.release()
            fo.record_failure(endpoint, lease, "stream_pre_byte")
            continue
        lease.complete()  # stream accepted; active slot released, as ever
        replay.origin = endpoint  # a second cut asks THIS engine for pages
        replay.resumes += 1
        state.metrics.record_stream_resume("success")
        state.metrics.record_stream_resumed_tokens(model,
                                                   len(replay.committed))
        if trace is not None:
            trace.mark("stream_resume", endpoint=endpoint.name,
                       committed_tokens=len(replay.committed))
        return resumed, endpoint, iterator, first_chunk


async def _migrate_stream(state: AppState, replay: ReplayState,
                          target_id: str, model: str):
    """Planner-directed live migration (gateway/rebalance.py): park the
    stream on its healthy origin (POST /v1/kv/export {"park": true}),
    collect the KV snapshot, and open a token-identical continuation on
    the rebalancer's pinned target — the exact /v1/resume machinery the
    reactive cut path uses, minus every failure-side effect. Returns
    ``((upstream, endpoint, iterator, first_chunk), "success")`` or
    ``(None, "aborted"|"refused")``: "aborted" means the migration never
    touched the origin's stream (ineligible target, origin would not
    park), "refused" means the target rejected the adopt — in which case
    the origin's parked copy re-inserts and keeps streaming on the SAME
    connection, so either failure is client-invisible. Unlike
    _acquire_resume this books no endpoint failures, spends no retry
    budget and counts nothing in stream_resumes: both engines are
    healthy, and a refusal is planner feedback, not sickness."""
    origin = replay.origin
    target = state.registry.get(target_id)
    if (target is None or origin is None or target.id == origin.id
            or target.status != EndpointStatus.ONLINE
            or target.endpoint_type.value not in RESUMABLE_ENDPOINT_TYPES):
        return None, "aborted"
    engine_model = None
    for m in state.registry.models_for(target.id):
        if model in (m.canonical_name, m.model_id):
            engine_model = m.model_id
            break
    if engine_model is None:
        return None, "aborted"  # target does not serve this model
    if (replay.deadline_at is not None
            and replay.deadline_at - time.monotonic() <= 0):
        return None, "aborted"
    pages = await _fetch_kv_export(state, replay, park=True)
    if pages is None:
        return None, "aborted"
    headers = {"Content-Type": "application/json"}
    if target.api_key:
        headers["Authorization"] = f"Bearer {target.api_key}"
    if replay.rid:
        headers[REQUEST_ID_HEADER] = replay.rid
    if replay.deadline_at is not None:
        remaining_ms = (replay.deadline_at - time.monotonic()) * 1000.0
        headers["X-Request-Deadline-Ms"] = str(max(1, int(remaining_ms)))
    timeout = http.ClientTimeout(
        total=state.config.inference_timeout_s, sock_connect=10
    )
    try:
        resumed = await upstream_post(
            state, target, "/v1/resume",
            json=replay.resume_body(engine_model, kv_pages=pages),
            headers=headers, timeout=timeout,
        )
    except RETRYABLE_EXCEPTIONS:
        return None, "refused"
    if resumed.status != 200:
        resumed.release()
        return None, "refused"
    iterator = resumed.content.iter_any()
    try:
        first_chunk = await iterator.__anext__()
    except StopAsyncIteration:
        resumed.release()
        return None, "refused"
    except (http.ClientError, asyncio.TimeoutError, OSError,
            ConnectionResetError):
        resumed.release()
        return None, "refused"
    replay.origin = target  # a later cut asks THIS engine for pages
    return (resumed, target, iterator, first_chunk), "success"


def _replay_frame_out(replay: ReplayState, splicer: "ChunkSplicer | None",
                      frame: bytes) -> bytes | None:
    """One complete upstream SSE frame → the bytes to forward to the client
    (None = gateway-internal or fully duplicated, drop it). Before the first
    resume (`splicer` is None) client frames pass through byte-verbatim and
    are only ACCOUNTED; after a resume every chunk is spliced."""
    obj = parse_data_frame(frame)
    if obj is None:
        return frame  # [DONE], comments, blank keep-alives: forward as-is
    if "error" in obj:
        # engine-side terminal error frames pass through untouched in both
        # modes — they are client-facing, not duplicated content
        if splicer is not None and obj.get("object") != REPLAY_OBJECT:
            return frame
    if splicer is None:
        return frame if replay.note_openai_chunk(obj) else None
    if obj.get("object") == REPLAY_OBJECT:
        replay.note_openai_chunk(obj)  # extends the committed ledger only
        return None
    spliced = splicer.splice(obj)
    return encode_chunk_frame(spliced) if spliced is not None else None


async def _forward_stream(
    request, state: AppState, upstream, endpoint, model, api_kind, path,
    started, lease, prompt_text, client_ip, auth, stored_body=None,
    trace=None, failover: FailoverController | None = None,
    priority: str = "normal", replay: ReplayState | None = None,
) -> "web.StreamResponse | PreStreamFailure":
    """Byte-for-byte SSE passthrough with token accounting (api/proxy.rs:120).

    The first upstream chunk is pulled BEFORE the client response is
    prepared: a failure there returns PreStreamFailure (retryable by the
    caller, nothing was sent). After the first byte the stream is committed —
    an upstream cut emits a final `event: error` frame, counts against the
    endpoint (breaker + balancer per-endpoint stats), and records 502; a
    client disconnect counts against nobody. Every client write runs under
    LLMLB_STREAM_WRITE_TIMEOUT (docs/scheduling.md): a reader that stops
    draining aborts the stream (freeing the engine slot) instead of pinning
    it until the inference timeout."""
    iterator = upstream.content.iter_any()
    first_chunk: bytes | None = None
    try:
        first_chunk = await iterator.__anext__()
    except StopAsyncIteration:
        first_chunk = None  # empty-but-clean stream: forward the EOF as-is
    except (http.ClientError, asyncio.TimeoutError, OSError,
            ConnectionResetError) as e:
        upstream.release()
        return PreStreamFailure(f"{type(e).__name__}: {e}")

    headers = {
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
    }
    rid = request.get("request_id")
    if rid:  # set pre-prepare; the middleware cannot amend a sent stream
        headers[REQUEST_ID_HEADER] = rid
    resp = web.StreamResponse(status=200, headers=headers)
    await resp.prepare(request)
    lease.complete()  # endpoint accepted the stream; active slot released
    acc = StreamingTokenAccumulator()
    # Sampled token timeline for the trace: one mark per SSE data chunk
    # reaching the client, so /api/traces/<id> shows WHERE a slow stream
    # stalled. ttft_s additionally feeds the SLO goodput ledger.
    timeline = (TokenTimeline()
                if trace is not None and state.traces.sample_timeline()
                else None)
    # Slow-loris protection (StreamWriteGuard): one watchdog per stream, a
    # non-draining client aborts the pump instead of pinning the slot.
    guard = stream_write_guard(state, resp, endpoint, path)
    ttft_s: float | None = None
    status = 200
    error = None
    upstream_failed = False
    # Durable streams: once a cut's outcome has been booked in-line (victim
    # breaker + interruption counters at the moment of the cut), the finally
    # block must not book anything for it again.
    outcome_booked = False
    # Rebalancer visibility (gateway/rebalance.py): armed streams register
    # in the worker's StreamDirectory so migration directives can find
    # them; None when LLMLB_REBALANCE=0 or the stream is not resumable.
    handle = None
    try:
        if first_chunk is not None:
            observe_first_token(state, trace, model, endpoint.name,
                                started, streaming=True)
            ttft_s = time.monotonic() - started
            feed = acc.feed
            # Per-chunk hot loop: with the native scanner built, each chunk
            # costs one C scan (frame split + usage extract) and one socket
            # write — bound methods hoisted so the loop does no attribute
            # walks, and the timeline branch is a single identity test
            # unless this request was sampled for a token timeline. The
            # guarded write adds two timestamp stores per chunk (the
            # watchdog timer is per-stream, never per-chunk).
            write = guard.write if guard.active() else resp.write
            next_chunk = iterator.__anext__
            if replay is None:
                feed(first_chunk)
                await write(first_chunk)
                if timeline is not None and b"data:" in first_chunk:
                    timeline.mark()
                while True:
                    try:
                        chunk = await next_chunk()
                    except StopAsyncIteration:
                        break
                    except (http.ClientError, asyncio.TimeoutError,
                            OSError) as e:
                        # mid-stream upstream cut: tell the client, then
                        # count it against the endpoint
                        status = 502
                        error = f"stream interrupted: {type(e).__name__}"
                        upstream_failed = True
                        # guarded: a stalled client must not pin the handler
                        # on the farewell frame either
                        await write(sse_error_frame(error))
                        break
                    feed(chunk)
                    await write(chunk)
                    if timeline is not None and b"data:" in chunk:
                        timeline.mark()
            else:
                # Armed (resumable) pump: frames forward whole (a cut never
                # leaks a partial event), gateway-internal llmlb.replay
                # frames feed the committed-token ledger, and a mid-stream
                # cut books the dead endpoint once then splices a
                # token-identical continuation from another engine into
                # THIS response (docs/resilience.md "mid-stream recovery").
                splitter = FrameSplitter()
                splicer: ChunkSplicer | None = None
                chunk = first_chunk
                terminal_sent = False
                if state.streams is not None and replay.rid:
                    handle = state.streams.register(
                        replay.rid, model, endpoint.id)
                while True:
                    for frame in splitter.push(chunk):
                        out = _replay_frame_out(replay, splicer, frame)
                        if out is None:
                            continue
                        feed(out)
                        await write(out)
                        if is_done_frame(out):
                            terminal_sent = True
                        if timeline is not None and b"data:" in out:
                            timeline.mark()
                    # Frame boundary: a pending rebalance directive moves
                    # this stream NOW — park on the (healthy) origin, adopt
                    # on the planner's target, splice. Any failure leaves
                    # the origin stream pumping exactly as before.
                    migrated = None
                    if handle is not None and not terminal_sent:
                        directive = state.streams.claim(handle)
                        if directive is not None:
                            target_id, why, _did = directive
                            migrated, outcome = await _migrate_stream(
                                state, replay, target_id, model)
                            state.streams.note_outcome(
                                handle, success=migrated is not None,
                                target=target_id)
                            state.metrics.record_rebalance_migration(
                                why, outcome)
                            if trace is not None:
                                trace.mark("stream_migrate", reason=why,
                                           outcome=outcome,
                                           target=target_id)
                    if migrated is not None:
                        upstream.release()
                        upstream, endpoint, iterator, chunk = migrated
                        next_chunk = iterator.__anext__
                        # same splice mechanics as the reactive cut below:
                        # the adopter re-reports the full committed run and
                        # the splicer forwards only the unseen suffix
                        splitter = FrameSplitter()
                        splicer = ChunkSplicer(replay)
                        replay.mark_ledger_stale()
                        continue
                    try:
                        chunk = await next_chunk()
                    except StopAsyncIteration:
                        break
                    except (http.ClientError, asyncio.TimeoutError,
                            OSError) as e:
                        if terminal_sent:
                            break  # the stream already completed cleanly
                        # book the victim exactly once: breaker failure +
                        # per-endpoint stats + one stream_interruption, and
                        # exclusion from the re-selection below (a resume
                        # must never burn a half-open probe on the victim)
                        failover.record_failure(
                            endpoint, None, "stream_interrupted",
                            stream_interrupted=True,
                        )
                        resumed = await _acquire_resume(
                            state, failover, replay, model, trace=trace,
                        )
                        if resumed is None:
                            status = 502
                            error = (f"stream interrupted: "
                                     f"{type(e).__name__}")
                            outcome_booked = True  # victim booked above
                            await write(sse_error_frame(error))
                            break
                        upstream.release()
                        upstream, endpoint, iterator, chunk = resumed
                        next_chunk = iterator.__anext__
                        if handle is not None:
                            # keep the directory honest: a reactive resume
                            # re-homed this stream (not a migration — no
                            # window stamp, no migration count)
                            handle.endpoint_id = endpoint.id
                        # snapshot the forwarded offsets BEFORE resetting
                        # the ledger: the adopter re-reports the full
                        # committed sequence for a possible second cut
                        splitter = FrameSplitter()
                        splicer = ChunkSplicer(replay)
                        replay.mark_ledger_stale()
    except asyncio.CancelledError:
        # the watchdog's cancel can land at any await once it fires (e.g.
        # the next upstream read, if the write completed in the race) —
        # only a fired guard converts; anything else propagates
        if not guard.fired:
            raise
        status = 502
        error = f"stream write timeout: {guard.timeout_error()}"
        state.metrics.record_stream_write_timeout(model)
    except StreamWriteTimeout as e:
        # the client stopped draining (slow-loris): abort the stream — the
        # upstream release below closes the engine connection, which
        # cancels the slot — and count it. Not endpoint sickness.
        status = 502
        error = f"stream write timeout: {e}"
        state.metrics.record_stream_write_timeout(model)
    except (http.ClientError, asyncio.TimeoutError, OSError,
            ConnectionResetError) as e:
        # resp.write failed: the CLIENT went away — not endpoint sickness,
        # so neither breaker nor per-endpoint failure stats move.
        status = 502
        error = error or f"client disconnected: {type(e).__name__}"
    finally:
        guard.close()
        upstream.release()
        if state.streams is not None:
            # a directive racing this natural finish dies here un-acted-on
            state.streams.unregister(handle)
        if trace is not None:
            trace.end("decode")
            trace.end("proxy")
        # lease already completed at stream start; this books the breaker +
        # balancer stats + interruption metric (and resolves a half-open
        # probe even when the CLIENT was the one that went away). A cut
        # whose outcome was already booked in-line (armed pump: the victim
        # was charged at the moment of the cut) books nothing further here.
        if not outcome_booked:
            book_stream_outcome(state, failover, endpoint, model,
                                upstream_failed=upstream_failed,
                                completed=status == 200)
        pt, ct, reported = acc.finalize(prompt_text)
        duration_s = time.monotonic() - started
        if trace is not None and timeline is not None:
            trace.attach_timeline(timeline)
        if status == 200 and ttft_s is not None:
            # mean inter-token gap over the stream (None for single-token
            # responses: only the TTFT target applies)
            itl_mean = (max(0.0, duration_s - ttft_s) / (ct - 1)
                        if ct > 1 else None)
            state.metrics.record_slo(model, ttft_s, itl_mean,
                                     priority=priority)
        if ct > 0:
            state.load_manager.update_tps(
                endpoint.id, model, api_kind, ct, duration_s
            )
            state.events.publish(
                "TpsUpdated",
                {"endpoint_id": endpoint.id, "model": model,
                 "tps": round(ct / duration_s, 2) if duration_s > 0 else None},
            )
        _record(state, endpoint=endpoint, model=model, api_kind=api_kind,
                path=path, status=status, started=started, prompt_tokens=pt,
                completion_tokens=ct, client_ip=client_ip, auth=auth,
                error=error, stream=True, request_body=stored_body)
    return resp


def _extract_completion_text(parsed: dict) -> str:
    parts = []
    for choice in parsed.get("choices") or []:
        if not isinstance(choice, dict):
            continue
        msg = choice.get("message") or {}
        if isinstance(msg.get("content"), str):
            parts.append(msg["content"])
        if isinstance(choice.get("text"), str):
            parts.append(choice["text"])
    for item in parsed.get("output") or []:  # responses API
        if isinstance(item, dict):
            for c in item.get("content") or []:
                if isinstance(c, dict) and isinstance(c.get("text"), str):
                    parts.append(c["text"])
    return "".join(parts)


def _chat_prompt_text(body: dict) -> str:
    parts = []
    for m in body.get("messages") or []:
        if isinstance(m, dict):
            c = m.get("content")
            if isinstance(c, str):
                parts.append(c)
            elif isinstance(c, list):
                parts.extend(
                    p.get("text", "") for p in c if isinstance(p, dict)
                )
    return "\n".join(parts)


def _completion_prompt_text(body: dict) -> str:
    p = body.get("prompt")
    if isinstance(p, str):
        return p
    if isinstance(p, list):
        return "\n".join(str(x) for x in p)
    return ""


def _responses_prompt_text(body: dict) -> str:
    i = body.get("input")
    if isinstance(i, str):
        return i
    if isinstance(i, list):
        return _chat_prompt_text({"messages": i})
    return ""


# ------------------------------------------------------------------ handlers


async def chat_completions(request: web.Request) -> web.StreamResponse:
    return await proxy_openai_post(
        request, "/v1/chat/completions", TpsApiKind.CHAT,
        Capability.CHAT_COMPLETION, _chat_prompt_text,
    )


async def completions(request: web.Request) -> web.StreamResponse:
    return await proxy_openai_post(
        request, "/v1/completions", TpsApiKind.COMPLETION,
        Capability.CHAT_COMPLETION, _completion_prompt_text,
    )


async def embeddings(request: web.Request) -> web.StreamResponse:
    return await proxy_openai_post(
        request, "/v1/embeddings", TpsApiKind.EMBEDDINGS,
        Capability.EMBEDDINGS,
    )


async def responses(request: web.Request) -> web.StreamResponse:
    return await proxy_openai_post(
        request, "/v1/responses", TpsApiKind.RESPONSES,
        Capability.CHAT_COMPLETION, _responses_prompt_text,
    )


async def list_models(request: web.Request) -> web.Response:
    """Union of canonical models across online endpoints (api/openai.rs:261)."""
    state: AppState = request.app["state"]
    seen: dict[str, dict] = {}
    for ep in state.registry.list_online():
        for m in state.registry.models_for(ep.id):
            entry = seen.setdefault(
                m.canonical_name,
                {
                    "id": m.canonical_name,
                    "object": "model",
                    "created": int(m.created_at),
                    "owned_by": "llmlb",
                    "metadata": {
                        "endpoints": [],
                        "capabilities": [c.value for c in m.capabilities],
                        "context_length": m.context_length,
                    },
                },
            )
            entry["metadata"]["endpoints"].append(ep.name)
            # capability UNION across endpoints: with role-split fleets the
            # first endpoint synced may be prefill-only — the model still
            # has "decode" somewhere, and clients read this list to know
            # what the FLEET can do (docs/disaggregation.md)
            for c in m.capabilities:
                if c.value not in entry["metadata"]["capabilities"]:
                    entry["metadata"]["capabilities"].append(c.value)
    return web.json_response({"object": "list", "data": list(seen.values())})


async def get_model(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    model_id = request.match_info["model_id"]
    canonical = to_canonical(model_id)
    pairs = state.registry.find_by_model(canonical)
    if not pairs:
        return error_response(404, f"model {model_id!r} not found")
    _, m = pairs[0]
    return web.json_response(
        {
            "id": m.canonical_name,
            "object": "model",
            "created": int(m.created_at),
            "owned_by": "llmlb",
        }
    )
