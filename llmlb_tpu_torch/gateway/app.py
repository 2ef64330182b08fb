"""Gateway application: route tree + middleware stack.

The port's counterpart of llmlb_tpu/gateway/app.py: the OpenAI surface
(chat, completions, responses, embeddings, models, audio, images, and the
`openai:` / `google:` / `anthropic:` cloud prefixes), the Anthropic
/v1/messages, auth with users and invitations, endpoints admin, API keys,
the model registry and HF catalog, per-endpoint model management and the
playground proxy, the audit log, settings, system info, the dashboard's
data routes, its WebSocket (/ws/dashboard) and its static SPA (/dashboard,
the port's copy of the bundle), the TPS benchmarks, cloud metrics, request
traces, the tray (/api/system/tray*) and the self-update lifecycle
(/api/system/update/*), /health, /api/health and /metrics, behind the
reference's middlewares in its order: tracing (outermost) → audit →
inference gate → CSRF → auth (JWT / API key / x-api-key) → handler.
"""

from __future__ import annotations

import logging
import os
import time

from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway import (
    api_admin,
    api_anthropic,
    api_benchmarks,
    api_cloud,
    api_dashboard,
    api_media,
    api_models,
    api_openai,
    tracing,
)
from llmlb_tpu_torch.gateway.app_state import (
    METRICS_SPOOL_DEFAULT_S,
    AppState,
    gateway_exposition,
    read_peer_metrics,
    write_metrics_spool,
)
from llmlb_tpu_torch.gateway.audit import AuditEntry
from llmlb_tpu_torch.gateway.auth import (
    CSRF_COOKIE,
    JWT_COOKIE,
    AuthError,
    verify_jwt,
)
from llmlb_tpu_torch.gateway.config import env_float
from llmlb_tpu_torch.gateway.metrics import label_exposition
from llmlb_tpu_torch.gateway.tracing import REQUEST_ID_HEADER, mint_request_id
from llmlb_tpu_torch.gateway.types import Permission

log = logging.getLogger("llmlb_tpu_torch.gateway.app")

MAX_BODY_BYTES = 20 * 1024 * 1024  # parity: api/mod.rs:58

PUBLIC_PATHS = {
    ("POST", "/api/auth/login"),
    ("POST", "/api/auth/register"),
    ("GET", "/health"),
    ("GET", "/api/health"),  # fleet health + breaker state, same stance
    ("GET", "/metrics"),  # Prometheus scrape, same stance as the engine's
    ("GET", "/"),
}

# method+prefix → permission required when authenticating with an API key
_API_KEY_PERMS: list[tuple[str, str, Permission]] = [
    ("GET", "/api/endpoints", Permission.ENDPOINTS_READ),
    ("*", "/api/endpoints", Permission.ENDPOINTS_MANAGE),
    ("*", "/api/users", Permission.USERS_MANAGE),
    ("*", "/api/invitations", Permission.INVITATIONS_MANAGE),
    ("GET", "/api/audit", Permission.LOGS_READ),
    ("GET", "/api/dashboard/logs", Permission.LOGS_READ),
    ("GET", "/api/dashboard", Permission.METRICS_READ),
    ("GET", "/api/metrics", Permission.METRICS_READ),
    ("GET", "/api/models/registry", Permission.REGISTRY_READ),
    ("GET", "/api/benchmarks", Permission.METRICS_READ),
    ("GET", "/api/traces", Permission.METRICS_READ),
]


def _is_traced_path(path: str) -> bool:
    """Inference paths get full lifecycle traces (every request gets an id)."""
    return path.startswith("/v1/") or (
        path.startswith("/api/endpoints/")
        and path.endswith("/chat/completions")
    )


def _route_label(request: web.Request) -> str | None:
    """Matched route pattern (e.g. '/v1/chat/completions') — a bounded label
    set; unmatched requests return None and are not counted."""
    resource = getattr(request.match_info.route, "resource", None)
    return getattr(resource, "canonical", None)


@web.middleware
async def tracing_middleware(request: web.Request, handler):
    """Outermost: mints/reuses X-Request-Id, echoes it on every response
    (success and error paths), records the lifecycle trace for inference
    requests, and counts requests/errors per route in GatewayMetrics."""
    state: AppState = request.app["state"]
    rid = mint_request_id(request.headers.get(REQUEST_ID_HEADER))
    request["request_id"] = rid
    trace = None
    if _is_traced_path(request.path):
        trace = state.traces.start(rid, request.method, request.path)
        # auth covers the middleware stack up to the handler; the inference
        # handlers close it on entry, finish() closes it on rejection.
        trace.begin("auth")
        request["trace"] = trace
    status = 500
    error = None
    try:
        response = await handler(request)
        status = response.status
        if not response.prepared:  # streamed responses set it pre-prepare
            response.headers[REQUEST_ID_HEADER] = rid
        return response
    except web.HTTPException as e:
        status = e.status
        e.headers[REQUEST_ID_HEADER] = rid
        raise
    except Exception as e:
        error = f"{type(e).__name__}: {e}"
        raise
    finally:
        if trace is not None:
            state.traces.finish(trace, status, error)
        route = _route_label(request)
        if route is not None and request.path != "/metrics":
            state.metrics.record_request(route, status)


@web.middleware
async def audit_middleware(request: web.Request, handler):
    """Directly inside tracing: every request lands in the tamper-evident
    audit log."""
    state: AppState = request.app["state"]
    start = time.monotonic()
    status = 500
    detail = None
    try:
        response = await handler(request)
        status = response.status
        return response
    except web.HTTPException as e:
        status = e.status
        raise
    except Exception as e:
        detail = f"{type(e).__name__}: {e}"
        raise
    finally:
        if request.path != "/ws/dashboard":
            auth = request.get("auth") or {}
            state.audit.record(AuditEntry(
                ts=time.time(),
                method=request.method,
                path=request.path,
                status=status,
                duration_ms=(time.monotonic() - start) * 1000.0,
                actor=auth.get("actor"),
                actor_type=auth.get("actor_type", "anonymous"),
                ip=request.remote,
                detail=detail,
            ))


@web.middleware
async def gate_middleware(request: web.Request, handler):
    """Inference gate: during update drain, /v1/* rejects with 503+Retry-After
    (inference_gate.rs:200-230); otherwise counts the request in flight for the
    full (streaming) response lifetime."""
    state: AppState = request.app["state"]
    # Playground proxy is inference too (reference gates it: api/mod.rs:460-479).
    is_inference = request.path.startswith("/v1/") or (
        request.path.startswith("/api/endpoints/")
        and request.path.endswith("/chat/completions")
    )
    if is_inference:
        if state.gate.rejecting:
            return web.json_response(
                {"error": {"message": "server is draining for update",
                           "type": "server_error", "code": "draining"}},
                status=503,
                headers={"Retry-After": "30"},
            )
        with state.gate.track():
            return await handler(request)
    return await handler(request)


def _required_api_key_perm(method: str, path: str) -> Permission | None:
    for m, prefix, perm in _API_KEY_PERMS:
        if path.startswith(prefix) and (m == "*" or m == method):
            return perm
    return None


def _origin_matches(request: web.Request) -> bool:
    """Origin/Referer must match the Host the request arrived on (parity:
    auth/middleware.rs origin_matches). Missing both headers fails closed."""
    origin = request.headers.get("Origin")
    if origin is None:
        referer = request.headers.get("Referer")
        if referer and "://" in referer:
            scheme, _, rest = referer.partition("://")
            origin = f"{scheme}://{rest.split('/', 1)[0]}"
    if not origin or "://" not in origin:
        return False
    host = request.headers.get("X-Forwarded-Host", request.host)
    host = host.split(",")[0].strip()
    proto = request.headers.get(
        "X-Forwarded-Proto", request.scheme or "http"
    ).split(",")[0].strip()

    def norm(scheme: str, authority: str) -> tuple[str, str, str]:
        scheme = scheme.lower()
        authority = authority.lower().rstrip(".")
        default_port = {"http": "80", "https": "443"}.get(scheme, "")
        if authority.startswith("["):  # bracketed IPv6: [::1] or [::1]:8080
            h, _, rest = authority.partition("]")
            h += "]"
            p = rest[1:] if rest.startswith(":") else default_port
        elif ":" in authority:
            h, _, p = authority.rpartition(":")
        else:
            h, p = authority, default_port
        return scheme, h.rstrip("."), p or default_port

    o_scheme, _, o_rest = origin.partition("://")
    return norm(o_scheme, o_rest.split("/", 1)[0]) == norm(proto, host)


@web.middleware
async def csrf_middleware(request: web.Request, handler):
    """Double-submit CSRF for cookie-authenticated state changes (parity:
    auth/middleware.rs:431-479 csrf_protect_middleware). Header-authenticated
    requests (Authorization / x-api-key) are exempt — only the browser cookie
    session is forgeable cross-site."""
    if request.method not in ("POST", "PUT", "PATCH", "DELETE"):
        return await handler(request)
    if not request.path.startswith("/api/"):
        return await handler(request)
    if (request.method, request.path) in PUBLIC_PATHS:
        return await handler(request)  # login/register establish the session
    if "Authorization" in request.headers or "x-api-key" in request.headers:
        return await handler(request)
    if request.cookies.get(JWT_COOKIE) is None:
        return await handler(request)  # not a cookie session; auth will 401

    cookie_token = request.cookies.get(CSRF_COOKIE)
    if not cookie_token:
        return web.json_response({"error": "missing CSRF cookie"}, status=403)
    header_token = request.headers.get("x-csrf-token")
    if not header_token:
        return web.json_response({"error": "missing CSRF header"}, status=403)
    if cookie_token != header_token:
        return web.json_response({"error": "invalid CSRF token"}, status=403)
    if not _origin_matches(request):
        return web.json_response(
            {"error": "origin validation failed"}, status=403
        )
    return await handler(request)


@web.middleware
async def auth_middleware(request: web.Request, handler):
    state: AppState = request.app["state"]
    method, path = request.method, request.path

    if method == "OPTIONS" or (method, path) in PUBLIC_PATHS or path.startswith(
        "/dashboard"
    ):
        return await handler(request)
    if path == "/ws/dashboard":  # WS does its own token auth (query/cookie)
        return await handler(request)

    # ---- credential extraction
    bearer = None
    authz = request.headers.get("Authorization", "")
    if authz.startswith("Bearer "):
        bearer = authz[7:].strip()
    # Dashboard cookie session — accepted only on the /api/* surface, where
    # csrf_middleware guards state changes. /v1/* stays header-auth-only so a
    # cross-site form POST can never ride the browser cookie into inference.
    if not bearer and path.startswith("/api/"):
        bearer = request.cookies.get(JWT_COOKIE)
    anthropic_key = request.headers.get("x-api-key")  # Anthropic-style

    auth_ctx: dict | None = None
    if bearer and bearer.startswith("sk_"):
        key = state.api_keys.verify(bearer)
        if key:
            auth_ctx = {
                "actor": f"key:{key.name}", "actor_type": "api_key",
                "api_key_id": key.id, "user_id": key.user_id,
                "permissions": set(key.permissions), "role": None,
            }
    elif bearer:
        try:
            payload = verify_jwt(state.jwt_secret, bearer)
            auth_ctx = {
                "actor": payload.get("username"), "actor_type": "jwt",
                "user_id": payload.get("sub"), "api_key_id": None,
                "permissions": None, "role": payload.get("role"),
            }
        except AuthError:
            auth_ctx = None
    if auth_ctx is None and anthropic_key and anthropic_key.startswith("sk_"):
        key = state.api_keys.verify(anthropic_key)
        if key:
            auth_ctx = {
                "actor": f"key:{key.name}", "actor_type": "api_key",
                "api_key_id": key.id, "user_id": key.user_id,
                "permissions": set(key.permissions), "role": None,
            }

    if auth_ctx is None:
        if path.startswith("/v1/"):
            return web.json_response(
                {"error": {"message": "missing or invalid API key",
                           "type": "authentication_error", "code": None}},
                status=401,
            )
        return web.json_response({"error": "authentication required"}, status=401)

    request["auth"] = auth_ctx

    # ---- authorization
    if path.startswith("/v1/"):
        if auth_ctx["actor_type"] == "api_key":
            needed = (
                Permission.OPENAI_MODELS_READ
                if path.startswith("/v1/models") and method == "GET"
                else Permission.OPENAI_INFERENCE
            )
            perms = auth_ctx["permissions"] or set()
            if needed not in perms and Permission.OPENAI_INFERENCE not in perms:
                return web.json_response(
                    {"error": {"message": f"API key lacks {needed.value}",
                               "type": "permission_error", "code": None}},
                    status=403,
                )
        return await handler(request)

    # /api/* surface
    if auth_ctx["actor_type"] == "api_key":
        needed = _required_api_key_perm(method, path)
        if needed is None or needed not in (auth_ctx["permissions"] or set()):
            return web.json_response(
                {"error": f"API key lacks permission for {method} {path}"},
                status=403,
            )
        return await handler(request)

    # JWT: viewers read, admins everything; self-service paths exempt
    if auth_ctx["role"] != "admin":
        self_service = path in (
            "/api/auth/me", "/api/auth/change-password", "/api/api-keys"
        ) or path.startswith("/api/api-keys/")
        if method not in ("GET", "HEAD") and not self_service:
            return web.json_response(
                {"error": "admin role required"}, status=403
            )
    return await handler(request)


def create_app(state: AppState) -> web.Application:
    app = web.Application(
        client_max_size=MAX_BODY_BYTES,
        middlewares=[
            tracing_middleware, audit_middleware, gate_middleware,
            csrf_middleware, auth_middleware,
        ],
    )
    app["state"] = state
    r = app.router

    # ---- OpenAI surface (api/mod.rs:523-535)
    r.add_post("/v1/chat/completions", api_openai.chat_completions)
    r.add_post("/v1/completions", api_openai.completions)
    r.add_post("/v1/embeddings", api_openai.embeddings)
    r.add_post("/v1/responses", api_openai.responses)
    r.add_get("/v1/models", api_openai.list_models)
    r.add_get("/v1/models/{model_id:.+}", api_openai.get_model)
    r.add_post("/v1/audio/transcriptions", api_media.audio_transcriptions)
    r.add_post("/v1/audio/speech", api_media.audio_speech)
    r.add_post("/v1/images/generations", api_media.images_generations)
    r.add_post("/v1/images/edits", api_media.images_edits)
    r.add_post("/v1/images/variations", api_media.images_variations)

    # ---- Anthropic surface (api/mod.rs:553)
    r.add_post("/v1/messages", api_anthropic.messages)

    # ---- auth
    r.add_post("/api/auth/login", api_admin.login)
    r.add_post("/api/auth/logout", api_admin.logout)
    r.add_post("/api/auth/register", api_admin.register_with_invitation)
    r.add_get("/api/auth/me", api_admin.me)
    r.add_post("/api/auth/change-password", api_admin.change_password)

    # ---- endpoints admin
    r.add_get("/api/endpoints", api_admin.list_endpoints)
    r.add_post("/api/endpoints", api_admin.create_endpoint)
    r.add_get("/api/endpoints/{endpoint_id}", api_admin.get_endpoint)
    r.add_get(
        "/api/endpoints/{endpoint_id}/system-info",
        api_admin.get_endpoint_system_info,
    )
    r.add_put("/api/endpoints/{endpoint_id}", api_admin.update_endpoint)
    r.add_delete("/api/endpoints/{endpoint_id}", api_admin.delete_endpoint)
    r.add_post("/api/endpoints/{endpoint_id}/test", api_admin.test_endpoint)
    r.add_post("/api/endpoints/{endpoint_id}/sync", api_admin.sync_endpoint)
    r.add_get(
        "/api/endpoints/{endpoint_id}/health",
        api_admin.endpoint_health_history,
    )

    # ---- users / keys / invitations
    r.add_get("/api/users", api_admin.list_users)
    r.add_post("/api/users", api_admin.create_user)
    r.add_delete("/api/users/{user_id}", api_admin.delete_user)
    r.add_put("/api/users/{user_id}/role", api_admin.set_user_role)
    r.add_get("/api/api-keys", api_admin.list_api_keys)
    r.add_post("/api/api-keys", api_admin.create_api_key)
    r.add_delete("/api/api-keys/{key_id}", api_admin.revoke_api_key)
    r.add_get("/api/invitations", api_admin.list_invitations)
    r.add_post("/api/invitations", api_admin.create_invitation)
    r.add_delete(
        "/api/invitations/{invitation_id}", api_admin.delete_invitation
    )

    # ---- audit / settings / system
    # ---- model registry + catalog + per-endpoint model management
    r.add_post("/api/models/register", api_models.register_model)
    r.add_get("/api/models", api_models.list_registered_models)
    r.add_delete("/api/models/{name}", api_models.delete_registered_model)
    r.add_get(
        "/api/models/registry/{model}/manifest.json",
        api_models.get_model_manifest,
    )
    r.add_get("/api/catalog/search", api_models.catalog_search)
    r.add_post(
        "/api/endpoints/{endpoint_id}/models/download",
        api_models.download_endpoint_model,
    )
    r.add_get(
        "/api/endpoints/models/download/{task_id}",
        api_models.download_progress,
    )
    r.add_delete(
        "/api/endpoints/{endpoint_id}/models/{model}",
        api_models.delete_endpoint_model,
    )
    r.add_get(
        "/api/endpoints/{endpoint_id}/models/{model}/info",
        api_models.endpoint_model_info,
    )
    r.add_post(
        "/api/endpoints/{endpoint_id}/chat/completions",
        api_models.playground_chat_proxy,
    )

    r.add_get("/api/audit-log", api_admin.query_audit_log)
    r.add_post("/api/audit-log/verify", api_admin.verify_audit_chain)
    r.add_get("/api/dashboard/settings", api_admin.get_settings)
    r.add_put("/api/dashboard/settings", api_admin.update_setting)
    r.add_get("/api/system", api_admin.system_info)
    r.add_get("/api/system/tray", api_admin.tray_status)
    r.add_post("/api/system/tray/activate", api_admin.tray_activate)

    # ---- dashboard data + WS
    r.add_get("/api/dashboard/overview", api_dashboard.overview)
    r.add_get(
        "/api/dashboard/request-history", api_dashboard.request_history_minutes
    )
    r.add_get("/api/dashboard/requests", api_dashboard.request_records)
    r.add_get(
        "/api/dashboard/requests/{record_id}",
        api_dashboard.request_record_detail,
    )
    r.add_get("/api/dashboard/token-stats", api_dashboard.token_stats)
    r.add_get(
        "/api/dashboard/endpoints/{endpoint_id}/stats",
        api_dashboard.endpoint_stats,
    )
    r.add_get("/api/dashboard/model-tps", api_dashboard.model_tps)
    r.add_get("/api/dashboard/clients", api_dashboard.client_analytics)
    r.add_get("/api/dashboard/logs/lb", api_dashboard.tail_lb_logs)
    r.add_get("/ws/dashboard", api_dashboard.dashboard_ws)

    # ---- benchmarks + cloud metrics
    r.add_post("/api/benchmarks/tps", api_benchmarks.start_tps_benchmark)
    r.add_get("/api/benchmarks/tps", api_benchmarks.list_tps_benchmarks)
    r.add_get("/api/benchmarks/tps/{run_id}", api_benchmarks.get_tps_benchmark)
    r.add_get("/api/metrics/cloud", api_cloud.cloud_metrics_handler)

    # ---- observability: request traces + gateway-wide Prometheus metrics
    r.add_get("/api/traces", tracing.list_traces)
    r.add_get("/api/traces/{trace_id}", tracing.get_trace)
    r.add_get("/metrics", _gateway_metrics)

    # ---- update lifecycle
    r.add_post("/api/system/update/check", _update_check)
    r.add_post("/api/system/update/apply", _update_apply)
    r.add_post("/api/system/update/cancel", _update_cancel)
    r.add_put("/api/system/update/schedule", _update_schedule)

    # ---- liveness + root
    r.add_get("/health", _health)
    r.add_get("/api/health", _api_health)
    r.add_get("/", _root)

    # ---- dashboard SPA (static bundle, embedded in the reference binary)
    static_dir = os.path.join(os.path.dirname(__file__), "dashboard_static")
    if os.path.isdir(static_dir):
        r.add_get("/dashboard", _dashboard_index)
        r.add_get("/dashboard/{tail:.*}", _dashboard_asset)
        app["dashboard_static"] = static_dir

    async def on_shutdown(app):
        await state.close()

    app.on_shutdown.append(on_shutdown)
    return app


async def _health(request: web.Request) -> web.Response:
    return web.json_response({"status": "ok"})


async def _api_health(request: web.Request) -> web.Response:
    """GET /api/health — fleet-level health: per-endpoint status as the
    scheduler sees it right now (pull-checker status AND in-band breaker
    state + outcome counters), admission pressure, and the retry budget.
    The gateway-side counterpart of the engine's /api/health.

    Public (same stance as /metrics, which already exposes endpoint names
    and breaker states as labels) — but only names, never endpoint ids:
    ids are admin-API identifiers and stay behind auth."""
    state: AppState = request.app["state"]
    endpoints = []
    for ep in state.registry.list_all():
        breaker = (state.resilience.breaker_info(ep.id)
                   if state.resilience is not None
                   else {"state": ep.breaker_state})
        endpoints.append({
            "name": ep.name,
            "status": ep.status.value,
            # serving role from the last engine probe (docs/disaggregation.md)
            "role": ep.accelerator.role or "both",
            # graceful-drain advertisement from the last probe: a draining
            # engine is online but ejected from selection
            # (docs/deployment.md)
            "draining": ep.accelerator.draining,
            "breaker": breaker,
            "latency_ms": ep.latency_ms,
            "consecutive_probe_failures": ep.consecutive_failures,
            "outcomes": state.load_manager.endpoint_outcomes(ep.id),
            "active_requests": state.load_manager.active_count(ep.id),
        })
    online = sum(1 for e in endpoints if e["status"] == "online")
    serving = sum(
        1 for e in endpoints
        if (e["status"] == "online" and e["breaker"]["state"] != "open"
            and not e["draining"])
    )
    body = {
        "status": "ok" if serving or not endpoints else "degraded",
        "uptime_s": round(time.time() - state.started_at, 1),
        "endpoints_online": online,
        "endpoints_serving": serving,  # online AND breaker not open
        "endpoints": endpoints,
        "admission": {
            "queue_depth": state.admission.queue_depth(),
            "active_requests": state.load_manager.total_active(),
            "wfq_enabled": state.admission.wfq_enabled,
        },
    }
    if state.ratelimit is not None and state.ratelimit.enabled:
        body["ratelimit"] = state.ratelimit.snapshot()
    if state.worker.multi:
        body["worker"] = {"index": state.worker.index,
                          "count": state.worker.count}
    # a single-worker host federated over the mesh still has peers worth
    # showing (docs/deployment.md cross-host topology)
    if state.gossip is not None:
        body["gossip"] = state.gossip.stats()
    if state.resilience is not None:
        cfg = state.resilience.config
        body["resilience"] = {
            "enabled": cfg.enabled,
            "max_attempts": cfg.max_attempts,
            "breaker_failure_threshold": cfg.breaker_failure_threshold,
            "breaker_open_s": cfg.breaker_open_s,
            "retry_budget": state.resilience.budget.snapshot(),
        }
    if state.faults is not None:
        body["faults"] = state.faults.snapshot()
    return web.json_response(body)


async def _gateway_metrics(request: web.Request) -> web.Response:
    """GET /metrics — gateway-wide Prometheus exposition: per-model/endpoint
    TTFT, e2e, and queue-wait histograms, per-route counters, plus
    scrape-time gauges owned by the balancer, admission queue and event
    bus.

    Multi-worker: SO_REUSEPORT hands the scrape to ONE arbitrary worker, so
    the serving worker labels its own series worker="i", refreshes its
    spool, and appends its siblings' spooled (already-labeled) series —
    Prometheus sees the whole group on every scrape, attributable per
    worker (docs/deployment.md)."""
    state: AppState = request.app["state"]
    text = gateway_exposition(state)
    if state.worker.multi:
        text = label_exposition(text, "worker", state.worker.label)
        try:
            # scrape-fresh spool for whoever serves the next scrape, from
            # the text already rendered above (no second exposition build)
            write_metrics_spool(state, labeled_text=text)
        except OSError:
            pass
        interval = env_float("LLMLB_METRICS_SPOOL_SECS",
                             METRICS_SPOOL_DEFAULT_S)
        text += read_peer_metrics(state, max_age_s=3 * interval + 2.0)
    return web.Response(text=text, content_type="text/plain", charset="utf-8")


async def _root(request: web.Request) -> web.Response:
    return web.json_response({
        "name": "llmlb_tpu",
        "endpoints": ["/v1/chat/completions", "/v1/responses", "/v1/models",
                      "/v1/messages", "/api/endpoints", "/dashboard"],
    })


async def _dashboard_index(request: web.Request) -> web.FileResponse:
    return web.FileResponse(
        os.path.join(request.app["dashboard_static"], "index.html")
    )


async def _dashboard_asset(request: web.Request) -> web.StreamResponse:
    static_dir = os.path.abspath(request.app["dashboard_static"])
    tail = request.match_info["tail"] or "index.html"
    full = os.path.normpath(os.path.join(static_dir, tail))
    # containment by path components: a sibling directory whose name
    # starts with the bundle's would pass a string-prefix check
    if os.path.commonpath([full, static_dir]) != static_dir or \
            not os.path.isfile(full):
        return await _dashboard_index(request)  # SPA fallback
    return web.FileResponse(full)


async def _update_check(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    if state.update_manager is None:
        return web.json_response({"error": "updates not configured"}, status=501)
    return web.json_response(await state.update_manager.check(force=True))


async def _update_apply(request: web.Request) -> web.Response:
    from llmlb_tpu_torch.gateway.update import ApplyMode

    state: AppState = request.app["state"]
    if state.update_manager is None:
        return web.json_response({"error": "updates not configured"}, status=501)
    try:
        body = await request.json() if request.can_read_body else {}
    except Exception:
        body = {}
    mode = ApplyMode.FORCE if body.get("force") else ApplyMode.NORMAL
    started = state.update_manager.request_apply(mode)
    return web.json_response(
        {"applying": started, **state.update_manager.status()},
        status=202 if started else 409,
    )


async def _update_cancel(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    if state.update_manager is None:
        return web.json_response({"error": "updates not configured"}, status=501)
    return web.json_response({"cancelled": state.update_manager.cancel_drain()})


async def _update_schedule(request: web.Request) -> web.Response:
    state: AppState = request.app["state"]
    if state.update_manager is None:
        return web.json_response({"error": "updates not configured"}, status=501)
    try:
        body = await request.json()
        state.update_manager.set_schedule(
            body.get("mode", "immediate"), body.get("at_time")
        )
    except Exception as e:
        return web.json_response({"error": str(e)}, status=400)
    return web.json_response(state.update_manager.status())
