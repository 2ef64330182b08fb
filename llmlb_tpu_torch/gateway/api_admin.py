"""Admin /api/* surface of the serving path: login, logout and me; the
endpoint list, registration, detail, connection test and model sync; API
keys.

The port's part of llmlb_tpu/gateway/api_admin.py, handler for handler.
The reference's endpoint update and delete, users, invitations, audit log,
settings and system handlers come in later slices.
"""

from __future__ import annotations

import asyncio
import secrets
import time

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch.gateway.auth import (
    CSRF_COOKIE,
    JWT_COOKIE,
    UnsupportedPasswordHash,
    create_jwt,
)
from llmlb_tpu_torch.gateway.detection import (
    DetectionError,
    Unreachable,
    detect_endpoint_type,
)
from llmlb_tpu_torch.gateway.model_sync import sync_endpoint_models
from llmlb_tpu_torch.gateway.types import (
    Endpoint,
    EndpointStatus,
    EndpointType,
    Permission,
)


def _json_error(status: int, message: str) -> web.Response:
    return web.json_response({"error": message}, status=status)


def endpoint_to_json(ep: Endpoint, models: list | None = None) -> dict:
    out = {
        "id": ep.id,
        "name": ep.name,
        "base_url": ep.base_url,
        "endpoint_type": ep.endpoint_type.value,
        "status": ep.status.value,
        "breaker_state": ep.breaker_state,
        # disaggregation role as of the last health probe ("both" when the
        # endpoint advertises none — docs/disaggregation.md)
        "role": ep.accelerator.role or "both",
        "latency_ms": ep.latency_ms,
        "consecutive_failures": ep.consecutive_failures,
        "accelerator": {
            "accelerator": ep.accelerator.accelerator,
            "chip_count": ep.accelerator.chip_count,
            "hbm_used_bytes": ep.accelerator.hbm_used_bytes,
            "hbm_total_bytes": ep.accelerator.hbm_total_bytes,
            "utilization": ep.accelerator.utilization,
        },
        "created_at": ep.created_at,
        "updated_at": ep.updated_at,
        "last_checked_at": ep.last_checked_at,
        "has_api_key": bool(ep.api_key),
    }
    if models is not None:
        out["models"] = [
            {
                "model_id": m.model_id,
                "canonical_name": m.canonical_name,
                "capabilities": [c.value for c in m.capabilities],
                "context_length": m.context_length,
            }
            for m in models
        ]
    return out


# ------------------------------------------------------------- endpoints API


async def list_endpoints(request: web.Request) -> web.Response:
    state = request.app["state"]
    out = [
        endpoint_to_json(ep, state.registry.models_for(ep.id))
        for ep in state.registry.list_all()
    ]
    out.sort(key=lambda e: (e["latency_ms"] is None, e["latency_ms"] or 0))
    return web.json_response({"endpoints": out})


async def get_endpoint(request: web.Request) -> web.Response:
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    return web.json_response(endpoint_to_json(ep, state.registry.models_for(ep.id)))


async def create_endpoint(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    base_url = (body.get("base_url") or body.get("url") or "").strip()
    if not base_url.startswith(("http://", "https://")):
        return _json_error(400, "base_url must be an http(s) URL")
    name = body.get("name") or base_url
    ep = Endpoint(
        name=name, base_url=base_url, api_key=body.get("api_key"),
        status=EndpointStatus.PENDING,
    )
    requested_type = body.get("endpoint_type")
    if requested_type:
        try:
            ep.endpoint_type = EndpointType(requested_type)
        except ValueError:
            return _json_error(400, f"unknown endpoint_type {requested_type!r}")
    else:
        try:
            ep.endpoint_type = await detect_endpoint_type(
                base_url, state.http, timeout=state.config.health_check_timeout_s,
                api_key=ep.api_key,
            )
        except Unreachable:
            ep.endpoint_type = EndpointType.OPENAI_COMPATIBLE  # checked later
        except DetectionError:
            ep.endpoint_type = EndpointType.OPENAI_COMPATIBLE
    try:
        state.registry.add(ep)
    except ValueError as e:
        return _json_error(409, str(e))
    # immediate first health check + model sync (registration UX parity)
    if state.health_checker is not None:
        await state.health_checker.check_endpoint(ep)
        ep = state.registry.get(ep.id) or ep
    return web.json_response(
        endpoint_to_json(ep, state.registry.models_for(ep.id)), status=201
    )


async def test_endpoint(request: web.Request) -> web.Response:
    """Connection test: probe + report (api/endpoints.rs run_connection_test)."""
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    start = time.monotonic()
    try:
        detected = await detect_endpoint_type(
            ep.base_url, state.http,
            timeout=state.config.health_check_timeout_s, api_key=ep.api_key,
        )
        return web.json_response({
            "ok": True,
            "detected_type": detected.value,
            "latency_ms": round((time.monotonic() - start) * 1000, 2),
        })
    except DetectionError as e:
        return web.json_response({
            "ok": False,
            "error": str(e),
            "latency_ms": round((time.monotonic() - start) * 1000, 2),
        })


async def sync_endpoint(request: web.Request) -> web.Response:
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    try:
        added, removed = await sync_endpoint_models(ep, state.registry, state.http)
    except (http.ClientError, asyncio.TimeoutError, OSError, RuntimeError) as e:
        return _json_error(502, f"model sync failed: {e}")
    return web.json_response({
        "synced": True, "added": added, "removed": removed,
        "models": [m.model_id for m in state.registry.models_for(ep.id)],
    })


# -------------------------------------------------------------------- auth


async def login(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    try:
        user = state.users.authenticate(
            body.get("username") or "", body.get("password") or ""
        )
    except UnsupportedPasswordHash as e:
        return _json_error(401, str(e))
    if user is None:
        return _json_error(401, "invalid credentials")
    token = create_jwt(state.jwt_secret, user.id, user.username, user.role)
    resp = web.json_response({
        "token": token,
        "user": {
            "id": user.id, "username": user.username, "role": user.role.value,
            "must_change_password": user.must_change_password,
        },
    })
    # Cookie session for the dashboard SPA: HttpOnly JWT + a readable CSRF
    # token for the double-submit check (reference auth/middleware.rs:113-245).
    csrf = secrets.token_urlsafe(32)
    secure = request.headers.get("X-Forwarded-Proto", "").lower() == "https"
    resp.set_cookie(JWT_COOKIE, token, httponly=True, samesite="Lax",
                    secure=secure, max_age=24 * 3600, path="/")
    resp.set_cookie(CSRF_COOKIE, csrf, httponly=False, samesite="Lax",
                    secure=secure, max_age=24 * 3600, path="/")
    return resp


async def logout(request: web.Request) -> web.Response:
    resp = web.json_response({"ok": True})
    resp.del_cookie(JWT_COOKIE, path="/")
    resp.del_cookie(CSRF_COOKIE, path="/")
    return resp


async def me(request: web.Request) -> web.Response:
    auth = request.get("auth") or {}
    if not auth.get("user_id"):
        return _json_error(401, "not authenticated")
    state = request.app["state"]
    user = state.users.get(auth["user_id"])
    if user is None:
        return _json_error(404, "user not found")
    return web.json_response({
        "id": user.id, "username": user.username, "role": user.role.value,
        "must_change_password": user.must_change_password,
    })


# ----------------------------------------------------------------- api keys


async def list_api_keys(request: web.Request) -> web.Response:
    state = request.app["state"]
    auth = request.get("auth") or {}
    keys = state.api_keys.list(
        None if auth.get("role") == "admin" else auth.get("user_id")
    )
    return web.json_response({"api_keys": [
        {"id": k.id, "name": k.name, "key_prefix": k.key_prefix,
         "permissions": [p.value for p in k.permissions],
         "created_at": k.created_at, "revoked": k.revoked,
         "last_used_at": k.last_used_at, "expires_at": k.expires_at}
        for k in keys
    ]})


async def create_api_key(request: web.Request) -> web.Response:
    state = request.app["state"]
    auth = request.get("auth") or {}
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    perms = []
    for p in body.get("permissions") or []:
        try:
            perms.append(Permission(p))
        except ValueError:
            return _json_error(400, f"unknown permission {p!r}")
    if not perms:
        perms = [Permission.OPENAI_INFERENCE, Permission.OPENAI_MODELS_READ]
    record, raw = state.api_keys.create(
        auth.get("user_id") or "", body.get("name") or "unnamed", perms,
        expires_at=body.get("expires_at"),
    )
    return web.json_response({
        "id": record.id, "name": record.name, "api_key": raw,
        "permissions": [p.value for p in record.permissions],
    }, status=201)


async def revoke_api_key(request: web.Request) -> web.Response:
    state = request.app["state"]
    if not state.api_keys.revoke(request.match_info["key_id"]):
        return _json_error(404, "api key not found")
    return web.json_response({"revoked": request.match_info["key_id"]})
