"""Admin /api/* surface: endpoints CRUD + auth + users + keys + invitations +
audit queries + settings + system info.

The port's copy of llmlb_tpu/gateway/api_admin.py, handler for handler:
`system_info` carries the update manager's status (gateway/update.py),
`tray_status` and `tray_activate` the tray's (gateway/tray.py). Endpoint
registration and delete publish `EndpointRegistered` and `EndpointRemoved`
on the dashboard's event bus, as the reference's.
"""

from __future__ import annotations

import asyncio
import secrets
import time

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

from llmlb_tpu_torch import __version__
from llmlb_tpu_torch.gateway.auth import (
    CSRF_COOKIE,
    JWT_COOKIE,
    AuthError,
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
    Role,
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


async def get_endpoint_system_info(request: web.Request) -> web.Response:
    """Live device/system probe of one endpoint's runtime (reference
    system_info/mod.rs dispatch; llama.cpp /slots + /metrics, TPU
    /api/health, Ollama /api/version + /api/ps, xLLM /api/system)."""
    from llmlb_tpu_torch.gateway.system_info import (
        get_endpoint_system_info as probe,
    )

    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    info = await probe(ep, state.http)
    return web.json_response({
        "endpoint_id": ep.id,
        "endpoint_type": ep.endpoint_type.value,
        "available": info is not None,
        "info": info,
    })


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
    state.events.publish(
        "EndpointRegistered", {"endpoint_id": ep.id, "name": ep.name}
    )
    # immediate first health check + model sync (registration UX parity)
    if state.health_checker is not None:
        await state.health_checker.check_endpoint(ep)
        ep = state.registry.get(ep.id) or ep
    return web.json_response(
        endpoint_to_json(ep, state.registry.models_for(ep.id)), status=201
    )


async def update_endpoint(request: web.Request) -> web.Response:
    state = request.app["state"]
    ep = state.registry.get(request.match_info["endpoint_id"])
    if ep is None:
        return _json_error(404, "endpoint not found")
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    if "name" in body:
        ep.name = str(body["name"])
    if "base_url" in body:
        ep.base_url = str(body["base_url"])
    if "api_key" in body:
        ep.api_key = body["api_key"] or None
    if "endpoint_type" in body:
        try:
            ep.endpoint_type = EndpointType(body["endpoint_type"])
        except ValueError:
            return _json_error(400, "unknown endpoint_type")
    state.registry.update(ep)
    return web.json_response(endpoint_to_json(ep))


async def delete_endpoint(request: web.Request) -> web.Response:
    state = request.app["state"]
    endpoint_id = request.match_info["endpoint_id"]
    ep = state.registry.get(endpoint_id)
    if not state.registry.remove(endpoint_id):
        return _json_error(404, "endpoint not found")
    state.load_manager.clear_tps_for_endpoint(endpoint_id)
    state.load_manager.drop_endpoint_outcomes(endpoint_id)
    if state.resilience is not None:
        state.resilience.forget(endpoint_id,
                                endpoint_name=ep.name if ep else None)
    state.events.publish("EndpointRemoved", {"endpoint_id": endpoint_id})
    return web.json_response({"deleted": endpoint_id})


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


async def endpoint_health_history(request: web.Request) -> web.Response:
    state = request.app["state"]
    endpoint_id = request.match_info["endpoint_id"]
    rows = state.db.list_health_checks(endpoint_id, limit=200)
    return web.json_response({
        "checks": [
            {"ok": bool(r["ok"]), "latency_ms": r["latency_ms"],
             "error": r["error"], "checked_at": r["checked_at"]}
            for r in rows
        ]
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


async def change_password(request: web.Request) -> web.Response:
    state = request.app["state"]
    auth = request.get("auth") or {}
    if not auth.get("user_id"):
        return _json_error(401, "not authenticated")
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    user = state.users.get(auth["user_id"])
    try:
        ok = user is not None and state.users.authenticate(
            user.username, body.get("current_password") or ""
        )
    except UnsupportedPasswordHash as e:
        return _json_error(401, str(e))
    if not ok:
        return _json_error(401, "current password incorrect")
    try:
        state.users.change_password(user.id, body.get("new_password") or "")
    except AuthError as e:
        return _json_error(400, str(e))
    return web.json_response({"changed": True})


async def register_with_invitation(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    try:
        user = state.invitations.redeem(
            body.get("code") or "", body.get("username") or "",
            body.get("password") or "", state.users,
        )
    except AuthError as e:
        return _json_error(400, str(e))
    token = create_jwt(state.jwt_secret, user.id, user.username, user.role)
    return web.json_response({"token": token, "user": {
        "id": user.id, "username": user.username, "role": user.role.value,
    }}, status=201)


# -------------------------------------------------------------------- users


async def list_users(request: web.Request) -> web.Response:
    state = request.app["state"]
    return web.json_response({"users": [
        {"id": u.id, "username": u.username, "role": u.role.value,
         "must_change_password": u.must_change_password,
         "created_at": u.created_at}
        for u in state.users.list()
    ]})


async def create_user(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
    except Exception:
        return _json_error(400, "invalid JSON body")
    try:
        role = Role(body.get("role", "viewer"))
        user = state.users.create(
            body.get("username") or "", body.get("password") or "", role
        )
    except (AuthError, ValueError) as e:
        return _json_error(400, str(e))
    return web.json_response(
        {"id": user.id, "username": user.username, "role": user.role.value},
        status=201,
    )


async def delete_user(request: web.Request) -> web.Response:
    state = request.app["state"]
    auth = request.get("auth") or {}
    user_id = request.match_info["user_id"]
    if auth.get("user_id") == user_id:
        return _json_error(400, "cannot delete your own account")
    if not state.users.delete(user_id):
        return _json_error(404, "user not found")
    return web.json_response({"deleted": user_id})


async def set_user_role(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
        role = Role(body.get("role"))
    except Exception:
        return _json_error(400, "invalid role")
    user_id = request.match_info["user_id"]
    if state.users.get(user_id) is None:
        return _json_error(404, "user not found")
    state.users.set_role(user_id, role)
    return web.json_response({"id": user_id, "role": role.value})


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


# -------------------------------------------------------------- invitations


async def list_invitations(request: web.Request) -> web.Response:
    state = request.app["state"]
    return web.json_response({"invitations": state.invitations.list()})


async def create_invitation(request: web.Request) -> web.Response:
    state = request.app["state"]
    auth = request.get("auth") or {}
    try:
        body = await request.json() if request.can_read_body else {}
    except Exception:
        body = {}
    try:
        role = Role(body.get("role", "viewer"))
    except ValueError:
        return _json_error(400, "invalid role")
    inv = state.invitations.create(auth.get("user_id") or "", role)
    return web.json_response(inv, status=201)


async def delete_invitation(request: web.Request) -> web.Response:
    state = request.app["state"]
    if not state.invitations.delete(request.match_info["invitation_id"]):
        return _json_error(404, "invitation not found")
    return web.json_response({"deleted": request.match_info["invitation_id"]})


# -------------------------------------------------------------------- audit


async def query_audit_log(request: web.Request) -> web.Response:
    state = request.app["state"]
    q = request.query
    entries = state.audit.search(
        q=q.get("q"), actor=q.get("actor"), path_prefix=q.get("path"),
        since=float(q["since"]) if "since" in q else None,
        until=float(q["until"]) if "until" in q else None,
        limit=min(int(q.get("limit", 100)), 1000),
        offset=int(q.get("offset", 0)),
    )
    return web.json_response({"entries": entries})


async def verify_audit_chain(request: web.Request) -> web.Response:
    state = request.app["state"]
    state.audit.flush()
    ok, err = state.audit.verify()
    return web.json_response({"ok": ok, "error": err})


# ----------------------------------------------------------------- settings


async def get_settings(request: web.Request) -> web.Response:
    state = request.app["state"]
    settings = {
        k: v for k, v in state.db.list_settings().items()
        if not k.startswith("auth.")  # never expose secrets
    }
    return web.json_response({"settings": settings})


async def update_setting(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
        key, value = str(body["key"]), str(body["value"])
    except Exception:
        return _json_error(400, "body must have 'key' and 'value'")
    if key.startswith("auth."):
        return _json_error(400, "auth.* settings are not writable via API")
    if key == "ip_alert_threshold":
        from llmlb_tpu_torch.gateway.api_dashboard import parse_ip_alert_threshold

        try:
            parse_ip_alert_threshold(value)
        except ValueError:
            return _json_error(400, "ip_alert_threshold must be an integer >= 1")
    state.db.set_setting(key, value)
    return web.json_response({"key": key, "value": value})


# ------------------------------------------------------------------- system


async def system_info(request: web.Request) -> web.Response:
    state = request.app["state"]
    update = None
    if state.update_manager is not None:
        update = state.update_manager.status()
    return web.json_response({
        "name": "llmlb_tpu",
        "version": __version__,
        "uptime_s": round(time.time() - state.started_at, 1),
        "update": update,
        "gate": {
            "rejecting": state.gate.rejecting,
            "in_flight": state.gate.in_flight,
        },
    })


async def tray_status(request: web.Request) -> web.Response:
    """Tray menu + notifications (headless backends expose them here since
    there is no desktop shell to draw in — gui/tray.rs equivalent surface)."""
    state = request.app["state"]
    if state.tray is None:
        return web.json_response({"enabled": False})
    return web.json_response({"enabled": True, **state.tray.status()})


async def tray_activate(request: web.Request) -> web.Response:
    """Dispatch a tray menu click (the reference's tray→update-manager proxy,
    reachable over HTTP because the backend is headless)."""
    state = request.app["state"]
    if state.tray is None:
        return _json_error(404, "tray is not enabled (set LLMLB_TRAY=1)")
    try:
        body = await request.json()
        item = str(body["item"])
    except Exception:
        return _json_error(400, "body must have 'item'")
    result = await state.tray.activate(item)
    return web.json_response(result, status=200 if result.get("ok") else 400)
