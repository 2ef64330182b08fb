"""Dashboard data APIs + live WebSocket.

The port's copy of llmlb_tpu/gateway/api_dashboard.py, handler for handler,
on the standard library (`gateway/http.py`'s WebSocket section serves
`/ws/dashboard`). The JSON keys are the reference's, which the SPA reads:
`tpu` holds the online endpoints' accelerator figures (the card's on the
port's engines).

Parity with reference api/dashboard.rs (overview/stats/history/token stats/
client analytics :171-1254) and api/dashboard_ws.rs (JWT-auth WS pushing event
bus messages :36-76). Data comes from the in-memory 60-min history ring plus
the daily-stats and request_history tables.
"""

from __future__ import annotations

import asyncio
import datetime
import json
import logging
import time

from llmlb_tpu_torch.gateway.http import WSMsgType, web

from llmlb_tpu_torch.gateway.auth import AuthError, verify_jwt

IP_ALERT_THRESHOLD_DEFAULT = 100  # parity: dashboard.rs:1350


def parse_ip_alert_threshold(value: str) -> int:
    """Integer >= 1, or ValueError (dashboard.rs:1353-1364)."""
    parsed = int(value)  # raises ValueError on non-integers
    if parsed < 1:
        raise ValueError("ip_alert_threshold must be an integer >= 1")
    return parsed


def effective_ip_alert_threshold(raw: str | None) -> int:
    """Configured threshold with default fallback; a corrupt stored value
    logs and falls back rather than breaking analytics (dashboard.rs:1367)."""
    if raw is None:
        return IP_ALERT_THRESHOLD_DEFAULT
    try:
        return parse_ip_alert_threshold(raw)
    except ValueError:
        log.warning("invalid ip_alert_threshold %r in settings; using "
                    "default %d", raw, IP_ALERT_THRESHOLD_DEFAULT)
        return IP_ALERT_THRESHOLD_DEFAULT

log = logging.getLogger("llmlb_tpu_torch.gateway.dashboard")


async def overview(request: web.Request) -> web.Response:
    state = request.app["state"]
    endpoints = state.registry.list_all()
    online = [e for e in endpoints if e.status.value == "online"]
    models = state.registry.canonical_model_names()
    lm_stats = state.load_manager.stats()
    today = datetime.date.today().isoformat()
    row = state.db.query_one(
        """SELECT COALESCE(SUM(request_count),0) AS requests,
                  COALESCE(SUM(error_count),0) AS errors,
                  COALESCE(SUM(prompt_tokens),0) AS pt,
                  COALESCE(SUM(completion_tokens),0) AS ct
           FROM endpoint_daily_stats WHERE date=?""",
        (today,),
    )
    return web.json_response({
        "endpoints": {"total": len(endpoints), "online": len(online)},
        "models": {"total": len(models)},
        "requests": {
            "active": lm_stats["active_requests"],
            "today": row["requests"], "errors_today": row["errors"],
        },
        "tokens_today": {"prompt": row["pt"], "completion": row["ct"]},
        "latency": state.metrics.summary(),
        "tpu": {
            "total_chips": sum(e.accelerator.chip_count for e in online),
            "hbm_used_bytes": sum(e.accelerator.hbm_used_bytes for e in online),
            "hbm_total_bytes": sum(e.accelerator.hbm_total_bytes for e in online),
        },
    })


async def request_history_minutes(request: web.Request) -> web.Response:
    state = request.app["state"]
    return web.json_response(
        {"minutes": state.load_manager.history_minute_buckets()}
    )


async def request_records(request: web.Request) -> web.Response:
    state = request.app["state"]
    q = request.query
    clauses, params = [], []
    if q.get("model"):
        clauses.append("model=?")
        params.append(q["model"])
    if q.get("endpoint_id"):
        clauses.append("endpoint_id=?")
        params.append(q["endpoint_id"])
    if q.get("status"):
        clauses.append("status_code=?")
        params.append(int(q["status"]))
    where = ("WHERE " + " AND ".join(clauses)) if clauses else ""
    limit = min(int(q.get("limit", 50)), 500)
    offset = int(q.get("offset", 0))
    rows = state.db.query(
        f"""SELECT id, ts, endpoint_id, endpoint_name, model, api_kind, path,
                  status_code, duration_ms, prompt_tokens, completion_tokens,
                  client_ip, stream, error
           FROM request_history {where} ORDER BY ts DESC LIMIT ? OFFSET ?""",
        tuple(params) + (limit, offset),
    )
    return web.json_response({"records": [dict(r) for r in rows]})


async def request_record_detail(request: web.Request) -> web.Response:
    state = request.app["state"]
    row = state.db.query_one(
        "SELECT * FROM request_history WHERE id=?",
        (request.match_info["record_id"],),
    )
    if row is None:
        return web.json_response({"error": "record not found"}, status=404)
    return web.json_response(dict(row))


async def token_stats(request: web.Request) -> web.Response:
    """Total/daily/by-model/by-endpoint token statistics."""
    state = request.app["state"]
    days = min(int(request.query.get("days", 30)), 365)
    since = (
        datetime.date.today() - datetime.timedelta(days=days)
    ).isoformat()
    daily = state.db.query(
        """SELECT date, SUM(prompt_tokens) AS pt, SUM(completion_tokens) AS ct,
                  SUM(request_count) AS requests
           FROM endpoint_daily_stats WHERE date>=? GROUP BY date ORDER BY date""",
        (since,),
    )
    by_model = state.db.query(
        """SELECT model, SUM(prompt_tokens) AS pt,
                  SUM(completion_tokens) AS ct, SUM(request_count) AS requests
           FROM endpoint_daily_stats WHERE date>=? GROUP BY model
           ORDER BY ct DESC""",
        (since,),
    )
    by_endpoint = state.db.query(
        """SELECT endpoint_id, SUM(prompt_tokens) AS pt,
                  SUM(completion_tokens) AS ct, SUM(request_count) AS requests
           FROM endpoint_daily_stats WHERE date>=? GROUP BY endpoint_id""",
        (since,),
    )
    total = state.db.query_one(
        """SELECT COALESCE(SUM(prompt_tokens),0) AS pt,
                  COALESCE(SUM(completion_tokens),0) AS ct,
                  COALESCE(SUM(request_count),0) AS requests
           FROM endpoint_daily_stats WHERE date>=?""",
        (since,),
    )
    return web.json_response({
        "total": dict(total),
        "daily": [dict(r) for r in daily],
        "by_model": [dict(r) for r in by_model],
        "by_endpoint": [dict(r) for r in by_endpoint],
    })


async def endpoint_stats(request: web.Request) -> web.Response:
    state = request.app["state"]
    endpoint_id = request.match_info["endpoint_id"]
    days = min(int(request.query.get("days", 30)), 365)
    since = (
        datetime.date.today() - datetime.timedelta(days=days)
    ).isoformat()
    rows = state.db.query(
        """SELECT date, model, api_kind, request_count, error_count,
                  prompt_tokens, completion_tokens, total_duration_ms
           FROM endpoint_daily_stats
           WHERE endpoint_id=? AND date>=? ORDER BY date""",
        (endpoint_id, since),
    )
    return web.json_response({"stats": [dict(r) for r in rows]})


async def model_tps(request: web.Request) -> web.Response:
    state = request.app["state"]
    return web.json_response({"tps": state.load_manager.tps_snapshot()})


async def client_analytics(request: web.Request) -> web.Response:
    """Client-IP rankings / timeline / per-client detail (dashboard.rs analytics)."""
    state = request.app["state"]
    q = request.query
    try:
        days = min(int(q.get("days", 7)), 90)
    except ValueError:
        return web.json_response(
            {"error": "days must be an integer"}, status=400
        )
    since_ts = (
        datetime.datetime.now() - datetime.timedelta(days=days)
    ).timestamp()
    ranking = state.db.query(
        """SELECT client_ip, COUNT(*) AS requests,
                  SUM(prompt_tokens) AS pt, SUM(completion_tokens) AS ct,
                  SUM(CASE WHEN status_code>=400 THEN 1 ELSE 0 END) AS errors
           FROM request_history WHERE ts>=? AND client_ip IS NOT NULL
           GROUP BY client_ip ORDER BY requests DESC LIMIT 50""",
        (since_ts,),
    )
    # is_alert: last-HOUR request count at/above the configurable threshold
    # (settings key ip_alert_threshold, default 100 — dashboard.rs:1265-1279)
    threshold = effective_ip_alert_threshold(
        state.db.get_setting("ip_alert_threshold")
    )
    hour_ago = time.time() - 3600.0
    last_hour = {
        row["client_ip"]: row["n"]
        for row in state.db.query(
            """SELECT client_ip, COUNT(*) AS n FROM request_history
               WHERE ts>=? AND client_ip IS NOT NULL GROUP BY client_ip""",
            (hour_ago,),
        )
    }
    heatmap = state.db.query(
        """SELECT CAST(strftime('%w', ts, 'unixepoch') AS INTEGER) AS dow,
                  CAST(strftime('%H', ts, 'unixepoch') AS INTEGER) AS hour,
                  COUNT(*) AS requests
           FROM request_history WHERE ts>=?
           GROUP BY dow, hour""",
        (since_ts,),
    )
    by_key = state.db.query(
        """SELECT api_key_id, COUNT(*) AS requests,
                  SUM(completion_tokens) AS ct
           FROM request_history WHERE ts>=? AND api_key_id IS NOT NULL
           GROUP BY api_key_id ORDER BY requests DESC LIMIT 50""",
        (since_ts,),
    )
    ranking_out = []
    for r in ranking:
        row = dict(r)
        row["is_alert"] = last_hour.get(row["client_ip"], 0) >= threshold
        ranking_out.append(row)
    return web.json_response({
        "ranking": ranking_out,
        "heatmap": [dict(r) for r in heatmap],
        "by_api_key": [dict(r) for r in by_key],
        "ip_alert_threshold": threshold,
    })


# ---------------------------------------------------------------- WebSocket


async def dashboard_ws(request: web.Request) -> web.WebSocketResponse:
    """JWT-authenticated (header, query param, or cookie), admin-only."""
    state = request.app["state"]
    token = None
    authz = request.headers.get("Authorization", "")
    if authz.startswith("Bearer "):
        token = authz[7:]
    token = token or request.query.get("token") or request.cookies.get("llmlb_token")
    if not token:
        raise web.HTTPUnauthorized(text="missing token")
    try:
        payload = verify_jwt(state.jwt_secret, token)
    except AuthError as e:
        raise web.HTTPUnauthorized(text=str(e))
    if payload.get("role") != "admin":
        raise web.HTTPForbidden(text="admin role required")

    ws = web.WebSocketResponse(heartbeat=30)
    await ws.prepare(request)
    sub_id, queue = state.events.subscribe()
    try:
        consumer = asyncio.create_task(_consume_client(ws))
        try:
            while not ws.closed:
                try:
                    event = await asyncio.wait_for(queue.get(), timeout=5.0)
                except asyncio.TimeoutError:
                    continue
                await ws.send_str(json.dumps(event, separators=(",", ":")))
        finally:
            consumer.cancel()
    finally:
        state.events.unsubscribe(sub_id)
    return ws


async def _consume_client(ws: web.WebSocketResponse) -> None:
    """Drain client frames so pings/closes are processed."""
    try:
        async for msg in ws:
            if msg.type in (WSMsgType.CLOSE, WSMsgType.ERROR):
                break
    except Exception:  # allow-silent: client ws died; writer side handles it
        pass


async def tail_lb_logs(request: web.Request) -> web.Response:
    """GET /api/dashboard/logs/lb — tail the gateway's own log file
    (parity: api/logs.rs:52; requires logs.read via the API-key perm map)."""
    from llmlb_tpu_torch.gateway.logging_setup import active_log_path, tail_log

    try:
        lines = int(request.query.get("lines", "200"))
    except ValueError:
        return web.json_response({"error": "lines must be an integer"},
                                 status=400)
    path = active_log_path()
    return web.json_response({
        "path": path,
        "available": path is not None,
        "lines": tail_log(lines),
    })
