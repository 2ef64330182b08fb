"""The port's dashboard, event bus, benchmarks and log sink, held against
the JAX gateway.

- Scripted session: one admin session is sent to the JAX gateway and to
  the port's gateway, each in front of its own copies of two deterministic
  stub engines. It opens /ws/dashboard first, then registers an endpoint,
  sends chats streamed and not, runs a TPS benchmark (its 400s, 202, the
  completed record, 404 and the list), registers a second endpoint whose
  breaker a fault rule trips, reads every /api/dashboard/* route with its
  filters, limits and errors (the record 404, `days` 400, `lines` 400, the
  IP alert threshold), the log tail, the API-key permission matrix of the
  new routes, /dashboard with its assets, the SPA fallback and the
  traversal case, and the socket's 401s and 403 and its admin logins by
  header, query and cookie; then deletes the second endpoint. Statuses,
  masked bodies and the socket's sequence of events must be equal
  (`TelemetryUpdated` by its keys).
- The event bus, the log sink and the static bundle held against the
  reference's: drop-oldest with a publish from another thread, handlers
  that do not stack, the same tail of one file, the same bytes.
- C17, shared with the reference: a benchmark whose upstream answers a
  body that is not JSON stays `running` and holds its lease.

The full path, a TPS run through the port's gateway to the port's engine,
is in tests/test_torch_gateway_api_full.py.
"""

import asyncio
import json
import logging
import os
import re
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import aiohttp
import pytest
import yarl

from llmlb_tpu.gateway import api_benchmarks as ref_bench
from llmlb_tpu.gateway import events as ref_events
from llmlb_tpu.gateway import logging_setup as ref_logging
from llmlb_tpu.gateway.faults import FaultInjector as RefFaultInjector
from llmlb_tpu.gateway.faults import FaultRule as RefFaultRule
from llmlb_tpu_torch.gateway import api_benchmarks, events, logging_setup
from llmlb_tpu_torch.gateway.faults import FaultInjector, FaultRule
from tests.gateway.test_dashboard_spa import _strip_js
from tests.support import ADMIN_PASSWORD
from tests.test_torch_gateway_e2e import (
    _MASKED as E2E_MASKED,
    STUB_MODEL,
    _jax_gateway,
    _PortGateway,
    _stub,
)

REPO = Path(__file__).resolve().parent.parent
STATIC = "gateway/dashboard_static"
ASSETS = ("index.html", "app.js", "views.js", "charts.js", "style.css")
MESSAGES = [{"role": "user", "content": "the quick brown fox"}]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the reference's token estimates by its ~4-characters fallback, as the
    # port's (ROADMAP C15); a short breaker threshold and no backoff
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    monkeypatch.setenv("LLMLB_BREAKER_FAILURE_THRESHOLD", "2")
    monkeypatch.setenv("LLMLB_RETRY_BACKOFF_BASE", "0")
    # Nothing the session compares may depend on the host's speed: a
    # request on a loaded host must not miss an SLO target in one gateway
    # and meet it in the other (the overview's slo_met_total and
    # goodput_ratio), and a tripped breaker must not reach its half-open
    # time in one session only.
    monkeypatch.setenv("LLMLB_SLO_TTFT_MS", "3600000")
    monkeypatch.setenv("LLMLB_SLO_ITL_MS", "3600000")
    monkeypatch.setenv("LLMLB_BREAKER_OPEN_SECS", "3600")
    monkeypatch.setattr(ref_bench.STORE, "runs", {})
    monkeypatch.setattr(api_benchmarks.STORE, "runs", {})


@pytest.fixture
def root_logging():
    """init_logging installs handlers on the root logger: put it back."""
    root = logging.getLogger()
    handlers, level = list(root.handlers), root.level
    yield
    for h in list(root.handlers):
        if h not in handlers:
            root.removeHandler(h)
            h.close()
    root.setLevel(level)
    ref_logging._active_log_path = None
    logging_setup._active_log_path = None


# ------------------------------------------------------------- masking

_MASKED = E2E_MASKED | {
    "ts", "duration_ms", "started_at", "completed_at", "duration_s",
    "run_id", "trace_id", "throughput_rps", "mean_tps", "p50_latency_ms",
    "p50", "p90", "p99", "mean", "ema_tps", "last_update", "tps",
    "total_duration_ms", "api_key_id", "user_id", "expires_at",
}


def _norm(obj, ids: dict):
    """Endpoint ids replaced by their names (in keys too), then every
    timing, id and secret leaf masked."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            k = _sub(k, ids)
            out[k] = ("*" if k in _MASKED and not isinstance(v, (dict, list))
                      else _norm(v, ids))
        return out
    if isinstance(obj, list):
        return [_norm(v, ids) for v in obj]
    return _sub(obj, ids) if isinstance(obj, str) else obj


def _sub(s: str, ids: dict) -> str:
    for eid, name in ids.items():
        s = s.replace(eid, f"<{name}>")
    return s


def _event(ev: dict, ids: dict) -> tuple:
    data = ev["data"]
    if ev["type"] == "TelemetryUpdated":
        return (ev["type"], _sub(data["endpoint_id"], ids), sorted(data),
                sorted(data["tpu"]))
    return ev["type"], _norm(data, ids)


# ------------------------------------------------------------- session


async def _session(base: str, stub_a: str, stub_flaky: str,
                   add_fault, runs: dict) -> tuple[list, list]:
    out: list = []
    ids: dict = {}
    async with aiohttp.ClientSession() as s:
        async def call(method, path, body=None, headers=None, data=None,
                       raw_path=False):
            url = yarl.URL(base + path, encoded=True) if raw_path \
                else base + path
            async with s.request(method, url, json=body, data=data,
                                 headers=headers or {}) as r:
                raw = await r.read()
                ctype = r.headers.get("Content-Type", "").split(";")[0]
            if ctype == "application/json":
                obj = json.loads(raw)
                shown = obj
                if path.startswith("/api/dashboard/request-history"):
                    shown = {"requests": sum(m["requests"]
                                             for m in obj["minutes"]),
                             "errors": sum(m["errors"]
                                           for m in obj["minutes"]),
                             "keys": sorted(obj["minutes"][0])}
                elif path.startswith("/api/dashboard/logs/lb") and \
                        r.status == 200:
                    shown = {**obj, "path": os.path.basename(obj["path"]),
                             "lines": [ln.split(" ", 2)[2]
                                       for ln in obj["lines"]]}
                out.append((method, _sub(path, ids), r.status, ctype,
                            _norm(shown, ids)))
                return obj
            out.append((method, _sub(path, ids), r.status, ctype, raw))
            return raw

        login = await call("POST", "/api/auth/login", {
            "username": "admin", "password": ADMIN_PASSWORD})
        admin = {"Authorization": f"Bearer {login['token']}"}
        keys = {}
        for name, perm in (("inference", "openai.inference"),
                           ("metrics", "metrics.read"),
                           ("logs", "logs.read"),
                           ("reader", "endpoints.read")):
            k = await call("POST", "/api/api-keys", {
                "name": name, "permissions": [perm]}, headers=admin)
            keys[name] = {"Authorization": f"Bearer {k['api_key']}"}
        await call("POST", "/api/users", {"username": "viewer1",
                                          "password": "viewer-pass-1",
                                          "role": "viewer"}, headers=admin)
        viewer = await call("POST", "/api/auth/login", {
            "username": "viewer1", "password": "viewer-pass-1"})
        feed = await s.ws_connect(base + "/ws/dashboard", headers=admin)

        # the socket's own auth: 401 (none, bad, an API key), 403 (viewer)
        await call("GET", "/ws/dashboard")
        await call("GET", "/ws/dashboard?token=not-a-jwt")
        await call("GET", "/ws/dashboard", headers=keys["metrics"])
        await call("GET", "/ws/dashboard", headers={
            "Authorization": f"Bearer {viewer['token']}"})
        for how in ("query", "cookie"):
            if how == "query":
                ws = await s.ws_connect(
                    base + f"/ws/dashboard?token={login['token']}")
            else:
                ws = await s.ws_connect(base + "/ws/dashboard", headers={
                    "Cookie": f"llmlb_token={login['token']}"})
            await ws.close()
            out.append(("ws", how, ws.close_code))

        ep = await call("POST", "/api/endpoints", {"base_url": stub_a,
                                                   "name": "a"},
                        headers=admin)
        ids[ep["id"]] = "a"
        chat = {"model": STUB_MODEL, "messages": MESSAGES, "max_tokens": 5}
        await call("POST", "/v1/chat/completions", chat, keys["inference"])
        await call("POST", "/v1/chat/completions", {**chat, "stream": True},
                   keys["inference"])
        await call("POST", "/v1/chat/completions",
                   {**chat, "model": "no-such-model"}, keys["inference"])

        # the benchmark: 400s, 202, completed, 404, the list
        await call("POST", "/api/benchmarks/tps", data=b"{not json",
                   headers={**admin, "Content-Type": "application/json"})
        await call("POST", "/api/benchmarks/tps", {}, headers=admin)
        run = await call("POST", "/api/benchmarks/tps", {
            "model": STUB_MODEL, "requests": 4, "concurrency": 2,
            "max_tokens": 3}, headers=admin)
        ids[run["run_id"]] = "run"
        # wait on the run itself, in the gateway's run store (`runs`): an
        # HTTP poll would add a timing-dependent count of requests to the
        # overview's requests_total
        deadline = asyncio.get_running_loop().time() + 120
        while runs[run["run_id"]]["status"] != "completed":
            assert asyncio.get_running_loop().time() < deadline, \
                "the TPS run never completed"
            await asyncio.sleep(0.025)
        await call("GET", f"/api/benchmarks/tps/{run['run_id']}",
                   headers=admin)
        await call("GET", "/api/benchmarks/tps/no-such-run", headers=admin)
        await call("GET", "/api/benchmarks/tps", headers=admin)

        # a second endpoint, its breaker tripped by a fault rule
        ep2 = await call("POST", "/api/endpoints", {"base_url": stub_flaky,
                                                    "name": "flaky"},
                         headers=admin)
        ids[ep2["id"]] = "flaky"
        add_fault("flaky")
        for _ in range(3):
            await call("POST", "/v1/chat/completions", chat,
                       keys["inference"])

        # every dashboard route
        d = "/api/dashboard"
        await call("GET", d + "/overview", headers=admin)
        await call("GET", d + "/request-history", headers=admin)
        recs = await call("GET", d + "/requests", headers=admin)
        ids[recs["records"][0]["id"]] = "record"
        for q in ("?limit=2&offset=1", f"?model={STUB_MODEL}", "?status=404",
                  f"?endpoint_id={ep['id']}", "?limit=100000"):
            await call("GET", d + "/requests" + q, headers=admin)
        await call("GET", d + f"/requests/{recs['records'][0]['id']}",
                   headers=admin)
        await call("GET", d + "/requests/no-such-record", headers=admin)
        for q in ("", "?days=1", "?days=100000", "?days=abc"):
            await call("GET", d + "/token-stats" + q, headers=admin)
        for q in ("", "?days=2"):
            await call("GET", d + f"/endpoints/{ep['id']}/stats" + q,
                       headers=admin)
        await call("GET", d + "/model-tps", headers=admin)
        await call("GET", d + "/clients", headers=admin)
        await call("GET", d + "/clients?days=abc", headers=admin)
        await call("PUT", d + "/settings", {"key": "ip_alert_threshold",
                                            "value": "2"}, headers=admin)
        await call("PUT", d + "/settings", {"key": "ip_alert_threshold",
                                            "value": "0"}, headers=admin)
        await call("GET", d + "/clients?days=3", headers=admin)
        await call("GET", d + "/logs/lb?lines=abc", headers=admin)
        for i in range(3):
            logging.getLogger("dashboard.test").warning("marker %d", i)
        await call("GET", d + "/logs/lb?lines=3", headers=admin)

        # the API-key permission matrix of the new routes
        for name, hdr in keys.items():
            for method, path, body in (
                    ("GET", d + "/overview", None),
                    ("GET", d + "/clients", None),
                    ("GET", d + "/logs/lb?lines=1", None),
                    ("GET", "/api/benchmarks/tps", None),
                    ("POST", "/api/benchmarks/tps", {})):
                async with s.request(method, base + path, json=body,
                                     headers=hdr) as r:
                    out.append((name, method, path, r.status))

        # the SPA: no auth needed; the fallback and the traversal case
        for path in ("/dashboard", "/dashboard/",
                     *(f"/dashboard/{a}" for a in ASSETS),
                     "/dashboard/some/client/route"):
            await call("GET", path)
        await call("GET", "/dashboard/..%2F..%2Fapp_state.py", raw_path=True)

        await call("DELETE", f"/api/endpoints/{ep2['id']}", headers=admin)
        feed_events = []
        while not feed_events or feed_events[-1]["type"] != "EndpointRemoved":
            msg = await asyncio.wait_for(feed.receive(), 10)
            assert msg.type == aiohttp.WSMsgType.TEXT, msg
            feed_events.append(json.loads(msg.data))
        await feed.close()
    return out, [_event(ev, ids) for ev in feed_events]


async def test_scripted_dashboard_session_matches_the_jax_gateway(
        tmp_path, root_logging):
    stubs = [_stub(), _stub(), _stub(), _stub()]
    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()

    def fault(state, injector, rule):
        def add(name):
            state.faults = injector()
            state.faults.add_rule(rule(kind="connect_refused", endpoint=name,
                                       path="/v1/chat", max_fires=2))
        return add

    try:
        ref_logging.init_logging(str(tmp_path / "ref"))
        ref = await _session(jax_url, stubs[0][1], stubs[1][1],
                             fault(gw.state, RefFaultInjector, RefFaultRule),
                             ref_bench.STORE.runs)
        logging_setup.init_logging(str(tmp_path / "port"))
        ours = await _session(port.url, stubs[2][1], stubs[3][1],
                              fault(port.state, FaultInjector, FaultRule),
                              api_benchmarks.STORE.runs)
        assert len(ours[0]) == len(ref[0])
        for a, b in zip(ref[0], ours[0]):
            assert b == a
        assert ours[1] == ref[1]
        # what the records say, beyond being the reference's
        rec = {(r[0], r[1]): r for r in ours[0] if len(r) == 5}
        bench = [r for r in ours[0]
                 if r[1].startswith("/api/benchmarks/tps/") and r[2] == 200]
        assert bench[0][4]["status"] == "completed"
        assert (bench[0][4]["succeeded"], bench[0][4]["failed"]) == (4, 0)
        assert bench[0][4]["per_endpoint"]["<a>"]["requests"] == 4
        overview = rec[("GET", "/api/dashboard/overview")][4]
        assert overview["endpoints"] == {"total": 2, "online": 2}
        assert rec[("GET", "/dashboard/app.js")][4] == \
            (REPO / "llmlb_tpu_torch" / STATIC / "app.js").read_bytes()
        tail = rec[("GET", "/api/dashboard/logs/lb?lines=3")][4]
        assert (tail["available"], tail["path"], tail["lines"]) == (
            True, "llmlb.log", [f"WARNING w0 dashboard.test: marker {i}"
                                for i in range(3)])
        kinds = [e[0] for e in ours[1]]
        assert kinds.count("EndpointRegistered") == 2
        # one TelemetryUpdated for each probe that happened (registration
        # probes each endpoint once; the checker does not loop here)
        probes = port.state.db.query_one(
            "SELECT COUNT(*) AS n FROM endpoint_health_checks")["n"]
        assert probes == 2
        assert kinds.count("TelemetryUpdated") == probes
        assert ("BreakerStateChanged", {
            "endpoint_id": "<flaky>", "name": "flaky", "from": "closed",
            "to": "open", "reason": "failure threshold: connect_error"}) \
            in ours[1]
        assert "MetricsUpdated" in kinds and "TpsUpdated" in kinds
        traces = [e[1] for e in ours[1] if e[0] == "TraceCompleted"]
        assert len(traces) == 6 and {t["path"] for t in traces} == {
            "/v1/chat/completions"}
        assert ours[1][-1] == ("EndpointRemoved",
                               {"endpoint_id": "<flaky>"})
    finally:
        await gw.close()
        await port.close()
        for srv, _ in stubs:
            srv.shutdown()
            srv.server_close()


# ------------------------------------------------------- units


@pytest.mark.parametrize("mod", [ref_events, events], ids=["ref", "port"])
def test_event_bus_drops_oldest_from_another_thread(mod):
    async def run():
        bus = mod.DashboardEventBus(queue_size=4)
        sub, q = bus.subscribe()
        other, q2 = bus.subscribe()
        t = threading.Thread(target=lambda: [
            bus.publish("MetricsUpdated", {"seq": i}) for i in range(10)])
        t.start()
        t.join()
        for _ in range(20):
            await asyncio.sleep(0)
        kept = [q.get_nowait()["data"]["seq"] for _ in range(q.qsize())]
        dropped = (bus.dropped_events(sub), bus.dropped_events(other),
                   bus.dropped_events_total())
        bus.unsubscribe(other)
        bus.publish("TpsUpdated")
        await asyncio.sleep(0)
        last = q.get_nowait()
        return kept, dropped, bus.dropped_events(other), \
            (last["type"], last["data"]), bus.serialize({"a": [1, 2]})

    got = asyncio.run(run())
    assert got == ([6, 7, 8, 9], (6, 6, 12), 0, ("TpsUpdated", {}),
                   '{"a":[1,2]}')
    assert mod.DashboardEventBus.EVENTS == ref_events.DashboardEventBus.EVENTS


def test_logging_setup_matches_the_reference(tmp_path, root_logging,
                                              monkeypatch):
    monkeypatch.delenv("LLMLB_LOG_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert logging_setup.default_log_dir() == ref_logging.default_log_dir()
    monkeypatch.setenv("LLMLB_LOG_DIR", str(tmp_path / "env"))
    assert logging_setup.default_log_dir() == str(tmp_path / "env")
    assert logging_setup.DEFAULT_LOG_FORMAT == ref_logging.DEFAULT_LOG_FORMAT
    root = logging.getLogger()
    for mod in (ref_logging, logging_setup):
        path = mod.init_logging(str(tmp_path / mod.__name__))
        assert mod.init_logging(str(tmp_path / mod.__name__)) == path
        sinks = [h for h in root.handlers if getattr(h, "_llmlb_sink", 0)]
        assert len(sinks) == 2 and mod.active_log_path() == path
        assert os.path.basename(path) == "llmlb.log"
    assert logging_setup.init_logging(file_sink=False) is None
    assert logging_setup.tail_log(5) == []
    # a file beyond the 256 KiB window, and one within it
    big = tmp_path / "big.log"
    big.write_text("".join(f"line {i} " + "x" * (i % 97) + "\n"
                           for i in range(6000)))
    small = tmp_path / "small.log"
    small.write_text("a\nb\nc")
    for f in (big, small):
        for n in (0, -3, 1, 200, 4999, 5000, 9000):
            assert logging_setup.tail_log(n, str(f)) == \
                ref_logging.tail_log(n, str(f)), (f, n)
    assert logging_setup.tail_log(3, str(small)) == ["a", "b", "c"]
    assert logging_setup.tail_log(5, str(tmp_path / "absent")) == []


def test_static_bundle_is_complete_balanced_and_the_references():
    """The port's copy of tests/gateway/test_dashboard_spa.py's bundle
    check, on the port's files, which are the reference's bytes."""
    port_dir = REPO / "llmlb_tpu_torch" / STATIC
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(ASSETS)
    for name in ASSETS:
        assert (port_dir / name).read_bytes() == \
            (REPO / "llmlb_tpu" / STATIC / name).read_bytes(), name
    index = (port_dir / "index.html").read_text()
    refs = re.findall(r'(?:src|href)="/dashboard/([\w.\-]+)"', index)
    assert "style.css" in refs and "app.js" in refs
    for name in refs:
        assert (port_dir / name).is_file(), name
    pairs = {"(": ")", "[": "]", "{": "}"}
    for js in ("app.js", "views.js", "charts.js"):
        opens: list[str] = []
        for ch in _strip_js((port_dir / js).read_text()):
            if ch in pairs:
                opens.append(ch)
            elif ch in pairs.values():
                assert opens and pairs[opens[-1]] == ch, f"{js}: {ch!r}"
                opens.pop()
        assert not opens, f"{js}: unclosed {opens}"
    app_src = (port_dir / "app.js").read_text()
    views_src = (port_dir / "views.js").read_text()
    routes = re.findall(r"^\s+(\w+): views\.(\w+),", app_src, flags=re.M)
    assert routes
    for _, fn in routes:
        assert re.search(rf"export (?:async )?function {fn}\b", views_src), fn


# ------------------------------------------------------- C17


class _TextErrorHandler(BaseHTTPRequestHandler):
    """An engine that probes healthy and answers every POST with a
    plain-text 500."""

    def log_message(self, *a):
        pass

    def _send(self, status, ctype, data):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/api/system":
            body = {"tpu_engine": True, "model": STUB_MODEL}
        elif self.path == "/api/health":
            body = {"status": "ok", "gpu": {"accelerator": "gpu",
                                            "chip_count": 1}}
        else:
            body = {"object": "list", "data": [{"id": STUB_MODEL}]}
        self._send(200, "application/json", json.dumps(body).encode())

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length", 0)))
        self._send(500, "text/plain", b"Internal Server Error")


async def _non_json_run(base: str, state, url: str) -> tuple:
    async with aiohttp.ClientSession() as s:
        async with s.post(base + "/api/auth/login", json={
                "username": "admin", "password": ADMIN_PASSWORD}) as r:
            admin = {"Authorization": "Bearer " + (await r.json())["token"]}
        async with s.post(base + "/api/endpoints", json={
                "base_url": url, "name": "text500"}, headers=admin) as r:
            ep = await r.json()
        async with s.post(base + "/api/benchmarks/tps", json={
                "model": STUB_MODEL, "requests": 1, "concurrency": 1,
                "max_tokens": 3}, headers=admin) as r:
            run_id = (await r.json())["run_id"]
        await asyncio.sleep(0.5)
        async with s.get(base + f"/api/benchmarks/tps/{run_id}",
                         headers=admin) as r:
            run = await r.json()
    return (run["status"], sorted(run),
            state.load_manager.active_count(ep["id"]))


async def test_benchmark_on_a_non_json_upstream_stays_running_as_the_reference(
        ):
    """ROADMAP C17: `_run_single` reads the upstream's body as JSON and
    catches only connection errors and timeouts, so a plain-text 500
    raises JSONDecodeError out of the run's gather: the run stays
    `running` and the lease it took is never released. The port keeps the
    reference's behaviour."""
    servers = [ThreadingHTTPServer(("127.0.0.1", 0), _TextErrorHandler)
               for _ in range(2)]
    for srv in servers:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    urls = ["http://127.0.0.1:%d" % srv.server_address[1] for srv in servers]
    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()
    try:
        ref = await _non_json_run(jax_url, gw.state, urls[0])
        ours = await _non_json_run(port.url, port.state, urls[1])
        assert ours == ref == ("running", [
            "model", "run_id", "started_at", "status"], 1)
    finally:
        await gw.close()
        await port.close()
        for srv in servers:
            srv.shutdown()
            srv.server_close()
