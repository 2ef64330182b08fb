"""The port's gateway end to end, held against the JAX gateway.

- Scripted session: one client session (login, API key, registration,
  /v1/models, chat streamed and not, completions, responses, embeddings,
  an unknown model, a missing key, a malformed body, then a failing second
  endpoint whose breaker opens while requests fail over) is sent to the JAX
  gateway and to the port's gateway, each in front of its own copy of one
  deterministic stub engine. Status codes, JSON bodies (ids, secrets, URLs
  and times masked) and SSE frame sequences must be equal.
- Full path: the port's gateway in front of the port's engine server gives
  the JAX gateway-in-front-of-JAX-engine's greedy text and usage, on the
  same debug-tiny weights, for chat (streamed and not) and /v1/responses;
  registration detects the port's engine as `tpu` and syncs its model.
- Resume: two port engine servers behind the port's gateway; the
  `engine_abort` fault rule cuts the first stream mid-way and the gateway
  resumes it on the other server: one well-formed stream with the uncut
  text, one resume booked.

One JAX EngineCore (module-scoped), debug-tiny in fp32 on the CPU.
"""

import asyncio
import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.server import create_engine_app
from llmlb_tpu.engine.service import Engine as JaxEngine
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.gateway.health import EndpointHealthChecker as RefChecker
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.gateway import http as gh
from llmlb_tpu_torch.gateway.app import create_app
from llmlb_tpu_torch.gateway.app_state import build_app_state
from llmlb_tpu_torch.gateway.config import ServerConfig
from llmlb_tpu_torch.gateway.db import Database
from llmlb_tpu_torch.gateway.faults import FaultInjector, FaultRule
from llmlb_tpu_torch.gateway.health import EndpointHealthChecker
from llmlb_tpu_torch.gateway.http import web
from tests.support import (
    ADMIN_PASSWORD,
    GatewayHarness,
    assert_sse_protocol,
    parse_sse_frames,
)

STUB_MODEL = "stub-model"
MESSAGES = [{"role": "user", "content": "the quick brown fox"}]
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32, 64),
               kv_page_size=16, eos_id=-1, seed=0)
MAX_TOKENS = 12


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the reference's token estimates by its ~4-characters fallback, as the
    # port's (its tiktoken path would fetch a BPE file over the network:
    # ROADMAP C15); a short breaker threshold and no backoff
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    monkeypatch.setenv("LLMLB_BREAKER_FAILURE_THRESHOLD", "2")
    monkeypatch.setenv("LLMLB_RETRY_BACKOFF_BASE", "0")


# ------------------------------------------------------------- stub engine


class _StubHandler(BaseHTTPRequestHandler):
    """A deterministic tpu:// engine: the same bytes for the same request,
    so two gateways in front of two stubs must forward the same frames."""

    def log_message(self, *a):
        pass

    def _json(self, obj, status=200):
        data = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _sse(self, frames):
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.end_headers()
        for f in frames:
            self.wfile.write(f"data: {f if isinstance(f, str) else json.dumps(f)}"
                             "\n\n".encode())
            self.wfile.flush()
        self.close_connection = True

    def do_GET(self):
        if self.path == "/api/system":
            return self._json({"tpu_engine": True, "model": STUB_MODEL})
        if self.path == "/api/health":
            return self._json({"status": "ok", "gpu": {
                "accelerator": "gpu", "chip_count": 1},
                "engine": {"num_slots": 4, "active_slots": 0, "queued": 0}})
        if self.path == "/v1/models":
            return self._json({"object": "list", "data": [
                {"id": STUB_MODEL, "object": "model"}]})
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        body = json.loads(self.rfile.read(
            int(self.headers.get("Content-Length", 0))) or b"{}")
        if self.server.fail:
            return self._json({"error": "induced"}, 500)
        words = [f"s{i} " for i in range(int(body.get("max_tokens") or 4))]
        usage = {"prompt_tokens": 7, "completion_tokens": len(words),
                 "total_tokens": 7 + len(words)}
        stream = bool(body.get("stream"))
        if self.path == "/v1/chat/completions":
            def chunk(delta, finish=None):
                return {"id": "chatcmpl-stub", "object":
                        "chat.completion.chunk", "created": 1700000000,
                        "model": body.get("model"), "choices": [
                            {"index": 0, "delta": delta,
                             "finish_reason": finish}]}
            if not stream:
                return self._json({
                    "id": "chatcmpl-stub", "object": "chat.completion",
                    "created": 1700000000, "model": body.get("model"),
                    "choices": [{"index": 0, "message": {
                        "role": "assistant", "content": "".join(words)},
                        "finish_reason": "length"}], "usage": usage})
            frames = [chunk({"role": "assistant", "content": ""})]
            for i, w in enumerate(words):
                if body.get("llmlb_replay"):
                    frames.append({"object": "llmlb.replay", "tokens": [i]})
                frames.append(chunk({"content": w}))
            frames += [chunk({}, "length"), {
                "id": "chatcmpl-stub", "object": "chat.completion.chunk",
                "choices": [], "usage": usage}, "[DONE]"]
            return self._sse(frames)
        if self.path == "/v1/completions":
            if not stream:
                return self._json({
                    "id": "cmpl-stub", "object": "text_completion",
                    "created": 1, "model": body.get("model"), "choices": [
                        {"index": 0, "text": "".join(words),
                         "finish_reason": "length"}], "usage": usage})
            return self._sse([{"id": "cmpl-stub", "object":
                               "text_completion", "choices": [
                                   {"index": 0, "text": w}]} for w in words]
                             + [{"choices": [], "usage": usage}, "[DONE]"])
        if self.path == "/v1/responses":
            text = "".join(words)
            if not stream:
                return self._json({
                    "id": "resp-stub", "object": "response", "created_at": 1,
                    "model": body.get("model"), "status": "completed",
                    "output": [{"type": "message", "role": "assistant",
                                "content": [{"type": "output_text",
                                             "text": text}]}],
                    "usage": {"input_tokens": 7,
                              "output_tokens": len(words)}})
            return self._sse(
                [{"type": "response.output_text.delta", "delta": w}
                 for w in words]
                + [{"type": "response.completed", "response": {
                    "usage": {"input_tokens": 7,
                              "output_tokens": len(words)}}}])
        if self.path == "/v1/embeddings":
            return self._json({"object": "list", "model": body.get("model"),
                               "data": [{"object": "embedding", "index": 0,
                                         "embedding": [0.25, -0.5, 1.0]}],
                               "usage": {"prompt_tokens": 3,
                                         "total_tokens": 3}})
        self._json({"error": "not found"}, 404)


def _stub(fail=False):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), _StubHandler)
    srv.fail = fail
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


# ------------------------------------------------------------- gateways


class _PortGateway:
    """The port's gateway in-process on a free port, its health checker
    wired (registration probes and syncs at once) but not looping."""

    @classmethod
    async def create(cls):
        self = cls()
        self.state = await build_app_state(
            ServerConfig.from_env(), db=Database(":memory:"),
            start_background=False)
        st = self.state
        st.health_checker = EndpointHealthChecker(
            st.registry, st.load_manager, st.db, st.http, st.events,
            interval_s=3600, timeout_s=5.0, resilience=st.resilience)
        self.runner = web.AppRunner(create_app(st), shutdown_timeout=1.0)
        await self.runner.setup()
        await web.TCPSite(self.runner, "127.0.0.1", 0).start()
        self.url = "http://127.0.0.1:%d" % self.runner.addresses[0][1]
        return self

    async def close(self):
        await self.runner.cleanup()


async def _jax_gateway():
    gw = await GatewayHarness.create()
    st = gw.state
    st.health_checker = RefChecker(
        st.registry, st.load_manager, st.db, st.http, st.events,
        interval_s=3600, timeout_s=5.0, resilience=st.resilience)
    return gw, str(gw.client.make_url("")).rstrip("/")


_MASKED = {"id", "created", "created_at", "updated_at", "last_checked_at",
           "latency_ms", "uptime_s", "token", "api_key", "base_url",
           "key_prefix", "sampled_at", "last_failure_ts", "opened_at",
           "open_remaining_s", "recorded_at", "last_used_at", "retry_after_s"}


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


async def _session(base: str, stub_a: str, stub_b: str) -> list:
    """The scripted client session; one record per exchange."""
    out = []
    async with gh.ClientSession() as s:
        async def call(method, path, body=None, headers=None, raw=False):
            r = await s.request(method, base + path, json=body,
                                headers=headers or {})
            data = await r.read()
            ctype = r.headers.get("Content-Type", "")
            if "event-stream" in ctype:
                frames = parse_sse_frames(data)
                if "/chat/" in path or "/completions" in path:
                    assert_sse_protocol(data, "openai")
                rec = (method, path, r.status, "sse", frames)
            elif "json" in ctype:
                obj = _mask(json.loads(data))
                if path == "/api/endpoints" and method == "GET":
                    # listed by probe latency: an order that is timing
                    obj["endpoints"].sort(key=lambda e: e["name"])
                rec = (method, path, r.status, "json", obj)
            else:
                rec = (method, path, r.status, ctype.split(";")[0],
                       data.decode())
            out.append(rec)
            return json.loads(data) if "json" in ctype else None

        login = await call("POST", "/api/auth/login", {
            "username": "admin", "password": ADMIN_PASSWORD})
        admin = {"Authorization": f"Bearer {login['token']}"}
        await call("GET", "/api/auth/me", headers=admin)
        key = await call("POST", "/api/api-keys", {
            "name": "t", "permissions": ["openai.inference",
                                         "openai.models.read"]},
            headers=admin)
        inf = {"Authorization": f"Bearer {key['api_key']}"}
        await call("POST", "/api/endpoints", {"base_url": stub_a,
                                              "name": "a"}, headers=admin)
        await call("GET", "/v1/models", headers=inf)
        await call("GET", f"/v1/models/{STUB_MODEL}", headers=inf)
        chat = {"model": STUB_MODEL, "messages": MESSAGES, "max_tokens": 5}
        await call("POST", "/v1/chat/completions", chat, inf)
        await call("POST", "/v1/chat/completions", {**chat, "stream": True},
                   inf)
        comp = {"model": STUB_MODEL, "prompt": "once upon", "max_tokens": 3}
        await call("POST", "/v1/completions", comp, inf)
        await call("POST", "/v1/completions", {**comp, "stream": True}, inf)
        resp = {"model": STUB_MODEL, "input": "hello", "max_tokens": 4}
        await call("POST", "/v1/responses", resp, inf)
        await call("POST", "/v1/responses", {**resp, "stream": True}, inf)
        await call("POST", "/v1/embeddings", {"model": STUB_MODEL,
                                              "input": "embed me"}, inf)
        await call("POST", "/v1/chat/completions",
                   {**chat, "model": "no-such-model"}, inf)
        await call("POST", "/v1/chat/completions", chat)
        await call("POST", "/v1/chat/completions", {"messages": []}, inf)
        await call("GET", "/v1/nowhere", headers=inf)
        # a second endpoint that fails every request: unmeasured, it is
        # tried first, fails over to "a", and its breaker opens
        await call("POST", "/api/endpoints", {"base_url": stub_b,
                                              "name": "b"}, headers=admin)
        for _ in range(4):
            await call("POST", "/v1/chat/completions", chat, inf)
        await call("GET", "/api/health")
        await call("GET", "/api/endpoints", headers=admin)
    return out


async def test_scripted_session_matches_the_jax_gateway():
    stubs = [_stub(), _stub(fail=True), _stub(), _stub(fail=True)]
    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()
    try:
        ref = await _session(jax_url, stubs[0][1], stubs[1][1])
        ours = await _session(port.url, stubs[2][1], stubs[3][1])
        assert len(ours) == len(ref)
        for a, b in zip(ref, ours):
            assert b == a
        health = ours[-2][4]
        assert {e["name"]: e["breaker"]["state"]
                for e in health["endpoints"]} == {"a": "closed", "b": "open"}
        assert ours[3][4]["endpoint_type"] == "tpu"
        statuses = [r[2] for r in ours]
        assert statuses.count(404) == 3 and 401 in statuses and 400 in statuses
    finally:
        await gw.close()
        await port.close()
        for srv, _ in stubs:
            srv.shutdown()
            srv.server_close()


# ------------------------------------------------------------- full path


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


class _PortServer:
    def __init__(self, weights):
        cfg = get_preset("debug-tiny")
        self.engine = Engine.from_preset(
            "debug-tiny", device="cpu",
            params=params_from_numpy(weights[1], cfg, "cpu"), **CORE_KW)
        self.srv, self.thread = start_server(self.engine)
        self.url = "http://%s:%d" % self.srv.server_address[:2]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        self.engine.shutdown()


@pytest.fixture(scope="module")
def port_servers(weights):
    servers = [_PortServer(weights), _PortServer(weights)]
    yield servers
    for s in servers:
        s.close()


def _stream_text(raw: bytes) -> tuple[str, dict | None]:
    text, usage = [], None
    for frame in parse_sse_frames(raw):
        for d in frame["data"]:
            if d == "[DONE]":
                continue
            obj = json.loads(d)
            usage = obj.get("usage") or usage
            for c in obj.get("choices") or []:
                text.append((c.get("delta") or {}).get("content") or "")
    return "".join(text), usage


async def _full_path(base: str, engine_url: str) -> dict:
    async with gh.ClientSession() as s:
        r = await s.post(base + "/api/auth/login", json={
            "username": "admin", "password": ADMIN_PASSWORD})
        admin = {"Authorization": "Bearer " + (await r.json())["token"]}
        r = await s.post(base + "/api/api-keys", json={"name": "t"},
                         headers=admin)
        inf = {"Authorization": "Bearer " + (await r.json())["api_key"]}
        r = await s.post(base + "/api/endpoints", json={
            "base_url": engine_url, "name": "engine"}, headers=admin)
        reg = await r.json()
        assert r.status == 201, reg
        chat = {"model": "debug-tiny", "messages": MESSAGES,
                "max_tokens": MAX_TOKENS, "temperature": 0}
        r = await s.post(base + "/v1/chat/completions", json=chat,
                         headers=inf)
        plain = await r.json()
        r = await s.post(base + "/v1/chat/completions",
                         json={**chat, "stream": True}, headers=inf)
        raw = await r.read()
        assert_sse_protocol(raw, "openai")
        r = await s.post(base + "/v1/responses", json={
            "model": "debug-tiny", "input": "the quick brown fox",
            "max_output_tokens": MAX_TOKENS, "temperature": 0},
            headers=inf)
        resp = await r.json()
        assert r.status == 200, resp
    return {
        "type": reg["endpoint_type"], "models": [
            m["model_id"] for m in reg["models"]],
        "chat": (plain["choices"][0]["message"]["content"], plain["usage"]),
        "stream": _stream_text(raw),
        "responses": (resp["output"][0]["content"][0]["text"],
                      resp["usage"]),
    }


async def test_full_path_matches_the_jax_stack(weights, port_servers):
    cfg = jax_preset("debug-tiny")
    jcore = JaxEngineCore(cfg, weights[0], kv_layout="paged",
                          prefix_cache=False, **CORE_KW)
    jcore.start()
    jengine = JaxEngine("debug-tiny", jcore, JaxByteTokenizer(cfg.vocab_size))
    jserver = TestServer(create_engine_app(jengine, owns_engine=False))
    await jserver.start_server()
    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()
    try:
        ref = await _full_path(jax_url, f"http://127.0.0.1:{jserver.port}")
        ours = await _full_path(port.url, port_servers[0].url)
        assert ours["type"] == "tpu" and ours["models"] == ["debug-tiny"]
        assert ours == ref
        assert ours["chat"][1]["completion_tokens"] == MAX_TOKENS
        assert ours["stream"][0] == ours["chat"][0]
    finally:
        await gw.close()
        await port.close()
        await jserver.close()
        await asyncio.to_thread(jcore.stop)


async def test_cut_stream_resumes_on_the_other_port_engine(port_servers):
    a, b = port_servers
    port = await _PortGateway.create()
    try:
        async with gh.ClientSession() as s:
            chat = {"model": "debug-tiny", "messages": MESSAGES,
                    "max_tokens": MAX_TOKENS, "temperature": 0,
                    "stream": True}
            r = await s.post(a.url + "/v1/chat/completions",
                             json={**chat, "llmlb_replay": True})
            armed = await r.read()
            r = await s.post(a.url + "/v1/chat/completions", json=chat)
            uncut = _stream_text(await r.read())
            r = await s.post(port.url + "/api/auth/login", json={
                "username": "admin", "password": ADMIN_PASSWORD})
            admin = {"Authorization": "Bearer " + (await r.json())["token"]}
            for i, srv in enumerate((a, b)):
                r = await s.post(port.url + "/api/endpoints", json={
                    "base_url": srv.url, "name": f"port{i}"}, headers=admin)
                assert (await r.json())["endpoint_type"] == "tpu"
            r = await s.post(port.url + "/api/api-keys", json={"name": "t"},
                             headers=admin)
            inf = {"Authorization": "Bearer " + (await r.json())["api_key"]}
            port.state.faults = FaultInjector()
            port.state.faults.add_rule(FaultRule(
                kind="engine_abort", endpoint="*", path="chat",
                after_bytes=len(armed) // 2, max_fires=1))
            r = await s.post(port.url + "/v1/chat/completions", json=chat,
                             headers=inf)
            assert r.status == 200
            raw = await r.read()
        assert b"event: error" not in raw
        assert_sse_protocol(raw, "openai")
        assert _stream_text(raw) == uncut
        summary = port.state.metrics.summary()
        assert summary["stream_resumes"] == {"success": 1}
        assert 0 < summary["stream_resumed_tokens_total"] < MAX_TOKENS
    finally:
        await port.close()
