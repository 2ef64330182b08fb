"""The port's gateway client API end to end, held against the JAX gateway.

- Scripted session: one client session is sent to the JAX gateway and to
  the port's gateway, each in front of its own copies of two deterministic
  stub engines and a stub multimodal engine, and both in front of one
  stub cloud (OpenAI, Anthropic and Gemini dialects) and one stub
  Hugging Face API. It covers /v1/messages (plain, streamed, tool_use,
  errors, a mid-stream cut that resumes, and one that gives up), the five
  media routes with their capability 404s and 400s, `openai:`,
  `anthropic:` and `google:` models and /api/metrics/cloud, the model
  registry, its manifest and the catalog search, a per-endpoint download
  and its progress, model info and delete, the playground proxy, users,
  an invitation and the registration with it, change-password, endpoint
  update and delete, health history, system info, settings, the audit log
  and its verify, and the API-key permission matrix of the new routes.
  Statuses, masked JSON bodies and SSE frame sequences must be equal.

The full path, through real engines, is in
tests/test_torch_gateway_api_full.py.
"""

import asyncio
import base64
import email.parser
import email.policy
import hashlib
import json
import re
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from llmlb_tpu.gateway import api_anthropic as ref_anth
from llmlb_tpu.gateway import api_cloud as ref_cloud
from llmlb_tpu.gateway.faults import FaultInjector as RefFaultInjector
from llmlb_tpu.gateway.faults import FaultRule as RefFaultRule
from llmlb_tpu_torch.engine.tts import encode_wav
from llmlb_tpu_torch.gateway import api_anthropic, api_cloud
from llmlb_tpu_torch.gateway import http as gh
from llmlb_tpu_torch.gateway.faults import FaultInjector, FaultRule
from tests.support import ADMIN_PASSWORD, parse_sse_frames
from tests.test_torch_gateway_e2e import _jax_gateway, _PortGateway

STUB_MODEL = "stub-model"
MESSAGES = [{"role": "user", "content": "the quick brown fox"}]
MAX_TOKENS = 12
# about half the bytes of an armed MAX_TOKENS stream from the stub engine
HALF_STREAM = 1700
CLOUD_KEYS = {"OPENAI_API_KEY": "sk-openai-test",
              "ANTHROPIC_API_KEY": "sk-ant-test",
              "GEMINI_API_KEY": "gm-test"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the reference's token estimates by its ~4-characters fallback, as the
    # port's (its tiktoken path would fetch a BPE file over the network:
    # ROADMAP C15); a short breaker threshold and no backoff
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    monkeypatch.setenv("LLMLB_BREAKER_FAILURE_THRESHOLD", "2")
    monkeypatch.setenv("LLMLB_RETRY_BACKOFF_BASE", "0")
    for k, v in CLOUD_KEYS.items():
        monkeypatch.setenv(k, v)


# -------------------------------------------------------------- stubs


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def _send(self, data: bytes, ctype: str, status: int = 200):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _json(self, obj, status=200):
        self._send(json.dumps(obj).encode(), "application/json", status)

    def _sse(self, frames, pace: float = 0.0):
        """`data:` frames (dicts, strings) or (event, dict) pairs, `pace`
        seconds apart (so that each arrives as a chunk of its own, and a
        fault rule's byte budget ends on the same frame every run)."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Connection", "close")
        self.end_headers()
        for f in frames:
            if isinstance(f, tuple):
                raw = f"event: {f[0]}\ndata: {json.dumps(f[1])}\n\n"
            else:
                raw = (f"data: {f if isinstance(f, str) else json.dumps(f)}"
                       "\n\n")
            try:
                self.wfile.write(raw.encode())
                self.wfile.flush()
            except OSError:  # the gateway walked away (a fault rule's cut)
                break
            if pace:
                time.sleep(pace)
        self.close_connection = True

    def _body(self) -> bytes:
        return self.rfile.read(int(self.headers.get("Content-Length", 0)))

    def _form(self, raw: bytes) -> list:
        """Every part of a multipart body (parsed by the standard library)
        as [name, filename, content type, sha256 of the bytes]."""
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            b"Content-Type: " + self.headers["Content-Type"].encode()
            + b"\r\n\r\n" + raw)
        out = []
        for part in msg.iter_parts():
            data = part.get_payload(decode=True) or b""
            out.append([part.get_param("name", header="content-disposition"),
                        part.get_filename(), part.get_content_type(),
                        hashlib.sha256(data).hexdigest()[:16]])
        return out


class _EngineHandler(_Handler):
    """A deterministic tpu:// engine serving STUB_MODEL: the same bytes for
    the same request. Tools in the request make it answer with two tool
    calls, streamed interleaved by index; a message containing "fail-me"
    gets a 400; /v1/resume re-emits the whole stream."""

    def do_GET(self):
        if self.path == "/api/system":
            return self._json({"tpu_engine": True, "model": STUB_MODEL})
        if self.path == "/api/health":
            return self._json({"status": "ok", "tpu": {
                "device_kind": "stub", "chip_count": 1},
                "engine": {"num_slots": 4, "active_slots": 0, "queued": 0}})
        if self.path == "/v1/models":
            return self._json({"object": "list", "data": [
                {"id": m, "object": "model"} for m in self.server.models]})
        self._json({"error": "not found"}, 404)

    def do_DELETE(self):
        if self.path.startswith("/api/models/"):
            name = urllib.parse.unquote(self.path[len("/api/models/"):])
            if name in self.server.models:
                self.server.models.remove(name)
                return self._json({"deleted": name})
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        body = json.loads(self._body() or b"{}")
        if self.path == "/api/models/download":
            self.server.models.append(body["model"])
            return self._json({"status": "success"})
        if self.path == "/v1/kv/export":
            return self._json({"error": "no export"}, 404)
        if self.path not in ("/v1/chat/completions", "/v1/resume"):
            return self._json({"error": "not found"}, 404)
        if "fail-me" in json.dumps(body.get("messages")):
            return self._json({"error": {"message": "induced"}}, 400)
        words = [f"s{i} " for i in range(int(body.get("max_tokens") or 4))]
        tools = [t["function"]["name"] for t in body.get("tools") or []][:2]
        usage = {"prompt_tokens": 7, "completion_tokens": len(words),
                 "total_tokens": 7 + len(words)}
        finish = "tool_calls" if tools else "length"
        calls = [{"id": f"call_{i}", "type": "function", "function": {
            "name": name, "arguments": json.dumps({"n": i, "w": words[0]})}}
            for i, name in enumerate(tools)]

        def chunk(delta, fin=None):
            return {"id": "chatcmpl-stub", "object": "chat.completion.chunk",
                    "created": 1700000000, "model": body.get("model"),
                    "choices": [{"index": 0, "delta": delta,
                                 "finish_reason": fin}]}

        if not body.get("stream"):
            message = {"role": "assistant",
                       "content": None if tools else "".join(words)}
            if tools:
                message["tool_calls"] = calls
            return self._json({
                "id": "chatcmpl-stub", "object": "chat.completion",
                "created": 1700000000, "model": body.get("model"),
                "choices": [{"index": 0, "message": message,
                             "finish_reason": finish}], "usage": usage})
        frames = [chunk({"role": "assistant", "content": ""})]
        for i, w in enumerate(words):
            if body.get("llmlb_replay"):
                frames.append({"object": "llmlb.replay", "tokens": [i]})
            if tools:
                if i < 2 * len(tools):  # openings, then interleaved args
                    j = i % len(tools)
                    args = calls[j]["function"]["arguments"]
                    half = len(args) // 2
                    tc = {"index": j, "function": {
                        "arguments": args[:half] if i < len(tools)
                        else args[half:]}}
                    if i < len(tools):
                        tc.update(id=calls[j]["id"], type="function")
                        tc["function"]["name"] = calls[j]["function"]["name"]
                    frames.append(chunk({"tool_calls": [tc]}))
                continue
            frames.append(chunk({"content": w}))
        frames += [chunk({}, finish), {
            "id": "chatcmpl-stub", "object": "chat.completion.chunk",
            "choices": [], "usage": usage}, "[DONE]"]
        return self._sse(frames, pace=0.01 if body.get("llmlb_replay")
                         else 0.0)


class _MediaHandler(_Handler):
    """A tpu:// engine with one model per media capability."""

    MODELS = {"whisper-stub": "audio_transcription",
              "tts-stub": "audio_speech", "image-stub": "image_generation"}

    def do_GET(self):
        if self.path == "/api/system":
            return self._json({"tpu_engine": True, "model": "whisper-stub"})
        if self.path == "/api/health":
            return self._json({"status": "ok"})
        if self.path == "/v1/models":
            return self._json({"object": "list", "data": [
                {"id": m, "object": "model", "capabilities": [c]}
                for m, c in self.MODELS.items()]})
        self._json({"error": "not found"}, 404)

    def do_POST(self):
        raw = self._body()
        if self.path == "/v1/audio/speech":
            body = json.loads(raw)
            return self._send(b"RIFF" + hashlib.sha256(
                json.dumps(body, sort_keys=True).encode()).digest(),
                "audio/wav")
        if self.path == "/v1/images/generations":
            body = json.loads(raw)
            return self._json({"created": 1, "model": body.get("model"),
                               "data": [{"b64_json": base64.b64encode(
                                   f"png{i}:{body['prompt']}".encode()
                               ).decode()} for i in range(body.get("n", 1))]})
        if self.path in ("/v1/audio/transcriptions", "/v1/images/edits",
                         "/v1/images/variations"):
            return self._json({"path": self.path, "form": self._form(raw)})
        self._json({"error": "not found"}, 404)


class _CloudHandler(_Handler):
    """OpenAI, Anthropic and Gemini on one port, each checking its key."""

    def do_POST(self):
        body = json.loads(self._body() or b"{}")
        if self.path == "/v1/chat/completions":
            if self.headers.get("Authorization") != "Bearer sk-openai-test":
                return self._json({"error": "bad key"}, 401)
            text = f"openai says {len(body['messages'])}"
            if body.get("stream"):
                return self._sse([{"id": "c1", "object":
                                   "chat.completion.chunk", "choices": [
                                       {"index": 0, "delta": {"content": w}}]}
                                  for w in text.split()] + ["[DONE]"])
            return self._json({"id": "c1", "object": "chat.completion",
                               "model": body["model"], "choices": [
                                   {"index": 0, "message": {
                                       "role": "assistant", "content": text},
                                    "finish_reason": "stop"}]})
        if self.path == "/v1/messages":
            if self.headers.get("x-api-key") != "sk-ant-test" or \
                    not self.headers.get("anthropic-version"):
                return self._json({"error": "bad key"}, 401)
            if body.get("stream"):
                return self._sse([
                    ("message_start", {"type": "message_start", "message": {
                        "id": "msg_cloud", "model": body["model"]}}),
                    ("content_block_delta", {
                        "type": "content_block_delta", "index": 0,
                        "delta": {"type": "text_delta", "text": "claude"}}),
                    ("message_stop", {"type": "message_stop"})])
            return self._json({
                "id": "msg_cloud", "type": "message", "model": body["model"],
                "content": [{"type": "text", "text": "claude says "
                             + body["messages"][-1]["content"]}],
                "stop_reason": "max_tokens",
                "usage": {"input_tokens": 4, "output_tokens": 2},
                "echo": {k: v for k, v in body.items() if k != "messages"}})
        m = re.fullmatch(r"/v1beta/models/([^:]+):generateContent", self.path)
        if m:
            if self.headers.get("x-goog-api-key") != "gm-test":
                return self._json({"error": "bad key"}, 401)
            return self._json({"candidates": [{"content": {"parts": [
                {"text": f"gemini {m.group(1)} "
                 f"{body.get('generationConfig')}"}]},
                "finishReason": "MAX_TOKENS"}],
                "usageMetadata": {"promptTokenCount": 3,
                                  "candidatesTokenCount": 5}})
        self._json({"error": "not found"}, 404)


class _HfHandler(_Handler):
    REPOS = {
        "org/llama-gguf": ["README.md", "llama-Q8_0.gguf", "llama-Q4_K_M.gguf",
                           "config.json"],
        "org/tiny-embed": ["model-00002.safetensors",
                           "model-00001.safetensors", "tokenizer.json",
                           "model.safetensors.index.json", "notes.txt"],
        "org/no-weights": ["README.md"],
    }

    def do_GET(self):
        split = urllib.parse.urlsplit(self.path)
        if split.path == "/api/models":
            q = urllib.parse.parse_qs(split.query)
            hits = [{"modelId": r, "downloads": 10 * i, "likes": i,
                     "tags": ["t"] * 10}
                    for i, r in enumerate(sorted(self.REPOS))
                    if q["search"][0] in r]
            return self._json(hits[:int(q["limit"][0])])
        repo = split.path[len("/api/models/"):]
        if repo in self.REPOS:
            return self._json({"id": repo, "siblings": [
                {"rfilename": f} for f in self.REPOS[repo]]})
        self._json({"error": "not found"}, 404)


def _serve(handler, **attrs):
    srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
    srv.daemon_threads = True
    for k, v in attrs.items():
        setattr(srv, k, v)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


# ------------------------------------------------------------- masking


_MASKED = {"id", "created", "created_at", "updated_at", "last_checked_at",
           "latency_ms", "uptime_s", "token", "api_key", "base_url",
           "key_prefix", "sampled_at", "last_failure_ts", "opened_at",
           "open_remaining_s", "recorded_at", "last_used_at", "retry_after_s",
           "code", "expires_at", "used_at", "checked_at", "ts",
           "duration_ms", "started_at", "task_id", "url",
           # which batch an entry lands in depends on how many times the
           # session polled the download task
           "batch_id"}
_IDS = re.compile(r"[0-9a-f]{32}|[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-"
                  r"[0-9a-f]{4}-[0-9a-f]{12}|msg_[0-9a-f]{24}|"
                  r"toolu_[0-9a-f]{12}|http://127\.0\.0\.1:\d+")


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    if isinstance(obj, str):
        return _IDS.sub("<id>", obj)
    return obj


def _sse_record(raw: bytes) -> list:
    out = []
    for frame in parse_sse_frames(raw):
        data = []
        for d in frame["data"]:
            try:
                data.append(_mask(json.loads(d)))
            except ValueError:
                data.append(d)
        out.append([frame["event"], data])
    return out


def _metrics_record(text: str) -> list[str]:
    """The counters of /api/metrics/cloud (latencies are timing)."""
    return [ln for ln in text.splitlines()
            if ln.startswith("llmlb_cloud_requests_total")
            or ln.startswith("llmlb_cloud_latency_seconds_count")]


# ------------------------------------------------------------- the session


class _Client:
    def __init__(self, s: gh.ClientSession, base: str):
        self.s, self.base, self.out = s, base, []

    async def call(self, method, path, body=None, headers=None, *,
                   data=None, label=None):
        kw = {"json": body} if data is None else {"data": data}
        r = await self.s.request(method, self.base + path,
                                 headers=headers or {}, **kw)
        raw = await r.read()
        ctype = r.headers.get("Content-Type", "").split(";")[0]
        where = label or path
        if ctype == "text/event-stream":
            rec = (method, where, r.status, "sse", _sse_record(raw))
        elif ctype == "application/json":
            obj = json.loads(raw)
            if path == "/api/endpoints" and method == "GET":
                # listed by probe latency: an order that is timing
                obj["endpoints"].sort(key=lambda e: e["name"])
            rec = (method, where, r.status, "json", _mask(obj))
        elif path == "/api/metrics/cloud":
            rec = (method, where, r.status, ctype,
                   _metrics_record(raw.decode()))
        else:
            rec = (method, where, r.status, ctype, raw.hex())
        self.out.append(rec)
        if ctype == "application/json":
            return json.loads(raw)
        return raw


def _multipart_form(fields) -> gh.FormData:
    form = gh.FormData()
    for name, value, filename, ctype in fields:
        if filename is None:
            form.add_field(name, value)
        else:
            form.add_field(name, value, filename=filename, content_type=ctype)
    return form


async def _session(base: str, gw_state, engines: list[str], media: str,
                   faults_cls) -> list:
    """The scripted client session; one record per exchange."""
    async with gh.ClientSession() as s:
        c = _Client(s, base)
        call = c.call
        login = await call("POST", "/api/auth/login", {
            "username": "admin", "password": ADMIN_PASSWORD})
        admin = {"Authorization": f"Bearer {login['token']}"}
        key = await call("POST", "/api/api-keys", {
            "name": "t", "permissions": ["openai.inference",
                                         "openai.models.read"]},
            headers=admin)
        inf = {"Authorization": f"Bearer {key['api_key']}"}
        anth_key = {"x-api-key": key["api_key"],
                    "anthropic-version": "2023-06-01"}
        ep_a = await call("POST", "/api/endpoints", {
            "base_url": engines[0], "name": "a"}, headers=admin)

        # ---- /v1/messages
        msg = {"model": STUB_MODEL, "max_tokens": 5, "system": "be brief",
               "messages": [{"role": "user", "content": "hello there"}]}
        await call("POST", "/v1/messages", msg, inf)
        await call("POST", "/v1/messages", {**msg, "stream": True}, anth_key)
        tools = {**msg, "tools": [
            {"name": "lookup", "description": "d", "input_schema": {
                "type": "object"}},
            {"name": "fetch", "input_schema": {"type": "object"}}],
            "tool_choice": {"type": "auto"}}
        await call("POST", "/v1/messages", tools, inf)
        await call("POST", "/v1/messages", {**tools, "stream": True}, inf)
        await call("POST", "/v1/messages", {**msg, "messages": [
            {"role": "user", "content": [{"type": "text", "text": "x"}]},
            {"role": "assistant", "content": [
                {"type": "tool_use", "id": "t1", "name": "lookup",
                 "input": {"q": 1}}]},
            {"role": "user", "content": [
                {"type": "tool_result", "tool_use_id": "t1",
                 "content": "42"}]}]}, inf)
        bad = dict(msg)
        del bad["max_tokens"]
        await call("POST", "/v1/messages", bad, inf)
        await call("POST", "/v1/messages", {**msg, "messages": []}, inf)
        await call("POST", "/v1/messages", data=b"{not json", headers=inf)
        await call("POST", "/v1/messages", {**msg, "model": "nope"}, inf)
        await call("POST", "/v1/messages", {**msg, "messages": [
            {"role": "user", "content": "fail-me"}]}, inf)
        await call("POST", "/v1/messages", msg)
        await call("POST", "/v1/messages", {**msg, "tool_choice": {
            "type": "tool", "name": "missing"}}, inf)

        # ---- a cut half-way that resumes on the second engine, then one
        # that gives up (the resumed streams cut too, the attempts spent)
        armed = {**msg, "max_tokens": MAX_TOKENS, "stream": True}
        ep_b = await call("POST", "/api/endpoints", {
            "base_url": engines[1], "name": "b"}, headers=admin)
        faults = faults_cls[0]()
        rule = faults_cls[1]
        faults.add_rule(rule(kind="engine_abort", endpoint="*", path="chat",
                             after_bytes=HALF_STREAM, max_fires=2))
        gw_state.faults = faults
        await call("POST", "/v1/messages", armed, inf, label="cut")
        faults.add_rule(rule(kind="engine_abort", endpoint="*",
                             path="resume", after_bytes=HALF_STREAM))
        await call("POST", "/v1/messages", armed, inf, label="give-up")
        gw_state.faults = None
        summary = gw_state.metrics.summary()
        c.out.append(("resumes", summary["stream_resumes"]))

        # ---- media: capability 404s before the media engine is known
        speech = {"model": "tts-stub", "input": "hello", "voice": "nova"}
        await call("POST", "/v1/audio/speech", speech, inf)
        await call("POST", "/v1/images/generations", {"prompt": "a cat"},
                   inf)
        ep_mm = await call("POST", "/api/endpoints", {
            "base_url": media, "name": "mm"}, headers=admin)
        await call("POST", "/v1/audio/speech", speech, inf)
        await call("POST", "/v1/audio/speech", {**speech, "model": "x"}, inf)
        await call("POST", "/v1/images/generations", {
            "prompt": "a cat", "n": 2, "model": "image-stub"}, inf)
        await call("POST", "/v1/images/generations", {"n": 1}, inf)
        await call("POST", "/v1/images/generations", {
            "prompt": "a cat", "n": 11}, inf)
        await call("POST", "/v1/audio/speech", data=b"[", headers=inf)
        wav = encode_wav(np.sin(np.arange(800) / 5.0).astype(np.float32))
        form = [("file", wav, "a.wav", "audio/wav"),
                ("model", "whisper-stub", None, None),
                ("prompt", "héllo\r\n--x", None, None)]
        await call("POST", "/v1/audio/transcriptions",
                   data=_multipart_form(form), headers=inf)
        await call("POST", "/v1/audio/transcriptions", {"model": "w"}, inf)
        cut_form = (b'--b\r\nContent-Disposition: form-data; name="file"; '
                    b'filename="a.wav"\r\n\r\nRIFF')
        await call("POST", "/v1/audio/transcriptions", data=cut_form,
                   headers={**inf, "Content-Type":
                            "multipart/form-data; boundary=b"})
        img = [("image", b"\x89PNG\r\n\x1a\nfake", "in.png", "image/png"),
               ("prompt", "add a hat", None, None), ("n", "1", None, None)]
        await call("POST", "/v1/images/edits", data=_multipart_form(img),
                   headers=inf)
        await call("POST", "/v1/images/variations",
                   data=_multipart_form(img[:1]), headers=inf)

        # ---- cloud prefixes
        chat = {"messages": [{"role": "system", "content": "s"},
                             {"role": "user", "content": "hi"}],
                "max_tokens": 9, "temperature": 0.5, "stop": "END"}
        for model in ("openai:gpt-x", "anthropic:claude-x",
                      "google:gemini-x"):
            await call("POST", "/v1/chat/completions", {**chat,
                                                        "model": model}, inf)
        await call("POST", "/v1/chat/completions", {
            **chat, "model": "openai:gpt-x", "stream": True}, inf)
        await call("POST", "/v1/messages", {**msg, "model":
                                            "anthropic:claude-x"}, anth_key)
        await call("POST", "/v1/messages", {
            **msg, "model": "anthropic:claude-x", "stream": True}, inf)
        await call("GET", "/api/metrics/cloud", headers=admin)

        # ---- registry, manifest, catalog
        for repo in ("org/llama-gguf", "org/tiny-embed", "org/missing",
                     "bad", "org/no-weights"):
            await call("POST", "/api/models/register", {"repo": repo},
                       admin)
        await call("GET", "/api/models", headers=admin)
        await call("GET", "/api/models/registry/llama-gguf/manifest.json",
                   headers=admin)
        await call("GET", "/api/models/registry/none/manifest.json",
                   headers=admin)
        await call("DELETE", "/api/models/tiny-embed", headers=admin)
        await call("DELETE", "/api/models/tiny-embed", headers=admin)
        await call("GET", "/api/catalog/search?q=org&limit=2", headers=admin)
        await call("GET", "/api/catalog/search", headers=admin)

        # ---- per-endpoint models, the playground
        a_id, b_id = ep_a["id"], ep_b["id"]
        r = await call("POST", f"/api/endpoints/{a_id}/models/download",
                       {"model": "extra-model"}, admin, label="download")
        for _ in range(200):  # the task, then its model sync, are done
            prog = await s.get(base + "/api/endpoints/models/download/"
                               + r["task_id"], headers=admin)
            ep = await s.get(base + f"/api/endpoints/{a_id}", headers=admin)
            synced = [m["model_id"] for m in (await ep.json())["models"]]
            if (await prog.json())["status"] != "running" and \
                    "extra-model" in synced:
                break
            await asyncio.sleep(0.02)
        await call("GET", "/api/endpoints/models/download/" + r["task_id"],
                   headers=admin, label="progress")
        await call("GET", "/api/endpoints/models/download/none",
                   headers=admin)
        await call("GET", f"/api/endpoints/{a_id}/models/extra-model/info",
                   headers=admin, label="info")
        await call("DELETE", f"/api/endpoints/{a_id}/models/extra-model",
                   headers=admin, label="delete-model")
        await call("GET", f"/api/endpoints/{a_id}/models/extra-model/info",
                   headers=admin, label="info-gone")
        await call("POST", f"/api/endpoints/{a_id}/chat/completions", {
            "model": STUB_MODEL, "messages": MESSAGES, "max_tokens": 3,
            "stream": True}, admin, label="playground")
        await call("POST", "/api/endpoints/none/chat/completions", {},
                   admin)

        # ---- users, invitations, passwords
        await call("POST", "/api/users", {"username": "vic",
                                          "password": "viewerpass1"}, admin)
        await call("POST", "/api/users", {"username": "x", "password": "1"},
                   admin)
        users = await call("GET", "/api/users", headers=admin)
        vic = [u for u in users["users"] if u["username"] == "vic"][0]
        await call("PUT", f"/api/users/{vic['id']}/role", {"role": "admin"},
                   admin, label="role")
        await call("PUT", f"/api/users/{vic['id']}/role", {"role": "root"},
                   admin, label="bad-role")
        inv = await call("POST", "/api/invitations", {"role": "viewer"},
                         admin)
        await call("GET", "/api/invitations", headers=admin)
        reg = await call("POST", "/api/auth/register", {
            "code": inv["code"], "username": "newbie",
            "password": "newbiepass1"})
        await call("POST", "/api/auth/register", {
            "code": inv["code"], "username": "again",
            "password": "againpass12"})
        viewer = {"Authorization": f"Bearer {reg['token']}"}
        await call("POST", "/api/auth/change-password", {
            "current_password": "wrong", "new_password": "x"}, viewer)
        await call("POST", "/api/auth/change-password", {
            "current_password": "newbiepass1",
            "new_password": "newbiepass2"}, viewer)
        await call("POST", "/api/auth/login", {
            "username": "newbie", "password": "newbiepass2"})
        await call("PUT", "/api/dashboard/settings", {
            "key": "k", "value": "v"}, viewer)
        await call("GET", "/api/users", headers=viewer)
        inv2 = await call("POST", "/api/invitations", None, admin)
        await call("DELETE", f"/api/invitations/{inv2['id']}",
                   headers=admin, label="del-inv")
        await call("DELETE", "/api/invitations/none", headers=admin)
        await call("DELETE", f"/api/users/{vic['id']}", headers=admin,
                   label="del-user")
        await call("DELETE", f"/api/users/{login['user']['id']}",
                   headers=admin, label="del-self")

        # ---- endpoints: update, history, system info, delete
        await call("PUT", f"/api/endpoints/{b_id}", {"name": "b-renamed"},
                   admin, label="rename")
        await call("PUT", f"/api/endpoints/{b_id}", {
            "endpoint_type": "warp"}, admin, label="bad-type")
        await call("GET", f"/api/endpoints/{a_id}/health", headers=admin,
                   label="health")
        await call("GET", f"/api/endpoints/{a_id}/system-info",
                   headers=admin, label="system-info")
        await call("GET", f"/api/endpoints/{ep_mm['id']}/system-info",
                   headers=admin, label="system-info-mm")
        await call("DELETE", f"/api/endpoints/{b_id}", headers=admin,
                   label="del-ep")
        await call("DELETE", f"/api/endpoints/{b_id}", headers=admin,
                   label="del-ep-again")
        await call("GET", "/api/endpoints", headers=admin)

        # ---- settings, system, audit
        await call("PUT", "/api/dashboard/settings", {
            "key": "ip_alert_threshold", "value": "5"}, admin)
        await call("PUT", "/api/dashboard/settings", {
            "key": "ip_alert_threshold", "value": "0"}, admin)
        await call("PUT", "/api/dashboard/settings", {
            "key": "auth.jwt_secret", "value": "x"}, admin)
        await call("PUT", "/api/dashboard/settings", {"key": "k"}, admin)
        await call("GET", "/api/dashboard/settings", headers=admin)
        await call("GET", "/api/system", headers=admin)

        # ---- the API-key permission matrix of the new routes
        routes = [("GET", "/api/users"), ("GET", "/api/invitations"),
                  ("GET", "/api/audit-log"), ("GET", "/api/metrics/cloud"),
                  ("GET", "/api/dashboard/settings"), ("GET", "/api/system"),
                  ("GET", "/api/models/registry/llama-gguf/manifest.json"),
                  ("GET", "/api/models"), ("POST", "/api/audit-log/verify"),
                  ("GET", f"/api/endpoints/{a_id}/health"),
                  ("POST", "/v1/messages"), ("POST", "/v1/audio/speech")]
        for perm in ("users.manage", "invitations.manage", "logs.read",
                     "metrics.read", "registry.read", "endpoints.read",
                     "openai.models.read"):
            k = await call("POST", "/api/api-keys", {
                "name": perm, "permissions": [perm]}, admin)
            hk = {"Authorization": f"Bearer {k['api_key']}"}
            statuses = []
            for method, path in routes:
                r = await s.request(method, base + path, headers=hk,
                                    json={} if method == "POST" else None)
                await r.read()
                statuses.append(r.status)
            c.out.append(("perm", perm, statuses))

        # verify flushes the pending entries, so both searches see the
        # same entries however many times the session polled above
        await call("POST", "/api/audit-log/verify", None, admin)
        await call("GET", "/api/audit-log?path=/v1/messages&limit=500",
                   headers=admin)
        await call("GET", "/api/audit-log?q=invitations", headers=admin)
        await call("POST", "/api/audit-log/verify", None, admin)
    return c.out


async def test_scripted_session_matches_the_jax_gateway(monkeypatch):
    cloud, cloud_url = _serve(_CloudHandler)
    hf, hf_url = _serve(_HfHandler)
    monkeypatch.setenv("HF_BASE_URL", hf_url)
    for mod in (ref_cloud, api_cloud):
        monkeypatch.setattr(mod, "OPENAI_BASE", cloud_url)
        monkeypatch.setattr(mod, "GOOGLE_BASE", cloud_url)
        monkeypatch.setattr(mod, "ANTHROPIC_BASE", cloud_url)
        monkeypatch.setattr(mod, "METRICS", mod.CloudMetrics())
    for mod in (ref_anth, api_anthropic):
        monkeypatch.setattr(mod, "ANTHROPIC_BASE", cloud_url)
    servers = []

    def engines():
        out = []
        for handler, attrs in ((_EngineHandler, {"models": [STUB_MODEL]}),
                               (_EngineHandler, {"models": [STUB_MODEL]}),
                               (_MediaHandler, {})):
            srv, url = _serve(handler, **attrs)
            servers.append(srv)
            out.append(url)
        return out

    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()
    try:
        e = engines()
        ref = await _session(jax_url, gw.state, e[:2], e[2],
                             (RefFaultInjector, RefFaultRule))
        e = engines()
        ours = await _session(port.url, port.state, e[:2], e[2],
                              (FaultInjector, FaultRule))
        assert len(ours) == len(ref)
        for a, b in zip(ref, ours):
            if b != a:
                print("REF ", json.dumps(a, indent=1))
                print("OURS", json.dumps(b, indent=1))
            assert b == a
        rec = {r[1]: r for r in ours if len(r) == 5}
        resumes = [r[1] for r in ours if r[0] == "resumes"][0]
        # the give-up: resumed once, then cut again with no engine left
        assert resumes == {"success": 2, "no_endpoint": 1}, resumes
        cut = rec["cut"]
        frames = cut[4]
        assert cut[2] == 200 and frames[0][0] == "message_start"
        assert [f[0] for f in frames].count("message_start") == 1
        assert frames[-1][0] == "message_stop"
        text = "".join(d["delta"]["text"] for ev, ds in frames for d in ds
                       if ev == "content_block_delta")
        assert text == "".join(f"s{i} " for i in range(MAX_TOKENS))
        assert rec["give-up"][4][-1][0] == "error"
        audit = [r for r in ours if str(r[1]).startswith("/api/audit-log")]
        assert audit[0][4] == audit[-1][4] == {"ok": True, "error": None}
        assert len(audit[1][4]["entries"]) > 10
        perms = {r[1]: r[2] for r in ours if r[0] == "perm"}
        assert perms["users.manage"][:2] == [200, 403]
        assert perms["logs.read"][2] == 200
        assert perms["metrics.read"][3:5] == [200, 200]
        assert perms["registry.read"][6] == 200
    finally:
        await gw.close()
        await port.close()
        for srv in servers + [cloud, hf]:
            srv.shutdown()
            srv.server_close()
