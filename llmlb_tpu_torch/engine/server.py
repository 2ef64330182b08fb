"""OpenAI-compatible HTTP server of the port's engine, on the standard
library (`http.server.ThreadingHTTPServer`, one thread per connection).

Counterpart of the serving subset of `llmlb_tpu/engine/server.py`:

- `GET /v1/models`, with the reference's capabilities (`structured_outputs`,
  `embeddings` where the model family has an `encode` forward, `lora` with
  adapters on);
- `POST /v1/chat/completions`, streaming (SSE, written and flushed chunk by
  chunk, ending with a usage chunk and `data: [DONE]`) and non-streaming,
  with the reference's chunk and usage shapes;
- `POST /v1/completions`, `POST /v1/responses` and `POST /v1/embeddings`,
  with the reference's shapes and validation messages;
- durable streams: a chat body with `"llmlb_replay": true` (the gateway
  arms its streams so) gets `{"object": "llmlb.replay", "tokens": [...]}`
  frames before the text those tokens produced, and `POST /v1/resume`
  takes the original chat body plus `committed_ids` (and optionally the
  origin's `kv_pages`) and streams the full completion, continued
  token-identical from the committed tokens;
- disaggregated prefill/decode, with the reference's routes and shapes:
  `POST /v1/handoff/prefill` (a chat body plus `handoff_tokens`, 1..64,
  default LLMLB_DISAGG_HANDOFF_TOKENS or 1; 409 on `--role decode`)
  prefills and commits that many tokens and answers `{"object":
  "llmlb.handoff", "handoff": <wire payload>, "finish", ...}`, the payload
  carrying the row's KV pages when the engine ships them; `POST
  /v1/handoff` (`{"handoff": <payload>, "stream", "model", "tool_name"}`)
  adopts it and answers the full completion, streamed or not (a malformed
  payload is a 400). `--role` (both, split, prefill, decode) is advertised
  as /v1/models' `prefill` / `decode` capabilities and `role` key, and as
  the `disagg` block of /api/health and /api/system;
- KV page shipping: `POST /v1/kv/export {"request_id", "park"}` hands over
  a parked stream's serialized KV pages once (with `"park": true` it first
  asks the step loop to park that stream, polling up to 2 s for the
  payload; 404 when there is none), which the gateway attaches to
  `/v1/resume` on another engine; it answers while draining, which is
  what it is for;
- graceful drain: `POST /api/drain` (and SIGTERM in `main`) stops
  admission: new `/v1/*` work gets 503 with `Retry-After` and code
  `draining`, `/api/health` says `"status": "draining"` with a `draining`
  block (what the gateway's health probe reads), in-flight streams get the
  grace (`LLMLB_DRAIN_GRACE_S`, 30 s by default, or the body's `grace_s`),
  then the rows still decoding are parked and the stragglers' sockets shut
  down, so the gateway resumes them elsewhere;
- `GET /api/health` (with the `sched` block: the prefill chunk budget,
  queue depths by priority class, preemption and deadline-shed counters;
  the `kv_transfer` block: page moves, fallbacks by reason, the offload
  tier; and the `spec` block: the speculative decoding knobs and acceptance
  figures) and `GET /api/system`,
  carrying `"tpu_engine": true` — the field the gateway's endpoint
  detection keys on to treat this as an in-tree engine — and
  `"backend": "cuda"`; `/api/health` also carries the `gpu` block (the
  device's memory, which the gateway's probe reads for placement), `perf`
  (live MFU and memory-bandwidth utilization) and `metrics` (latency
  percentiles and counters), `/api/system` the `perf` block;
- observability, with the reference's routes, shapes and status codes:
  `GET /metrics` (Prometheus text), `GET /api/steps?limit=&slow=` (the
  step records, with `perf` and the flight recorder's counters), `GET
  /api/requests/{id}/timeline` (one request's flight record, by the
  gateway's X-Request-Id; 404 when the recorder is off or knows nothing
  of it), `POST /api/profile` (`{"action": "start", "seconds": N}` or
  `{"action": "stop"}`: a torch.profiler capture of the serving loop),
  `GET /api/profile` (its state and completed captures), `GET
  /api/profile/{capture_id}` (the capture as a zip) and `POST
  /debug/profile` (`{"seconds": N}`: start, wait out, answer with the
  trace directory). Traces land under LLMLB_TRACE_DIR; with
  LLMLB_PROFILE_TOKEN set, every profile route needs `Authorization:
  Bearer <token>` (401 otherwise).

Request fields are validated by the reference's rules: `priority` (the
admission class; a more important request may park a less important one)
and the `X-Request-Deadline-Ms` header (a request still queued past it is
shed), `speculative` (`{"enabled", "max_draft_tokens"}`: the request
speculates, or not, whatever the engine's `--spec-decode` default; the
draft budget clamps into `--spec-max-draft`). Structured outputs, as the
reference serves them: a chat's `response_format` (`json_object`,
`json_schema`) or forced `tool_choice` goes through the port's
`inspect_request` (malformed or uncompilable requests are 400s naming the
feature) and becomes the request's grammar constraint; a forced tool call
is answered in the `tool_calls` shape (streamed: a first delta with the
call's id and name, then the arguments as fragments) with finish_reason
`"tool_calls"` where the grammar ended the call. `/api/health` and
`/api/system` carry the `structured` block.

Multimodal services, as the reference serves them beside the chat model
(`--asr`, `--tts`, `--image`: a checkpoint directory or "random"): POST
/v1/audio/transcriptions (multipart/form-data with a WAV `file` part, parsed
with the stdlib's email parser) answers `{"text": ...}`, POST
/v1/audio/speech (`{"input", "voice", "speed"}`) a PCM16 WAV, POST
/v1/images/generations (`{"prompt", "n"}`) `{"created", "data":
[{"b64_json"}]}`; each answers 404 when its service is not loaded and the
reference's 400s on a bad request; /v1/models lists each service with its
capability (`audio_transcription`, `audio_speech`, `image_generation`).

Multi-LoRA (`--lora-dir`): a request names an adapter with the `lora` field
or a `model:adapter` suffix (the suffix only on a LoRA-enabled engine);
unknown, unservable or conflicting adapters are 400s naming `lora`.
`/v1/models` gives the base entry the `lora` capability and one
`base:adapter` entry per resident adapter; `/api/health` and `/api/system`
carry a `lora` block.

Multi-rank serving (parallel/, engine/multihost.py): with
LLMLB_COORDINATOR=host:port, LLMLB_NUM_HOSTS=N and LLMLB_HOST_ID=i (or
LLMLB_DISTRIBUTED=1 under torchrun) one process a rank joins a
torch.distributed world before the engine is built (NCCL on the cards,
gloo on the CPU; LLMLB_MESH_BACKEND=gloo lets ranks share a card), every
rank with the same flags. Rank 0 serves HTTP; a follower runs the
lockstep loop only, binds no port, and exits when the leader stops.
Ranks per host are torchrun's LOCAL_WORLD_SIZE, else the whole world (the
LLMLB_COORDINATOR ranks share one host); the default mesh sizes ep and tp
within a host and multiplies dp across hosts, as the reference. A dp > 1
mesh splits the batch's slots into dp groups; `--lora-dir` serves on one
host's ranks and is refused across hosts. `/api/health`'s `engine` block
carries the `mesh` and `dp_slots` (each dp group's slots).

Run: `python -m llmlb_tpu_torch.engine.server --preset llama-3-8b` (on the
card, random weights), or `--checkpoint DIR` to serve a HF checkpoint with
its own tokenizer (`transformers` needed); `--device cpu` for the plain
PyTorch path; `--quantize all` for int8
weights and KV pages; `--kv-layout dense` for the slot cache; `--lora-dir
DIR` for adapters).
"""

from __future__ import annotations

import argparse
import email.parser
import email.policy
import json
import logging
import os
import re
import signal
import socket
import threading
import time
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from llmlb_tpu_torch import __version__
from llmlb_tpu_torch.disagg import (
    ROLES,
    HandoffError,
    handoff_payload,
    parse_handoff,
)
from llmlb_tpu_torch.engine.cuda_probe import guard_backend_init
from llmlb_tpu_torch.engine.profiling import ProfileError, ProfileManager
from llmlb_tpu_torch.engine.scheduler import SamplingParams
from llmlb_tpu_torch.engine.service import Engine, EngineError
from llmlb_tpu_torch.lora import adapter_from_body
from llmlb_tpu_torch.parallel.distributed import init_from_env
from llmlb_tpu_torch.structured import inspect_request

log = logging.getLogger("llmlb_tpu_torch.engine.server")

SYSTEM_FINGERPRINT = f"fp_llmlb_tpu_torch_{__version__}"
MAX_BODY_BYTES = 20 * 1024 * 1024
# a resume body may carry a KV page payload (base64, tens of MiB for long
# contexts at full width), as in the reference
KV_BODY_BYTES = 256 * 1024 * 1024
_REQUEST_ID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,128}$")
_TIMELINE_RE = re.compile(r"^/api/requests/([^/]+)/timeline$")


def _sampling_from(body: dict, default_max: int = 256,
                   deadline_ms: float | None = None) -> SamplingParams:
    def pick(*names, default):
        for n in names:
            if body.get(n) is not None:
                return body[n]
        return default

    temperature = float(pick("temperature", default=1.0))
    top_p = float(pick("top_p", default=1.0))
    top_k = int(pick("top_k", default=0))
    max_tokens = int(pick("max_tokens", "max_completion_tokens",
                          "max_output_tokens", default=default_max))
    if temperature < 0:
        raise ValueError("'temperature' must be >= 0")
    if not 0 < top_p <= 1:
        raise ValueError("'top_p' must be in (0, 1]")
    if top_k < 0:
        raise ValueError("'top_k' must be >= 0")
    if max_tokens < 1:
        raise ValueError("'max_tokens' must be >= 1")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
        raise ValueError("'seed' must be an integer")
    return SamplingParams(temperature=temperature, top_p=top_p, top_k=top_k,
                          max_tokens=max_tokens, seed=seed,
                          priority=_priority_from(body),
                          speculative=_speculative_from(body),
                          deadline_ms=deadline_ms)


_PRIORITY_NAMES = {"high": 0, "normal": 1, "low": 2}


def _priority_from(body: dict) -> int:
    """Per-request priority class, "high"/"normal"/"low" or 0/1/2 (lower is
    more important; default "normal"), as the reference validates it."""
    p = body.get("priority")
    if p is None:
        return 1
    if isinstance(p, str):
        if p not in _PRIORITY_NAMES:
            raise ValueError(
                "'priority' must be one of high, normal, low (or 0..2)")
        return _PRIORITY_NAMES[p]
    if isinstance(p, bool) or not isinstance(p, int) or not 0 <= p <= 2:
        raise ValueError(
            "'priority' must be one of high, normal, low (or 0..2)")
    return p


def _deadline_from(headers) -> float | None:
    """The request's remaining deadline in milliseconds, from the
    X-Request-Deadline-Ms header (set by the gateway or a direct client),
    as the reference validates it."""
    raw = headers.get("X-Request-Deadline-Ms")
    if not raw:
        return None
    try:
        ms = float(raw)
    except ValueError:
        raise ValueError("X-Request-Deadline-Ms must be a number") from None
    if ms <= 0:
        raise ValueError("X-Request-Deadline-Ms must be positive")
    return ms


def _speculative_from(body: dict) -> dict | None:
    """Per-request speculative-decoding knobs, `speculative: {enabled,
    max_draft_tokens}`, as the reference validates them, so a malformed
    knob is a 400 instead of being silently ignored."""
    spec = body.get("speculative")
    if spec is None:
        return None
    if not isinstance(spec, dict):
        raise ValueError("'speculative' must be an object")
    out: dict = {}
    if "enabled" in spec:
        if not isinstance(spec["enabled"], bool):
            raise ValueError("'speculative.enabled' must be a boolean")
        out["enabled"] = spec["enabled"]
    if spec.get("max_draft_tokens") is not None:
        k = spec["max_draft_tokens"]
        if not isinstance(k, int) or isinstance(k, bool) or k < 1:
            raise ValueError(
                "'speculative.max_draft_tokens' must be a positive integer")
        out["max_draft_tokens"] = k
    return out or None


def _handoff_tokens_from(body: dict) -> int:
    """The tokens the prefill side commits before handing off: the body's
    `handoff_tokens`, else LLMLB_DISAGG_HANDOFF_TOKENS, else 1, within
    1..64 (the window rides the wire; a large one only moves decode work
    onto the prefill engine), as the reference validates it."""
    raw = body.get("handoff_tokens")
    if raw is None:
        raw = os.environ.get("LLMLB_DISAGG_HANDOFF_TOKENS", 1)
    try:
        k = int(raw)
    except (TypeError, ValueError):
        raise ValueError("'handoff_tokens' must be an integer") from None
    if isinstance(body.get("handoff_tokens"), bool) or not 1 <= k <= 64:
        raise ValueError("'handoff_tokens' must be between 1 and 64")
    return k


def _stops_from(body: dict) -> list[str]:
    stop = body.get("stop") or body.get("stop_sequences") or []
    if isinstance(stop, str):
        return [stop]
    return [s for s in stop if isinstance(s, str)]


def _usage(prompt_tokens: int, completion_tokens: int) -> dict:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _drain_grace_from_env() -> float:
    """The drain's grace in seconds: LLMLB_DRAIN_GRACE_S, 30 by default."""
    raw = os.environ.get("LLMLB_DRAIN_GRACE_S")
    if raw:
        try:
            return max(0.0, float(raw))
        except ValueError:
            log.warning("LLMLB_DRAIN_GRACE_S=%r is not a number; using 30",
                        raw)
    return 30.0


class DrainController:
    """Graceful drain, the reference's: `start` flips the server to
    draining (new /v1 work 503s with an honest Retry-After, /api/health
    advertises it, the core admits nothing more) while in-flight work gets
    the grace to finish. Past the grace, the core parks every row still
    decoding (its committed tokens stay on the request), the sockets of the
    accepted /v1 requests still open are shut down (the gateway sees a
    mid-stream cut and resumes the stream on another engine from its own
    ledger), and everything still queued ends with an error, so the
    handler threads waiting on it return. One-way."""

    def __init__(self, engine: Engine):
        self.engine = engine
        self.grace_s = _drain_grace_from_env()
        self.draining = False
        self.started_at = 0.0
        self.parked = 0
        self.aborted_connections = 0
        self._lock = threading.Lock()
        # sockets of the accepted /v1 POSTs still being answered
        self._streams: set[socket.socket] = set()
        self._thread: threading.Thread | None = None

    def track(self, sock: socket.socket) -> None:
        with self._lock:
            self._streams.add(sock)

    def untrack(self, sock: socket.socket) -> None:
        with self._lock:
            self._streams.discard(sock)

    def remaining_s(self) -> float:
        if not self.draining:
            return self.grace_s
        return max(0.0, self.started_at + self.grace_s - time.monotonic())

    def retry_after_s(self) -> int:
        """Retry-After of a refused admission: the grace still left (after
        it this process is gone)."""
        return max(1, int(self.remaining_s() + 0.999))

    def info(self) -> dict:
        return {
            "draining": self.draining,
            "grace_s": self.grace_s,
            "remaining_s": round(self.remaining_s(), 3),
            "active_streams": len(self._streams),
            "parked": self.parked,
            "aborted_connections": self.aborted_connections,
        }

    def start(self, grace_s: float | None = None) -> dict:
        """Begin draining (idempotent); returns the drain info."""
        with self._lock:
            if not self.draining:
                if grace_s is not None:
                    self.grace_s = max(0.0, float(grace_s))
                self.draining = True
                self.started_at = time.monotonic()
                self.engine.core.begin_drain()
                log.info("drain started: %d in-flight stream(s), grace %.1fs",
                         len(self._streams), self.grace_s)
                self._thread = threading.Thread(target=self._run,
                                                name="engine-drain",
                                                daemon=True)
                self._thread.start()
        return self.info()

    def wait(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _run(self) -> None:
        core = self.engine.core
        deadline = self.started_at + self.grace_s
        while time.monotonic() < deadline:
            if not self._streams and core.stats().active_slots == 0:
                log.info("drain complete: all in-flight work finished "
                         "within the grace")
                return
            time.sleep(0.05)
        # Grace spent: the step loop parks what still decodes (slot state
        # is the loop's); wait until it took the request (bounded: a wedged
        # loop must not hold the sockets open forever), then for the parks.
        before = core.stats().drain_parked_total
        core.request_drain_park()
        t_end = time.monotonic() + 30.0
        while core._drain_park_requested and time.monotonic() < t_end:
            time.sleep(0.02)
        t_end = time.monotonic() + 2.0
        while core.stats().active_slots > 0 and time.monotonic() < t_end:
            time.sleep(0.02)
        self.parked = core.stats().drain_parked_total - before
        with self._lock:
            stragglers = list(self._streams)
        for sock in stragglers:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass  # closed by its handler meanwhile: nothing to cut
        self.aborted_connections = len(stragglers)
        # after the cuts: end everything queued (parked work included)
        core.request_drain_flush()
        if stragglers or self.parked:
            log.warning("drain grace expired: parked %d row(s), shut down %d "
                        "connection(s) for the gateway to resume",
                        self.parked, len(stragglers))


class EngineHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, address: tuple[str, int], engine: Engine, *,
                 asr=None, tts=None, image=None):
        self.engine = engine
        # the multimodal services (engine/asr.py, tts.py, image.py), or None
        self.asr, self.tts, self.image = asr, tts, image
        self.drain = DrainController(engine)
        # one profiler per engine; it starts and stops on the step loop
        core = engine.core
        self.profiles = ProfileManager(cuda=core.device.type == "cuda",
                                       run_in_loop=core.call_in_loop)
        super().__init__(address, _Handler)


class _Handler(BaseHTTPRequestHandler):
    server: EngineHTTPServer
    server_version = f"llmlb_tpu_torch/{__version__}"

    def log_message(self, fmt, *args):  # route access logs through logging
        log.debug("%s - " + fmt, self.address_string(), *args)

    # ---------------------------------------------------------------- helpers

    def _json(self, status: int, body: dict, headers: dict | None = None):
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(data)

    def _error(self, status: int, message: str,
               err_type: str = "invalid_request_error"):
        self._json(status, {"error": {"message": message, "type": err_type,
                                      "code": None}})

    def _sse(self, payload: dict | str) -> None:
        data = payload if isinstance(payload, str) else json.dumps(
            payload, separators=(",", ":"))
        self.wfile.write(f"data: {data}\n\n".encode())
        self.wfile.flush()

    def _event(self, name: str, payload: dict) -> None:
        """One named SSE event (the Responses API's stream)."""
        data = json.dumps(payload, separators=(",", ":"))
        self.wfile.write(f"event: {name}\ndata: {data}\n\n".encode())
        self.wfile.flush()

    def _start_sse(self) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

    def _request_id(self) -> str | None:
        rid = self.headers.get("X-Request-Id")
        return rid if rid and _REQUEST_ID_RE.match(rid) else None

    def _body(self, limit: int = MAX_BODY_BYTES) -> dict | None:
        """The JSON object body, or None after answering 4xx."""
        length = int(self.headers.get("Content-Length") or 0)
        if length > limit:
            self._error(413, "request body too large")
            return None
        try:
            body = json.loads(self.rfile.read(length) or b"null")
        except ValueError:
            self._error(400, "invalid JSON body")
            return None
        if not isinstance(body, dict):
            self._error(400, "body must be a JSON object")
            return None
        return body

    def _form(self) -> dict | None:
        """A multipart/form-data body as {field name: bytes}, or None
        after answering 4xx (the reference's 400 for another type)."""
        ctype = self.headers.get("Content-Type") or ""
        if not ctype.startswith("multipart/"):
            self._error(400, "multipart/form-data body required")
            return None
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self._error(413, "request body too large")
            return None
        msg = email.parser.BytesParser(policy=email.policy.HTTP).parsebytes(
            b"Content-Type: " + ctype.encode("latin-1") + b"\r\n\r\n"
            + self.rfile.read(length))
        fields = {}
        if msg.is_multipart():
            for part in msg.iter_parts():
                name = part.get_param("name", header="content-disposition")
                if name is not None:
                    fields[name] = part.get_payload(decode=True) or b""
        return fields

    # ----------------------------------------------------------------- routes

    def do_GET(self):
        engine = self.server.engine
        path, _, query = self.path.partition("?")
        timeline = _TIMELINE_RE.match(path)
        if path == "/metrics":
            self._metrics()
        elif path == "/api/steps":
            self._steps(urllib.parse.parse_qs(query))
        elif timeline is not None:
            self._timeline(urllib.parse.unquote(timeline.group(1)))
        elif path == "/api/profile" or path.startswith("/api/profile/"):
            if not self._profile_authorized():
                what = ("status" if path == "/api/profile" else "download")
                self._error(401, f"profile {what} requires the profile token",
                            "authentication_error")
            elif path == "/api/profile":
                self._json(200, self.server.profiles.status())
            else:
                self._profile_artifact(path[len("/api/profile/"):])
        elif path == "/v1/models":
            self._json(200, {"object": "list",
                             "data": _models(engine, self.server)})
        elif path == "/api/health":
            body = engine.health()
            drain = self.server.drain
            if drain.draining:
                # the gateway's probe reads this every interval and drops
                # the endpoint from selection
                body["status"] = "draining"
            body["draining"] = drain.info()
            self._json(200, body)
        elif path == "/api/system":
            self._json(200, {
                "name": "llmlb_tpu_torch-engine",
                "version": __version__,
                "tpu_engine": True,
                "backend": "cuda",
                "device": str(engine.core.device),
                "model": engine.model_id,
                "kv_cache": engine.core.kv_cache_info(),
                "prefix_cache": engine.core.prefix_cache_info(),
                "quant": engine.core.quant_info(),
                "lora": engine.core.lora_info(),
                "sched": engine.core.sched_info(),
                "kv_transfer": engine.core.kv_transfer_info(),
                "structured": engine.core.structured_info(),
                "spec": engine.core.spec_info(),
                "disagg": engine.core.disagg_info(),
                "draining": self.server.drain.info(),
                "perf": engine.core.perf_info(),
            })
        else:
            self._error(404, f"no route for GET {path}")

    # ---------------------------------------------------------- observability

    def _metrics(self) -> None:
        """GET /metrics: the Prometheus exposition of the serving loop."""
        core = self.server.engine.core
        text = core.metrics.render(
            core.stats(), prefix_cache=core.prefix_cache_info(),
            kv_cache=core.kv_cache_info(), structured=core.structured_info(),
            perf=core.perf_info(), quant=core.quant_info(),
            sched=core.sched_info(), lora=core.lora_info(),
            flightrec=core.flightrec.counters(),
            kv_offload=core.kv_transfer_info()["offload"])
        data = text.encode()
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _steps(self, query: dict) -> None:
        """GET /api/steps: the newest step records (`limit`, default 64,
        at most the ring's size; `slow=1`: flagged ones only), the per-kind
        baselines, the `perf` block and the flight recorder's counters."""
        core = self.server.engine.core
        try:
            limit = int(query.get("limit", ["64"])[-1])
        except ValueError:
            self._error(400, "'limit' must be an integer")
            return
        slow_only = query.get("slow", [""])[-1] in ("1", "true", "yes")
        body = core.step_stats.snapshot(limit=limit, slow_only=slow_only)
        body["perf"] = core.perf_info()
        body["flightrec"] = core.flightrec.counters()
        self._json(200, body)

    def _timeline(self, rid: str) -> None:
        """GET /api/requests/{id}/timeline: one request's flight record by
        the gateway's request id, the events sorted causally."""
        recorder = self.server.engine.core.flightrec
        if not recorder.enabled:
            self._error(404, "flight recorder disabled (LLMLB_FLIGHTREC=0)")
            return
        body = recorder.timeline(rid)
        if body is None:
            self._error(404, f"no flight record for request '{rid}'")
            return
        self._json(200, body)

    def _profile_authorized(self) -> bool:
        """With LLMLB_PROFILE_TOKEN set, profile control and downloads
        need `Authorization: Bearer <token>`."""
        token = os.environ.get("LLMLB_PROFILE_TOKEN")
        if not token:
            return True
        return self.headers.get("Authorization", "") == f"Bearer {token}"

    def _profile_body(self) -> dict | None:
        """A profile route's body, as the reference reads it: absent or
        unparsable is {}; anything but an object is a 400."""
        length = int(self.headers.get("Content-Length") or 0)
        if length > MAX_BODY_BYTES:
            self._error(413, "request body too large")
            return None
        try:
            body = json.loads(self.rfile.read(length)) if length else {}
        except ValueError:
            body = {}
        if not isinstance(body, dict):
            self._error(400, "body must be a JSON object")
            return None
        return body

    def _profile_post(self, path: str) -> None:
        """POST /api/profile and POST /debug/profile."""
        if not self._profile_authorized():
            self._error(401, "profile capture requires the profile token",
                        "authentication_error")
            return
        body = self._profile_body()
        if body is None:
            return
        profiles = self.server.profiles
        if path == "/debug/profile":
            self._debug_profile(body)
            return
        action = body.get("action", "start")
        try:
            if action == "start":
                try:
                    seconds = float(body.get("seconds", 3.0))
                except (TypeError, ValueError):
                    self._error(400, "'seconds' must be a number")
                    return
                self._json(200, {"started": True, **profiles.start(seconds)})
                return
            if action == "stop":
                self._json(200, {"stopped": True, **profiles.stop()})
                return
        except ProfileError as e:
            self._error(e.status, str(e), "server_error" if e.status >= 500
                        else "invalid_request_error")
            return
        self._error(400, "'action' must be 'start' or 'stop'")

    def _debug_profile(self, body: dict) -> None:
        """POST /debug/profile {"seconds": N}: the one-shot form. Start a
        capture, wait out its bounded duration (this connection's thread
        only), answer with the trace directory."""
        try:
            seconds = min(30.0, max(0.1, float(body.get("seconds", 3.0))))
        except (TypeError, ValueError):
            self._error(400, "'seconds' must be a number")
            return
        profiles = self.server.profiles
        try:
            started = profiles.start(seconds)
        except ProfileError as e:
            self._error(e.status, str(e))
            return
        profiles.wait_idle(seconds + 30.0)
        self._json(200, {
            "trace_dir": started["trace_dir"],
            "seconds": started["seconds"],
            "capture_id": started["capture_id"],
            "hint": "open trace.json in chrome://tracing or Perfetto",
        })

    def _profile_artifact(self, capture_id: str) -> None:
        """GET /api/profile/{capture_id}: the capture's directory as a
        zip, built on this connection's thread and sent from the file."""
        try:
            path, filename = self.server.profiles.artifact(capture_id)
        except ProfileError as e:
            self._error(e.status, str(e))
            return
        size = os.path.getsize(path)
        self.send_response(200)
        self.send_header("Content-Type", "application/zip")
        self.send_header("Content-Disposition",
                         f'attachment; filename="{filename}"')
        self.send_header("Content-Length", str(size))
        self.end_headers()
        with open(path, "rb") as f:
            while chunk := f.read(1 << 20):
                self.wfile.write(chunk)

    _POST_ROUTES = {
        "/v1/chat/completions": "_chat",
        "/v1/resume": "_resume",
        "/v1/handoff/prefill": "_handoff_prefill",
        "/v1/handoff": "_handoff",
        "/v1/kv/export": "_kv_export",
        "/v1/completions": "_completions",
        "/v1/responses": "_responses",
        "/v1/embeddings": "_embeddings",
        "/api/drain": "_drain_control",
        "/v1/audio/transcriptions": "_transcriptions",
        "/v1/audio/speech": "_speech",
        "/v1/images/generations": "_images",
    }
    # route -> (the server's service attribute, the 404's message)
    _SERVICES = {
        "/v1/audio/transcriptions": (
            "asr", "no transcription model is loaded on this engine"),
        "/v1/audio/speech": ("tts", "no speech model is loaded on this engine"),
        "/v1/images/generations": (
            "image", "no image model is loaded on this engine"),
    }

    def do_POST(self):
        path = self.path.split("?", 1)[0]
        if path in ("/api/profile", "/debug/profile"):
            self._profile_post(path)
            return
        route = self._POST_ROUTES.get(path)
        if route is None:
            self._error(404, f"no route for POST {path}")
            return
        service = self._SERVICES.get(path)
        if service is not None and getattr(self.server, service[0]) is None:
            self._error(404, service[1])
            return
        drain = self.server.drain
        # the export is exempt from the drain: it exists for that window
        admitted = path.startswith("/v1/") and path != "/v1/kv/export"
        if admitted and drain.draining:
            self._json(503, {"error": {
                "message": "engine is draining; retry on another endpoint",
                "type": "overloaded_error", "code": "draining"}},
                headers={"Retry-After": str(drain.retry_after_s())})
            return
        if path == "/v1/audio/transcriptions":  # multipart, not JSON
            body = self._form()
        else:
            body = self._body(KV_BODY_BYTES if path in ("/v1/resume",
                                                         "/v1/handoff")
                              else MAX_BODY_BYTES)
        if body is None:
            return
        if not admitted:
            getattr(self, route)(body)
            return
        # an accepted /v1 request: the drain shuts its socket down if it is
        # still open when the grace is spent
        drain.track(self.connection)
        try:
            getattr(self, route)(body)
        finally:
            drain.untrack(self.connection)

    def _kv_export(self, body: dict) -> None:
        """POST /v1/kv/export {"request_id": <gateway id>, "park": bool}:
        hand over a parked stream's serialized KV pages, once. With "park"
        (a migration of a live stream) the step loop is first asked to park
        that one stream, and the payload is polled for up to 2 s; a 404
        then means the stream could not park (prefilling, finished), and
        the migration aborts with the stream untouched."""
        rid = body.get("request_id")
        if not isinstance(rid, str) or not rid:
            self._error(400, "'request_id' must be a non-empty string")
            return
        core = self.server.engine.core
        if body.get("park"):
            core.request_park(rid)
            deadline = time.monotonic() + 2.0
            payload = core.take_kv_export(rid)
            while payload is None and time.monotonic() < deadline:
                time.sleep(0.02)
                payload = core.take_kv_export(rid)
        else:
            payload = core.take_kv_export(rid)
        if payload is None:
            self._error(404, f"no KV export held for request {rid!r}")
            return
        self._json(200, {"object": "llmlb.kv_export", "request_id": rid,
                         "kv_pages": payload})

    def _drain_control(self, body: dict) -> None:
        """POST /api/drain {"grace_s": N}: begin the drain (idempotent);
        poll /api/health for its progress."""
        grace = body.get("grace_s")
        if grace is not None and (isinstance(grace, bool)
                                  or not isinstance(grace, (int, float))
                                  or grace < 0):
            self._error(400, "'grace_s' must be a non-negative number")
            return
        self._json(200, self.server.drain.start(grace))

    # ------------------------------------------------------ chat completions

    def _parse_chat(self, body: dict):
        """(prompt_ids, sampling, stops, tool_name, model) of a chat body;
        ValueError naming the field (or the unsupported schema feature)
        when it is malformed. A `response_format` or forced `tool_choice`
        becomes the sampling's grammar constraint; `tool_name` is the
        forced tool's, for the answer's shape."""
        engine = self.server.engine
        messages = body.get("messages")
        if not isinstance(messages, list) or not messages:
            raise ValueError("'messages' must be a non-empty array")
        if int(body.get("n") or 1) != 1:
            raise ValueError("only n=1 is supported")
        prompt_ids = engine.encode_chat(messages)
        structured = inspect_request(body)
        sampling = _sampling_from(body,
                                  deadline_ms=_deadline_from(self.headers))
        tool_name = None
        if structured is not None:
            sampling.constraint = structured.spec
            tool_name = structured.tool_name
        model = body.get("model") or engine.model_id
        adapter, base = _parse_lora(engine, body)
        if adapter is not None:
            sampling.lora = adapter
            model = base or model
        return prompt_ids, sampling, _stops_from(body), tool_name, model

    def _chat(self, body: dict) -> None:
        try:
            prompt_ids, sampling, stops, tool_name, model = self._parse_chat(
                body)
            deltas = self.server.engine.stream(
                prompt_ids, sampling, stops, request_id=self._request_id())
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        self._answer_chat(body, deltas, model, len(prompt_ids), tool_name)

    def _resume(self, body: dict) -> None:
        """POST /v1/resume: the original chat body plus `committed_ids`, the
        tokens the client already holds, and optionally `kv_pages`, the
        origin's export, landed instead of replaying when this pool can take
        it. The stream continues from them token-identical to an
        uninterrupted run, and the full completion (committed text
        included) is answered in the chat shape; the gateway cuts what its
        client has."""
        committed = body.get("committed_ids")
        if committed is None:
            committed = []
        if not isinstance(committed, list) or any(
                isinstance(t, bool) or not isinstance(t, int)
                for t in committed):
            self._error(400, "'committed_ids' must be a list of token ids")
            return
        try:
            prompt_ids, sampling, stops, tool_name, model = self._parse_chat(
                body)
            kv_pages = body.get("kv_pages")
            deltas = self.server.engine.adopt_stream(
                prompt_ids, committed, sampling, stops,
                request_id=self._request_id(),
                kv_pages=kv_pages if isinstance(kv_pages, dict) else None)
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        self._answer_chat(body, deltas, model, len(prompt_ids), tool_name)

    def _handoff_prefill(self, body: dict) -> None:
        """POST /v1/handoff/prefill: the prefill half of the cross-process
        handoff. A chat body plus `handoff_tokens`; the engine prefills and
        commits that many tokens, and the answer's `handoff` is the wire
        payload for a decode engine's /v1/handoff, which streams the full
        completion. `finish` is null while the stream has more to generate,
        else its natural finish inside the window (the adopter then
        reproduces it), so a caller needs one shape."""
        engine = self.server.engine
        if engine.core.role == "decode":
            self._error(409, "this engine serves --role decode; it adopts "
                        "handoffs (/v1/handoff) but does not originate them")
            return
        try:
            prompt_ids, sampling, stops, tool_name, model = self._parse_chat(
                body)
            emit = _handoff_tokens_from(body)
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        rid = self._request_id()
        try:
            committed, finish, kv_pages = engine.prefill_handoff(
                prompt_ids, sampling, emit_tokens=emit, request_id=rid)
        except EngineError as e:
            self._error(500, str(e), "server_error")
            return
        except ValueError as e:
            self._error(400, str(e))
            return
        payload = handoff_payload(
            prompt_ids, committed, sampling, stop=stops, request_id=rid,
            kv_pages=kv_pages if finish is None else None)
        self._json(200, {"object": "llmlb.handoff", "model": model,
                         "handoff": payload, "finish": finish,
                         "tool_name": tool_name,
                         "usage": _usage(len(prompt_ids), len(committed))})

    def _handoff(self, body: dict) -> None:
        """POST /v1/handoff: adopt a stream a prefill engine started.
        `{"handoff": <wire payload>, "stream", "model", "tool_name"}`. The
        stream continues by the exact resume (or lands the payload's
        `kv_pages` when this pool can take them), token-identical to an
        uninterrupted run, and the answer carries the full completion in
        the chat shape. The X-Request-Deadline-Ms header (the gateway's
        remaining budget) overrides the wire's deadline."""
        engine = self.server.engine
        try:
            prompt_ids, committed, sampling, stops, wire_rid, t0 = (
                parse_handoff(body.get("handoff")))
        except HandoffError as e:
            self._error(400, str(e))
            return
        tool_name = body.get("tool_name")
        if tool_name is not None and not isinstance(tool_name, str):
            self._error(400, "'tool_name' must be a string")
            return
        model = body.get("model") or engine.model_id
        rid = self._request_id() or wire_rid
        try:
            deadline = _deadline_from(self.headers)
        except ValueError as e:
            self._error(400, str(e))
            return
        if deadline is not None:
            sampling.deadline_ms = deadline
        # anything but an object is no attachment: the adoption replays
        kv_pages = body["handoff"].get("kv_pages")
        try:
            deltas = engine.adopt_stream(
                prompt_ids, committed, sampling, stops, request_id=rid,
                kv_pages=kv_pages if isinstance(kv_pages, dict) else None,
                emitted_at=t0)
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        self._answer_chat(body, deltas, model, len(prompt_ids), tool_name)

    def _answer_chat(self, body: dict, deltas, model: str,
                     prompt_tokens: int, tool_name: str | None = None) -> None:
        completion_id = f"chatcmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())
        if body.get("stream"):
            include_usage = bool(
                (body.get("stream_options") or {}).get("include_usage", True))
            self._stream_chat(deltas, completion_id, created, model,
                              prompt_tokens, include_usage,
                              replay=bool(body.get("llmlb_replay")),
                              tool_name=tool_name)
            return
        final = self._collect(deltas)
        if final is None:
            return
        finish = final.finish_reason
        if tool_name is not None:
            # a forced tool call: the constrained text is its arguments
            message = {"role": "assistant", "content": None, "tool_calls": [{
                "id": f"call_{uuid.uuid4().hex[:24]}", "type": "function",
                "function": {"name": tool_name, "arguments": final.text}}]}
            finish = "tool_calls" if finish == "stop" else finish
        else:
            message = {"role": "assistant", "content": final.text}
        self._json(200, {
            "id": completion_id,
            "object": "chat.completion",
            "created": created,
            "model": model,
            "system_fingerprint": SYSTEM_FINGERPRINT,
            "choices": [{"index": 0, "message": message,
                         "finish_reason": finish}],
            "usage": _usage(final.prompt_tokens, final.completion_tokens),
        })

    def _collect(self, deltas):
        """The whole completion of a delta stream (the final delta with the
        full text), or None after answering 500 for an engine error."""
        text, final = [], None
        try:
            for delta in deltas:
                text.append(delta.text)
                if delta.finish_reason is not None:
                    final = delta
        except EngineError as e:
            self._error(500, str(e), "server_error")
            return None
        final.text = "".join(text)
        return final

    def _stream_chat(self, deltas, completion_id: str, created: int,
                     model: str, prompt_tokens: int,
                     include_usage: bool, replay: bool = False,
                     tool_name: str | None = None) -> None:
        self._start_sse()

        def chunk(delta: dict, finish: str | None = None) -> dict:
            return {
                "id": completion_id,
                "object": "chat.completion.chunk",
                "created": created,
                "model": model,
                "system_fingerprint": SYSTEM_FINGERPRINT,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}],
            }

        usage = _usage(prompt_tokens, 0)
        finish = "stop"
        try:
            self._sse(chunk({"role": "assistant", "content": ""}))
            if tool_name is not None:
                # a forced tool call: the first tool delta opens the call
                # (id and name), the constrained arguments follow as
                # fragments
                self._sse(chunk({"tool_calls": [{
                    "index": 0, "id": f"call_{uuid.uuid4().hex[:24]}",
                    "type": "function",
                    "function": {"name": tool_name, "arguments": ""}}]}))
            try:
                for delta in deltas:
                    if replay and delta.token_ids:
                        # the committed ids before the text they produced:
                        # the gateway's ledger for a mid-stream resume
                        self._sse({"object": "llmlb.replay",
                                   "tokens": [int(t)
                                              for t in delta.token_ids]})
                    if delta.text and tool_name is not None:
                        self._sse(chunk({"tool_calls": [{
                            "index": 0,
                            "function": {"arguments": delta.text}}]}))
                    elif delta.text:
                        self._sse(chunk({"content": delta.text}))
                    if delta.finish_reason is not None:
                        finish = delta.finish_reason
                        usage = _usage(delta.prompt_tokens,
                                       delta.completion_tokens)
            except EngineError as e:
                self._sse({"error": {"message": str(e)}})
                self._sse("[DONE]")
                return
            if tool_name is not None and finish == "stop":
                finish = "tool_calls"
            self._sse(chunk({}, finish))
            if include_usage:
                final = chunk({}, None)
                final["choices"] = []
                final["usage"] = usage
                self._sse(final)
            self._sse("[DONE]")
        except OSError:
            # client gone, or the drain shut the socket down: cancel the
            # request (a parked one is ended by the drain's flush)
            deltas.close()

    # ----------------------------------------------------------- completions

    def _completions(self, body: dict) -> None:
        engine = self.server.engine
        prompt = body.get("prompt")
        if isinstance(prompt, list):
            if len(prompt) != 1 or not isinstance(prompt[0], str):
                self._error(400, "only a single string prompt is supported")
                return
            prompt = prompt[0]
        if not isinstance(prompt, str) or not prompt:
            self._error(400, "'prompt' must be a non-empty string")
            return
        model = body.get("model") or engine.model_id
        prompt_ids = engine.tokenizer.encode(prompt)
        try:
            sampling = _sampling_from(
                body, default_max=16, deadline_ms=_deadline_from(self.headers))
            adapter, base = _parse_lora(engine, body)
            if adapter is not None:
                sampling.lora = adapter
                model = base or model
            deltas = engine.stream(prompt_ids, sampling, _stops_from(body),
                                   request_id=self._request_id())
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        completion_id = f"cmpl-{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        def chunk(text: str, finish: str | None) -> dict:
            return {"id": completion_id, "object": "text_completion",
                    "created": created, "model": model,
                    "choices": [{"index": 0, "text": text,
                                 "finish_reason": finish}]}

        if not body.get("stream"):
            final = self._collect(deltas)
            if final is not None:
                out = chunk(final.text, final.finish_reason)
                out["usage"] = _usage(final.prompt_tokens,
                                      final.completion_tokens)
                self._json(200, out)
            return
        self._start_sse()
        usage = _usage(len(prompt_ids), 0)
        finish = "stop"
        try:
            try:
                for delta in deltas:
                    if delta.finish_reason is not None:
                        finish = delta.finish_reason
                        usage = _usage(delta.prompt_tokens,
                                       delta.completion_tokens)
                    if delta.text:
                        self._sse(chunk(delta.text, None))
            except EngineError as e:
                self._sse({"error": {"message": str(e)}})
                self._sse("[DONE]")
                return
            last = chunk("", finish)
            last["usage"] = usage
            self._sse(last)
            self._sse("[DONE]")
        except OSError:
            deltas.close()  # client gone: cancel the request

    # ------------------------------------------------------------- responses

    def _responses(self, body: dict) -> None:
        """The OpenAI Responses API over the chat path."""
        engine = self.server.engine
        model = body.get("model") or engine.model_id
        input_ = body.get("input")
        if isinstance(input_, str):
            messages = [{"role": "user", "content": input_}]
        elif isinstance(input_, list):
            messages = [{"role": m.get("role", "user"),
                         "content": m.get("content", "")}
                        for m in input_ if isinstance(m, dict)]
        else:
            self._error(400, "'input' must be a string or message array")
            return
        if body.get("instructions"):
            messages = ([{"role": "system", "content": body["instructions"]}]
                        + messages)
        try:
            prompt_ids = engine.encode_chat(messages)
            sampling = _sampling_from(
                body, deadline_ms=_deadline_from(self.headers))
            deltas = engine.stream(prompt_ids, sampling, _stops_from(body),
                                   request_id=self._request_id())
        except (ValueError, TypeError) as e:
            self._error(400, str(e))
            return
        response_id = f"resp_{uuid.uuid4().hex[:24]}"
        created = int(time.time())

        def envelope(status: str, text: str, usage: dict | None) -> dict:
            return {
                "id": response_id,
                "object": "response",
                "created_at": created,
                "status": status,
                "model": model,
                "output": [{
                    "type": "message",
                    "id": f"msg_{response_id}",
                    "role": "assistant",
                    "status": status,
                    "content": [{"type": "output_text", "text": text,
                                 "annotations": []}],
                }],
                "usage": usage or {"input_tokens": 0, "output_tokens": 0,
                                   "total_tokens": 0},
            }

        def usage_of(delta) -> dict:
            return {"input_tokens": delta.prompt_tokens,
                    "output_tokens": delta.completion_tokens,
                    "total_tokens": (delta.prompt_tokens
                                     + delta.completion_tokens)}

        if not body.get("stream"):
            final = self._collect(deltas)
            if final is not None:
                self._json(200, envelope("completed", final.text,
                                         usage_of(final)))
            return
        self._start_sse()
        try:
            self._event("response.created", {
                "type": "response.created",
                "response": envelope("in_progress", "", None)})
            parts: list[str] = []
            usage = None
            try:
                for delta in deltas:
                    if delta.text:
                        parts.append(delta.text)
                        self._event("response.output_text.delta", {
                            "type": "response.output_text.delta",
                            "item_id": f"msg_{response_id}",
                            "output_index": 0, "content_index": 0,
                            "delta": delta.text})
                    if delta.finish_reason is not None:
                        usage = usage_of(delta)
            except EngineError as e:
                self._event("response.failed", {
                    "type": "response.failed",
                    "response": {"id": response_id, "object": "response",
                                 "status": "failed",
                                 "error": {"message": str(e)}}})
                return
            self._event("response.completed", {
                "type": "response.completed",
                "response": envelope("completed", "".join(parts), usage)})
        except OSError:
            deltas.close()  # client gone: cancel the request

    # ------------------------------------------------------------ embeddings

    def _embeddings(self, body: dict) -> None:
        """OpenAI /v1/embeddings: `input` is a string, a list of strings, or
        token id lists."""
        engine = self.server.engine
        raw = body.get("input")
        if raw is None:
            self._error(400, "'input' is required")
            return
        if isinstance(raw, str):
            inputs = [raw]
        elif isinstance(raw, list) and raw and all(
                isinstance(x, int) for x in raw):
            inputs = [raw]  # one pre-tokenized input
        elif isinstance(raw, list) and raw:
            inputs = raw
        else:
            self._error(400, "'input' must be a non-empty string or array")
            return
        batch_ids: list[list[int]] = []
        for item in inputs:
            if isinstance(item, str):
                batch_ids.append(engine.tokenizer.encode(item))
            elif isinstance(item, list) and all(isinstance(x, int)
                                                for x in item):
                batch_ids.append([int(x) for x in item])
            else:
                self._error(400, "each input must be a string or token array")
                return
        try:
            vectors = engine.embed(batch_ids)
        except ValueError as e:
            self._error(400, str(e))
            return
        prompt_tokens = sum(len(x) for x in batch_ids)
        self._json(200, {
            "object": "list",
            "model": body.get("model", engine.model_id),
            "data": [{"object": "embedding", "index": i, "embedding": vec}
                     for i, vec in enumerate(vectors)],
            "usage": {"prompt_tokens": prompt_tokens,
                      "total_tokens": prompt_tokens},
        })

    def _transcriptions(self, fields: dict) -> None:
        """OpenAI /v1/audio/transcriptions: the WAV `file` part -> text
        (the other parts, model and language among them, are read and
        ignored, as in the reference)."""
        data = fields.get("file")
        if not data:
            self._error(400, "'file' part is required")
            return
        try:
            text = self.server.asr.transcribe_wav_bytes(data)
        except (ValueError, EOFError) as e:
            self._error(400, f"could not decode audio: {e}")
            return
        self._json(200, {"text": text})

    def _speech(self, body: dict) -> None:
        """OpenAI /v1/audio/speech: {input, voice, speed} -> WAV bytes."""
        text = body.get("input")
        if not isinstance(text, str) or not text:
            self._error(400, "'input' is required")
            return
        voice = str(body.get("voice", "alloy"))
        try:
            speed = float(body.get("speed", 1.0))
            wav = self.server.tts.synthesize(text, voice, speed)
        except (TypeError, ValueError) as e:
            self._error(400, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", "audio/wav")
        self.send_header("Content-Length", str(len(wav)))
        self.end_headers()
        self.wfile.write(wav)

    def _images(self, body: dict) -> None:
        """OpenAI /v1/images/generations: {prompt, n} -> base64 PNGs."""
        prompt = body.get("prompt")
        if not isinstance(prompt, str) or not prompt:
            self._error(400, "'prompt' is required")
            return
        n = body.get("n", 1)
        if not isinstance(n, int) or not 1 <= n <= 10:
            self._error(400, "'n' must be between 1 and 10")
            return
        try:
            images = self.server.image.generate_b64(prompt, n)
        except ValueError as e:
            self._error(400, str(e))
            return
        self._json(200, {"created": int(time.time()),
                         "data": [{"b64_json": b} for b in images]})


def _models(engine: Engine, services=None) -> list[dict]:
    """The /v1/models entries, with the reference's capabilities: the base
    model, with `structured_outputs` (grammar-constrained decoding; the
    gateway steers constrained requests by it), `embeddings` when the
    model family has an `encode` forward (Llama does, Mixtral does not:
    /v1/embeddings then answers 400) and `lora` when adapters are on
    ("this endpoint can load any adapter of its store"), then one
    `base:adapter` entry per RESIDENT adapter (without `embeddings`: the
    encode forward applies no adapter), so the gateway routes adapter
    traffic where it is already loaded. The serving role rides the
    capabilities, `prefill` and `decode` (both for "both" and "split"),
    and every entry's `role` key: the gateway's role-aware routing reads
    them. `services` (the server) adds an entry for each multimodal
    service it holds, with its one capability."""
    caps = ["chat_completion", "structured_outputs"]
    if engine.supports_embeddings():
        caps.append("embeddings")
    role = engine.core.role
    if role in ("both", "split", "prefill"):
        caps.append("prefill")
    if role in ("both", "split", "decode"):
        caps.append("decode")
    lora = engine.core.lora
    if lora is not None:
        caps.append("lora")

    def entry(model_id: str, caps: list[str]) -> dict:
        return {"id": model_id, "object": "model", "created": 0,
                "owned_by": "llmlb_tpu_torch", "capabilities": caps}

    data = [{**entry(engine.model_id, list(caps)), "role": role}]
    if lora is not None:
        for name in lora.resident_names():
            data.append({**entry(f"{engine.model_id}:{name}",
                                 [c for c in caps if c != "embeddings"]),
                         "role": role, "lora": name})
    for attr, cap in (("asr", "audio_transcription"), ("tts", "audio_speech"),
                      ("image", "image_generation")):
        service = getattr(services, attr, None)
        if service is not None:
            data.append(entry(service.model_id, [cap]))
    return data


def _parse_lora(engine: Engine, body: dict) -> tuple[str | None, str | None]:
    """(adapter, base model) of a body, validated against the engine's
    adapter store; ValueError naming the `lora` field otherwise. A `:suffix`
    counts only on a LoRA-enabled engine."""
    lora = engine.core.lora
    if body.get("lora") is None and lora is None:
        return None, None
    if lora is None:
        raise ValueError("'lora' adapters are not enabled on this engine "
                         "(start it with --lora-dir)")
    base, adapter = adapter_from_body(body)
    if adapter is None:
        return None, None
    lora.validate(adapter)
    return adapter, base


def start_server(engine: Engine, host: str = "127.0.0.1", port: int = 0, *,
                 asr=None, tts=None,
                 image=None) -> tuple[EngineHTTPServer, threading.Thread]:
    """Serve `engine` (and the multimodal services given) from a
    background thread; port 0 picks a free port (read it from
    `server.server_address`). Stop with server.shutdown();
    `server.drain.start(grace_s)` drains first."""
    server = EngineHTTPServer((host, port), engine, asr=asr, tts=tts,
                              image=image)
    thread = threading.Thread(target=server.serve_forever,
                              name="engine-http", daemon=True)
    thread.start()
    return server, thread


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="llmlb_tpu_torch inference engine (PyTorch/CUDA)")
    parser.add_argument("--preset", default="debug-tiny")
    parser.add_argument(
        "--checkpoint", default=None,
        help="HF checkpoint directory (config.json, safetensors shards and "
             "the tokenizer's files; the tokenizer needs `transformers`) "
             "served in place of the preset's random weights")
    parser.add_argument("--model-id", default=None)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8100)
    parser.add_argument("--num-slots", type=int, default=8)
    parser.add_argument("--slot-capacity", type=int, default=4096)
    parser.add_argument(
        "--prefill-buckets", default=None,
        help="comma-separated one-shot prefill lengths (default 32..512); "
             "prompts beyond the largest run through chunked prefill")
    parser.add_argument(
        "--prefill-chunk-budget", type=int, default=None,
        help="max prompt tokens prefilled per step-loop iteration while "
             "other slots decode (default 0 = uncapped; also via "
             "LLMLB_PREFILL_CHUNK_BUDGET); with a budget, prompts longer "
             "than its bucket always run in chunks of that bucket")
    parser.add_argument("--kv-page-size", type=int, default=None,
                        help="tokens per KV page (default 128)")
    parser.add_argument("--kv-pages", type=int, default=None,
                        help="total pages in the pool (default: every slot's "
                             "full capacity plus the trash page)")
    parser.add_argument("--decode-burst", type=int, default=None,
                        help="decode+sample steps per host sync (default 8 on "
                             "the card, 1 on the CPU)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and the sampler")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument(
        "--init-timeout", type=float, default=None,
        help="seconds the CUDA init probe may take before the server exits "
             "with its evidence (default LLMLB_INIT_TIMEOUT or 600; 0 skips "
             "the probe)")
    parser.add_argument(
        "--quantize", choices=("off", "weights", "kv", "all"), default=None,
        help="int8 quantization (default off; also via LLMLB_QUANTIZE): "
             "'weights' = per-output-channel int8 projection weights, 'kv' "
             "= int8 KV pages with per-vector scales, 'all' = both")
    parser.add_argument(
        "--kv-layout", choices=("paged", "dense"), default=None,
        help="KV cache layout (default paged; also via LLMLB_KV_LAYOUT): "
             "'dense' keeps one contiguous row of --slot-capacity positions "
             "per slot")
    parser.add_argument(
        "--lora-dir", default=None,
        help="directory of LoRA adapters in the HF/PEFT layout, one "
             "subdirectory each (also via LLMLB_LORA_DIR); enables the "
             "'lora' request field and 'model:adapter' names")
    parser.add_argument("--lora-max-adapters", type=int, default=None,
                        help="resident adapter rows of the pool (default 8; "
                             "LLMLB_LORA_MAX_ADAPTERS)")
    parser.add_argument("--lora-rank-cap", type=int, default=None,
                        help="largest adapter rank served, the pool's rank "
                             "(default 16; LLMLB_LORA_RANK_CAP)")
    parser.add_argument(
        "--prefix-cache", choices=("on", "off"), default=None,
        help="radix-tree prefix KV reuse across requests (default on; also "
             "via LLMLB_PREFIX_CACHE=0)")
    parser.add_argument(
        "--prefix-cache-slots", type=int, default=None,
        help="most prefix donors held at once (default num_slots // 2, "
             "always leaving one serving slot)")
    parser.add_argument(
        "--min-prefix-len", type=int, default=None,
        help="shortest prompt prefix worth caching, in tokens (default: "
             "the cache's alignment)")
    parser.add_argument(
        "--role", choices=ROLES, default=None,
        help="serving role (default both; also via LLMLB_ROLE): 'split' runs "
             "a prefill pool and a decode pool as two step loops over one "
             "paged KV pool, handing a request off by its block-table row; "
             "'prefill' / 'decode' advertise a cross-process role to the "
             "gateway, which prefills on a prefill engine "
             "(/v1/handoff/prefill) and hands the stream to a decode engine "
             "(/v1/handoff)")
    parser.add_argument(
        "--disagg-prefill-slots", type=int, default=None,
        help="slots of the prefill pool under --role split (default "
             "num_slots // 4, at least 1; also via "
             "LLMLB_DISAGG_PREFILL_SLOTS); the rest form the decode pool")
    parser.add_argument(
        "--spec-decode", choices=("on", "off"), default=None,
        help="speculative decoding default for requests without their own "
             "'speculative' knob (default off; also via LLMLB_SPEC_DECODE): "
             "prompt-lookup drafting and one K+1-token verify step")
    parser.add_argument(
        "--spec-max-draft", type=int, default=None,
        help="max draft tokens per verify step (default 4, cap 16; also via "
             "LLMLB_SPEC_MAX_DRAFT): the verify chunk's width")
    parser.add_argument(
        "--spec-ngram", type=int, default=None,
        help="longest n-gram the prompt-lookup drafter matches on (default "
             "3; also via LLMLB_SPEC_NGRAM)")
    # modality services (checkpoint dir, or "random" for test weights)
    parser.add_argument("--asr", default=None,
                        help="whisper checkpoint dir or 'random'")
    parser.add_argument("--tts", default=None,
                        help="TTS checkpoint dir or 'random'")
    parser.add_argument("--image", default=None,
                        help="diffusion checkpoint dir or 'random'")
    return parser


def services_from(args: argparse.Namespace) -> dict:
    """The multimodal services the --asr, --tts and --image flags name (a
    checkpoint directory, or "random" for the reference's small random
    models), on the server's device."""
    from llmlb_tpu_torch.engine.asr import AsrEngine
    from llmlb_tpu_torch.engine.image import ImageEngine
    from llmlb_tpu_torch.engine.tts import TtsEngine

    services = {}
    for name, cls in (("asr", AsrEngine), ("tts", TtsEngine),
                      ("image", ImageEngine)):
        where = getattr(args, name)
        if where:
            services[name] = (cls.from_random(device=args.device)
                              if where == "random"
                              else cls.from_checkpoint(where,
                                                       device=args.device))
    return services


def core_kwargs_from(args: argparse.Namespace) -> dict:
    """The EngineCore keywords of parsed server arguments (flags left unset
    leave the core's own default or environment variable in charge)."""
    core_kwargs = dict(num_slots=args.num_slots,
                       slot_capacity=args.slot_capacity, seed=args.seed,
                       kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
                       decode_burst=args.decode_burst,
                       quantize=args.quantize, kv_layout=args.kv_layout,
                       lora_dir=args.lora_dir,
                       lora_max_adapters=args.lora_max_adapters,
                       lora_rank_cap=args.lora_rank_cap)
    if args.prefix_cache is not None:
        core_kwargs["prefix_cache"] = args.prefix_cache == "on"
    if args.prefix_cache_slots is not None:
        core_kwargs["prefix_cache_slots"] = max(0, args.prefix_cache_slots)
    if args.min_prefix_len is not None:
        core_kwargs["min_prefix_len"] = max(1, args.min_prefix_len)
    if args.role is not None:
        core_kwargs["role"] = args.role
    if args.disagg_prefill_slots is not None:
        core_kwargs["disagg_prefill_slots"] = max(
            1, args.disagg_prefill_slots)
    if args.prefill_buckets:
        core_kwargs["prefill_buckets"] = tuple(
            int(b) for b in args.prefill_buckets.split(","))
    if args.prefill_chunk_budget is not None:
        core_kwargs["prefill_chunk_budget"] = max(0, args.prefill_chunk_budget)
    if args.spec_decode is not None:
        core_kwargs["spec_decode"] = args.spec_decode == "on"
    if args.spec_max_draft is not None:
        core_kwargs["spec_max_draft"] = max(1, args.spec_max_draft)
    if args.spec_ngram is not None:
        core_kwargs["spec_ngram"] = max(1, args.spec_ngram)
    return core_kwargs


def main(argv: list[str] | None = None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    core_kwargs = core_kwargs_from(args)
    if not args.device.startswith("cpu"):
        # before the first in-process CUDA call: a card that does not come
        # up exits here with the probe's evidence, never on the CPU
        guard_backend_init(args.init_timeout)
    # Multi-rank bring-up before the engine exists (it reads the world
    # size); a no-op unless LLMLB_COORDINATOR / LLMLB_NUM_HOSTS /
    # LLMLB_HOST_ID or LLMLB_DISTRIBUTED are set.
    init_from_env(args.device)
    if args.checkpoint:
        engine = Engine.from_checkpoint(args.checkpoint,
                                        model_id=args.model_id,
                                        device=args.device, **core_kwargs)
    else:
        engine = Engine.from_preset(args.preset, model_id=args.model_id,
                                    device=args.device, **core_kwargs)
    coordinator = engine.core.coordinator
    if coordinator is not None and not coordinator.is_leader:
        # A follower rank: its step thread runs the lockstep loop, running
        # the forwards the leader plans; HTTP belongs to the leader. It
        # returns when the leader's plan says stop.
        log.info("multi-rank follower %d: serving loop only (the leader "
                 "owns HTTP)", engine.core.mesh.rank)
        engine.core._thread.join()
        engine.shutdown()
        return
    server = EngineHTTPServer((args.host, args.port), engine,
                              **services_from(args))

    def drain_then_stop() -> None:
        server.drain.start()
        server.drain.wait()
        server.shutdown()

    # SIGTERM drains (the grace for in-flight work, then parks and socket
    # cuts for the gateway to resume) before the server and engine stop
    signal.signal(signal.SIGTERM, lambda signum, frame: threading.Thread(
        target=drain_then_stop, name="engine-sigterm", daemon=True).start())
    log.info("serving %s on http://%s:%d (%s)", engine.model_id,
             *server.server_address[:2], engine.core.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.shutdown()


if __name__ == "__main__":
    main()
