"""Request-lifecycle tracing: gateway → balancer → engine.

Every inbound request gets a trace id (a client-supplied ``X-Request-Id``
is reused when well-formed, otherwise one is minted), echoed on the
response so clients can correlate their logs with gateway traces.
Inference requests additionally record ordered spans — ``auth``,
``admission``, ``queue_wait``, ``endpoint_select``, ``proxy``,
``first_token``, ``decode``, ``done`` — with monotonic timestamps, and the
id is forwarded on the proxied call via ``X-Request-Id`` so the engine
scheduler's ``request_id`` joins the same trace. Completed traces live in
a bounded ring buffer served at ``GET /api/traces`` (+ ``/{id}``) and are
announced on the dashboard event bus as ``TraceCompleted`` events.

Cross-process timelines (docs/tracing.md): ``/api/traces/{id}?view=timeline``
joins the gateway's own spans with the flight-recorder events of EVERY
engine the request touched — the selection target plus any handoff
adopter and resume target named by span attrs — fetched live from each
engine's ``GET /api/requests/{id}/timeline`` and merged into one causally
ordered event list. ``?format=chrome`` exports the same merge as Chrome
trace-event JSON loadable in Perfetto (chrome://tracing).

Multi-worker lookup: SO_REUSEPORT hands ``/api/traces/{id}`` to an
arbitrary worker, which 404s when a sibling served the request. With a
spool directory configured (the gossip dir, automatic under multi-worker),
completed traces are spooled as one JSON file each and any worker answers
for any sibling — the /metrics spool's sibling-merge pattern. The port's
copy of llmlb_tpu/gateway/tracing.py, with its ``TraceCompleted`` events.

No reference counterpart: the reference router only logs per-request
lines. This is the shared spine later perf PRs measure themselves
against — TTFT vs queue wait vs engine step time, per request.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
import uuid
from collections import OrderedDict, deque

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.http import web

REQUEST_ID_HEADER = "X-Request-Id"

# Client-supplied ids are echoed into headers, logs, and label-adjacent
# places; anything outside this shape is replaced, not trusted.
_ID_RE = re.compile(r"^[A-Za-z0-9_.:\-]{1,128}$")

# Canonical lifecycle order, used by consumers (dashboard, tests) to lay
# spans out; traces may omit phases a request never reached.
SPAN_ORDER = ("auth", "admission", "queue_wait", "endpoint_select", "proxy",
              "first_token", "decode", "done")


def mint_request_id(raw: str | None) -> str:
    if raw and _ID_RE.match(raw):
        return raw
    return uuid.uuid4().hex


class TokenTimeline:
    """Bounded per-request token timing marks for streamed responses: one
    monotonic stamp per SSE data chunk that reached the client. Attached to
    the request's trace, it shows WHERE a slow stream stalled (a late first
    mark = prefill/queueing; a gap mid-stream = a slow step, page-pool
    eviction, or an engine hiccup) — the per-request view the ITL histogram
    averages away. Cost: one clock read + one list append per chunk, capped
    at MAX_MARKS; marks beyond the cap keep counting but record nothing."""

    MAX_MARKS = 256

    def __init__(self):
        self.marks: list[float] = []
        self.count = 0

    def mark(self) -> None:
        self.count += 1
        if len(self.marks) < self.MAX_MARKS:
            self.marks.append(time.monotonic())

    def payload(self, trace_t0: float) -> dict:
        """JSON block for the trace: offsets from request arrival (ms),
        plus the largest inter-mark gap — the stall, pre-located."""
        marks_ms = [round((m - trace_t0) * 1000.0, 3) for m in self.marks]
        max_gap = 0.0
        for a, b in zip(marks_ms, marks_ms[1:]):
            max_gap = max(max_gap, b - a)
        return {
            "chunks": self.count,
            "truncated": self.count > len(self.marks),
            "first_ms": marks_ms[0] if marks_ms else None,
            "last_ms": marks_ms[-1] if marks_ms else None,
            "max_gap_ms": round(max_gap, 3),
            "marks_ms": marks_ms,
        }


class RequestTrace:
    """Ordered spans over one request's lifetime. Touched only from the
    event loop; durations come from one monotonic clock."""

    def __init__(self, trace_id: str, method: str, path: str):
        self.trace_id = trace_id
        self.method = method
        self.path = path
        self.started_at = time.time()
        self.t0 = time.monotonic()
        self.model: str | None = None
        self.endpoint_id: str | None = None
        self.endpoint_name: str | None = None
        self.status: int | None = None
        self.error: str | None = None
        self.duration_ms: float | None = None
        self.spans: list[dict] = []
        self._open: dict[str, int] = {}  # name -> index into spans
        # sampled streamed-token timeline (TokenTimeline.payload shape)
        self.token_timeline: dict | None = None

    # --------------------------------------------------------------- spans

    def begin(self, name: str) -> None:
        if name in self._open:
            return
        self._open[name] = len(self.spans)
        self.spans.append({
            "name": name,
            "start_ms": round((time.monotonic() - self.t0) * 1000.0, 3),
            "duration_ms": None,
        })

    def end(self, name: str) -> None:
        idx = self._open.pop(name, None)
        if idx is None:
            return
        span = self.spans[idx]
        now_ms = (time.monotonic() - self.t0) * 1000.0
        span["duration_ms"] = round(max(0.0, now_ms - span["start_ms"]), 3)

    def mark(self, name: str, **attrs) -> None:
        """Point-in-time span (duration 0)."""
        span = {
            "name": name,
            "start_ms": round((time.monotonic() - self.t0) * 1000.0, 3),
            "duration_ms": 0.0,
        }
        if attrs:
            span["attrs"] = attrs
        self.spans.append(span)

    def add_span(self, name: str, *, start_monotonic: float,
                 duration_s: float, **attrs) -> None:
        """Span with caller-measured bounds (e.g. queue_wait from the
        admission queue's own waited_s)."""
        span = {
            "name": name,
            "start_ms": round((start_monotonic - self.t0) * 1000.0, 3),
            "duration_ms": round(max(0.0, duration_s) * 1000.0, 3),
        }
        if attrs:
            span["attrs"] = attrs
        self.spans.append(span)

    def set_endpoint(self, endpoint) -> None:
        self.endpoint_id = endpoint.id
        self.endpoint_name = endpoint.name

    # -------------------------------------------------------------- finish

    def finish(self, status: int, error: str | None = None) -> None:
        now_ms = (time.monotonic() - self.t0) * 1000.0
        for name in list(self._open):
            self.end(name)
        self.status = status
        self.error = error
        self.duration_ms = round(now_ms, 3)
        self.spans.sort(key=lambda s: s["start_ms"])
        self.spans.append({
            "name": "done", "start_ms": round(now_ms, 3), "duration_ms": 0.0,
        })

    def attach_timeline(self, timeline: "TokenTimeline") -> None:
        if timeline.count:
            self.token_timeline = timeline.payload(self.t0)

    def to_dict(self) -> dict:
        d = {
            "trace_id": self.trace_id,
            "method": self.method,
            "path": self.path,
            "started_at": self.started_at,
            "model": self.model,
            "endpoint_id": self.endpoint_id,
            "endpoint_name": self.endpoint_name,
            "status": self.status,
            "error": self.error,
            "duration_ms": self.duration_ms,
            "spans": self.spans,
        }
        if self.token_timeline is not None:
            d["token_timeline"] = self.token_timeline
        return d


class TraceStore:
    """Bounded ring of completed traces + the in-flight set. Thread-safe:
    completion may be observed from bench/scrape threads.

    `spool_dir` (multi-worker): completed traces are additionally written
    as one JSON file each so sibling workers sharing the directory can
    answer `/api/traces/{id}` for requests they never served."""

    SPOOL_RETENTION_S = 600.0
    _SPOOL_PRUNE_EVERY = 64

    def __init__(self, capacity: int = 256, events=None,
                 timeline_interval: int | None = None,
                 spool_dir: str | None = None):
        self.capacity = max(1, capacity)
        self._events = events  # DashboardEventBus | None
        self._lock = threading.Lock()
        self._active: "OrderedDict[str, RequestTrace]" = OrderedDict()
        self._done: deque[RequestTrace] = deque(maxlen=self.capacity)
        self.spool_dir = spool_dir
        self.spool_errors_total = 0
        self._spool_writes = 0
        # token-timeline sampling: every Nth streamed request carries marks
        # (1 = all streams, 0 = none; LLMLB_TRACE_TIMELINE_SAMPLE)
        if timeline_interval is None:
            try:
                timeline_interval = int(
                    os.environ.get("LLMLB_TRACE_TIMELINE_SAMPLE", "1")
                )
            except ValueError:
                timeline_interval = 1
        self.timeline_interval = max(0, timeline_interval)
        self._timeline_seen = 0

    def sample_timeline(self) -> bool:
        """Decide (round-robin over streamed requests) whether this stream
        records a TokenTimeline — bounded cost under sampling pressure."""
        if self.timeline_interval <= 0:
            return False
        with self._lock:
            self._timeline_seen += 1
            return (self._timeline_seen - 1) % self.timeline_interval == 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._done)

    def start(self, trace_id: str, method: str, path: str) -> RequestTrace:
        trace = RequestTrace(trace_id, method, path)
        with self._lock:
            # A reused client id replaces any stale in-flight entry rather
            # than leaking it.
            self._active[trace.trace_id] = trace
            while len(self._active) > self.capacity:
                self._active.popitem(last=False)
        return trace

    def finish(self, trace: RequestTrace, status: int,
               error: str | None = None) -> None:
        trace.finish(status, error)
        with self._lock:
            # Identity check: a reused client id may have replaced this
            # trace's slot with a newer in-flight trace — don't evict it.
            if self._active.get(trace.trace_id) is trace:
                del self._active[trace.trace_id]
            self._done.append(trace)
        if self.spool_dir:
            self._spool(trace)
        if self._events is not None:
            self._events.publish("TraceCompleted", {
                "trace_id": trace.trace_id,
                "path": trace.path,
                "model": trace.model,
                "endpoint_id": trace.endpoint_id,
                "status": status,
                "duration_ms": trace.duration_ms,
            })

    def get(self, trace_id: str) -> dict | None:
        with self._lock:
            trace = self._active.get(trace_id)
            if trace is not None:
                d = trace.to_dict()
                d["in_flight"] = True
                return d
            for t in self._done:
                if t.trace_id == trace_id:
                    d = t.to_dict()
                    d["in_flight"] = False
                    return d
        # sibling-worker fallback: a spooled trace another worker finished
        return self._read_spool(trace_id)

    # -------------------------------------------------------------- spooling

    def _spool_path(self, trace_id: str) -> str:
        return os.path.join(self.spool_dir, f"trace-{trace_id}.json")

    def _spool(self, trace: RequestTrace) -> None:
        """Write one completed trace atomically (tmp + rename: a sibling's
        concurrent read never sees a torn file). Spool failures count, not
        crash — the in-memory ring stays authoritative."""
        try:
            os.makedirs(self.spool_dir, exist_ok=True)
            path = self._spool_path(trace.trace_id)
            tmp = f"{path}.{os.getpid()}.tmp"
            body = trace.to_dict()
            body["in_flight"] = False
            with open(tmp, "w") as f:
                json.dump(body, f, separators=(",", ":"))
            os.replace(tmp, path)
        except (OSError, TypeError, ValueError):
            self.spool_errors_total += 1
            return
        self._spool_writes += 1
        if self._spool_writes % self._SPOOL_PRUNE_EVERY == 0:
            self._prune_spool()

    def _prune_spool(self) -> None:
        horizon = time.time() - self.SPOOL_RETENTION_S
        try:
            names = os.listdir(self.spool_dir)
        except OSError:
            return
        for name in names:
            if not name.startswith("trace-"):
                continue
            p = os.path.join(self.spool_dir, name)
            try:
                if os.path.getmtime(p) < horizon:
                    os.unlink(p)
            except OSError:
                continue  # allow-silent: a sibling's sweep got there first

    def _read_spool(self, trace_id: str) -> dict | None:
        if not self.spool_dir or not _ID_RE.match(trace_id):
            return None
        try:
            with open(self._spool_path(trace_id)) as f:
                body = json.load(f)
        except (OSError, ValueError):
            return None
        if not isinstance(body, dict) or body.get("trace_id") != trace_id:
            return None
        body["spooled"] = True
        return body

    def list(self, limit: int = 100) -> list[dict]:
        """Most-recent-first completed traces (non-positive limit: none)."""
        if limit <= 0:
            return []
        with self._lock:
            out = [t.to_dict() for t in list(self._done)[-limit:]]
        out.reverse()
        return out


def observe_first_token(state, trace, model: str, endpoint_name: str,
                        started: float, *, streaming: bool = False) -> None:
    """First-byte-from-upstream bookkeeping, applied identically by every
    proxy path: records the gateway TTFT histogram and the ``first_token``
    trace mark; on streams also opens the ``decode`` span. Non-streaming
    callers invoke it at the response boundary, where first token and
    end-to-end coincide."""
    state.metrics.record_ttft(model, endpoint_name,
                              time.monotonic() - started)
    if trace is not None:
        trace.mark("first_token")
        if streaming:
            trace.begin("decode")


# ------------------------------------------------------- cross-process join

# Per-engine timeline fetch budget: a dead engine must not stall the whole
# view — its absence is reported in the `sources` block instead.
TIMELINE_FETCH_TIMEOUT_S = 3.0

# Cross-process happens-before edges the wall-clock merge must not flip:
# clock skew between hosts can stamp the adopting engine's event earlier
# than the emitting engine's. Same-source pairs are never repaired — the
# per-process seq already orders those exactly (and a park/resume cycle
# can legitimately repeat).
_CAUSAL_EDGES = (
    ("handoff_emitted", "adopted"),
    ("staged", "adopted"),
    ("parked", "resumed"),
)


def endpoints_touched(trace: dict) -> list[str]:
    """Endpoint names the trace's spans record, in first-touch order: the
    selection target (`endpoint_select`), any handoff adopter
    (`handoff_adopt`), and any failover resume target (`stream_resume`)."""
    names: list[str] = []
    for span in trace.get("spans") or []:
        ep = (span.get("attrs") or {}).get("endpoint")
        if ep and ep not in names:
            names.append(ep)
    if not names and trace.get("endpoint_name"):
        names.append(trace["endpoint_name"])
    return names


def _gateway_events(trace: dict) -> list[dict]:
    """The trace's own spans re-expressed in flight-recorder event shape
    (wall-clock ts = started_at + the span's monotonic offset), so the
    proxy-side lifecycle interleaves with the engines' events."""
    base = float(trace.get("started_at") or 0.0)
    events = []
    for n, span in enumerate(trace.get("spans") or []):
        ev: dict = {
            "seq": n + 1,
            "ts": round(base + float(span.get("start_ms") or 0.0) / 1000.0, 6),
            "src": "gateway",
            "event": span["name"],
            "request_id": trace["trace_id"],
        }
        if span.get("duration_ms"):
            ev["duration_s"] = round(span["duration_ms"] / 1000.0, 6)
        if span.get("attrs"):
            ev["attrs"] = span["attrs"]
        events.append(ev)
    return events


async def fetch_engine_timelines(
    state, trace: dict,
) -> tuple[list[dict], list[dict]]:
    """Fetch `GET /api/requests/{id}/timeline` from every engine the trace
    names. Returns (events, sources): events carry an `endpoint` label on
    top of their engine-side `src`; sources reports per-engine fetch
    outcomes so a missing engine is visible, not silent."""
    by_name = {e.name: e for e in state.registry.list_all()}
    events: list[dict] = []
    sources: list[dict] = []
    seen: set[tuple] = set()  # spool siblings can return duplicate events
    for name in endpoints_touched(trace):
        info: dict = {"endpoint": name, "ok": False}
        ep = by_name.get(name)
        if ep is None:
            info["error"] = "endpoint not registered"
            sources.append(info)
            continue
        url = (ep.url.rstrip("/")
               + f"/api/requests/{trace['trace_id']}/timeline")
        try:
            timeout = http.ClientTimeout(total=TIMELINE_FETCH_TIMEOUT_S)
            async with state.http.get(url, timeout=timeout) as resp:
                if resp.status == 200:
                    body = await resp.json()
                else:
                    info["error"] = f"HTTP {resp.status}"
                    sources.append(info)
                    continue
        except Exception as e:  # noqa: BLE001 — any fetch failure reports
            info["error"] = str(e) or type(e).__name__
            sources.append(info)
            continue
        fetched = 0
        for ev in (body.get("events") or []):
            if not isinstance(ev, dict):
                continue
            key = (ev.get("src"), ev.get("seq"))
            if key in seen:
                continue
            seen.add(key)
            ev = dict(ev)
            ev["endpoint"] = name
            events.append(ev)
            fetched += 1
        info.update(ok=True, events=fetched, source=body.get("source"))
        sources.append(info)
    return events, sources


def _event_sort_key(ev: dict):
    return (float(ev.get("ts") or 0.0), str(ev.get("src") or ""),
            int(ev.get("seq") or 0))


def repair_causal_order(events: list[dict]) -> None:
    """Clamp cross-source effect events that wall-clock skew stamped
    before their cause (handoff emit → adopt, stage → adopt, park →
    resume): the effect's ts moves just past the latest other-source
    cause and the event is flagged `ts_adjusted`. In-place; re-sorts."""
    changed = False
    for cause_name, effect_name in _CAUSAL_EDGES:
        causes = [e for e in events if e.get("event") == cause_name]
        if not causes:
            continue
        for ev in events:
            if ev.get("event") != effect_name:
                continue
            prior = [c for c in causes if c.get("src") != ev.get("src")]
            if not prior:
                continue
            cmax = max(float(c.get("ts") or 0.0) for c in prior)
            if float(ev.get("ts") or 0.0) < cmax:
                ev["ts"] = round(cmax + 1e-6, 6)
                ev["ts_adjusted"] = True
                changed = True
    if changed:
        events.sort(key=_event_sort_key)


def merge_timeline(trace: dict, engine_events: list[dict],
                   sources: list[dict]) -> dict:
    """One ordered cross-process timeline: gateway spans + every fetched
    engine event, sorted by (wall ts, source, per-source seq) with causal
    repair for skewed cross-process edges."""
    events = _gateway_events(trace) + engine_events
    events.sort(key=_event_sort_key)
    repair_causal_order(events)
    return {
        "trace_id": trace["trace_id"],
        "endpoints": endpoints_touched(trace),
        "sources": sources,
        "events": events,
        "event_count": len(events),
    }


def chrome_trace(timeline: dict) -> dict:
    """Chrome trace-event JSON (Perfetto / chrome://tracing): one pid per
    process (gateway + each engine source), complete `X` slices for
    duration-bearing events, `i` instants for the rest. Timestamps are
    microseconds from the earliest event."""
    events = timeline.get("events") or []
    t0 = min((float(e.get("ts") or 0.0) for e in events), default=0.0)
    pids: dict[str, int] = {}
    out: list[dict] = []

    def pid_for(ev: dict) -> int:
        src = str(ev.get("src") or "?")
        label = (f"{ev['endpoint']} ({src})"
                 if ev.get("endpoint") else src)
        if src not in pids:
            pids[src] = len(pids) + 1
            out.append({"ph": "M", "name": "process_name", "pid": pids[src],
                        "tid": 0, "args": {"name": label}})
        return pids[src]

    for ev in events:
        pid = pid_for(ev)
        args = dict(ev.get("attrs") or {})
        args["request_id"] = ev.get("request_id")
        if ev.get("ts_adjusted"):
            args["ts_adjusted"] = True
        ts_us = round((float(ev.get("ts") or 0.0) - t0) * 1e6, 3)
        rec = {"name": ev.get("event"), "pid": pid, "tid": 0,
               "ts": ts_us, "cat": "llmlb", "args": args}
        if ev.get("duration_s"):
            rec.update(ph="X", dur=round(float(ev["duration_s"]) * 1e6, 3))
        else:
            rec.update(ph="i", s="p")
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


# ------------------------------------------------------------------ handlers


async def list_traces(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        limit = min(int(request.query.get("limit", 100)), 500)
    except ValueError:
        return web.json_response({"error": "limit must be an integer"},
                                 status=400)
    return web.json_response({"traces": state.traces.list(limit)})


async def get_trace(request: web.Request) -> web.Response:
    """GET /api/traces/{id} — one trace. `?view=timeline` joins the
    gateway spans with every touched engine's flight-recorder events into
    one causally ordered cross-process timeline; `?format=chrome` exports
    that merge as Chrome trace-event JSON (Perfetto-loadable)."""
    state = request.app["state"]
    trace = state.traces.get(request.match_info["trace_id"])
    if trace is None:
        return web.json_response({"error": "trace not found"}, status=404)
    want_chrome = request.query.get("format") == "chrome"
    want_timeline = request.query.get("view") == "timeline" or want_chrome
    if not want_timeline:
        return web.json_response(trace)
    engine_events, sources = await fetch_engine_timelines(state, trace)
    timeline = merge_timeline(trace, engine_events, sources)
    if want_chrome:
        return web.json_response(chrome_trace(timeline))
    body = dict(trace)
    body["timeline"] = timeline
    return web.json_response(body)
