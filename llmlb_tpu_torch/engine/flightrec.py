"""Per-request flight recorder: engine-side lifecycle event log.

The port's own copy of `llmlb_tpu/engine/flightrec.py` (pure Python, the
same semantics, events, bounds and spool). It records what happened to one
request inside the engine, every lifecycle edge the scheduler crosses:

  admitted         request passed validation and entered the engine
  queued           landed on a priority-class queue (class + position)
  prefill_chunk    one prompt-KV fill dispatch (tokens, cached-prefix
                   tokens reused from the prefix cache)
  staged           split-mode prefill complete: the row waits for a
                   decode slot (tokens, slot)
  handoff_emitted  committed tokens wrapped into a cross-process handoff
                   (/v1/handoff/prefill)
  adopted          this engine adopted a stream: a split handoff
                   (in_process, staged seconds), or one another engine
                   started (/v1/handoff, /v1/resume: committed tokens,
                   wire latency)
  parked           slot preempted (reason: preempt | pages | drain |
                   migrate) with its generated-token count
  resumed          a parked request re-activated (replay, or page restore
                   when its KV travelled as bytes)
  kv_shipped       this request's KV pages gathered to the host for an
                   export (tokens, pages, bytes)
  kv_spilled       parked-slot pages kept in the host-RAM offload tier
  kv_restored      serialized pages landed into this engine's pool
                   (source: wire | offload; kind: stream | prefix)
  lora_acquire     adapter pinned for the request (+ load wait seconds)
  spec_accept      one speculative verify step's drafted/accepted counts
  shed             dropped before prefill (deadline exceeded)
  finished         terminal success (reason: stop | length | cancelled)
  errored          terminal failure (message)
  slow_step        this request sat in a dispatch the slow-step detector
                   flagged (kind, total seconds, step seq)

Events are keyed by the gateway-minted ``X-Request-Id`` (the engine's
request id minus its uniquifying ``.{8 hex}`` suffix), so the gateway can
join them to its own trace spans: its ``/api/traces/{id}?view=timeline``
fetches ``GET /api/requests/{id}/timeline`` from every engine the request
touched and merges one cross-process timeline.

Events fire per lifecycle edge (a handful per request), never per token;
each emit is one clock read, one dict build and two deque appends behind a
lock. ``LLMLB_FLIGHTREC=0`` short-circuits emit() before the clock read.

Timestamps are wall-clock (``time.time()``, the only clock two processes
share); in-process ordering is exact through a sequence number.

Post-mortem (``LLMLB_FLIGHTREC_SPOOL``): when the knob names a directory,
every event is also appended to a per-request JSONL file there, and engines
sharing the directory serve each other's events. Off by default.
"""

from __future__ import annotations

import json
import os
import re
import threading
import time
from collections import OrderedDict, deque

# The lifecycle taxonomy (docs/tracing.md documents each event's fields).
EVENTS = (
    "admitted", "queued", "prefill_chunk", "staged", "handoff_emitted",
    "adopted", "parked", "resumed", "kv_shipped", "kv_spilled",
    "kv_restored", "lora_acquire", "spec_accept",
    "shed", "finished", "errored", "slow_step",
)

# scheduler request ids are "{gateway_rid}.{uuid4().hex[:8]}"
_SUFFIX_RE = re.compile(r"\.[0-9a-f]{8}$")
# spool filenames must not traverse; gateway ids already match this shape
_UNSAFE_RE = re.compile(r"[^A-Za-z0-9_.:\-]")

_PRUNE_EVERY = 256  # emits between lazy retention sweeps
_SPOOL_PRUNE_EVERY = 128  # spool writes between stale-file sweeps


def gateway_rid(request_id: str) -> str:
    """Strip the scheduler's uniquifying ``.{8 hex}`` suffix, recovering
    the gateway-minted X-Request-Id the events are keyed by. Ids without
    the suffix (engine-local uuids, test ids) pass through unchanged."""
    return _SUFFIX_RE.sub("", request_id)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


class FlightRecorder:
    """Bounded per-request event deques + a global recent-events ring +
    aggregate counters. Thread-safe: emit() runs on the step loop and the
    HTTP service threads; timeline()/counters() on scrape handlers."""

    def __init__(self, *, enabled: bool | None = None,
                 ring: int | None = None,
                 max_requests: int | None = None,
                 events_per_request: int | None = None,
                 retention_s: float | None = None,
                 spool_dir: str | None = None,
                 source: str | None = None):
        if enabled is None:
            enabled = os.environ.get(
                "LLMLB_FLIGHTREC", "1").lower() not in ("0", "false", "no")
        self.enabled = bool(enabled)
        self.ring_capacity = max(
            16, ring if ring is not None
            else _env_int("LLMLB_FLIGHTREC_RING", 4096))
        self.max_requests = max(
            1, max_requests if max_requests is not None
            else _env_int("LLMLB_FLIGHTREC_REQS", 256))
        self.events_per_request = max(
            8, events_per_request if events_per_request is not None
            else _env_int("LLMLB_FLIGHTREC_EVENTS", 128))
        self.retention_s = float(
            retention_s if retention_s is not None
            else _env_int("LLMLB_FLIGHTREC_RETENTION_S", 600))
        if spool_dir is None:
            spool_dir = os.environ.get("LLMLB_FLIGHTREC_SPOOL") or None
        self.spool_dir = spool_dir
        # source tag on every event: which process recorded it. The engine
        # has no registry name for itself, so pid is the honest identity;
        # the gateway merge re-labels sources with endpoint names.
        self.source = source or f"engine-pid{os.getpid()}"
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.ring_capacity)
        # rid -> {"events": deque, "dropped": int, ...accounting stamps};
        # ordered by last touch, so the front is the eviction candidate
        self._reqs: "OrderedDict[str, dict]" = OrderedDict()
        self._seq = 0
        self.events_total = 0
        self.events_dropped_total = 0
        self.requests_total = 0
        self.spool_errors_total = 0
        self.by_event: dict[str, int] = {}
        # timeline-derived queue-vs-compute accounting (the Grafana panel):
        # admitted -> first prefill_chunk is queue time; first prefill_chunk
        # -> terminal is service time.
        self.queue_seconds_total = 0.0
        self.service_seconds_total = 0.0
        self._spool_writes = 0
        if self.enabled and self.spool_dir:
            try:
                os.makedirs(self.spool_dir, exist_ok=True)
            except OSError:
                self.spool_errors_total += 1
                self.spool_dir = None

    # ------------------------------------------------------------- recording

    def emit(self, request_id: str, event: str, **attrs) -> None:
        """Record one lifecycle event. Safe from any thread; a no-op (before
        the first clock read) when the recorder is disabled."""
        if not self.enabled:
            return
        now = time.time()
        rid = gateway_rid(request_id)
        with self._lock:
            self._seq += 1
            ev: dict = {"seq": self._seq, "ts": round(now, 6),
                        "src": self.source, "event": event,
                        "request_id": rid}
            if request_id != rid:
                ev["engine_request_id"] = request_id
            if attrs:
                ev["attrs"] = attrs
            rec = self._reqs.get(rid)
            if rec is None:
                rec = {"events": deque(maxlen=self.events_per_request),
                       "dropped": 0, "first_ts": now}
                self._reqs[rid] = rec
                self.requests_total += 1
                while len(self._reqs) > self.max_requests:
                    self._reqs.popitem(last=False)
            else:
                self._reqs.move_to_end(rid)
            if len(rec["events"]) == self.events_per_request:
                rec["dropped"] += 1
                self.events_dropped_total += 1
            rec["events"].append(ev)
            rec["last_ts"] = now
            self._ring.append(ev)
            self.events_total += 1
            self.by_event[event] = self.by_event.get(event, 0) + 1
            if event == "admitted":
                rec["admitted_ts"] = now
            elif event == "prefill_chunk" and "compute_ts" not in rec:
                rec["compute_ts"] = now
                if "admitted_ts" in rec:
                    self.queue_seconds_total += now - rec["admitted_ts"]
            elif event in ("finished", "errored", "shed"):
                start = rec.get("compute_ts", rec.get("admitted_ts"))
                if start is not None:
                    self.service_seconds_total += now - start
            if self._seq % _PRUNE_EVERY == 0:
                self._prune_locked(now)
        if self.spool_dir:
            self._spool(rid, ev)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.retention_s
        while self._reqs:
            rid, rec = next(iter(self._reqs.items()))
            if rec.get("last_ts", rec["first_ts"]) >= horizon:
                break
            del self._reqs[rid]

    # --------------------------------------------------------------- spooling

    def _spool(self, rid: str, ev: dict) -> None:
        path = os.path.join(self.spool_dir,
                            f"req-{_UNSAFE_RE.sub('_', rid)}.jsonl")
        try:
            with open(path, "a") as f:
                f.write(json.dumps(ev, separators=(",", ":")) + "\n")
        except (OSError, TypeError, ValueError):
            with self._lock:
                self.spool_errors_total += 1
            return
        self._spool_writes += 1
        if self._spool_writes % _SPOOL_PRUNE_EVERY == 0:
            self._prune_spool()

    def _prune_spool(self) -> None:
        horizon = time.time() - self.retention_s
        try:
            names = os.listdir(self.spool_dir)
        except OSError:
            return
        for name in names:
            if not name.startswith("req-"):
                continue
            p = os.path.join(self.spool_dir, name)
            try:
                if os.path.getmtime(p) < horizon:
                    os.unlink(p)
            except OSError:
                continue  # allow-silent: sibling pruned it first

    def _read_spool(self, rid: str) -> list[dict]:
        path = os.path.join(self.spool_dir,
                            f"req-{_UNSAFE_RE.sub('_', rid)}.jsonl")
        events: list[dict] = []
        try:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # torn tail line from a killed writer
                    if isinstance(ev, dict) and "event" in ev:
                        events.append(ev)
        except OSError:
            return []
        return events

    # ---------------------------------------------------------------- reading

    def timeline(self, request_id: str) -> dict | None:
        """JSON view of one request's events (memory merged with any
        spooled sibling events), sorted by (ts, src, seq). None when the
        recorder knows nothing about the id."""
        rid = gateway_rid(request_id)
        with self._lock:
            rec = self._reqs.get(rid)
            events = list(rec["events"]) if rec is not None else []
            dropped = rec["dropped"] if rec is not None else 0
        if self.spool_dir:
            seen = {(e["src"], e["seq"]) for e in events}
            for ev in self._read_spool(rid):
                key = (ev.get("src"), ev.get("seq"))
                if key not in seen:
                    seen.add(key)
                    events.append(ev)
        if not events:
            return None
        events.sort(key=lambda e: (e.get("ts", 0.0), str(e.get("src", "")),
                                   e.get("seq", 0)))
        return {
            "request_id": rid,
            "source": self.source,
            "events": events,
            "dropped": dropped,
            "first_ts": events[0].get("ts"),
            "last_ts": events[-1].get("ts"),
        }

    def counters(self) -> dict:
        """Aggregate view for /api/steps and /metrics."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "events_total": self.events_total,
                "events_dropped_total": self.events_dropped_total,
                "requests_total": self.requests_total,
                "requests_tracked": len(self._reqs),
                "by_event": dict(self.by_event),
                "queue_seconds_total": round(self.queue_seconds_total, 6),
                "service_seconds_total": round(self.service_seconds_total, 6),
                "spool": bool(self.spool_dir),
                "spool_errors_total": self.spool_errors_total,
            }
