"""Gateway resilience layer: in-band failover + per-endpoint circuit breaking.

Before this layer, any single upstream hiccup was a client-visible 502: the
proxy gave up on the first connect error or non-200, and a dead endpoint kept
receiving traffic until the pull-based health checker (30 s interval x 2
strikes) noticed — up to ~60 s of guaranteed failures. This module closes
both gaps with in-band signals:

* **Failover retries** (`FailoverController`): a failed attempt re-runs
  endpoint selection excluding every endpoint that already failed this
  request, with capped exponential backoff + jitter, under a global
  `RetryBudget` (retries capped as a fraction of recent request volume so a
  melting fleet is not amplified by its own failover traffic). Non-streamed
  requests and streams that fail *before the first byte reaches the client*
  are retryable; mid-stream failures are not (bytes already left).

* **Passive health / circuit breaker** (`ResilienceManager`): per-endpoint
  closed -> open -> half-open breakers fed by in-band outcomes, including
  stream interruptions. Tripping ejects the endpoint from `select`/
  `try_admit` immediately (the LoadManager consults `allow()`); after the
  open interval one half-open probe request is admitted and its outcome
  closes or re-opens (doubled interval, capped) the breaker. The pull
  checker reconciles: a successful out-of-band probe fast-forwards an open
  breaker to half-open, and a recovered-from-offline endpoint starts with a
  fresh breaker.

* **Fault-aware upstream POST** (`upstream_post`): the single choke point
  every proxy path uses to talk to an endpoint, where faults.py rules are
  applied — so all of the above is testable deterministically.

Prior art: the retry-budget idea follows Finagle/Envoy `retry_budget`
(ratio + min floor over a sliding window); the breaker is the standard
consecutive-failure trip with exponential open intervals.
"""

from __future__ import annotations

import asyncio
import enum
import math
import random
import threading
import time

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.config import ResilienceConfig
from llmlb_tpu_torch.gateway.faults import (
    EngineAbortResponse,
    InjectedHTTPResponse,
    StreamCutResponse,
)
from llmlb_tpu_torch.gateway.gossip import SeqClock, newer

RETRYABLE_EXCEPTIONS = (http.ClientError, asyncio.TimeoutError, OSError)


class BreakerState(str, enum.Enum):
    CLOSED = "closed"
    HALF_OPEN = "half_open"
    OPEN = "open"


# /metrics gauge encoding (llmlb_gateway_breaker_state{endpoint=...})
BREAKER_STATE_CODE = {
    BreakerState.CLOSED: 0,
    BreakerState.HALF_OPEN: 1,
    BreakerState.OPEN: 2,
}


# A half-open probe that never reports an outcome (handler crash, leaked
# lease) must not wedge the breaker in half_open forever: its slot is
# reclaimed after this long. Generous — longer than the default 300 s
# inference timeout, so a legitimately slow probe stream is not double-run.
HALF_OPEN_PROBE_TIMEOUT_S = 600.0


class _Breaker:
    """Per-endpoint breaker record. All mutation under the manager's lock."""

    __slots__ = ("state", "consecutive_failures", "opened_at", "open_until",
                 "trip_streak", "probes_in_flight", "probe_started_at",
                 "last_failure_reason", "last_change_ver")

    def __init__(self):
        self.state = BreakerState.CLOSED
        self.consecutive_failures = 0
        self.opened_at = 0.0
        self.open_until = 0.0
        self.trip_streak = 0  # consecutive trips; doubles the open interval
        self.probes_in_flight = 0
        self.probe_started_at = 0.0
        self.last_failure_reason: str | None = None
        # (seq, origin) stamp of the last applied transition (local or
        # remote): the seq-LWW ordering key for cross-worker gossip — wall
        # stamps skewed across hosts and could resurrect a stale OPEN
        # (gossip.newer); None until the first transition.
        self.last_change_ver: tuple | None = None


class RetryBudget:
    """Sliding-window retry budget: retries are allowed while the retry
    count stays under max(min_floor, ratio * recent requests). Envoy's
    `retry_budget` semantics, windowed rather than token-bucketed so the
    figure shown in /api/health is directly interpretable."""

    def __init__(self, ratio: float, min_retries: int, window_s: float):
        self.ratio = ratio
        self.min_retries = min_retries
        self.window_s = window_s
        self._lock = threading.Lock()
        self._requests: list[float] = []
        self._retries: list[float] = []
        # Called (spend count is rare — failures only) after a successful
        # local spend; app_state wires this to gossip so sibling workers
        # count the retry against their own window too. Request volume
        # stays worker-local on purpose: replicating every request would
        # put a datagram on the bus per request, and a per-worker request
        # denominator only makes the budget MORE conservative.
        self.on_spend = None

    def _trim(self, now: float) -> None:
        cutoff = now - self.window_s
        for series in (self._requests, self._retries):
            # windows are short and appends ordered; linear trim from the left
            i = 0
            while i < len(series) and series[i] < cutoff:
                i += 1
            if i:
                del series[:i]

    def note_request(self, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim(now)
            self._requests.append(now)

    def allowed(self, now: float | None = None) -> int:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim(now)
            return max(self.min_retries,
                       int(self.ratio * len(self._requests)))

    def try_spend(self, now: float | None = None) -> bool:
        now = time.monotonic() if now is None else now
        with self._lock:
            self._trim(now)
            cap = max(self.min_retries, int(self.ratio * len(self._requests)))
            if len(self._retries) >= cap:
                return False
            self._retries.append(now)
        cb = self.on_spend
        if cb is not None:
            try:
                cb()
            except Exception:  # allow-silent: gossip publish is best-effort
                pass
        return True

    def note_remote_spend(self) -> None:
        """A sibling worker spent a retry: count it against this window so
        the fleet-wide retry volume honors one budget, not N."""
        with self._lock:
            self._trim(time.monotonic())
            self._retries.append(time.monotonic())

    def snapshot(self) -> dict:
        now = time.monotonic()
        with self._lock:
            self._trim(now)
            cap = max(self.min_retries, int(self.ratio * len(self._requests)))
            return {
                "window_s": self.window_s,
                "requests_in_window": len(self._requests),
                "retries_in_window": len(self._retries),
                "retries_allowed": cap,
            }


class ResilienceManager:
    """Per-endpoint breakers + the global retry budget.

    Wired into the LoadManager as `load_manager.resilience`: selection
    filters candidates through `allow()` and reports admissions via
    `on_admit()` (which consumes half-open probe slots). Proxy paths report
    outcomes via `record_success()`/`record_failure()`. Thread-safe — lease
    releases can arrive from GC finalizer threads.
    """

    def __init__(self, config: ResilienceConfig | None = None, *,
                 metrics=None, events=None, registry=None):
        self.config = config or ResilienceConfig()
        self.metrics = metrics  # GatewayMetrics | None
        self.events = events  # DashboardEventBus | None
        self.registry = registry  # EndpointRegistry | None
        self.budget = RetryBudget(
            self.config.retry_budget_ratio,
            self.config.retry_budget_min,
            self.config.retry_budget_window_s,
        )
        self._lock = threading.Lock()
        self._breakers: dict[str, _Breaker] = {}
        # GossipBus | None (set by app_state): transitions replicate to
        # sibling workers so a breaker tripped here ejects the endpoint
        # everywhere within ~1 RTT. Advisory — with gossip off, every worker
        # still converges on its own in-band failures.
        self.gossip = None
        self._applying_remote = False  # loop guard: remote applies don't re-gossip
        self._local_clock = SeqClock()  # version source when no bus attached

    def _next_ver(self):
        g = self.gossip
        if g is not None:
            return g.next_version()
        return (self._local_clock.tick(), "local")

    # ------------------------------------------------------------ transitions

    def _transition(self, endpoint_id: str, b: _Breaker,
                    to: BreakerState, reason: str | None = None) -> None:
        """Caller holds the lock. The sinks (metrics/events/registry) use
        their own locks and never call back into this manager, so invoking
        them under our lock cannot deadlock."""
        frm = b.state
        if frm == to:
            return
        b.state = to
        ver = self._next_ver()
        b.last_change_ver = ver
        if to == BreakerState.OPEN:
            now = time.monotonic()
            b.opened_at = now
            interval = min(
                self.config.breaker_open_max_s,
                self.config.breaker_open_s * (2 ** b.trip_streak),
            )
            b.open_until = now + interval
            b.trip_streak += 1
            b.probes_in_flight = 0
        elif to == BreakerState.HALF_OPEN:
            b.probes_in_flight = 0
        else:  # CLOSED
            b.consecutive_failures = 0
            b.trip_streak = 0
            b.probes_in_flight = 0
        name = endpoint_id
        if self.registry is not None:
            ep = self.registry.get(endpoint_id)
            if ep is not None:
                name = ep.name
            self.registry.set_breaker_state(endpoint_id, to.value)
        if self.metrics is not None:
            self.metrics.record_breaker_transition(name, to.value)
            self.metrics.set_breaker_state(
                name, BREAKER_STATE_CODE[to]
            )
        if self.events is not None:
            self.events.publish("BreakerStateChanged", {
                "endpoint_id": endpoint_id,
                "name": name,
                "from": frm.value,
                "to": to.value,
                "reason": reason,
            })
        if self.gossip is not None and not self._applying_remote:
            # the wire version IS the local stamp (seq=ver[0]): a delayed
            # echo of an older remote transition can never outrank this one
            self.gossip.publish("breaker", {
                "eid": endpoint_id,
                "to": to.value,
                "reason": reason,
                # ship the remaining open interval, not the deadline —
                # peers rebuild the deadline on their own monotonic clock
                "remaining_s": (
                    round(max(0.0, b.open_until - time.monotonic()), 3)
                    if to == BreakerState.OPEN else 0.0
                ),
            }, seq=ver[0])

    def apply_remote_breaker(self, endpoint_id: str, to: str,
                             remaining_s: float, reason: str | None,
                             ver: tuple) -> None:
        """A sibling worker's breaker transition, applied seq-LWW.

        OPEN ejects the endpoint here with the peer's remaining interval (so
        the whole group reopens together); CLOSED/HALF_OPEN relax a local
        open breaker (the peer had direct probe evidence). Purely advisory:
        a dropped message only delays ejection until this worker's own
        failures trip its local breaker, and correctness (request outcomes,
        retries) never consults the peer state directly."""
        if not self.config.enabled:
            return
        try:
            target = BreakerState(to)
        except ValueError:
            return
        if (self.registry is not None
                and self.registry.get(endpoint_id) is None):
            return  # deleted endpoint: never resurrect its breaker
        ver = tuple(ver)
        with self._lock:
            b = self._breakers.setdefault(endpoint_id, _Breaker())
            if not newer(ver, b.last_change_ver):
                return  # stale: this worker already knows something newer
            self._applying_remote = True
            try:
                if target == BreakerState.OPEN:
                    if b.state != BreakerState.OPEN:
                        self._transition(endpoint_id, b, BreakerState.OPEN,
                                         f"gossip: {reason}")
                        # override the locally computed interval with the
                        # tripping worker's remaining window
                        b.open_until = time.monotonic() + max(0.0, remaining_s)
                elif target == BreakerState.HALF_OPEN:
                    if b.state == BreakerState.OPEN:
                        self._transition(endpoint_id, b,
                                         BreakerState.HALF_OPEN,
                                         f"gossip: {reason}")
                elif b.state != BreakerState.CLOSED:
                    self._transition(endpoint_id, b, BreakerState.CLOSED,
                                     f"gossip: {reason}")
                # adopt the WIRE version: this worker's state now equals the
                # sender's, so anything newer than the sender's stamp (and
                # only that) should supersede it here too
                b.last_change_ver = ver
            finally:
                self._applying_remote = False

    # -------------------------------------------------------------- selection

    def allow(self, endpoint_id: str, now: float | None = None) -> bool:
        """May this endpoint receive a request right now? Open breakers past
        their interval lazily move to half-open here, so expiry needs no
        timer task."""
        if not self.config.enabled:
            return True
        now = time.monotonic() if now is None else now
        with self._lock:
            b = self._breakers.get(endpoint_id)
            if b is None or b.state == BreakerState.CLOSED:
                return True
            if b.state == BreakerState.OPEN:
                if now < b.open_until:
                    return False
                self._transition(endpoint_id, b, BreakerState.HALF_OPEN,
                                 "open interval elapsed")
            if (b.probes_in_flight > 0
                    and now - b.probe_started_at > HALF_OPEN_PROBE_TIMEOUT_S):
                # outcome never arrived (crashed handler, leaked lease):
                # reclaim the slot instead of wedging half-open forever
                b.probes_in_flight = 0
            return b.probes_in_flight < self.config.breaker_half_open_probes

    def on_admit(self, endpoint_id: str) -> None:
        """An admission actually landed on this endpoint; in half-open that
        consumes the probe slot so only N probes fly at once."""
        with self._lock:
            b = self._breakers.get(endpoint_id)
            if b is not None and b.state == BreakerState.HALF_OPEN:
                b.probes_in_flight += 1
                b.probe_started_at = time.monotonic()

    # --------------------------------------------------------------- outcomes

    def record_success(self, endpoint_id: str) -> None:
        with self._lock:
            b = self._breakers.get(endpoint_id)
            if b is None:
                return
            if b.state == BreakerState.HALF_OPEN:
                self._transition(endpoint_id, b, BreakerState.CLOSED,
                                 "probe succeeded")
            elif b.state == BreakerState.CLOSED:
                b.consecutive_failures = 0
            # OPEN: a straggler success (request admitted pre-trip) is not
            # probe evidence; wait for the half-open probe.

    def record_failure(self, endpoint_id: str, reason: str = "error") -> None:
        if not self.config.enabled:
            return
        if (self.registry is not None
                and self.registry.get(endpoint_id) is None):
            # in-flight failure for an endpoint deleted mid-request: do not
            # resurrect its breaker (forget() already ran — a revived entry
            # would export an uncleable state gauge under the raw id)
            return
        with self._lock:
            b = self._breakers.setdefault(endpoint_id, _Breaker())
            b.last_failure_reason = reason
            if b.state == BreakerState.HALF_OPEN:
                self._transition(endpoint_id, b, BreakerState.OPEN,
                                 f"probe failed: {reason}")
            elif b.state == BreakerState.CLOSED:
                b.consecutive_failures += 1
                if (b.consecutive_failures
                        >= self.config.breaker_failure_threshold):
                    self._transition(endpoint_id, b, BreakerState.OPEN,
                                     f"failure threshold: {reason}")

    # ------------------------------------------------- pull-checker reconcile

    def note_probe(self, endpoint_id: str, ok: bool) -> None:
        """Out-of-band health-probe outcome (health.py). A successful probe
        fast-forwards an open breaker to half-open — the next real request
        is the in-band probe; a failed probe while half-open re-opens."""
        with self._lock:
            b = self._breakers.get(endpoint_id)
            if b is None:
                return
            if ok and b.state == BreakerState.OPEN:
                self._transition(endpoint_id, b, BreakerState.HALF_OPEN,
                                 "health probe succeeded")
            elif not ok and b.state == BreakerState.HALF_OPEN:
                self._transition(endpoint_id, b, BreakerState.OPEN,
                                 "health probe failed")

    def reset(self, endpoint_id: str) -> None:
        """Endpoint recovered offline->online via the pull checker: start
        with a fresh breaker (the engine restarted; history is stale)."""
        with self._lock:
            b = self._breakers.get(endpoint_id)
            if b is not None and b.state != BreakerState.CLOSED:
                self._transition(endpoint_id, b, BreakerState.CLOSED,
                                 "endpoint recovered")
            self._breakers.pop(endpoint_id, None)

    def forget(self, endpoint_id: str, endpoint_name: str | None = None) -> None:
        """Endpoint removed from the registry. Clears the /metrics state
        gauge too (the caller passes the name — the registry entry is
        already gone), or an endpoint deleted while open would pin the
        GatewayBreakerOpen alert forever."""
        with self._lock:
            self._breakers.pop(endpoint_id, None)
        if self.metrics is not None and endpoint_name is not None:
            self.metrics.clear_breaker_state(endpoint_name)

    # ------------------------------------------------------------- inspection

    def state_of(self, endpoint_id: str) -> BreakerState:
        with self._lock:
            b = self._breakers.get(endpoint_id)
            return b.state if b is not None else BreakerState.CLOSED

    def breaker_info(self, endpoint_id: str) -> dict:
        now = time.monotonic()
        with self._lock:
            b = self._breakers.get(endpoint_id)
            if b is None:
                return {"state": BreakerState.CLOSED.value,
                        "consecutive_failures": 0, "retry_after_s": 0.0}
            return {
                "state": b.state.value,
                "consecutive_failures": b.consecutive_failures,
                "trip_streak": b.trip_streak,
                "last_failure_reason": b.last_failure_reason,
                "retry_after_s": (
                    round(max(0.0, b.open_until - now), 3)
                    if b.state == BreakerState.OPEN else 0.0
                ),
            }

    def soonest_reopen_s(self, endpoint_ids: list[str]) -> float | None:
        """Seconds until the first of these breakers admits traffic again;
        None when at least one admits traffic right now."""
        now = time.monotonic()
        waits: list[float] = []
        for eid in endpoint_ids:
            if self.allow(eid, now):
                return None
            with self._lock:
                b = self._breakers.get(eid)
                waits.append(max(0.0, b.open_until - now) if b else 0.0)
        return min(waits) if waits else None


# ----------------------------------------------------------------- failover


class PreStreamFailure:
    """Sentinel returned by the streaming proxies when the upstream stream
    died before any byte reached the client — the one stream failure that
    is safe to fail over (the client saw nothing)."""

    def __init__(self, error: str):
        self.error = error


def book_stream_outcome(state, failover, endpoint, model, *,
                        upstream_failed: bool, completed: bool) -> None:
    """Common outcome booking for the streaming proxies' finally blocks.
    An upstream cut feeds the breaker + per-endpoint stats + the
    interruption metric; a clean completion is a success; a client
    disconnect with the upstream still healthy counts as endpoint-alive —
    every stream must resolve its outcome or a half-open probe slot would
    leak and wedge the breaker."""
    if upstream_failed:
        if failover is not None:
            failover.record_failure(endpoint, None, "stream_interrupted",
                                    stream_interrupted=True)
        else:
            state.load_manager.note_endpoint_failure(
                endpoint.id, stream_interruption=True)
            state.metrics.record_stream_interruption(model, endpoint.name)
    elif failover is not None:
        if completed:
            failover.record_success(endpoint)
        else:
            failover.record_alive(endpoint)


def backoff_delay(retry_index: int, config: ResilienceConfig,
                  rng: random.Random | None = None) -> float:
    """Capped exponential backoff with full jitter over the upper half:
    delay in [cap/2, cap] of min(backoff_cap, base * 2^(retry-1))."""
    r = rng.random() if rng is not None else random.random()
    cap = min(config.backoff_cap_s,
              config.backoff_base_s * (2 ** max(0, retry_index - 1)))
    return cap * (0.5 + 0.5 * r)


class FailoverController:
    """Drives one client request's attempt loop across endpoints.

    Usage (per proxy path)::

        fo = FailoverController(state, model, trace=trace)
        while True:
            selection = await select(..., exclude=fo.failed_ids)
            ...post...
            on failure:
                fo.record_failure(endpoint, lease, reason)
                if await fo.should_retry(reason):
                    continue
                return <502 / normalized error>
            on success:
                fo.record_success(endpoint)
    """

    def __init__(self, state, model: str, *, trace=None, candidates_fn=None):
        self.state = state
        self.model = model
        self.trace = trace
        self.attempt = 1
        self.retried = False
        self.failed_ids: set[str] = set()
        # () -> list[Endpoint]: the request's full candidate pool. A retry is
        # only worth its backoff when an endpoint we have NOT yet failed on
        # remains — otherwise fail fast with the normalized 502 (a single
        # dead endpoint must not park the client on the queue first).
        self.candidates_fn = candidates_fn
        resilience = state.resilience
        self.config = (resilience.config if resilience is not None
                       else ResilienceConfig())
        if resilience is not None:
            resilience.budget.note_request()

    def record_failure(self, endpoint, lease, reason: str, *,
                       stream_interrupted: bool = False) -> None:
        """Book one failed attempt everywhere it must land: lease release,
        breaker, per-endpoint balancer stats, TPS reset is NOT done here
        (the pull checker owns that on offline).

        429 is retryable (this request fails over to a peer) but does NOT
        feed the breaker: a saturated endpoint is alive, and tripping
        breakers on saturation converts an overload spike into a cascade
        of hard ejections (Envoy's outlier detection excludes 429 for the
        same reason)."""
        if lease is not None:
            lease.fail()
        self.failed_ids.add(endpoint.id)
        if self.state.resilience is not None and reason != "http_429":
            self.state.resilience.record_failure(endpoint.id, reason)
        self.state.load_manager.note_endpoint_failure(
            endpoint.id, stream_interruption=stream_interrupted
        )
        if stream_interrupted:
            self.state.metrics.record_stream_interruption(
                self.model, endpoint.name
            )

    def record_success(self, endpoint) -> None:
        if self.state.resilience is not None:
            self.state.resilience.record_success(endpoint.id)
        self.state.load_manager.note_endpoint_success(endpoint.id)
        if self.retried:
            self.state.metrics.record_failover_recovery(self.model)

    def record_alive(self, endpoint) -> None:
        """The endpoint responded, but the request did not succeed for a
        reason that is not endpoint sickness (non-retryable 4xx, malformed
        200 body, client disconnect). Liveness evidence for the breaker —
        crucially, it resolves a half-open probe — without counting a
        request success or a failover recovery."""
        if self.state.resilience is not None:
            self.state.resilience.record_success(endpoint.id)

    async def should_retry(self, reason: str) -> bool:
        """True = the caller may re-select and retry (budget spent, backoff
        already slept, attempt count advanced)."""
        resilience = self.state.resilience
        if resilience is None or not self.config.enabled:
            return False
        if self.attempt >= self.config.max_attempts:
            return False
        if self.candidates_fn is not None and not any(
            ep.id not in self.failed_ids for ep in self.candidates_fn()
        ):
            return False
        if not resilience.budget.try_spend():
            self.state.metrics.record_retry_budget_exhausted()
            return False
        self.state.metrics.record_failover_retry(self.model, reason)
        if self.trace is not None:
            self.trace.mark("failover", attempt=self.attempt, reason=reason)
        delay = backoff_delay(self.attempt, self.config)
        self.attempt += 1
        self.retried = True
        if delay > 0:
            await asyncio.sleep(delay)
        return True


# ------------------------------------------------------- upstream HTTP edge


async def upstream_post(state, endpoint, path: str, *, json=None, data=None,
                        headers=None, timeout=None):
    """The one POST every proxy path uses to reach an endpoint. Applies
    fault-injection rules (faults.py) at this boundary: added latency,
    connect-refused, synthetic HTTP status, or a stream cut after K bytes —
    each counted in /metrics so a chaos run is observable."""
    from llmlb_tpu_torch.gateway.faults import UPSTREAM_KINDS

    faults = state.faults
    fired = (faults.decide(endpoint, path, kinds=UPSTREAM_KINDS)
             if faults is not None else ())
    cut_rule = None
    abort_rule = None
    for rule in fired:
        state.metrics.record_fault_injected(rule.kind)
        if rule.kind == "latency" and rule.latency_ms > 0:
            await asyncio.sleep(rule.latency_ms / 1000.0)
        elif rule.kind == "connect_refused":
            raise http.ClientConnectionError(
                f"fault injected: connect refused ({endpoint.name})"
            )
        elif rule.kind == "http":
            return InjectedHTTPResponse(rule.status)
        elif rule.kind == "stream_cut":
            cut_rule = rule
        elif rule.kind == "engine_abort":
            abort_rule = rule
    resp = await state.http.post(
        endpoint.url + path, json=json, data=data, headers=headers,
        timeout=timeout,
    )
    if abort_rule is not None:
        # connection reset after K delivered bytes, no partial event, no
        # prior error frame — the killed-engine signature the mid-stream
        # resume path recovers from (docs/resilience.md)
        return EngineAbortResponse(resp, abort_rule.after_bytes)
    if cut_rule is not None:
        return StreamCutResponse(resp, cut_rule.after_bytes)
    return resp


# ------------------------------------------------------------- Retry-After


def retry_after_seconds(state, model: str | None,
                        capability=None) -> int:
    """Retry-After for a 503: if every endpoint serving the model is
    draining, the soonest drain completion (a replacement engine should be
    registering about then — docs/deployment.md); if every endpoint is
    breaker-open, the soonest breaker reopen; otherwise a fraction of the
    queue timeout (capacity should free up well before a full timeout)."""
    resilience = state.resilience
    if model:
        pairs = state.registry.find_by_model(model, capability)
        eps = [ep for ep, _ in pairs]
        draining = [ep for ep in eps
                    if ep.accelerator is not None and ep.accelerator.draining]
        if eps and len(draining) == len(eps):
            wait = min(ep.accelerator.drain_remaining_s for ep in draining)
            return max(1, min(60, math.ceil(wait)))
        if eps and resilience is not None:
            wait = resilience.soonest_reopen_s([ep.id for ep in eps])
            if wait is not None:
                return max(1, math.ceil(wait))
    queue_timeout = state.load_manager.queue_config.queue_timeout_s
    return max(1, min(30, math.ceil(queue_timeout / 4)))
