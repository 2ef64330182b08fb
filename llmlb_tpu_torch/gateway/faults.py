"""Deterministic fault injection at the gateway's upstream HTTP boundary.

The resilience layer (resilience.py) exists to absorb endpoint death, slow
death, and mid-stream cuts — none of which can be tested reliably by killing
real sockets on cue. This module injects those failures *inside the proxy's
HTTP boundary* instead: every upstream POST consults a rule table and may be
turned into a connect error, delayed, answered with a synthetic HTTP status,
or have its response stream cut after K bytes. Rules fire deterministically
(`every_n` counters, or probabilities drawn from one seeded RNG), so chaos
tests replay bit-for-bit.

Rules come from the ``LLMLB_FAULTS`` env var (a JSON list, see FaultRule) or
are installed programmatically (``state.faults.add_rule``, used by tests and
``scripts/bench_gateway.py --workload chaos``). No rules configured = zero
work on the hot path (``state.faults`` is None).

No reference counterpart: the reference repo has no failure-injection story
at all; this is the harness the ROADMAP's "handles as many scenarios as you
can imagine" demands.
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import threading

from llmlb_tpu_torch.gateway import http

VALID_KINDS = ("connect_refused", "latency", "http", "stream_cut",
               "engine_abort", "stalled_reader")

# Kinds applied at the upstream POST boundary (resilience.upstream_post);
# stalled_reader is applied in the CLIENT-side stream pump instead — it
# simulates a reader that stops draining the SSE stream (after_bytes sets
# the stall point, latency_ms the stall duration), which the pump's write
# timeout must catch (docs/scheduling.md slow-loris protection).
UPSTREAM_KINDS = ("connect_refused", "latency", "http", "stream_cut",
                  "engine_abort")


@dataclasses.dataclass
class FaultRule:
    """One injection rule.

    JSON shape (``LLMLB_FAULTS`` is a list of these)::

        {"kind": "connect_refused",        # or latency | http | stream_cut
         "endpoint": "tpu-a",              # endpoint name/id/URL substring,
                                           # "*" matches every endpoint
         "path": "/v1/chat",               # request-path substring (optional)
         "every_n": 1,                     # fire on every Nth matching call…
         "probability": 0.25,              # …or with seeded probability
         "status": 500,                    # kind=http: synthetic status
         "latency_ms": 250,                # kind=latency: added delay
         "after_bytes": 100,               # kind=stream_cut: cut point
         "max_fires": 10}                  # optional cap, then rule is inert

    Exactly one of ``every_n`` / ``probability`` should be set; neither means
    fire on every match (same as ``every_n: 1``).
    """

    kind: str
    endpoint: str = "*"
    path: str | None = None
    every_n: int | None = None
    probability: float | None = None
    status: int = 500
    latency_ms: float = 0.0
    after_bytes: int = 0
    max_fires: int | None = None
    # runtime counters (not part of the config surface)
    seen: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.kind not in VALID_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (expected one of "
                f"{', '.join(VALID_KINDS)})"
            )

    def matches(self, endpoint, path: str) -> bool:
        if self.path is not None and self.path not in path:
            return False
        if self.endpoint == "*":
            return True
        return (
            self.endpoint in endpoint.name
            or self.endpoint == endpoint.id
            or self.endpoint in endpoint.url
        )


class InjectedHTTPResponse:
    """Quacks enough like an aiohttp ClientResponse for the proxy paths:
    ``status``, ``headers``, ``read()``, ``release()``. Never streams —
    the proxies only stream 200s, and injected statuses are errors."""

    def __init__(self, status: int):
        self.status = status
        self.headers: dict[str, str] = {"Content-Type": "application/json"}
        self._body = json.dumps(
            {"error": {"message": "fault injected", "type": "server_error",
                       "code": "fault_injected"}}
        ).encode()

    async def read(self) -> bytes:
        return self._body

    def release(self) -> None:
        pass


class _CutContent:
    """Async-iterates the inner response content, raising a client error
    after the byte budget is spent — a mid-stream connection cut."""

    def __init__(self, inner, after_bytes: int):
        self._inner = inner
        self._budget = after_bytes

    async def iter_any(self):
        async for chunk in self._inner.iter_any():
            if len(chunk) >= self._budget:
                if self._budget > 0:
                    yield chunk[: self._budget]
                raise http.ServerDisconnectedError(
                    "fault injected: stream cut"
                )
            self._budget -= len(chunk)
            yield chunk


class _AbortContent:
    """Async-iterates the inner response content, raising ConnectionResetError
    once `after_bytes` whole chunks have been delivered — the SIGKILLed-engine
    signature: the socket resets cleanly between frames, with NO partial event
    and NO prior error frame. Distinct from `_CutContent`, which delivers a
    truncated partial chunk first (a cut that can land mid-line): with
    `after_bytes` aligned to a frame boundary this rule reproduces exactly
    what a killed engine process looks like to the proxy, so the mid-stream
    resume path is unit-testable without forking processes."""

    def __init__(self, inner, after_bytes: int):
        self._inner = inner
        self._budget = after_bytes

    async def iter_any(self):
        async for chunk in self._inner.iter_any():
            if len(chunk) > self._budget:
                raise ConnectionResetError(
                    "fault injected: engine abort"
                )
            self._budget -= len(chunk)
            yield chunk
        if self._budget > 0:
            # the stream ended before the abort point: reset at EOF anyway —
            # the rule promised a reset, and a silently clean end would make
            # a mis-sized test pass for the wrong reason
            raise ConnectionResetError("fault injected: engine abort at EOF")


class EngineAbortResponse:
    """Wraps a real upstream response so its connection resets after K
    delivered bytes with no prior error frame (kind="engine_abort")."""

    def __init__(self, inner, after_bytes: int):
        self._inner = inner
        self.content = _AbortContent(inner.content, after_bytes)

    @property
    def status(self) -> int:
        return self._inner.status

    @property
    def headers(self):
        return self._inner.headers

    async def read(self) -> bytes:
        raise ConnectionResetError("fault injected: engine abort")

    def release(self) -> None:
        self._inner.release()


class StreamCutResponse:
    """Wraps a real upstream response so its body stream dies after K bytes."""

    def __init__(self, inner, after_bytes: int):
        self._inner = inner
        self.content = _CutContent(inner.content, after_bytes)

    @property
    def status(self) -> int:
        return self._inner.status

    @property
    def headers(self):
        return self._inner.headers

    async def read(self) -> bytes:
        return await self._inner.read()

    def release(self) -> None:
        self._inner.release()


class FaultInjector:
    """Rule table + deterministic firing state. Thread-safe (counters are
    read from /api/health while the event loop proxies)."""

    def __init__(self, rules: list[FaultRule] | None = None, seed: int = 0):
        self._lock = threading.Lock()
        self._rules: list[FaultRule] = list(rules or [])
        self._rng = random.Random(seed)

    @classmethod
    def from_env(cls) -> "FaultInjector | None":
        raw = os.environ.get("LLMLB_FAULTS")
        if not raw:
            return None
        try:
            spec = json.loads(raw)
            rules = [FaultRule(**r) for r in spec]
        except (ValueError, TypeError) as e:
            raise ValueError(f"LLMLB_FAULTS is not a valid rule list: {e}")
        seed = int(os.environ.get("LLMLB_FAULTS_SEED", "0") or 0)
        return cls(rules, seed=seed)

    def add_rule(self, rule: FaultRule) -> FaultRule:
        with self._lock:
            self._rules.append(rule)
        return rule

    def remove_rule(self, rule: FaultRule) -> None:
        with self._lock:
            if rule in self._rules:
                self._rules.remove(rule)

    def clear(self) -> None:
        with self._lock:
            self._rules.clear()

    def decide(self, endpoint, path: str,
               kinds: tuple[str, ...] | None = None) -> list[FaultRule]:
        """All rules that fire for this upstream call, in table order.
        Counters advance per *matching* call, so `every_n` is deterministic
        regardless of what other endpoints are doing. `kinds` restricts
        which rule kinds this call site applies (rules outside it neither
        fire nor advance their counters here — the stream pump and the
        upstream POST each consult their own kinds exactly once)."""
        fired: list[FaultRule] = []
        with self._lock:
            for rule in self._rules:
                if kinds is not None and rule.kind not in kinds:
                    continue
                if not rule.matches(endpoint, path):
                    continue
                if rule.max_fires is not None and rule.fires >= rule.max_fires:
                    continue
                rule.seen += 1
                if rule.probability is not None:
                    fire = self._rng.random() < rule.probability
                else:
                    n = rule.every_n or 1
                    fire = rule.seen % n == 0
                if fire:
                    rule.fires += 1
                    fired.append(rule)
        return fired

    def snapshot(self) -> list[dict]:
        """Per-rule config + fire counts for /api/health."""
        with self._lock:
            return [
                {
                    "kind": r.kind, "endpoint": r.endpoint, "path": r.path,
                    "every_n": r.every_n, "probability": r.probability,
                    "status": r.status if r.kind == "http" else None,
                    "latency_ms": (r.latency_ms
                                   if r.kind in ("latency", "stalled_reader")
                                   else None),
                    "after_bytes": (r.after_bytes
                                    if r.kind in ("stream_cut",
                                                  "engine_abort",
                                                  "stalled_reader")
                                    else None),
                    "seen": r.seen, "fires": r.fires,
                }
                for r in self._rules
            ]
