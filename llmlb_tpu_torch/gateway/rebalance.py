"""Proactive live-stream rebalancing: the port's copy of
llmlb_tpu/gateway/rebalance.py.

Moving a LIVE stream is a gateway decision (`/v1/resume`), made O(bytes)
by KV page shipping; failure pulls that trigger reactively. This module is
the planner: a loop in the elected primary worker that watches
per-endpoint occupancy, queue depth, TPS EMAs and SLO goodput, and when
engine A is overloaded while engine B sits idle, migrates live streams A->B
through the resume + KV-export path while the client keeps streaming.
Drain, rolling restart, autoscale-down and hot-spot dissipation are all the
same mechanism with a different `reason` label: an engine that advertises
draining gets evacuated; an overloaded one gets bled down to the
hysteresis band.

Split of responsibilities:

- ``Rebalancer`` (primary worker only): scores endpoints, applies hysteresis
  and the migration budget, and issues directives — locally to its own
  ``StreamDirectory`` and over gossip (``migrate``) so sibling workers move
  their streams too. Directives are advisory like all gossip: a worker that
  misses one just keeps serving from the hot engine until the next tick.
- ``StreamDirectory`` (every worker): the worker's live streams by gateway
  request id. The streaming pump (api_openai) checks its handle at frame
  boundaries and performs the actual migration; a refused or failed adopt
  aborts instantly to the reactive failover path with the origin unharmed.

Safety rails (docs/resilience.md):
  hysteresis bands   — migrate only when source ≥ high AND target ≤ low for
                       consecutive ticks; a source between bands is left
                       alone, so load noise cannot thrash streams.
  migration budget   — at most `max_concurrent` in flight and `per_minute`
                       stream moves per minute, fleet-directive-side.
  per-stream window  — the same stream is never migrated twice within
                       `stream_window_s`.
  SLO gate           — hot-spot migrations are skipped entirely while the
                       fleet's goodput ratio is healthy and the hot engine
                       has no queue: visible pain first, churn second.
``LLMLB_REBALANCE=0`` disables registration and the loop — bit-compatible
with the gateway without the rebalancer.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import threading
import time
from collections import deque

from llmlb_tpu_torch.gateway.config import env_bool, env_float, env_int

log = logging.getLogger("llmlb_tpu_torch.gateway.rebalance")

# Consecutive ticks a source must hold above the high band before a hotspot
# directive fires — one noisy probe sample must not move a stream.
HYSTERESIS_TICKS = 2

# When telemetry gives no slot count, assume this capacity for the
# occupancy score (matches the engine default of 8 decode slots).
DEFAULT_SLOTS = 8


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    enabled: bool = True
    interval_s: float = 2.0
    # occupancy bands: (active_slots + queued) / num_slots
    high_water: float = 0.85
    low_water: float = 0.4
    max_concurrent: int = 2
    per_minute: int = 6
    stream_window_s: float = 60.0
    # hot-spot migrations are suppressed while fleet goodput holds at or
    # above this ratio AND the hot engine has an empty queue (1.0 = always
    # willing to migrate; SLO accounting disabled = gate inert)
    min_goodput: float = 0.98

    @classmethod
    def from_env(cls) -> "RebalanceConfig":
        return cls(
            enabled=env_bool("LLMLB_REBALANCE", True),
            interval_s=env_float("LLMLB_REBALANCE_INTERVAL", 2.0),
            high_water=env_float("LLMLB_REBALANCE_HIGH", 0.85),
            low_water=env_float("LLMLB_REBALANCE_LOW", 0.4),
            max_concurrent=env_int("LLMLB_REBALANCE_MAX_CONCURRENT", 2),
            per_minute=env_int("LLMLB_REBALANCE_PER_MINUTE", 6),
            stream_window_s=env_float("LLMLB_REBALANCE_STREAM_WINDOW", 60.0),
            min_goodput=env_float("LLMLB_REBALANCE_MIN_GOODPUT", 0.98),
        )


class StreamHandle:
    """One live stream this worker is pumping. The pump owns the handle;
    the directory (gossip/rebalancer side) only ever sets `pending` —
    single-writer per field, so a directive racing a natural finish cannot
    corrupt anything: the pump simply never looks again."""

    __slots__ = ("rid", "model", "endpoint_id", "started_at", "migrations",
                 "last_migrate_at", "pending", "migrating", "done")

    def __init__(self, rid: str, model: str, endpoint_id: str):
        self.rid = rid
        self.model = model
        self.endpoint_id = endpoint_id
        self.started_at = time.monotonic()
        self.migrations = 0
        self.last_migrate_at = 0.0
        # (target_eid, reason, directive_id) | None — set by the directory,
        # claimed by the pump at a frame boundary
        self.pending: tuple | None = None
        self.migrating = False  # claimed and in flight
        self.done = False


class StreamDirectory:
    """Live streams on THIS worker, keyed by gateway request id. The pump
    registers on stream start and unregisters in its finally block; the
    rebalancer (local tick or a gossiped directive) marks handles pending."""

    def __init__(self, config: RebalanceConfig | None = None):
        self.config = config or RebalanceConfig.from_env()
        self._lock = threading.Lock()
        self._streams: dict[str, StreamHandle] = {}

    def register(self, rid: str, model: str,
                 endpoint_id: str) -> StreamHandle | None:
        if not self.config.enabled:
            return None  # LLMLB_REBALANCE=0: invisible, bit-compatible
        handle = StreamHandle(rid, model, endpoint_id)
        with self._lock:
            self._streams[rid] = handle
        return handle

    def unregister(self, handle: StreamHandle | None) -> None:
        """Stream finished (naturally or not). A directive that raced the
        finish dies here un-acted-on — no orphaned lease, no accounting."""
        if handle is None:
            return
        handle.done = True
        handle.pending = None
        with self._lock:
            self._streams.pop(handle.rid, None)

    def claim(self, handle: StreamHandle) -> tuple | None:
        """Pump-side: atomically take a pending directive (returns
        (target, reason, directive_id) or None). The claim moves the handle
        into `migrating` until note_outcome resolves it."""
        with self._lock:
            pending = handle.pending
            if pending is None or handle.done:
                return None
            handle.pending = None
            handle.migrating = True
            return pending

    def note_outcome(self, handle: StreamHandle, *, success: bool,
                     target: str | None = None) -> None:
        """Pump-side: migration resolved. Success re-homes the handle; any
        outcome stamps the window so the next directive skips this stream."""
        with self._lock:
            handle.migrating = False
            handle.last_migrate_at = time.monotonic()
            if success and target:
                handle.endpoint_id = target
                handle.migrations += 1

    def apply_directive(self, eid: str, target: str, reason: str,
                        max_streams: int, directive_id: int) -> int:
        """Mark up to `max_streams` eligible streams on `eid` pending
        migration to `target`; returns how many were marked. Eligible =
        live, not already pending/migrating, outside the per-stream
        window. Oldest first — the longest stream has the most KV to lose
        to a crash and the most to gain from an idle engine."""
        if max_streams <= 0:
            return 0
        now = time.monotonic()
        window = self.config.stream_window_s
        marked = 0
        with self._lock:
            candidates = sorted(
                (h for h in self._streams.values()
                 if h.endpoint_id == eid and not h.done
                 and h.pending is None and not h.migrating
                 and now - h.last_migrate_at > window),
                key=lambda h: h.started_at,
            )
            for h in candidates[:max_streams]:
                h.pending = (target, reason, directive_id)
                marked += 1
        return marked

    def inflight(self) -> int:
        with self._lock:
            return sum(1 for h in self._streams.values()
                       if h.pending is not None or h.migrating)

    def counts(self) -> dict[str, int]:
        """Live streams per endpoint (rebalancer scoring input)."""
        with self._lock:
            out: dict[str, int] = {}
            for h in self._streams.values():
                out[h.endpoint_id] = out.get(h.endpoint_id, 0) + 1
            return out

    def snapshot(self) -> dict:
        with self._lock:
            by_endpoint: dict[str, int] = {}
            for h in self._streams.values():
                by_endpoint[h.endpoint_id] = by_endpoint.get(
                    h.endpoint_id, 0) + 1
            return {
                "streams": len(self._streams),
                "inflight_migrations": sum(
                    1 for h in self._streams.values()
                    if h.pending is not None or h.migrating
                ),
                "by_endpoint": by_endpoint,
            }


class Rebalancer:
    """The planner loop (primary worker only — the single-writer discipline
    that already scopes the health checker and maintenance there)."""

    def __init__(self, registry, load_manager, directory: StreamDirectory,
                 *, metrics=None, gossip=None,
                 config: RebalanceConfig | None = None):
        self.registry = registry
        self.load_manager = load_manager
        self.directory = directory
        self.metrics = metrics
        self.gossip = gossip
        self.config = config or RebalanceConfig.from_env()
        self._task: asyncio.Task | None = None
        self._over: dict[str, int] = {}       # eid -> consecutive hot ticks
        self._issued: deque[float] = deque()  # per-minute budget (monotonic)
        self._directive_seq = 0
        self.directives_total = 0
        self.skipped_budget_total = 0

    # ------------------------------------------------------------- lifecycle

    def start(self) -> None:
        if self.config.enabled and self._task is None:
            self._task = asyncio.create_task(self._loop(), name="rebalancer")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.interval_s)
            try:
                self.tick()
            except Exception:
                log.exception("rebalance tick failed")

    # --------------------------------------------------------------- scoring

    def _resumable(self) -> list:
        from llmlb_tpu_torch.gateway.replay import RESUMABLE_ENDPOINT_TYPES

        return [
            ep for ep in self.registry.list_online()
            if ep.endpoint_type.value in RESUMABLE_ENDPOINT_TYPES
        ]

    def score(self, ep) -> float:
        """Occupancy pressure: (busy slots + queued) / capacity. Telemetry
        (engine /api/health via the probe loop) when fresh, gateway-side
        active counts otherwise — both advisory, the bands absorb noise."""
        acc = getattr(ep, "accelerator", None)
        if acc is not None and getattr(acc, "num_slots", 0):
            return (acc.active_slots + acc.queue_depth) / max(
                1, acc.num_slots)
        return self.load_manager.active_count(ep.id) / float(DEFAULT_SLOTS)

    def _goodput_degraded(self) -> bool:
        """True only when SLO accounting has a measurement AND it is below
        the gate — unknown goodput never justifies churn."""
        if self.metrics is None:
            return False
        try:
            ratio = self.metrics.summary().get("goodput_ratio")
        except Exception:
            return False
        return ratio is not None and ratio < self.config.min_goodput

    # ------------------------------------------------------------ directives

    def _budget_allows(self, n: int) -> int:
        """Clamp a wanted stream count to the budget; 0 = skip. Charges
        nothing — `_charge` runs after the directive actually issues."""
        now = time.monotonic()
        while self._issued and now - self._issued[0] > 60.0:
            self._issued.popleft()
        room_minute = self.config.per_minute - len(self._issued)
        room_concurrent = self.config.max_concurrent - self.directory.inflight()
        return max(0, min(n, room_minute, room_concurrent))

    def _charge(self, n: int) -> None:
        now = time.monotonic()
        for _ in range(n):
            self._issued.append(now)

    def _issue(self, src_eid: str, target_eid: str, reason: str,
               n: int) -> int:
        granted = self._budget_allows(n)
        if granted <= 0:
            self.skipped_budget_total += 1
            if self.metrics is not None:
                self.metrics.record_rebalance_migration(reason, "skipped")
            return 0
        self._directive_seq += 1
        directive_id = self._directive_seq
        # local streams first (gossip never loops back to ourselves)...
        marked = self.directory.apply_directive(
            src_eid, target_eid, reason, granted, directive_id)
        # ...then every sibling worker, same budget figure: each worker
        # moves at most `granted` of ITS streams — the budget is per
        # directive, deliberately conservative against double counting.
        if self.gossip is not None:
            self.gossip.publish("migrate", {
                "eid": src_eid,
                "target": target_eid,
                "reason": reason,
                "max_streams": granted,
                "directive_id": directive_id,
            })
        self._charge(max(1, marked))
        self.directives_total += 1
        log.info("rebalance directive #%d: %s -> %s (%s, up to %d streams, "
                 "%d marked locally)", directive_id, src_eid, target_eid,
                 reason, granted, marked)
        return granted

    def evacuate(self, eid: str, reason: str = "drain",
                 target: str | None = None) -> int:
        """Move every stream off `eid` (budget-paced): the drain runbook,
        rolling restarts and autoscale-down all enter here — repeatedly, one
        tick at a time, until the endpoint is empty."""
        eps = [ep for ep in self._resumable() if ep.id != eid]
        if not eps:
            return 0
        if target is None:
            target = min(eps, key=self.score).id
        return self._issue(eid, target, reason,
                           self.config.max_concurrent)

    # ------------------------------------------------------------------ tick

    def tick(self) -> None:
        """One planning pass. Public (not just the loop's callee) so tests
        and the bench drive it deterministically."""
        eps = self._resumable()
        if len(eps) < 2:
            return
        scores = {ep.id: self.score(ep) for ep in eps}

        # 1) evacuation: an engine advertising draining (rolling restart,
        #    autoscale-down, operator drain) gets its streams moved NOW —
        #    proactively, not when its connections die.
        draining = [ep for ep in eps
                    if getattr(ep.accelerator, "draining", False)]
        for ep in draining:
            healthy = [e for e in eps if e.id != ep.id
                       and not getattr(e.accelerator, "draining", False)]
            if not healthy:
                continue
            target = min(healthy, key=lambda e: scores[e.id])
            self._issue(ep.id, target.id, "drain",
                        self.config.max_concurrent)

        # 2) hot-spot dissipation, hysteresis-banded.
        candidates = [ep for ep in eps if ep not in draining]
        if len(candidates) < 2:
            return
        src = max(candidates, key=lambda e: scores[e.id])
        if scores[src.id] >= self.config.high_water:
            self._over[src.id] = self._over.get(src.id, 0) + 1
        else:
            self._over.pop(src.id, None)
            return
        if self._over[src.id] < HYSTERESIS_TICKS:
            return
        targets = [e for e in candidates if e.id != src.id
                   and scores[e.id] <= self.config.low_water]
        if not targets:
            return
        # no queue on the hot engine and no measured SLO pain: high
        # occupancy is just good utilization — leave the streams alone
        src_queue = getattr(src.accelerator, "queue_depth", 0) or 0
        if src_queue == 0 and not self._goodput_degraded():
            return
        # fastest idle engine wins the stream: prefer the lowest score,
        # break ties toward the higher decode TPS EMA for the hot model mix
        target = min(targets, key=lambda e: (round(scores[e.id], 3),
                                             -self._tps_hint(e.id)))
        self._issue(src.id, target.id, "hotspot", 1)
        self._over.pop(src.id, None)  # re-arm hysteresis after acting

    def _tps_hint(self, eid: str) -> float:
        """Best decode TPS EMA observed for an endpoint across models —
        tiebreak only, so staleness is harmless."""
        try:
            snap = self.load_manager.tps_snapshot()
        except Exception:
            return 0.0
        best = 0.0
        for key, s in snap.items():
            if key.startswith(f"{eid}:"):
                best = max(best, float(s.get("ema_tps") or 0.0))
        return best

    def snapshot(self) -> dict:
        return {
            "enabled": self.config.enabled,
            "directives_total": self.directives_total,
            "skipped_budget_total": self.skipped_budget_total,
            "inflight": self.directory.inflight(),
            "bands": {"high": self.config.high_water,
                      "low": self.config.low_water},
        }
