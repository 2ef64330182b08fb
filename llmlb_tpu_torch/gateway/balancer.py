"""LoadManager: TPS-EMA scheduling, request leases, in-memory request history.

Behavior parity with the reference scheduler (reference balancer/mod.rs):
- Per-(endpoint, model, api_kind) tokens/sec tracked as an EMA with α=0.2
  (balancer/types.rs:98-121); endpoints with higher measured TPS are preferred.
- Endpoints with no measurement yet score +inf so they get probed first;
  ties (incl. all-unmeasured) break round-robin (balancer/mod.rs:1955-1984).
- RequestLease is an RAII guard: active count increments on acquire and is
  always released — explicitly via complete()/fail(), or by the finalizer if
  the holder forgets (balancer/lease.rs Drop semantics).
- 60-minute in-memory request history ring for dashboards (types.rs:22),
  seeded from the DB at boot.
- TPU-aware extension (no reference counterpart): measured TPS scores are
  multiplied by a telemetry penalty computed from the endpoint's last health
  probe — HBM pressure above HBM_PRESSURE_KNEE fades the score toward zero,
  and a non-empty engine admission queue divides it by (1 + depth). Unmeasured
  endpoints still probe first, but telemetry breaks ties among them before
  round-robin does.
- Prefix-affinity routing (no reference counterpart): requests whose prompt
  head hashes to a recently-routed prefix stick to the endpoint that last
  served it, so the engine-side prefix KV cache (engine/prefix_cache.py)
  actually gets hit. Two modes (LLMLB_AFFINITY):
    * ``lru`` (default single-worker): learned bounded LRU map with TTL —
      the historical behavior, bit-identical to pre-multi-worker gateways.
    * ``ring`` (default with --workers > 1): rendezvous/consistent hashing
      over the live endpoint set — every worker maps the same prompt head
      to the same endpoint with zero coordination, steering survives worker
      restarts, and endpoint churn remaps only ~1/E of keys.
  Both fall back to normal scoring whenever the sticky endpoint is
  unhealthy, absent, or at its cap.
- Gossip replication (gateway/gossip.py, multi-worker): TPS EMA samples and
  (in lru mode) affinity pins publish to sibling workers and apply
  last-writer-wins; a worker that misses updates only places requests
  slightly worse until its own measurements converge.

The port's copy of llmlb_tpu/gateway/balancer.py: the Python core and the
native router core (llmlb_tpu_torch/native/router_core.cpp), which the port
builds from its own sources.
"""

from __future__ import annotations

import asyncio
import bisect
import dataclasses
import hashlib
import os
import threading
import time
import typing
from collections import OrderedDict, defaultdict, deque

from llmlb_tpu_torch.gateway.config import QueueConfig, env_bool
from llmlb_tpu_torch.gateway.gossip import SeqClock, Version, newer
from llmlb_tpu_torch.gateway.types import Endpoint, TpsApiKind

TPS_EMA_ALPHA = 0.2  # parity: balancer/types.rs:109
HISTORY_WINDOW_S = 3600.0  # parity: 60-min window, balancer/types.rs:22
METRICS_STALE_S = 120.0

# Telemetry-aware placement: above this HBM fill fraction an endpoint's score
# fades linearly, reaching TELEMETRY_MIN_PENALTY at 100% full. A KV-cache-bound
# engine near HBM capacity will soon reject or thrash; prefer its peers.
HBM_PRESSURE_KNEE = 0.85
TELEMETRY_MIN_PENALTY = 0.05

# Prefix-affinity routing: the tpu:// engine keeps a prefix KV cache
# (engine/prefix_cache.py), so two requests sharing a system prompt are far
# cheaper on the SAME engine than split across two. The gateway hashes the
# head of each prompt and remembers which endpoint last served that hash;
# the next request with the same hash is steered there as long as the
# endpoint is a live candidate under its admission cap — otherwise selection
# falls back to the normal TPS/telemetry scoring and the hash is re-pinned
# to whatever endpoint wins. The map is bounded (LRU) and entries expire,
# so a dead prefix never pins routing forever.
PREFIX_AFFINITY_CAPACITY = 4096
PREFIX_AFFINITY_TTL_S = 600.0
PREFIX_AFFINITY_CHARS = 512  # ≈ the first 128 prompt tokens
# Heads shorter than this can never clear the engine's minimum cacheable
# prefix (the smallest prefill bucket — 32 tokens ≈ 128 chars on the default
# config), so pinning them would override TPS/telemetry placement for zero
# cache benefit — short prompts keep the old scoring.
PREFIX_AFFINITY_MIN_CHARS = 128


def prefix_affinity_hash(model: str, text: str,
                         lora: str | None = None) -> str | None:
    """Stable hash of a prompt's head (+ model, so two models' identical
    system prompts don't collide onto one engine's cache; + LoRA adapter
    id — under multi-LoRA the prompt KV depends on the adapter's wq/wk/wv
    deltas, so two adapters sharing a system prompt must pin and warm
    caches independently, docs/lora.md). None for heads too short to
    benefit from prefix reuse. lora=None hashes exactly as before, so
    adapter-free affinity keys are unchanged."""
    if len(text) < PREFIX_AFFINITY_MIN_CHARS:
        return None
    head = text[:PREFIX_AFFINITY_CHARS]
    key = (f"{model}\x00{head}" if lora is None
           else f"{model}\x00lora={lora}\x00{head}")
    return hashlib.sha1(key.encode("utf-8", "replace")).hexdigest()


# Gossip: one TPS message per tracked key at most this often — the EMA moves
# slowly, and per-request fan-out would put a datagram on the bus for every
# completion.
TPS_GOSSIP_MIN_INTERVAL_S = 1.0

# Prefix-heat gossip: batch locally observed (hash → endpoint, hits) deltas
# and flush at most this often, so a hot shared prefix costs one datagram
# per interval, not one per request.
HEAT_GOSSIP_MIN_INTERVAL_S = 1.0

AFFINITY_MODES = ("lru", "ring")


def hrw_weight(prefix_hash: str, endpoint_id: str) -> int:
    """Rendezvous (highest-random-weight) score of one (key, endpoint)
    pair: the first 8 bytes of sha256("hash|endpoint") as a big-endian
    integer. The native twin (router_core.cpp hrw_select) computes the
    same bytes, so Python and C++ agree bit for bit."""
    digest = hashlib.sha256(
        f"{prefix_hash}|{endpoint_id}".encode()
    ).digest()
    return int.from_bytes(digest[:8], "big")


def hrw_owner(prefix_hash: str, endpoint_ids: list[str]) -> str | None:
    """Consistent-hash owner of a prefix over the live endpoint set.

    Pure function of (key, set): every worker computes the same owner with
    no shared state, a restart loses nothing, and removing one endpoint
    remaps only the keys it owned (~1/E) — the property a mod-N hash lacks.
    Ties (astronomically unlikely) break toward the smallest endpoint id.
    """
    best: str | None = None
    best_w = -1
    for eid in endpoint_ids:
        w = hrw_weight(prefix_hash, eid)
        if w > best_w or (w == best_w and (best is None or eid < best)):
            best, best_w = eid, w
    return best


def default_affinity_mode(worker_count: int = 1) -> str:
    """LLMLB_AFFINITY beats the worker-count default: ring when several
    workers must agree without coordination, lru (the historical,
    bit-identical behavior) for a single worker."""
    raw = (os.environ.get("LLMLB_AFFINITY") or "").strip().lower()
    if raw in AFFINITY_MODES:
        return raw
    return "ring" if worker_count > 1 else "lru"


def telemetry_penalty(ep: Endpoint, now: float | None = None) -> float:
    """Multiplicative demotion factor in (0, 1] from the endpoint's last
    health-probe telemetry. 1.0 = unloaded, no telemetry, or telemetry older
    than METRICS_STALE_S (a snapshot from a probe that has since stopped
    reporting must not demote an endpoint forever)."""
    acc = ep.accelerator
    if acc is None:
        return 1.0
    if acc.sampled_at <= 0:
        return 1.0
    if ((now if now is not None else time.time()) - acc.sampled_at
            > METRICS_STALE_S):
        return 1.0
    p = 1.0
    pressure = acc.hbm_pressure
    if pressure is not None and pressure > HBM_PRESSURE_KNEE:
        span = 1.0 - HBM_PRESSURE_KNEE
        frac = min(1.0, (pressure - HBM_PRESSURE_KNEE) / span)
        p *= max(TELEMETRY_MIN_PENALTY, 1.0 - frac * (1.0 - TELEMETRY_MIN_PENALTY))
    if acc.queue_depth > 0:
        p /= 1.0 + acc.queue_depth
    return p


@dataclasses.dataclass
class ModelTpsState:
    """EMA of tokens/sec for one (endpoint, model, api_kind)."""

    ema_tps: float = 0.0
    samples: int = 0
    last_update: float = 0.0

    def update(self, tokens: int, duration_s: float, now: float | None = None) -> None:
        if duration_s <= 0 or tokens <= 0:
            return
        tps = tokens / duration_s
        if self.samples == 0:
            self.ema_tps = tps
        else:
            self.ema_tps = TPS_EMA_ALPHA * tps + (1 - TPS_EMA_ALPHA) * self.ema_tps
        self.samples += 1
        self.last_update = now if now is not None else time.time()


@dataclasses.dataclass
class RequestRecord:
    ts: float
    endpoint_id: str
    model: str
    api_kind: TpsApiKind
    status_code: int
    duration_ms: float
    prompt_tokens: int = 0
    completion_tokens: int = 0


class RequestLease:
    """Active-request guard. Release exactly once; idempotent on double release."""

    def __init__(self, manager: "LoadManager", endpoint_id: str, model: str,
                 api_kind: TpsApiKind):
        self.manager = manager
        self.endpoint_id = endpoint_id
        self.model = model
        self.api_kind = api_kind
        self.started_at = time.monotonic()
        self._released = False

    def complete(self) -> None:
        """Request handed off successfully (e.g. stream started)."""
        self._release()

    def complete_with_tokens(self, prompt_tokens: int, completion_tokens: int) -> None:
        duration = time.monotonic() - self.started_at
        self.manager.update_tps(
            self.endpoint_id, self.model, self.api_kind,
            completion_tokens, duration,
        )
        self._release()

    def fail(self) -> None:
        self._release()

    def _release(self) -> None:
        if not self._released:
            self._released = True
            self.manager._release_active(self.endpoint_id)

    def __del__(self):  # Drop-safety: never leak an active count
        self._release()

    def __enter__(self) -> "RequestLease":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self._release()


class LoadManager:
    def __init__(self, queue_config: QueueConfig | None = None,
                 use_native: bool | None = None,
                 affinity_mode: str | None = None):
        self.queue_config = queue_config or QueueConfig()
        self.affinity_mode = (affinity_mode if affinity_mode in AFFINITY_MODES
                              else default_affinity_mode())
        # GossipBus | None (set by app_state in multi-worker mode): TPS
        # samples and lru-mode affinity pins replicate to sibling workers.
        # Advisory only — every consumer of this state tolerates staleness.
        self.gossip = None
        self._tps_pub_ts: dict[tuple[str, str, str], float] = {}
        self._lock = threading.Lock()
        # Seq-LWW versions (gossip.newer): per-key (seq, origin) stamps for
        # TPS/affinity state plus per-endpoint clear tombstones, so a
        # delayed datagram from before a clear can never resurrect stale
        # state — wall stamps don't order across hosts. The local clock is
        # the fallback when no bus is attached (single worker).
        self._local_clock = SeqClock()
        self._tps_ver: dict[tuple[str, str, str], Version] = {}
        self._clear_ver: dict[str, Version] = {}
        # (endpoint_id, model, api_kind) -> ModelTpsState
        self._tps: dict[tuple[str, str, str], ModelTpsState] = {}
        self._active: dict[str, int] = defaultdict(int)
        self._rr_counter: dict[str, int] = defaultdict(int)  # round-robin per model
        self._history: deque[RequestRecord] = deque()
        self._total_requests = 0
        # (model, prefix_hash) -> (endpoint_id, recorded_at, version);
        # recorded_at is LOCAL receipt time (TTL only — skew-free),
        # version is the seq-LWW stamp. Bounded LRU.
        self._affinity: OrderedDict[
            tuple[str, str], tuple[str, float, Version]
        ] = OrderedDict()
        self._affinity_hits = 0
        self._affinity_misses = 0
        self._affinity_evictions = 0
        # Prefix-heat map (LLMLB_AFFINITY_HEAT, ring mode): which endpoint
        # ACTUALLY holds each hot prefix cached, learned locally and over
        # gossip — ring selection prefers a live under-cap holder before
        # the rendezvous owner, so steering follows real cache contents
        # after endpoint churn/migration instead of pure hash topology.
        # (model, prefix_hash) -> [endpoint_id, hits, version]; bounded LRU.
        self.affinity_heat = env_bool("LLMLB_AFFINITY_HEAT", False)
        self._heat: OrderedDict[tuple[str, str], list] = OrderedDict()
        self._heat_pending: dict[str, dict[str, list]] = {}
        self._heat_pub_ts = 0.0
        # In-band per-endpoint outcome stats (resilience layer feeds these;
        # stream interruptions land here too — before this, a stream that
        # died mid-flight never counted against its endpoint because the
        # lease completes at stream start). Independent of the breaker:
        # surfaced in /api/health and stats() even with resilience disabled.
        self._endpoint_outcomes: dict[str, dict] = {}
        # ResilienceManager | None (set by app_state): selection consults
        # allow() so breaker-open endpoints are ejected immediately, and
        # reports admissions via on_admit() (half-open probe accounting).
        self.resilience = None
        # Called (outside the lock) with the endpoint id each time a lease is
        # released — the AdmissionQueue uses it to wake parked waiters instead
        # of having them poll (parity: balancer/mod.rs:2273-2427 notify path).
        self.on_release: typing.Callable[[str], None] | None = None
        # Native scheduler core (native/router_core.cpp): the same state
        # machine in C++, selection-for-selection identical to the Python
        # path below (tested side by side). Python remains the fallback and
        # the behavioral reference. LLMLB_NATIVE_ROUTER=0 disables.
        self._rc = None
        self._hrw_native = None
        if use_native is None:
            use_native = os.environ.get(
                "LLMLB_NATIVE_ROUTER", "1"
            ).lower() not in ("0", "false")
        if use_native:
            try:
                from llmlb_tpu_torch.native import NativeRouterCore

                self._rc = NativeRouterCore(TPS_EMA_ALPHA)
            except (RuntimeError, OSError):
                self._rc = None
            try:
                from llmlb_tpu_torch.native import native_hrw_available, native_hrw_select

                if native_hrw_available():
                    self._hrw_native = native_hrw_select
            except ImportError:
                self._hrw_native = None

    # ------------------------------------------------------------------- TPS

    def update_tps(
        self, endpoint_id: str, model: str, api_kind: TpsApiKind,
        tokens: int, duration_s: float,
    ) -> None:
        if self._rc is not None:
            self._rc.update_tps(endpoint_id, model, api_kind.value,
                                tokens, duration_s, time.time())
            self._stamp_tps(endpoint_id, model, api_kind.value)
            self._maybe_gossip_tps(endpoint_id, model, api_kind.value)
            return
        if duration_s <= 0 or tokens <= 0:
            return  # rejected samples must not create phantom tracked keys
        with self._lock:
            key = (endpoint_id, model, api_kind.value)
            state = self._tps.setdefault(key, ModelTpsState())
            state.update(tokens, duration_s)
        self._stamp_tps(endpoint_id, model, api_kind.value)
        self._maybe_gossip_tps(endpoint_id, model, api_kind.value)

    def _stamp_tps(self, endpoint_id: str, model: str, kind: str) -> None:
        """A local in-band measurement outranks every gossip message this
        worker has already witnessed (Lamport: the tick is causally after
        them) — a delayed stale datagram can never override it."""
        ver = self._next_ver()
        with self._lock:
            self._tps_ver[(endpoint_id, model, kind)] = ver

    # --------------------------------------------------------- tps replication

    def _next_ver(self) -> Version:
        """Allocate a fresh seq-LWW version: the bus's Lamport clock when
        gossip is attached (so local stamps and wire stamps share one
        order), a process-local clock otherwise."""
        g = self.gossip
        if g is not None:
            return g.next_version()
        return (self._local_clock.tick(), "local")

    def _tps_info(self, endpoint_id: str, model: str,
                  kind: str) -> tuple[float, int, float] | None:
        """(ema, samples, last_update) for one key, whichever core holds it."""
        if self._rc is not None:
            return self._rc.tps_info(endpoint_id, model, kind)
        with self._lock:
            state = self._tps.get((endpoint_id, model, kind))
            if state is None or state.samples == 0:
                return None
            return state.ema_tps, state.samples, state.last_update

    def _maybe_gossip_tps(self, endpoint_id: str, model: str,
                          kind: str) -> None:
        g = self.gossip
        if g is None:
            return
        key = (endpoint_id, model, kind)
        now = time.monotonic()
        if now - self._tps_pub_ts.get(key, 0.0) < TPS_GOSSIP_MIN_INTERVAL_S:
            return
        self._tps_pub_ts[key] = now
        info = self._tps_info(endpoint_id, model, kind)
        if info is None:
            return
        ema, samples, _last = info
        g.publish("tps", {"eid": endpoint_id, "model": model, "kind": kind,
                          "ema": ema, "samples": samples})

    def apply_remote_tps(self, endpoint_id: str, model: str, kind: str,
                         ema: float, samples: int, ver: Version) -> None:
        """A sibling worker's EMA, applied seq-LWW: not newer than this
        worker's own stamp (or the endpoint's clear tombstone) is dropped —
        wall stamps skew across hosts and silently resurrected stale state;
        (seq, origin) versions don't. Never re-gossips."""
        ver = tuple(ver)
        key = (endpoint_id, model, kind)
        with self._lock:
            if not newer(ver, self._clear_ver.get(endpoint_id)):
                return
            if not newer(ver, self._tps_ver.get(key)):
                return
            self._tps_ver[key] = ver
            if self._rc is None:
                self._tps[key] = ModelTpsState(
                    ema_tps=ema, samples=max(1, samples),
                    last_update=time.time(),
                )
        if self._rc is not None:
            # local wall only feeds the native core's same-process staleness
            # bookkeeping; cross-worker ordering was decided above
            self._rc.seed_tps(endpoint_id, model, kind, ema,
                              max(1, samples), time.time())

    def seed_tps(self, endpoint_id: str, model: str, api_kind: TpsApiKind,
                 ema_tps: float, samples: int = 1) -> None:
        """Warm-start from persisted daily stats at boot (bootstrap parity)."""
        if self._rc is not None:
            self._rc.seed_tps(endpoint_id, model, api_kind.value,
                              ema_tps, samples, time.time())
            return
        with self._lock:
            self._tps[(endpoint_id, model, api_kind.value)] = ModelTpsState(
                ema_tps=ema_tps, samples=samples, last_update=time.time()
            )

    def get_tps(self, endpoint_id: str, model: str,
                api_kind: TpsApiKind) -> float | None:
        if self._rc is not None:
            return self._rc.get_tps(endpoint_id, model, api_kind.value)
        with self._lock:
            state = self._tps.get((endpoint_id, model, api_kind.value))
            return state.ema_tps if state and state.samples else None

    def clear_tps_for_endpoint(self, endpoint_id: str,
                               _publish: bool = True) -> None:
        """On failure: a recovered endpoint must re-learn (balancer/mod.rs:1791).
        Prefix affinities pinned to it are dropped too — its engine restarts
        with a cold prefix cache, so stickiness buys nothing and would keep
        steering shared-prefix traffic at a flapping endpoint. The clear
        gossips to sibling workers (the pull checker that noticed the
        failure runs in one elected worker only)."""
        ver = self._next_ver()
        self._clear_endpoint_state(endpoint_id, ver)
        if _publish and self.gossip is not None:
            self.gossip.publish("tps_clear", {"eid": endpoint_id},
                                seq=ver[0])

    def apply_remote_tps_clear(self, endpoint_id: str, ver: Version) -> None:
        """A sibling's clear, tombstoned with the WIRE version: any tps or
        affinity datagram published before the clear (lower version) is
        dropped on arrival — no stale-state resurrection, however delayed
        or reordered the transport got. Never re-gossips."""
        ver = tuple(ver)
        with self._lock:
            if not newer(ver, self._clear_ver.get(endpoint_id)):
                return
        self._clear_endpoint_state(endpoint_id, ver)

    def _clear_endpoint_state(self, endpoint_id: str, ver: Version) -> None:
        with self._lock:
            self._clear_ver[endpoint_id] = ver
            for key in [k for k, v in self._affinity.items()
                        if v[0] == endpoint_id]:
                del self._affinity[key]
            for key in [k for k in self._tps_ver if k[0] == endpoint_id]:
                del self._tps_ver[key]
            for key in [k for k, v in self._heat.items()
                        if v[0] == endpoint_id]:
                del self._heat[key]
        if self._rc is not None:
            self._rc.clear_endpoint(endpoint_id)
        else:
            with self._lock:
                self._tps = {
                    k: v for k, v in self._tps.items() if k[0] != endpoint_id
                }

    def tps_snapshot(self) -> dict[str, dict]:
        if self._rc is not None:
            return self._rc.snapshot()
        with self._lock:
            return {
                f"{eid}:{model}:{kind}": {
                    "ema_tps": round(s.ema_tps, 3),
                    "samples": s.samples,
                    "last_update": s.last_update,
                }
                for (eid, model, kind), s in self._tps.items()
            }

    # ------------------------------------------------------- prefix affinity

    def _affinity_peek_locked(self, model: str, prefix_hash: str) -> str | None:
        key = (model, prefix_hash)
        got = self._affinity.get(key)
        if got is None:
            return None
        endpoint_id, ts, _ver = got
        if time.time() - ts > PREFIX_AFFINITY_TTL_S:
            del self._affinity[key]
            return None
        return endpoint_id

    def _affinity_note_locked(self, model: str, prefix_hash: str,
                              endpoint_id: str) -> bool:
        """Returns True when the pin is new or moved to another endpoint
        (the only cases worth gossiping — refreshes are noise)."""
        key = (model, prefix_hash)
        prev = self._affinity.get(key)
        self._affinity[key] = (endpoint_id, time.time(), self._next_ver())
        self._affinity.move_to_end(key)
        while len(self._affinity) > PREFIX_AFFINITY_CAPACITY:
            self._affinity.popitem(last=False)
            self._affinity_evictions += 1
        return prev is None or prev[0] != endpoint_id

    def _gossip_affinity(self, model: str, prefix_hash: str,
                         endpoint_id: str) -> None:
        if self.gossip is not None:
            self.gossip.publish("affinity", {
                "model": model, "hash": prefix_hash, "eid": endpoint_id,
            })

    def apply_remote_affinity(self, model: str, prefix_hash: str,
                              endpoint_id: str, ver: Version) -> None:
        """A sibling worker pinned this prefix (lru mode only — ring mode
        needs no replication, the hash IS the agreement). Seq-LWW on the
        wire version; TTL runs on LOCAL receipt time (remote wall stamps
        would expire early/late under cross-host skew). Never counted as
        hit/miss, never re-gossiped."""
        if self.affinity_mode != "lru":
            return
        ver = tuple(ver)
        with self._lock:
            if not newer(ver, self._clear_ver.get(endpoint_id)):
                return
            key = (model, prefix_hash)
            cur = self._affinity.get(key)
            if cur is not None and not newer(ver, cur[2]):
                return
            self._affinity[key] = (endpoint_id, time.time(), ver)
            self._affinity.move_to_end(key)
            while len(self._affinity) > PREFIX_AFFINITY_CAPACITY:
                self._affinity.popitem(last=False)
                self._affinity_evictions += 1

    # ----------------------------------------------------------- prefix heat

    def _heat_note_locked(self, model: str, prefix_hash: str,
                          endpoint_id: str) -> None:
        """One request for this prefix actually served by `endpoint_id` —
        its KV cache now (still) holds the prefix. Caller holds _lock."""
        key = (model, prefix_hash)
        entry = self._heat.get(key)
        if entry is not None and entry[0] == endpoint_id:
            entry[1] += 1
        else:
            entry = [endpoint_id, 1, self._next_ver()]
            self._heat[key] = entry
        self._heat.move_to_end(key)
        while len(self._heat) > PREFIX_AFFINITY_CAPACITY:
            self._heat.popitem(last=False)
        self._heat_pending.setdefault(model, {})[prefix_hash] = [
            endpoint_id, entry[1],
        ]

    def _maybe_gossip_heat(self) -> None:
        """Flush batched heat deltas at most once per interval (call sites
        must NOT hold _lock — publish writes to sockets)."""
        g = self.gossip
        if g is None or not self.affinity_heat:
            return
        now = time.monotonic()
        with self._lock:
            if (not self._heat_pending
                    or now - self._heat_pub_ts < HEAT_GOSSIP_MIN_INTERVAL_S):
                return
            self._heat_pub_ts = now
            pending, self._heat_pending = self._heat_pending, {}
        for model, entries in pending.items():
            g.publish("heat", {"model": model, "entries": entries})

    def apply_remote_heat(self, model: str, entries: dict,
                          ver: Version) -> None:
        """A sibling's heat deltas: seq-LWW per entry, hit counts merge
        monotonically when both workers agree on the holder. Never
        re-gossips."""
        ver = tuple(ver)
        with self._lock:
            for prefix_hash, value in entries.items():
                if not (isinstance(value, (list, tuple)) and len(value) >= 2):
                    continue
                eid, hits = str(value[0]), int(value[1])
                if not newer(ver, self._clear_ver.get(eid)):
                    continue
                key = (model, str(prefix_hash))
                cur = self._heat.get(key)
                if cur is not None and cur[0] == eid:
                    cur[1] = max(cur[1], hits)
                    cur[2] = max(cur[2], ver)
                elif cur is None or newer(ver, cur[2]):
                    self._heat[key] = [eid, hits, ver]
                self._heat.move_to_end(key)
            while len(self._heat) > PREFIX_AFFINITY_CAPACITY:
                self._heat.popitem(last=False)

    def _heat_endpoint_locked(self, model: str,
                              prefix_hash: str) -> str | None:
        entry = self._heat.get((model, prefix_hash))
        return entry[0] if entry is not None else None

    def _affinity_endpoint(self, model: str,
                           prefix_hash: str | None) -> str | None:
        if prefix_hash is None:
            return None
        with self._lock:
            return self._affinity_peek_locked(model, prefix_hash)

    def _hrw_owner(self, prefix_hash: str, endpoint_ids: list[str]) -> str | None:
        if self._hrw_native is not None:
            idx = self._hrw_native(prefix_hash, endpoint_ids)
            if 0 <= idx < len(endpoint_ids):
                return endpoint_ids[idx]
            return None
        return hrw_owner(prefix_hash, endpoint_ids)

    def _sticky_endpoint_id(self, endpoints: list[Endpoint], model: str,
                            prefix_hash: str | None) -> str | None:
        """The endpoint this prefix should steer to, by affinity mode: the
        learned LRU pin, or the consistent-hash owner over the candidate
        set (post-breaker, pre-cap)."""
        if prefix_hash is None:
            return None
        if self.affinity_mode == "ring":
            if self.affinity_heat:
                # steer by what is ACTUALLY cached where, when known: a
                # migrated/churned prefix keeps hitting its warm engine
                # instead of the (cold) rendezvous owner
                with self._lock:
                    hot = self._heat_endpoint_locked(model, prefix_hash)
                if hot is not None and any(ep.id == hot for ep in endpoints):
                    return hot
            return self._hrw_owner(prefix_hash, [ep.id for ep in endpoints])
        return self._affinity_endpoint(model, prefix_hash)

    def _affinity_record(self, model: str, prefix_hash: str | None,
                         endpoint_id: str, *, hit: bool) -> None:
        if prefix_hash is None:
            return
        changed = False
        with self._lock:
            if self.affinity_mode == "lru":
                changed = self._affinity_note_locked(model, prefix_hash,
                                                     endpoint_id)
            if self.affinity_heat:
                self._heat_note_locked(model, prefix_hash, endpoint_id)
            if hit:
                self._affinity_hits += 1
            else:
                self._affinity_misses += 1
        if changed:
            self._gossip_affinity(model, prefix_hash, endpoint_id)
        self._maybe_gossip_heat()

    def affinity_stats(self) -> dict:
        """Prefix-affinity figures for the gateway /metrics exposition."""
        with self._lock:
            return {
                "entries": len(self._affinity),
                "hits_total": self._affinity_hits,
                "misses_total": self._affinity_misses,
                "evictions_total": self._affinity_evictions,
                "heat_entries": len(self._heat),
            }

    # ------------------------------------------------------ endpoint outcomes

    def _outcomes_for(self, endpoint_id: str) -> dict:
        """Caller holds self._lock."""
        return self._endpoint_outcomes.setdefault(endpoint_id, {
            "successes": 0, "failures": 0, "stream_interruptions": 0,
            "consecutive_failures": 0, "last_failure_ts": None,
        })

    def note_endpoint_success(self, endpoint_id: str) -> None:
        with self._lock:
            o = self._outcomes_for(endpoint_id)
            o["successes"] += 1
            o["consecutive_failures"] = 0

    def note_endpoint_failure(self, endpoint_id: str, *,
                              stream_interruption: bool = False) -> None:
        with self._lock:
            o = self._outcomes_for(endpoint_id)
            o["failures"] += 1
            if stream_interruption:
                o["stream_interruptions"] += 1
            o["consecutive_failures"] += 1
            o["last_failure_ts"] = time.time()

    def endpoint_outcomes(self, endpoint_id: str | None = None) -> dict:
        """In-band outcome counters, per endpoint or the whole map. Pure
        read: never inserts (scrape paths must not grow the map)."""
        with self._lock:
            if endpoint_id is not None:
                o = self._endpoint_outcomes.get(endpoint_id)
                return dict(o) if o is not None else {
                    "successes": 0, "failures": 0, "stream_interruptions": 0,
                    "consecutive_failures": 0, "last_failure_ts": None,
                }
            return {eid: dict(o) for eid, o in self._endpoint_outcomes.items()}

    def drop_endpoint_outcomes(self, endpoint_id: str) -> None:
        """Endpoint deleted: stop carrying its counters (ids churn on
        re-registration; dead entries would inflate stats() forever)."""
        with self._lock:
            self._endpoint_outcomes.pop(endpoint_id, None)

    # -------------------------------------------------------------- selection

    def _permitted(self, endpoints: list[Endpoint]) -> list[Endpoint]:
        """Drop endpoints whose circuit breaker refuses traffic right now,
        and endpoints whose last health probe advertised a graceful drain
        (docs/deployment.md) — both reduce the candidate set, never the 404
        decision: a model whose endpoints are all ejected queues and 503s.
        No resilience manager wired (unit tests, resilience disabled) means
        no breaker filtering; the drain filter always applies."""
        out = [ep for ep in endpoints
               if ep.accelerator is None or not ep.accelerator.draining]
        if self.resilience is None:
            return out
        return [ep for ep in out if self.resilience.allow(ep.id)]

    def _note_admitted(self, endpoint_id: str) -> None:
        if self.resilience is not None:
            self.resilience.on_admit(endpoint_id)

    def select_endpoint(
        self,
        endpoints: list[Endpoint],
        model: str,
        api_kind: TpsApiKind = TpsApiKind.CHAT,
        prefix_hash: str | None = None,
    ) -> Endpoint | None:
        """Pick the best endpoint: prefix affinity first (the endpoint that
        last served this prompt head, while it is a live candidate under its
        cap), then telemetry-weighted measured-TPS desc; unmeasured first
        (probe), telemetry then round-robin among equals; full endpoints
        (admission cap) excluded; breaker-open endpoints ejected."""
        endpoints = self._permitted(endpoints)
        if not endpoints:
            return None
        if self._rc is not None:
            sticky = self._affinity_sticky_rc(endpoints, model, prefix_hash)
            if sticky is not None:
                return sticky
            idx = self._rc_select(endpoints, model, api_kind, admit=False)
            if idx < 0:
                return None
            self._affinity_record(model, prefix_hash, endpoints[idx].id,
                                  hit=False)
            return endpoints[idx]
        with self._lock:
            return self._select_locked(endpoints, model, api_kind,
                                       prefix_hash)

    def _affinity_sticky_rc(self, endpoints: list[Endpoint], model: str,
                            prefix_hash: str | None) -> Endpoint | None:
        """Native-router path: affinity (LRU map or consistent-hash owner)
        steers before delegating to the C++ scorer. Only honors an endpoint
        that is still a candidate and under its admission cap."""
        eid = self._sticky_endpoint_id(endpoints, model, prefix_hash)
        if eid is None:
            return None
        cap = self.queue_config.max_active_per_endpoint
        for ep in endpoints:
            if ep.id == eid and self._rc.active(eid) < cap:
                self._affinity_record(model, prefix_hash, eid, hit=True)
                return ep
        return None

    def _rc_select(self, endpoints: list[Endpoint], model: str,
                   api_kind: TpsApiKind, *, admit: bool) -> int:
        now = time.time()
        return self._rc.select(
            model, api_kind.value,
            [ep.id for ep in endpoints],
            [telemetry_penalty(ep, now) for ep in endpoints],
            self.queue_config.max_active_per_endpoint,
            admit,
        )

    def _select_locked(
        self, endpoints: list[Endpoint], model: str, api_kind: TpsApiKind,
        prefix_hash: str | None = None,
    ) -> Endpoint | None:
        cap = self.queue_config.max_active_per_endpoint
        candidates = [
            ep for ep in endpoints if self._active[ep.id] < cap
        ]
        if not candidates:
            return None

        if prefix_hash is not None:
            if self.affinity_mode == "ring":
                # Consistent-hash owner over the permitted set (not just the
                # under-cap candidates): an at-cap owner counts a miss and
                # falls through to scoring rather than silently remapping —
                # the key snaps back the moment capacity frees. With the
                # heat map on, a live under-cap endpoint KNOWN to hold the
                # prefix cached outranks the hash owner.
                owner = None
                if self.affinity_heat:
                    owner = self._heat_endpoint_locked(model, prefix_hash)
                    if not any(ep.id == owner for ep in candidates):
                        owner = None
                if owner is None:
                    owner = self._hrw_owner(prefix_hash,
                                            [ep.id for ep in endpoints])
                for ep in candidates:
                    if ep.id == owner:
                        if self.affinity_heat:
                            self._heat_note_locked(model, prefix_hash, ep.id)
                        self._affinity_hits += 1
                        return ep
                self._affinity_misses += 1
            else:
                sticky_id = self._affinity_peek_locked(model, prefix_hash)
                for ep in candidates:
                    if ep.id == sticky_id:
                        self._affinity_note_locked(model, prefix_hash, ep.id)
                        self._affinity_hits += 1
                        return ep

        now = time.time()
        scored: list[tuple[float, float, Endpoint]] = []
        for ep in candidates:
            pen = telemetry_penalty(ep, now)
            state = self._tps.get((ep.id, model, api_kind.value))
            if state is None or state.samples == 0:
                s = float("inf")  # unmeasured: probe first
            else:
                s = state.ema_tps * pen
            scored.append((s, pen, ep))

        best = max(s for s, _, _ in scored)
        top = [(pen, ep) for s, pen, ep in scored if s == best]
        if len(top) > 1:
            # inf ties (all unmeasured) and exact-score ties: let telemetry
            # discriminate before falling back to round-robin.
            best_pen = max(pen for pen, _ in top)
            top = [(pen, ep) for pen, ep in top if pen == best_pen]
        idx = self._rr_counter[model] % len(top)
        self._rr_counter[model] += 1
        chosen = top[idx][1]
        if prefix_hash is not None and self.affinity_mode == "lru":
            changed = self._affinity_note_locked(model, prefix_hash, chosen.id)
            self._affinity_misses += 1
            if changed:
                # publish-under-lock is safe: gossip sends are non-blocking
                # datagram writes, never an event-loop round trip
                self._gossip_affinity(model, prefix_hash, chosen.id)
        return chosen

    def try_admit(
        self, endpoints: list[Endpoint], model: str, api_kind: TpsApiKind,
        prefix_hash: str | None = None,
    ) -> tuple[Endpoint, RequestLease] | None:
        """Atomic select + lease under one lock: concurrent admissions cannot
        both pick the last free slot of an endpoint (the select-then-begin
        two-step had that race)."""
        endpoints = self._permitted(endpoints)
        if not endpoints:
            return None
        if self._rc is not None:
            eid = self._sticky_endpoint_id(endpoints, model, prefix_hash)
            sticky = next((ep for ep in endpoints if ep.id == eid), None)
            if sticky is not None:
                # atomic cap-check + begin in the native core, scoped to the
                # sticky endpoint alone; at-cap falls through to full scoring
                got = self._rc.select(
                    model, api_kind.value, [sticky.id],
                    [telemetry_penalty(sticky)],
                    self.queue_config.max_active_per_endpoint, True,
                )
                if got == 0:
                    self._affinity_record(model, prefix_hash, sticky.id,
                                          hit=True)
                    self._note_admitted(sticky.id)
                    return sticky, RequestLease(self, sticky.id, model,
                                                api_kind)
            idx = self._rc_select(endpoints, model, api_kind, admit=True)
            if idx < 0:
                return None
            chosen = endpoints[idx]
            self._affinity_record(model, prefix_hash, chosen.id, hit=False)
            self._note_admitted(chosen.id)
            return chosen, RequestLease(self, chosen.id, model, api_kind)
        with self._lock:
            chosen = self._select_locked(endpoints, model, api_kind,
                                         prefix_hash)
            if chosen is None:
                return None
            self._active[chosen.id] += 1
            self._total_requests += 1
        self._note_admitted(chosen.id)
        return chosen, RequestLease(self, chosen.id, model, api_kind)

    def begin_request(
        self, endpoint: Endpoint, model: str, api_kind: TpsApiKind
    ) -> RequestLease:
        # No _note_admitted here: begin_request callers (playground proxy)
        # target one explicit endpoint, bypass breaker-filtered selection,
        # and never report outcomes — consuming a half-open probe slot from
        # this path would wedge the breaker with no outcome to resolve it.
        if self._rc is not None:
            self._rc.begin(endpoint.id)
            return RequestLease(self, endpoint.id, model, api_kind)
        with self._lock:
            self._active[endpoint.id] += 1
            self._total_requests += 1
        return RequestLease(self, endpoint.id, model, api_kind)

    def _release_active(self, endpoint_id: str) -> None:
        if self._rc is not None:
            self._rc.release(endpoint_id)
        else:
            with self._lock:
                if self._active[endpoint_id] > 0:
                    self._active[endpoint_id] -= 1
        cb = self.on_release
        if cb is not None:
            try:
                cb(endpoint_id)
            except Exception:  # allow-silent: a broken listener must
                pass               # not poison releases

    def active_count(self, endpoint_id: str) -> int:
        if self._rc is not None:
            return self._rc.active(endpoint_id)
        with self._lock:
            return self._active[endpoint_id]

    def total_active(self) -> int:
        if self._rc is not None:
            return self._rc.total_active()
        with self._lock:
            return sum(self._active.values())

    # --------------------------------------------------------------- history

    def record_request(self, record: RequestRecord) -> None:
        with self._lock:
            self._history.append(record)
            cutoff = time.time() - HISTORY_WINDOW_S
            while self._history and self._history[0].ts < cutoff:
                self._history.popleft()

    def history_minute_buckets(self) -> list[dict]:
        """Requests/errors/tokens per minute over the window (dashboard feed)."""
        with self._lock:
            buckets: dict[int, dict] = {}
            for r in self._history:
                minute = int(r.ts // 60) * 60
                b = buckets.setdefault(
                    minute,
                    {"ts": minute, "requests": 0, "errors": 0,
                     "prompt_tokens": 0, "completion_tokens": 0},
                )
                b["requests"] += 1
                if r.status_code >= 400:
                    b["errors"] += 1
                b["prompt_tokens"] += r.prompt_tokens
                b["completion_tokens"] += r.completion_tokens
            return [buckets[k] for k in sorted(buckets)]

    def stats(self) -> dict:
        with self._lock:
            outcome_totals = {
                "endpoint_failures_total": sum(
                    o["failures"] for o in self._endpoint_outcomes.values()
                ),
                "stream_interruptions_total": sum(
                    o["stream_interruptions"]
                    for o in self._endpoint_outcomes.values()
                ),
            }
        if self._rc is not None:
            with self._lock:
                history_size = len(self._history)
            return {
                "total_requests": self._rc.total_requests(),
                "active_requests": self._rc.total_active(),
                "history_size": history_size,
                "tracked_tps_keys": self._rc.tracked_keys(),
                "native_router": True,
                **outcome_totals,
            }
        with self._lock:
            return {
                "total_requests": self._total_requests,
                "active_requests": sum(self._active.values()),
                "history_size": len(self._history),
                "tracked_tps_keys": len(self._tps),
                **outcome_totals,
            }


@dataclasses.dataclass
class WaitResult:
    """Outcome of a queued admission wait (parity: balancer/types.rs
    WaitResult / AdmissionDecision)."""

    admitted: bool
    endpoint: Endpoint | None = None
    lease: RequestLease | None = None
    queue_position: int = 0  # 1-based position held while waiting (0 = fast path)
    waited_s: float = 0.0


# Parked waiters re-check capacity at least this often even without a release
# wake — covers endpoints that register/recover mid-wait (no release fires).
RECHECK_INTERVAL_S = 1.0


class _Ticket:
    __slots__ = ("future", "vtime", "seq", "tenant")

    def __init__(self, vtime: float = 0.0, seq: int = 0,
                 tenant: str | None = None):
        self.future: "asyncio.Future | None" = None
        self.vtime = vtime
        self.seq = seq
        self.tenant = tenant


class AdmissionQueue:
    """Notify-based admission: waiters park on futures that lease releases
    wake, replacing a 50 ms poll loop (parity: the reference's notify-based
    begin_request/WaitResult machinery, balancer/mod.rs:2273-2427).

    Weighted fair queuing (docs/scheduling.md): each parked ticket carries a
    virtual finish time — ``max(vclock, tenant's last vtime) + 1/weight`` —
    and the queue is kept sorted by it. A release wakes every parked waiter
    IN THAT ORDER (the event loop runs their retries in wake order, so the
    smallest-vtime ticket gets first claim on the freed slot): a tenant that
    queued 50 requests advances its own virtual clock 50 steps, so another
    tenant's next request slots in right behind the greedy tenant's FIRST
    ticket, not its fiftieth — each tenant saturates only its own share of
    the contended queue. With one tenant (or ``wfq_enabled=False`` via
    LLMLB_WFQ=0) the order degenerates to exact arrival FIFO, the historical
    behavior. Wakes arriving from other threads (e.g. a lease released by a
    GC finalizer) are marshalled onto the owning event loop with
    call_soon_threadsafe.
    """

    def __init__(self, manager: LoadManager):
        self.manager = manager
        self._tickets: list[_Ticket] = []  # sorted by (vtime, seq)
        self._loop: "asyncio.AbstractEventLoop | None" = None
        # GatewayMetrics, attached by app_state: counts admission
        # re-attempts by parked waiters, labeled by API kind.
        self.metrics = None
        # WFQ state: app_state loads weights from LLMLB_WFQ_WEIGHTS and the
        # enable flag from LLMLB_WFQ (default on).
        self.wfq_enabled = True
        self.weights: dict[str, float] = {}
        self._vclock = 0.0
        self._seq = 0
        self._tenant_vtime: dict[str, float] = {}
        manager.on_release = self._on_release

    def weight_for(self, tenant_name: str | None) -> float:
        return self.weights.get(tenant_name or "", 1.0)

    # ---------------------------------------------------------------- waking

    def _on_release(self, endpoint_id: str) -> None:
        loop = self._loop
        if loop is None or loop.is_closed():
            return
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is loop:
            self._wake_all()
        else:
            try:
                loop.call_soon_threadsafe(self._wake_all)
            except RuntimeError:
                pass  # loop shut down mid-release

    def _wake_all(self) -> None:
        for t in self._tickets:
            if t.future is not None and not t.future.done():
                t.future.set_result(None)

    # --------------------------------------------------------------- waiting

    def position(self, ticket: _Ticket) -> int:
        try:
            return self._tickets.index(ticket) + 1
        except ValueError:
            return 0

    def queue_depth(self) -> int:
        return len(self._tickets)

    def _enqueue(self, tenant: str | None, weight: float) -> _Ticket:
        """Assign the ticket's virtual finish time and insert in vtime
        order. FIFO mode (wfq_enabled=False) stamps the arrival sequence
        instead — bit-identical to the historical queue."""
        self._seq += 1
        if not self.wfq_enabled:
            ticket = _Ticket(vtime=float(self._seq), seq=self._seq,
                             tenant=tenant)
        else:
            key = tenant or ""
            vtime = max(self._vclock, self._tenant_vtime.get(key, 0.0))
            vtime += 1.0 / max(0.01, weight)
            self._tenant_vtime[key] = vtime
            ticket = _Ticket(vtime=vtime, seq=self._seq, tenant=tenant)
        bisect.insort(self._tickets, ticket,
                      key=lambda t: (t.vtime, t.seq))
        return ticket

    def _dequeue(self, ticket: _Ticket, serviced: bool) -> None:
        try:
            self._tickets.remove(ticket)
        except ValueError:
            return
        if serviced and self.wfq_enabled:
            self._vclock = max(self._vclock, ticket.vtime)
        if not any(t.tenant == ticket.tenant for t in self._tickets):
            # Last queued ticket for this tenant: drop its clock entry
            # unconditionally. Serviced tickets already advanced _vclock, so
            # the entry is redundant; UNserviced exits (queue timeout,
            # deadline shed, disconnect) incurred no fairness debt — keeping
            # a vtime ahead of the vclock would both penalize the tenant's
            # next request for work it never received and leak one map entry
            # per tenant whose last wait timed out (ip-keyed tenants make
            # that unbounded under exactly the overload that forms queues).
            self._tenant_vtime.pop(ticket.tenant or "", None)

    async def admit(
        self,
        get_endpoints,
        model: str,
        api_kind: TpsApiKind,
        timeout_s: float | None = None,
        prefix_hash: str | None = None,
        tenant: str | None = None,
        weight: float = 1.0,
    ) -> WaitResult:
        """Admit onto the best endpoint, parking until a slot frees or the
        queue timeout passes. `get_endpoints` is re-invoked on every retry so
        registry changes (recovered/added endpoints) are picked up.
        `prefix_hash` biases selection toward the endpoint whose prefix KV
        cache is warm for this prompt head. `tenant`/`weight` feed the
        weighted-fair queue order — the uncontended fast path below never
        touches WFQ state, so fairness costs nothing until there is a queue."""
        start = time.monotonic()
        got = self.manager.try_admit(get_endpoints(), model, api_kind,
                                     prefix_hash)
        if got is not None:
            return WaitResult(admitted=True, endpoint=got[0], lease=got[1])

        if timeout_s is None:
            timeout_s = self.manager.queue_config.queue_timeout_s
        self._loop = asyncio.get_running_loop()
        deadline = start + timeout_s
        ticket = self._enqueue(tenant, weight)
        serviced = False
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return WaitResult(
                        admitted=False,
                        queue_position=self.position(ticket),
                        waited_s=time.monotonic() - start,
                    )
                ticket.future = self._loop.create_future()
                try:
                    # The release notification is the fast path; the bounded
                    # wait is a slow safety tick so capacity that appears
                    # WITHOUT a release (an endpoint registering or
                    # recovering mid-wait) is still noticed promptly.
                    await asyncio.wait_for(
                        ticket.future,
                        timeout=min(remaining, RECHECK_INTERVAL_S),
                    )
                except asyncio.TimeoutError:
                    pass  # fall through to retry; deadline checked at top
                if self.metrics is not None:
                    self.metrics.record_retry(api_kind.value)
                got = self.manager.try_admit(get_endpoints(), model, api_kind,
                                             prefix_hash)
                if got is not None:
                    serviced = True
                    return WaitResult(
                        admitted=True, endpoint=got[0], lease=got[1],
                        queue_position=self.position(ticket),
                        waited_s=time.monotonic() - start,
                    )
        finally:
            self._dequeue(ticket, serviced)
