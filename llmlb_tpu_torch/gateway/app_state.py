"""AppState: shared state injected into all handlers + bootstrap sequence.

The port's counterpart of llmlb_tpu/gateway/app_state.py at one worker: DB +
schema, registry cache load, LoadManager seeding from daily stats, the shared
HTTP client (gateway/http.py), admin bootstrap, JWT secret provisioning,
the dashboard event bus (handed to the trace store, the breakers and the
health checker, as the reference's), the audit log (its chain verified at
start and hourly), breakers and retry budget, rate limits, health checker,
history retention. The reference's gossip bus and metrics spool (multi-worker
serving), rebalancer, update manager and tray come with the slices that
port them.
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import logging
import secrets
import threading
import time

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.audit import AuditLog
from llmlb_tpu_torch.gateway.auth import (
    ApiKeyStore,
    InvitationStore,
    UserStore,
    ensure_admin_exists,
)
from llmlb_tpu_torch.gateway.balancer import (
    AdmissionQueue,
    LoadManager,
    default_affinity_mode,
)
from llmlb_tpu_torch.gateway.config import (
    QueueConfig,
    RateLimitConfig,
    ResilienceConfig,
    ServerConfig,
    SloConfig,
    env_bool,
    env_float,
    env_int,
    wfq_weights_from_env,
)
from llmlb_tpu_torch.gateway.db import Database
from llmlb_tpu_torch.gateway.events import DashboardEventBus
from llmlb_tpu_torch.gateway.faults import FaultInjector
from llmlb_tpu_torch.gateway.gate import InferenceGate
from llmlb_tpu_torch.gateway.health import EndpointHealthChecker
from llmlb_tpu_torch.gateway.metrics import GatewayMetrics
from llmlb_tpu_torch.gateway.ratelimit import RateLimiter
from llmlb_tpu_torch.gateway.registry import EndpointRegistry
from llmlb_tpu_torch.gateway.resilience import ResilienceManager
from llmlb_tpu_torch.gateway.tracing import TraceStore
from llmlb_tpu_torch.gateway.types import TpsApiKind

log = logging.getLogger("llmlb_tpu_torch.gateway")


class HistoryWriter:
    """Request-history + daily-stat DB writes.

    Synchronous by default (bit-identical to the historical per-request
    execute). In multi-worker mode (or with LLMLB_HISTORY_FLUSH_SECS set)
    rows buffer in memory and a periodic task flushes them in one
    transaction each — N workers' hot paths then take the WAL writer lock a
    couple of times per second instead of three times per request, which is
    the difference between near-linear scaling and serializing on SQLite.
    """

    _HISTORY_SQL = (
        "INSERT INTO request_history "
        "(id, ts, endpoint_id, endpoint_name, model, api_kind, path, "
        " status_code, duration_ms, prompt_tokens, completion_tokens, "
        " client_ip, api_key_id, user_id, stream, error, request_body) "
        "VALUES (?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?,?)"
    )
    _DAILY_SQL = (
        "INSERT INTO endpoint_daily_stats "
        "(endpoint_id, date, model, api_kind, request_count, error_count, "
        " prompt_tokens, completion_tokens, total_duration_ms) "
        "VALUES (?,?,?,?,1,?,?,?,?) "
        "ON CONFLICT(endpoint_id, date, model, api_kind) DO UPDATE SET "
        "request_count = request_count + 1, "
        "error_count = error_count + excluded.error_count, "
        "prompt_tokens = prompt_tokens + excluded.prompt_tokens, "
        "completion_tokens = completion_tokens + excluded.completion_tokens, "
        "total_duration_ms = total_duration_ms + excluded.total_duration_ms"
    )

    def __init__(self, db: Database, batched: bool = False,
                 flush_interval_s: float = 0.5):
        self.db = db
        self.batched = batched
        self.flush_interval_s = flush_interval_s
        self._lock = threading.Lock()
        self._history_rows: list[tuple] = []
        self._daily_rows: list[tuple] = []
        self._task: asyncio.Task | None = None

    # Backstop for batched writers whose flush task is not running (an
    # embedder building a multi-worker state with start_background=False):
    # past this many buffered rows, add_* flushes inline instead of
    # growing without bound.
    MAX_BUFFERED_ROWS = 10_000

    def add_history(self, params: tuple) -> None:
        if not self.batched:
            self.db.execute(self._HISTORY_SQL, params)
            return
        with self._lock:
            self._history_rows.append(params)
            overflow = len(self._history_rows) >= self.MAX_BUFFERED_ROWS
        if overflow:
            self.flush()

    def add_daily(self, params: tuple) -> None:
        if not self.batched:
            self.db.execute(self._DAILY_SQL, params)
            return
        with self._lock:
            self._daily_rows.append(params)
            overflow = len(self._daily_rows) >= self.MAX_BUFFERED_ROWS
        if overflow:
            self.flush()

    def flush(self) -> None:
        with self._lock:
            history, self._history_rows = self._history_rows, []
            daily, self._daily_rows = self._daily_rows, []
        if not history and not daily:
            return
        try:
            with self.db.transaction():
                if history:
                    self.db.executemany(self._HISTORY_SQL, history)
                for row in daily:  # UPSERT rows may collide per key
                    self.db.execute(self._DAILY_SQL, row)
        except Exception:
            # transient WAL contention must not silently lose a flush
            # window of history: put the rows back for the next attempt
            with self._lock:
                self._history_rows[:0] = history
                self._daily_rows[:0] = daily
            raise

    def start(self) -> None:
        if self.batched and self._task is None:
            self._task = asyncio.create_task(
                self._flush_loop(), name="history-writer"
            )

    async def _flush_loop(self) -> None:
        while True:
            await asyncio.sleep(self.flush_interval_s)
            try:
                self.flush()
            except Exception:
                log.exception("request-history flush failed")

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        try:
            self.flush()
        except Exception:
            log.exception("final request-history flush failed")


@dataclasses.dataclass
class AppState:
    config: ServerConfig
    db: Database
    registry: EndpointRegistry
    load_manager: LoadManager
    admission: AdmissionQueue
    events: DashboardEventBus
    gate: InferenceGate
    audit: AuditLog
    users: UserStore
    api_keys: ApiKeyStore
    invitations: InvitationStore
    jwt_secret: str
    http: http.ClientSession
    metrics: GatewayMetrics
    traces: TraceStore
    resilience: ResilienceManager | None = None
    faults: FaultInjector | None = None
    # Per-API-key token buckets (gateway/ratelimit.py, docs/scheduling.md);
    # always constructed — zero hot-path work unless limits are configured.
    ratelimit: RateLimiter | None = None
    health_checker: EndpointHealthChecker | None = None
    history: "HistoryWriter | None" = None
    started_at: float = dataclasses.field(default_factory=time.time)
    _tasks: list[asyncio.Task] = dataclasses.field(default_factory=list)

    async def close(self) -> None:
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass  # allow-silent: shutdown teardown of cancelled tasks
        if self.health_checker:
            await self.health_checker.stop()
        if self.history is not None:
            await self.history.stop()
        await self.audit.stop()
        await self.http.close()
        self.db.close()


async def build_app_state(
    config: ServerConfig | None = None,
    *,
    db: Database | None = None,
    start_background: bool = True,
) -> AppState:
    config = config or ServerConfig.from_env()
    if db is None:
        db = Database(config.database_url or ":memory:")

    registry = EndpointRegistry(db)
    load_manager = LoadManager(
        QueueConfig.from_env(), affinity_mode=default_affinity_mode(1),
    )
    admission = AdmissionQueue(load_manager)
    # Weighted fair queuing (docs/scheduling.md): per-tenant virtual-time
    # ordering of the contended admission queue; LLMLB_WFQ=0 restores the
    # historical pure-FIFO order.
    admission.wfq_enabled = env_bool("LLMLB_WFQ", True)
    admission.weights = wfq_weights_from_env()
    events = DashboardEventBus()
    gate = InferenceGate()
    audit = AuditLog(db)
    # SLO targets ride inside the metrics registry: every proxy path that
    # finishes a successful request judges it there (record_slo)
    metrics = GatewayMetrics(slo=SloConfig.from_env())
    admission.metrics = metrics  # admission-retry counter (balancer.py)
    traces = TraceStore(capacity=env_int("LLMLB_TRACE_BUFFER", 256),
                        events=events)

    users = UserStore(db)
    api_keys = ApiKeyStore(db, cache_ttl_s=env_float(
        "LLMLB_AUTH_CACHE_TTL", 0.0))
    invitations = InvitationStore(db)

    # admin bootstrap (reference auth/bootstrap.rs)
    admin, generated = ensure_admin_exists(
        users, config.admin_username, config.admin_password
    )
    if generated:
        log.warning(
            "bootstrap admin %r created with generated password: %s "
            "(change it on first login)",
            admin.username, generated,
        )

    # JWT secret: env > persisted setting > fresh random (persisted).
    jwt_secret = config.jwt_secret or db.get_setting("auth.jwt_secret")
    if not jwt_secret:
        db.execute(
            """INSERT INTO settings (key, value, updated_at)
               VALUES ('auth.jwt_secret', ?, ?)
               ON CONFLICT(key) DO NOTHING""",
            (secrets.token_urlsafe(32), time.time()),
        )
        jwt_secret = db.get_setting("auth.jwt_secret")

    # startup audit chain verification (bootstrap.rs:211-265)
    ok, err = audit.verify()
    if not ok:
        log.error("AUDIT CHAIN VERIFICATION FAILED: %s", err)

    client = http.ClientSession(
        connector=http.TCPConnector(limit_per_host=32, keepalive_timeout=60)
    )

    # Resilience layer: per-endpoint circuit breakers + the global retry
    # budget; selection consults it through load_manager.resilience. The
    # fault injector is None unless LLMLB_FAULTS configures rules (or a
    # chaos test installs them) — zero hot-path cost otherwise.
    resilience = ResilienceManager(
        ResilienceConfig.from_env(), metrics=metrics, events=events,
        registry=registry,
    )
    load_manager.resilience = resilience
    faults = FaultInjector.from_env()
    ratelimit = RateLimiter(RateLimitConfig.from_env())
    # Per-request history/daily-stat writes: synchronous, or batched when
    # LLMLB_HISTORY_FLUSH_SECS opts in.
    flush_s = env_float("LLMLB_HISTORY_FLUSH_SECS", 0.0)
    history = HistoryWriter(
        db, batched=flush_s > 0,
        flush_interval_s=flush_s if flush_s > 0 else 0.5,
    )

    state = AppState(
        config=config, db=db, registry=registry, load_manager=load_manager,
        admission=admission, events=events, gate=gate, audit=audit,
        users=users,
        api_keys=api_keys, invitations=invitations, jwt_secret=jwt_secret,
        http=client, metrics=metrics, traces=traces,
        resilience=resilience, faults=faults, ratelimit=ratelimit,
        history=history,
    )

    _seed_tps_from_daily_stats(state)

    if start_background:
        audit.start()
        history.start()
        checker = EndpointHealthChecker(
            registry, load_manager, db, client, events,
            interval_s=config.health_check_interval_s,
            timeout_s=config.health_check_timeout_s,
            resilience=resilience,
        )
        checker.start()
        state.health_checker = checker
        state._tasks.append(
            asyncio.create_task(_maintenance_loop(state),
                                name="gw-maintenance")
        )
    return state


def _seed_tps_from_daily_stats(state: AppState) -> None:
    """Warm-start the TPS tracker from today's persisted stats
    (bootstrap.rs:142-159)."""
    today = datetime.date.today().isoformat()
    rows = state.db.query(
        """SELECT endpoint_id, model, api_kind, completion_tokens,
                  total_duration_ms, request_count
           FROM endpoint_daily_stats WHERE date=? AND request_count>0""",
        (today,),
    )
    for r in rows:
        if r["total_duration_ms"] and r["completion_tokens"]:
            tps = r["completion_tokens"] / (r["total_duration_ms"] / 1000.0)
            try:
                kind = TpsApiKind(r["api_kind"])
            except ValueError:
                kind = TpsApiKind.OTHER
            state.load_manager.seed_tps(
                r["endpoint_id"], r["model"], kind, tps,
                samples=r["request_count"],
            )


def gateway_exposition(state: AppState) -> str:
    """The gateway's full Prometheus text exposition: GatewayMetrics series
    plus scrape-time figures owned by the balancer, admission queue and
    event bus."""
    affinity = state.load_manager.affinity_stats()
    counters = {
        "llmlb_gateway_dropped_events_total":
            state.events.dropped_events_total(),
        "llmlb_gateway_prefix_affinity_hits_total": affinity["hits_total"],
        "llmlb_gateway_prefix_affinity_misses_total":
            affinity["misses_total"],
        "llmlb_gateway_prefix_affinity_evictions_total":
            affinity["evictions_total"],
    }
    gauges = {
        "llmlb_gateway_active_requests": state.load_manager.total_active(),
        "llmlb_gateway_admission_queue_depth": state.admission.queue_depth(),
        "llmlb_gateway_traces_buffered": len(state.traces),
        "llmlb_gateway_prefix_affinity_entries": affinity["entries"],
    }
    return state.metrics.render(counters=counters, gauges=gauges)


async def _maintenance_loop(state: AppState) -> None:
    """Hourly: request-history retention cleanup + periodic audit verify
    (reference: cleanup task bootstrap.rs:161, audit verify :211-265)."""
    while True:
        await asyncio.sleep(3600)
        try:
            cutoff = time.time() - state.config.request_history_retention_days * 86400
            state.db.execute("DELETE FROM request_history WHERE ts < ?", (cutoff,))
            ok, err = state.audit.verify()
            if not ok:
                log.error("periodic audit verification failed: %s", err)
        except Exception:
            log.exception("maintenance cycle failed")


def record_daily_stat(
    state: AppState,
    endpoint_id: str,
    model: str,
    api_kind: TpsApiKind,
    *,
    error: bool = False,
    prompt_tokens: int = 0,
    completion_tokens: int = 0,
    duration_ms: float = 0.0,
) -> None:
    today = datetime.date.today().isoformat()
    state.history.add_daily(
        (endpoint_id, today, model, api_kind.value, int(error),
         prompt_tokens, completion_tokens, duration_ms),
    )
