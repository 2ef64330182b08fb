"""AppState: shared state injected into all handlers + bootstrap sequence.

The port's counterpart of llmlb_tpu/gateway/app_state.py: DB + schema,
registry cache load, LoadManager seeding from daily stats, the shared HTTP
client (gateway/http.py), admin bootstrap, JWT secret provisioning, the
dashboard event bus (handed to the trace store, the breakers and the health
checker, as the reference's), the audit log (its chain verified at start and
hourly), breakers and retry budget, rate limits, health checker, history
retention; with several workers (gateway/worker.py) the gossip bus that
replicates the routing state between them, the trace spool and the metrics
spool, and the health checker, maintenance and the live-stream
rebalancer (gateway/rebalance.py) on the primary only; every worker keeps
the directory of its live streams, which the rebalancer's `migrate`
directives reach over gossip. `server.run_server` attaches the update
manager (gateway/update.py) and, with LLMLB_TRAY=1, the tray
(gateway/tray.py).
"""

from __future__ import annotations

import asyncio
import dataclasses
import datetime
import logging
import os
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
from llmlb_tpu_torch.gateway.gossip import (
    MEMBER_KEY_PREFIX,
    GossipBus,
    GossipFaults,
    MeshConfig,
    default_gossip_dir,
)
from llmlb_tpu_torch.gateway.health import EndpointHealthChecker
from llmlb_tpu_torch.gateway.metrics import GatewayMetrics
from llmlb_tpu_torch.gateway.ratelimit import RateLimiter
from llmlb_tpu_torch.gateway.rebalance import (
    RebalanceConfig,
    Rebalancer,
    StreamDirectory,
)
from llmlb_tpu_torch.gateway.registry import EndpointRegistry
from llmlb_tpu_torch.gateway.resilience import ResilienceManager
from llmlb_tpu_torch.gateway.tracing import TraceStore
from llmlb_tpu_torch.gateway.types import TpsApiKind
from llmlb_tpu_torch.gateway.worker import WorkerInfo, current_worker

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
    worker: WorkerInfo = dataclasses.field(default_factory=WorkerInfo)
    gossip: GossipBus | None = None  # multi-worker state replication
    update_manager: object | None = None  # set by gateway.update
    tray: object | None = None  # TrayController when LLMLB_TRAY=1
    history: "HistoryWriter | None" = None
    # Fleet rebalancing (gateway/rebalance.py): every worker tracks its live
    # streams in `streams`; the elected primary additionally runs the
    # planner loop in `rebalancer`. LLMLB_REBALANCE=0 leaves the directory
    # inert (register returns None) and the planner unconstructed.
    streams: StreamDirectory | None = None
    rebalancer: Rebalancer | None = None
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
        if self.rebalancer is not None:
            await self.rebalancer.stop()
        if self.health_checker:
            await self.health_checker.stop()
        if self.history is not None:
            await self.history.stop()
        if self.gossip is not None:
            self.gossip.close()
        await self.audit.stop()
        await self.http.close()
        self.db.close()


async def build_app_state(
    config: ServerConfig | None = None,
    *,
    db: Database | None = None,
    start_background: bool = True,
    worker: WorkerInfo | None = None,
) -> AppState:
    config = config or ServerConfig.from_env()
    if db is None:
        db = Database(config.database_url or ":memory:")
    if worker is None:
        worker = current_worker()

    registry = EndpointRegistry(db)
    load_manager = LoadManager(
        QueueConfig.from_env(),
        affinity_mode=default_affinity_mode(worker.count),
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
    # Multi-worker: spool completed traces to the gossip dir so ANY worker
    # answers /api/traces/{id} regardless of which sibling served the
    # request (same sibling-merge pattern as the /metrics spool below).
    traces = TraceStore(
        capacity=env_int("LLMLB_TRACE_BUFFER", 256), events=events,
        spool_dir=(default_gossip_dir(config.port) if worker.multi else None),
    )

    users = UserStore(db)
    api_keys = ApiKeyStore(db, cache_ttl_s=env_float(
        "LLMLB_AUTH_CACHE_TTL",
        ApiKeyStore.MULTI_WORKER_DEFAULT_TTL_S if worker.multi else 0.0,
    ))
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
    # Insert-if-absent then re-read: N workers booting concurrently must all
    # adopt ONE secret, or a session minted by worker A would 401 on
    # worker B behind the shared SO_REUSEPORT port.
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

    # Per-API-key rate limits: worker-local conservative shares by default
    # (limits divide by the worker count — the group never exceeds the
    # configured rate); promoted to fleet-global buckets below when the
    # gossip bus starts (attach_gossip).
    ratelimit = RateLimiter(RateLimitConfig.from_env(), workers=worker.count)

    # Per-request history/daily-stat writes: synchronous single-worker (the
    # historical behavior), batched when N workers share the WAL file or
    # when LLMLB_HISTORY_FLUSH_SECS opts in explicitly.
    flush_s = env_float("LLMLB_HISTORY_FLUSH_SECS", 0.0)
    history = HistoryWriter(
        db, batched=worker.multi or flush_s > 0,
        flush_interval_s=flush_s if flush_s > 0 else 0.5,
    )

    # Live-stream directory: every worker tracks the streams it is pumping
    # so rebalance directives (local or gossiped) can find them.
    streams = StreamDirectory(RebalanceConfig.from_env())

    state = AppState(
        config=config, db=db, registry=registry, load_manager=load_manager,
        admission=admission, events=events, gate=gate, audit=audit,
        users=users,
        api_keys=api_keys, invitations=invitations, jwt_secret=jwt_secret,
        http=client, metrics=metrics, traces=traces,
        resilience=resilience, faults=faults, ratelimit=ratelimit,
        worker=worker, history=history, streams=streams,
    )

    _seed_tps_from_daily_stats(state)

    # Gossip replication between sibling workers — and, when
    # LLMLB_GOSSIP_BIND configures the mesh, across hosts (LLMLB_GOSSIP=0
    # disables both; a single-worker gateway with no mesh has no peers and
    # skips it entirely). All replicated state is advisory: breakers, TPS,
    # retry budget, affinity pins, adapter residency, heat, rate-limit
    # spend, registry cache coherence — each converges locally without it.
    mesh = MeshConfig.from_env()
    if (worker.multi or mesh.enabled) and env_bool("LLMLB_GOSSIP", True):
        state.gossip = await _start_gossip(state, mesh)

    if start_background:
        audit.start()
        history.start()
        if worker.multi:
            interval = env_float(
                "LLMLB_METRICS_SPOOL_SECS", METRICS_SPOOL_DEFAULT_S
            )
            state._tasks.append(asyncio.create_task(
                _metrics_spool_loop(state, max(0.2, interval)),
                name="metrics-spool",
            ))
        # Single-writer discipline (docs/deployment.md): the pull health
        # checker, the hourly maintenance loop and the rebalancer run in
        # the elected primary worker only — N workers probing every engine
        # would multiply fleet-wide probe load by N for zero information.
        if worker.is_primary:
            checker = EndpointHealthChecker(
                registry, load_manager, db, client, events,
                interval_s=config.health_check_interval_s,
                timeout_s=config.health_check_timeout_s,
                resilience=resilience,
            )
            checker.start()
            checker.gossip = state.gossip  # residency push (health.py)
            state.health_checker = checker
            state._tasks.append(
                asyncio.create_task(_maintenance_loop(state),
                                    name="gw-maintenance")
            )
            # Proactive rebalancer (gateway/rebalance.py): same primary-only
            # single-writer discipline as the probe loop it reads from.
            rb = Rebalancer(
                registry, load_manager, streams, metrics=metrics,
                gossip=state.gossip, config=streams.config,
            )
            rb.start()
            state.rebalancer = rb
    return state


async def _start_gossip(state: AppState,
                        mesh: MeshConfig | None = None) -> GossipBus:
    """Bind this worker's bus socket (plus the UDP/TCP mesh when configured)
    and wire every replicated-state hook. Receivers apply via
    ``apply_remote_*`` entry points that never re-publish, so a two-worker
    group cannot ping-pong a message forever. Conflict resolution is the
    (seq, origin) version in ``m["ver"]`` — never the wall stamp."""
    mesh = mesh or MeshConfig.from_env()
    db = state.db
    membership = register = None
    if mesh.enabled:
        # Membership from the endpoint-registry database: every host
        # persists its advertised mesh address under a settings key, so any
        # host that can reach the shared DB finds the fleet without config.
        def membership() -> dict:
            return {
                key[len(MEMBER_KEY_PREFIX):]: value
                for key, value in db.list_settings().items()
                if key.startswith(MEMBER_KEY_PREFIX) and value
            }

        def register(origin: str, advertise: str) -> None:
            db.set_setting(MEMBER_KEY_PREFIX + origin, advertise)

    bus = GossipBus(
        default_gossip_dir(state.config.port), state.worker.index,
        expected_peers=state.worker.count - 1,
        mesh=mesh, faults=GossipFaults.from_env(),
        membership=membership, register=register,
    )
    await bus.start()
    lm = state.load_manager
    resilience = state.resilience
    registry = state.registry
    bus.on_lag = state.metrics.observe_gossip_lag

    lm.gossip = bus
    bus.subscribe("tps", lambda d, m: lm.apply_remote_tps(
        d["eid"], d["model"], d["kind"], float(d["ema"]),
        int(d.get("samples", 1)), m["ver"],
    ))
    bus.subscribe("tps_clear", lambda d, m: lm.apply_remote_tps_clear(
        d["eid"], m["ver"],
    ))
    bus.subscribe("affinity", lambda d, m: lm.apply_remote_affinity(
        d["model"], d["hash"], d["eid"], m["ver"],
    ))
    bus.subscribe("heat", lambda d, m: lm.apply_remote_heat(
        d["model"], d.get("entries") or {}, m["ver"],
    ))
    if resilience is not None:
        resilience.gossip = bus
        resilience.budget.on_spend = lambda: bus.publish("retry_spend", {})
        bus.subscribe("breaker", lambda d, m: resilience.apply_remote_breaker(
            d["eid"], d["to"], float(d.get("remaining_s", 0.0)),
            d.get("reason"), m["ver"],
        ))
        bus.subscribe(
            "retry_spend",
            lambda d, m: resilience.budget.note_remote_spend(),
        )
    registry.on_mutate = lambda: bus.publish("registry", {})
    bus.subscribe("registry", lambda d, m: registry.reload())
    # Event-driven adapter residency: the primary's probe loop pushes
    # resident-set changes; siblings patch their model cache immediately
    # instead of waiting out a full registry reload round.
    bus.subscribe("residency", lambda d, m: registry.apply_residency(
        d["eid"], list((d.get("adapters") or {})),
    ))
    # Global token buckets: admission spend replicates fleet-wide so a
    # tenant at rps=N is admitted ≈N across all workers, not N×workers.
    if state.ratelimit is not None and state.ratelimit.enabled:
        state.ratelimit.attach_gossip(bus)
    # Rebalance directives from the (possibly remote) primary: mark up to
    # max_streams of OUR live streams on the source endpoint for migration.
    streams = state.streams
    if streams is not None and streams.config.enabled:
        bus.subscribe("migrate", lambda d, m: streams.apply_directive(
            d["eid"], d["target"], d.get("reason") or "hotspot",
            int(d.get("max_streams", 1)), int(d.get("directive_id", 0)),
        ))
    return bus


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
    plus scrape-time figures owned by the balancer, admission queue, event
    bus, and (multi-worker) the gossip bus."""
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
    if state.gossip is not None:
        gs = state.gossip.stats()
        counters["llmlb_gateway_gossip_messages_sent_total"] = gs["sent_total"]
        counters["llmlb_gateway_gossip_messages_received_total"] = (
            gs["received_total"]
        )
        counters["llmlb_gateway_gossip_send_errors_total"] = (
            gs["send_errors_total"]
        )
        counters["llmlb_gateway_gossip_rejected_total"] = (
            gs["recv_rejected_total"]
        )
        counters["llmlb_gateway_gossip_fault_dropped_total"] = (
            gs["fault_dropped_total"]
        )
        gauges["llmlb_gateway_gossip_peers"] = (
            gs["peers"] + gs["mesh_peers"]
        )
        gauges["llmlb_gateway_gossip_partition_suspected"] = (
            1 if gs["partition_suspected"] else 0
        )
        if gs["lag_s"] is not None:
            gauges["llmlb_gateway_gossip_lag_seconds"] = round(gs["lag_s"], 6)
    if state.rebalancer is not None:
        rb = state.rebalancer.snapshot()
        counters["llmlb_gateway_rebalance_directives_total"] = (
            rb["directives_total"]
        )
        gauges["llmlb_gateway_rebalance_inflight"] = rb["inflight"]
    return state.metrics.render(counters=counters, gauges=gauges)


# Each worker spools its worker-labeled exposition to a shared file this
# often; the worker that receives a /metrics scrape (SO_REUSEPORT picks one
# arbitrarily) merges its siblings' spools, so Prometheus always sees the
# whole group no matter which accept queue the scrape landed in.
METRICS_SPOOL_DEFAULT_S = 5.0


def _metrics_spool_path(state: AppState, index: int) -> str:
    return os.path.join(
        default_gossip_dir(state.config.port), f"metrics-w{index}.prom"
    )


def write_metrics_spool(state: AppState,
                        labeled_text: str | None = None) -> None:
    """Spool this worker's worker-labeled exposition for siblings to
    merge. The /metrics handler passes the text it just rendered so a
    scrape builds the exposition once, not twice."""
    from llmlb_tpu_torch.gateway.metrics import label_exposition

    path = _metrics_spool_path(state, state.worker.index)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if labeled_text is None:
        labeled_text = label_exposition(
            gateway_exposition(state), "worker", state.worker.label
        )
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        f.write(labeled_text)
    os.replace(tmp, path)  # atomic: a scrape never reads a torn file


def read_peer_metrics(state: AppState, max_age_s: float) -> str:
    """Concatenated sibling expositions (comment lines stripped — the
    serving worker's own exposition already declared the families; Prom
    treats the peers' samples as additional series via their worker
    label). Stale spools (dead worker) age out instead of freezing."""
    import glob as _glob

    own = _metrics_spool_path(state, state.worker.index)
    parts: list[str] = []
    now = time.time()
    for path in sorted(_glob.glob(
        os.path.join(default_gossip_dir(state.config.port), "metrics-w*.prom")
    )):
        if path == own:
            continue
        try:
            if now - os.path.getmtime(path) > max_age_s:
                continue
            with open(path) as f:
                text = f.read()
        except OSError:
            continue
        parts.append("\n".join(
            line for line in text.splitlines()
            if line and not line.startswith("#")
        ))
    return ("\n".join(parts) + "\n") if parts else ""


async def _metrics_spool_loop(state: AppState, interval_s: float) -> None:
    while True:
        try:
            write_metrics_spool(state)
        except Exception:
            log.exception("metrics spool write failed")
        await asyncio.sleep(interval_s)


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
