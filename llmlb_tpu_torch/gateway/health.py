"""Pull-based endpoint health checker.

State machine parity with reference health/endpoint_checker.rs: default 30 s
interval (:43), 5 s probe timeout (:40), offline after 2 consecutive failures
(:46), pending→offline immediately on first failure (:580); on recovery the
type is re-detected and models auto-synced (:333-377,:426); TPS state cleared on
failure so recovered endpoints re-learn (:313-317); every check persisted.

TPU extension: tpu/xllm endpoints are probed at /api/health and their chip/HBM
telemetry flows into the registry (the reference read GPU fields, :515). The
port reads the same fields from the port's engine (`/api/health`'s `gpu`
block, with its `engine`, `disagg`, `draining` and `lora` blocks).
The port's copy of llmlb_tpu/gateway/health.py, with its dashboard events
(`EndpointStatusChanged`, `TelemetryUpdated`) and its gossip push of
resident adapters (`residency`, from the primary worker that probes).
"""

from __future__ import annotations

import asyncio
import logging
import time

from llmlb_tpu_torch.gateway import http

from llmlb_tpu_torch.gateway.balancer import LoadManager
from llmlb_tpu_torch.gateway.db import Database
from llmlb_tpu_torch.gateway.detection import detect_endpoint_type
from llmlb_tpu_torch.gateway.events import DashboardEventBus
from llmlb_tpu_torch.gateway.model_sync import sync_endpoint_models
from llmlb_tpu_torch.gateway.registry import EndpointRegistry
from llmlb_tpu_torch.gateway.types import (
    AcceleratorInfo,
    Endpoint,
    EndpointStatus,
    EndpointType,
    HealthCheckResult,
)

log = logging.getLogger("llmlb_tpu_torch.gateway.health")

OFFLINE_AFTER_FAILURES = 2  # parity: endpoint_checker.rs:46


def _as_int(v, default: int = 0) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return default


def _parse_telemetry(body: dict) -> AcceleratorInfo:
    """Tolerant parse of an engine /api/health body. Malformed fields degrade
    to zeros rather than raising — a bad payload from one endpoint must never
    abort the whole health cycle (check_all gathers without return_exceptions)."""
    from llmlb_tpu_torch.disagg import ROLES

    tpu = body.get("tpu") or body.get("gpu")
    tpu = tpu if isinstance(tpu, dict) else {}
    engine = body.get("engine")
    engine = engine if isinstance(engine, dict) else {}
    util = tpu.get("utilization")
    disagg = body.get("disagg")
    disagg = disagg if isinstance(disagg, dict) else {}
    role = disagg.get("role")
    # Graceful drain advertisement (docs/deployment.md): a draining engine
    # keeps answering probes with 200 (so its models never 404) but flags
    # itself here — selection drops it within one probe interval.
    drain = body.get("draining")
    drain = drain if isinstance(drain, dict) else {}
    draining = (body.get("status") == "draining"
                or bool(drain.get("draining")))
    try:
        drain_remaining = max(0.0, float(drain.get("remaining_s") or 0.0))
    except (TypeError, ValueError):
        drain_remaining = 0.0
    # Multi-LoRA advertisement (docs/lora.md): resident adapter names,
    # re-read every probe like the disagg role above.
    lora = body.get("lora")
    lora = lora if isinstance(lora, dict) else {}
    lora_loaded = lora_available = None
    if lora.get("enabled"):
        lora_loaded = tuple(
            str(n) for n in (lora.get("resident") or ())
        )
        lora_available = tuple(
            str(n) for n in (lora.get("available") or ())
        )
    return AcceleratorInfo(
        role=role if role in ROLES else None,
        draining=draining,
        drain_remaining_s=drain_remaining,
        lora_loaded=lora_loaded,
        lora_available=lora_available,
        accelerator=tpu.get("accelerator") or ("tpu" if "tpu" in body else None),
        chip_count=_as_int(tpu.get("chip_count")),
        hbm_used_bytes=_as_int(tpu.get("hbm_used_bytes")),
        hbm_total_bytes=_as_int(tpu.get("hbm_total_bytes")),
        utilization=util if isinstance(util, (int, float)) else None,
        queue_depth=_as_int(engine.get("queued")),
        active_slots=_as_int(engine.get("active_slots")),
        num_slots=_as_int(engine.get("num_slots")),
        sampled_at=time.time(),
    )


class EndpointHealthChecker:
    def __init__(
        self,
        registry: EndpointRegistry,
        load_manager: LoadManager,
        db: Database,
        session: http.ClientSession,
        events: DashboardEventBus | None = None,
        interval_s: float = 30.0,
        timeout_s: float = 5.0,
        resilience=None,
    ):
        self.registry = registry
        self.load_manager = load_manager
        self.db = db
        self.session = session
        self.events = events
        self.interval_s = interval_s
        self.timeout_s = timeout_s
        # ResilienceManager | None: in-band breaker state reconciles with
        # this pull checker — a good probe fast-forwards an open breaker to
        # half-open, a recovered-from-offline endpoint gets a fresh breaker.
        self.resilience = resilience
        # GossipBus | None (wired by app_state): resident-adapter changes
        # push to sibling workers the moment a probe observes them, instead
        # of each sibling waiting out its own registry reload.
        self.gossip = None
        self._task: asyncio.Task | None = None

    def start(self) -> None:
        self._task = asyncio.create_task(self._monitor_loop(), name="health-checker")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _monitor_loop(self) -> None:
        while True:
            try:
                await self.check_all()
            except Exception:
                log.exception("health check cycle failed")
            await asyncio.sleep(self.interval_s)

    async def check_all(self) -> list[HealthCheckResult]:
        endpoints = self.registry.list_all()
        if not endpoints:
            return []
        return list(
            await asyncio.gather(*(self.check_endpoint(ep) for ep in endpoints))
        )

    # ------------------------------------------------------------------ probe

    async def _probe(self, ep: Endpoint) -> HealthCheckResult:
        """One HTTP probe. tpu/xllm: /api/health (telemetry) with /v1/models
        fallback; everything else: /v1/models."""
        headers = {}
        if ep.api_key:
            headers["Authorization"] = f"Bearer {ep.api_key}"
        start = time.monotonic()

        async def get(path: str) -> tuple[int, dict | None]:
            async with self.session.get(
                ep.url + path,
                headers=headers,
                timeout=http.ClientTimeout(total=self.timeout_s),
            ) as resp:
                try:
                    body = await resp.json(content_type=None)
                except Exception:
                    body = None
                return resp.status, body if isinstance(body, dict) else None

        try:
            accelerator = None
            models_payload = None
            if ep.endpoint_type in (EndpointType.TPU, EndpointType.XLLM):
                try:
                    status, body = await get("/api/health")
                except (http.ClientError, asyncio.TimeoutError, OSError):
                    status, body = 0, None
                if status == 200 and body:
                    accelerator = _parse_telemetry(body)
                else:
                    status, models_payload = await get("/v1/models")
            else:
                status, models_payload = await get("/v1/models")

            latency_ms = (time.monotonic() - start) * 1000.0
            ok = status == 200
            return HealthCheckResult(
                endpoint_id=ep.id, ok=ok, latency_ms=latency_ms,
                error=None if ok else f"HTTP {status}",
                accelerator=accelerator, models_payload=models_payload,
            )
        except (http.ClientError, asyncio.TimeoutError, OSError) as e:
            return HealthCheckResult(
                endpoint_id=ep.id, ok=False,
                latency_ms=(time.monotonic() - start) * 1000.0,
                error=f"{type(e).__name__}: {e}",
            )

    # ------------------------------------------------------------ state logic

    async def check_endpoint(self, ep: Endpoint) -> HealthCheckResult:
        result = await self._probe(ep)
        prev_status = ep.status

        if result.ok:
            recovered = prev_status in (
                EndpointStatus.OFFLINE, EndpointStatus.ERROR, EndpointStatus.PENDING
            )
            self.registry.update_status(
                ep.id, EndpointStatus.ONLINE,
                latency_ms=result.latency_ms,
                accelerator=result.accelerator,
                consecutive_failures=0,
            )
            if self.resilience is not None:
                if recovered:
                    # the engine restarted; in-band failure history is stale
                    self.resilience.reset(ep.id)
                else:
                    # good probe: open breaker fast-forwards to half-open so
                    # the next real request (not the 30 s timer) decides
                    self.resilience.note_probe(ep.id, True)
            if recovered:
                await self._on_recovery(ep)
            self._sync_lora_models(ep, result.accelerator)
        else:
            failures = ep.consecutive_failures + 1
            if prev_status == EndpointStatus.PENDING:
                new_status = EndpointStatus.OFFLINE  # pending fails fast (:580)
            elif failures >= OFFLINE_AFTER_FAILURES:
                new_status = EndpointStatus.OFFLINE
            else:
                new_status = prev_status  # one strike: stay online
            self.registry.update_status(
                ep.id, new_status, consecutive_failures=failures
            )
            if self.resilience is not None:
                self.resilience.note_probe(ep.id, False)
            if new_status == EndpointStatus.OFFLINE:
                # recovered endpoints must re-measure TPS (:313-317)
                self.load_manager.clear_tps_for_endpoint(ep.id)

        self.db.record_health_check(
            ep.id, result.ok, result.latency_ms, result.error, result.checked_at
        )
        new_ep = self.registry.get(ep.id)
        if self.events and new_ep and new_ep.status != prev_status:
            self.events.publish(
                "EndpointStatusChanged",
                {
                    "endpoint_id": ep.id,
                    "name": ep.name,
                    "from": prev_status.value,
                    "to": new_ep.status.value,
                },
            )
        if self.events and result.accelerator:
            self.events.publish(
                "TelemetryUpdated",
                {"endpoint_id": ep.id, "tpu": vars(result.accelerator)},
            )
        return result

    def _sync_lora_models(self, ep: Endpoint, acc) -> None:
        """Mirror a probe's resident-adapter advertisement into
        `base:adapter` model entries (docs/lora.md). Model sync proper runs
        only at registration/recovery, but adapters hot-load and evict at
        request rate — this keeps find_by_model("base:adapter") fresh
        within one probe interval, the disagg-role re-parse precedent.
        No-op (and no DB churn) when the resident set is unchanged."""
        if acc is None or acc.lora_loaded is None:
            return
        from llmlb_tpu_torch.gateway.types import Capability, EndpointModel

        models = self.registry.models_for(ep.id)
        base = [m for m in models if ":" not in m.model_id]
        lora_base = [m for m in base if Capability.LORA in m.capabilities]
        if not lora_base:
            return
        wanted: dict[str, EndpointModel] = {}
        for m in lora_base:
            for name in acc.lora_loaded:
                mid = f"{m.model_id}:{name}"
                wanted[mid] = EndpointModel(
                    endpoint_id=ep.id,
                    model_id=mid,
                    canonical_name=f"{m.canonical_name}:{name}",
                    capabilities=list(m.capabilities),
                    context_length=m.context_length,
                )
        current = {m.model_id for m in models if ":" in m.model_id}
        if current == set(wanted):
            return
        self.registry.sync_models(ep.id, base + list(wanted.values()))
        # Event-driven residency (docs/lora.md): the resident set CHANGED —
        # push it so siblings (and mesh peers) patch their caches now, one
        # gossip hop instead of one probe/reload interval.
        if self.gossip is not None:
            self.gossip.publish("residency", {
                "eid": ep.id,
                "adapters": {name: 1 for name in acc.lora_loaded},
            })

    async def _on_recovery(self, ep: Endpoint) -> None:
        """Re-detect type (it may have been swapped) and resync models."""
        try:
            detected = await detect_endpoint_type(
                ep.base_url, self.session, timeout=self.timeout_s, api_key=ep.api_key
            )
            if detected != ep.endpoint_type:
                log.info(
                    "endpoint %s type changed %s -> %s",
                    ep.name, ep.endpoint_type.value, detected.value,
                )
                self.registry.update_type(ep.id, detected)
                ep.endpoint_type = detected
        except Exception:  # allow-silent: re-detection is opportunistic;
            pass           # the model resync below still runs and logs
        try:
            await sync_endpoint_models(ep, self.registry, self.session)
        except Exception as e:
            log.warning("model sync on recovery failed for %s: %s", ep.name, e)
