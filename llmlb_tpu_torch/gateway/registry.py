"""EndpointRegistry: in-memory endpoint/model cache with SQLite write-through.

Parity with reference registry/endpoints.rs:80-608 (find_by_model :209,
list_online_by_capability :169, update_status :282, sync_models :483): every
read is served from memory; every mutation writes DB then cache under one lock.
"""

from __future__ import annotations

import threading
import time

from llmlb_tpu_torch.gateway.db import Database
from llmlb_tpu_torch.gateway.types import (
    AcceleratorInfo,
    Capability,
    Endpoint,
    EndpointModel,
    EndpointStatus,
    EndpointType,
)


class EndpointRegistry:
    def __init__(self, db: Database):
        self.db = db
        self._lock = threading.RLock()
        self._endpoints: dict[str, Endpoint] = {}
        self._models: dict[str, list[EndpointModel]] = {}  # endpoint_id -> models
        # Called (no args) after every durable mutation; app_state wires it
        # to the gossip bus in multi-worker mode so sibling workers reload
        # their cache from the shared DB (~1 RTT instead of never — each
        # worker's cache is otherwise only seeded at its own boot).
        self.on_mutate = None
        self._load()

    def _load(self) -> None:
        with self._lock:
            self._endpoints = {ep.id: ep for ep in self.db.list_endpoints()}
            self._models = {}
            for m in self.db.list_endpoint_models():
                self._models.setdefault(m.endpoint_id, []).append(m)

    def reload(self) -> None:
        """Re-seed the cache from the DB (a sibling worker mutated it).
        Transient cache-only fields (breaker_state) are re-mirrored by the
        resilience layer on its next transition; never fires on_mutate."""
        self._load()

    def _notify_mutation(self) -> None:
        cb = self.on_mutate
        if cb is not None:
            try:
                cb()
            except Exception:  # allow-silent: a broken listener must not
                pass           # poison registry mutations

    # ------------------------------------------------------------------ CRUD

    def add(self, endpoint: Endpoint) -> Endpoint:
        with self._lock:
            for existing in self._endpoints.values():
                if existing.url == endpoint.url:
                    raise ValueError(f"endpoint URL already registered: {endpoint.url}")
            self.db.upsert_endpoint(endpoint)
            self._endpoints[endpoint.id] = endpoint
        self._notify_mutation()
        return endpoint

    def update(self, endpoint: Endpoint) -> None:
        with self._lock:
            endpoint.updated_at = time.time()
            self.db.upsert_endpoint(endpoint)
            self._endpoints[endpoint.id] = endpoint
        self._notify_mutation()

    def remove(self, endpoint_id: str) -> bool:
        with self._lock:
            if endpoint_id not in self._endpoints:
                return False
            self.db.delete_endpoint(endpoint_id)
            self._endpoints.pop(endpoint_id, None)
            self._models.pop(endpoint_id, None)
        self._notify_mutation()
        return True

    def get(self, endpoint_id: str) -> Endpoint | None:
        with self._lock:
            return self._endpoints.get(endpoint_id)

    def list_all(self) -> list[Endpoint]:
        with self._lock:
            return list(self._endpoints.values())

    def list_online(self) -> list[Endpoint]:
        with self._lock:
            return [
                ep for ep in self._endpoints.values()
                if ep.status == EndpointStatus.ONLINE
            ]

    # ----------------------------------------------------------------- status

    def update_status(
        self,
        endpoint_id: str,
        status: EndpointStatus,
        latency_ms: float | None = None,
        accelerator: AcceleratorInfo | None = None,
        consecutive_failures: int | None = None,
    ) -> Endpoint | None:
        with self._lock:
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                return None
            status_changed = ep.status != status
            ep.status = status
            if latency_ms is not None:
                ep.latency_ms = latency_ms
            if accelerator is not None:
                ep.accelerator = accelerator
            if consecutive_failures is not None:
                ep.consecutive_failures = consecutive_failures
            ep.last_checked_at = time.time()
            ep.updated_at = time.time()
            self.db.upsert_endpoint(ep)
        # notify siblings on status flips only — every 30 s probe rewrites
        # latency/telemetry, and a reload per probe per worker is pure churn
        # (stale telemetry between flips degrades steering, not correctness)
        if status_changed:
            self._notify_mutation()
        return ep

    def set_breaker_state(self, endpoint_id: str, state: str) -> None:
        """Mirror the in-band circuit breaker's state onto the cached
        endpoint (resilience.py calls this on every transition). Cache-only
        on purpose: breaker state is runtime truth, not configuration, so it
        must not round-trip through the DB."""
        with self._lock:
            ep = self._endpoints.get(endpoint_id)
            if ep is not None:
                ep.breaker_state = state

    def update_type(self, endpoint_id: str, endpoint_type: EndpointType) -> None:
        with self._lock:
            ep = self._endpoints.get(endpoint_id)
            if ep is None:
                return
            ep.endpoint_type = endpoint_type
            ep.updated_at = time.time()
            self.db.upsert_endpoint(ep)
        self._notify_mutation()

    # ----------------------------------------------------------------- models

    def sync_models(self, endpoint_id: str, models: list[EndpointModel]) -> None:
        with self._lock:
            self.db.replace_endpoint_models(endpoint_id, models)
            self._models[endpoint_id] = list(models)
        self._notify_mutation()

    def apply_residency(self, endpoint_id: str, adapters: list[str]) -> None:
        """Patch the cached `base:adapter` model entries for an endpoint to
        exactly `adapters` — the gossip fast path for adapter residency
        (health._sync_lora_models pushes changes the moment a probe sees
        them). Cache-only like set_breaker_state: the primary's sync_models
        already persisted the truth to the shared DB, and a full reload
        rides the `registry` gossip behind this message anyway — this just
        closes the window where a sibling routes on a stale resident set."""
        with self._lock:
            models = self._models.get(endpoint_id)
            if not models:
                return
            base = [m for m in models if ":" not in m.model_id]
            lora_base = [m for m in base
                         if Capability.LORA in m.capabilities]
            if not lora_base:
                return
            wanted: dict[str, EndpointModel] = {}
            for m in lora_base:
                for name in adapters:
                    mid = f"{m.model_id}:{name}"
                    wanted[mid] = EndpointModel(
                        endpoint_id=endpoint_id,
                        model_id=mid,
                        canonical_name=f"{m.canonical_name}:{name}",
                        capabilities=list(m.capabilities),
                        context_length=m.context_length,
                    )
            self._models[endpoint_id] = base + list(wanted.values())

    def models_for(self, endpoint_id: str) -> list[EndpointModel]:
        with self._lock:
            return list(self._models.get(endpoint_id, []))

    def all_models(self) -> list[EndpointModel]:
        with self._lock:
            return [m for ms in self._models.values() for m in ms]

    def canonical_model_names(self) -> list[str]:
        with self._lock:
            seen: dict[str, None] = {}
            for ms in self._models.values():
                for m in ms:
                    seen.setdefault(m.canonical_name)
            return list(seen)

    def find_by_model(
        self, canonical_name: str, capability: Capability | None = None
    ) -> list[tuple[Endpoint, EndpointModel]]:
        """Online endpoints serving a model (optionally with a capability)."""
        with self._lock:
            out = []
            for ep in self._endpoints.values():
                if ep.status != EndpointStatus.ONLINE:
                    continue
                for m in self._models.get(ep.id, []):
                    if m.canonical_name != canonical_name and m.model_id != canonical_name:
                        continue
                    if capability is not None and capability not in m.capabilities:
                        continue
                    out.append((ep, m))
                    break
            return out

    def list_online_by_capability(
        self, capability: Capability
    ) -> list[tuple[Endpoint, EndpointModel]]:
        with self._lock:
            out = []
            for ep in self._endpoints.values():
                if ep.status != EndpointStatus.ONLINE:
                    continue
                for m in self._models.get(ep.id, []):
                    if capability in m.capabilities:
                        out.append((ep, m))
                        break
            return out
