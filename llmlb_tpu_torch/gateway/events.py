"""Dashboard event bus: broadcast pub/sub feeding the /ws/dashboard socket.

The port's copy of llmlb_tpu/gateway/events.py. Parity with reference
events/mod.rs:20-122 (tokio::broadcast): bounded per-subscriber queues;
slow subscribers drop oldest events rather than block publishers. Event
names match the reference set plus accelerator telemetry
(`TelemetryUpdated`, whose `tpu` key carries the card's figures on the
port's engines). The update manager (gateway/update.py) publishes
`UpdateStateChanged`, which the tray (gateway/tray.py) follows.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from typing import Any


class DashboardEventBus:
    EVENTS = (
        "EndpointRegistered",
        "EndpointStatusChanged",
        "EndpointRemoved",
        "BreakerStateChanged",
        "MetricsUpdated",
        "TpsUpdated",
        "UpdateStateChanged",
        "TelemetryUpdated",
        "TraceCompleted",
    )

    def __init__(self, queue_size: int = 256):
        self._queue_size = queue_size
        self._subscribers: dict[int, asyncio.Queue] = {}
        self._loops: dict[int, asyncio.AbstractEventLoop] = {}
        self._next_id = 0
        self._lock = threading.Lock()
        # Dropped-event accounting: a slow subscriber silently losing events
        # is invisible without it. Per-subscriber counts reset with the
        # subscription; the total survives for /metrics.
        self._dropped: dict[int, int] = {}
        self._dropped_total = 0

    def subscribe(self) -> tuple[int, asyncio.Queue]:
        """Called from the event loop that will consume the queue."""
        q: asyncio.Queue = asyncio.Queue(self._queue_size)
        loop = asyncio.get_running_loop()
        with self._lock:
            sub_id = self._next_id
            self._next_id += 1
            self._subscribers[sub_id] = q
            self._loops[sub_id] = loop
            self._dropped[sub_id] = 0
        return sub_id, q

    def unsubscribe(self, sub_id: int) -> None:
        with self._lock:
            self._subscribers.pop(sub_id, None)
            self._loops.pop(sub_id, None)
            self._dropped.pop(sub_id, None)

    def dropped_events(self, sub_id: int) -> int:
        with self._lock:
            return self._dropped.get(sub_id, 0)

    def dropped_events_total(self) -> int:
        with self._lock:
            return self._dropped_total

    def publish(self, event_type: str, payload: dict[str, Any] | None = None) -> None:
        """Thread-safe: usable from engine threads and the health checker."""
        event = {
            "type": event_type,
            "ts": time.time(),
            "data": payload or {},
        }
        with self._lock:
            targets = list(self._subscribers.items())
            loops = dict(self._loops)
        for sub_id, q in targets:
            loop = loops.get(sub_id)
            if loop is None or loop.is_closed():
                continue

            def _put(q=q, event=event, sub_id=sub_id):
                if q.full():
                    try:
                        q.get_nowait()  # drop oldest for slow consumers
                    except asyncio.QueueEmpty:
                        pass
                    else:
                        with self._lock:
                            if sub_id in self._dropped:
                                self._dropped[sub_id] += 1
                            self._dropped_total += 1
                q.put_nowait(event)

            try:
                loop.call_soon_threadsafe(_put)
            except RuntimeError:
                continue

    @staticmethod
    def serialize(event: dict) -> str:
        return json.dumps(event, separators=(",", ":"))
