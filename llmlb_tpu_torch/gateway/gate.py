"""Inference gate: counts in-flight inference and supports drain for updates.

Parity with reference inference_gate.rs:28-85: while rejecting, /v1/* returns
503 + Retry-After; `wait_for_idle` lets the updater drain; streaming bodies
count as in-flight until fully written (the reference wraps response bodies in
InFlightBody — here handlers hold the gate token across the whole stream).
"""

from __future__ import annotations

import asyncio
import contextlib


class InferenceGate:
    def __init__(self):
        self._in_flight = 0
        self._rejecting = False
        self._idle_event = asyncio.Event()
        self._idle_event.set()

    @property
    def in_flight(self) -> int:
        return self._in_flight

    @property
    def rejecting(self) -> bool:
        return self._rejecting

    def start_rejecting(self) -> None:
        self._rejecting = True

    def stop_rejecting(self) -> None:
        self._rejecting = False

    @contextlib.contextmanager
    def track(self):
        """Count a request in-flight for the duration of the with-block."""
        self._in_flight += 1
        self._idle_event.clear()
        try:
            yield
        finally:
            self._in_flight -= 1
            if self._in_flight == 0:
                self._idle_event.set()

    async def wait_for_idle(self, timeout_s: float | None = None) -> bool:
        try:
            await asyncio.wait_for(self._idle_event.wait(), timeout_s)
            return True
        except asyncio.TimeoutError:
            return False
