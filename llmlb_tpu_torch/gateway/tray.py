"""System-tray equivalent: a menu-model controller over the update lifecycle.

The port's copy of llmlb_tpu/gateway/tray.py. Parity with reference
gui/tray.rs:37-135 — the reference builds a win/mac tray-icon whose menu
shows "Open Dashboard", an update line that tracks the UpdateManager state
(notify on available, click-to-apply), and the configured update schedule;
tray events are proxied into the update manager.

This build targets headless Linux serving hosts, where there is no desktop
shell, so the tray is split into a platform-neutral controller (menu model +
event-bus subscription + action dispatch — everything gui/tray.rs does
besides drawing) and a pluggable backend. The shipped `HeadlessTrayBackend`
records menu state and notifications and logs them (queryable in tests and
over `/api/system/tray`); a GUI backend need only implement
`update_menu`/`notify`. Enable with LLMLB_TRAY=1 (the reference compiles the
tray only on win/mac; headless is our "unsupported platform" analogue, not a
stub of the logic).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable

log = logging.getLogger("llmlb_tpu_torch.gateway.tray")


class HeadlessTrayBackend:
    """Backend that records the menu model and notifications.

    Stands in for tray-icon on hosts with no display server; the controller
    logic above it is identical to what a GUI backend would drive.
    """

    def __init__(self, max_notifications: int = 50):
        self.menu: list[dict[str, Any]] = []
        self.notifications: list[dict[str, Any]] = []
        self._max = max_notifications

    def update_menu(self, items: list[dict[str, Any]]) -> None:
        self.menu = items

    def notify(self, title: str, body: str) -> None:
        self.notifications.append(
            {"title": title, "body": body, "ts": time.time()}
        )
        del self.notifications[:-self._max]
        log.info("tray notification: %s — %s", title, body)


class TrayController:
    """Builds the tray menu from update state and dispatches menu actions.

    Mirrors the reference's menu composition (gui/tray.rs:37-135): a static
    "Open Dashboard" entry, a dynamic update entry whose label/enabled state
    follow the UpdateManager state machine, a read-only schedule line, and
    Quit. `activate(item_id)` is the click path the reference proxies into
    the update manager.
    """

    def __init__(
        self,
        dashboard_url: str,
        update_manager,
        events=None,
        backend=None,
        quit_cb: Callable[[], None] | None = None,
        open_url_cb: Callable[[str], None] | None = None,
    ):
        self.dashboard_url = dashboard_url
        self.update = update_manager
        self.events = events
        self.backend = backend or HeadlessTrayBackend()
        self.quit_cb = quit_cb
        # Opening a browser is a platform side effect; injectable so servers
        # and tests never spawn one.
        self.open_url_cb = open_url_cb or (
            lambda url: log.info("open dashboard: %s", url)
        )
        self._task: asyncio.Task | None = None
        self._sub_id: int | None = None
        self._notified_version: str | None = None
        self.refresh()

    # ------------------------------------------------------------- menu model

    def _update_item(self) -> dict[str, Any]:
        st = self.update.status() if self.update else {"state": "up_to_date"}
        state = st.get("state", "up_to_date")
        version = st.get("available_version")
        if state == "available" and version:
            return {"id": "update", "label": f"Update to {version} available — apply",
                    "enabled": True}
        if state == "draining":
            return {"id": "update", "label": "Update: draining in-flight requests…",
                    "enabled": False}
        if state == "applying":
            return {"id": "update", "label": "Update: applying…", "enabled": False}
        if state == "failed":
            err = (st.get("error") or "unknown error")[:80]
            return {"id": "update", "label": f"Update failed: {err} — retry check",
                    "enabled": True}
        return {"id": "update", "label": "Check for updates", "enabled": True}

    def _schedule_item(self) -> dict[str, Any]:
        sched = (self.update.status().get("schedule")
                 if self.update else None) or {}
        mode = sched.get("mode", "immediate")
        if mode == "at_time" and sched.get("at_time"):
            when = time.strftime("%H:%M", time.localtime(sched["at_time"]))
            label = f"Update schedule: at {when}"
        elif mode == "on_idle":
            label = "Update schedule: when idle"
        else:
            label = "Update schedule: immediate"
        return {"id": "schedule", "label": label, "enabled": False}

    def menu_model(self) -> list[dict[str, Any]]:
        return [
            {"id": "open_dashboard", "label": "Open Dashboard", "enabled": True},
            self._update_item(),
            self._schedule_item(),
            {"id": "quit", "label": "Quit", "enabled": True},
        ]

    def refresh(self) -> None:
        self.backend.update_menu(self.menu_model())

    # ---------------------------------------------------------------- actions

    async def activate(self, item_id: str) -> dict[str, Any]:
        """Dispatch a menu click (the reference's tray→update-manager proxy)."""
        if item_id == "open_dashboard":
            self.open_url_cb(self.dashboard_url)
            return {"ok": True}
        if item_id == "update":
            st = self.update.status()
            if st.get("state") == "available" and st.get("available_version"):
                started = self.update.request_apply()
                self.refresh()
                return {"ok": started, "action": "apply"}
            result = await self.update.check(force=True)
            self.refresh()
            return {"ok": True, "action": "check", **{
                k: v for k, v in result.items() if k in ("available", "version")
            }}
        if item_id == "quit":
            if self.quit_cb:
                self.quit_cb()
            return {"ok": True}
        return {"ok": False, "error": f"unknown item {item_id!r}"}

    # ----------------------------------------------------- event subscription

    async def start(self) -> None:
        """Follow UpdateStateChanged on the event bus: refresh the menu and
        raise a notification when an update becomes available or fails."""
        if self.events is None:
            return
        self._sub_id, queue = self.events.subscribe()
        self._task = asyncio.create_task(self._pump(queue), name="tray-events")

    async def _pump(self, queue: asyncio.Queue) -> None:
        while True:
            event = await queue.get()
            try:
                if event.get("type") != "UpdateStateChanged":
                    continue
                data = event.get("data") or {}
                state, version = data.get("state"), data.get("version")
                if (state == "available" and version
                        and version != self._notified_version):
                    self._notified_version = version
                    self.backend.notify(
                        "Update available",
                        f"Version {version} is ready to apply from the tray "
                        "menu.",
                    )
                elif state == "failed":
                    self.backend.notify(
                        "Update failed",
                        str(self.update.status().get("error") or "see logs"),
                    )
                self.refresh()
            except Exception:
                # one bad event must not kill tray notifications for good
                log.exception("tray event handling failed; continuing")

    async def stop(self) -> None:
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                # allow-silent: a pump that died earlier must not abort the
                # server's shutdown sequence (drain + update stop follow us)
                pass
            self._task = None
        if self.events is not None and self._sub_id is not None:
            self.events.unsubscribe(self._sub_id)
            self._sub_id = None

    def status(self) -> dict[str, Any]:
        """Queryable tray state for /api/system/tray and tests."""
        return {
            "menu": self.backend.menu,
            "notifications": getattr(self.backend, "notifications", []),
        }
