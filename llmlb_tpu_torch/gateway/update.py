"""Self-update manager: state machine + drain-aware apply + rollback watch.

The port's copy of llmlb_tpu/gateway/update.py. Parity with reference
update/ (state machine mod.rs:59-123, background tasks :807-905,
check/download :965+, drain via InferenceGate, scheduling
schedule.rs:17-90, post-restart health watch + rollback README.md:160-166).
The swap unit is an operator-configured artifact (update_source.py) rather
than a Rust binary, but the externally observable lifecycle — hourly check →
available → download w/ progress → draining (503s on /v1/*) → applying →
restart → 30 s health watch with `.bak` rollback — and the admin API shape
are preserved. It publishes `UpdateStateChanged` and
`UpdateDownloadProgress` on the dashboard's event bus. Hooks remain
injectable for tests; the defaults are the real GitHub + artifact-swap
implementations when configured via LLMLB_UPDATE_REPO /
LLMLB_UPDATE_ARTIFACT.
"""

from __future__ import annotations

import asyncio
import dataclasses
import enum
import json
import logging
import os
import tempfile
import time

from llmlb_tpu_torch.gateway.events import DashboardEventBus
from llmlb_tpu_torch.gateway.gate import InferenceGate

log = logging.getLogger("llmlb_tpu_torch.gateway.update")

CHECK_INTERVAL_S = 3600.0  # parity: hourly background check
POST_RESTART_WATCH_S = 30.0  # parity: 30 s health watch after restart
SCHEDULE_TICK_S = 5.0


class UpdateState(str, enum.Enum):
    UP_TO_DATE = "up_to_date"
    AVAILABLE = "available"
    DRAINING = "draining"
    APPLYING = "applying"
    FAILED = "failed"


class ApplyMode(str, enum.Enum):
    NORMAL = "normal"  # wait for in-flight inference to drain
    FORCE = "force"  # abort in-flight


@dataclasses.dataclass
class ScheduleConfig:
    mode: str = "immediate"  # immediate | on_idle | at_time
    at_time: float | None = None


class UpdateManager:
    def __init__(
        self,
        gate: InferenceGate,
        events: DashboardEventBus | None = None,
        drain_timeout_s: float = 300.0,
        apply_hook=None,  # async callable that performs the actual swap/restart
        check_hook=None,  # async callable returning {"version": ..} | None
        source=None,  # GitHubUpdateSource (or compatible)
        applier=None,  # ArtifactSwapApplier (or compatible)
        restart_cb=None,  # sync/async: hand control to the supervisor
    ):
        self.gate = gate
        self.events = events
        self.drain_timeout_s = drain_timeout_s
        self.apply_hook = apply_hook
        self.check_hook = check_hook
        self.source = source
        self.applier = applier
        self.restart_cb = restart_cb
        self.state = UpdateState.UP_TO_DATE
        self.available_version: str | None = None
        self.available_asset_url: str | None = None
        self.downloaded_path: str | None = None
        self._downloaded_version: str | None = None
        self.download_progress: dict | None = None  # {"done": n, "total": n}
        self.error: str | None = None
        self.schedule = ScheduleConfig()
        self.history: list[dict] = []
        self.last_check_at: float | None = None
        self._apply_task: asyncio.Task | None = None
        self.last_apply_mode: ApplyMode | None = None
        self._bg_tasks: list[asyncio.Task] = []

    @classmethod
    def from_env(cls, gate: InferenceGate, http, current_version: str,
                 events: DashboardEventBus | None = None,
                 drain_timeout_s: float = 300.0,
                 restart_cb=None) -> "UpdateManager":
        """Build with the real GitHub + artifact-swap hooks when
        LLMLB_UPDATE_REPO / LLMLB_UPDATE_ARTIFACT are configured."""
        from llmlb_tpu_torch.gateway.update_source import (
            ArtifactSwapApplier,
            GitHubUpdateSource,
        )

        repo = os.environ.get("LLMLB_UPDATE_REPO")
        artifact = os.environ.get("LLMLB_UPDATE_ARTIFACT")
        source = GitHubUpdateSource(
            http, repo, current_version,
            asset_match=os.environ.get("LLMLB_UPDATE_ASSET_MATCH", ""),
            api_base=os.environ.get(
                "LLMLB_UPDATE_API_BASE", "https://api.github.com"
            ),
        ) if repo else None
        applier = ArtifactSwapApplier(artifact) if artifact else None
        if repo and not artifact:
            log.warning(
                "LLMLB_UPDATE_REPO is set but LLMLB_UPDATE_ARTIFACT is not: "
                "update checks will run, but apply has nothing to swap and "
                "will fail rather than pretend to succeed"
            )
        return cls(
            gate, events, drain_timeout_s=drain_timeout_s,
            source=source, applier=applier, restart_cb=restart_cb,
        )

    def _set_state(self, state: UpdateState) -> None:
        self.state = state
        if self.events:
            self.events.publish(
                "UpdateStateChanged",
                {"state": state.value, "version": self.available_version},
            )

    def status(self) -> dict:
        return {
            "state": self.state.value,
            "available_version": self.available_version,
            "download_progress": self.download_progress,
            "error": self.error,
            "last_check_at": self.last_check_at,
            "schedule": dataclasses.asdict(self.schedule),
            "history": self.history[-10:],
        }

    async def check(self, force: bool = False) -> dict:
        """Query for an available update (hourly background + on demand).
        Priority: injected check_hook (tests) > GitHub source > none."""
        self.last_check_at = time.time()
        try:
            if self.check_hook is not None:
                info = await self.check_hook()
            elif self.source is not None:
                info = await self.source.check(force=force)
            else:
                return {"available": False}
        except Exception as e:
            self.error = str(e)
            return {"available": False, "error": str(e)}
        applying = self._apply_task is not None and not self._apply_task.done()
        if info and info.get("version"):
            if info["version"] in self._blocked_versions():
                log.warning(
                    "release %s was rolled back on this host; not offering it "
                    "again", info["version"],
                )
                if self.available_version == info["version"]:
                    self.available_version = None
                    self.available_asset_url = None
                if not applying and self.state == UpdateState.AVAILABLE:
                    self._set_state(UpdateState.UP_TO_DATE)
                return {"available": False, "blocked": info["version"]}
            self.available_version = info["version"]
            self.available_asset_url = info.get("asset_url")
            self.error = None  # a successful check clears stale errors
            if not applying:  # never stomp DRAINING/APPLYING mid-apply
                self._set_state(UpdateState.AVAILABLE)
            return {"available": True, **info}
        if not applying:
            self._set_state(UpdateState.UP_TO_DATE)
            self.error = None
        return {"available": False}

    # A version that failed its post-restart health watch is remembered on
    # disk so neither this process nor the restarted one re-offers it
    # (reference rollback semantics; prevents an apply/rollback flip-flop).
    def _blocklist_path(self) -> str | None:
        if self.applier is None:
            return None
        return os.path.join(self.applier.state_dir, "update_blocklist.json")

    def _blocked_versions(self) -> set[str]:
        path = self._blocklist_path()
        if not path:
            return set()
        try:
            with open(path) as f:
                return set(json.load(f))
        except FileNotFoundError:
            return set()
        except (OSError, ValueError) as e:
            log.warning("update blocklist at %s unreadable (%s); treating "
                        "as empty", path, e)
            return set()

    def _block_version(self, version: str | None) -> None:
        path = self._blocklist_path()
        if not path or not version:
            return
        blocked = self._blocked_versions() | {version}
        try:
            # atomic: a crash mid-write must not leave a truncated file that
            # silently reads back as an empty blocklist
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(sorted(blocked), f)
            os.replace(tmp, path)
        except OSError:
            log.warning("could not persist update blocklist at %s", path)

    _UNPINNED = object()  # sentinel: caller did not pin a release

    async def download(self, version=_UNPINNED, asset_url=_UNPINNED):
        """Fetch the asset to a staging path, publishing progress events
        (update/mod.rs download-with-progress). Callers on the apply path
        pass a pinned (version, asset_url) pair so a concurrent check()
        discovering a newer release can't relabel in-flight bytes — pinned
        values are authoritative, even when the pinned asset_url is None
        (no fallback to mutable instance state)."""
        if version is UpdateManager._UNPINNED:
            version = self.available_version
        if asset_url is UpdateManager._UNPINNED:
            asset_url = self.available_asset_url
        if self.source is None or not asset_url:
            return None
        # Cache is keyed by version: a staged download from a previous
        # release must never be applied under a newer version's label.
        if (self.downloaded_path
                and self._downloaded_version == version
                and os.path.isfile(self.downloaded_path)):
            return self.downloaded_path
        # Stage next to the artifact when possible (same filesystem, private
        # service dir); else a fresh 0700 tempdir — never a predictable path
        # in world-writable /tmp.
        if self.applier is not None:
            staging_dir = self.applier.state_dir
        else:
            staging_dir = tempfile.mkdtemp(prefix="llmlb-update-")
        staging = os.path.join(staging_dir, f"llmlb-update-{version}")

        def progress(done: int, total: int) -> None:
            self.download_progress = {"done": done, "total": total}
            # Throttle: one event per ~4 MiB. total==0 (chunked encoding)
            # must not bypass the throttle; the completion event below is
            # published unconditionally once the transfer finishes.
            if self.events and done % (1 << 22) < (1 << 16):
                self.events.publish("UpdateDownloadProgress", {
                    "version": version, "done": done, "total": total,
                })

        self.downloaded_path = await self.source.download(
            asset_url, staging, progress_cb=progress
        )
        self._downloaded_version = version
        done = (self.download_progress or {}).get("done", 0)
        self.download_progress = {"done": done, "total": done}
        if self.events:
            self.events.publish("UpdateDownloadProgress", {
                "version": version, "done": done, "total": done,
                "complete": True,
            })
        return self.downloaded_path

    def request_apply(self, mode: ApplyMode = ApplyMode.NORMAL) -> bool:
        if self._apply_task and not self._apply_task.done():
            return False
        self.last_apply_mode = mode
        self._apply_task = asyncio.create_task(self._apply_flow(mode))
        return True

    async def _apply_flow(self, mode: ApplyMode) -> None:
        """download → drain → apply → (restart). Reference §3.4 call stack."""
        started = time.time()
        # Pin the release being applied: a concurrent check() discovering a
        # newer version must not relabel this apply mid-flight.
        version = self.available_version
        asset_url = self.available_asset_url

        def fail(msg: str) -> None:
            self.error = msg
            self.history.append({
                "version": version, "mode": mode.value,
                "started_at": started, "finished_at": time.time(),
                "ok": False, "error": msg,
            })
            self._set_state(UpdateState.FAILED)
            # a failed FORCE apply must not leave shutdown drains disabled
            self.last_apply_mode = None

        # Everything that can fail without touching traffic happens BEFORE
        # the drain: the 503 window must cover only the swap itself.
        if version and version in self._blocked_versions():
            fail(f"release {version} was rolled back on this host")
            return
        if self.applier is not None and self.applier.read_marker():
            fail("previous update's post-restart health watch has not "
                 "completed; not stacking another apply")
            return
        staged = None
        if self.apply_hook is None:
            if self.applier is None:
                fail("no apply mechanism configured "
                     "(set LLMLB_UPDATE_ARTIFACT or an apply hook)")
                return
            try:
                staged = await self.download(version, asset_url)
            except Exception as e:
                fail(str(e))
                return
            if staged is None:
                fail(f"no downloadable asset for {version or 'update'}")
                return

        self._set_state(UpdateState.DRAINING)
        self.gate.start_rejecting()  # /v1/* now 503 + Retry-After
        try:
            if mode == ApplyMode.NORMAL:
                drained = await self.gate.wait_for_idle(self.drain_timeout_s)
                if not drained:
                    log.warning(
                        "drain timeout after %.0fs with %d in flight; proceeding",
                        self.drain_timeout_s, self.gate.in_flight,
                    )
            self._set_state(UpdateState.APPLYING)
            if self.apply_hook is not None:
                await self.apply_hook()
            else:
                self.applier.apply(staged, version)
                if self.restart_cb is not None:
                    r = self.restart_cb()
                    if asyncio.iscoroutine(r):
                        await r
            self.history.append({
                "version": version,
                "mode": mode.value,
                "started_at": started,
                "finished_at": time.time(),
                "ok": True,
            })
            self._set_state(UpdateState.UP_TO_DATE)
            self.error = None
            self.available_version = None
        except Exception as e:
            fail(str(e))
        finally:
            self.gate.stop_rejecting()

    def cancel_drain(self) -> bool:
        if self.state == UpdateState.DRAINING and self._apply_task:
            self._apply_task.cancel()
            self.gate.stop_rejecting()
            self._set_state(
                UpdateState.AVAILABLE if self.available_version
                else UpdateState.UP_TO_DATE
            )
            return True
        return False

    def set_schedule(self, mode: str, at_time: float | None = None) -> None:
        if mode not in ("immediate", "on_idle", "at_time"):
            raise ValueError(f"unknown schedule mode {mode!r}")
        self.schedule = ScheduleConfig(mode=mode, at_time=at_time)

    # ------------------------------------------------------- background tasks

    def start_background_tasks(
        self, check_interval_s: float = CHECK_INTERVAL_S
    ) -> None:
        """Hourly release check + schedule executor (update/mod.rs:807-905,
        schedule.rs:17-90)."""
        self._bg_tasks.append(asyncio.create_task(
            self._check_loop(check_interval_s), name="update-check"
        ))
        self._bg_tasks.append(asyncio.create_task(
            self._schedule_loop(), name="update-schedule"
        ))

    async def stop_background_tasks(self) -> None:
        for t in self._bg_tasks:
            t.cancel()
        for t in self._bg_tasks:
            try:
                await t
            except (asyncio.CancelledError, Exception):
                pass  # allow-silent: shutdown teardown of cancelled tasks
        self._bg_tasks.clear()

    async def _check_loop(self, interval_s: float) -> None:
        while True:
            try:
                await self.check()
            except Exception:
                log.exception("background update check failed")
            await asyncio.sleep(interval_s)

    async def _schedule_loop(self) -> None:
        """Fire a pending AVAILABLE update per the configured schedule:
        on_idle waits for zero in-flight inference; at_time waits for the
        wall clock. 'immediate' keeps apply operator-triggered (API parity:
        the reference's Immediate mode is what /update/apply does)."""
        while True:
            await asyncio.sleep(SCHEDULE_TICK_S)
            try:
                if self.state != UpdateState.AVAILABLE:
                    continue
                if self.applier is not None and self.applier.read_marker():
                    continue  # current update's health watch still pending
                mode = self.schedule.mode
                if mode == "on_idle" and self.gate.in_flight == 0:
                    log.info("on_idle schedule firing update apply")
                    self.request_apply(ApplyMode.NORMAL)
                elif (mode == "at_time" and self.schedule.at_time
                        and time.time() >= self.schedule.at_time):
                    log.info("at_time schedule firing update apply")
                    self.schedule = ScheduleConfig()  # one-shot
                    self.request_apply(ApplyMode.NORMAL)
            except Exception:
                log.exception("schedule loop failure")

    # ---------------------------------------------------- post-restart watch

    async def post_restart_watch(
        self, health_check, watch_s: float = POST_RESTART_WATCH_S,
        interval_s: float = 1.0,
    ) -> str:
        """After a restart with a pending-update marker: confirm the new
        version is healthy for `watch_s`, else roll back from `.bak`
        (reference 30 s health watch + auto-rollback). `health_check` is an
        async callable returning truthy when serving is healthy.

        Returns one of: "no_marker", "healthy", "rolled_back",
        "rollback_failed"."""
        if self.applier is None:
            return "no_marker"
        marker = self.applier.read_marker()
        if not marker:
            return "no_marker"
        deadline = time.monotonic() + watch_s
        healthy_streak = 0
        while time.monotonic() < deadline:
            try:
                ok = await health_check()
            except Exception:
                ok = False
            if ok:
                healthy_streak += 1
                if healthy_streak >= 3:  # stable, not a lucky first probe
                    self.applier.clear_marker()
                    self.history.append({
                        "version": marker.get("version"),
                        "post_restart": "healthy", "ts": time.time(),
                    })
                    log.info("update %s confirmed healthy",
                             marker.get("version"))
                    return "healthy"
            else:
                healthy_streak = 0
            await asyncio.sleep(interval_s)
        rolled = self.applier.rollback()
        # Remember the bad release on disk: the restarted process (and this
        # one) must not offer or re-apply it.
        self._block_version(marker.get("version"))
        self.history.append({
            "version": marker.get("version"),
            "post_restart": "rolled_back" if rolled else "rollback_failed",
            "ts": time.time(),
        })
        self._set_state(UpdateState.FAILED)
        self.error = (
            f"update {marker.get('version')} unhealthy after restart; "
            + ("rolled back" if rolled else "rollback failed (no .bak)")
        )
        log.error("%s", self.error)
        if rolled and self.restart_cb is not None:
            r = self.restart_cb()
            if asyncio.iscoroutine(r):
                await r
        return "rolled_back" if rolled else "rollback_failed"
