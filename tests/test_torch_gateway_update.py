"""The port's self-update, instance lock and tray against the JAX package's.

`llmlb_tpu_torch/gateway/update.py`, `update_source.py`, `lock.py` and
`tray.py` are held against `llmlb_tpu/gateway/`'s:

- the update lifecycle: one stub release server (the standard library's, on
  127.0.0.1) drives both packages' `UpdateManager` through each scenario of
  `tests/gateway/test_update_lifecycle.py` (check, download, drain, swap and
  the post-restart watch; rollback on an unhealthy watch and the blocklist;
  the on-idle and at-time schedules; a check failure that is reported; an
  apply without an asset; an apply with no mechanism), each side on its own
  client (aiohttp for the reference, gateway/http.py for the port); both
  give the same sequence of results, the same published events, the same
  `status()` and history (timestamps dropped) and the same bytes on disk;
- the lock: a lock file that either package wrote is honoured by the
  other's `acquire`, `status` and `stop` (ROADMAP C23: the lock names the
  configured port, so two `--port 0` gateways on one data directory
  refuse each other in both packages);
- the tray: the same menu models and activation results for the same
  update states, and the same notifications from the event bus;
- both gateways answer `/api/system/update/*` and `/api/system/tray*` with
  the same statuses and bodies;
- the process: the real `serve` (tray on, updates from the stub), `status`,
  a refused second `serve`, a drained update that exits 0 and swaps the
  artifact, the restart whose watch clears the marker, and `stop`, with
  aiohttp, torch and jax unimportable.
"""

import asyncio
import dataclasses
import json
import os
import random
import re
import signal
import subprocess
import sys
import textwrap
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from types import SimpleNamespace

import aiohttp
import pytest

from llmlb_tpu.gateway import events as ref_events
from llmlb_tpu.gateway import gate as ref_gate
from llmlb_tpu.gateway import lock as ref_lock
from llmlb_tpu.gateway import tray as ref_tray
from llmlb_tpu.gateway import update as ref_update
from llmlb_tpu.gateway import update_source as ref_source
from llmlb_tpu_torch.gateway import events, gate, lock, tray, update
from llmlb_tpu_torch.gateway import http as gh
from llmlb_tpu_torch.gateway import update_source
from tests.support import ADMIN_PASSWORD

REPO = Path(__file__).resolve().parent.parent

REF = SimpleNamespace(events=ref_events, gate=ref_gate, lock=ref_lock,
                      tray=ref_tray, update=ref_update, source=ref_source,
                      session=aiohttp.ClientSession)
PORT = SimpleNamespace(events=events, gate=gate, lock=lock, tray=tray,
                       update=update, source=update_source,
                       session=gh.ClientSession)


@pytest.fixture(autouse=True)
def _no_tiktoken(monkeypatch):
    """The reference gateway's tiktoken path would fetch a BPE file over the
    network (ROADMAP C15)."""
    monkeypatch.setitem(sys.modules, "tiktoken", None)


class _Releases:
    """A GitHub Releases stand-in on 127.0.0.1 (the standard library's
    server on a thread): the latest release of acme/llmlb-tpu, `version`,
    with one asset `app.bin` of `asset` bytes. `hits` counts release
    checks."""

    def __init__(self, version: str = "v9.9.9", asset: bytes = b""):
        self.version, self.asset, self.hits = version, asset, 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, body: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/repos/acme/llmlb-tpu/releases/latest":
                    outer.hits += 1
                    return self._send(json.dumps({
                        "tag_name": outer.version, "body": "release notes",
                        "assets": [{"name": "app.bin",
                                    "browser_download_url":
                                        outer.url + "/assets/app.bin"}],
                    }).encode(), "application/json")
                if self.path == "/assets/app.bin":
                    return self._send(outer.asset, "application/octet-stream")
                self.send_error(404)

        self.srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = "http://127.0.0.1:%d" % self.srv.server_address[1]
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.srv.shutdown()
        self.srv.server_close()


@pytest.fixture(scope="module")
def releases():
    rel = _Releases(asset=random.Random(0).randbytes(300_007))
    yield rel
    rel.close()


_STAMPS = {"last_check_at", "started_at", "finished_at", "ts", "applied_at"}


def _unstamp(obj):
    if isinstance(obj, dict):
        return {k: (v is not None if k in _STAMPS else _unstamp(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unstamp(v) for v in obj]
    return obj


def _disk(root: Path) -> dict:
    """Every file under `root`: its bytes, or a marker's JSON with its
    timestamp dropped and its paths made relative."""
    out = {}
    for p in sorted(root.rglob("*")):
        if not p.is_file():
            continue
        rel = str(p.relative_to(root))
        if p.suffix == ".json":
            obj = json.loads(p.read_text())
            if isinstance(obj, dict):
                obj = {k: (os.path.relpath(v, root)
                           if k in ("artifact", "backup") else v)
                       for k, v in _unstamp(obj).items()}
            out[rel] = obj
        else:
            out[rel] = p.read_bytes()
    return out


async def _events(queue: asyncio.Queue) -> list:
    """The events published so far, in order, timestamps dropped. A
    download's progress events are kept only at completion: their number
    follows how the body arrived (chunks of at most 64 KiB, not exactly),
    so the others are checked for rising counts and dropped."""
    await asyncio.sleep(0.01)
    out, last = [], 0
    while not queue.empty():
        ev = queue.get_nowait()
        data = dict(ev["data"])
        if ev["type"] == "UpdateDownloadProgress" and not data.get(
                "complete"):
            assert last <= data["done"] <= data["total"]
            last = data["done"]
            continue
        out.append((ev["type"], data))
    return out


async def _until(pred, timeout_s: float = 20.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not pred():
        assert time.monotonic() < deadline, "timed out"
        await asyncio.sleep(0.005)


def _status(mgr) -> dict:
    return _unstamp(mgr.status())


# ------------------------------------------------------- the lifecycle


async def _lifecycle(pkg, rel: _Releases, root: Path) -> list:
    """check → cached check → download → drain around one in-flight
    request → swap with `.bak` and marker → restart → the post-restart
    watch clears the marker."""
    artifact = root / "app.bin"
    artifact.write_bytes(b"OLD ARTIFACT")
    restarts, out = [], []
    bus = pkg.events.DashboardEventBus()
    _, queue = bus.subscribe()
    async with pkg.session() as http:
        g = pkg.gate.InferenceGate()
        mgr = pkg.update.UpdateManager(
            g, bus, drain_timeout_s=20.0,
            source=pkg.source.GitHubUpdateSource(
                http, "acme/llmlb-tpu", "1.0.0", api_base=rel.url),
            applier=pkg.source.ArtifactSwapApplier(str(artifact)),
            restart_cb=lambda: restarts.append(1))
        hits = rel.hits
        out.append(("check", await mgr.check(), rel.hits - hits))
        out.append(("cached", await mgr.check(), rel.hits - hits))
        release = asyncio.Event()

        async def inference():
            with g.track():
                await release.wait()

        inflight = asyncio.create_task(inference())
        await asyncio.sleep(0)
        mode = pkg.update.ApplyMode.NORMAL
        out.append(("apply", mgr.request_apply(mode),
                    mgr.request_apply(mode)))
        await _until(lambda: mgr.state.value != "available")
        out.append(("draining", mgr.state.value, g.rejecting, g.in_flight,
                    _status(mgr), restarts[:]))
        release.set()
        await inflight
        await mgr._apply_task
        out.append(("applied", _status(mgr), restarts[:], g.rejecting))
        out.append(("disk", _disk(root)))

        async def healthy():
            return True

        out.append(("watch", await mgr.post_restart_watch(
            healthy, watch_s=5.0, interval_s=0.01), _status(mgr)))
        out.append(("watched disk", _disk(root)))
    out.append(("events", await _events(queue)))
    return out


async def _rollback(pkg, rel: _Releases, root: Path) -> list:
    """An unhealthy watch rolls back from `.bak`, blocklists the release on
    disk and restarts; a fresh manager (the restarted process) neither
    offers nor applies it."""
    artifact = root / "app.bin"
    artifact.write_bytes(b"BROKEN NEW VERSION")
    (root / "app.bin.bak").write_bytes(b"GOOD OLD VERSION")
    applier = pkg.source.ArtifactSwapApplier(str(artifact))
    applier.write_marker("v9.9.9")
    restarts, out = [], []
    bus = pkg.events.DashboardEventBus()
    _, queue = bus.subscribe()
    mgr = pkg.update.UpdateManager(pkg.gate.InferenceGate(), bus,
                                   applier=applier,
                                   restart_cb=lambda: restarts.append(1))

    async def never_healthy():
        return False

    out.append(("watch", await mgr.post_restart_watch(
        never_healthy, watch_s=0.2, interval_s=0.02), _status(mgr),
        mgr.error, restarts))
    out.append(("disk", _disk(root)))

    async def offers_v999():
        return {"version": "v9.9.9", "asset_url": "http://x/a"}

    mgr2 = pkg.update.UpdateManager(
        pkg.gate.InferenceGate(), bus,
        applier=pkg.source.ArtifactSwapApplier(str(artifact)),
        check_hook=offers_v999)
    out.append(("check", await mgr2.check(), _status(mgr2)))
    mgr2.available_version = "v9.9.9"
    assert mgr2.request_apply(pkg.update.ApplyMode.FORCE)
    await mgr2._apply_task
    out.append(("apply blocked", _status(mgr2), mgr2.last_apply_mode))
    out.append(("events", await _events(queue)))
    return out


async def _schedules(pkg, rel: _Releases, root: Path) -> list:
    """on_idle fires once no request is in flight; at_time fires once the
    clock passes and resets the schedule to immediate."""
    g = pkg.gate.InferenceGate()
    bus = pkg.events.DashboardEventBus()
    _, queue = bus.subscribe()
    applied, out = [], []

    async def apply_hook():
        applied.append(1)

    mgr = pkg.update.UpdateManager(g, bus, apply_hook=apply_hook,
                                   drain_timeout_s=0.5)
    mgr.available_version = "v2.0.0"
    mgr._set_state(pkg.update.UpdateState.AVAILABLE)
    mgr.set_schedule("on_idle")
    with pytest.raises(ValueError, match="unknown schedule mode"):
        mgr.set_schedule("weekly")
    mgr.start_background_tasks(check_interval_s=3600)
    try:
        with g.track():
            await asyncio.sleep(0.1)
            out.append(("busy", len(applied), mgr.state.value))
        await _until(lambda: applied)
        await mgr._apply_task
        out.append(("idle", len(applied), _status(mgr)))
        applied.clear()
        mgr.available_version = "v2.1.0"
        mgr._set_state(pkg.update.UpdateState.AVAILABLE)
        mgr.set_schedule("at_time", time.time() + 0.15)
        out.append(("waiting", _status(mgr)["schedule"]["mode"]))
        await _until(lambda: applied)
        await mgr._apply_task
        out.append(("at_time", len(applied), _status(mgr)))
    finally:
        await mgr.stop_background_tasks()
    out.append(("events", await _events(queue)))
    return out


async def _check_failure(pkg, rel: _Releases, root: Path) -> list:
    """A release check that cannot connect is reported in the result and
    in `status()`, not raised. The message is each client library's own:
    only its presence is compared."""
    async with pkg.session() as http:
        mgr = pkg.update.UpdateManager(
            pkg.gate.InferenceGate(),
            source=pkg.source.GitHubUpdateSource(
                http, "acme/x", "1.0.0", api_base="http://127.0.0.1:1"))
        res = await mgr.check()
    assert isinstance(res["error"], str) and res["error"]
    assert mgr.error == res["error"]
    return [("check", {**res, "error": True},
             {**_status(mgr), "error": True})]


async def _no_asset(pkg, rel: _Releases, root: Path) -> list:
    """A release with no matching asset fails before the drain."""
    artifact = root / "app.bin"
    artifact.write_bytes(b"OLD")
    bus = pkg.events.DashboardEventBus()
    _, queue = bus.subscribe()
    async with pkg.session() as http:
        g = pkg.gate.InferenceGate()
        mgr = pkg.update.UpdateManager(
            g, bus, source=pkg.source.GitHubUpdateSource(
                http, "acme/llmlb-tpu", "1.0.0", asset_match="no-such-asset",
                api_base=rel.url),
            applier=pkg.source.ArtifactSwapApplier(str(artifact)))
        res = await mgr.check(force=True)
        assert mgr.request_apply(pkg.update.ApplyMode.NORMAL)
        await mgr._apply_task
    return [("check", res), ("apply", _status(mgr), g.rejecting,
                             mgr.last_apply_mode),
            ("disk", _disk(root)), ("events", await _events(queue))]


async def _no_mechanism(pkg, rel: _Releases, root: Path) -> list:
    """No hook and no applier: the apply is recorded as a failure."""
    g = pkg.gate.InferenceGate()
    bus = pkg.events.DashboardEventBus()
    _, queue = bus.subscribe()
    mgr = pkg.update.UpdateManager(g, bus)
    mgr.available_version = "v2.0.0"
    mgr._set_state(pkg.update.UpdateState.AVAILABLE)
    assert mgr.request_apply(pkg.update.ApplyMode.NORMAL)
    await mgr._apply_task
    assert not mgr.cancel_drain()
    return [("apply", _status(mgr), g.rejecting),
            ("events", await _events(queue))]


@pytest.mark.parametrize("scenario", [
    _lifecycle, _rollback, _schedules, _check_failure, _no_asset,
    _no_mechanism], ids=lambda f: f.__name__.strip("_"))
async def test_lifecycle_matches_the_jax_package(scenario, releases,
                                                 tmp_path, monkeypatch):
    monkeypatch.setattr(ref_update, "SCHEDULE_TICK_S", 0.02)
    monkeypatch.setattr(update, "SCHEDULE_TICK_S", 0.02)
    got = {}
    for name, pkg in (("jax", REF), ("port", PORT)):
        root = tmp_path / name
        root.mkdir()
        got[name] = await scenario(pkg, releases, root)
    assert got["port"] == got["jax"]
    if scenario is _lifecycle:
        check, cached = got["port"][:2]
        assert check[1]["available"] and check[2] == 1 and cached[2] == 1
        applied = dict((r[0], r) for r in got["port"])["applied"][1]
        assert applied["download_progress"] == {
            "done": len(releases.asset), "total": len(releases.asset)}
        disk = dict((r[0], r) for r in got["port"])["disk"][1]
        assert disk["app.bin"] == releases.asset
        assert disk["app.bin.bak"] == b"OLD ARTIFACT"
        assert disk["update_pending.json"]["version"] == "v9.9.9"


async def test_cancel_drain_matches(releases, tmp_path):
    """A drain cancelled by the operator: back to available, the gate
    open, nothing swapped."""
    got = {}
    for name, pkg in (("jax", REF), ("port", PORT)):
        root = tmp_path / name
        root.mkdir()
        (root / "app.bin").write_bytes(b"OLD")
        bus = pkg.events.DashboardEventBus()
        _, queue = bus.subscribe()
        async with pkg.session() as http:
            g = pkg.gate.InferenceGate()
            mgr = pkg.update.UpdateManager(
                g, bus, drain_timeout_s=30.0,
                source=pkg.source.GitHubUpdateSource(
                    http, "acme/llmlb-tpu", "1.0.0", api_base=releases.url),
                applier=pkg.source.ArtifactSwapApplier(str(root / "app.bin")))
            await mgr.check(force=True)
            with g.track():
                mgr.request_apply()
                await _until(lambda: mgr.state.value == "draining")
                cancelled = mgr.cancel_drain()
                await asyncio.sleep(0.01)
                row = (cancelled, _status(mgr), g.rejecting,
                       mgr._apply_task.cancelled())
        got[name] = [row, _disk(root), await _events(queue)]
    assert got["port"] == got["jax"]
    assert got["port"][0][0] is True and got["port"][0][2] is False


def test_is_newer_matches():
    rng = random.Random(0)
    tags = ["1.0.0", "v1.0.0", "1.10.0", "1.9.9", "v2.0.0-rc1", "2.0.0",
            "0.1.0", "v0.1.0", "1.0", "1.0.0.1", "", "vX", "1.0.0-beta",
            "v9.9.9"]
    pairs = [(a, b) for a in tags for b in tags]
    pairs += [(".".join(str(rng.randrange(12)) for _ in range(3)),
               ".".join(str(rng.randrange(12)) for _ in range(3)))
              for _ in range(200)]
    assert [update_source.is_newer(a, b) for a, b in pairs] == [
        ref_source.is_newer(a, b) for a, b in pairs]


# ----------------------------------------------------------------- lock


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["jax-writes", "port-writes"])
def test_lock_is_shared_with_the_jax_package(writer, reader, tmp_path,
                                             monkeypatch):
    """The same path and JSON: a live holder refuses the other package's
    acquire with the same message and shows in its status; released, it is
    gone from both; a stale file (a dead pid) is taken over; stop sends the
    holder SIGTERM. Port 0 is a port like another (C23)."""
    monkeypatch.setenv("LLMLB_DATA_DIR", str(tmp_path))
    for port in (45123, 0):
        held = writer.lock.ServerLock.acquire(port)
        assert held.path == str(tmp_path / f"llmlb-{port}.lock")
        info = json.loads(Path(held.path).read_text())
        assert set(info) == {"pid", "port", "ts"}
        assert reader.lock.ServerLock.status(port) == info == \
            writer.lock.ServerLock.status(port)
        errors = []
        for pkg in (writer, reader):
            with pytest.raises(RuntimeError) as e:
                pkg.lock.ServerLock.acquire(port)
            errors.append(str(e.value))
        assert errors[0] == errors[1] == (
            f"another llmlb instance (pid {os.getpid()}) already holds "
            f"port {port}")
        held.release()
        assert reader.lock.ServerLock.status(port) is None
        assert not reader.lock.ServerLock.stop(port)

    # a stale lock: its holder has exited
    dead = subprocess.Popen([sys.executable, "-c", "pass"])
    dead.wait()
    with monkeypatch.context() as m:
        m.setattr(writer.lock.os, "getpid", lambda: dead.pid)
        writer.lock.ServerLock.acquire(45124)
    assert reader.lock.ServerLock.status(45124) is None
    taken = reader.lock.ServerLock.acquire(45124)
    assert reader.lock.ServerLock.status(45124)["pid"] == os.getpid()
    taken.release()

    # stop: the holder is another live process
    child = subprocess.Popen([sys.executable, "-c",
                              "import time; time.sleep(60)"])
    try:
        with monkeypatch.context() as m:
            m.setattr(writer.lock.os, "getpid", lambda: child.pid)
            writer.lock.ServerLock.acquire(45125)
        assert reader.lock.ServerLock.status(45125)["pid"] == child.pid
        assert reader.lock.ServerLock.stop(45125)
        assert child.wait(timeout=10) == -signal.SIGTERM
        assert reader.lock.ServerLock.status(45125) is None
        assert writer.lock.ServerLock.status(45125) is None
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()


@pytest.mark.parametrize("pkg", ["port", "jax"])
async def test_a_start_that_fails_releases_the_lock(pkg, tmp_path,
                                                    monkeypatch):
    """C25: `run_server` on a port that another socket holds raises
    EADDRINUSE after it took the lock. The port releases the lock on the
    way out, so this process (whose pid lives on) can take it again; the
    reference leaves its file, and every later acquire in this process is
    refused."""
    import socket

    from llmlb_tpu.gateway import config as ref_config
    from llmlb_tpu.gateway import server as ref_server
    from llmlb_tpu_torch.gateway import config, server

    cfg_mod, srv, lk = ((config, server, lock) if pkg == "port"
                        else (ref_config, ref_server, ref_lock))
    monkeypatch.setenv("LLMLB_DATA_DIR", str(tmp_path))
    monkeypatch.setenv("LLMLB_ADMIN_PASSWORD", ADMIN_PASSWORD)
    for native in ("llmlb_tpu.native", "llmlb_tpu_torch.native"):
        monkeypatch.setattr(f"{native}.ensure_native_built", lambda: None)
    busy = socket.socket()
    busy.bind(("127.0.0.1", 0))
    busy.listen()
    port = busy.getsockname()[1]
    try:
        cfg = dataclasses.replace(
            cfg_mod.ServerConfig.from_env(), host="127.0.0.1", port=port,
            database_url=str(tmp_path / "llmlb.db"))
        with pytest.raises(OSError):
            await srv.run_server(cfg)
    finally:
        busy.close()
    if pkg == "port":
        assert lk.ServerLock.status(port) is None
        assert not (tmp_path / f"llmlb-{port}.lock").exists()
        lk.ServerLock.acquire(port).release()
    else:
        assert lk.ServerLock.status(port)["pid"] == os.getpid()
        with pytest.raises(RuntimeError, match="already holds"):
            lk.ServerLock.acquire(port)
        os.unlink(tmp_path / f"llmlb-{port}.lock")


# ----------------------------------------------------------------- tray


def _tray_pair(pkg, opened: list, quits: list):
    bus = pkg.events.DashboardEventBus()
    mgr = pkg.update.UpdateManager(pkg.gate.InferenceGate(), events=bus)
    t = pkg.tray.TrayController(
        "http://gw:1234/dashboard", mgr, events=bus,
        open_url_cb=opened.append, quit_cb=lambda: quits.append(1))
    return bus, mgr, t


async def _tray_script(pkg) -> list:
    """Menus over every state and schedule, each menu item's activation,
    and the notifications the bus's events raise."""
    opened, quits, out = [], [], []
    bus, mgr, t = _tray_pair(pkg, opened, quits)
    State = pkg.update.UpdateState
    for state, version, error in [
            (State.UP_TO_DATE, None, None), (State.AVAILABLE, "v2.0.0", None),
            (State.AVAILABLE, None, None), (State.DRAINING, "v2.0.0", None),
            (State.APPLYING, "v2.0.0", None),
            (State.FAILED, "v2.0.0", "disk full " * 20),
            (State.FAILED, None, None)]:
        mgr.state, mgr.available_version, mgr.error = state, version, error
        t.refresh()
        out.append(("menu", state.value, t.status()["menu"]))
    mgr.state, mgr.available_version, mgr.error = State.UP_TO_DATE, None, None
    for mode, at in [("on_idle", None), ("at_time", 1_800_000_000.0),
                     ("at_time", None), ("immediate", None)]:
        mgr.set_schedule(mode, at)
        t.refresh()
        out.append(("schedule", mode, t.menu_model()[2]))

    checks, applied = [], asyncio.Event()

    async def check_hook():
        checks.append(1)
        return {"version": "v3.0.0", "asset_url": None}

    async def apply_hook():
        applied.set()

    mgr.check_hook, mgr.apply_hook = check_hook, apply_hook
    await t.start()
    try:
        out.append(("activate", "update", await t.activate("update"),
                    len(checks), mgr.state.value))
        out.append(("activate", "update", await t.activate("update")))
        await asyncio.wait_for(applied.wait(), 10)
        await mgr._apply_task
        for item in ("open_dashboard", "quit", "nonsense"):
            out.append(("activate", item, await t.activate(item)))
        out.append(("callbacks", opened, quits))
        # the bus: one notification a version (the check above raised the
        # first), one a failure; a bad event does not stop the pump
        mgr.error = "bad artifact"
        for data in ({"state": "available", "version": "v5.0.0"},
                     {"state": "available", "version": "v5.0.0"},
                     None,
                     {"state": "failed", "version": "v5.0.0"},
                     {"state": "available", "version": "v6.0.0"}):
            if data is None:
                notify = t.backend.notify
                t.backend.notify = None  # the next notify raises
                bus.publish("UpdateStateChanged",
                            {"state": "available", "version": "v5.5.0"})
                await asyncio.sleep(0.05)
                t.backend.notify = notify
                continue
            bus.publish("UpdateStateChanged", data)
            bus.publish("TpsUpdated", {})
            await asyncio.sleep(0.02)
        await _until(lambda: len(t.backend.notifications) == 4)
        out.append(("notifications", [
            {k: v for k, v in n.items() if k != "ts"}
            for n in t.status()["notifications"]]))
    finally:
        await t.stop()
    out.append(("stopped", t._task, t._sub_id))
    return out


async def test_tray_matches_the_jax_package():
    got = {"jax": await _tray_script(REF), "port": await _tray_script(PORT)}
    assert got["port"] == got["jax"]
    menus = [r for r in got["port"] if r[0] == "menu"]
    assert menus[1][2][1] == {"id": "update", "enabled": True,
                              "label": "Update to v2.0.0 available — apply"}
    notes = got["port"][-2][1]
    assert [(n["title"], n["body"]) for n in notes] == [
        ("Update available", "Version v3.0.0 is ready to apply from the tray "
                             "menu."),
        ("Update available", "Version v5.0.0 is ready to apply from the tray "
                             "menu."),
        ("Update failed", "bad artifact"),
        ("Update available", "Version v6.0.0 is ready to apply from the tray "
                             "menu.")]


# ------------------------------------------------------ both gateways


async def _gateway_surface(base: str, state, pkg) -> list:
    """/api/system/update/* and /api/system/tray* with nothing attached,
    then with a tray and an update manager on hooks."""
    out = []
    async with gh.ClientSession() as s:
        r = await s.post(base + "/api/auth/login", json={
            "username": "admin", "password": ADMIN_PASSWORD})
        admin = {"Authorization": "Bearer " + (await r.json())["token"]}

        async def call(method, path, body=None, headers=admin):
            r = await s.request(method, base + path, json=body,
                                headers=headers)
            data = await r.read()
            obj = json.loads(data) if data else None
            out.append((method, path, r.status, _unstamp(obj)))

        async def surface():
            await call("GET", "/api/system/tray")
            await call("POST", "/api/system/tray/activate", {"item": "x"})
            await call("POST", "/api/system/tray/activate", {})
            for verb in ("check", "cancel"):
                await call("POST", f"/api/system/update/{verb}")
            await call("PUT", "/api/system/update/schedule",
                       {"mode": "on_idle"})
            await call("PUT", "/api/system/update/schedule",
                       {"mode": "weekly"})
            await call("POST", "/api/system/update/apply")
            if state.update_manager is not None:
                await state.update_manager._apply_task
            r = await s.get(base + "/api/system", headers=admin)
            out.append(("system", _unstamp({
                k: v for k, v in (await r.json()).items()
                if k not in ("uptime_s", "version")})))

        await surface()
        await call("GET", "/api/system/tray", headers={
            "Authorization": "Bearer bogus"})
        applied = []

        async def check_hook():
            return {"version": "v7.7.7"}

        async def apply_hook():
            applied.append(1)

        mgr = pkg.update.UpdateManager(state.gate, events=state.events,
                                       check_hook=check_hook,
                                       apply_hook=apply_hook)
        state.update_manager = mgr
        state.tray = pkg.tray.TrayController("http://x/dashboard", mgr)
        await surface()
        await call("POST", "/api/system/tray/activate", {"item": "update"})
        await mgr._apply_task
        await call("POST", "/api/system/update/apply", {"force": True})
        await mgr._apply_task
        await call("GET", "/api/system/tray")
        out.append(("applied", len(applied)))
    return out


async def test_both_gateways_answer_the_same(monkeypatch):
    from tests.test_torch_gateway_e2e import _jax_gateway, _PortGateway

    monkeypatch.setenv("LLMLB_ADMIN_PASSWORD", ADMIN_PASSWORD)
    jgw, jbase = await _jax_gateway()
    pgw = await _PortGateway.create()
    try:
        got = {"jax": await _gateway_surface(jbase, jgw.state, REF),
               "port": await _gateway_surface(pgw.url, pgw.state, PORT)}
    finally:
        await jgw.close()
        await pgw.close()
    assert got["port"] == got["jax"]
    by = {(r[0], r[1]): r for r in got["port"][:8]}
    assert by[("GET", "/api/system/tray")][2:] == (200, {"enabled": False})
    assert by[("POST", "/api/system/tray/activate")][2] == 404
    assert by[("POST", "/api/system/update/check")][2:] == (
        501, {"error": "updates not configured"})
    assert got["port"][-1] == ("applied", 2)


# -------------------------------------------------------------- process


_BLOCKED = textwrap.dedent("""
    import runpy, sys
    for n in ("torch", "aiohttp", "argon2", "jax", "llmlb_tpu"):
        sys.modules[n] = None
    sys.argv = ["server"] + sys.argv[1:]
    runpy.run_module("llmlb_tpu_torch.gateway.server", run_name="__main__")
""")


def _cli(env: dict, *args: str, timeout: float = 60):
    return subprocess.run([sys.executable, "-c", _BLOCKED, *args], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _http(base: str, method: str, path: str, body=None, headers=None):
    req = urllib.request.Request(
        base + path, method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _login(base: str) -> dict:
    _, got = _http(base, "POST", "/api/auth/login",
                   {"username": "admin", "password": "adminpass1"})
    return {"Authorization": f"Bearer {got['token']}"}


def test_serve_status_update_restart_and_stop(tmp_path):
    """The real process on port 0 with aiohttp, torch and jax unimportable,
    updates from the stub and the tray on: `status` names it; a second
    `serve --port 0` on the same data directory is refused by the lock
    (C23: the lock names the configured port, as the reference's); check,
    then a normal apply swaps the artifact and exits 0, the lock released;
    the restarted gateway's watch clears the marker; `stop` ends it."""
    rel = _Releases(asset=random.Random(1).randbytes(200_003))
    data = tmp_path / "data"
    data.mkdir()
    artifact = data / "app.bin"
    artifact.write_bytes(b"OLD ARTIFACT")
    env = {**os.environ, "LLMLB_DATA_DIR": str(data),
           "LLMLB_LOG_DIR": str(tmp_path / "logs"),
           "LLMLB_ADMIN_PASSWORD": "adminpass1", "LLMLB_PORT": "0",
           "LLMLB_UPDATE_REPO": "acme/llmlb-tpu",
           "LLMLB_UPDATE_API_BASE": rel.url,
           "LLMLB_UPDATE_ARTIFACT": str(artifact), "LLMLB_TRAY": "1"}
    serve_argv = [sys.executable, "-c", _BLOCKED, "serve", "--host",
                  "127.0.0.1", "--port", "0"]
    procs = []

    def serve(tag: str):
        log = tmp_path / f"{tag}.log"
        with open(log, "w") as out:
            proc = subprocess.Popen(serve_argv, cwd=REPO, env=env,
                                    stdout=out, stderr=subprocess.STDOUT)
        procs.append(proc)
        deadline = time.monotonic() + 60
        while True:
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)", log.read_text())
            if m:
                return proc, f"http://127.0.0.1:{m.group(1)}"
            assert proc.poll() is None and time.monotonic() < deadline, \
                log.read_text()
            time.sleep(0.02)

    try:
        first, base = serve("first")
        second = subprocess.Popen(serve_argv, cwd=REPO, env=env,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
        procs.append(second)
        status = _cli(env, "status")
        assert status.stdout.strip() == f"running: pid={first.pid} port=0"
        second_out = second.communicate(timeout=60)[0]
        assert second.returncode != 0
        assert (f"RuntimeError: another llmlb instance (pid {first.pid}) "
                "already holds port 0") in second_out
        assert "listening" not in second_out
        assert _http(base, "GET", "/health") == (200, {"status": "ok"})

        admin = _login(base)
        status, got = _http(base, "POST", "/api/system/update/check",
                            headers=admin)
        assert (status, got["available"], got["version"]) == (
            200, True, "v9.9.9")
        deadline = time.monotonic() + 10
        while True:
            _, tray_view = _http(base, "GET", "/api/system/tray",
                                 headers=admin)
            if tray_view["notifications"] or time.monotonic() > deadline:
                break
            time.sleep(0.02)
        assert tray_view["menu"][1]["label"] == (
            "Update to v9.9.9 available — apply")
        assert [n["title"] for n in tray_view["notifications"]] == [
            "Update available"]
        status, got = _http(base, "POST", "/api/system/update/apply", {},
                            headers=admin)
        assert status == 202 and got["applying"] is True
        assert first.wait(timeout=60) == 0
        assert artifact.read_bytes() == rel.asset
        assert (data / "app.bin.bak").read_bytes() == b"OLD ARTIFACT"
        marker = json.loads((data / "update_pending.json").read_text())
        assert marker["version"] == "v9.9.9"
        assert not (data / "llmlb-0.lock").exists()

        # the supervisor's restart
        again, base = serve("again")
        deadline = time.monotonic() + 30
        while (data / "update_pending.json").exists():
            assert time.monotonic() < deadline and again.poll() is None
            time.sleep(0.05)
        _, system = _http(base, "GET", "/api/system", headers=_login(base))
        assert {"version": "v9.9.9", "post_restart": "healthy"} in [
            {k: v for k, v in h.items() if k != "ts"}
            for h in system["update"]["history"]]
        assert _cli(env, "stop", "--port", "0").stdout.strip() == "stopped"
        assert again.wait(timeout=60) == 0
        assert _cli(env, "status").stdout.strip() == "not running"
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        rel.close()
    for tag in ("first", "again"):
        text = (tmp_path / f"{tag}.log").read_text()
        assert "Traceback" not in text, text
