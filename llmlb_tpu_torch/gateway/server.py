"""Gateway server entry: bootstrap state, serve, graceful shutdown.

The port's counterpart of llmlb_tpu/gateway/server.py, on the standard
library (gateway/http.py):

    python -m llmlb_tpu_torch.gateway.server serve [--host H] [--port P]
        [--workers N]
    python -m llmlb_tpu_torch.gateway.server status
    python -m llmlb_tpu_torch.gateway.server stop [--port P]
    python -m llmlb_tpu_torch.gateway.server assistant {curl,openapi,guide} ...

Configuration is the reference's environment (`LLMLB_PORT`,
`LLMLB_DATA_DIR`, `LLMLB_ADMIN_PASSWORD`, ... see config.py); logs go to
stderr and to a daily-rotated file under `LLMLB_LOG_DIR`
(logging_setup.py), which `/api/dashboard/logs/lb` tails. The dashboard is
served at `/dashboard`. SIGINT or SIGTERM drains in-flight inference for
up to 30 s (open dashboard sockets close with 1001 at once), then stops; a
second signal stops at once. At start (before any worker forks) it builds
the native library (llmlb_tpu_torch/native/) if it is not built yet.

Multi-worker serving (``--workers N`` / ``LLMLB_WORKERS``): a supervisor
forks N shared-nothing gateway processes that share the listen port via
SO_REUSEPORT; see gateway/worker.py and docs/deployment.md. N > 1 needs a
fixed port (port 0 would give each worker an ephemeral port of its own).
The workers gossip over unix sockets under ``LLMLB_GOSSIP_DIR`` (default
``$LLMLB_DATA_DIR/gossip/<port>``); the elected primary (worker 0) runs the
health checker, maintenance, the rebalancer, the update manager's
background checks, the tray and the post-restart health watch, and keeps
the log file. SIGTERM to the supervisor reaches every worker; each drains,
and the supervisor exits 0.

One gateway holds a port: `serve` takes the instance lock
`$LLMLB_DATA_DIR/llmlb-<port>.lock` (gateway/lock.py; the supervisor holds
it for its workers), `status` reads it and `stop` sends its holder SIGTERM.
The lock names the configured port, so every `--port 0` gateway on one data
directory shares `llmlb-0.lock`: give each its own LLMLB_DATA_DIR.
Self-update (gateway/update.py) is on when LLMLB_UPDATE_REPO and
LLMLB_UPDATE_ARTIFACT are set: an apply drains `/v1/*`, swaps the
artifact (keeping `.bak`) and exits 0 for the supervisor to restart it; the
restarted gateway watches its own /health for 30 s and rolls back from
`.bak` if it is unhealthy. LLMLB_TRAY=1 attaches the headless tray
(gateway/tray.py, `/api/system/tray`), LLMLB_UVLOOP=1 runs the event loop
on uvloop where it is installed. `assistant` is gateway/assistant.py.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import time

from llmlb_tpu_torch.gateway.app import create_app
from llmlb_tpu_torch.gateway.app_state import build_app_state
from llmlb_tpu_torch.gateway.config import ServerConfig, env_bool
from llmlb_tpu_torch.gateway.http import web
from llmlb_tpu_torch.gateway.lock import ServerLock
from llmlb_tpu_torch.gateway.logging_setup import init_logging
from llmlb_tpu_torch.gateway.update import ApplyMode, UpdateManager
from llmlb_tpu_torch.gateway.worker import (
    WorkerInfo,
    current_worker,
    run_supervisor,
    supports_reuse_port,
    worker_count_from_env,
)

log = logging.getLogger("llmlb_tpu_torch.gateway.server")


def maybe_install_uvloop() -> bool:
    """Opt-in uvloop (LLMLB_UVLOOP=1): a drop-in libuv event loop worth
    ~2-3x on the pure proxy path. Graceful fallback — uvloop is not a
    dependency of this repo, so absence logs and keeps the stdlib loop."""
    if not env_bool("LLMLB_UVLOOP", False):
        return False
    try:
        import uvloop  # type: ignore[import-not-found]
    except ImportError:
        log.warning("LLMLB_UVLOOP=1 but uvloop is not installed; "
                    "using the stdlib asyncio event loop")
        return False
    asyncio.set_event_loop_policy(uvloop.EventLoopPolicy())
    log.info("uvloop event loop policy installed")
    return True


async def run_server(config: ServerConfig | None = None, *,
                     worker: WorkerInfo | None = None,
                     acquire_lock: bool = True, ready=None) -> None:
    """Serve until SIGINT/SIGTERM, or until an update apply hands over to
    the supervisor. `ready`, when given, is called with the bound (host,
    port) once the socket listens."""
    config = config or ServerConfig.from_env()
    worker = worker or current_worker()
    if config.database_url:
        os.makedirs(os.path.dirname(config.database_url) or ".",
                    exist_ok=True)

    from llmlb_tpu_torch.native import ensure_native_built

    ensure_native_built()  # blocking build belongs here, not in a request path

    # In multi-worker mode the supervisor holds the instance lock for the
    # whole group; forked workers must not fight over it.
    lock = ServerLock.acquire(config.port) if acquire_lock else None
    try:
        await _serve(config, worker, ready)
    finally:
        # Released however serving ends, a setup that raises included (a
        # port another program holds): a caller in a process that lives on
        # can serve on this port again (ROADMAP C25).
        if lock is not None:
            lock.release()


async def _serve(config: ServerConfig, worker: WorkerInfo, ready) -> None:
    state = await build_app_state(config, worker=worker)
    stop_event = asyncio.Event()

    from llmlb_tpu_torch import __version__

    # Real self-update wiring when LLMLB_UPDATE_REPO/ARTIFACT are set:
    # restart = graceful exit, the supervisor re-execs the (new) artifact.
    state.update_manager = UpdateManager.from_env(
        state.gate, state.http, __version__, events=state.events,
        drain_timeout_s=config.update_drain_timeout_s,
        restart_cb=stop_event.set,
    )
    # Background update checks run on the elected primary only; an apply
    # landing on any worker still drains and exits that worker, which takes
    # the whole group down for the external supervisor to re-exec.
    if worker.is_primary:
        state.update_manager.start_background_tasks()
    app = create_app(state)

    # Short shutdown grace: idle keep-alive connections must not delay a
    # supervisor restart.
    runner = web.AppRunner(app, shutdown_timeout=5.0)
    await runner.setup()
    site = web.TCPSite(
        runner, config.host, config.port,
        # N workers bind the same (host, port); the kernel load-balances
        # accepted connections across their accept queues.
        reuse_port=True if worker.multi else None,
    )
    await site.start()
    host, port = runner.addresses[0][:2]
    log.info("llmlb_tpu_torch gateway listening on %s:%d", host, port)
    if ready is not None:
        ready(host, port)

    probe_host = config.host
    if probe_host in ("0.0.0.0", "::", ""):
        probe_host = "127.0.0.1"
    elif ":" in probe_host:  # bare IPv6 address needs brackets in a URL
        probe_host = f"[{probe_host}]"

    # Tray equivalent (reference gui/tray.rs, win/mac only): opt-in on
    # headless hosts; menu/notifications surface at /api/system/tray. One
    # tray per gateway instance, not per worker.
    if worker.is_primary and os.environ.get(
        "LLMLB_TRAY", "0"
    ).lower() in ("1", "true"):
        from llmlb_tpu_torch.gateway.tray import TrayController

        state.tray = TrayController(
            f"http://{probe_host}:{port}/dashboard",
            state.update_manager,
            events=state.events,
            quit_cb=stop_event.set,
        )
        await state.tray.start()

    async def self_health() -> bool:
        try:
            async with state.http.get(
                f"http://{probe_host}:{port}/health", timeout=2
            ) as r:
                return r.status == 200
        except Exception:
            return False

    # If we just restarted into a freshly applied update, watch health for
    # 30 s and roll back from .bak on failure (reference post-restart watch).
    # Primary-only: one watcher per instance decides the rollback.
    watch_task = (
        asyncio.create_task(
            state.update_manager.post_restart_watch(self_health)
        )
        if worker.is_primary else None
    )

    hard_stop = asyncio.Event()
    first_signal_at = 0.0

    def on_signal() -> None:
        nonlocal first_signal_at
        now = time.monotonic()
        if stop_event.is_set():
            # a deliberate second signal (not a duplicate delivery of the
            # first) escalates to a hard stop
            if now - first_signal_at > 0.5:
                hard_stop.set()
        else:
            first_signal_at = now
        stop_event.set()

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, on_signal)
        except NotImplementedError:
            pass
    try:
        await stop_event.wait()
    finally:
        log.info("shutting down")
        if watch_task is not None:
            watch_task.cancel()
        if state.tray is not None:
            await state.tray.stop()
        await state.update_manager.stop_background_tasks()
        # Drain in-flight inference before tearing the server down: with the
        # 5 s shutdown grace above, an ordinary SIGTERM would otherwise cut
        # long-running generations mid-stream. Skipped after a FORCE apply
        # (its point is aborting wedged streams) and cut short by a second
        # signal. A NORMAL update apply has already drained, so the wait
        # returns immediately there.
        forced = state.update_manager.last_apply_mode == ApplyMode.FORCE
        state.gate.start_rejecting()
        if not forced and not hard_stop.is_set():
            drain = asyncio.ensure_future(state.gate.wait_for_idle(30.0))
            bail = asyncio.ensure_future(hard_stop.wait())
            done, pending = await asyncio.wait(
                {drain, bail}, return_when=asyncio.FIRST_COMPLETED
            )
            for p in pending:
                p.cancel()
            if drain in done and not drain.result():
                log.warning("shutdown drain timeout with %d in flight",
                            state.gate.in_flight)
        await runner.cleanup()


def serve_multi_worker(config: ServerConfig, workers: int) -> int:
    """Supervisor path: hold the instance lock, build the native library
    once (N children racing the compiler would each wait on the build
    lock), fork the workers, and wait. Each child re-inits logging with its
    worker id (the file sink stays primary-only — N
    TimedRotatingFileHandlers would race the midnight rotation) and runs
    the ordinary run_server. Returns the supervisor's exit code."""
    from llmlb_tpu_torch.native import ensure_native_built

    if config.database_url:
        os.makedirs(os.path.dirname(config.database_url) or ".",
                    exist_ok=True)
    ensure_native_built()
    lock = ServerLock.acquire(config.port)
    try:
        def child_main(worker: WorkerInfo) -> int:
            init_logging(file_sink=worker.is_primary)
            maybe_install_uvloop()
            asyncio.run(
                run_server(config, worker=worker, acquire_lock=False)
            )
            return 0

        return run_supervisor(workers, child_main)
    finally:
        lock.release()


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m llmlb_tpu_torch.gateway.server",
        description="OpenAI-compatible gateway in front of the port's "
                    "engines")
    sub = parser.add_subparsers(dest="command")
    serve = sub.add_parser("serve", help="run the gateway")
    serve.add_argument("--host", default=None)
    serve.add_argument("--port", type=int, default=None,
                       help="listen port (0: any free port; the log line "
                            "'listening on HOST:PORT' names it)")
    serve.add_argument(
        "--workers", type=int, default=None,
        help="number of gateway worker processes sharing the port via "
             "SO_REUSEPORT (default LLMLB_WORKERS or 1; more than one "
             "needs a fixed --port)",
    )
    sub.add_parser("status", help="check whether a gateway is running "
                                  "(on LLMLB_PORT)")
    stop = sub.add_parser("stop", help="stop a running gateway")
    stop.add_argument("--port", type=int, default=None)
    assistant = sub.add_parser(
        "assistant", help="API helper: sanitized curl, openapi, guides"
    )
    assistant.add_argument("assistant_args", nargs=argparse.REMAINDER)

    args = parser.parse_args(argv)
    if args.command == "assistant":
        from llmlb_tpu_torch.gateway.assistant import main as assistant_main

        raise SystemExit(assistant_main(args.assistant_args))

    config = ServerConfig.from_env()
    overrides = {}
    if getattr(args, "host", None):
        overrides["host"] = args.host
    if getattr(args, "port", None) is not None:
        overrides["port"] = args.port
    if overrides:
        config = config.__class__(**{**config.__dict__, **overrides})

    if args.command == "status":
        info = ServerLock.status(config.port)
        if info:
            print(f"running: pid={info['pid']} port={info['port']}")
        else:
            print("not running")
        return
    if args.command == "stop":
        print("stopped" if ServerLock.stop(config.port) else "not running")
        return

    workers = worker_count_from_env(getattr(args, "workers", None))
    if workers > 1 and config.port == 0:
        parser.error("--workers > 1 needs a fixed --port: with port 0 each "
                     "worker would listen on an ephemeral port of its own")

    # stderr + daily-rotated file sink (reference logging.rs:41-182)
    init_logging()
    if workers > 1 and not supports_reuse_port():
        log.warning("--workers %d requested but SO_REUSEPORT is "
                    "unavailable on this platform; serving "
                    "single-process", workers)
        workers = 1
    if workers > 1:
        code = serve_multi_worker(config, workers)
        if code:
            raise SystemExit(code)
        return
    # Pin the 1-of-1 identity explicitly (and in the env, which
    # current_worker() and logging read): a lingering LLMLB_WORKERS=4
    # must not make this lone process bind with reuse_port or wait for
    # gossip siblings that will never exist.
    os.environ["LLMLB_WORKERS"] = "1"
    maybe_install_uvloop()
    asyncio.run(run_server(config, worker=WorkerInfo(0, 1)))


if __name__ == "__main__":
    main()
