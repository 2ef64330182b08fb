"""Gateway server entry: bootstrap state, serve, graceful shutdown.

The port's counterpart of llmlb_tpu/gateway/server.py, on the standard
library (gateway/http.py):

    python -m llmlb_tpu_torch.gateway.server serve [--host H] [--port P]
        [--workers N]

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
health checker, maintenance and the rebalancer and keeps the log file. SIGTERM to the
supervisor reaches every worker; each drains, and the supervisor exits 0.
The reference's instance lock, uvloop knob, update manager, tray and
assistant come with later slices.
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
from llmlb_tpu_torch.gateway.config import ServerConfig
from llmlb_tpu_torch.gateway.http import web
from llmlb_tpu_torch.gateway.logging_setup import init_logging
from llmlb_tpu_torch.gateway.worker import (
    WorkerInfo,
    current_worker,
    run_supervisor,
    supports_reuse_port,
    worker_count_from_env,
)

log = logging.getLogger("llmlb_tpu_torch.gateway.server")


async def run_server(config: ServerConfig | None = None, *,
                     worker: WorkerInfo | None = None,
                     ready=None) -> None:
    """Serve until SIGINT/SIGTERM. `ready`, when given, is called with the
    bound (host, port) once the socket listens."""
    config = config or ServerConfig.from_env()
    worker = worker or current_worker()
    if config.database_url:
        os.makedirs(os.path.dirname(config.database_url) or ".",
                    exist_ok=True)

    from llmlb_tpu_torch.native import ensure_native_built

    ensure_native_built()  # blocking build belongs here, not in a request path
    state = await build_app_state(config, worker=worker)
    app = create_app(state)
    stop_event = asyncio.Event()

    # Short shutdown grace: idle keep-alive connections must not delay a
    # restart.
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
        # Drain in-flight inference before tearing the server down, cut
        # short by a second signal.
        state.gate.start_rejecting()
        if not hard_stop.is_set():
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
    """Supervisor path: build the native library once (N children racing
    the compiler would each wait on the build lock), fork the workers, and
    wait. Each child re-inits logging with its worker id (the file sink
    stays primary-only — N TimedRotatingFileHandlers would race the
    midnight rotation) and runs the ordinary run_server. Returns the
    supervisor's exit code."""
    from llmlb_tpu_torch.native import ensure_native_built

    if config.database_url:
        os.makedirs(os.path.dirname(config.database_url) or ".",
                    exist_ok=True)
    ensure_native_built()

    def child_main(worker: WorkerInfo) -> int:
        init_logging(file_sink=worker.is_primary)
        asyncio.run(run_server(config, worker=worker))
        return 0

    return run_supervisor(workers, child_main)


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
    args = parser.parse_args(argv)
    if args.command not in (None, "serve"):
        parser.error(f"unknown command {args.command!r}")

    config = ServerConfig.from_env()
    overrides = {}
    if getattr(args, "host", None):
        overrides["host"] = args.host
    if getattr(args, "port", None) is not None:
        overrides["port"] = args.port
    if overrides:
        config = config.__class__(**{**config.__dict__, **overrides})

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
    asyncio.run(run_server(config, worker=WorkerInfo(0, 1)))


if __name__ == "__main__":
    main()
