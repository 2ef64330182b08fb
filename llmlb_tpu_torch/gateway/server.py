"""Gateway server entry: bootstrap state, serve, graceful shutdown.

The port's counterpart of llmlb_tpu/gateway/server.py at one worker, on the
standard library (gateway/http.py):

    python -m llmlb_tpu_torch.gateway.server serve [--host H] [--port P]

Configuration is the reference's environment (`LLMLB_PORT`,
`LLMLB_DATA_DIR`, `LLMLB_ADMIN_PASSWORD`, ... see config.py); logs go to
stderr and to a daily-rotated file under `LLMLB_LOG_DIR`
(logging_setup.py), which `/api/dashboard/logs/lb` tails. The dashboard is
served at `/dashboard`. SIGINT or SIGTERM drains in-flight inference for
up to 30 s (open dashboard sockets close with 1001 at once), then stops; a
second signal stops at once. The reference's multi-worker supervisor and
gossip, instance lock, update manager, tray and assistant come with later
slices.
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

log = logging.getLogger("llmlb_tpu_torch.gateway.server")


async def run_server(config: ServerConfig | None = None, *,
                     ready=None) -> None:
    """Serve until SIGINT/SIGTERM. `ready`, when given, is called with the
    bound (host, port) once the socket listens."""
    config = config or ServerConfig.from_env()
    if config.database_url:
        os.makedirs(os.path.dirname(config.database_url) or ".",
                    exist_ok=True)
    state = await build_app_state(config)
    app = create_app(state)
    stop_event = asyncio.Event()

    # Short shutdown grace: idle keep-alive connections must not delay a
    # restart.
    runner = web.AppRunner(app, shutdown_timeout=5.0)
    await runner.setup()
    site = web.TCPSite(runner, config.host, config.port)
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
    args = parser.parse_args(argv)

    # stderr + daily-rotated file sink (reference logging.rs:41-182)
    init_logging()

    config = ServerConfig.from_env()
    if args.command not in (None, "serve"):
        parser.error(f"unknown command {args.command!r}")
    overrides = {}
    if getattr(args, "host", None):
        overrides["host"] = args.host
    if getattr(args, "port", None) is not None:
        overrides["port"] = args.port
    if overrides:
        config = config.__class__(**{**config.__dict__, **overrides})
    asyncio.run(run_server(config))


if __name__ == "__main__":
    main()
