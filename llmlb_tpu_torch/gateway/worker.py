"""Multi-worker serving: shared-nothing gateway processes on one port.

The port's copy of llmlb_tpu/gateway/worker.py. The gateway imports no
torch, so a forked worker never inherits a CUDA context it could not use.

The reference router is a single Rust process that clears ~170k req/s; a
CPython gateway is GIL-bound near 1-2k req/s per process, so horizontal
scale on one host comes from N processes sharing the listen port via
SO_REUSEPORT (the kernel load-balances accepted connections across the
workers' accept queues). Each worker is shared-nothing: its own event loop,
LoadManager, breaker set, SQLite connection, and HTTP client. The small
mutable routing state replicates best-effort over the gossip bus
(gateway/gossip.py); correctness never depends on it.

Single-writer discipline for the things that must not run N times:
  * the pull health checker probes from exactly one elected worker
    (the primary, index 0) — otherwise N workers multiply probe load
    on every engine;
  * the hourly maintenance loop (history retention, audit verify) runs on
    the primary only, as do the update manager's background checks, the
    tray and the post-restart health watch (server.py);
  * SQLite stays safe for the remaining cross-worker writes (request
    history, daily stats, audit batches) via WAL + busy_timeout and an
    atomic audit flush transaction (db.py / audit.py).

The supervisor (`run_supervisor`) forks N children and babysits them:
signals forward to the children, and the first unexpected child death
tears the group down (a supervisor like systemd restarts the whole unit —
per-worker respawn would silently mask crash loops).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import sys

log = logging.getLogger("llmlb_tpu_torch.gateway.worker")

# Set by the supervisor in each forked child; single-process serving leaves
# them unset and current_worker() reports the 1-of-1 identity.
WORKER_INDEX_ENV = "LLMLB_WORKER_INDEX"
WORKER_COUNT_ENV = "LLMLB_WORKERS"


@dataclasses.dataclass(frozen=True)
class WorkerInfo:
    """This process's place in the worker group."""

    index: int = 0
    count: int = 1

    @property
    def is_primary(self) -> bool:
        """The elected worker: health checker, maintenance, updates."""
        return self.index == 0

    @property
    def multi(self) -> bool:
        return self.count > 1

    @property
    def label(self) -> str:
        return str(self.index)


def current_worker() -> WorkerInfo:
    """Worker identity from the environment (the supervisor sets it in each
    child); a plain single-process gateway is worker 0 of 1."""
    try:
        count = max(1, int(os.environ.get(WORKER_COUNT_ENV, "1")))
    except ValueError:
        count = 1
    try:
        index = int(os.environ.get(WORKER_INDEX_ENV, "0"))
    except ValueError:
        index = 0
    return WorkerInfo(index=max(0, min(index, count - 1)), count=count)


def worker_count_from_env(cli_value: int | None = None) -> int:
    """Resolve --workers / LLMLB_WORKERS (CLI wins); 0/absent means 1."""
    if cli_value is not None and cli_value > 0:
        return cli_value
    try:
        return max(1, int(os.environ.get(WORKER_COUNT_ENV, "1") or "1"))
    except ValueError:
        return 1


def run_supervisor(workers: int, child_main) -> int:
    """Fork `workers` children, each running ``child_main(WorkerInfo)``;
    forward SIGTERM/SIGINT; tear the group down when any child exits.
    Returns the exit code for the supervisor process. POSIX-only (fork +
    SO_REUSEPORT are both POSIX facilities; on platforms without them the
    caller runs single-process)."""
    pids: list[int] = []
    for i in range(workers):
        pid = os.fork()
        if pid == 0:
            # Child: die with the supervisor. Without PDEATHSIG, a
            # SIGKILLed (or crashed) supervisor leaves N orphan workers
            # holding the port forever — observed in practice.
            try:
                import ctypes

                libc = ctypes.CDLL(None, use_errno=True)
                libc.prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
            except (OSError, AttributeError):
                pass
            # Stamp identity into the env so every layer (logging,
            # metrics labels, gossip socket name) can read it without
            # plumbing the WorkerInfo through call sites that predate
            # multi-worker serving.
            os.environ[WORKER_INDEX_ENV] = str(i)
            os.environ[WORKER_COUNT_ENV] = str(workers)
            try:
                code = child_main(WorkerInfo(index=i, count=workers))
            except KeyboardInterrupt:
                code = 0
            except BaseException:  # a child must never unwind into the
                log.exception("worker %d crashed", i)  # supervisor's stack
                code = 1
            # never return into the supervisor's stack
            os._exit(code or 0)
        pids.append(pid)

    shutting_down = False

    def forward(signum, _frame):
        nonlocal shutting_down
        shutting_down = True
        for pid in pids:
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        old[sig] = signal.signal(sig, forward)

    log.info("supervisor: %d workers forked (pids %s)", workers, pids)
    exit_code = 0
    live = set(pids)
    try:
        while live:
            try:
                pid, status = os.wait()
            except InterruptedError:
                continue
            except ChildProcessError:
                break
            if pid not in live:
                continue
            live.discard(pid)
            code = os.waitstatus_to_exitcode(status)
            if code != 0:
                exit_code = exit_code or (code if code > 0 else 1)
            if live and not shutting_down:
                # one worker died on its own: take the group down rather
                # than limp along with silently reduced capacity
                log.warning(
                    "worker pid %d exited %s; stopping the group", pid, code
                )
                shutting_down = True
                for p in live:
                    try:
                        os.kill(p, signal.SIGTERM)
                    except ProcessLookupError:
                        pass
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
    return exit_code


def supports_reuse_port() -> bool:
    import socket

    return hasattr(socket, "SO_REUSEPORT") and sys.platform != "win32"
