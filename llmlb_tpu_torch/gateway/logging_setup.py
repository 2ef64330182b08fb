"""Logging subsystem: stderr + daily-rotated file sink with retention cleanup.

Parity with reference logging.rs:41-182 (tracing-subscriber dual sinks:
stderr layer + daily-rotated non-blocking file layer under ~/.llmlb/logs,
env-filtered, old-file cleanup). Python counterpart: logging with a
TimedRotatingFileHandler under ``log_dir`` (default ``~/.llmlb_tpu/logs``),
level from ``LLMLB_LOG_LEVEL``, and rotated files beyond the retention count
deleted at rollover. The active file path is exposed for the dashboard
log-tail API (reference api/logs.rs:52).

The port's copy of llmlb_tpu/gateway/logging_setup.py: the same
environment (`LLMLB_LOG_DIR`, `LLMLB_LOG_LEVEL`, `LLMLB_LOG_RETENTION`,
`LLMLB_LOG_FORMAT`), the same default directory and file name, and the
`worker` field (`LLMLB_WORKER_INDEX`, set in each forked worker; 0 at one
worker). The port's gateway installs it with its file sink (in the primary
worker alone under `--workers N`), the port's engine server without.
"""

from __future__ import annotations

import logging
import logging.handlers
import os

LOG_FILENAME = "llmlb.log"
DEFAULT_RETENTION = 14  # rotated files kept, parity with cleanup loop

# Every line carries the worker id (``w0`` .. ``wN-1``): with --workers N
# the processes' stderr interleaves on one console, and an untagged line
# from worker 3 is indistinguishable from worker 0's. Override with
# LLMLB_LOG_FORMAT (standard logging %-format; the extra field is
# ``%(worker)s``). Documented in docs/configuration.md.
DEFAULT_LOG_FORMAT = (
    "%(asctime)s %(levelname)-7s w%(worker)s %(name)s: %(message)s"
)

_active_log_path: str | None = None
_factory_installed = False


def _install_worker_field() -> None:
    """Stamp every LogRecord with this process's worker index via the
    record factory (handler filters would miss records emitted before the
    handlers exist, and third-party handlers added later)."""
    global _factory_installed
    if _factory_installed:
        return
    _factory_installed = True
    old_factory = logging.getLogRecordFactory()

    def factory(*args, **kwargs):
        record = old_factory(*args, **kwargs)
        if not hasattr(record, "worker"):
            record.worker = os.environ.get("LLMLB_WORKER_INDEX", "0")
        return record

    logging.setLogRecordFactory(factory)


def default_log_dir() -> str:
    return os.environ.get(
        "LLMLB_LOG_DIR",
        os.path.join(os.path.expanduser("~"), ".llmlb_tpu", "logs"),
    )


def active_log_path() -> str | None:
    """Path of the live log file, or None when file logging is disabled."""
    return _active_log_path


def init_logging(
    log_dir: str | None = None,
    *,
    level: str | None = None,
    retention: int | None = None,
    file_sink: bool = True,
) -> str | None:
    """Install stderr + rotating-file handlers on the root logger.

    Returns the active log file path (None if the file sink is disabled or
    the directory can't be created). Idempotent: re-running replaces the
    handlers rather than stacking duplicates.
    """
    global _active_log_path

    level_name = (level or os.environ.get("LLMLB_LOG_LEVEL") or "INFO").upper()
    log_level = getattr(logging, level_name, logging.INFO)
    retention = retention if retention is not None else int(
        os.environ.get("LLMLB_LOG_RETENTION", DEFAULT_RETENTION)
    )

    _install_worker_field()
    root = logging.getLogger()
    root.setLevel(log_level)
    fmt = logging.Formatter(
        os.environ.get("LLMLB_LOG_FORMAT") or DEFAULT_LOG_FORMAT
    )

    for h in list(root.handlers):
        if getattr(h, "_llmlb_sink", False):
            root.removeHandler(h)
            try:
                h.close()
            except Exception:  # allow-silent: closing a dead log sink
                pass

    stderr = logging.StreamHandler()
    stderr.setFormatter(fmt)
    stderr._llmlb_sink = True
    root.addHandler(stderr)

    _active_log_path = None
    if file_sink:
        directory = log_dir or default_log_dir()
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(directory, LOG_FILENAME)
            fileh = logging.handlers.TimedRotatingFileHandler(
                path, when="midnight", backupCount=retention, utc=True,
                delay=True,
            )
            fileh.setFormatter(fmt)
            fileh._llmlb_sink = True
            root.addHandler(fileh)
            _active_log_path = path
        except OSError as e:
            root.warning("file log sink disabled: %s", e)
    return _active_log_path


def tail_log(lines: int = 200, path: str | None = None) -> list[str]:
    """Last N lines of the active log file (log-tail API, api/logs.rs:52-73).
    Reads a bounded window from the end so huge files stay cheap."""
    p = path or _active_log_path
    if not p or not os.path.isfile(p):
        return []
    lines = max(1, min(lines, 5000))
    window = 256 * 1024
    with open(p, "rb") as f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        f.seek(max(0, size - window))
        chunk = f.read()
    text = chunk.decode("utf-8", "replace")
    out = text.splitlines()
    if size > window and out:
        out = out[1:]  # first line may be torn by the window cut
    return out[-lines:]
