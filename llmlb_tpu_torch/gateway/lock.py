"""Single-instance lockfile per port, with stale-PID detection.

The port's copy of llmlb_tpu/gateway/lock.py. Parity with reference
lock/mod.rs (acquire :298, stale detection via is_process_running :225,
stop-by-PID :262-380). The path (`$LLMLB_DATA_DIR/llmlb-<port>.lock`) and
the JSON format are the JAX package's, so a JAX gateway and a port gateway
on one port and one data directory refuse each other. The port is the
configured one: every `--port 0` gateway on one data directory shares
`llmlb-0.lock`, and a second one is refused.
"""

from __future__ import annotations

import json
import os
import signal
import time


def _lock_dir() -> str:
    d = os.path.expanduser(os.environ.get("LLMLB_DATA_DIR", "~/.llmlb"))
    os.makedirs(d, exist_ok=True)
    return d


def _lock_path(port: int) -> str:
    return os.path.join(_lock_dir(), f"llmlb-{port}.lock")


def _pid_running(pid: int) -> bool:
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True


class ServerLock:
    def __init__(self, port: int, path: str):
        self.port = port
        self.path = path

    @classmethod
    def acquire(cls, port: int) -> "ServerLock":
        path = _lock_path(port)
        if os.path.exists(path):
            try:
                with open(path) as f:
                    info = json.load(f)
                if _pid_running(int(info.get("pid", -1))):
                    raise RuntimeError(
                        f"another llmlb instance (pid {info['pid']}) already "
                        f"holds port {port}"
                    )
            except (ValueError, OSError):
                pass  # stale/corrupt lockfile: fall through and replace
        with open(path, "w") as f:
            json.dump({"pid": os.getpid(), "port": port, "ts": time.time()}, f)
        return cls(port, path)

    def release(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass

    @staticmethod
    def status(port: int) -> dict | None:
        path = _lock_path(port)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                info = json.load(f)
        except (ValueError, OSError):
            return None
        if not _pid_running(int(info.get("pid", -1))):
            return None
        return info

    @staticmethod
    def stop(port: int) -> bool:
        info = ServerLock.status(port)
        if info is None:
            return False
        try:
            os.kill(int(info["pid"]), signal.SIGTERM)
            return True
        except (ProcessLookupError, PermissionError):
            return False
