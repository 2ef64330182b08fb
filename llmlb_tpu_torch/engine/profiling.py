"""On-demand torch.profiler capture of a live engine.

Counterpart of `llmlb_tpu/engine/profiling.py` (jax.profiler there): an
operator answers "where do my step milliseconds go" below the step-phase
records' resolution (each kernel, copy and host op on one timeline)
without restarting the serving process.

One ProfileManager per engine guards the profiler: start -> bounded
auto-stop timer -> a downloadable zip of the capture's directory, which
holds `trace.json` (Chrome trace format: chrome://tracing or Perfetto).
Captures are opt-in per request and stop themselves at their bounded
duration even if the client never calls stop.

The profiler starts and stops on the engine's step loop, between two
iterations (`run_in_loop`, the core's `call_in_loop`): starting it while
a CUDA graph is being captured would break the capture, and the
profiler's CPU-op callbacks may be per thread. The trace's export and the
zip run on the caller's thread (the auto-stop timer or an HTTP handler),
off the loop. A capture of the card lists CPU ops and CUDA kernels
(`ProfilerActivity.CUDA`); on the CPU, CPU ops only.

Gating: the engine port is unauthenticated by design (it sits behind the
gateway), so capture access is controlled by LLMLB_PROFILE_TOKEN; when
set, every profile route requires `Authorization: Bearer <token>`.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
import threading
import time
import uuid
import zipfile
from typing import Callable

log = logging.getLogger("llmlb_tpu_torch.engine.profiling")

MAX_CAPTURE_S = 60.0  # the profiler buffers in RAM; bound it hard
MAX_KEPT_CAPTURES = 4  # older trace dirs are deleted as new ones land
TRACE_FILE = "trace.json"


class ProfileError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ProfileManager:
    """Start/stop lifecycle around one torch.profiler.profile plus a small
    ledger of completed captures for artifact download. `cuda` adds the
    CUDA activity (the card's kernels); `run_in_loop(fn)` runs `fn` on the
    engine's step loop and returns its result (inline by default)."""

    def __init__(self, trace_root: str | None = None, *, cuda: bool = False,
                 run_in_loop: Callable | None = None):
        self._lock = threading.Lock()
        self._active: dict | None = None
        self._profiler = None
        self._timer: threading.Timer | None = None
        self._captures: list[dict] = []  # completed, newest last
        self._root_override = trace_root
        self._cuda = cuda
        self._run_in_loop = run_in_loop or (lambda fn: fn())
        # set while no capture runs: wait_idle() parks on it
        self._idle = threading.Event()
        self._idle.set()

    # ---------------------------------------------------------------- control

    def _new_profiler(self):
        import torch.profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if self._cuda:
            acts.append(tp.ProfilerActivity.CUDA)
        return tp.profile(activities=acts)

    def start(self, seconds: float) -> dict:
        """Begin a capture with a bounded auto-stop. Raises ProfileError 409
        if one is already running."""
        seconds = min(MAX_CAPTURE_S, max(0.1, float(seconds)))
        # traces land under a server-controlled root (resolved per capture,
        # so LLMLB_TRACE_DIR set after start-up is honored): a
        # client-supplied path would be a directory-write primitive
        root = (self._root_override or os.environ.get("LLMLB_TRACE_DIR")
                or tempfile.gettempdir())
        with self._lock:
            # a capture still writing its trace counts as running: the
            # profiler it stops is the one a new start would enable
            if self._active is not None or not self._idle.is_set():
                raise ProfileError(409, "a profile capture is already running")
            os.makedirs(root, exist_ok=True)
            out_dir = tempfile.mkdtemp(prefix="llmlb-trace-", dir=root)
            try:
                prof = self._new_profiler()
                self._run_in_loop(prof.start)
            except Exception as e:
                shutil.rmtree(out_dir, ignore_errors=True)
                raise ProfileError(500, f"profiler failed to start: {e}")
            capture = {
                "capture_id": uuid.uuid4().hex[:12],
                "trace_dir": out_dir,
                "started_at": time.time(),
                "seconds_requested": seconds,
            }
            self._active = capture
            self._profiler = prof
            self._idle.clear()
            self._timer = threading.Timer(seconds, self._auto_stop,
                                          args=(capture["capture_id"],))
            self._timer.daemon = True
            self._timer.start()
        log.info("profile capture %s started (%.1fs max) -> %s",
                 capture["capture_id"], seconds, out_dir)
        return {"capture_id": capture["capture_id"], "seconds": seconds,
                "trace_dir": out_dir}

    def stop(self) -> dict:
        """Stop the running capture early. Raises ProfileError 409 when
        nothing is recording."""
        done = self._finish(expected_id=None)
        if done is None:
            raise ProfileError(409, "no profile capture is running")
        return done

    def _auto_stop(self, capture_id: str) -> None:
        try:
            self._finish(expected_id=capture_id)
        except Exception:  # boundary: the timer thread has no caller
            log.exception("profile auto-stop failed")

    def _finish(self, expected_id: str | None) -> dict | None:
        # claim the capture under the lock; stop the profiler on the loop
        # and write the trace outside the lock, so status() and start()
        # never wait behind the export
        with self._lock:
            active = self._active
            if active is None:
                return None
            if expected_id is not None and active["capture_id"] != expected_id:
                return None  # an explicit stop already closed this capture
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            prof, self._profiler = self._profiler, None
            self._active = None
        try:
            self._run_in_loop(prof.stop)
            prof.export_chrome_trace(
                os.path.join(active["trace_dir"], TRACE_FILE))
        except Exception as e:
            log.exception("profiler stop failed")
            active["error"] = f"stop failed: {e}"
        active["stopped_at"] = time.time()
        active["duration_s"] = round(
            active["stopped_at"] - active["started_at"], 3)
        active["bytes"] = _dir_bytes(active["trace_dir"])
        with self._lock:
            self._captures.append(active)
            evicted = []
            while len(self._captures) > MAX_KEPT_CAPTURES:
                evicted.append(self._captures.pop(0))
            # idle only once the capture is on the ledger: a waiter that
            # wakes finds its trace written
            self._idle.set()
        for stale in evicted:
            shutil.rmtree(stale["trace_dir"], ignore_errors=True)
            try:
                os.unlink(stale["trace_dir"].rstrip("/") + ".zip")
            except OSError:
                pass
        log.info("profile capture %s stopped after %.2fs (%d bytes)",
                 active["capture_id"], active["duration_s"], active["bytes"])
        return self._public(active)

    # ---------------------------------------------------------------- reading

    @staticmethod
    def _public(capture: dict) -> dict:
        out = dict(capture)
        out["download"] = f"/api/profile/{capture['capture_id']}"
        return out

    def wait_idle(self, timeout_s: float) -> bool:
        """Block until the running capture finishes (its trace written);
        True when idle, False when the timeout passed first."""
        return self._idle.wait(timeout_s)

    def status(self) -> dict:
        with self._lock:
            active = dict(self._active) if self._active else None
            captures = [self._public(c) for c in reversed(self._captures)]
        if active is not None:
            active["elapsed_s"] = round(time.time() - active["started_at"], 2)
        return {"recording": active is not None, "active": active,
                "captures": captures}

    def artifact(self, capture_id: str) -> tuple[str, str]:
        """(zip path, download filename) of a completed capture's trace
        directory, built on disk beside it (a trace of the card runs to
        hundreds of MB) and cached for repeat downloads."""
        with self._lock:
            capture = next((c for c in self._captures
                            if c["capture_id"] == capture_id), None)
        if capture is None:
            raise ProfileError(404, f"no completed capture {capture_id!r}")
        root = capture["trace_dir"].rstrip("/")
        zip_path = root + ".zip"
        filename = f"llmlb-trace-{capture_id}.zip"
        if os.path.isfile(zip_path):
            return zip_path, filename
        # a temp name then a rename: a concurrent download never sees a
        # half-written zip
        tmp_path = zip_path + ".tmp"
        try:
            names = 0
            with zipfile.ZipFile(tmp_path, "w", zipfile.ZIP_DEFLATED) as zf:
                for dirpath, _dirs, files in os.walk(root):
                    for name in files:
                        full = os.path.join(dirpath, name)
                        zf.write(full, os.path.relpath(full, root))
                        names += 1
            if names == 0:
                raise ProfileError(500, "capture produced no trace files")
            os.replace(tmp_path, zip_path)
        except OSError as e:
            # an eviction may remove this capture's dir while we walk it
            try:
                os.unlink(tmp_path)
            except OSError:
                pass
            raise ProfileError(
                404, f"capture {capture_id!r} no longer on disk: {e}")
        return zip_path, filename


def _dir_bytes(root: str) -> int:
    total = 0
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                pass
    return total
