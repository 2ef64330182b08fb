"""ctypes bindings to the gateway's C++ native core.

The port's copy of llmlb_tpu/native/__init__.py, minus the safetensors
reader (the port loads checkpoints with engine/safetensors_io.py). Three
sources in this directory make one library:

- ``router_core.cpp``: the LoadManager's scheduler state (TPS EMA map,
  active counts, round-robin selection, the rendezvous-hash owner, a
  constant-time compare);
- ``sse_scan.cpp``: the SSE frame scanner of the token accounting;
- ``hash_chain.cpp``: SHA-256 and the audit log's batch chain.

The library is built with ``g++ -O2 -std=c++17 -fPIC -shared`` (the
reference Makefile's flags) into ``llmlb_tpu_torch/_build/``, named by a
hash of the sources and flags, so an unchanged tree reuses it and a changed
one rebuilds. ``ensure_native_built()`` builds it (blocking: call it at
process start, never in a request path); several processes building at once
take a file lock, and the library appears under its name in one rename.
``load_native()`` only loads what is built. Every consumer keeps its Python
twin as the fallback, as in the reference (``LLMLB_NATIVE_ROUTER=0`` picks
the router's).
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

log = logging.getLogger("llmlb_tpu_torch.native")

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"
SOURCES = ("hash_chain.cpp", "sse_scan.cpp", "router_core.cpp")
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")

_lib: ctypes.CDLL | None = None
_lib_lock = threading.Lock()
_build_attempted = False
# Filled by ensure_native_built(): the library's path, seconds spent,
# whether it was already built, the compiler.
BUILD_INFO: dict = {}


def _compiler() -> str | None:
    return shutil.which(os.environ.get("CXX") or "g++")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    """Where the library of the current sources lives (built or not)."""
    return BUILD_DIR / f"libllmlb_native_{_source_hash()}.so"


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.sha256_hex.restype = None
    lib.sha256_hex.argtypes = [c.c_char_p, c.c_int64, c.c_char_p]
    lib.chain_hash_hex.restype = None
    lib.chain_hash_hex.argtypes = [
        c.c_char_p, c.POINTER(c.c_char_p), c.POINTER(c.c_int64), c.c_int64,
        c.c_char_p,
    ]

    lib.rc_new.restype = c.c_void_p
    lib.rc_new.argtypes = [c.c_double]
    lib.rc_free.restype = None
    lib.rc_free.argtypes = [c.c_void_p]
    lib.rc_update_tps.restype = None
    lib.rc_update_tps.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_char_p,
        c.c_int64, c.c_double, c.c_double,
    ]
    lib.rc_seed_tps.restype = None
    lib.rc_seed_tps.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_char_p,
        c.c_double, c.c_int64, c.c_double,
    ]
    lib.rc_get_tps.restype = c.c_double
    lib.rc_get_tps.argtypes = [c.c_void_p, c.c_char_p, c.c_char_p, c.c_char_p]
    lib.rc_tps_info.restype = c.c_int32
    lib.rc_tps_info.argtypes = [
        c.c_void_p, c.c_char_p, c.c_char_p, c.c_char_p,
        c.POINTER(c.c_double), c.POINTER(c.c_int64), c.POINTER(c.c_double),
    ]
    lib.rc_clear_endpoint.restype = None
    lib.rc_clear_endpoint.argtypes = [c.c_void_p, c.c_char_p]
    lib.rc_tracked_keys.restype = c.c_int64
    lib.rc_tracked_keys.argtypes = [c.c_void_p]
    lib.rc_begin.restype = None
    lib.rc_begin.argtypes = [c.c_void_p, c.c_char_p]
    lib.rc_release.restype = None
    lib.rc_release.argtypes = [c.c_void_p, c.c_char_p]
    lib.rc_active.restype = c.c_int64
    lib.rc_active.argtypes = [c.c_void_p, c.c_char_p]
    lib.rc_total_active.restype = c.c_int64
    lib.rc_total_active.argtypes = [c.c_void_p]
    lib.rc_total_requests.restype = c.c_int64
    lib.rc_total_requests.argtypes = [c.c_void_p]
    lib.rc_select.restype = c.c_int64
    lib.rc_select.argtypes = [
        c.c_void_p, c.c_char_p, c.POINTER(c.c_char_p),
        c.POINTER(c.c_double), c.c_int64, c.c_int64, c.c_char_p, c.c_int,
    ]
    lib.rc_snapshot.restype = c.c_int64
    lib.rc_snapshot.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.hrw_select.restype = c.c_int64
    lib.hrw_select.argtypes = [c.c_char_p, c.POINTER(c.c_char_p), c.c_int64]
    lib.ct_equal.restype = c.c_int32
    lib.ct_equal.argtypes = [c.c_char_p, c.c_int64, c.c_char_p, c.c_int64]

    lib.sse_new.restype = c.c_void_p
    lib.sse_feed.restype = None
    lib.sse_feed.argtypes = [c.c_void_p, c.c_char_p, c.c_int64]
    lib.sse_frames.restype = c.c_int64
    lib.sse_frames.argtypes = [c.c_void_p]
    lib.sse_usage.restype = c.c_int32
    lib.sse_usage.argtypes = [
        c.c_void_p, c.POINTER(c.c_int64), c.POINTER(c.c_int64)
    ]
    lib.sse_free.restype = None
    lib.sse_free.argtypes = [c.c_void_p]


def _build(path: Path) -> None:
    """Compile the sources into `path`, under a lock shared with every
    other process building into the same directory; a temporary name and
    one rename, so a loader never sees half a file."""
    cxx = _compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++ or $CXX) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.is_file():  # another process built it while we waited
            BUILD_INFO.update(cached=True, seconds=0.0)
            return
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        run = subprocess.run(
            [cxx, *CXXFLAGS, "-o", str(tmp),
             *(str(NATIVE_DIR / name) for name in SOURCES)],
            capture_output=True, text=True, timeout=300,
        )
        if run.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native build failed:\n{run.stdout}"
                               f"{run.stderr}")
        tmp.replace(path)
        BUILD_INFO.update(cached=False, seconds=time.perf_counter() - t0,
                          cxx=cxx)


def ensure_native_built() -> bool:
    """Build the library if missing. BLOCKING (runs the compiler): call this
    from process startup (server mains, test setup), never from a request
    path. False (and a log line) when it cannot be built."""
    global _build_attempted
    path = lib_path()
    with _lib_lock:
        if _build_attempted:
            return path.is_file()
        _build_attempted = True
        BUILD_INFO["path"] = str(path)
        if path.is_file():
            BUILD_INFO.setdefault("cached", True)
            BUILD_INFO.setdefault("seconds", 0.0)
            return True
        try:
            _build(path)
        except Exception as e:
            log.info("native build unavailable (%s); using Python fallbacks",
                     e)
    return path.is_file()


def load_native() -> ctypes.CDLL | None:
    """Load the already-built native library; None if unavailable. Does NOT
    build: ensure_native_built() does that at process startup."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = lib_path()
        if not path.is_file():
            return None
        try:
            lib = ctypes.CDLL(str(path))
            _configure(lib)
            _lib = lib
        except (OSError, AttributeError) as e:
            log.warning("failed to load native library: %s", e)
            return None
        return _lib


# ----------------------------------------------------------------- hash chain


def native_chain_hash(prev_hash_hex: str, entries: list[bytes]) -> str | None:
    lib = load_native()
    if lib is None:
        return None
    n = len(entries)
    arr = (ctypes.c_char_p * n)(*entries)
    lens = (ctypes.c_int64 * n)(*[len(e) for e in entries])
    out = ctypes.create_string_buffer(65)
    lib.chain_hash_hex(prev_hash_hex.encode(), arr, lens, n, out)
    return out.value.decode()


# ------------------------------------------------------------------ SSE scan


class NativeSseScanner:
    def __init__(self):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._handle = lib.sse_new()

    def feed(self, chunk: bytes) -> None:
        self._lib.sse_feed(self._handle, chunk, len(chunk))

    @property
    def frames(self) -> int:
        return self._lib.sse_frames(self._handle)

    def usage(self) -> tuple[int, int] | None:
        pt = ctypes.c_int64()
        ct = ctypes.c_int64()
        if self._lib.sse_usage(self._handle, ctypes.byref(pt), ctypes.byref(ct)):
            return int(pt.value), int(ct.value)
        return None

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.sse_free(self._handle)
            self._handle = None


# ------------------------------------------------- hot-path micro primitives


def native_hrw_available() -> bool:
    return load_native() is not None


def native_hrw_select(key: str, endpoint_ids: list[str]) -> int:
    """Index of the consistent-hash (rendezvous) owner of `key` among
    `endpoint_ids`; -1 for an empty list. Bit-identical to
    balancer.hrw_owner."""
    lib = load_native()
    n = len(endpoint_ids)
    if lib is None or n == 0:
        return -1
    arr = (ctypes.c_char_p * n)(*[e.encode() for e in endpoint_ids])
    return lib.hrw_select(key.encode(), arr, n)


def native_ct_equal(a: bytes, b: bytes) -> bool | None:
    """Constant-time byte equality in compiled code; None when the native
    library is unavailable (callers fall back to hmac.compare_digest)."""
    lib = load_native()
    if lib is None:
        return None
    return bool(lib.ct_equal(a, len(a), b, len(b)))


# ---------------------------------------------------------------- router core


class NativeRouterCore:
    """C++ scheduler state: TPS-EMA map + active counts + round-robin
    selection (router_core.cpp). Raises RuntimeError when the library is
    unavailable; LoadManager keeps the pure-Python implementation as the
    fallback."""

    def __init__(self, alpha: float):
        lib = load_native()
        if lib is None:
            raise RuntimeError("native router core unavailable")
        self._lib = lib
        self._handle = lib.rc_new(alpha)

    def update_tps(self, eid: str, model: str, kind: str,
                   tokens: int, duration_s: float, now: float) -> None:
        self._lib.rc_update_tps(
            self._handle, eid.encode(), model.encode(), kind.encode(),
            tokens, duration_s, now,
        )

    def seed_tps(self, eid: str, model: str, kind: str,
                 ema: float, samples: int, now: float) -> None:
        self._lib.rc_seed_tps(
            self._handle, eid.encode(), model.encode(), kind.encode(),
            ema, samples, now,
        )

    def get_tps(self, eid: str, model: str, kind: str) -> float | None:
        v = self._lib.rc_get_tps(
            self._handle, eid.encode(), model.encode(), kind.encode()
        )
        return None if v < 0 else v

    def tps_info(self, eid: str, model: str,
                 kind: str) -> tuple[float, int, float] | None:
        """(ema, samples, last_update) or None when unmeasured: feeds the
        cross-worker TPS gossip (publish + last-writer-wins compare)."""
        ema = ctypes.c_double()
        samples = ctypes.c_int64()
        last = ctypes.c_double()
        got = self._lib.rc_tps_info(
            self._handle, eid.encode(), model.encode(), kind.encode(),
            ctypes.byref(ema), ctypes.byref(samples), ctypes.byref(last),
        )
        if not got:
            return None
        return float(ema.value), int(samples.value), float(last.value)

    def clear_endpoint(self, eid: str) -> None:
        self._lib.rc_clear_endpoint(self._handle, eid.encode())

    def tracked_keys(self) -> int:
        return self._lib.rc_tracked_keys(self._handle)

    def begin(self, eid: str) -> None:
        self._lib.rc_begin(self._handle, eid.encode())

    def release(self, eid: str) -> None:
        self._lib.rc_release(self._handle, eid.encode())

    def active(self, eid: str) -> int:
        return self._lib.rc_active(self._handle, eid.encode())

    def total_active(self) -> int:
        return self._lib.rc_total_active(self._handle)

    def total_requests(self) -> int:
        return self._lib.rc_total_requests(self._handle)

    def select(self, model: str, kind: str, eids: list[str],
               penalties: list[float], cap: int, admit: bool) -> int:
        n = len(eids)
        arr = (ctypes.c_char_p * n)(*[e.encode() for e in eids])
        pens = (ctypes.c_double * n)(*penalties)
        return self._lib.rc_select(
            self._handle, model.encode(), arr, pens, n, cap,
            kind.encode(), 1 if admit else 0,
        )

    def snapshot(self) -> dict[str, dict]:
        # Size-then-fill with a growth retry: the map can gain keys between
        # the two calls (another thread's update_tps), in which case the fill
        # call reports a larger size and we re-read; never parse a truncated
        # buffer.
        needed = self._lib.rc_snapshot(self._handle, None, 0)
        while True:
            if needed <= 0:
                return {}
            cap = needed + 4096  # slack for keys added between calls
            buf = ctypes.create_string_buffer(cap)
            needed = self._lib.rc_snapshot(self._handle, buf, cap)
            if needed <= cap:
                break
        out: dict[str, dict] = {}
        for line in buf.raw[:needed].decode().splitlines():
            eid, model, kind, ema, samples, last_update = line.split("\t")
            out[f"{eid}:{model}:{kind}"] = {
                "ema_tps": round(float(ema), 3),
                "samples": int(samples),
                "last_update": float(last_update),
            }
        return out

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rc_free(self._handle)
            self._handle = None
