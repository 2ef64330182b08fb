"""Compile `llmlb_tpu_torch/csrc/*.cu` with nvcc and load them with ctypes.

The kernels are built on first use, from the sources in the package and
nothing else: one `nvcc -c` per source, all started together, then one link
into a shared library with a plain C interface. The library lands in
`llmlb_tpu_torch/_build/` (listed in .gitignore), named by a hash of the
sources and flags, so an unchanged tree reuses it and a changed one rebuilds.

Loading uses ctypes: every pointer and the CUDA stream pass as
`ctypes.c_void_p`, every int as `ctypes.c_int`, the scale as
`ctypes.c_float`; each entry point returns a cudaError_t. A missing compiler
or a failed build raises — there is no fallback.

`launch` calls an entry point on the current stream, raises if the launch
was refused, and adds one to `LAUNCHES[name]`: the count of every kernel of
the port since the last `reset_launch_counts()`. Only a CUDA launch adds to
it; the plain versions do not. Under CUDA graph capture `launch` records the
kernel into the graph instead of running it, and a replay runs no wrapper:
the decode graphs (`engine/decode_graph.py`) take a capture's counts back
out with `add_launches(..., times=-1)` and add them again on every replay.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("flash_prefill.cu", "paged_decode.cu", "paged_extend.cu",
           "paged_decode_quant.cu", "paged_extend_quant.cu", "flash_decode.cu",
           "flash_extend.cu", "lora_bgmv.cu")
HEADERS = ("attention_common.cuh", "attention_tc.cuh",
           "attention_decode.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # q, k, v, prompt_lens, out, B, T, H, K, D, scale, dtype, stream
    "llmlb_flash_prefill": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k_pages, v_pages, tables, kv_lens, out, part (fp32 split scratch),
    # B, H, K, D, PS, PPN, pages, splits, scale, dtype, stream
    "llmlb_paged_flash_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _I, _F, _I, _P],
    # q, k_pages, v_pages, tables, start_pos, chunk_lens, out, B, T, H, K, D,
    # PS, PPN, scale, dtype, stream
    "llmlb_paged_flash_extend": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _I, _P],
    # q, k_codes, k_scales, v_codes, v_scales, tables, kv_lens, out, part
    # (fp32 split scratch), B, H, K, D, PS, PPN, pages, splits, scale, dtype,
    # stream
    "llmlb_paged_flash_decode_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k_codes, k_scales, v_codes, v_scales, tables, start_pos, chunk_lens,
    # out, B, T, H, K, D, PS, PPN, scale, dtype, stream
    "llmlb_paged_flash_extend_quant": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                       _I, _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k_cache, v_cache, kv_lens, out, part (fp32 split scratch), B, H, K,
    # D, S, sweep, splits, scale, dtype, stream
    "llmlb_flash_decode": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _F, _I, _P],
    # q, k_cache, v_cache, start_pos, chunk_lens, out, B, T, H, K, D, S,
    # scale, dtype, stream
    "llmlb_flash_extend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                           _I, _P],
    # x, a, b, idx, out (fp32 delta, mode a) or y (the projection's output,
    # added into in place, mode b), B, T, IN, R, OUT, cluster, dtype, stream
    "llmlb_lora_bgmv": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _P],
}

# Kernel launches since the last reset, by kernel name.
LAUNCHES: dict[str, int] = {
    "flash_prefill": 0,
    "paged_flash_decode": 0,
    "paged_flash_extend": 0,
    "paged_flash_decode_quant": 0,
    "paged_flash_extend_quant": 0,
    "flash_decode": 0,
    "flash_extend": 0,
    "lora_delta": 0,
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# Filled by build(): seconds spent, and nvcc's -Xptxas -v report per source.
BUILD_INFO: dict = {}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    nvcc on PATH."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built on this host"
        )
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels (or reuse an up-to-date build); returns the path
    of the shared library. Raises RuntimeError with nvcc's output on
    failure."""
    lib_path = BUILD_DIR / f"libllmlb_attention_{_source_hash()}.so"
    if lib_path.is_file():
        BUILD_INFO.setdefault("seconds", 0.0)
        BUILD_INFO.setdefault("cached", True)
        return lib_path
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = BUILD_DIR / (Path(name).stem + f"_{os.getpid()}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
               str(CSRC_DIR / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    reports, failures = {}, []
    for name, _obj, proc in procs:
        out, err = proc.communicate()
        reports[name] = (out + err).strip()
        if proc.returncode != 0:
            failures.append(f"--- {name} (exit {proc.returncode})\n{out}{err}")
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
         *(str(obj) for _n, obj, _p in procs)],
        capture_output=True, text=True,
    )
    for _n, obj, _p in procs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(lib_path)  # atomic: a concurrent loader never sees half a file
    BUILD_INFO.update(seconds=time.perf_counter() - t0, cached=False,
                      ptxas=reports, nvcc=nvcc)
    return lib_path


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launches_since(before: dict[str, int]) -> dict[str, int]:
    """The launches counted since `before` (a copy of LAUNCHES), by kernel,
    leaving out kernels with none."""
    return {name: n - before.get(name, 0) for name, n in LAUNCHES.items()
            if n != before.get(name, 0)}


def add_launches(counts: dict[str, int], times: int = 1) -> None:
    """Add `times` x `counts` to LAUNCHES (a graph replay's kernels)."""
    for name, n in counts.items():
        LAUNCHES[name] += times * n


def launch(name: str, entry: str, device, *args) -> None:
    """Call entry point `entry` on `device`'s current stream and count one
    launch of kernel `name`; raises if the launch was refused."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, entry)(*args, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError_t {rc}")
    LAUNCHES[name] += 1


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _lib = lib
        return _lib
