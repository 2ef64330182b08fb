"""Staged CUDA backend probe: diagnose init hangs instead of suffering them.

Counterpart of `llmlb_tpu/engine/tpu_probe.py`. A wedged driver or a card
held by another process can hang the first CUDA call with no output. The
probe runs in a CHILD process, in stages (import torch ->
`torch.cuda.is_available()` and the device count -> a tiny matmul on the
card), with `faulthandler` stack dumps every 30 s, so a hang reports
where it hangs, and the child's stderr tail survives the kill.

The engine server calls `guard_backend_init` before it builds the engine
on the card: an init that fails or does not finish within the timeout
(LLMLB_INIT_TIMEOUT, seconds, default 600; 0 disables the guard) exits
non-zero with the evidence. It never falls back to the CPU.
"""

from __future__ import annotations

import logging
import os
import subprocess
import sys

log = logging.getLogger("llmlb_tpu_torch.engine.cuda_probe")

PROBE_TIMEOUT_S = 150
PROBE_LONG_TIMEOUT_S = 420

PROBE_CODE = r"""
import faulthandler, sys, time
faulthandler.enable()
faulthandler.dump_traceback_later(30, repeat=True, file=sys.stderr)
t0 = time.time()
def mark(stage):
    print(f"[probe +{time.time()-t0:.1f}s] {stage}", file=sys.stderr, flush=True)
mark("stage1: import torch")
import torch
mark(f"stage1 done: torch {torch.__version__} (CUDA {torch.version.cuda})")
mark("stage2: torch.cuda.is_available() (driver init)")
if not torch.cuda.is_available():
    print("cpu 0 none")
    sys.exit(0)
n = torch.cuda.device_count()
name = torch.cuda.get_device_name(0)
mark(f"stage2 done: {n}x {name}")
mark("stage3: tiny matmul")
x = torch.ones((256, 256), dtype=torch.bfloat16, device="cuda:0")
(x @ x).sum().item()
mark("stage3 done")
print("cuda", n, name)
"""


def tail(text: str | bytes | None, lines: int = 25) -> list[str]:
    """Last N lines of captured child output, each clipped."""
    if not text:
        return []
    if isinstance(text, bytes):
        text = text.decode("utf-8", "replace")
    return [ln[:300] for ln in text.strip().splitlines()[-lines:]]


def staged_probe(
    timeouts: tuple[float, ...] = (PROBE_TIMEOUT_S, PROBE_LONG_TIMEOUT_S),
    *,
    code: str | None = None,
    log_fn=None,
) -> tuple[bool, str, dict]:
    """Run the staged probe child once per timeout until it succeeds.
    Returns (ok, diagnostic, evidence); evidence carries each attempt's
    outcome and the child's stdout and stderr tails (JSON-safe)."""
    if code is None:
        code = PROBE_CODE  # module attr at call time: tests may patch it
    emit = log_fn or (lambda msg: log.info("%s", msg))
    evidence: dict = {"attempts": []}
    last = ""
    for attempt, timeout_s in enumerate(timeouts, start=1):
        emit(f"CUDA probe attempt {attempt}/{len(timeouts)} "
             f"(timeout {timeout_s}s)")
        rec: dict = {"attempt": attempt, "timeout_s": timeout_s}
        try:
            r = subprocess.run([sys.executable, "-c", code],
                               capture_output=True, text=True,
                               timeout=timeout_s)
        except subprocess.TimeoutExpired as te:
            rec["outcome"] = f"timeout after {timeout_s}s"
            rec["child_stderr_tail"] = tail(te.stderr)
            rec["child_stdout_tail"] = tail(te.stdout)
            evidence["attempts"].append(rec)
            last = f"probe timed out after {timeout_s}s (backend init hang)"
            emit(last)
            for ln in rec["child_stderr_tail"]:
                emit(f"  child| {ln}")
            continue
        rec["returncode"] = r.returncode
        if r.returncode == 0 and r.stdout.strip():
            out = r.stdout.strip().splitlines()[-1]
            emit(f"CUDA probe OK: {out}")
            rec["outcome"] = f"ok: {out}"
            evidence["attempts"].append(rec)
            if out.startswith("cuda"):
                return True, out, evidence
            return False, f"backend is {out!r}, not cuda", evidence
        rec["outcome"] = f"rc={r.returncode}"
        rec["child_stderr_tail"] = tail(r.stderr)
        rec["child_stdout_tail"] = tail(r.stdout)
        evidence["attempts"].append(rec)
        t = rec["child_stderr_tail"] or rec["child_stdout_tail"] or ["unknown"]
        last = f"probe rc={r.returncode}: {t[-1]}"
        emit(last)
    return False, last, evidence


def guard_backend_init(timeout_s: float | None = None) -> None:
    """Before the first in-process CUDA call, prove in a child that the
    card initializes within `timeout_s`; on a failure or a hang, print the
    child's stderr tail and raise SystemExit. `timeout_s` defaults from
    LLMLB_INIT_TIMEOUT (seconds; default 600); 0 skips the probe. Call it
    only when the engine is to run on the card."""
    if timeout_s is None:
        raw = os.environ.get("LLMLB_INIT_TIMEOUT", "")
        try:
            timeout_s = float(raw) if raw else 600.0
        except ValueError:
            log.warning("LLMLB_INIT_TIMEOUT=%r is not a number; using 600",
                        raw)
            timeout_s = 600.0
    if timeout_s <= 0:
        return
    ok, diag, evidence = staged_probe(
        (timeout_s,), log_fn=lambda m: log.info("[init-probe] %s", m))
    if ok:
        return
    print("=" * 72, file=sys.stderr)
    print(f"CUDA backend init FAILED: {diag}", file=sys.stderr)
    for rec in evidence["attempts"]:
        print(f"-- attempt {rec['attempt']} ({rec['outcome']}):",
              file=sys.stderr)
        for ln in rec.get("child_stderr_tail", []):
            print(f"   {ln}", file=sys.stderr)
    print("(set LLMLB_INIT_TIMEOUT=0 to skip this guard, or --device cpu "
          "to serve on the CPU)", file=sys.stderr)
    print("=" * 72, file=sys.stderr)
    raise SystemExit(
        f"CUDA backend init did not complete within {timeout_s:.0f}s: {diag}")
