"""Step-loop introspection: per-step phase records, ring buffer, anomalies.

The port's own copy of `llmlb_tpu/engine/stepstats.py` (pure Python, the
same semantics). Every scheduler dispatch (a prefill group or chunk, a
decode burst, a speculative verify step) produces ONE record with a
per-phase wall-clock breakdown:

  plan      — admission work with no dispatch of its own (queue pops,
              prefix matches, page reservation), absorbed by the next record
  draft     — the verify step's prompt-lookup proposals (`_collect_drafts`)
  host_sync — host-to-device state refresh before a dispatch: block-table
              rows, grammar cursors or mask rows, forced tokens
  dispatch  — the host wall of the launches: a graph replay, or the eager
              model step's kernel launches
  compute   — the host's wait on a CUDA event recorded right after the
              dispatch (on the card; 0 on the CPU, whose ops run inside the
              dispatch, and on a prefill, which the host never waits for)
  fetch     — the device-to-host token copy (the per-burst `.cpu()`)
  emit      — host-side token delivery: stop checks, grammar FSM advance,
              event-queue puts

Records land in a bounded ring served at the engine's `/api/steps`, plus
per-phase histograms in `/metrics`. A slow-step detector keeps an EMA of
step time per kind and flags steps over a multiple of it.

The recorder is a handful of `time.perf_counter()` deltas per step and one
dict append (tests/test_torch_observability.py times `observe` directly).
"""

from __future__ import annotations

import threading
import time
from collections import deque

PHASES = ("plan", "draft", "host_sync", "dispatch", "compute", "fetch",
          "emit")

# Step kinds the scheduler dispatches. Each kind keeps its OWN EMA baseline
# in the slow-step detector: a K+1-token speculative verify step is
# legitimately several times a single-token decode step, so folding them
# into one baseline would either flag every verify step or mask genuinely
# slow decodes.
#   prefill — prompt KV fill (one-shot group, chunked extend, or CP pass)
#   decode  — 1-token (or burst-scanned k-token) step, one token/slot/step
#   verify  — speculative K+1-token verification (llmlb_tpu_torch/spec): scores
#             the drafts in one extend-style dispatch; `tokens` on its
#             records counts tokens actually EMITTED (accepted + 1 per
#             slot), not positions scored
KINDS = ("prefill", "decode", "verify")

# EMA smoothing for the per-kind step-time baseline. Small alpha: the
# baseline should drift with load, not chase a single outlier.
_EMA_ALPHA = 0.05
# A step is anomalous when it exceeds max(ratio x EMA, floor). The floor
# keeps microsecond-scale CPU steps from flagging scheduler jitter.
_SLOW_RATIO = 4.0
_SLOW_FLOOR_S = 0.020
# Steps observed before the detector arms (the first steps of a fresh
# engine include graph captures and would all flag).
_WARMUP_STEPS = 16


class StepRecorder:
    """Bounded ring of per-step phase breakdowns + slow-step detection +
    a sliding window of (tokens, busy seconds) for live MFU math.

    Thread-safety: observe() runs on the step loop only; snapshot()/window()
    may run on scrape threads — everything mutable sits behind one lock
    held for microseconds.
    """

    def __init__(self, capacity: int = 512, *, slow_ratio: float = _SLOW_RATIO,
                 slow_floor_s: float = _SLOW_FLOOR_S,
                 window: int = 128):
        self.capacity = max(1, capacity)
        self.slow_ratio = slow_ratio
        self.slow_floor_s = slow_floor_s
        self._lock = threading.Lock()
        self._ring: deque[dict] = deque(maxlen=self.capacity)
        self._seq = 0
        self._ema: dict[str, float] = {}  # kind -> EMA of total_s
        self._seen: dict[str, int] = {}
        self.slow_steps_total = 0
        # sliding window of decode steps for throughput-derived figures
        self._window: deque[tuple[float, int]] = deque(maxlen=max(1, window))

    # -------------------------------------------------------------- recording

    def observe(self, kind: str, phases: dict[str, float], *,
                active_slots: int = 0, tokens: int = 0,
                request_ids: dict[str, str] | None = None,
                dispatches: int = 0,
                device_ms: float | None = None) -> bool:
        """Record one step; returns True when it was flagged anomalous.
        `phases` maps phase name -> seconds (missing phases count as 0);
        `tokens` is the number of tokens this step delivered to the host
        (decode: burst x active slots); `request_ids` maps slot id ->
        gateway request id for the requests riding this dispatch, so a
        flagged record NAMES its victims (/api/steps?slow=1); `dispatches`
        counts the model step calls this step launched (one for a graph
        replay; `engine/dispatch_check.py` asserts exactly 1 on decode and
        verify records after each graph key's warm-up). `device_ms` is the
        card's time between two CUDA events recorded around the dispatch
        (None on the CPU, or until `set_device_ms` fills it in: a prefill's
        events are read after a later fetch, never waited for)."""
        now = time.time()
        total = sum(phases.values())
        with self._lock:
            seen = self._seen.get(kind, 0)
            ema = self._ema.get(kind)
            slow = False
            if seen >= _WARMUP_STEPS and ema is not None:
                threshold = max(self.slow_ratio * ema, self.slow_floor_s)
                slow = total > threshold
                if slow:
                    self.slow_steps_total += 1
            # anomalous steps do not feed the baseline: one 40x step must
            # not drag the EMA up and mask the next one
            if ema is None:
                self._ema[kind] = total
            elif not slow:
                self._ema[kind] = ema + _EMA_ALPHA * (total - ema)
            self._seen[kind] = seen + 1
            self._seq += 1
            self._ring.append({
                "seq": self._seq,
                "ts": now,
                "kind": kind,
                "total_s": total,
                "phases_s": {p: phases.get(p, 0.0) for p in PHASES},
                "active_slots": active_slots,
                "tokens": tokens,
                "dispatches": dispatches,
                "device_ms": device_ms,
                "request_ids": dict(request_ids) if request_ids else {},
                "slow": slow,
            })
            # decode AND verify steps feed the throughput window: both
            # deliver committed tokens, and live MFU must see speculative
            # throughput or it would collapse the moment speculation engages
            if kind in ("decode", "verify") and tokens > 0:
                self._window.append((total, tokens))
        return slow

    def set_device_ms(self, seq: int, device_ms: float) -> bool:
        """Fill in record `seq`'s device time once its events completed;
        False when the record has left the ring."""
        with self._lock:
            back = self._seq - seq
            if not 0 <= back < len(self._ring):
                return False
            self._ring[len(self._ring) - 1 - back]["device_ms"] = device_ms
        return True

    # --------------------------------------------------------------- reading

    @property
    def seq(self) -> int:
        """Sequence number of the most recent record (0 before the first).
        Lock-free read of an int the GIL keeps coherent."""
        return self._seq

    def window_throughput(self) -> tuple[float, int]:
        """(busy seconds, tokens) over the sliding decode window — the
        denominator/numerator for live MFU. Busy seconds exclude idle loop
        sleeps: MFU is measured against time the device was actually
        stepping, which is the figure an operator tunes kernels by."""
        with self._lock:
            if not self._window:
                return 0.0, 0
            secs = sum(s for s, _ in self._window)
            toks = sum(t for _, t in self._window)
        return secs, toks

    def snapshot(self, limit: int = 64, *, slow_only: bool = False) -> dict:
        """JSON-safe view for /api/steps: recent records (newest first),
        per-kind EMA baselines, and the anomaly counter."""
        limit = max(0, min(limit, self.capacity))
        with self._lock:
            records = list(self._ring)
            ema = dict(self._ema)
            slow_total = self.slow_steps_total
            seq = self._seq
        if slow_only:
            records = [r for r in records if r["slow"]]
        records = records[-limit:]
        records.reverse()
        # copies: the ring's dicts stay untouched for concurrent snapshots
        records = [
            {**r,
             "total_s": round(r["total_s"], 6),
             "phases_s": {k: round(v, 6) for k, v in r["phases_s"].items()}}
            for r in records
        ]
        return {
            "steps_total": seq,
            "buffered": len(self._ring) if not slow_only else None,
            "capacity": self.capacity,
            "slow_steps_total": slow_total,
            "ema_step_s": {k: round(v, 6) for k, v in ema.items()},
            "slow_ratio": self.slow_ratio,
            "slow_floor_s": self.slow_floor_s,
            "records": records,
        }
