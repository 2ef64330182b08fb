"""Per-API-key token-bucket rate limiting (docs/scheduling.md).

One greedy tenant must not be able to wreck p99 latency for everyone: the
gateway refuses its excess load with 429 + an honest Retry-After computed
from the bucket's refill rate, instead of queuing it in front of everyone
else's work. Two buckets per tenant:

- requests/second (burst-capped): debited 1 at admission.
- tokens/minute: the PROMPT estimate is debited at admission; completion
  tokens are debited after the response finishes (the bucket may go
  negative — a tenant that just streamed a huge completion throttles its
  own NEXT request, not the one already running).

Two enforcement modes:

- **Local share** (no gossip): each worker enforces ``limit / workers`` —
  conservative like retry budgets: the group as a whole can never admit
  more than the configured rate, and SO_REUSEPORT's accept spreading makes
  the per-worker share an even split in practice (docs/deployment.md).
- **Global buckets** (gossip attached via ``attach_gossip``): every worker
  holds FULL-limit buckets and batches its admissions into ``rl_spend``
  gossip; receivers charge their own buckets by the delta (unconditionally
  — levels may go negative), so a tenant at rps=N is admitted ≈N across
  the whole fleet instead of N×workers. Gossip loss only makes the limit
  temporarily more generous, never unsafe for correctness — and the bus
  dropping entirely degrades to independent full-limit workers, which the
  operator sees on the gossip_partition_suspected gauge. LLMLB_GOSSIP=0
  keeps the conservative local-share mode.

No reference counterpart: the reference gateway admits whoever shows up
first (ROADMAP open item 5 names this as the missing overload story).
"""

from __future__ import annotations

import threading
import time

from llmlb_tpu_torch.gateway.config import RateLimitConfig

# Global mode: batch locally admitted spends and flush to the bus at most
# this often (plus the bus heartbeat as a floor when traffic is idle) — one
# datagram per interval per worker, not one per request.
RL_SPEND_FLUSH_S = 0.25


class TokenBucket:
    """Classic token bucket. ``take`` is check-and-debit; ``charge`` is an
    unconditional post-paid debit that may drive the level negative."""

    def __init__(self, rate_per_s: float, burst: float):
        self.rate = max(0.0, rate_per_s)
        self.burst = max(1.0, burst)
        self.level = self.burst
        self.ts = time.monotonic()

    def _refill(self, now: float) -> None:
        if self.rate <= 0:
            return
        self.level = min(self.burst, self.level + (now - self.ts) * self.rate)
        self.ts = now

    def take(self, cost: float, now: float | None = None) -> float:
        """Debit ``cost`` if covered; returns 0.0 on success, else the
        seconds until the bucket refills enough (the Retry-After figure)."""
        now = time.monotonic() if now is None else now
        self._refill(now)
        if self.level >= cost:
            self.level -= cost
            return 0.0
        if self.rate <= 0:
            return 60.0  # burst-only bucket that cannot refill: back off
        return (cost - self.level) / self.rate

    def charge(self, cost: float, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self._refill(now)
        self.level -= cost  # may go negative: throttles the next take


class RateVerdict:
    __slots__ = ("allowed", "retry_after_s", "reason")

    def __init__(self, allowed: bool, retry_after_s: float = 0.0,
                 reason: str | None = None):
        self.allowed = allowed
        self.retry_after_s = retry_after_s
        self.reason = reason  # "requests" | "tokens"


_ALLOW = RateVerdict(True)


class RateLimiter:
    """Tenant-keyed bucket pairs. Thread-safe; zero work when disabled."""

    # A tenant idle this long has full buckets anyway: drop its entry so
    # the map does not grow one pair per key ever seen.
    IDLE_EVICT_S = 900.0

    def __init__(self, config: RateLimitConfig, workers: int = 1):
        self.config = config
        self.workers = max(1, int(workers))
        self._lock = threading.Lock()
        # tenant id -> (rps bucket | None, tpm bucket | None, last_used)
        self._buckets: dict[str, list] = {}
        # Global mode (attach_gossip): the bus, plus spends admitted here
        # since the last flush — tenant -> [requests, tokens, key_name].
        self.gossip = None
        self._pending: dict[str, list] = {}
        self._last_flush = time.monotonic()
        self.remote_spends_applied = 0  # datagrams folded in (snapshot)

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    @property
    def global_mode(self) -> bool:
        return self.gossip is not None

    def attach_gossip(self, bus) -> None:
        """Switch to fleet-global buckets: full limits locally, admissions
        replicated as rl_spend deltas. Resets tracked tenants — their
        buckets were sized for the per-worker share."""
        with self._lock:
            self.gossip = bus
            self._buckets.clear()
            self._pending.clear()
        bus.subscribe("rl_spend",
                      lambda d, m: self.apply_remote_spend(d["spends"]))
        # traffic-idle flush floor: pending spends never wait past one
        # heartbeat even if this worker admits nothing else
        bus.on_heartbeat.append(self.flush_spends)

    def _limits_for(self, name: str | None) -> tuple[float, float, float]:
        """(rps, burst, tpm) for a tenant, overrides by key name first. A
        key PRESENT in the override wins even at 0 ("unlimited" — how a
        trusted key is exempted from the global default); an ABSENT key
        inherits the global. Local-share mode divides by the worker count
        (each worker enforces its share); global mode uses full limits and
        relies on gossiped spends."""
        cfg = self.config
        rps, burst, tpm = cfg.requests_per_s, cfg.burst, cfg.tokens_per_min
        ov = cfg.overrides.get(name or "")
        if ov is not None:
            rps = float(ov["rps"]) if "rps" in ov else rps
            burst = float(ov["burst"]) if "burst" in ov else burst
            tpm = float(ov["tpm"]) if "tpm" in ov else tpm
        w = 1 if self.global_mode else self.workers
        return rps / w, (burst / w if burst > 0 else 0.0), tpm / w

    def _pair(self, tenant: str, name: str | None):
        got = self._buckets.get(tenant)
        if got is not None:
            got[2] = time.monotonic()
            return got
        rps, burst, tpm = self._limits_for(name)
        rps_bucket = (TokenBucket(rps, burst or max(1.0, 2 * rps))
                      if rps > 0 else None)
        tpm_bucket = (TokenBucket(tpm / 60.0, tpm) if tpm > 0 else None)
        got = [rps_bucket, tpm_bucket, time.monotonic()]
        self._buckets[tenant] = got
        if len(self._buckets) > 4096:
            self._evict_idle()
        return got

    def _evict_idle(self) -> None:
        cutoff = time.monotonic() - self.IDLE_EVICT_S
        for t in [t for t, b in self._buckets.items() if b[2] < cutoff]:
            del self._buckets[t]

    def acquire(self, tenant: str, name: str | None = None,
                est_tokens: int = 0) -> RateVerdict:
        """Admission check for one request: 1 from the request bucket plus
        the prompt-token estimate from the token bucket. Refusal debits
        nothing (a 429'd request consumed no engine work)."""
        if not self.enabled:
            return _ALLOW
        with self._lock:
            rps_bucket, tpm_bucket, _ = self._pair(tenant, name)
            if rps_bucket is not None:
                wait = rps_bucket.take(1.0)
                if wait > 0:
                    return RateVerdict(False, wait, "requests")
            if tpm_bucket is not None:
                wait = tpm_bucket.take(float(max(0, est_tokens)))
                if wait > 0:
                    if rps_bucket is not None:
                        rps_bucket.level += 1.0  # roll back the paired debit
                    return RateVerdict(False, wait, "tokens")
            if self.global_mode:
                self._note_spend_locked(tenant, name, 1, max(0, est_tokens))
        self.flush_spends()
        return _ALLOW

    def charge_tokens(self, tenant: str, tokens: int,
                      name: str | None = None) -> None:
        """Post-paid debit of completion tokens (post-response truth the
        admission estimate could not know)."""
        if not self.enabled or tokens <= 0:
            return
        with self._lock:
            _, tpm_bucket, _ = self._pair(tenant, name)
            if tpm_bucket is not None:
                tpm_bucket.charge(float(tokens))
            if self.global_mode:
                self._note_spend_locked(tenant, name, 0, tokens)
        self.flush_spends()

    # ---------------------------------------------------- global replication

    def _note_spend_locked(self, tenant: str, name: str | None,
                           reqs: int, tokens: int) -> None:
        entry = self._pending.setdefault(tenant, [0, 0, name or ""])
        entry[0] += reqs
        entry[1] += tokens

    def flush_spends(self, force: bool = False) -> None:
        """Publish batched spend deltas when the interval elapsed (or
        forced by tests/shutdown). Never called with the lock held —
        publish writes to sockets."""
        g = self.gossip
        if g is None:
            return
        now = time.monotonic()
        with self._lock:
            if not self._pending:
                return
            if not force and now - self._last_flush < RL_SPEND_FLUSH_S:
                return
            self._last_flush = now
            pending, self._pending = self._pending, {}
        g.publish("rl_spend", {
            "spends": {t: list(v) for t, v in pending.items()},
        })

    def apply_remote_spend(self, spends: dict) -> None:
        """A sibling's admitted spends: unconditional charges against our
        own full-limit buckets (levels may go negative — exactly how the
        post-paid completion debit already works), so the NEXT local
        admission sees fleet-wide consumption. Never re-gossips."""
        if not self.enabled or not isinstance(spends, dict):
            return
        with self._lock:
            self.remote_spends_applied += 1
            for tenant, value in spends.items():
                if not (isinstance(value, (list, tuple)) and len(value) >= 2):
                    continue
                reqs, tokens = float(value[0]), float(value[1])
                name = (str(value[2]) or None) if len(value) > 2 else None
                rps_bucket, tpm_bucket, _ = self._pair(str(tenant), name)
                if rps_bucket is not None and reqs > 0:
                    rps_bucket.charge(reqs)
                if tpm_bucket is not None and tokens > 0:
                    tpm_bucket.charge(tokens)

    def snapshot(self) -> dict:
        """Live figures for /api/health."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "tenants_tracked": len(self._buckets),
                "global": self.global_mode,
                "workers_divisor": 1 if self.global_mode else self.workers,
                "remote_spends_applied": self.remote_spends_applied,
                "defaults": {
                    "rps": self.config.requests_per_s,
                    "burst": self.config.burst,
                    "tpm": self.config.tokens_per_min,
                },
                "overrides": dict(self.config.overrides),
            }
