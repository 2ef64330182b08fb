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

The reference's multi-worker modes (a per-worker share of each limit, or
fleet-global buckets over its gossip bus) come with multi-worker serving;
one worker enforces the full limits.

No reference counterpart: the reference gateway admits whoever shows up
first (ROADMAP open item 5 names this as the missing overload story).
"""

from __future__ import annotations

import threading
import time

from llmlb_tpu_torch.gateway.config import RateLimitConfig


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

    def __init__(self, config: RateLimitConfig):
        self.config = config
        self._lock = threading.Lock()
        # tenant id -> (rps bucket | None, tpm bucket | None, last_used)
        self._buckets: dict[str, list] = {}

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def _limits_for(self, name: str | None) -> tuple[float, float, float]:
        """(rps, burst, tpm) for a tenant, overrides by key name first. A
        key PRESENT in the override wins even at 0 ("unlimited" — how a
        trusted key is exempted from the global default); an ABSENT key
        inherits the global."""
        cfg = self.config
        rps, burst, tpm = cfg.requests_per_s, cfg.burst, cfg.tokens_per_min
        ov = cfg.overrides.get(name or "")
        if ov is not None:
            rps = float(ov["rps"]) if "rps" in ov else rps
            burst = float(ov["burst"]) if "burst" in ov else burst
            tpm = float(ov["tpm"]) if "tpm" in ov else tpm
        return rps, max(0.0, burst), tpm

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

    def snapshot(self) -> dict:
        """Live figures for /api/health."""
        with self._lock:
            return {
                "enabled": self.enabled,
                "tenants_tracked": len(self._buckets),
                # the reference's multi-worker fields, at one worker
                "global": False,
                "workers_divisor": 1,
                "remote_spends_applied": 0,
                "defaults": {
                    "rps": self.config.requests_per_s,
                    "burst": self.config.burst,
                    "tpm": self.config.tokens_per_min,
                },
                "overrides": dict(self.config.overrides),
            }
