"""Environment-based configuration: the port's copy of
llmlb_tpu/gateway/config.py.

It leaves out the reference's `auto_sync_interval_s`
(LLMLB_AUTO_SYNC_INTERVAL), a setting that nothing in either package reads
(ROADMAP C24): the port parses only settings that it acts on.

Same variable names and defaults as the reference (reference config.rs:28-77;
README LLMLB_* table), so a reference deployment's env carries over.
"""

from __future__ import annotations

import dataclasses
import logging
import os


def env_str(name: str, default: str | None = None) -> str | None:
    return os.environ.get(name, default)


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class QueueConfig:
    """Admission/queue behavior when all endpoints for a model are busy."""

    max_queue_size: int = 100
    queue_timeout_s: float = 30.0
    max_active_per_endpoint: int = 32

    @classmethod
    def from_env(cls) -> "QueueConfig":
        return cls(
            max_queue_size=env_int("LLMLB_QUEUE_MAX_SIZE", 100),
            queue_timeout_s=env_float("LLMLB_QUEUE_TIMEOUT_SECS", 30.0),
            max_active_per_endpoint=env_int("LLMLB_MAX_ACTIVE_PER_ENDPOINT", 32),
        )


@dataclasses.dataclass(frozen=True)
class ResilienceConfig:
    """In-band failover + per-endpoint circuit breaking (gateway/resilience.py).

    Retries: a failed upstream attempt (connect error, timeout, retryable
    status) re-runs endpoint selection excluding the failed endpoint, with
    capped exponential backoff + jitter, under a global retry budget —
    retries are capped as a fraction of recent request volume so a melting
    fleet is not amplified by its own failover traffic.

    Breaker: consecutive in-band failures trip an endpoint open (ejected
    from selection immediately, no 30 s health-probe wait); after the open
    interval one half-open probe request is admitted, and its outcome
    closes or re-opens (with doubled interval, capped) the breaker.
    """

    enabled: bool = True
    max_attempts: int = 3  # total tries per request, incl. the first
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    # Re-selection after a failure parks at most this long for a slot —
    # a failed request must not burn the full client queue timeout again.
    failover_queue_timeout_s: float = 5.0
    retry_budget_ratio: float = 0.2  # retries per recent request
    retry_budget_min: int = 10  # floor: always allow this many per window
    retry_budget_window_s: float = 60.0
    retryable_statuses: tuple[int, ...] = (429, 500, 502, 503, 504)
    breaker_failure_threshold: int = 5  # consecutive failures to trip
    breaker_open_s: float = 10.0
    breaker_open_max_s: float = 120.0  # repeated trips double up to this
    breaker_half_open_probes: int = 1

    @classmethod
    def from_env(cls) -> "ResilienceConfig":
        raw_statuses = env_str("LLMLB_RETRY_STATUSES", "")
        statuses = cls.retryable_statuses
        if raw_statuses:
            try:
                statuses = tuple(
                    int(s) for s in raw_statuses.split(",") if s.strip()
                )
            except ValueError:
                logging.getLogger("llmlb_tpu_torch.gateway.config").warning(
                    "LLMLB_RETRY_STATUSES=%r is not a comma-separated list "
                    "of integers; using default %r",
                    raw_statuses, statuses,
                )
        return cls(
            enabled=env_bool("LLMLB_RESILIENCE", True),
            max_attempts=max(1, env_int("LLMLB_RETRY_MAX_ATTEMPTS", 3)),
            backoff_base_s=env_float("LLMLB_RETRY_BACKOFF_BASE", 0.05),
            backoff_cap_s=env_float("LLMLB_RETRY_BACKOFF_CAP", 2.0),
            failover_queue_timeout_s=env_float(
                "LLMLB_FAILOVER_QUEUE_TIMEOUT", 5.0
            ),
            retry_budget_ratio=env_float("LLMLB_RETRY_BUDGET_RATIO", 0.2),
            retry_budget_min=env_int("LLMLB_RETRY_BUDGET_MIN", 10),
            retry_budget_window_s=env_float("LLMLB_RETRY_BUDGET_WINDOW", 60.0),
            retryable_statuses=statuses,
            breaker_failure_threshold=max(
                1, env_int("LLMLB_BREAKER_FAILURE_THRESHOLD", 5)
            ),
            breaker_open_s=env_float("LLMLB_BREAKER_OPEN_SECS", 10.0),
            breaker_open_max_s=env_float("LLMLB_BREAKER_OPEN_MAX_SECS", 120.0),
            breaker_half_open_probes=max(
                1, env_int("LLMLB_BREAKER_HALF_OPEN_PROBES", 1)
            ),
        )


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Latency-SLO targets for goodput accounting (gateway/metrics.py).

    Goodput — the fraction of requests meeting their TTFT and inter-token
    latency targets — is the serving figure that survives adversarial
    traffic, where raw throughput lies ("Answer Fast" framing, PAPERS.md;
    ROADMAP item 5). Targets are per model with a global default:

        LLMLB_SLO_TTFT_MS      default TTFT target (default 2000)
        LLMLB_SLO_ITL_MS       default mean-ITL target (default 200)
        LLMLB_SLO_TARGETS      JSON per-model overrides, e.g.
                               {"llama-3-8b": {"ttft_ms": 500, "itl_ms": 50}}
        LLMLB_SLO=0            disable goodput accounting entirely
    """

    enabled: bool = True
    ttft_target_s: float = 2.0
    itl_target_s: float = 0.2
    # model -> (ttft_target_s, itl_target_s); fall back to the defaults
    per_model: dict = dataclasses.field(default_factory=dict)

    def targets_for(self, model: str) -> tuple[float, float]:
        override = self.per_model.get(model)
        if override is not None:
            return override
        return self.ttft_target_s, self.itl_target_s

    @classmethod
    def from_env(cls) -> "SloConfig":
        per_model: dict = {}
        raw = env_str("LLMLB_SLO_TARGETS", "")
        default_ttft = env_float("LLMLB_SLO_TTFT_MS", 2000.0) / 1000.0
        default_itl = env_float("LLMLB_SLO_ITL_MS", 200.0) / 1000.0
        if raw:
            import json

            try:
                parsed = json.loads(raw)
                for model, t in parsed.items():
                    per_model[str(model)] = (
                        float(t.get("ttft_ms", default_ttft * 1000)) / 1000.0,
                        float(t.get("itl_ms", default_itl * 1000)) / 1000.0,
                    )
            except (ValueError, AttributeError, TypeError):
                logging.getLogger("llmlb_tpu_torch.gateway.config").warning(
                    "LLMLB_SLO_TARGETS=%r is not a JSON object of "
                    '{"model": {"ttft_ms": N, "itl_ms": N}}; ignoring', raw,
                )
                per_model = {}
        return cls(
            enabled=env_bool("LLMLB_SLO", True),
            ttft_target_s=default_ttft,
            itl_target_s=default_itl,
            per_model=per_model,
        )


@dataclasses.dataclass(frozen=True)
class RateLimitConfig:
    """Per-API-key token-bucket rate limits (gateway/ratelimit.py).

    Two buckets per tenant: requests/second (burst-capped) and tokens/minute
    (prompt estimate debited at admission, completion tokens debited after
    the response — the bucket may go negative, throttling the NEXT request).
    A refused request gets 429 with Retry-After computed from the bucket's
    refill rate. Defaults are 0 = unlimited; per-key overrides by API-key
    name (or id):

        LLMLB_RATELIMIT_RPS        default requests/second per key (0 = off)
        LLMLB_RATELIMIT_BURST      bucket size (default 2x rps, min 1)
        LLMLB_RATELIMIT_TPM        default tokens/minute per key (0 = off)
        LLMLB_RATELIMIT_OVERRIDES  JSON per-key overrides, e.g.
                                   {"bulk-batch": {"rps": 1, "tpm": 6000}}

    Multi-worker: with the gossip bus up, buckets are fleet-GLOBAL — each
    worker enforces the full limit and replicates its admitted spends as
    `rl_spend` deltas (RateLimiter.attach_gossip), so a tenant at rps=N is
    admitted ≈N across all workers and mesh-federated hosts. With gossip
    disabled, limits divide by the worker count (each worker enforces
    limit/N) — conservative, like retry budgets.
    """

    requests_per_s: float = 0.0
    burst: float = 0.0  # 0 -> 2x rps (min 1)
    tokens_per_min: float = 0.0
    overrides: dict = dataclasses.field(default_factory=dict)

    @property
    def enabled(self) -> bool:
        return (self.requests_per_s > 0 or self.tokens_per_min > 0
                or bool(self.overrides))

    @classmethod
    def from_env(cls) -> "RateLimitConfig":
        overrides: dict = {}
        raw = env_str("LLMLB_RATELIMIT_OVERRIDES", "")
        if raw:
            import json

            try:
                parsed = json.loads(raw)
                for key, t in parsed.items():
                    # keep ONLY the keys the operator wrote: an absent key
                    # inherits the global default, an explicit 0 means
                    # unlimited for that key (see RateLimiter._limits_for)
                    overrides[str(key)] = {
                        k: float(t[k]) for k in ("rps", "burst", "tpm")
                        if k in t
                    }
            except (ValueError, AttributeError, TypeError):
                logging.getLogger("llmlb_tpu_torch.gateway.config").warning(
                    "LLMLB_RATELIMIT_OVERRIDES=%r is not a JSON object of "
                    '{"key": {"rps": N, "burst": N, "tpm": N}}; ignoring',
                    raw,
                )
                overrides = {}
        return cls(
            requests_per_s=env_float("LLMLB_RATELIMIT_RPS", 0.0),
            burst=env_float("LLMLB_RATELIMIT_BURST", 0.0),
            tokens_per_min=env_float("LLMLB_RATELIMIT_TPM", 0.0),
            overrides=overrides,
        )


def wfq_weights_from_env() -> dict[str, float]:
    """LLMLB_WFQ_WEIGHTS: JSON of per-tenant weights for the weighted fair
    admission queue, keyed by API-key name (default weight 1.0). A weight-2
    tenant drains twice as fast through a contended queue."""
    raw = env_str("LLMLB_WFQ_WEIGHTS", "")
    if not raw:
        return {}
    import json

    try:
        parsed = json.loads(raw)
        return {str(k): max(0.01, float(v)) for k, v in parsed.items()}
    except (ValueError, AttributeError, TypeError):
        logging.getLogger("llmlb_tpu_torch.gateway.config").warning(
            'LLMLB_WFQ_WEIGHTS=%r is not a JSON object of {"key": weight}; '
            "ignoring", raw,
        )
        return {}


@dataclasses.dataclass(frozen=True)
class ServerConfig:
    host: str = "0.0.0.0"
    port: int = 32768  # reference default port
    database_url: str = ""
    jwt_secret: str | None = None
    log_level: str = "info"
    health_check_interval_s: float = 30.0
    health_check_timeout_s: float = 5.0
    request_history_retention_days: int = 7
    inference_timeout_s: float = 300.0
    admin_username: str = "admin"
    admin_password: str | None = None
    update_drain_timeout_s: float = 300.0
    # Slow-loris protection: an SSE write that cannot reach the client
    # within this many seconds aborts the stream (freeing the engine slot)
    # instead of pinning it for the full inference timeout. 0 disables.
    stream_write_timeout_s: float = 30.0
    # Default request deadline in ms applied when the client sends none
    # (X-Request-Deadline-Ms header wins). 0 = no default deadline.
    request_deadline_ms: float = 0.0
    # Durable streams (gateway/replay.py, docs/resilience.md): when a tpu://
    # engine dies mid-stream, replay prompt+committed tokens onto another
    # engine and splice the token-identical continuation into the SAME
    # client response instead of emitting a terminal error frame.
    stream_resume: bool = True
    # Resume attempts per stream (each also spends the global retry budget).
    stream_resume_attempts: int = 2

    @classmethod
    def from_env(cls) -> "ServerConfig":
        data_dir = os.path.expanduser(env_str("LLMLB_DATA_DIR", "~/.llmlb") or "~/.llmlb")
        return cls(
            host=env_str("LLMLB_HOST", "0.0.0.0") or "0.0.0.0",
            port=env_int("LLMLB_PORT", 32768),
            database_url=env_str(
                "LLMLB_DATABASE_URL", os.path.join(data_dir, "llmlb.db")
            )
            or "",
            jwt_secret=env_str("LLMLB_JWT_SECRET"),
            log_level=env_str("LLMLB_LOG_LEVEL", "info") or "info",
            health_check_interval_s=env_float("LLMLB_HEALTH_CHECK_INTERVAL", 30.0),
            health_check_timeout_s=env_float("LLMLB_HEALTH_CHECK_TIMEOUT", 5.0),
            request_history_retention_days=env_int(
                "LLMLB_REQUEST_HISTORY_RETENTION_DAYS", 7
            ),
            inference_timeout_s=env_float("LLMLB_INFERENCE_TIMEOUT", 300.0),
            admin_username=env_str("LLMLB_ADMIN_USERNAME", "admin") or "admin",
            admin_password=env_str("LLMLB_ADMIN_PASSWORD"),
            update_drain_timeout_s=env_float("LLMLB_UPDATE_DRAIN_TIMEOUT", 300.0),
            stream_write_timeout_s=env_float(
                "LLMLB_STREAM_WRITE_TIMEOUT", 30.0
            ),
            request_deadline_ms=env_float("LLMLB_REQUEST_DEADLINE_MS", 0.0),
            stream_resume=env_bool("LLMLB_STREAM_RESUME", True),
            stream_resume_attempts=max(
                0, env_int("LLMLB_STREAM_RESUME_ATTEMPTS", 2)
            ),
        )
