"""Gateway-wide Prometheus metrics: the request-path figures the balancer
cannot see from inside one engine.

Same dependency-free idiom as EngineMetrics (llmlb_tpu/engine/metrics.py):
plain counters and bucketed histograms behind one lock, rendered in
Prometheus text exposition at GET /metrics. Histograms are labeled
per (model, endpoint) so a slow request can be attributed to queueing vs
the engine, and to WHICH engine — the per-phase breakdown every serving
paper tunes against, now observable at the gateway layer.

Series:
  llmlb_gateway_requests_total{route,status}   counter
  llmlb_gateway_errors_total{route}            counter (status >= 400)
  llmlb_gateway_retries_total{api}             counter (admission re-attempts)
  llmlb_gateway_queue_timeouts_total{model}    counter
  llmlb_gateway_ttft_seconds{model,endpoint}   histogram
  llmlb_gateway_e2e_seconds{model,endpoint}    histogram
  llmlb_gateway_queue_wait_seconds{model,endpoint} histogram
resilience-layer series (gateway/resilience.py):
  llmlb_gateway_failover_retries_total{model,reason}     counter
  llmlb_gateway_failover_recoveries_total{model}         counter
  llmlb_gateway_retry_budget_exhausted_total             counter
  llmlb_gateway_breaker_transitions_total{endpoint,to}   counter
  llmlb_gateway_breaker_state{endpoint}                  gauge (0/1/2)
  llmlb_gateway_stream_interruptions_total{model,endpoint} counter
  llmlb_gateway_faults_injected_total{kind}              counter
fleet series (gateway/rebalance.py, gateway/gossip.py):
  llmlb_gateway_rebalance_migrations_total{reason,outcome} counter
  llmlb_gateway_gossip_delay_seconds                     histogram
  (plus the gossip counters, gossip_peers and gossip_partition_suspected,
   scrape-time figures injected by app_state.gateway_exposition)
SLO goodput series (targets from SloConfig, docs/profiling.md):
  llmlb_gateway_slo_eligible_total{model}   counter (requests judged)
  llmlb_gateway_slo_met_total{model}        counter (met every target)
  llmlb_gateway_slo_ttft_miss_total{model}  counter
  llmlb_gateway_slo_itl_miss_total{model}   counter
  llmlb_gateway_goodput_ratio{model}        gauge (met / eligible)
overload-protection series (docs/scheduling.md):
  llmlb_gateway_slo_priority_eligible_total{priority}  counter
  llmlb_gateway_slo_priority_met_total{priority}       counter
  llmlb_gateway_goodput_by_priority{priority}          gauge
  llmlb_gateway_ratelimit_rejections_total{reason}     counter (429s)
  llmlb_gateway_deadline_shed_total{model}             counter
  llmlb_gateway_stream_write_timeouts_total{model}     counter
plus scrape-time gauges (active requests, admission queue depth, event-bus
drops, trace-buffer size) injected by the /metrics handler.
"""

from __future__ import annotations

import re
import threading
from collections import defaultdict

from llmlb_tpu_torch.engine.metrics import Histogram

# Sample lines of a Prometheus text exposition: `name value`,
# `name{labels} value`, with optional trailing timestamp. The label block
# is matched greedily to the LAST closing brace before the value — a '}'
# inside a label value (legal; only \ " \n are escaped) must not truncate
# the block or the injected label would land mid-string.
_SAMPLE_LINE = re.compile(
    r"^([A-Za-z_:][A-Za-z0-9_:]*)(\{.*\})?( .*)$"
)


def label_exposition(text: str, label: str, value: str) -> str:
    """Inject one label into every sample line of an exposition.

    Multi-worker /metrics: each worker's series carry worker="N" so a
    scrape (which SO_REUSEPORT hands to ONE arbitrary worker) stays
    attributable after the serving worker merges its siblings' spooled
    expositions — sum by (...) in PromQL aggregates, by (worker) splits.
    """
    pair = f'{label}="{value}"'
    out = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        m = _SAMPLE_LINE.match(line)
        if m is None:
            out.append(line)
            continue
        name, labels, rest = m.group(1), m.group(2), m.group(3)
        if labels:
            out.append(f"{name}{{{labels[1:-1]},{pair}}}{rest}")
        else:
            out.append(f"{name}{{{pair}}}{rest}")
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")

# Gateway-side latency edges: TTFT spans engine prefill plus proxy overhead
# (tens of ms to tens of seconds for queued long prompts); queue wait spans
# sub-ms fast-path admissions to the 30 s queue timeout.
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
E2E_BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
               60.0, 120.0)
QUEUE_WAIT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                      5.0, 10.0, 30.0)
# One-way gossip delivery delay: sub-ms on a unix socket, tens of ms across
# hosts, seconds when a delay fault or congested mesh is in play.
GOSSIP_LAG_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                      1.0, 2.5, 5.0)


def _escape(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class GatewayMetrics:
    def __init__(self, slo=None):
        # `slo` is a config.SloConfig (None: goodput accounting inert —
        # the series still render, at zero, so dashboards never 404)
        self.slo = slo
        self._lock = threading.Lock()
        self._requests: dict[tuple[str, int], int] = defaultdict(int)
        self._errors: dict[str, int] = defaultdict(int)
        self._retries: dict[str, int] = defaultdict(int)
        self._queue_timeouts: dict[str, int] = defaultdict(int)
        # (model, endpoint) -> Histogram
        self._ttft: dict[tuple[str, str], Histogram] = {}
        self._e2e: dict[tuple[str, str], Histogram] = {}
        self._queue_wait: dict[tuple[str, str], Histogram] = {}
        # resilience layer (gateway/resilience.py)
        self._failover_retries: dict[tuple[str, str], int] = defaultdict(int)
        self._failover_recoveries: dict[str, int] = defaultdict(int)
        self._retry_budget_exhausted = 0
        self._breaker_transitions: dict[tuple[str, str], int] = defaultdict(int)
        self._breaker_state: dict[str, int] = {}
        self._stream_interruptions: dict[tuple[str, str], int] = defaultdict(int)
        self._faults_injected: dict[str, int] = defaultdict(int)
        # fleet rebalancing (gateway/rebalance.py): proactive live-stream
        # migrations by (reason=hotspot|drain|restart, outcome=success|
        # aborted|refused|skipped) — distinct from stream_resumes, which
        # counts REACTIVE failure recovery
        self._rebalance_migrations: dict[tuple[str, str], int] = defaultdict(int)
        # one-way gossip delivery delay per received message (wall-clock
        # derived, diagnostic only — see gossip.py module docstring)
        self._gossip_lag = Histogram(GOSSIP_LAG_BUCKETS)
        # structured outputs (llmlb_tpu/structured): requests that asked for
        # grammar-constrained decoding, by kind, and requests rejected 400
        # at gateway-side validation (malformed / unsupported schema)
        self._structured_requests: dict[str, int] = defaultdict(int)
        self._structured_rejected = 0
        # multi-LoRA adapter routing (docs/lora.md): requests that named an
        # adapter, by route — "hot" (an endpoint already had it resident),
        # "load" (fell back to a lora-capable endpoint, triggering a
        # hot-load), "rejected" (400: malformed field or unserveable
        # adapter)
        self._lora_requests: dict[str, int] = defaultdict(int)
        # disaggregated prefill/decode (docs/disaggregation.md): two-phase
        # handoffs the proxy orchestrated, by outcome — "adopted" (a decode
        # pool endpoint took the stream) or "self" (no adopter free; the
        # prefill endpoint continued its own stream)
        self._handoffs: dict[str, int] = defaultdict(int)
        # SLO goodput accounting: per-model attainment counters against the
        # SloConfig targets; goodput_ratio renders as met/eligible
        self._slo_eligible: dict[str, int] = defaultdict(int)
        self._slo_met: dict[str, int] = defaultdict(int)
        self._slo_ttft_miss: dict[str, int] = defaultdict(int)
        self._slo_itl_miss: dict[str, int] = defaultdict(int)
        # goodput BY PRIORITY CLASS (docs/scheduling.md): the figure that
        # shows overload protection working — high-priority goodput holding
        # while low-priority traffic absorbs the squeeze
        self._slo_prio_eligible: dict[str, int] = defaultdict(int)
        self._slo_prio_met: dict[str, int] = defaultdict(int)
        # overload protection (docs/scheduling.md): requests refused by the
        # per-key token buckets, requests shed because their deadline had
        # already passed, and streams aborted by the write timeout
        # (stalled/slow-loris clients)
        self._ratelimit_rejections: dict[str, int] = defaultdict(int)
        self._deadline_shed: dict[str, int] = defaultdict(int)
        self._stream_write_timeouts: dict[str, int] = defaultdict(int)
        # durable streams (gateway/replay.py, docs/resilience.md): mid-stream
        # cuts replayed onto another engine, by outcome — "success" (the
        # continuation spliced into the client stream), or why the gateway
        # gave up and emitted the terminal error frame instead ("exhausted"
        # attempts, "budget" refused, "no_endpoint", "failed" resume POST)
        self._stream_resumes: dict[str, int] = defaultdict(int)
        # committed tokens replayed onto the resuming engine (the work the
        # failover saved the client from losing)
        self._stream_resumed_tokens: dict[str, int] = defaultdict(int)

    # ------------------------------------------------------------ recorders

    def record_request(self, route: str, status: int) -> None:
        with self._lock:
            self._requests[(route, status)] += 1
            if status >= 400:
                self._errors[route] += 1

    def record_retry(self, api: str) -> None:
        """One admission re-attempt after parking on the queue, labeled by
        API kind ('chat', 'completion', ...) — the admission queue sits below
        route matching and never sees the route pattern."""
        with self._lock:
            self._retries[api] += 1

    def record_queue_timeout(self, model: str) -> None:
        with self._lock:
            self._queue_timeouts[model] += 1

    # --------------------------------------------------- resilience recorders

    def record_failover_retry(self, model: str, reason: str) -> None:
        """One in-band failover retry: the request is being re-run against a
        different endpoint after `reason` (connect_error/timeout/http_5xx/
        http_429/stream_pre_byte)."""
        with self._lock:
            self._failover_retries[(model, reason)] += 1

    def record_failover_recovery(self, model: str) -> None:
        """A request that failed on >= 1 endpoint ultimately succeeded —
        the failure the client never saw."""
        with self._lock:
            self._failover_recoveries[model] += 1

    def record_retry_budget_exhausted(self) -> None:
        with self._lock:
            self._retry_budget_exhausted += 1

    def record_breaker_transition(self, endpoint: str, to_state: str) -> None:
        with self._lock:
            self._breaker_transitions[(endpoint, to_state)] += 1

    def set_breaker_state(self, endpoint: str, code: int) -> None:
        """Current breaker state per endpoint: 0=closed, 1=half_open, 2=open."""
        with self._lock:
            self._breaker_state[endpoint] = code

    def clear_breaker_state(self, endpoint: str) -> None:
        """Endpoint deleted: stop exporting its state gauge (a frozen open
        reading would alert on a nonexistent endpoint forever). Transition
        counters stay — they are history, not state."""
        with self._lock:
            self._breaker_state.pop(endpoint, None)

    def record_stream_interruption(self, model: str, endpoint: str) -> None:
        with self._lock:
            self._stream_interruptions[(model, endpoint)] += 1

    def record_fault_injected(self, kind: str) -> None:
        with self._lock:
            self._faults_injected[kind] += 1

    def record_rebalance_migration(self, reason: str, outcome: str) -> None:
        """One proactive migration attempt resolved by the rebalancer;
        reason is hotspot / drain / restart, outcome is success (stream now
        lives on the target), refused (target would not adopt; stream stayed
        put), aborted (mid-flight failure, fell back to the reactive resume
        path) or skipped (budget / window guard)."""
        with self._lock:
            self._rebalance_migrations[(reason, outcome)] += 1

    def observe_gossip_lag(self, seconds: float) -> None:
        """One-way delivery delay of one received gossip message."""
        with self._lock:
            self._gossip_lag.observe(max(0.0, seconds))

    def record_structured_request(self, kind: str) -> None:
        """One request asking for constrained decoding; `kind` is
        json_object / json_schema / tool_call."""
        with self._lock:
            self._structured_requests[kind] += 1

    def record_structured_rejected(self) -> None:
        """Gateway-side validation refused a structured request (400)."""
        with self._lock:
            self._structured_rejected += 1

    def record_lora_route(self, route: str) -> None:
        """One adapter-naming request routed: hot / load / rejected
        (docs/lora.md)."""
        with self._lock:
            self._lora_requests[route] += 1

    def record_handoff(self, outcome: str) -> None:
        """One orchestrated prefill→decode handoff; outcome is "adopted"
        (decode-capable endpoint took the stream) or "self" (fallback:
        the prefill endpoint adopted its own payload)."""
        with self._lock:
            self._handoffs[outcome] += 1

    def record_ratelimit_rejection(self, reason: str) -> None:
        """One 429 from the per-key token buckets; reason is 'requests'
        (rps bucket) or 'tokens' (tokens/minute bucket)."""
        with self._lock:
            self._ratelimit_rejections[reason] += 1

    def record_deadline_shed(self, model: str) -> None:
        """A request shed at the gateway because its deadline had already
        passed (queue wait ate the budget) — no prefill was burned."""
        with self._lock:
            self._deadline_shed[model] += 1

    def record_stream_write_timeout(self, model: str) -> None:
        """A stream aborted because the client stopped draining it for
        longer than the write timeout (slow-loris protection)."""
        with self._lock:
            self._stream_write_timeouts[model] += 1

    def record_stream_resume(self, outcome: str) -> None:
        """One mid-stream resume attempt resolved; outcome is "success"
        (continuation spliced) or the give-up reason (exhausted / budget /
        no_endpoint / failed)."""
        with self._lock:
            self._stream_resumes[outcome] += 1

    def record_stream_resumed_tokens(self, model: str, n: int) -> None:
        """Committed tokens replayed onto the resuming engine."""
        if n <= 0:
            return
        with self._lock:
            self._stream_resumed_tokens[model] += n

    def record_slo(self, model: str, ttft_s: float | None,
                   itl_mean_s: float | None,
                   priority: str | None = None) -> None:
        """Judge one SUCCESSFUL inference request against its model's SLO
        targets. `ttft_s` is client-observed time to first byte/response;
        `itl_mean_s` is the mean inter-token gap over the stream (None for
        non-streaming or single-token responses — only the TTFT target
        applies then). Failed requests are never goodput, but they are
        already counted by errors_total; this ledger answers the narrower
        'of the requests that succeeded, how many were fast enough'."""
        if self.slo is None or not self.slo.enabled or ttft_s is None:
            return
        ttft_target, itl_target = self.slo.targets_for(model)
        ttft_miss = ttft_s > ttft_target
        itl_miss = itl_mean_s is not None and itl_mean_s > itl_target
        with self._lock:
            self._slo_eligible[model] += 1
            if ttft_miss:
                self._slo_ttft_miss[model] += 1
            if itl_miss:
                self._slo_itl_miss[model] += 1
            if not (ttft_miss or itl_miss):
                self._slo_met[model] += 1
            if priority is not None:
                self._slo_prio_eligible[priority] += 1
                if not (ttft_miss or itl_miss):
                    self._slo_prio_met[priority] += 1

    def _observe(self, table: dict, buckets: tuple[float, ...],
                 model: str, endpoint: str, seconds: float) -> None:
        with self._lock:
            hist = table.get((model, endpoint))
            if hist is None:
                hist = table[(model, endpoint)] = Histogram(buckets)
            hist.observe(seconds)

    def record_ttft(self, model: str, endpoint: str, seconds: float) -> None:
        self._observe(self._ttft, TTFT_BUCKETS, model, endpoint, seconds)

    def record_e2e(self, model: str, endpoint: str, seconds: float) -> None:
        self._observe(self._e2e, E2E_BUCKETS, model, endpoint, seconds)

    def record_queue_wait(self, model: str, endpoint: str,
                          seconds: float) -> None:
        self._observe(self._queue_wait, QUEUE_WAIT_BUCKETS, model, endpoint,
                      seconds)

    # ----------------------------------------------------------- exposition

    def summary(self) -> dict:
        """Compact JSON figures (bench tooling + dashboard overview)."""
        with self._lock:
            def pcts(table: dict) -> dict:
                merged: Histogram | None = None
                for hist in table.values():
                    if merged is None:
                        merged = Histogram(hist.edges)
                    for i, c in enumerate(hist.counts):
                        merged.counts[i] += c
                    merged.total += hist.total
                    merged.n += hist.n
                    merged.max = max(merged.max, hist.max)
                if merged is None:
                    return {"p50": None, "p99": None, "count": 0}
                return {"p50": merged.percentile(50),
                        "p99": merged.percentile(99), "count": merged.n}

            return {
                "requests_total": sum(self._requests.values()),
                "errors_total": sum(self._errors.values()),
                "retries_total": sum(self._retries.values()),
                "queue_timeouts_total": sum(self._queue_timeouts.values()),
                "failover_retries_total": sum(self._failover_retries.values()),
                "failover_recoveries_total":
                    sum(self._failover_recoveries.values()),
                "stream_interruptions_total":
                    sum(self._stream_interruptions.values()),
                "faults_injected_total": sum(self._faults_injected.values()),
                "structured_requests_total":
                    sum(self._structured_requests.values()),
                "structured_rejected_total": self._structured_rejected,
                "lora_requests_total": sum(self._lora_requests.values()),
                "handoffs_total": sum(self._handoffs.values()),
                "slo_eligible_total": sum(self._slo_eligible.values()),
                "slo_met_total": sum(self._slo_met.values()),
                "ratelimit_rejections_total":
                    sum(self._ratelimit_rejections.values()),
                "deadline_shed_total": sum(self._deadline_shed.values()),
                "stream_write_timeouts_total":
                    sum(self._stream_write_timeouts.values()),
                "stream_resumes": dict(self._stream_resumes),
                "rebalance_migrations": {
                    f"{reason}/{outcome}": n
                    for (reason, outcome), n
                    in sorted(self._rebalance_migrations.items())
                },
                "stream_resumed_tokens_total":
                    sum(self._stream_resumed_tokens.values()),
                "goodput_by_priority": {
                    prio: round(self._slo_prio_met.get(prio, 0) / n, 4)
                    for prio, n in self._slo_prio_eligible.items() if n
                },
                "goodput_ratio": (
                    round(sum(self._slo_met.values())
                          / sum(self._slo_eligible.values()), 4)
                    if self._slo_eligible else None
                ),
                "ttft_s": pcts(self._ttft),
                "e2e_s": pcts(self._e2e),
                "queue_wait_s": pcts(self._queue_wait),
            }

    def render(self, *, gauges: dict[str, float] | None = None,
               counters: dict[str, float] | None = None) -> str:
        """Prometheus text exposition. `gauges`/`counters` hold scrape-time
        figures owned elsewhere (load manager, admission queue, event bus)."""
        with self._lock:
            lines = ["# TYPE llmlb_gateway_requests_total counter"]
            for (route, status), n in sorted(self._requests.items()):
                lines.append(
                    f'llmlb_gateway_requests_total{{route="{_escape(route)}",'
                    f'status="{status}"}} {n}'
                )
            lines.append("# TYPE llmlb_gateway_errors_total counter")
            for route, n in sorted(self._errors.items()):
                lines.append(
                    f'llmlb_gateway_errors_total{{route="{_escape(route)}"}} {n}'
                )
            lines.append("# TYPE llmlb_gateway_retries_total counter")
            for api, n in sorted(self._retries.items()):
                lines.append(
                    f'llmlb_gateway_retries_total{{api="{_escape(api)}"}} {n}'
                )
            lines.append("# TYPE llmlb_gateway_queue_timeouts_total counter")
            for model, n in sorted(self._queue_timeouts.items()):
                lines.append(
                    f'llmlb_gateway_queue_timeouts_total'
                    f'{{model="{_escape(model)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_failover_retries_total counter"
            )
            for (model, reason), n in sorted(self._failover_retries.items()):
                lines.append(
                    f'llmlb_gateway_failover_retries_total'
                    f'{{model="{_escape(model)}",reason="{_escape(reason)}"}}'
                    f' {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_failover_recoveries_total counter"
            )
            for model, n in sorted(self._failover_recoveries.items()):
                lines.append(
                    f'llmlb_gateway_failover_recoveries_total'
                    f'{{model="{_escape(model)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_retry_budget_exhausted_total counter"
            )
            lines.append(
                f"llmlb_gateway_retry_budget_exhausted_total "
                f"{self._retry_budget_exhausted}"
            )
            lines.append(
                "# TYPE llmlb_gateway_breaker_transitions_total counter"
            )
            for (endpoint, to), n in sorted(self._breaker_transitions.items()):
                lines.append(
                    f'llmlb_gateway_breaker_transitions_total'
                    f'{{endpoint="{_escape(endpoint)}",to="{_escape(to)}"}}'
                    f' {n}'
                )
            lines.append("# TYPE llmlb_gateway_breaker_state gauge")
            for endpoint, code in sorted(self._breaker_state.items()):
                lines.append(
                    f'llmlb_gateway_breaker_state'
                    f'{{endpoint="{_escape(endpoint)}"}} {code}'
                )
            lines.append(
                "# TYPE llmlb_gateway_stream_interruptions_total counter"
            )
            for (model, endpoint), n in sorted(
                self._stream_interruptions.items()
            ):
                lines.append(
                    f'llmlb_gateway_stream_interruptions_total'
                    f'{{model="{_escape(model)}",'
                    f'endpoint="{_escape(endpoint)}"}} {n}'
                )
            lines.append("# TYPE llmlb_gateway_faults_injected_total counter")
            for kind, n in sorted(self._faults_injected.items()):
                lines.append(
                    f'llmlb_gateway_faults_injected_total'
                    f'{{kind="{_escape(kind)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_rebalance_migrations_total counter"
            )
            for (reason, outcome), n in sorted(
                self._rebalance_migrations.items()
            ):
                lines.append(
                    f'llmlb_gateway_rebalance_migrations_total'
                    f'{{reason="{_escape(reason)}",'
                    f'outcome="{_escape(outcome)}"}} {n}'
                )
            lines.append("# TYPE llmlb_gateway_gossip_delay_seconds histogram")
            if self._gossip_lag.n > 0:
                cumulative = 0
                for i, edge in enumerate(self._gossip_lag.edges):
                    cumulative += self._gossip_lag.counts[i]
                    lines.append(
                        f'llmlb_gateway_gossip_delay_seconds_bucket'
                        f'{{le="{edge}"}} {cumulative}'
                    )
                cumulative += self._gossip_lag.counts[-1]
                lines.append(
                    f'llmlb_gateway_gossip_delay_seconds_bucket'
                    f'{{le="+Inf"}} {cumulative}'
                )
                lines.append(
                    f"llmlb_gateway_gossip_delay_seconds_sum "
                    f"{self._gossip_lag.total}"
                )
                lines.append(
                    f"llmlb_gateway_gossip_delay_seconds_count "
                    f"{self._gossip_lag.n}"
                )
            lines.append(
                "# TYPE llmlb_gateway_structured_requests_total counter"
            )
            for kind, n in sorted(self._structured_requests.items()):
                lines.append(
                    f'llmlb_gateway_structured_requests_total'
                    f'{{kind="{_escape(kind)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_structured_rejected_total counter"
            )
            lines.append(
                f"llmlb_gateway_structured_rejected_total "
                f"{self._structured_rejected}"
            )
            lines.append(
                "# TYPE llmlb_gateway_lora_requests_total counter"
            )
            for route, n in sorted(self._lora_requests.items()):
                lines.append(
                    f'llmlb_gateway_lora_requests_total'
                    f'{{route="{_escape(route)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_handoffs_total counter"
            )
            for outcome, n in sorted(self._handoffs.items()):
                lines.append(
                    f'llmlb_gateway_handoffs_total'
                    f'{{outcome="{_escape(outcome)}"}} {n}'
                )
            for fam, table in (
                ("llmlb_gateway_slo_eligible_total", self._slo_eligible),
                ("llmlb_gateway_slo_met_total", self._slo_met),
                ("llmlb_gateway_slo_ttft_miss_total", self._slo_ttft_miss),
                ("llmlb_gateway_slo_itl_miss_total", self._slo_itl_miss),
            ):
                lines.append(f"# TYPE {fam} counter")
                for model, n in sorted(table.items()):
                    lines.append(f'{fam}{{model="{_escape(model)}"}} {n}')
            lines.append("# TYPE llmlb_gateway_goodput_ratio gauge")
            for model, eligible in sorted(self._slo_eligible.items()):
                if eligible > 0:
                    ratio = self._slo_met.get(model, 0) / eligible
                    lines.append(
                        f'llmlb_gateway_goodput_ratio'
                        f'{{model="{_escape(model)}"}} {round(ratio, 6)}'
                    )
            for fam, table in (
                ("llmlb_gateway_slo_priority_eligible_total",
                 self._slo_prio_eligible),
                ("llmlb_gateway_slo_priority_met_total", self._slo_prio_met),
            ):
                lines.append(f"# TYPE {fam} counter")
                for prio, n in sorted(table.items()):
                    lines.append(
                        f'{fam}{{priority="{_escape(prio)}"}} {n}'
                    )
            lines.append(
                "# TYPE llmlb_gateway_goodput_by_priority gauge"
            )
            for prio, eligible in sorted(self._slo_prio_eligible.items()):
                if eligible > 0:
                    ratio = self._slo_prio_met.get(prio, 0) / eligible
                    lines.append(
                        f'llmlb_gateway_goodput_by_priority'
                        f'{{priority="{_escape(prio)}"}} {round(ratio, 6)}'
                    )
            lines.append(
                "# TYPE llmlb_gateway_ratelimit_rejections_total counter"
            )
            for reason, n in sorted(self._ratelimit_rejections.items()):
                lines.append(
                    f'llmlb_gateway_ratelimit_rejections_total'
                    f'{{reason="{_escape(reason)}"}} {n}'
                )
            lines.append("# TYPE llmlb_gateway_deadline_shed_total counter")
            for model, n in sorted(self._deadline_shed.items()):
                lines.append(
                    f'llmlb_gateway_deadline_shed_total'
                    f'{{model="{_escape(model)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_stream_write_timeouts_total counter"
            )
            for model, n in sorted(self._stream_write_timeouts.items()):
                lines.append(
                    f'llmlb_gateway_stream_write_timeouts_total'
                    f'{{model="{_escape(model)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_stream_resumes_total counter"
            )
            for outcome, n in sorted(self._stream_resumes.items()):
                lines.append(
                    f'llmlb_gateway_stream_resumes_total'
                    f'{{outcome="{_escape(outcome)}"}} {n}'
                )
            lines.append(
                "# TYPE llmlb_gateway_stream_resumed_tokens_total counter"
            )
            for model, n in sorted(self._stream_resumed_tokens.items()):
                lines.append(
                    f'llmlb_gateway_stream_resumed_tokens_total'
                    f'{{model="{_escape(model)}"}} {n}'
                )
            for name, table in (
                ("llmlb_gateway_ttft_seconds", self._ttft),
                ("llmlb_gateway_e2e_seconds", self._e2e),
                ("llmlb_gateway_queue_wait_seconds", self._queue_wait),
            ):
                lines.append(f"# TYPE {name} histogram")
                for (model, endpoint), hist in sorted(table.items()):
                    labels = (f'model="{_escape(model)}",'
                              f'endpoint="{_escape(endpoint)}"')
                    cumulative = 0
                    for i, edge in enumerate(hist.edges):
                        cumulative += hist.counts[i]
                        lines.append(
                            f'{name}_bucket{{{labels},le="{edge}"}} '
                            f'{cumulative}'
                        )
                    cumulative += hist.counts[-1]
                    lines.append(
                        f'{name}_bucket{{{labels},le="+Inf"}} {cumulative}'
                    )
                    lines.append(f"{name}_sum{{{labels}}} {hist.total}")
                    lines.append(f"{name}_count{{{labels}}} {hist.n}")
            for cname, value in sorted((counters or {}).items()):
                lines.append(f"# TYPE {cname} counter")
                lines.append(f"{cname} {value}")
            for gname, value in sorted((gauges or {}).items()):
                lines.append(f"# TYPE {gname} gauge")
                lines.append(f"{gname} {value}")
            return "\n".join(lines) + "\n"
