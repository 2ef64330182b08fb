"""Engine Prometheus metrics: counters, gauges and latency histograms.

Counterpart of `llmlb_tpu/engine/metrics.py`: the same bucket edges, the
same `record_*` hooks, and `summary()` / `render()` under the reference's
series names. One tally per count: the events the scheduler already counts
(prefix cache, KV shipping, structured outputs, speculation, overload
protection) stay in its counter classes, and `summary` and `render` read
them from `EngineCore.stats()`, so `/metrics`, `/api/health` and
`core.stats()` cannot disagree. What no other class counts lives here:
requests by outcome, tokens, the latency and step histograms, the decode
dispatch tallies, the adapters' load histogram and per-adapter requests,
the step-phase histograms, and the disaggregation's handoffs by kind, their
latency and the staged backlog.

The context-parallel fallback is always 0 (the port prefills on one
device).
"""

from __future__ import annotations

import threading

from llmlb_tpu_torch.engine.stepstats import PHASES

# Bucket edges in seconds, the reference's: TTFT goals are tens of ms
# (one-shot prefill) to seconds (chunked long prompts); ITL goals are
# single-digit ms.
TTFT_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
ITL_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 1.0)
# per-dispatch step durations: prefill tens of ms to seconds, a decode step
# (burst-amortized) single-digit ms
STEP_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5)
# schema -> DFA -> mask-table compiles and adapter loads
COMPILE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0)
# step-phase breakdown (engine/stepstats.py): host phases tens of µs to low
# ms; compute µs (CPU debug configs) to hundreds of ms (prefill chunks)
PHASE_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                 0.025, 0.05, 0.1, 0.25, 0.5, 1.0)


class Histogram:
    def __init__(self, buckets: tuple[float, ...]):
        self.edges = tuple(buckets)
        self.counts = [0] * (len(buckets) + 1)  # last = +Inf
        self.total = 0.0
        self.n = 0
        self.max = 0.0

    def observe(self, value: float) -> None:
        for i, edge in enumerate(self.edges):
            if value <= edge:
                self.counts[i] += 1
                break
        else:
            self.counts[-1] += 1
        self.total += value
        self.n += 1
        if value > self.max:
            self.max = value

    def percentile(self, pct: float) -> float | None:
        """Approximate percentile, linearly interpolated within the landing
        bucket (None if empty); above the top edge, the max observed (a
        finite, JSON-safe figure)."""
        if self.n == 0:
            return None
        target = self.n * pct / 100.0
        seen = 0
        lower = 0.0
        for i, edge in enumerate(self.edges):
            count = self.counts[i]
            if count and seen + count >= target:
                frac = (target - seen) / count
                return lower + frac * (edge - lower)
            seen += count
            lower = edge
        return max(self.edges[-1], self.max)


def _render_histogram(lines: list, name: str, hist: Histogram,
                      label: str = "") -> None:
    """One histogram family in Prometheus exposition form (cumulative
    buckets, +Inf, sum, count); `label` is a pre-rendered `k="v"` pair."""
    brace = f"{{{label},le=" if label else "{le="
    cumulative = 0
    for i, edge in enumerate(hist.edges):
        cumulative += hist.counts[i]
        lines.append(f'{name}_bucket{brace}"{edge}"}} {cumulative}')
    cumulative += hist.counts[-1]
    lines.append(f'{name}_bucket{brace}"+Inf"}} {cumulative}')
    suffix = f"{{{label}}}" if label else ""
    lines.append(f"{name}_sum{suffix} {hist.total}")
    lines.append(f"{name}_count{suffix} {hist.n}")


def _series(lines: list, kind: str, pairs) -> None:
    """`# TYPE` and value lines for unlabelled series of one kind."""
    for name, value in pairs:
        lines += [f"# TYPE {name} {kind}", f"{name} {value}"]


class EngineMetrics:
    _LORA_LABEL_CAP = 64

    def __init__(self):
        self._lock = threading.Lock()
        self.requests_total = 0
        self.tokens_total = 0
        self.errors_total = 0
        self.cancelled_total = 0
        self.ttft = Histogram(TTFT_BUCKETS)
        self.itl = Histogram(ITL_BUCKETS)
        self.prefill_step = Histogram(STEP_BUCKETS)
        self.decode_step = Histogram(STEP_BUCKETS)
        self.batch_occupancy = 0
        self.schema_compile = Histogram(COMPILE_BUCKETS)
        # decode and verify steps run as one graph replay, and the model
        # step calls every decode-loop step issued
        self.fused_decode_steps_total = 0
        self.decode_dispatches_total = 0
        # adapter loads' seconds and requests per adapter (capped labels);
        # the load and eviction counts are the LoraManager's
        self.lora_load = Histogram(COMPILE_BUCKETS)
        self.lora_requests_total: dict[str, int] = {}
        self.step_phase: dict[str, Histogram] = {
            p: Histogram(PHASE_BUCKETS) for p in PHASES}
        # Disaggregated prefill/decode: handoffs by kind (in_process, split
        # mode's page-id exchange; emitted, a prefill engine handed a stream
        # away; adopted, a decode engine took one), the latency between a
        # request's prefill completing and its adoption, and the staged
        # requests waiting for a decode slot now.
        self.handoff_total: dict[str, int] = {
            "in_process": 0, "emitted": 0, "adopted": 0}
        self.handoff_latency = Histogram(STEP_BUCKETS)
        self.handoff_backlog = 0

    # ------------------------------------------------------------ recorders

    def record_ttft(self, seconds: float) -> None:
        with self._lock:
            self.ttft.observe(seconds)

    def record_emit(self, itl_seconds: float | None) -> None:
        """One locked update a token: the token, and its inter-token gap
        (None for a row's first token)."""
        with self._lock:
            self.tokens_total += 1
            if itl_seconds is not None:
                self.itl.observe(itl_seconds)

    def record_prefill_step(self, seconds: float) -> None:
        with self._lock:
            self.prefill_step.observe(seconds)

    def record_decode_step(self, seconds: float, active_slots: int) -> None:
        with self._lock:
            self.decode_step.observe(seconds)
            self.batch_occupancy = active_slots

    def set_batch_occupancy(self, active_slots: int) -> None:
        with self._lock:
            self.batch_occupancy = active_slots

    def record_schema_compile(self, seconds: float) -> None:
        with self._lock:
            self.schema_compile.observe(seconds)

    def record_decode_dispatches(self, n: int, fused: bool = False) -> None:
        """Model step calls of one decode-loop step (decode or verify);
        `fused` marks a step that ran as one graph replay."""
        with self._lock:
            self.decode_dispatches_total += max(0, int(n))
            if fused:
                self.fused_decode_steps_total += 1

    def record_step_phases(self, phases: dict[str, float]) -> None:
        """One locked update a step; zero-duration phases stay out of the
        histograms. (The slow-step count is the StepRecorder's.)"""
        with self._lock:
            for name, seconds in phases.items():
                hist = self.step_phase.get(name)
                if hist is not None and seconds > 0.0:
                    hist.observe(seconds)

    def record_handoff(self, kind: str, latency_s: float | None = None) -> None:
        """One prefill-to-decode handoff of `kind`; `latency_s` is the
        prefill-complete to adoption gap (None for "emitted": the prefill
        side cannot see the adoption)."""
        with self._lock:
            if kind in self.handoff_total:
                self.handoff_total[kind] += 1
            if latency_s is not None and latency_s >= 0.0:
                self.handoff_latency.observe(latency_s)

    def set_handoff_backlog(self, n: int) -> None:
        with self._lock:
            self.handoff_backlog = n

    def handoff_counts(self) -> tuple[dict[str, int], int]:
        """(handoffs by kind, the staged backlog), read together."""
        with self._lock:
            return dict(self.handoff_total), self.handoff_backlog

    def record_lora_load(self, seconds: float) -> None:
        with self._lock:
            self.lora_load.observe(seconds)

    def record_lora_request(self, adapter: str) -> None:
        """Per-adapter requests; past _LORA_LABEL_CAP names, further ones
        fold into "_other"."""
        with self._lock:
            if (adapter not in self.lora_requests_total
                    and len(self.lora_requests_total) >= self._LORA_LABEL_CAP):
                adapter = "_other"
            self.lora_requests_total[adapter] = (
                self.lora_requests_total.get(adapter, 0) + 1)

    def record_request_done(self, finish: str) -> None:
        with self._lock:
            self.requests_total += 1
            if finish == "cancelled":
                self.cancelled_total += 1
            elif finish == "error":
                self.errors_total += 1

    # ----------------------------------------------------------- exposition

    def summary(self, stats, lora: dict | None = None) -> dict:
        """Compact JSON figures for /api/health, the reference's keys.
        `stats` is `EngineCore.stats()`, `lora` its
        lora_info()."""
        pc, kv, st, sp = stats.prefix, stats.kv, stats.structured, stats.spec
        lora = lora or {}
        with self._lock:
            return {
                "requests_total": self.requests_total,
                "tokens_total": self.tokens_total,
                "errors_total": self.errors_total,
                "cancelled_total": self.cancelled_total,
                "ttft_p50_s": self.ttft.percentile(50),
                "ttft_p99_s": self.ttft.percentile(99),
                "itl_p50_s": self.itl.percentile(50),
                "itl_p99_s": self.itl.percentile(99),
                "prefix_hits_total": pc.prefix_hits_total,
                "prefix_misses_total": pc.prefix_misses_total,
                "prefix_cached_tokens_total": pc.prefix_cached_tokens_total,
                "prefix_evictions_total": pc.prefix_evictions_total,
                "structured_requests_total": st.structured_requests_total,
                "constraint_violations_total": st.constraint_violations_total,
                "schema_compile_p50_s": self.schema_compile.percentile(50),
                "spec_verify_steps_total": sp.verify_steps_total,
                "spec_draft_tokens_total": sp.draft_tokens_total,
                "spec_accepted_tokens_total": sp.accepted_tokens_total,
                "spec_acceptance_rate": sp.acceptance_rate,
                "fused_decode_steps_total": self.fused_decode_steps_total,
                "decode_dispatches_total": self.decode_dispatches_total,
                "constrained_burst_fallback_total":
                    st.constrained_burst_fallback_total,
                "preemptions_total": stats.preemptions_total,
                "preempt_resumes_total": stats.preempt_resumes_total,
                "deadline_shed_total": stats.deadline_shed_total,
                "handoff_total": dict(self.handoff_total),
                "handoff_backlog": self.handoff_backlog,
                "handoff_latency_p50_s": self.handoff_latency.percentile(50),
                "drain_state": int(stats.draining),
                "drain_parked_total": stats.drain_parked_total,
                "kv_ship_total": kv.kv_ship_total,
                "kv_ship_bytes_total": kv.kv_ship_bytes_total,
                "kv_restored_total": kv.kv_restored_total,
                "kv_ship_fallback_total": dict(kv.kv_ship_fallback_total),
                "lora_loads_total": lora.get("loads_total", 0),
                "lora_evictions_total": lora.get("evictions_total", 0),
            }

    def render(self, stats, *, prefix_cache: dict | None = None,
               kv_cache: dict | None = None,
               structured: dict | None = None,
               perf: dict | None = None,
               quant: dict | None = None,
               sched: dict | None = None,
               lora: dict | None = None,
               flightrec: dict | None = None,
               kv_offload: dict | None = None) -> str:
        """Prometheus text exposition. `stats` is `EngineCore.stats()` (the
        event counters the scheduler keeps, and the queue and slot
        figures); the blocks are the core's *_info() dicts, as in the
        reference: each family renders when its block says it is on."""
        pc, kv, st, sp = stats.prefix, stats.kv, stats.structured, stats.spec
        lines: list[str] = []
        with self._lock:
            _series(lines, "counter", (
                ("llmlb_engine_requests_total", self.requests_total),
                ("llmlb_engine_tokens_total", self.tokens_total),
                ("llmlb_engine_errors_total", self.errors_total),
                ("llmlb_engine_cancelled_total", self.cancelled_total)))
            _series(lines, "gauge", (
                ("llmlb_engine_queue_depth", stats.queued),
                ("llmlb_engine_active_slots", stats.active_slots),
                ("llmlb_engine_num_slots", stats.num_slots),
                ("llmlb_engine_batch_occupancy", self.batch_occupancy)))
            _series(lines, "counter", (
                ("llmlb_engine_prefix_cache_hits_total", pc.prefix_hits_total),
                ("llmlb_engine_prefix_cache_misses_total",
                 pc.prefix_misses_total),
                ("llmlb_engine_prefix_cache_cached_tokens_total",
                 pc.prefix_cached_tokens_total),
                ("llmlb_engine_prefix_cache_insertions_total",
                 pc.prefix_insertions_total),
                ("llmlb_engine_prefix_cache_inserted_tokens_total",
                 pc.prefix_inserted_tokens_total),
                ("llmlb_engine_prefix_cache_evictions_total",
                 pc.prefix_evictions_total),
                ("llmlb_engine_structured_requests_total",
                 st.structured_requests_total),
                ("llmlb_engine_masked_decode_steps_total",
                 st.masked_decode_steps_total),
                ("llmlb_engine_constraint_violations_total",
                 st.constraint_violations_total),
                ("llmlb_engine_mask_cache_hits_total", st.mask_cache_hits_total),
                ("llmlb_engine_mask_cache_misses_total",
                 st.mask_cache_misses_total),
                ("llmlb_engine_mask_cache_evictions_total",
                 st.mask_cache_evictions_total),
                ("llmlb_engine_slow_steps_total", stats.slow_steps_total),
                ("llmlb_engine_spec_verify_steps_total", sp.verify_steps_total),
                ("llmlb_engine_spec_draft_tokens_total", sp.draft_tokens_total),
                ("llmlb_engine_spec_accepted_tokens_total",
                 sp.accepted_tokens_total),
                ("llmlb_engine_spec_emitted_tokens_total",
                 sp.emitted_tokens_total),
                ("llmlb_engine_fused_decode_steps_total",
                 self.fused_decode_steps_total),
                ("llmlb_engine_decode_dispatches_total",
                 self.decode_dispatches_total),
                ("llmlb_engine_constrained_burst_fallback_total",
                 st.constrained_burst_fallback_total),
                ("llmlb_engine_preemptions_total", stats.preemptions_total),
                ("llmlb_engine_preempt_resumes_total",
                 stats.preempt_resumes_total),
                ("llmlb_engine_deadline_shed_total",
                 stats.deadline_shed_total)))
            lines.append("# TYPE llmlb_engine_handoff_total counter")
            for kind, n in self.handoff_total.items():
                lines.append(f'llmlb_engine_handoff_total{{kind="{kind}"}} {n}')
            _series(lines, "gauge", (
                ("llmlb_engine_handoff_backlog", self.handoff_backlog),
                ("llmlb_engine_drain_state", int(stats.draining))))
            _series(lines, "counter", (
                ("llmlb_engine_drain_parked_total", stats.drain_parked_total),
                ("llmlb_engine_kv_ship_total", kv.kv_ship_total),
                ("llmlb_engine_kv_ship_bytes_total", kv.kv_ship_bytes_total),
                ("llmlb_engine_kv_ship_seconds_total",
                 kv.kv_ship_seconds_total),
                ("llmlb_engine_kv_restored_total", kv.kv_restored_total),
                ("llmlb_engine_kv_restored_bytes_total",
                 kv.kv_restored_bytes_total)))
            lines.append("# TYPE llmlb_engine_kv_ship_fallback_total counter")
            for reason, n in kv.kv_ship_fallback_total.items():
                lines.append(f'llmlb_engine_kv_ship_fallback_total'
                             f'{{reason="{reason}"}} {n}')
            if kv_offload is not None and kv_offload.get("enabled"):
                _series(lines, "gauge", (
                    ("llmlb_engine_kv_offload_budget_bytes",
                     kv_offload.get("budget_bytes", 0)),
                    ("llmlb_engine_kv_offload_bytes",
                     kv_offload.get("bytes", 0)),
                    ("llmlb_engine_kv_offload_entries",
                     kv_offload.get("entries", 0))))
                _series(lines, "counter", (
                    (f"llmlb_engine_kv_offload_{key}_total",
                     kv_offload.get(key, 0))
                    for key in ("hits", "misses", "spills", "evictions",
                                "spilled_bytes", "restored_bytes")))
            if sched is not None:
                lines.append("# TYPE llmlb_engine_queue_depth_class gauge")
                for name, depth in sorted(
                        (sched.get("queued_by_class") or {}).items()):
                    lines.append(f'llmlb_engine_queue_depth_class'
                                 f'{{priority="{name}"}} {depth}')
                by_role = sched.get("queued_by_role")
                if by_role:
                    # split engines only: work waiting for a prefill slot,
                    # and staged work waiting for a decode slot
                    lines.append("# TYPE llmlb_engine_queue_depth_role gauge")
                    for name, depth in sorted(by_role.items()):
                        lines.append(f'llmlb_engine_queue_depth_role'
                                     f'{{role="{name}"}} {depth}')
            if lora is not None and lora.get("enabled"):
                _series(lines, "gauge", (
                    ("llmlb_engine_lora_loaded",
                     len(lora.get("resident") or ())),
                    ("llmlb_engine_lora_available",
                     len(lora.get("available") or ())),
                    ("llmlb_engine_lora_max_adapters",
                     lora.get("max_adapters", 0))))
                _series(lines, "counter", (
                    ("llmlb_engine_lora_loads_total",
                     lora.get("loads_total", 0)),
                    ("llmlb_engine_lora_evictions_total",
                     lora.get("evictions_total", 0)),
                    ("llmlb_engine_lora_cp_fallback_total",
                     lora.get("cp_fallback_total", 0))))
                if self.lora_requests_total:
                    lines.append(
                        "# TYPE llmlb_engine_lora_requests_total counter")
                    for name, count in sorted(self.lora_requests_total.items()):
                        lines.append('llmlb_engine_lora_requests_total'
                                     f'{{adapter="{name}"}} {count}')
                hname = "llmlb_engine_lora_load_seconds"
                lines.append(f"# TYPE {hname} histogram")
                _render_histogram(lines, hname, self.lora_load)
            if flightrec is not None and flightrec.get("enabled"):
                _series(lines, "counter", (
                    ("llmlb_engine_flightrec_events_total",
                     flightrec.get("events_total", 0)),
                    ("llmlb_engine_flightrec_events_dropped_total",
                     flightrec.get("events_dropped_total", 0))))
                _series(lines, "gauge", (
                    ("llmlb_engine_flightrec_requests_tracked",
                     flightrec.get("requests_tracked", 0)),))
                _series(lines, "counter", (
                    ("llmlb_engine_flightrec_queue_seconds_total",
                     flightrec.get("queue_seconds_total", 0.0)),
                    ("llmlb_engine_flightrec_service_seconds_total",
                     flightrec.get("service_seconds_total", 0.0))))
            if perf is not None and perf.get("available"):
                _series(lines, "gauge", (
                    ("llmlb_engine_mfu_ratio", perf["mfu"]),
                    ("llmlb_engine_hbm_bw_utilization_ratio",
                     perf["hbm_bw_utilization"]),
                    ("llmlb_engine_model_flops_per_token",
                     perf["flops_per_token"]),
                    ("llmlb_engine_model_bytes_per_token",
                     perf["bytes_per_token"])))
            if structured is not None and structured.get("enabled"):
                _series(lines, "gauge", (
                    ("llmlb_engine_mask_cache_entries",
                     structured["mask_cache_entries"]),
                    ("llmlb_engine_mask_cache_bytes",
                     structured["mask_cache_bytes"])))
            if prefix_cache is not None and prefix_cache.get("enabled"):
                _series(lines, "gauge", (
                    ("llmlb_engine_prefix_cache_entries",
                     prefix_cache["entries"]),
                    ("llmlb_engine_prefix_cache_pinned_slots",
                     prefix_cache["pinned_slots"]),
                    ("llmlb_engine_prefix_cache_pinned_hbm_bytes",
                     prefix_cache["pinned_hbm_bytes"])))
                if "pinned_pages" in prefix_cache:
                    _series(lines, "gauge", (
                        ("llmlb_engine_prefix_cache_pinned_pages",
                         prefix_cache["pinned_pages"]),))
            if quant is not None:
                lines.append("# TYPE llmlb_engine_quant_mode gauge")
                for mode in ("off", "weights", "kv", "all"):
                    lines.append(f'llmlb_engine_quant_mode{{mode="{mode}"}} '
                                 f'{1 if quant.get("mode") == mode else 0}')
                _series(lines, "gauge", (
                    ("llmlb_engine_param_bytes", quant.get("param_bytes", 0)),))
            if kv_cache is not None:
                _series(lines, "gauge", (
                    ("llmlb_engine_kv_hbm_bytes", kv_cache.get("hbm_bytes", 0)),))
            if kv_cache is not None and kv_cache.get("layout") == "paged":
                _series(lines, "gauge", (
                    ("llmlb_engine_kv_bytes_per_page",
                     kv_cache.get("bytes_per_page", 0)),
                    ("llmlb_engine_kv_pages_total", kv_cache["pages_total"]),
                    ("llmlb_engine_kv_pages_free", kv_cache["pages_free"]),
                    ("llmlb_engine_kv_pages_active", kv_cache["pages_active"]),
                    ("llmlb_engine_kv_pages_pinned", kv_cache["pages_pinned"]),
                    ("llmlb_engine_kv_page_size_tokens",
                     kv_cache["page_size"]),
                    ("llmlb_engine_kv_pool_utilization_ratio",
                     kv_cache["utilization"]),
                    ("llmlb_engine_kv_page_fragmentation_ratio",
                     kv_cache["fragmentation"]),
                    ("llmlb_engine_kv_page_waste_tokens_mean",
                     kv_cache["waste_tokens_mean"])))
            for name, hist in (
                    ("llmlb_engine_ttft_seconds", self.ttft),
                    ("llmlb_engine_itl_seconds", self.itl),
                    ("llmlb_engine_prefill_step_seconds", self.prefill_step),
                    ("llmlb_engine_decode_step_seconds", self.decode_step),
                    ("llmlb_engine_schema_compile_seconds",
                     self.schema_compile),
                    ("llmlb_engine_handoff_latency_seconds",
                     self.handoff_latency)):
                lines.append(f"# TYPE {name} histogram")
                _render_histogram(lines, name, hist)
            # one family labelled by phase; empty phases render too, so
            # dashboards see the whole label set
            name = "llmlb_engine_step_phase_seconds"
            lines.append(f"# TYPE {name} histogram")
            for phase, hist in self.step_phase.items():
                _render_histogram(lines, name, hist, label=f'phase="{phase}"')
        return "\n".join(lines) + "\n"
