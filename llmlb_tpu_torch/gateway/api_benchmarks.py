"""TPS benchmark service: load-test endpoints through the normal routing path.

Parity with reference api/benchmarks.rs (start :250, concurrent execution
:371-404, per-request :408): POST /api/benchmarks/tps starts an async run of N
chat requests with bounded concurrency through the same selection pipeline real
traffic uses; results aggregate latency percentiles + TPS per endpoint and are
kept in a pruned in-memory store.

The port's copy of llmlb_tpu/gateway/api_benchmarks.py, on the standard
library's client (`gateway/http.py`). Like the reference, `_run_single`
catches only connection errors and timeouts: an upstream answering a body
that is not JSON raises out of the run, which then stays `running` with
its lease held (ROADMAP C17, held by
tests/test_torch_gateway_dashboard.py).
"""

from __future__ import annotations

import asyncio
import statistics
import time
import uuid

from llmlb_tpu_torch.gateway import http
from llmlb_tpu_torch.gateway.api_openai import select_endpoint_with_queue
from llmlb_tpu_torch.gateway.http import web
from llmlb_tpu_torch.gateway.token_accounting import extract_usage_from_response
from llmlb_tpu_torch.gateway.types import Capability, TpsApiKind

MAX_STORED_RUNS = 20


class BenchmarkStore:
    def __init__(self):
        self.runs: dict[str, dict] = {}

    def put(self, run_id: str, run: dict) -> None:
        self.runs[run_id] = run
        while len(self.runs) > MAX_STORED_RUNS:
            self.runs.pop(next(iter(self.runs)))


STORE = BenchmarkStore()


def _percentile(values: list[float], pct: float) -> float:
    if not values:
        return 0.0
    ordered = sorted(values)
    idx = min(int(len(ordered) * pct / 100.0), len(ordered) - 1)
    return ordered[idx]


async def _run_single(state, model: str, prompt: str, max_tokens: int) -> dict:
    start = time.monotonic()
    try:
        selection = await select_endpoint_with_queue(
            state, model, Capability.CHAT_COMPLETION, TpsApiKind.CHAT
        )
    except Exception:
        selection = None
    if selection is None:
        return {"ok": False, "error": "no endpoint", "endpoint_id": None}
    endpoint, engine_model, lease, _model_rec = selection
    # Benchmarks go through the real admission machinery, so on a half-open
    # breaker they consume the probe slot — every exit below must report an
    # outcome to the resilience manager or that slot would stay wedged.
    resilience = state.resilience
    headers = {}
    if endpoint.api_key:
        headers["Authorization"] = f"Bearer {endpoint.api_key}"
    try:
        async with state.http.post(
            endpoint.url + "/v1/chat/completions",
            json={
                "model": engine_model,
                "messages": [{"role": "user", "content": prompt}],
                "max_tokens": max_tokens,
                "temperature": 0.7,
            },
            headers=headers,
            timeout=http.ClientTimeout(total=state.config.inference_timeout_s),
        ) as resp:
            body = await resp.json(content_type=None)
            elapsed = time.monotonic() - start
            if resp.status != 200:
                lease.fail()
                if resilience is not None:
                    if (resp.status in resilience.config.retryable_statuses
                            and resp.status != 429):
                        resilience.record_failure(endpoint.id,
                                                  f"http_{resp.status}")
                    else:
                        resilience.record_success(endpoint.id)
                return {"ok": False, "error": f"HTTP {resp.status}",
                        "endpoint_id": endpoint.id,
                        "latency_ms": elapsed * 1000}
            usage = extract_usage_from_response(body) or (0, 0)
            lease.complete_with_tokens(*usage)
            if resilience is not None:
                resilience.record_success(endpoint.id)
            state.load_manager.note_endpoint_success(endpoint.id)
            return {
                "ok": True, "endpoint_id": endpoint.id,
                "latency_ms": elapsed * 1000,
                "completion_tokens": usage[1],
                "tps": usage[1] / elapsed if elapsed > 0 else 0.0,
            }
    except (http.ClientError, asyncio.TimeoutError, OSError) as e:
        lease.fail()
        if resilience is not None:
            resilience.record_failure(endpoint.id, "connect_error")
        state.load_manager.note_endpoint_failure(endpoint.id)
        return {"ok": False, "error": type(e).__name__,
                "endpoint_id": endpoint.id,
                "latency_ms": (time.monotonic() - start) * 1000}


async def _execute(state, run_id: str, model: str, requests: int,
                   concurrency: int, prompt: str, max_tokens: int) -> None:
    run = STORE.runs[run_id]
    sem = asyncio.Semaphore(concurrency)

    async def bounded() -> dict:
        async with sem:
            return await _run_single(state, model, prompt, max_tokens)

    started = time.monotonic()
    results = await asyncio.gather(*(bounded() for _ in range(requests)))
    elapsed = time.monotonic() - started

    ok = [r for r in results if r["ok"]]
    latencies = [r["latency_ms"] for r in ok]
    by_endpoint: dict[str, list[dict]] = {}
    for r in ok:
        by_endpoint.setdefault(r["endpoint_id"], []).append(r)

    run.update({
        "status": "completed",
        "completed_at": time.time(),
        "duration_s": round(elapsed, 3),
        "requests": requests,
        "succeeded": len(ok),
        "failed": len(results) - len(ok),
        "latency_ms": {
            "p50": round(_percentile(latencies, 50), 2),
            "p90": round(_percentile(latencies, 90), 2),
            "p99": round(_percentile(latencies, 99), 2),
            "mean": round(statistics.fmean(latencies), 2) if latencies else 0,
        },
        "throughput_rps": round(len(ok) / elapsed, 2) if elapsed > 0 else 0,
        "per_endpoint": {
            eid: {
                "requests": len(rs),
                "mean_tps": round(
                    statistics.fmean([r["tps"] for r in rs]), 2
                ) if rs else 0,
                "p50_latency_ms": round(
                    _percentile([r["latency_ms"] for r in rs], 50), 2
                ),
            }
            for eid, rs in by_endpoint.items()
        },
        "errors": [r["error"] for r in results if not r["ok"]][:10],
    })


async def start_tps_benchmark(request: web.Request) -> web.Response:
    state = request.app["state"]
    try:
        body = await request.json()
    except Exception:
        return web.json_response({"error": "invalid JSON body"}, status=400)
    model = body.get("model")
    if not model:
        return web.json_response({"error": "'model' is required"}, status=400)
    requests = min(int(body.get("requests", 10)), 1000)
    concurrency = min(int(body.get("concurrency", 4)), 64)
    prompt = body.get("prompt") or "Benchmark: write one sentence about TPUs."
    max_tokens = min(int(body.get("max_tokens", 64)), 2048)

    run_id = uuid.uuid4().hex
    STORE.put(run_id, {
        "run_id": run_id, "status": "running", "model": model,
        "started_at": time.time(),
    })
    asyncio.create_task(
        _execute(state, run_id, model, requests, concurrency, prompt, max_tokens)
    )
    return web.json_response({"run_id": run_id, "status": "running"}, status=202)


async def get_tps_benchmark(request: web.Request) -> web.Response:
    run = STORE.runs.get(request.match_info["run_id"])
    if run is None:
        return web.json_response({"error": "run not found"}, status=404)
    return web.json_response(run)


async def list_tps_benchmarks(request: web.Request) -> web.Response:
    return web.json_response({"runs": list(STORE.runs.values())})
