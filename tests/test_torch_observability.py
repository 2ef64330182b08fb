"""The port's observability layer against the JAX package's.

Unit twins of tests/engine/test_step_introspection.py and
tests/engine/test_flightrec.py: the same inputs go through both packages'
StepRecorder, FlightRecorder, Histogram and cost helpers, and the results
must be equal. Then one reference engine (the JAX package's debug-tiny
server) and one port engine serve the same requests, and the port's
`/api/steps`, `/api/requests/{id}/timeline`, `/metrics`, `/api/health`
and `/api/system` must carry the reference's shapes, series names and
status codes; `perf_info` must give the reference's figures on debug-tiny,
quantized and not; the flight recorder and the step records must hold on
the port's own rules (the lifecycle `ast` check, the dispatch check).
"""

import json
import re
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from llmlb_tpu.engine import flightrec as ref_fr
from llmlb_tpu.engine import metrics as ref_metrics
from llmlb_tpu.engine import stepstats as ref_ss
from llmlb_tpu.engine import telemetry as ref_tel
from llmlb_tpu_torch.engine import flightrec as fr
from llmlb_tpu_torch.engine import metrics as port_metrics
from llmlb_tpu_torch.engine import stepstats as ss
from llmlb_tpu_torch.engine import telemetry as tel

REPO = Path(__file__).resolve().parent.parent
BOTH_SS = pytest.mark.parametrize("mod", [ref_ss, ss], ids=["jax", "port"])
BOTH_FR = pytest.mark.parametrize("mod", [ref_fr, fr], ids=["jax", "port"])


def _strip(snap: dict) -> dict:
    """A snapshot without its wall-clock stamps and the port's device
    field, for comparison across the two recorders."""
    out = dict(snap)
    out["records"] = [{k: v for k, v in r.items()
                       if k not in ("ts", "device_ms")}
                      for r in snap["records"]]
    return out


# --------------------------------------------------------- step recorder


def _drive(mod, script):
    rec = mod.StepRecorder(**script.get("kw", {}))
    flags = [rec.observe(kind, phases, **kw)
             for kind, phases, kw in script["steps"]]
    return rec, flags


STEP_SCRIPTS = {
    "ring": {"kw": {"capacity": 4},
             "steps": [("decode", {"compute": 0.001}, {"tokens": 1})] * 10},
    "slow": {"kw": {"slow_floor_s": 0.0},
             "steps": [("decode", {"compute": 0.001}, {})] * 30
             + [("decode", {"compute": 0.040}, {})] * 2
             + [("prefill", {"compute": 0.5}, {})]},
    "warmup": {"kw": {"slow_floor_s": 0.0},
               "steps": [("decode", {"compute": 0.001 * (i + 1)}, {})
                         for i in range(10)]},
    "window": {"kw": {"window": 4},
               "steps": [("prefill", {"compute": 1.0}, {"tokens": 100})]
               + [("decode", {"compute": 0.01, "fetch": 0.01},
                   {"tokens": 8})] * 6
               + [("verify", {"draft": 0.001, "compute": 0.02},
                   {"tokens": 13, "dispatches": 1,
                    "request_ids": {"0": "a"}})]},
}


@pytest.mark.parametrize("name", sorted(STEP_SCRIPTS))
def test_step_recorder_matches_reference(name):
    """Ring wrap-around, the slow flag after warm-up (a flagged step does
    not feed the baseline), warm-up never flags, the decode and verify
    window: the same observations through both recorders give the same
    flags, window and snapshots (every limit, slow-only too)."""
    script = STEP_SCRIPTS[name]
    ref, ref_flags = _drive(ref_ss, script)
    port, port_flags = _drive(ss, script)
    assert port_flags == ref_flags
    assert port.slow_steps_total == ref.slow_steps_total
    assert port.window_throughput() == ref.window_throughput()
    for limit in (1, 2, 10, 64):
        for slow in (False, True):
            assert _strip(port.snapshot(limit, slow_only=slow)) == _strip(
                ref.snapshot(limit, slow_only=slow))
    if name == "slow":
        assert ref_flags[30:32] == [True, True] and not any(ref_flags[:30])
    if name == "ring":
        assert [r["seq"] for r in port.snapshot(10)["records"]] == [
            10, 9, 8, 7]


@BOTH_SS
def test_snapshot_copies_records(mod):
    rec = mod.StepRecorder()
    rec.observe("decode", {"compute": 0.00123456789}, tokens=1)
    a = rec.snapshot()["records"][0]
    a["phases_s"]["compute"] = 999.0
    assert rec.snapshot()["records"][0]["phases_s"]["compute"] != 999.0


def test_phases_kinds_and_the_device_field():
    assert ss.PHASES == ref_ss.PHASES and ss.KINDS == ref_ss.KINDS
    rec = ss.StepRecorder(capacity=3)
    rec.observe("prefill", {"dispatch": 0.01})
    rec.observe("decode", {"compute": 0.01}, device_ms=9.5)
    assert rec.snapshot()["records"][0]["device_ms"] == 9.5
    assert rec.snapshot()["records"][1]["device_ms"] is None
    assert rec.set_device_ms(1, 7.25)
    assert rec.snapshot()["records"][1]["device_ms"] == 7.25
    for _ in range(3):
        rec.observe("decode", {"compute": 0.01})
    assert not rec.set_device_ms(1, 1.0)  # left the ring


# --------------------------------------------------------------- telemetry


def test_chip_lookup_and_cost_helpers_match_reference():
    from llmlb_tpu.engine.presets import get_preset as ref_preset
    from llmlb_tpu_torch.engine.presets import get_preset

    h100 = tel.chip_spec_for("NVIDIA H100 80GB HBM3")
    assert (h100.peak_flops, h100.int8_flops, h100.peak_hbm_bw) == (
        989e12, 1979e12, 3.35e12)
    for kind in ("cpu", "unknown accelerator", "TPU v5 lite"):
        assert tel.chip_spec_for(kind) is None
    assert ref_tel.chip_spec_for("cpu") is None
    cfg, ref_cfg = get_preset("debug-tiny"), ref_preset("debug-tiny")
    n = 1_000_000
    assert tel.model_flops_per_token(cfg, n) == ref_tel.model_flops_per_token(
        ref_cfg, n)
    for kw in ({}, {"batch": 4}, {"batch": 8, "weight_bytes": 123456.0,
                                  "kv_cell_bytes": 20.0}):
        assert tel.model_bytes_per_token(cfg, n, 64, **kw) == pytest.approx(
            ref_tel.model_bytes_per_token(ref_cfg, n, 64, **kw), rel=0)


@pytest.mark.parametrize("samples", [[0.0004], [0.003, 0.02, 0.2, 40.0],
                                     [0.001 * i for i in range(1, 200)]])
def test_histogram_matches_reference(samples):
    for edges in (port_metrics.TTFT_BUCKETS, port_metrics.PHASE_BUCKETS):
        a, b = port_metrics.Histogram(edges), ref_metrics.Histogram(edges)
        for x in samples:
            a.observe(x)
            b.observe(x)
        for pct in (1, 50, 90, 99, 100):
            assert a.percentile(pct) == b.percentile(pct)
    assert port_metrics.STEP_BUCKETS == ref_metrics.STEP_BUCKETS
    assert port_metrics.ITL_BUCKETS == ref_metrics.ITL_BUCKETS
    assert port_metrics.COMPILE_BUCKETS == ref_metrics.COMPILE_BUCKETS


# --------------------------------------------------------- flight recorder


def _recorder(mod, **kw):
    kw.setdefault("enabled", True)
    kw.setdefault("spool_dir", None)
    return mod.FlightRecorder(**kw)


def _events(tl):
    return [(e["event"], e["request_id"], e.get("engine_request_id"),
             e.get("attrs")) for e in tl["events"]]


def test_gateway_rid_is_the_references():
    for rid in ("req-abc.0123abcd", "a.b.c", "deadbeefcafe", "x.12345678"):
        assert fr.gateway_rid(rid) == ref_fr.gateway_rid(rid)
    from llmlb_tpu_torch.engine import scheduler

    assert scheduler.gateway_rid is fr.gateway_rid  # one copy


FR_SCRIPTS = {
    "order": ({}, [("req-1.aabbccdd", "admitted", {"prompt_tokens": 5}),
                   ("req-1.aabbccdd", "prefill_chunk", {"tokens": 5}),
                   ("req-1.aabbccdd", "finished", {"reason": "stop"})]),
    "bounds": ({"events_per_request": 8},
               [("r", "spec_accept", {"drafted": 2, "accepted": i})
                for i in range(20)]),
    "lru": ({"max_requests": 2}, [("a", "admitted", {}),
                                  ("b", "admitted", {}),
                                  ("a", "finished", {"reason": "stop"}),
                                  ("c", "admitted", {})]),
    "disabled": ({"enabled": False}, [("r", "admitted", {})]),
}


@pytest.mark.parametrize("name", sorted(FR_SCRIPTS))
def test_flight_recorder_matches_reference(name):
    """Ordering, the per-request bound and drop counter, the LRU over
    requests, the counters, the inert disabled recorder: both recorders
    given the same emits give the same timelines and counters."""
    kw, emits = FR_SCRIPTS[name]
    recs = [_recorder(mod, **kw) for mod in (ref_fr, fr)]
    for rec in recs:
        for rid, event, attrs in emits:
            rec.emit(rid, event, **attrs)
    ref, port = recs
    for rid in ("req-1", "r", "a", "b", "c", "nope"):
        a, b = ref.timeline(rid), port.timeline(rid)
        assert (a is None) == (b is None)
        if a is not None:
            assert _events(b) == _events(a)
            assert b["dropped"] == a["dropped"]
            assert [e["seq"] for e in b["events"]] == sorted(
                e["seq"] for e in b["events"])
    ca, cb = ref.counters(), port.counters()
    for key in ("queue_seconds_total", "service_seconds_total"):
        assert cb.pop(key) >= 0.0 and ca.pop(key) >= 0.0
    assert cb == ca


def test_flight_recorder_spool_matches_reference(tmp_path):
    """Two recorders sharing a spool answer for each other's events
    (deduped, one causal timeline), a torn tail line is skipped, file names
    cannot traverse: the same in both packages."""
    got = {}
    for mod in (ref_fr, fr):
        spool = tmp_path / mod.__name__ / "spool"
        a = _recorder(mod, spool_dir=str(spool), source="engine-a")
        b = _recorder(mod, spool_dir=str(spool), source="engine-b")
        a.emit("r.11112222", "admitted")
        a.emit("r.11112222", "prefill_chunk", tokens=4)
        b.emit("r.33334444", "adopted", committed=2)
        b.emit("r.33334444", "finished", reason="stop")
        tl = b.timeline("r")
        path = next(spool.glob("req-r.jsonl"))
        with open(path, "a") as f:
            f.write('{"seq": 99, "ts"')
        fresh = _recorder(mod, spool_dir=str(spool), source="engine-c")
        a.emit("../../etc/passwd", "admitted")
        got[mod] = ([(e["src"], e["event"]) for e in tl["events"]],
                    [e["event"] for e in fresh.timeline("r")["events"]],
                    sorted(p.name for p in spool.iterdir()))
        assert all("/" not in p.name and p.parent == spool
                   for p in spool.iterdir())
    assert got[fr] == got[ref_fr]
    assert len(got[fr][0]) == 4


def test_event_taxonomy_is_the_references_and_closed():
    """The port's events are the reference's, and every event name the
    port emits is in them."""
    assert fr.EVENTS == ref_fr.EVENTS
    pat = re.compile(r"(?:_fr_emit|flightrec\.emit)\(\s*[^,]+,\s*"
                     r"\"([a-z_]+)\"")
    emitted = set()
    for path in (REPO / "llmlb_tpu_torch").rglob("*.py"):
        src = path.read_text()
        emitted.update(pat.findall(src))
        # _finish's event override ("shed")
        emitted.update(re.findall(r"\bevent=\"([a-z_]+)\"", src))
    assert {"admitted", "queued", "prefill_chunk", "parked", "resumed",
            "kv_spilled", "kv_restored", "adopted", "lora_acquire",
            "spec_accept", "shed", "slow_step"} <= emitted
    assert emitted <= set(fr.EVENTS), emitted - set(fr.EVENTS)


def test_lifecycle_rule_holds_on_the_port_scheduler():
    """scripts/check_lifecycle_events.py's rule: every terminal put is
    paired with an emit in its function, and _park_slot emits "parked"."""
    from scripts.check_lifecycle_events import check_scheduler

    path = REPO / "llmlb_tpu_torch" / "engine" / "scheduler.py"
    assert check_scheduler(path) == []
    src = path.read_text()
    assert src.count('request.events.put(("done", value))') == 1
    assert src.count('request.events.put(("error", value))') == 1


# ---------------------------------------------------------------- metrics


def _ref_series() -> set[str]:
    """Every series family the reference's render can emit."""
    from scripts.check_metrics_docs import engine_metric_names

    return engine_metric_names()


def _families(text: str) -> set[str]:
    return set(re.findall(r"^# TYPE (\S+) ", text, re.M))


def _full_render(stats) -> str:
    m = port_metrics.EngineMetrics()
    m.record_lora_request("sample")
    m.record_lora_load(0.01)
    return m.render(
        stats,
        prefix_cache={"enabled": True, "entries": 0, "pinned_slots": 0,
                      "pinned_pages": 0, "pinned_hbm_bytes": 0},
        structured={"enabled": True, "mask_cache_entries": 0,
                    "mask_cache_bytes": 0},
        perf={"available": True, "mfu": 0.1, "hbm_bw_utilization": 0.2,
              "flops_per_token": 1.0, "bytes_per_token": 2.0},
        quant={"mode": "off", "param_bytes": 0},
        sched={"queued_by_class": {"high": 0, "normal": 0, "low": 0},
               "queued_by_role": {"prefill": 0, "decode": 0}},
        lora={"enabled": True, "resident": [], "available": [],
              "max_adapters": 1},
        flightrec={"enabled": True},
        kv_offload={"enabled": True},
        kv_cache={"layout": "paged", "hbm_bytes": 0, "bytes_per_page": 0,
                  "pages_total": 1, "pages_free": 1, "pages_active": 0,
                  "pages_pinned": 0, "page_size": 16, "utilization": 0.0,
                  "fragmentation": 0.0, "waste_tokens_mean": 0.0})


def test_render_emits_only_reference_series_all_documented():
    """Every family the port renders is one the reference renders, under
    its name, and is documented in docs/monitoring/README.md (the
    reference's check_metrics_docs rule), and the port renders every one
    of them (the role queue depths with a split engine's `sched`)."""
    from llmlb_tpu_torch.engine.scheduler import EngineStats
    from scripts.check_metrics_docs import DOCS, undocumented

    stats = EngineStats(num_slots=2, active_slots=0, queued=0,
                        total_requests=0, total_tokens=0, uptime_s=0.0)
    text = _full_render(stats)
    names = _families(text)
    ref = _ref_series()
    assert names <= ref, names - ref
    assert ref - names == set()
    assert undocumented(names, DOCS.read_text()) == []
    # Prometheus text: every sample line is `name{labels} value`
    for line in text.splitlines():
        if not line.startswith("#"):
            assert re.match(r"^[a-z_]+(\{[^}]*\})? [0-9.e+-]+$", line), line


# ------------------------------------------------------------ engines (CPU)

ENGINE_KW = dict(num_slots=2, slot_capacity=64, prefill_buckets=(16,))
PROMPT = [1, 2, 3, 4, 5]


@pytest.fixture(scope="module")
def ref_engine():
    from llmlb_tpu.engine.service import Engine as RefEngine

    engine = RefEngine.from_preset("debug-tiny", **ENGINE_KW)
    yield engine
    engine.shutdown()


@pytest.fixture(scope="module")
def port_server():
    from llmlb_tpu_torch.engine.server import start_server
    from llmlb_tpu_torch.engine.service import Engine

    engine = Engine.from_preset("debug-tiny", device="cpu", **ENGINE_KW)
    server, thread = start_server(engine)
    yield engine, "http://%s:%d" % server.server_address[:2]
    server.shutdown()
    thread.join(timeout=30)
    engine.shutdown()


def _http(url: str, body: dict | None = None):
    """(status, parsed JSON or text) of a GET (or a POST with `body`)."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, raw, ctype = resp.status, resp.read(), resp.headers.get(
                "Content-Type", "")
    except urllib.error.HTTPError as e:
        status, raw, ctype = e.code, e.read(), e.headers.get(
            "Content-Type", "")
    return status, (json.loads(raw) if "json" in ctype else raw.decode())


async def _ref_routes(engine, rid: str) -> dict:
    """The reference server's bodies for the observability routes."""
    from aiohttp.test_utils import TestClient, TestServer

    from llmlb_tpu.engine.scheduler import SamplingParams as RefSampling
    from llmlb_tpu.engine.server import create_engine_app

    await engine.complete(PROMPT, RefSampling(temperature=0.0, max_tokens=6),
                          request_id=rid)
    client = TestClient(TestServer(create_engine_app(engine,
                                                     owns_engine=False)))
    await client.start_server()
    out = {}
    try:
        for path in ("/api/steps?limit=3", "/api/steps?limit=abc",
                     f"/api/requests/{rid}/timeline",
                     "/api/requests/never-seen/timeline", "/api/health",
                     "/api/system"):
            resp = await client.get(path)
            out[path] = (resp.status, await resp.json())
        resp = await client.get("/metrics")
        out["/metrics"] = (resp.status, await resp.text(),
                           resp.headers["Content-Type"])
    finally:
        await client.close()
    return out


def _port_routes(engine, base: str, rid: str) -> dict:
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    engine.complete(PROMPT, SamplingParams(temperature=0.0, max_tokens=6),
                    request_id=rid)
    out = {}
    for path in ("/api/steps?limit=3", "/api/steps?limit=abc",
                 f"/api/requests/{rid}/timeline",
                 "/api/requests/never-seen/timeline", "/api/health",
                 "/api/system"):
        out[path] = _http(base + path)
    with urllib.request.urlopen(base + "/metrics", timeout=60) as resp:
        out["/metrics"] = (resp.status, resp.read().decode(),
                           resp.headers["Content-Type"])
    return out


async def test_routes_carry_the_reference_shapes(ref_engine, port_server):
    """The same request through both engines, then each observability
    route of both servers: the same status codes and error bodies, the
    same keys in /api/steps (a record's, its phases, perf, the recorder's
    counters; the port's records add `device_ms`), the same lifecycle in
    the timeline, the reference's series in /metrics, and /api/health's
    `gpu`, `perf` and `metrics` blocks the reference's `tpu`, `perf` and
    `metrics` key for key."""
    engine, base = port_server
    rid = "gw-obs-routes-1"
    ref = await _ref_routes(ref_engine, rid)
    port = _port_routes(engine, base, rid)

    for path in ("/api/steps?limit=abc", "/api/requests/never-seen/timeline"):
        assert port[path] == ref[path], path
    (rs, rsteps), (ps, psteps) = ref["/api/steps?limit=3"], port[
        "/api/steps?limit=3"]
    assert rs == ps == 200
    assert set(psteps) == set(rsteps)
    assert set(psteps["records"][0]) == set(rsteps["records"][0]) | {
        "device_ms"}
    assert set(psteps["records"][0]["phases_s"]) == set(ss.PHASES)
    assert set(psteps["perf"]) == set(rsteps["perf"])
    assert set(psteps["flightrec"]) == set(rsteps["flightrec"])
    assert len(psteps["records"]) == 3
    for r in psteps["records"]:
        assert r["total_s"] == pytest.approx(sum(r["phases_s"].values()),
                                             abs=1e-5)

    (rs, rtl), (ps, ptl) = (ref[f"/api/requests/{rid}/timeline"],
                            port[f"/api/requests/{rid}/timeline"])
    assert rs == ps == 200 and set(ptl) == set(rtl)
    names = [e["event"] for e in ptl["events"]]
    assert names == [e["event"] for e in rtl["events"]]
    assert names[:2] == ["admitted", "queued"] and names[-1] == "finished"
    assert set(ptl["events"][-1]["attrs"]) == set(rtl["events"][-1]["attrs"])

    assert port["/metrics"][2] == ref["/metrics"][2]
    pnames, rnames = _families(port["/metrics"][1]), _families(
        ref["/metrics"][1])
    assert pnames <= _ref_series()
    # the engines' own blocks: the same families
    assert pnames == rnames

    rh, ph = ref["/api/health"][1], port["/api/health"][1]
    tpu, gpu = rh["tpu"], ph["gpu"]
    assert set(gpu) == set(tpu)
    assert set(gpu["chips"][0]) == set(tpu["chips"][0])
    assert gpu["accelerator"] == tpu["accelerator"] == "cpu"
    for key in ("platform", "device_kind", "hbm_used_bytes",
                "hbm_total_bytes"):
        assert gpu["chips"][0][key] == tpu["chips"][0][key], key
    assert gpu["hbm_used_bytes"] == tpu["hbm_used_bytes"] == 0
    assert gpu["chip_count"] == 1  # one card an engine; JAX's CPU mesh has 8
    assert set(ph["perf"]) == set(rh["perf"])
    assert set(ph["metrics"]) == set(rh["metrics"])
    assert ph["metrics"]["tokens_total"] == engine.core.stats().total_tokens
    assert ref["/api/system"][1]["perf"]["available"] is False
    assert set(port["/api/system"][1]["perf"]) == set(
        ref["/api/system"][1]["perf"])


def test_counts_agree_across_surfaces(port_server):
    """One tally per count: /metrics, /api/health's metrics block and
    core.stats() read the same figures."""
    engine, base = port_server
    _, text = _http(base + "/metrics")
    _, health = _http(base + "/api/health")
    stats = engine.core.stats()

    def sample(name):
        return float(re.search(rf"^{name} (\S+)$", text, re.M).group(1))

    assert sample("llmlb_engine_tokens_total") == stats.total_tokens == \
        health["metrics"]["tokens_total"]
    assert sample("llmlb_engine_prefix_cache_misses_total") == \
        stats.prefix.prefix_misses_total
    assert sample("llmlb_engine_requests_total") == \
        health["metrics"]["requests_total"] >= 1
    assert sample("llmlb_engine_slow_steps_total") == stats.slow_steps_total


def _perf_twin(core, ref_cfg, ref_params, quantize: str) -> dict:
    """The reference's perf_info on the port core's live state, its
    parameter figures counted the reference's way from the JAX params."""
    import jax.numpy as jnp

    from llmlb_tpu.engine.scheduler import EngineCore as RefCore
    from llmlb_tpu.quant import parse_quant_mode, quantize_params

    params = (quantize_params(ref_params)
              if parse_quant_mode(quantize).weights else ref_params)
    stub = types.SimpleNamespace(
        cfg=ref_cfg, step_stats=core.step_stats, slots=core.slots,
        _seq_lens=core._seq_lens, quant=parse_quant_mode(quantize),
        n_params=sum(int(v.size) for k, v in params.items()
                     if not (k.endswith("_scale") or "_lora_" in k)),
        param_bytes=sum(int(v.size) * jnp.dtype(v.dtype).itemsize
                        for v in params.values()))
    return RefCore.perf_info(stub)


@pytest.mark.parametrize("quantize", ["off", "all"])
def test_perf_info_matches_reference(quantize):
    """perf_info's figures on debug-tiny, with and without int8, equal the
    reference's on the same state (its n_chips counts JAX's 8 virtual CPU
    devices: the port's engine runs on one); on the CPU the gauges are
    unavailable, and an H100's peaks make them available."""
    import jax

    from llmlb_tpu.engine.presets import get_preset as ref_preset
    from llmlb_tpu.models import llama as jllama
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore

    ref_cfg = ref_preset("debug-tiny")
    ref_params = jllama.init_params(ref_cfg, jax.random.PRNGKey(0))
    core = EngineCore(get_preset("debug-tiny"), device="cpu", num_slots=2,
                      slot_capacity=64, prefill_buckets=(16,),
                      quantize=quantize)
    core.slots[0].request = object()
    core._seq_lens[0] = 40
    for _ in range(3):
        core.step_stats.observe("decode", {"compute": 0.01}, tokens=2)
    port, ref = core.perf_info(), _perf_twin(core, ref_cfg, ref_params,
                                             quantize)
    assert ref.pop("n_chips") == 8 and port.pop("n_chips") == 1
    assert port == ref
    assert port["available"] is False and port["tokens_per_sec_busy"] == 200.0
    # the card's peaks: mfu and bandwidth against the H100's columns
    import llmlb_tpu_torch.engine.scheduler as sched

    orig = sched.device_kind
    sched.device_kind = lambda device: "NVIDIA H100 80GB HBM3"
    try:
        on_card = core.perf_info()
    finally:
        sched.device_kind = orig
    peak = 1979e12 if quantize == "all" else 989e12
    assert on_card["available"] is True
    assert on_card["mfu"] == round(on_card["flops_per_token"] * 200.0 / peak,
                                   6)
    assert on_card["hbm_bw_utilization"] == round(
        on_card["bytes_per_token"] * 200.0 / 3.35e12, 6)


def test_slow_step_names_its_requests(port_server):
    """A flagged dispatch's record names its requests' gateway ids, and
    their flight records gain a slow_step event."""
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    engine, _ = port_server
    stats = engine.core.step_stats
    # arm the detector: silent for its first 16 steps of a kind
    engine.complete([2, 4, 6], SamplingParams(temperature=0.0, max_tokens=24))
    old = stats.slow_ratio, stats.slow_floor_s
    stats.slow_ratio = stats.slow_floor_s = 0.0
    try:
        engine.complete([9, 8, 7], SamplingParams(temperature=0.0,
                                                  max_tokens=4),
                        request_id="gw-victim-1")
    finally:
        stats.slow_ratio, stats.slow_floor_s = old
    named = [r for r in stats.snapshot(slow_only=True)["records"]
             if "gw-victim-1" in r["request_ids"].values()]
    assert named
    tl = engine.core.flightrec.timeline("gw-victim-1")
    slow = [e for e in tl["events"] if e["event"] == "slow_step"]
    assert slow and slow[0]["attrs"]["kind"] in ss.KINDS


def test_recording_costs_under_one_percent_of_a_step(port_server):
    """StepRecorder.observe + the phase histograms, and one flight-recorder
    emit, each timed alone against the port engine's measured mean decode
    step (the CPU debug engine's, far shorter than the card's). Each cost
    is the fastest of several timed rounds: what a call costs is its floor,
    and the floor does not rise when other processes take the CPU from a
    round (the tests run in parallel workers)."""
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    engine, _ = port_server
    engine.complete([1, 2, 3], SamplingParams(temperature=0.0, max_tokens=16))
    hist = engine.core.metrics.decode_step
    mean_step_s = hist.total / hist.n
    rec, metrics = ss.StepRecorder(), port_metrics.EngineMetrics()
    phases = {"plan": 1e-5, "host_sync": 1e-6, "dispatch": 1e-3,
              "compute": 1e-4, "fetch": 1e-4, "emit": 1e-4}
    flight = _recorder(fr)
    n, rounds = 400, 7

    def record():
        for _ in range(n):
            rec.observe("decode", phases, active_slots=2, tokens=2)
            metrics.record_step_phases(phases)

    def emit():
        for i in range(n):
            flight.emit(f"r{i % 64}.aabbccdd", "prefill_chunk", tokens=16,
                        cached_tokens=0)

    def floor_per_call(fn) -> float:
        times = []
        for _ in range(rounds):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) / n)
        return min(times)

    per_step = floor_per_call(record)
    assert per_step < 0.01 * mean_step_s, (per_step, mean_step_s)
    per_emit = floor_per_call(emit)
    assert per_emit < 0.01 * mean_step_s, (per_emit, mean_step_s)


def test_engine_records_every_dispatch_kind(port_server):
    """Prefill records name their rows, decode records sum their phases
    and count one model step each (burst 1 on the CPU), the phase
    histograms fill, and a request's timeline runs admitted -> queued ->
    prefill_chunk -> finished in seq order."""
    from llmlb_tpu_torch.engine.scheduler import SamplingParams

    engine, _ = port_server
    # The slow-step detector stays disarmed for this request: on a loaded
    # host a step past its floor (20 ms) adds a slow_step event to the
    # timeline, which this test does not drive (the slow-step test does).
    stats = engine.core.step_stats
    old = stats.slow_ratio, stats.slow_floor_s
    stats.slow_ratio = stats.slow_floor_s = float("inf")
    try:
        engine.complete(list(range(1, 40)), SamplingParams(temperature=0.0,
                                                           max_tokens=5),
                        request_id="gw-kinds-1")
    finally:
        stats.slow_ratio, stats.slow_floor_s = old
    recs = engine.core.step_stats.snapshot(limit=64)["records"]
    mine = [r for r in recs if "gw-kinds-1" in r["request_ids"].values()]
    kinds = [r["kind"] for r in reversed(mine)]
    assert kinds[:3] == ["prefill"] * 3  # 39 tokens in 16-token chunks
    assert "decode" in kinds
    assert all(r["dispatches"] == 1 for r in mine if r["kind"] == "decode")
    assert all(r["device_ms"] is None for r in mine)  # no events on the CPU
    tl = engine.core.flightrec.timeline("gw-kinds-1")
    ev = tl["events"]
    assert [e["event"] for e in ev] == (
        ["admitted", "queued"] + ["prefill_chunk"] * 3 + ["finished"])
    assert [e["attrs"].get("pos") for e in ev[2:5]] == [0, 16, 32]
    assert [e["seq"] for e in ev] == sorted(e["seq"] for e in ev)
    hist = engine.core.metrics.step_phase
    assert hist["dispatch"].n > 0 and hist["emit"].n > 0


def test_dispatch_check_passes_and_is_not_vacuous():
    """The port's twin of scripts/check_fused_dispatch.py passes on the
    CPU, and reports the mix that did not engage on a core without
    speculation."""
    from llmlb_tpu_torch.engine import dispatch_check
    from llmlb_tpu_torch.engine.presets import get_preset
    from llmlb_tpu_torch.engine.scheduler import EngineCore
    from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer
    from llmlb_tpu_torch.structured import ConstraintCompiler

    assert dispatch_check.run_check("cpu") == []
    core = EngineCore(get_preset("debug-tiny"), device="cpu", num_slots=4,
                      slot_capacity=128, prefill_buckets=(16, 32),
                      kv_page_size=16, spec_decode=False, eos_id=256)
    core.constraint_compiler = ConstraintCompiler(ByteTokenizer(512), 512)
    core.prepare_lora = lambda request: None  # no adapters: no rows
    core.start()
    try:
        findings = dispatch_check._check(core)
    finally:
        core.stop()
    assert any("no verify record" in f for f in findings), findings
    assert any("no adapter row" in f for f in findings), findings
