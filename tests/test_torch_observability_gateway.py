"""The unchanged gateway in front of the port's server: its health probe,
its cross-process timeline, and the flight recorder's bit-identical off
switch.

- `EndpointHealthChecker` probes the port's `/api/health` and parses its
  `gpu` block into the endpoint's `AcceleratorInfo` (one device, the
  port's own byte figures), as it does a JAX engine's `tpu` block;
- `/api/traces/{id}?view=timeline` fetches `GET
  /api/requests/{id}/timeline` from the port engine the request touched
  and merges its flight-recorder events with the gateway's spans, the
  source reported `ok: true`;
- a greedy stream with LLMLB_FLIGHTREC=0 is the stream with it on, token
  for token.
"""

import json
import urllib.error
import urllib.request

import pytest

from llmlb_tpu.gateway.health import EndpointHealthChecker
from llmlb_tpu.gateway.types import EndpointType
from llmlb_tpu_torch.engine.flightrec import FlightRecorder
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from tests.support import GatewayHarness, parse_sse_frames


@pytest.fixture(scope="module")
def served():
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=4,
                                slot_capacity=128, prefill_buckets=(16, 32),
                                kv_page_size=16, prefix_cache=False)
    server, thread = start_server(engine)
    yield engine, "http://%s:%d" % server.server_address[:2]
    server.shutdown()
    thread.join(timeout=30)
    engine.shutdown()


def _health(base: str) -> dict:
    with urllib.request.urlopen(base + "/api/health", timeout=60) as resp:
        return json.loads(resp.read())


async def test_health_probe_reads_the_port_telemetry(served):
    """The probe of a registered port engine fills the endpoint's
    AcceleratorInfo from the `gpu` block: one device, the port's byte
    figures, and the engine's slots."""
    _engine, base = served
    gw = await GatewayHarness.create()
    gw.state.health_checker = checker = EndpointHealthChecker(
        gw.state.registry, gw.state.load_manager, gw.state.db,
        gw.state.http, gw.state.events, interval_s=3600, timeout_s=5.0)
    try:
        r = await gw.client.post("/api/endpoints", json={
            "base_url": base, "name": "port0"},
            headers=await gw.admin_headers())
        assert r.status == 201, await r.text()
        (ep,) = gw.state.registry.list_all()
        assert ep.endpoint_type == EndpointType.TPU
        result = await checker.check_endpoint(ep)
        assert result.ok, result.error
        info = gw.state.registry.list_all()[0].accelerator
        gpu = _health(base)["gpu"]
        assert info.chip_count == 1 == gpu["chip_count"]
        assert info.accelerator == gpu["accelerator"] == "cpu"
        assert (info.hbm_used_bytes, info.hbm_total_bytes) == (
            gpu["hbm_used_bytes"], gpu["hbm_total_bytes"])
        assert info.num_slots == 4
    finally:
        await gw.close()


async def test_timeline_view_merges_the_port_engine_events(served):
    _engine, base = served
    gw = await GatewayHarness.create()
    try:
        gw.register_mock(base, ["debug-tiny"], endpoint_type=EndpointType.TPU,
                         name="port0")
        rid = "trace-port-timeline-1"
        resp = await gw.client.post(
            "/v1/chat/completions",
            json={"model": "debug-tiny", "temperature": 0, "max_tokens": 6,
                  "messages": [{"role": "user", "content": "hi"}]},
            headers={**(await gw.inference_headers()), "X-Request-Id": rid})
        assert resp.status == 200, await resp.text()

        resp = await gw.client.get(f"/api/traces/{rid}?view=timeline",
                                   headers=await gw.admin_headers())
        assert resp.status == 200, await resp.text()
        tl = (await resp.json())["timeline"]
        assert tl["endpoints"] == ["port0"]
        (src,) = tl["sources"]
        assert src["ok"] is True and src["events"] >= 4
        engine_evs = [e for e in tl["events"] if e["src"] == src["source"]]
        names = [e["event"] for e in engine_evs]
        assert names[:2] == ["admitted", "queued"]
        assert "prefill_chunk" in names and names[-1] == "finished"
        assert all(e["endpoint"] == "port0" for e in engine_evs)
        order = [e["event"] for e in tl["events"]]
        assert order.index("endpoint_select") < order.index("admitted")
    finally:
        await gw.close()


def _stream_ids(base: str, body: dict) -> list[int]:
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read()
    ids = []
    for frame in parse_sse_frames(raw):
        for data in frame["data"]:
            obj = json.loads(data) if data != "[DONE]" else {}
            if obj.get("object") == "llmlb.replay":
                ids += obj["tokens"]
    return ids


def test_flightrec_off_is_bit_identical(served, monkeypatch):
    """LLMLB_FLIGHTREC=0: the same greedy stream, and no event recorded."""
    engine, base = served
    body = {"messages": [{"role": "user", "content": "count to ten"}],
            "temperature": 0, "max_tokens": 24, "stream": True,
            "llmlb_replay": True}
    on = _stream_ids(base, body)
    real = engine.core.flightrec
    monkeypatch.setenv("LLMLB_FLIGHTREC", "0")
    engine.core.flightrec = FlightRecorder()
    try:
        off = _stream_ids(base, body)
        assert engine.core.flightrec.enabled is False
        assert engine.core.flightrec.events_total == 0
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/api/requests/x/timeline",
                                   timeout=60)
        assert err.value.code == 404
    finally:
        engine.core.flightrec = real
    assert len(on) == 24 and off == on
