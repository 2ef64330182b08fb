"""`/api/profile`, `/debug/profile` and the CUDA init probe of the port.

Twins of the reference's profile tests (tests/engine/test_engine_serving.py
test_engine_server_profile_endpoint, tests/engine/test_step_introspection.py
test_profile_*) held to their docstrings: a capture of the serving loop
writes trace files under LLMLB_TRACE_DIR and rejects bad durations with a
400; start -> stop gives a downloadable zip of real trace files; the
profile token gates every profile route; the one-shot form waits on the
manager's stop event. And the staged probe of `engine/cuda_probe.py`, the
twin of the reference's TPU probe: a hang keeps the child's evidence, a
host without the card is refused, the guard exits non-zero.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import zipfile

import pytest

from llmlb_tpu_torch.engine import cuda_probe
from llmlb_tpu_torch.engine.profiling import ProfileManager
from llmlb_tpu_torch.engine.scheduler import SamplingParams
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine


@pytest.fixture(scope="module")
def served():
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                                slot_capacity=64, prefill_buckets=(16,))
    server, thread = start_server(engine)
    yield engine, "http://%s:%d" % server.server_address[:2]
    server.shutdown()
    thread.join(timeout=30)
    engine.shutdown()


def _call(url: str, body=None, method: str | None = None,
          headers: dict | None = None, raw: bool = False):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, payload, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        status, payload, hdrs = e.code, e.read(), e.headers
    return status, (payload if raw else json.loads(payload)), hdrs


def _run_requests(engine, n=2):
    for i in range(n):
        engine.complete([1 + i, 2, 3, 4, 5],
                        SamplingParams(temperature=0.0, max_tokens=8))


def test_debug_profile_writes_traces_and_rejects_bad_durations(
        served, tmp_path, monkeypatch):
    """POST /debug/profile captures a torch.profiler trace of the serving
    loop under LLMLB_TRACE_DIR and rejects invalid durations with a
    structured 400 (the contract of the reference's
    test_engine_server_profile_endpoint)."""
    engine, base = served
    monkeypatch.setenv("LLMLB_TRACE_DIR", str(tmp_path))
    worker = threading.Thread(target=_run_requests, args=(engine, 3))
    worker.start()
    status, body, _ = _call(base + "/debug/profile", {"seconds": 0.2})
    worker.join(timeout=120)
    assert status == 200
    # traces stay under the server-controlled root
    assert body["trace_dir"].startswith(str(tmp_path))
    captured = [f for _r, _d, files in os.walk(body["trace_dir"])
                for f in files]
    assert captured == ["trace.json"]
    with open(os.path.join(body["trace_dir"], "trace.json")) as f:
        trace = json.load(f)
    assert trace["traceEvents"], "profiler produced no trace events"

    status, err, _ = _call(base + "/debug/profile", {"seconds": "abc"})
    assert status == 400
    assert err["error"]["message"] == "'seconds' must be a number"
    status, err, _ = _call(base + "/debug/profile", [1])
    assert (status, err["error"]["message"]) == (
        400, "body must be a JSON object")


def test_profile_capture_produces_downloadable_trace(served, tmp_path,
                                                     monkeypatch):
    """POST /api/profile start -> stop yields a completed capture whose zip
    is non-empty and unpacks to the Chrome trace of the engine's ops."""
    engine, base = served
    monkeypatch.setenv("LLMLB_TRACE_DIR", str(tmp_path))
    status, started, _ = _call(base + "/api/profile",
                               {"action": "start", "seconds": 30})
    assert status == 200 and started["started"] is True
    capture_id = started["capture_id"]
    assert started["trace_dir"].startswith(str(tmp_path))
    # one profiler at a time
    status, err, _ = _call(base + "/api/profile", {"action": "start"})
    assert status == 409
    assert _call(base + "/api/profile")[1]["recording"] is True

    _run_requests(engine)  # the serving loop itself is what gets traced

    status, done, _ = _call(base + "/api/profile", {"action": "stop"})
    assert status == 200 and done["capture_id"] == capture_id
    assert done["bytes"] > 0 and done["download"] == (
        f"/api/profile/{capture_id}")
    assert _call(base + "/api/profile", {"action": "stop"})[0] == 409
    status, err, _ = _call(base + "/api/profile", {"action": "nope"})
    assert (status, err["error"]["message"]) == (
        400, "'action' must be 'start' or 'stop'")
    status, err, _ = _call(base + "/api/profile",
                           {"action": "start", "seconds": "x"})
    assert status == 400

    st = _call(base + "/api/profile")[1]
    assert st["recording"] is False
    assert st["captures"][0]["capture_id"] == capture_id

    status, blob, hdrs = _call(base + f"/api/profile/{capture_id}", raw=True)
    assert status == 200 and hdrs["Content-Type"] == "application/zip"
    zf = zipfile.ZipFile(io.BytesIO(blob))
    assert zf.namelist() == ["trace.json"]
    names = {e.get("name") for e in json.loads(zf.read("trace.json"))[
        "traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names), (
        "no engine op in the trace")
    assert _call(base + "/api/profile/doesnotexist")[0] == 404


def test_profile_token_gates_every_route(served, monkeypatch):
    _engine, base = served
    monkeypatch.setenv("LLMLB_PROFILE_TOKEN", "s3cret")
    status, err, _ = _call(base + "/api/profile", {"action": "start"})
    assert status == 401
    assert err["error"]["type"] == "authentication_error"
    assert _call(base + "/api/profile")[0] == 401
    assert _call(base + "/api/profile/x")[0] == 401
    assert _call(base + "/debug/profile", {})[0] == 401
    ok = _call(base + "/api/profile",
               headers={"Authorization": "Bearer s3cret"})
    assert ok[0] == 200
    assert _call(base + "/api/profile",
                 headers={"Authorization": "Bearer wrong"})[0] == 401


def test_profiler_starts_and_stops_on_the_step_loop(served, tmp_path):
    """Start and stop run through the core's call queue, on the loop's
    thread, between two iterations."""
    engine, _ = served
    threads = []

    def on_loop(fn):
        def wrapped():
            threads.append(threading.current_thread().name)
            return fn()
        return engine.core.call_in_loop(wrapped)

    mgr = ProfileManager(trace_root=str(tmp_path), run_in_loop=on_loop)
    mgr.start(30)
    _run_requests(engine, 1)
    done = mgr.stop()
    assert done["bytes"] > 0
    assert threads == ["engine-step-loop", "engine-step-loop"]


def test_profile_wait_idle_wakes_on_stop_event_not_poll(tmp_path):
    """The one-shot form waits on the manager's idle event and wakes when
    the capture stops, its trace written."""
    mgr = ProfileManager(trace_root=str(tmp_path))
    assert mgr.wait_idle(0.01) is True
    mgr.start(30)
    assert mgr.wait_idle(0.01) is False
    woke = {}

    def waiter():
        assert mgr.wait_idle(10.0) is True
        woke["at"] = time.perf_counter()
        woke["captures"] = len(mgr.status()["captures"])

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    t_stop = time.perf_counter()
    mgr.stop()
    stop_s = time.perf_counter() - t_stop
    t.join(timeout=5)
    assert not t.is_alive()
    assert woke["captures"] == 1  # idle only once the trace is on the ledger
    # the waiter wakes with the stop itself, not a later poll tick
    assert woke["at"] - t_stop < stop_s + 0.045, (woke["at"] - t_stop, stop_s)


# ------------------------------------------------------------ CUDA probe


def test_staged_probe_timeout_preserves_child_evidence():
    hang = ("import sys, time\n"
            "print('[probe] stage1: hanging here', file=sys.stderr,"
            " flush=True)\n"
            "time.sleep(60)\n")
    ok, diag, evidence = cuda_probe.staged_probe((1,), code=hang,
                                                 log_fn=lambda m: None)
    assert ok is False and "timed out" in diag
    rec = evidence["attempts"][0]
    assert "timeout" in rec["outcome"]
    assert any("hanging here" in ln for ln in rec["child_stderr_tail"])


def test_staged_probe_refuses_a_host_without_the_card():
    """The real probe here (no CUDA): it reports the CPU and fails; it
    never passes on the CPU."""
    ok, diag, evidence = cuda_probe.staged_probe((120,),
                                                 log_fn=lambda m: None)
    assert ok is False
    assert "not cuda" in diag
    assert evidence["attempts"][0]["outcome"] == "ok: cpu 0 none"


def test_guard_backend_init_fails_fast_on_hang(monkeypatch, capsys):
    monkeypatch.setattr(
        cuda_probe, "PROBE_CODE",
        "import sys, time\n"
        "print('cuInit: waiting on the driver', file=sys.stderr, flush=True)\n"
        "time.sleep(60)\n")
    with pytest.raises(SystemExit) as exc:
        cuda_probe.guard_backend_init(1.0)
    assert "did not complete" in str(exc.value)
    err = capsys.readouterr().err
    assert "cuInit: waiting on the driver" in err
    assert "LLMLB_INIT_TIMEOUT=0" in err
    cuda_probe.guard_backend_init(0)  # disabled: no probe, no exit


def test_server_main_exits_before_building_when_the_card_is_absent(
        monkeypatch):
    """`python -m llmlb_tpu_torch.engine.server` (on the card by default)
    probes before it builds the engine: here it exits non-zero with the
    probe's evidence instead of falling back to the CPU."""
    from llmlb_tpu_torch.engine import server

    built = []
    monkeypatch.setattr(server.Engine, "from_preset",
                        classmethod(lambda cls, *a, **k: built.append(1)))
    monkeypatch.setenv("LLMLB_INIT_TIMEOUT", "120")
    with pytest.raises(SystemExit) as exc:
        server.main(["--preset", "debug-tiny"])
    assert "not cuda" in str(exc.value)
    assert built == []
