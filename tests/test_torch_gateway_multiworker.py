"""The port's multi-worker gateway (gateway/worker.py and the replication
hooks) held against the JAX gateway's.

- tests/gateway/test_multiworker.py's in-process cases, each run on the
  reference ([ref]) and on the port ([port]): N AppStates, each with its
  own SQLite connection to one shared WAL file and its own GossipBus
  socket in one shared directory — the state a forked worker holds, minus
  the fork. A breaker trip reaches the sibling within the reference's
  0.25 s budget; gossip off; TPS (and its clear), the retry budget, ring
  and LRU affinity, the prefix-heat map (LLMLB_AFFINITY_HEAT); an admin
  mutation and an adapter residency push reach the sibling's registry;
  concurrent audit flushes keep one chain; the single-writer split (only
  worker 0 probes); the metrics spool's sibling merge.
- The supervisor (run_supervisor) in a child process: SIGTERM reaches
  every worker and the supervisor exits 0; one worker's own death takes
  the group down with its code.
- `serve --workers 2 --port 0` is a parser error and forks nothing
  (ROADMAP C20).
- The real thing, once: `python -m llmlb_tpu_torch.gateway.server serve
  --workers 2` on one fixed port, with torch, aiohttp, argon2, jax and
  llmlb_tpu unimportable in it (a worker that imported any of them would
  die), in front of a stub engine registered through one worker: /health,
  both workers listing the engine online, chats served by both, the merged
  /metrics under worker="0" and worker="1", /api/health's worker count and
  gossip figures, 12 trace lookups on fresh connections, and SIGTERM: the
  supervisor exits 0 and no worker outlives it.
"""

import asyncio
import json
import os
import signal
import subprocess
import sys
import textwrap
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from llmlb_tpu.gateway import audit as ref_audit
from llmlb_tpu.gateway import balancer as ref_balancer
from llmlb_tpu.gateway import metrics as ref_metrics
from llmlb_tpu.gateway import worker as ref_worker
from llmlb_tpu_torch.gateway import audit, balancer, metrics, worker
from tests.test_torch_gateway_e2e import STUB_MODEL, _stub
from tests.test_torch_gateway_gossip import SIDES as GOSSIP_SIDES
from tests.test_torch_gateway_gossip import (
    _endpoint,
    _free_port,
    _wait_for,
    _worker_states,
)

REPO = Path(__file__).resolve().parent.parent
BREAKER_PROPAGATION_BUDGET_S = 0.25  # the reference's acceptance bound

SIDES = {
    "ref": types.SimpleNamespace(**vars(GOSSIP_SIDES["ref"]), audit=ref_audit,
                                 balancer=ref_balancer, metrics=ref_metrics),
    "port": types.SimpleNamespace(**vars(GOSSIP_SIDES["port"]), audit=audit,
                                  balancer=balancer, metrics=metrics),
}


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return SIDES[request.param]


def _load_manager(pkg, **kw):
    # the Python core, as the reference's own case (both packages' native
    # cores are held against each other in tests/test_torch_native.py)
    return pkg.balancer.LoadManager(use_native=False, **kw)


# ------------------------------------------------------------------- breaker


async def test_breaker_trip_propagates_across_workers(tmp_path, monkeypatch,
                                                      pkg):
    Breaker = pkg.resilience.BreakerState
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45711)
    try:
        ep = _endpoint(pkg, "engine-a")
        s0.registry.add(ep)
        # registry mutation gossips; the sibling reloads from the shared DB
        assert await _wait_for(lambda: s1.registry.get(ep.id) is not None,
                               2.0)
        threshold = s0.resilience.config.breaker_failure_threshold
        t0 = time.monotonic()
        for _ in range(threshold):
            s0.resilience.record_failure(ep.id, "connect_error")
        assert s0.resilience.state_of(ep.id) == Breaker.OPEN
        assert not s0.resilience.allow(ep.id)
        assert await _wait_for(lambda: not s1.resilience.allow(ep.id),
                               BREAKER_PROPAGATION_BUDGET_S), \
            "breaker open did not propagate to the sibling in 250 ms"
        assert time.monotonic() - t0 < BREAKER_PROPAGATION_BUDGET_S
        assert s1.resilience.state_of(ep.id) == Breaker.OPEN
        # the sibling's breaker reopens with the tripping worker's window
        assert s1.resilience.breaker_info(ep.id)["retry_after_s"] <= \
            s0.resilience.breaker_info(ep.id)["retry_after_s"] + 0.01
        s0.resilience.note_probe(ep.id, True)  # open -> half_open
        s0.resilience.on_admit(ep.id)
        s0.resilience.record_success(ep.id)  # half_open -> closed
        assert await _wait_for(
            lambda: s1.resilience.state_of(ep.id) == Breaker.CLOSED, 1.0
        ), "breaker close did not propagate"
        # applying a remote transition never re-publishes it
        await asyncio.sleep(0.05)
        assert s1.gossip.stats()["sent_total"] == 0
    finally:
        await s0.close()
        await s1.close()


async def test_gossip_disabled_workers_converge_independently(
        tmp_path, monkeypatch, pkg):
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2,
                                  gossip=False, port=45712)
    try:
        assert s0.gossip is None and s1.gossip is None
        ep = _endpoint(pkg, "engine-b")
        s0.registry.add(ep)
        s1.registry.reload()  # no gossip: a manual reload stands in for boot
        threshold = s0.resilience.config.breaker_failure_threshold
        for _ in range(threshold):
            s0.resilience.record_failure(ep.id, "connect_error")
        assert not s0.resilience.allow(ep.id)
        await asyncio.sleep(0.1)
        assert s1.resilience.allow(ep.id)
        for _ in range(threshold):
            s1.resilience.record_failure(ep.id, "connect_error")
        assert not s1.resilience.allow(ep.id)
    finally:
        await s0.close()
        await s1.close()


# ----------------------------------------------------------- tps + affinity


async def test_tps_ema_and_its_clear_gossip_between_workers(
        tmp_path, monkeypatch, pkg):
    chat = pkg.types.TpsApiKind.CHAT
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45713)
    try:
        ep = _endpoint(pkg, "engine-c")
        s0.registry.add(ep)
        s0.load_manager.update_tps(ep.id, "m", chat, 120, 1.0)
        assert await _wait_for(
            lambda: s1.load_manager.get_tps(ep.id, "m", chat) is not None,
            1.0), "TPS EMA did not replicate"
        assert s1.load_manager.get_tps(ep.id, "m", chat) == \
            pytest.approx(120.0)
        s0.load_manager.clear_tps_for_endpoint(ep.id)
        assert await _wait_for(
            lambda: s1.load_manager.get_tps(ep.id, "m", chat) is None, 1.0)
        # a delayed EMA stamped before the clear cannot resurrect it
        s1.load_manager.apply_remote_tps(ep.id, "m", chat.value, 99.0, 3,
                                         (1, s0.gossip.origin))
        assert s1.load_manager.get_tps(ep.id, "m", chat) is None
    finally:
        await s0.close()
        await s1.close()


async def test_retry_budget_spend_gossips(tmp_path, monkeypatch, pkg):
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45714)
    try:
        before = s1.resilience.budget.snapshot()["retries_in_window"]
        assert s0.resilience.budget.try_spend()
        assert await _wait_for(
            lambda: s1.resilience.budget.snapshot()["retries_in_window"]
            == before + 1, 1.0,
        ), "retry spend did not replicate into the sibling's window"
    finally:
        await s0.close()
        await s1.close()


async def test_ring_affinity_agrees_across_workers(tmp_path, monkeypatch,
                                                   pkg):
    """Consistent-hash mode, the multi-worker default: every worker maps
    the same prompt head to the same endpoint with no coordination."""
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45715)
    try:
        assert s0.load_manager.affinity_mode == "ring"
        assert s1.load_manager.affinity_mode == "ring"
        endpoints = [_endpoint(pkg, f"engine-{i}") for i in range(4)]
        for h in (f"prefixhash-{k}" for k in range(32)):
            picks = {lm.select_endpoint(endpoints, "m", prefix_hash=h).id
                     for lm in (s0.load_manager, s1.load_manager)}
            assert len(picks) == 1, f"workers disagreed on prefix {h}"
    finally:
        await s0.close()
        await s1.close()


def test_ring_remap_fraction_on_endpoint_removal(pkg):
    ids = [f"ep-{i}" for i in range(5)]
    keys = [f"prompthash-{k}" for k in range(1000)]
    before = {k: pkg.balancer.hrw_owner(k, ids) for k in keys}
    survivors = [e for e in ids if e != "ep-2"]
    after = {k: pkg.balancer.hrw_owner(k, survivors) for k in keys}
    remapped = [k for k in keys if before[k] != after[k]]
    assert all(before[k] == "ep-2" for k in remapped)
    assert set(remapped) == {k for k in keys if before[k] == "ep-2"}
    assert 0.10 < len(remapped) / len(keys) < 0.32
    assert before == {k: ref_balancer.hrw_owner(k, ids) for k in keys}


def test_ring_mode_single_manager_sticks_and_counts(pkg):
    lm = _load_manager(pkg, affinity_mode="ring")
    chat = pkg.types.TpsApiKind.CHAT
    endpoints = [_endpoint(pkg, f"e{i}") for i in range(3)]
    h = "deadbeef" * 5
    first = lm.select_endpoint(endpoints, "m", prefix_hash=h)
    for _ in range(5):
        assert lm.select_endpoint(endpoints, "m", prefix_hash=h) is first
    stats = lm.affinity_stats()
    assert (stats["hits_total"], stats["misses_total"], stats["entries"]) \
        == (6, 0, 0)
    lm2 = _load_manager(pkg, queue_config=pkg.config.QueueConfig(
        max_active_per_endpoint=1), affinity_mode="ring")
    got = lm2.try_admit(endpoints, "m", chat, prefix_hash=h)
    assert got is not None and got[0] is first
    got2 = lm2.try_admit(endpoints, "m", chat, prefix_hash=h)
    assert got2 is not None and got2[0] is not first
    assert lm2.affinity_stats()["misses_total"] == 1
    got[1].fail()
    got2[1].fail()
    got3 = lm2.try_admit(endpoints, "m", chat, prefix_hash=h)
    assert got3 is not None and got3[0] is first
    got3[1].fail()


async def test_lru_affinity_pin_gossips(tmp_path, monkeypatch, pkg):
    monkeypatch.setenv("LLMLB_AFFINITY", "lru")
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45716)
    try:
        assert s0.load_manager.affinity_mode == "lru"
        endpoints = [_endpoint(pkg, f"engine-{i}") for i in range(3)]
        h = "feedface" * 5
        pinned = s0.load_manager.select_endpoint(endpoints, "m",
                                                 prefix_hash=h)
        assert await _wait_for(
            lambda: s1.load_manager._affinity_endpoint("m", h) == pinned.id,
            1.0), "lru affinity pin did not replicate"
        assert s1.load_manager.select_endpoint(
            endpoints, "m", prefix_hash=h) is pinned
    finally:
        await s0.close()
        await s1.close()


async def test_prefix_heat_steers_the_sibling(tmp_path, monkeypatch, pkg):
    """LLMLB_AFFINITY_HEAT=1 in ring mode: the endpoint that actually
    served a prefix outranks the rendezvous owner, on this worker and,
    once the heat gossips, on its sibling."""
    monkeypatch.setenv("LLMLB_AFFINITY_HEAT", "1")
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45717)
    try:
        endpoints = [_endpoint(pkg, f"engine-{i}") for i in range(4)]
        h = "cafebabe" * 5
        owner = pkg.balancer.hrw_owner(h, [e.id for e in endpoints])
        warm = next(e for e in endpoints if e.id != owner)
        # the prefix was served by a non-owner (say, after churn)
        s0.load_manager._affinity_record("m", h, warm.id, hit=False)
        assert s0.load_manager.select_endpoint(
            endpoints, "m", prefix_hash=h).id == warm.id
        assert await _wait_for(
            lambda: s1.load_manager.affinity_stats()["heat_entries"] == 1,
            1.0), "prefix heat did not replicate"
        assert s1.load_manager.select_endpoint(
            endpoints, "m", prefix_hash=h).id == warm.id
        # with the warm endpoint gone the owner takes the key back
        rest = [e for e in endpoints if e.id != warm.id]
        assert s1.load_manager.select_endpoint(
            rest, "m", prefix_hash=h).id == owner
    finally:
        await s0.close()
        await s1.close()


# ----------------------------------------------------------- registry + db


async def test_admin_mutation_reaches_sibling_registry(tmp_path, monkeypatch,
                                                       pkg):
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45718)
    try:
        ep = _endpoint(pkg, "late-endpoint")
        s0.registry.add(ep)
        assert await _wait_for(lambda: s1.registry.get(ep.id) is not None,
                               2.0), "an added endpoint never reached the sibling"
        s0.registry.update_status(ep.id, pkg.types.EndpointStatus.OFFLINE)
        assert await _wait_for(
            lambda: s1.registry.get(ep.id).status
            == pkg.types.EndpointStatus.OFFLINE, 2.0)
        s0.registry.remove(ep.id)
        assert await _wait_for(lambda: s1.registry.get(ep.id) is None, 2.0), \
            "endpoint removal never propagated"
    finally:
        await s0.close()
        await s1.close()


async def test_adapter_residency_reaches_sibling(tmp_path, monkeypatch, pkg):
    """The primary's probe pushes a resident-adapter change (health.py);
    the sibling patches its `base:adapter` entries at once."""
    T = pkg.types
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45719)
    try:
        ep = _endpoint(pkg, "lora-engine")
        s0.registry.add(ep)
        s0.registry.sync_models(ep.id, [T.EndpointModel(
            endpoint_id=ep.id, model_id="base", canonical_name="base",
            capabilities=[T.Capability.CHAT_COMPLETION, T.Capability.LORA])])
        assert await _wait_for(lambda: len(s1.registry.models_for(ep.id))
                               == 1, 2.0)
        s0.gossip.publish("residency", {"eid": ep.id,
                                        "adapters": {"acme": 1, "zeta": 1}})
        assert await _wait_for(
            lambda: sorted(m.model_id for m in s1.registry.models_for(ep.id))
            == ["base", "base:acme", "base:zeta"], 1.0)
    finally:
        await s0.close()
        await s1.close()


async def test_audit_chain_survives_concurrent_worker_flushes(
        tmp_path, monkeypatch, pkg):
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45720)
    try:
        for i in range(30):
            s = (s0, s1)[i % 2]
            s.audit.record(pkg.audit.AuditEntry(
                ts=time.time(), method="GET", path=f"/x/{i}", status=200,
                duration_ms=1.0))
            if i % 5 == 4:
                s0.audit.flush()
                s1.audit.flush()
        s0.audit.flush()
        s1.audit.flush()
        for s in (s0, s1):
            ok, err = s.audit.verify()
            assert ok, f"audit chain broken across workers: {err}"
        n = s0.db.query_one("SELECT COUNT(*) AS n FROM audit_log")
        assert n["n"] == 30
    finally:
        await s0.close()
        await s1.close()


async def test_single_writer_split_and_worker_defaults(tmp_path, monkeypatch,
                                                       pkg):
    """With the background tasks on, only the primary probes and runs
    maintenance; every worker spools traces and metrics into the gossip
    dir, batches its history writes, caches API keys for 60 s and divides
    rate limits by the worker count."""
    monkeypatch.setenv("LLMLB_GOSSIP_DIR", str(tmp_path / "bus"))
    monkeypatch.setenv("LLMLB_METRICS_SPOOL_SECS", "0.2")
    db_path = str(tmp_path / "gw.db")
    cfg = pkg.config.ServerConfig(port=45721, database_url=db_path)
    states = [await pkg.app_state.build_app_state(
        cfg, db=pkg.db.Database(db_path),
        worker=pkg.worker.WorkerInfo(index=i, count=2)) for i in range(2)]
    try:
        s0, s1 = states
        assert s0.health_checker is not None and s1.health_checker is None
        assert s0.health_checker.gossip is s0.gossip
        for s in states:
            assert s.traces.spool_dir == str(tmp_path / "bus")
            assert s.history.batched
            assert s.api_keys.cache_ttl_s == 60.0
            assert s.ratelimit.workers == 2
            assert {t.get_name() for t in s._tasks} >= {"metrics-spool"}
        assert "gw-maintenance" in {t.get_name() for t in s0._tasks}
        assert "gw-maintenance" not in {t.get_name() for t in s1._tasks}
        assert await _wait_for(lambda: all(
            (tmp_path / "bus" / f"metrics-w{i}.prom").exists()
            for i in range(2)), 2.0)
        peers = pkg.app_state.read_peer_metrics(s0, max_age_s=10.0)
        assert 'worker="1"' in peers and 'worker="0"' not in peers
        assert not any(ln.startswith("#") for ln in peers.splitlines())
        # a trace one worker finished is answered by the other
        tr = s1.traces.start("trace-spool-1", "POST", "/v1/chat/completions")
        s1.traces.finish(tr, 401)
        got = s0.traces.get("trace-spool-1")
        assert got["trace_id"] == "trace-spool-1" and got["spooled"]
        assert s0.traces.get("../escape") is None
        assert [t["trace_id"] for t in s1.traces.list(5)] == ["trace-spool-1"]
    finally:
        for s in states:
            await s.close()


def test_label_exposition_injects_worker_label(pkg):
    text = ("# TYPE llmlb_gateway_requests_total counter\n"
            'llmlb_gateway_requests_total{route="/v1/x",status="200"} 5\n'
            "llmlb_gateway_active_requests 2\n")
    out = pkg.metrics.label_exposition(text, "worker", "3")
    assert ('llmlb_gateway_requests_total{route="/v1/x",status="200",'
            'worker="3"} 5') in out
    assert 'llmlb_gateway_active_requests{worker="3"} 2' in out
    assert out.splitlines()[0].startswith("# TYPE")
    assert out == ref_metrics.label_exposition(text, "worker", "3")


def test_gossip_delay_histogram_in_the_exposition():
    ours, ref = metrics.GatewayMetrics(), ref_metrics.GatewayMetrics()
    for m in (ours, ref):
        for s in (0.0004, 0.02, 3.0, -1.0):
            m.observe_gossip_lag(s)

    def family(text):
        return [ln for ln in text.splitlines() if "gossip_delay" in ln]

    got = family(ours.render())
    assert got == family(ref.render())
    assert 'llmlb_gateway_gossip_delay_seconds_bucket{le="0.001"} 2' in got
    assert "llmlb_gateway_gossip_delay_seconds_count 4" in got


# ---------------------------------------------------- identity + supervisor


@pytest.mark.parametrize("env,cli", [
    ({}, None), ({"LLMLB_WORKERS": "4", "LLMLB_WORKER_INDEX": "2"}, None),
    ({"LLMLB_WORKERS": "4", "LLMLB_WORKER_INDEX": "9"}, 3),
    ({"LLMLB_WORKERS": "x", "LLMLB_WORKER_INDEX": "y"}, 0),
    ({"LLMLB_WORKERS": "0", "LLMLB_WORKER_INDEX": "-2"}, 2),
])
def test_worker_identity_matches_the_reference(monkeypatch, env, cli):
    for k in ("LLMLB_WORKERS", "LLMLB_WORKER_INDEX"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours, ref = worker.current_worker(), ref_worker.current_worker()
    assert (ours.index, ours.count, ours.is_primary, ours.multi,
            ours.label) == (ref.index, ref.count, ref.is_primary, ref.multi,
                            ref.label)
    assert worker.worker_count_from_env(cli) == \
        ref_worker.worker_count_from_env(cli)
    assert worker.supports_reuse_port() == ref_worker.supports_reuse_port()


_SUPERVISOR = textwrap.dedent("""
    import json, os, signal, sys, time
    from {mod} import run_supervisor

    def child(w):
        stop = []
        signal.signal(signal.SIGTERM, lambda *a: stop.append(1))
        open(os.path.join(sys.argv[1], f"w{{w.index}}"), "w").write(
            json.dumps([os.getpid(), os.environ["LLMLB_WORKER_INDEX"],
                        os.environ["LLMLB_WORKERS"]]))
        if sys.argv[2] == "die" and w.index == 1:
            time.sleep(0.3)
            return 3
        deadline = time.monotonic() + 60
        while not stop and time.monotonic() < deadline:
            time.sleep(0.01)
        return 0 if stop else 5

    sys.exit(run_supervisor(2, child))
""")


@pytest.mark.parametrize("mode", ["sigterm", "die"])
def test_supervisor_stops_the_group(tmp_path, pkg, mode):
    """SIGTERM to the supervisor reaches both workers and it exits 0; a
    worker that exits on its own (code 3) takes its sibling down and the
    supervisor exits 3. Each child saw its index and the count."""
    code = _SUPERVISOR.format(mod=pkg.worker.__name__)
    proc = subprocess.Popen([sys.executable, "-c", code, str(tmp_path), mode],
                            cwd=REPO, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 30
        while len(list(tmp_path.glob("w*"))) < 2:
            assert time.monotonic() < deadline and proc.poll() is None, \
                proc.stderr.read() if proc.poll() is not None else ""
            time.sleep(0.02)
        time.sleep(0.1)
        kids = [json.loads((tmp_path / f"w{i}").read_text())
                for i in range(2)]
        assert [k[1:] for k in kids] == [["0", "2"], ["1", "2"]]
        if mode == "sigterm":
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == (0 if mode == "sigterm" else 3), proc.stderr.read()
    for pid, _, _ in kids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


# ------------------------------------------------------------ real processes


_SERVE = textwrap.dedent("""
    import runpy, sys
    for n in ("torch", "aiohttp", "argon2", "jax", "llmlb_tpu"):
        sys.modules[n] = None
    sys.argv = ["server", "serve", "--host", "127.0.0.1", "--port",
                sys.argv[1], "--workers", "2"]
    runpy.run_module("llmlb_tpu_torch.gateway.server", run_name="__main__")
""")


def _children(pid: int) -> list[int]:
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open(f"/proc/{d}/stat") as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def test_two_workers_on_port_zero_is_a_parser_error(tmp_path):
    """`serve --workers 2 --port 0` is refused by the parser before anything
    forks or builds (ROADMAP C20): port 0 would give each worker an
    ephemeral port of its own. The reference has no such check."""
    import os

    code = textwrap.dedent("""
        import os, runpy, sys
        def hook(name, args):
            if name == "os.fork":
                print("FORKED", flush=True)
        sys.addaudithook(hook)
        sys.argv = ["server", "serve", "--workers", "2", "--port", "0"]
        runpy.run_module("llmlb_tpu_torch.gateway.server",
                         run_name="__main__")
    """)
    env = {**os.environ, "LLMLB_DATA_DIR": str(tmp_path),
           "LLMLB_ADMIN_PASSWORD": "adminpass1",
           "LLMLB_LOG_DIR": str(tmp_path / "logs")}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 2, out.stderr
    assert "--workers > 1 needs a fixed --port" in out.stderr
    assert "FORKED" not in out.stdout and "listening" not in out.stderr
    assert not (tmp_path / "gossip").exists()


def test_serve_two_workers_on_one_port(tmp_path):
    stub, stub_url = _stub()
    port = _free_port()
    env = {**os.environ,
           "LLMLB_DATA_DIR": str(tmp_path / "data"),
           "LLMLB_LOG_DIR": str(tmp_path / "logs"),
           "LLMLB_GOSSIP_DIR": str(tmp_path / "bus"),
           "LLMLB_ADMIN_PASSWORD": "multiworker1",
           "LLMLB_METRICS_SPOOL_SECS": "0.3",
           "LLMLB_HEALTH_CHECK_INTERVAL": "0.5"}
    proc = subprocess.Popen([sys.executable, "-c", _SERVE, str(port)],
                            cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    base = f"http://127.0.0.1:{port}"

    def call(path, body=None, headers=None):
        """One request on a fresh connection: (status, JSON or text)."""
        req = urllib.request.Request(
            base + path, headers={"Content-Type": "application/json",
                                  **(headers or {})},
            data=None if body is None else json.dumps(body).encode())
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                status, raw = r.status, r.read().decode()
        except urllib.error.HTTPError as e:
            status, raw = e.code, e.read().decode()
        try:
            return status, json.loads(raw)
        except ValueError:
            return status, raw

    def until(pred, what, timeout_s=30.0):
        deadline = time.monotonic() + timeout_s
        while True:
            got = pred()
            if got:
                return got
            assert proc.poll() is None, proc.communicate()[1][-3000:]
            assert time.monotonic() < deadline, what
            time.sleep(0.05)

    kids: list[int] = []
    try:
        def up():
            try:
                return call("/health")[0] == 200
            except OSError:
                return False

        until(up, "the gateway never answered /health")
        kids = until(lambda: len(_children(proc.pid)) == 2
                     and _children(proc.pid), "two workers")
        login = call("/api/auth/login", {"username": "admin",
                                         "password": "multiworker1"})[1]
        admin = {"Authorization": f"Bearer {login['token']}"}
        key = call("/api/api-keys", {"name": "k", "permissions": [
            "openai.inference"]}, admin)[1]["api_key"]
        inf = {"Authorization": f"Bearer {key}"}
        status, ep = call("/api/endpoints", {"base_url": stub_url,
                                             "name": "stub"}, admin)
        assert status == 201, ep

        # both workers list the engine online with its model
        seen: dict = {}

        def listed():
            h = call("/api/health")[1]
            assert h["worker"]["count"] == 2
            if any(e["name"] == "stub" and e["status"] == "online"
                   for e in h["endpoints"]):
                seen[h["worker"]["index"]] = h
            return len(seen) == 2
        until(listed, "a worker never listed the engine online")

        # chats on fresh connections until both workers served some
        served = {}
        rid = None
        for i in range(64):
            rid = f"trace-mw-{i}"
            status, body = call("/v1/chat/completions", {
                "model": STUB_MODEL, "max_tokens": 3,
                "messages": [{"role": "user", "content": "hi"}]},
                {**inf, "X-Request-Id": rid})
            assert status == 200, body
            assert body["choices"][0]["message"]["content"] == "s0 s1 s2 "
            text = until(lambda: call("/metrics")[1], "metrics")
            served = {}
            for w in ("0", "1"):
                served[w] = sum(
                    float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                    if ln.startswith("llmlb_gateway_requests_total{")
                    and 'route="/v1/chat/completions"' in ln
                    and f'worker="{w}"' in ln)
            if i >= 3 and all(served.values()):
                break
        assert all(served.values()), served
        # every lookup of the last trace answers, whichever worker takes it
        for i in range(12):
            status, got = call(f"/api/traces/{rid}", headers=admin)
            assert status == 200, (i, got)
            assert got["trace_id"] == rid and got["status"] == 200
        # the list route answers (each worker lists its own recent traces)
        status, got = call("/api/traces?limit=500", headers=admin)
        assert status == 200 and isinstance(got["traces"], list), got
        # gossip moved between the workers, none refused
        stats: dict = {}

        def gossip_seen():
            h = call("/api/health")[1]
            stats[h["worker"]["index"]] = h["gossip"]
            return len(stats) == 2
        until(gossip_seen, "gossip stats from both workers")
        for g in stats.values():
            assert g["sent_total"] > 0 and g["received_total"] > 0, stats
            assert g["recv_rejected_total"] == 0 and g["peers"] == 1, stats
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
        stub.shutdown()
        stub.server_close()
    assert proc.returncode == 0, err[-3000:]
    for pid in kids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    assert "Traceback" not in err, err[-3000:]
