"""The port's gossip bus (llmlb_tpu_torch/gateway/gossip.py) held against
the JAX gateway's (llmlb_tpu/gateway/gossip.py).

- The wire: for every message kind, the same kind, data, origin, seq and
  ts give the same bytes in both packages; each package decodes the
  other's bytes to the same (kind, data, meta); both refuse a version
  mismatch, an unknown field and an unknown kind; the kinds and their wire
  versions are the same.
- One directory, two packages: a port bus (w0) and a reference bus (w1)
  deliver a `breaker` message both ways.
- tests/gateway/test_gossip_mesh.py's cases, each run on the reference
  ([ref]) and on the port ([port]): UDP delivery with host-qualified
  origins, the TCP fallback above UDP_MAX_BYTES, the peer figures, a
  skewed wall clock that cannot resurrect a breaker, LLMLB_GOSSIP_FAULTS
  parsing, partition and heal, drop faults, and the rate limiter's global
  buckets (gossip on) and per-worker share (gossip off). The rebalancer's
  `migrate` directive has no subscriber in the port yet; its bus-level
  replay suppression is held here.
"""

import asyncio
import dataclasses
import json
import socket
import time
import types

import pytest

from llmlb_tpu.gateway import app_state as ref_app_state
from llmlb_tpu.gateway import config as ref_config
from llmlb_tpu.gateway import db as ref_db
from llmlb_tpu.gateway import gossip as ref_gossip
from llmlb_tpu.gateway import resilience as ref_resilience
from llmlb_tpu.gateway import types as ref_types
from llmlb_tpu.gateway import worker as ref_worker
from llmlb_tpu_torch.gateway import (
    app_state,
    config,
    db,
    gossip,
    resilience,
)
from llmlb_tpu_torch.gateway import types as gw_types
from llmlb_tpu_torch.gateway import worker

SIDES = {
    "ref": types.SimpleNamespace(
        gossip=ref_gossip, app_state=ref_app_state, config=ref_config,
        db=ref_db, resilience=ref_resilience, types=ref_types,
        worker=ref_worker),
    "port": types.SimpleNamespace(
        gossip=gossip, app_state=app_state, config=config, db=db,
        resilience=resilience, types=gw_types, worker=worker),
}

ORIGIN = "10.0.0.7:7946#w1"
SEQ = 41
TS = 1700000000.125


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return SIDES[request.param]


def _probe(cls: type) -> dict:
    """A JSON-safe value unlike the default for every declared field, by
    its annotation (a field added to a kind without a rule here fails)."""
    out = {}
    for f in dataclasses.fields(cls):
        ann = str(f.type)
        if "dict" in ann:
            v = {"probe": f.name, "n": 3, "nested": [1, "x"]}
        elif "float" in ann:
            v = 0.125
        elif "int" in ann:
            v = 7
        elif "str" in ann:
            v = f"probe-{f.name}-é"
        else:
            raise AssertionError(f"{cls.__name__}.{f.name}: {ann!r}")
        out[f.name] = v
    return out


KINDS = sorted(ref_gossip.MESSAGE_TYPES)


# ------------------------------------------------------------------- wire


def test_message_kinds_and_versions_match_the_reference():
    assert KINDS == sorted(gossip.MESSAGE_TYPES) and len(KINDS) == 11

    def shape(mod):
        return {k: (c.VERSION, [(f.name, repr(f.default)
                                 if f.default is not dataclasses.MISSING
                                 else repr(f.default_factory()))
                                for f in dataclasses.fields(c)])
                for k, c in mod.MESSAGE_TYPES.items()}

    assert shape(gossip) == shape(ref_gossip)
    for name in ("UDP_MAX_BYTES", "TCP_MAX_BYTES", "PEER_REFRESH_S",
                 "HELLO_INTERVAL_S", "PARTITION_SUSPECT_S",
                 "MEMBER_KEY_PREFIX", "GOSSIP_FAULT_KINDS"):
        assert getattr(gossip, name) == getattr(ref_gossip, name), name


@pytest.mark.parametrize("kind", KINDS)
def test_encoded_bytes_equal_the_references(kind):
    data = _probe(ref_gossip.MESSAGE_TYPES[kind])
    ours = gossip.encode_message(kind, data, origin=ORIGIN, seq=SEQ, ts=TS)
    ref = ref_gossip.encode_message(kind, data, origin=ORIGIN, seq=SEQ,
                                    ts=TS)
    assert ours == ref
    # the defaults too (an empty data dict)
    assert gossip.encode_message(kind, {}, origin="w0", seq=1, ts=TS) == \
        ref_gossip.encode_message(kind, {}, origin="w0", seq=1, ts=TS)


@pytest.mark.parametrize("kind", KINDS)
def test_each_package_decodes_the_others_bytes(kind):
    data = _probe(ref_gossip.MESSAGE_TYPES[kind])
    from_port = gossip.encode_message(kind, data, origin=ORIGIN, seq=SEQ,
                                      ts=TS)
    from_ref = ref_gossip.encode_message(kind, data, origin=ORIGIN, seq=SEQ,
                                         ts=TS)
    want_meta = {"origin": ORIGIN, "seq": SEQ, "ver": (SEQ, ORIGIN),
                 "ts": TS, "lag_s": 0.0}
    assert ref_gossip.decode_message(from_port) == (kind, data, want_meta)
    assert gossip.decode_message(from_ref) == (kind, data, want_meta)


def _bad_envelopes(mod):
    good = json.loads(mod.encode_message(
        "breaker", {"eid": "e", "to": "open"}, origin="w0", seq=3, ts=TS))
    yield "version", {**good, "v": good["v"] + 1}
    yield "field", {**good, "d": {**good["d"], "extra": 1}}
    yield "kind", {**good, "k": "no-such-kind"}
    yield "origin", {**good, "o": ""}
    yield "seq", {**good, "s": -1}
    yield "bool seq", {**good, "s": True}
    yield "data", {**good, "d": [1]}
    yield "ts", {**good, "ts": "soon"}


def test_wire_refusals_match_the_reference(pkg):
    for case, env in _bad_envelopes(pkg.gossip):
        raw = json.dumps(env).encode()
        with pytest.raises(pkg.gossip.GossipWireError) as ours:
            pkg.gossip.decode_message(raw)
        # the other package refuses the same bytes with the same message
        other = ref_gossip if pkg.gossip is gossip else gossip
        with pytest.raises(other.GossipWireError) as theirs:
            other.decode_message(raw)
        assert str(ours.value) == str(theirs.value), case
    for raw in (b"not json", b"[1]"):
        with pytest.raises(pkg.gossip.GossipWireError):
            pkg.gossip.decode_message(raw)
    with pytest.raises(pkg.gossip.GossipWireError, match="does not declare"):
        pkg.gossip.encode_message("tps", {"bogus": 1}, origin="w0", seq=1)
    with pytest.raises(pkg.gossip.GossipWireError, match="unknown gossip"):
        pkg.gossip.encode_message("bogus", {}, origin="w0", seq=1)


def test_versions_order_as_the_reference():
    clock, ref_clock = gossip.SeqClock(), ref_gossip.SeqClock()
    for c in (clock, ref_clock):
        c.tick()
        c.witness(9)
        c.witness(4)
    assert clock.tick() == ref_clock.tick() == 10
    cases = [(None, None), ((1, "w0"), None), (None, (1, "w0")),
             ((2, "w0"), (1, "w1")), ((1, "w1"), (1, "w0")),
             ((1, "w0"), (1, "w0")), ([3, "a"], (2, "z"))]
    for cand, cur in cases:
        assert gossip.newer(cand, cur) == ref_gossip.newer(cand, cur)


# ------------------------------------------------- one dir, two packages


async def _wait_for(predicate, timeout_s: float, interval_s: float = 0.005):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        await asyncio.sleep(interval_s)
    return predicate()


async def test_port_and_reference_buses_share_one_directory(tmp_path):
    """A port worker (w0) and a reference worker (w1) in one gossip
    directory: a breaker transition published by either reaches the
    other, with the sender's origin and version."""
    ours = gossip.GossipBus(str(tmp_path / "bus"), 0, expected_peers=1)
    ref = ref_gossip.GossipBus(str(tmp_path / "bus"), 1, expected_peers=1)
    await ours.start()
    await ref.start()
    got_ours, got_ref = [], []
    ours.subscribe("breaker", lambda d, m: got_ours.append((d, m["ver"])))
    ref.subscribe("breaker", lambda d, m: got_ref.append((d, m["ver"])))
    try:
        msg = {"eid": "e1", "to": "open", "reason": "failure threshold",
               "remaining_s": 9.5}
        v_ours = ours.publish("breaker", msg)
        assert await _wait_for(lambda: got_ref, 2.0)
        assert got_ref == [(msg, v_ours)] and v_ours == (1, "w0")
        back = {**msg, "to": "closed", "remaining_s": 0.0}
        v_ref = ref.publish("breaker", back)
        assert await _wait_for(lambda: got_ours, 2.0)
        assert got_ours == [(back, v_ref)]
        # the reference witnessed seq 1, so its stamp outranks ours
        assert gossip.newer(v_ref, v_ours) and v_ref == (2, "w1")
        for bus in (ours, ref):
            st = bus.stats()
            assert (st["sent_total"], st["received_total"],
                    st["recv_rejected_total"], st["peers"]) == (1, 1, 0, 1)
    finally:
        ours.close()
        ref.close()


async def test_replayed_datagrams_of_spend_kinds_apply_once(tmp_path, pkg):
    """rl_spend, retry_spend and migrate are not idempotent: a replayed
    datagram (same origin, same or older seq) is dropped at the bus; other
    kinds are delivered again (their receivers order by version)."""
    bus = pkg.gossip.GossipBus(str(tmp_path / "bus"), 0)
    await bus.start()
    seen = []
    for kind in ("rl_spend", "retry_spend", "migrate", "tps"):
        bus.subscribe(kind, lambda d, m, k=kind: seen.append((k, m["seq"])))
    try:
        for kind in ("rl_spend", "retry_spend", "migrate", "tps"):
            for seq in (5, 5, 4, 6):
                bus._on_datagram(pkg.gossip.encode_message(
                    kind, {}, origin="w1", seq=seq))
        assert seen == [("rl_spend", 5), ("rl_spend", 6),
                        ("retry_spend", 5), ("retry_spend", 6),
                        ("migrate", 5), ("migrate", 6),
                        ("tps", 5), ("tps", 5), ("tps", 4), ("tps", 6)]
        # our own message looped back is not applied, a bad one is counted
        bus._on_datagram(pkg.gossip.encode_message(
            "tps", {}, origin=bus.origin, seq=99))
        bus._on_datagram(b"{}")
        assert len(seen) == 10
        assert bus.stats()["recv_rejected_total"] == 1
        assert bus.clock.peek() == 6
    finally:
        bus.close()


# ------------------------------------------------------------- mesh cases


def _endpoint(pkg, name: str):
    return pkg.types.Endpoint(name=name, base_url=f"http://{name}:1234",
                              status=pkg.types.EndpointStatus.ONLINE)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


async def _worker_states(pkg, tmp_path, monkeypatch, n: int, *, gossip=True,
                         port=45716):
    monkeypatch.setenv("LLMLB_GOSSIP_DIR", str(tmp_path / "bus"))
    monkeypatch.setenv("LLMLB_GOSSIP", "1" if gossip else "0")
    db_path = str(tmp_path / "gw.db")
    cfg = pkg.config.ServerConfig(port=port, database_url=db_path)
    states = []
    for i in range(n):
        states.append(await pkg.app_state.build_app_state(
            cfg, db=pkg.db.Database(db_path), start_background=False,
            worker=pkg.worker.WorkerInfo(index=i, count=n),
        ))
    return states


async def _mesh_pair(pkg, tmp_path):
    """Two buses on DIFFERENT unix dirs joined only by loopback UDP."""
    pa, pb = _free_port(), _free_port()
    addr_a, addr_b = f"127.0.0.1:{pa}", f"127.0.0.1:{pb}"
    g = pkg.gossip
    bus_a = g.GossipBus(str(tmp_path / "host-a"), 0,
                        mesh=g.MeshConfig(bind=addr_a, advertise=addr_a,
                                          peers=(addr_b,)))
    bus_b = g.GossipBus(str(tmp_path / "host-b"), 0,
                        mesh=g.MeshConfig(bind=addr_b, advertise=addr_b,
                                          peers=(addr_a,)))
    await bus_a.start()
    await bus_b.start()
    return bus_a, bus_b


async def test_mesh_udp_delivery_and_origin_identity(tmp_path, pkg):
    bus_a, bus_b = await _mesh_pair(pkg, tmp_path)
    got = []
    try:
        bus_b.subscribe("tps", lambda d, m: got.append((d, m)))
        bus_a.publish("tps", {"eid": "e1", "model": "m", "kind": "chat",
                              "ema": 120.0, "samples": 3})
        assert await _wait_for(lambda: got, 2.0), "UDP datagram never arrived"
        data, meta = got[0]
        assert data["ema"] == 120.0
        assert meta["origin"] == bus_a.origin
        assert "#w0" in meta["origin"] and "127.0.0.1" in meta["origin"]
        assert bus_a.origin != bus_b.origin  # same index, different host
    finally:
        bus_a.close()
        bus_b.close()


async def test_mesh_tcp_fallback_for_oversize_payloads(tmp_path, pkg):
    bus_a, bus_b = await _mesh_pair(pkg, tmp_path)
    got = []
    try:
        bus_b.subscribe("heat", lambda d, m: got.append(d))
        entries = {f"prefixhash-{i:05d}": float(i) for i in range(4000)}
        payload = {"model": "m", "entries": entries}
        assert len(json.dumps(payload).encode()) > pkg.gossip.UDP_MAX_BYTES
        bus_a.publish("heat", payload)
        assert await _wait_for(lambda: got, 3.0), "oversize payload lost"
        assert got[0]["entries"] == entries
    finally:
        bus_a.close()
        bus_b.close()


async def test_mesh_stats_expose_peer_figures(tmp_path, pkg):
    bus_a, bus_b = await _mesh_pair(pkg, tmp_path)
    try:
        stats = bus_a.stats()
        for key in ("sent_total", "received_total", "recv_rejected_total",
                    "fault_dropped_total", "mesh_peers",
                    "partition_suspected"):
            assert key in stats, key
        assert bus_a.mesh_peer_count() == 1
        assert stats["partition_suspected"] is False
    finally:
        bus_a.close()
        bus_b.close()


async def test_skewed_wall_clock_cannot_resurrect_breaker_state(
        tmp_path, monkeypatch, pkg):
    """A replayed OPEN with a wall stamp an hour ahead but an old sequence
    number loses to the newer CLOSED transition."""
    Breaker = pkg.resilience.BreakerState
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2)
    try:
        ep = _endpoint(pkg, "engine-skew")
        s0.registry.add(ep)
        assert await _wait_for(lambda: s1.registry.get(ep.id) is not None,
                               2.0)
        threshold = s0.resilience.config.breaker_failure_threshold
        for _ in range(threshold):
            s0.resilience.record_failure(ep.id, "connect_error")
        assert await _wait_for(
            lambda: s1.resilience.state_of(ep.id) == Breaker.OPEN, 1.0)
        s0.resilience.note_probe(ep.id, True)
        s0.resilience.on_admit(ep.id)
        s0.resilience.record_success(ep.id)
        assert await _wait_for(
            lambda: s1.resilience.state_of(ep.id) == Breaker.CLOSED, 1.0)
        stale = pkg.gossip.encode_message(
            "breaker",
            {"eid": ep.id, "to": "open", "reason": "stale-replay",
             "remaining_s": 30.0},
            origin=s0.gossip.origin, seq=1, ts=time.time() + 3600.0,
        )
        s1.gossip._on_datagram(stale)
        await asyncio.sleep(0.05)
        assert s1.resilience.state_of(ep.id) == Breaker.CLOSED
        assert s1.resilience.allow(ep.id)
    finally:
        await s0.close()
        await s1.close()


def test_gossip_faults_env_parsing(monkeypatch, pkg):
    monkeypatch.setenv("LLMLB_GOSSIP_FAULTS", json.dumps([
        {"kind": "drop", "message": "tps", "probability": 1.0},
        {"kind": "partition", "groups": [["w0"], ["w1"]]},
        {"kind": "delay", "message": "heat", "every_n": 2, "delay_s": 0.5,
         "max_fires": 1},
    ]))
    faults = pkg.gossip.GossipFaults.from_env()
    assert faults is not None
    assert faults.decide("tps", "w0", "w1") == (True, 0.0)
    assert faults.decide("heat", "w2", "w3") == (False, 0.0)
    assert faults.decide("heat", "w2", "w3") == (False, 0.5)
    assert faults.decide("heat", "w2", "w3") == (False, 0.0)  # max_fires
    snap = faults.snapshot()
    assert [(r["kind"], r["seen"], r["fires"]) for r in snap] == [
        ("drop", 1, 1), ("partition", 0, 1), ("delay", 2, 1)]
    monkeypatch.setenv("LLMLB_GOSSIP_FAULTS", "not json")
    with pytest.raises(ValueError):
        pkg.gossip.GossipFaults.from_env()
    monkeypatch.setenv("LLMLB_GOSSIP_FAULTS", json.dumps([{"kind": "bogus"}]))
    with pytest.raises(ValueError):
        pkg.gossip.GossipFaults.from_env()
    monkeypatch.delenv("LLMLB_GOSSIP_FAULTS")
    assert pkg.gossip.GossipFaults.from_env() is None
    monkeypatch.setenv("LLMLB_GOSSIP_BIND", "0.0.0.0:7946")
    monkeypatch.setenv("LLMLB_GOSSIP_PEERS", " a:1, ,b:2 ")
    monkeypatch.delenv("LLMLB_GOSSIP_ADVERTISE", raising=False)
    mesh = pkg.gossip.MeshConfig.from_env()
    assert (mesh.bind, mesh.advertise, mesh.peers, mesh.enabled) == (
        "0.0.0.0:7946", "0.0.0.0:7946", ("a:1", "b:2"), True)
    assert [pkg.gossip.parse_addr(a) for a in
            ("h:1", "[::1]:2", "nope", ":3", "h:x")] == [
        ("h", 1), ("::1", 2), None, None, None]


async def test_partition_no_resurrection_and_heal(tmp_path, monkeypatch, pkg):
    Breaker = pkg.resilience.BreakerState
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45717)
    try:
        ep = _endpoint(pkg, "engine-part")
        s0.registry.add(ep)
        assert await _wait_for(lambda: s1.registry.get(ep.id) is not None,
                               2.0)
        wall = pkg.gossip.GossipFaults([pkg.gossip.GossipFaultRule(
            kind="partition", groups=[["w0"], ["w1"]])])
        s0.gossip.faults = wall
        s1.gossip.faults = wall
        threshold = s0.resilience.config.breaker_failure_threshold
        for _ in range(threshold):
            s0.resilience.record_failure(ep.id, "connect_error")
        assert s0.resilience.state_of(ep.id) == Breaker.OPEN
        await asyncio.sleep(0.1)
        assert s1.resilience.state_of(ep.id) == Breaker.CLOSED
        assert s0.gossip.stats()["fault_dropped_total"] > 0
        for _ in range(threshold):
            s1.resilience.record_failure(ep.id, "connect_error")
        assert not s1.resilience.allow(ep.id)

        wall.clear()
        s0.resilience.note_probe(ep.id, True)
        s0.resilience.on_admit(ep.id)
        s0.resilience.record_success(ep.id)
        assert s0.resilience.state_of(ep.id) == Breaker.CLOSED
        assert await _wait_for(
            lambda: s1.resilience.state_of(ep.id) == Breaker.CLOSED, 1.0
        ), "post-heal transition did not propagate"
        stale = pkg.gossip.encode_message(
            "breaker",
            {"eid": ep.id, "to": "open", "reason": "pre-partition",
             "remaining_s": 30.0},
            origin=s0.gossip.origin, seq=2, ts=time.time(),
        )
        s1.gossip._on_datagram(stale)
        await asyncio.sleep(0.05)
        assert s1.resilience.state_of(ep.id) == Breaker.CLOSED
    finally:
        await s0.close()
        await s1.close()


async def test_gossip_drop_faults_count_and_degrade(tmp_path, monkeypatch,
                                                    pkg):
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45718)
    try:
        ep = _endpoint(pkg, "engine-drop")
        s0.registry.add(ep)
        assert await _wait_for(lambda: s1.registry.get(ep.id) is not None,
                               2.0)
        s0.gossip.faults = pkg.gossip.GossipFaults([
            pkg.gossip.GossipFaultRule(kind="drop", message="tps",
                                       probability=1.0)])
        chat = pkg.types.TpsApiKind.CHAT
        s0.load_manager.update_tps(ep.id, "m", chat, 99, 1.0)
        await asyncio.sleep(0.1)
        assert s1.load_manager.get_tps(ep.id, "m", chat) is None
        assert s0.gossip.stats()["fault_dropped_total"] >= 1
    finally:
        await s0.close()
        await s1.close()


async def test_global_ratelimit_admits_n_fleet_wide(tmp_path, monkeypatch,
                                                    pkg):
    monkeypatch.setenv("LLMLB_RATELIMIT_RPS", "0.01")  # negligible refill
    monkeypatch.setenv("LLMLB_RATELIMIT_BURST", "8")
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45719)
    try:
        for s in (s0, s1):
            snap = s.ratelimit.snapshot()
            assert snap["global"] is True
            assert snap["workers_divisor"] == 1
        for _ in range(4):
            assert s0.ratelimit.acquire("tenant-a").allowed
        s0.ratelimit.flush_spends(force=True)
        assert await _wait_for(
            lambda: s1.ratelimit.snapshot()["remote_spends_applied"] >= 1,
            1.0,
        ), "rl_spend delta never reached the sibling"
        admitted = 0
        while s1.ratelimit.acquire("tenant-a").allowed:
            admitted += 1
            assert admitted < 16, "sibling ignored replicated spends"
        assert admitted == 4
        verdict = s1.ratelimit.acquire("tenant-a")
        assert not verdict.allowed and verdict.retry_after_s > 0
    finally:
        await s0.close()
        await s1.close()


async def test_ratelimit_without_gossip_enforces_local_share(
        tmp_path, monkeypatch, pkg):
    monkeypatch.setenv("LLMLB_RATELIMIT_RPS", "0.01")
    monkeypatch.setenv("LLMLB_RATELIMIT_BURST", "8")
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2,
                                  gossip=False, port=45720)
    try:
        snap = s0.ratelimit.snapshot()
        assert snap["global"] is False
        assert snap["workers_divisor"] == 2
        for s in (s0, s1):
            admitted = 0
            while s.ratelimit.acquire("tenant-b").allowed:
                admitted += 1
                assert admitted < 16
            assert admitted == 4  # 8-burst split across 2 workers
    finally:
        await s0.close()
        await s1.close()
