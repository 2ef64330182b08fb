"""The port's live-stream rebalancer (gateway/rebalance.py and the pump's
migration, gateway/api_openai.py `_migrate_stream`) held against the JAX
gateway's.

- The planner: the JAX package's Rebalancer and StreamDirectory and the
  port's, on the same scripted or seeded sequence of endpoint telemetry,
  stream registrations, claims, outcomes, goodput readings and clock
  steps, give the same directives (gossiped and marked), the same budget
  skips, the same metric calls and the same snapshots. The scripts are
  tests/gateway/test_rebalance.py's planner cases, each run on both
  packages with the reference's own assertions.
- The pump, end to end on the CPU: the JAX gateway and the port's, each in
  front of the same servers of the port's engine (debug-tiny), serve one
  armed greedy chat stream per case and must forward the same normalised
  SSE frames, which are also the unmoved stream's:
    * a hotspot directive moves the live stream: the origin parks and
      exports its KV pages, the target adopts them with no prefill, and
      the target's ids are the unmoved stream's;
    * a target that refuses the adopt (a drained server) leaves the stream
      on its origin;
    * an origin that cannot export (KV shipping off) aborts the move with
      the stream untouched;
    * with LLMLB_REBALANCE=0 nothing registers and nothing moves.
- Gossip: a `migrate` directive published on one port worker's bus marks
  the stream in a sibling's StreamDirectory; the planner runs on the
  primary worker only.
"""

import asyncio
import json
import random
import sys
import time
import types
import urllib.request

import pytest

from llmlb_tpu.gateway import rebalance as ref_rebalance
from llmlb_tpu.gateway import types as ref_types
from llmlb_tpu_torch.engine.flightrec import gateway_rid
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.gateway import http as gh
from llmlb_tpu_torch.gateway import rebalance
from llmlb_tpu_torch.gateway import types as gw_types
from tests.support import (
    ADMIN_PASSWORD,
    TEST_JWT_SECRET,
    GatewayHarness,
    assert_sse_protocol,
    parse_sse_frames,
)
from tests.test_torch_gateway_e2e import _PortGateway
from tests.test_torch_gateway_gossip import SIDES as GOSSIP_SIDES
from tests.test_torch_gateway_gossip import _wait_for, _worker_states

PKGS = {"ref": types.SimpleNamespace(rb=ref_rebalance, types=ref_types),
        "port": types.SimpleNamespace(rb=rebalance, types=gw_types)}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the JAX gateway estimates tokens with tiktoken, which would fetch its
    # BPE file over the network (ROADMAP C15): its ~4-characters fallback
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    monkeypatch.setenv("LLMLB_ADMIN_PASSWORD", ADMIN_PASSWORD)
    monkeypatch.setenv("LLMLB_JWT_SECRET", TEST_JWT_SECRET)


# ============================================================== the planner


class _Clock:
    def __init__(self):
        self.t = 5000.0

    def __call__(self):
        return self.t


class _Ep:
    def __init__(self, P, eid, *, active=0, queue=0, slots=8,
                 draining=False):
        self.P, self.id = P, eid
        self.endpoint_type = P.types.EndpointType.TPU
        self.set(active=active, queue=queue, slots=slots, draining=draining)

    def set(self, *, active=0, queue=0, slots=8, draining=False):
        self.accelerator = self.P.types.AcceleratorInfo(
            accelerator="tpu", num_slots=slots, active_slots=active,
            queue_depth=queue, draining=draining)


class _Registry:
    def __init__(self, eps):
        self.eps = eps

    def list_online(self):
        return list(self.eps)


class _Load:
    def __init__(self):
        self.active, self.tps = {}, {}

    def active_count(self, eid):
        return self.active.get(eid, 0)

    def tps_snapshot(self):
        return dict(self.tps)


class _Metrics:
    def __init__(self, goodput=None):
        self.goodput, self.calls = goodput, []

    def record_rebalance_migration(self, reason, outcome):
        self.calls.append((reason, outcome))

    def summary(self):
        return {"goodput_ratio": self.goodput}


class _Bus:
    def __init__(self):
        self.published = []

    def publish(self, kind, data, **kw):
        self.published.append((kind, data))


def _planner(P, eps, *, metrics=None, config=None, directory=None):
    bus, load = _Bus(), _Load()
    cfg = config or P.rb.RebalanceConfig()
    reb = P.rb.Rebalancer(
        _Registry(eps), load,
        directory or P.rb.StreamDirectory(P.rb.RebalanceConfig()),
        metrics=metrics, gossip=bus, config=cfg)
    return reb, bus, load


def _state(reb, bus, metrics=None, handles=()):
    return {"published": list(bus.published),
            "directives": reb.directives_total,
            "skipped": reb.skipped_budget_total,
            "snapshot": reb.snapshot(),
            "directory": reb.directory.snapshot(),
            "metrics": list(metrics.calls) if metrics else None,
            "handles": [(h.rid, h.endpoint_id, h.pending, h.migrating,
                         h.migrations, h.done, h.last_migrate_at)
                        for h in handles]}


# Each case is tests/gateway/test_rebalance.py's planner test of the same
# name, with its assertions, on package P; it returns what it observed.

def case_hotspot_needs_consecutive_hot_ticks(P, clock):
    reb, bus, _ = _planner(P, [_Ep(P, "hot", active=8, queue=3),
                               _Ep(P, "idle")])
    reb.tick()
    out = [_state(reb, bus)]
    assert bus.published == [] and reb.directives_total == 0
    reb.tick()
    assert bus.published == [("migrate", {
        "eid": "hot", "target": "idle", "reason": "hotspot",
        "max_streams": 1, "directive_id": 1})]
    return out + [_state(reb, bus)]


def case_hysteresis_resets_on_a_cool_tick(P, clock):
    hot, idle = _Ep(P, "hot", active=8, queue=3), _Ep(P, "idle")
    reb, bus, _ = _planner(P, [hot, idle])
    out = []
    for active, queue in ((8, 3), (1, 0), (8, 3), (8, 3)):
        hot.set(active=active, queue=queue)
        reb.tick()
        out.append(_state(reb, bus))
    assert [s["directives"] for s in out] == [0, 0, 0, 1]
    return out


def case_no_migration_between_the_bands(P, clock):
    out = []
    for eps in ([_Ep(P, "warm", active=5), _Ep(P, "idle")],
                [_Ep(P, "busy", active=8, queue=2), _Ep(P, "half", active=4)]):
        reb, bus, _ = _planner(P, eps)
        reb.tick()
        reb.tick()
        assert bus.published == []
        out.append(_state(reb, bus))
    return out


def case_goodput_gate_blocks_queueless_hotspots(P, clock):
    metrics = _Metrics(goodput=None)
    reb, bus, _ = _planner(P, [_Ep(P, "hot", active=8), _Ep(P, "idle")],
                           metrics=metrics)
    for _ in range(3):
        reb.tick()
    assert bus.published == []
    out = [_state(reb, bus, metrics)]
    metrics.goodput = 0.80
    reb.tick()
    assert reb.directives_total == 1
    return out + [_state(reb, bus, metrics)]


def case_budget_per_minute_records_skipped(P, clock):
    metrics = _Metrics()
    reb, bus, _ = _planner(P, [_Ep(P, "hot", active=8, queue=3),
                               _Ep(P, "idle")], metrics=metrics,
                           config=P.rb.RebalanceConfig(per_minute=1))
    out = []
    for _ in range(4):
        reb.tick()
        out.append(_state(reb, bus, metrics))
    assert (reb.directives_total, reb.skipped_budget_total) == (1, 1)
    assert ("hotspot", "skipped") in metrics.calls
    clock.t += 61.0  # the minute passes: the budget frees
    reb.tick()
    reb.tick()
    assert reb.directives_total == 2
    return out + [_state(reb, bus, metrics)]


def case_budget_max_concurrent_counts_inflight(P, clock):
    directory = P.rb.StreamDirectory(P.rb.RebalanceConfig())
    handles = [directory.register(f"r{i}", "m", "hot") for i in range(2)]
    assert directory.apply_directive("hot", "idle", "drain", 2, 1) == 2
    metrics = _Metrics()
    reb, bus, _ = _planner(P, [_Ep(P, "hot", active=8, queue=3),
                               _Ep(P, "idle")], metrics=metrics,
                           config=P.rb.RebalanceConfig(max_concurrent=2),
                           directory=directory)
    reb.tick()
    reb.tick()
    assert reb.directives_total == 0 and reb.skipped_budget_total == 1
    return [_state(reb, bus, metrics, handles)]


def case_drain_evacuation_targets_least_loaded(P, clock):
    directory = P.rb.StreamDirectory(P.rb.RebalanceConfig())
    handle = directory.register("r1", "m", "going")
    reb, bus, _ = _planner(P, [_Ep(P, "going", active=4, draining=True),
                               _Ep(P, "busy", active=6),
                               _Ep(P, "calm", active=1)],
                           directory=directory)
    reb.tick()
    assert bus.published == [("migrate", {
        "eid": "going", "target": "calm", "reason": "drain",
        "max_streams": 2, "directive_id": 1})]
    assert handle.pending == ("calm", "drain", 1)
    return [_state(reb, bus, None, [handle])]


def case_stream_window_blocks_repeat_migration(P, clock):
    directory = P.rb.StreamDirectory(
        P.rb.RebalanceConfig(stream_window_s=60.0))
    handle = directory.register("r1", "m", "a")
    got = [directory.apply_directive("a", "b", "hotspot", 1, 1),
           directory.claim(handle)]
    directory.note_outcome(handle, success=True, target="b")
    got += [(handle.endpoint_id, handle.migrations),
            directory.apply_directive("b", "a", "hotspot", 1, 2)]
    clock.t += 61.0  # outside the window it is eligible again
    got.append(directory.apply_directive("b", "a", "hotspot", 1, 3))
    assert got == [1, ("b", "hotspot", 1), ("b", 1), 0, 1]
    return got + [directory.snapshot()]


def case_directive_racing_natural_finish_dies_unclaimed(P, clock):
    directory = P.rb.StreamDirectory(P.rb.RebalanceConfig())
    handle = directory.register("r1", "m", "a")
    got = [directory.apply_directive("a", "b", "drain", 4, 1)]
    directory.unregister(handle)
    got += [directory.claim(handle), directory.inflight(),
            directory.snapshot()]
    assert got[1:3] == [None, 0] and got[3]["streams"] == 0
    return got


def case_disabled_directory_registers_nothing(P, clock):
    directory = P.rb.StreamDirectory(P.rb.RebalanceConfig(enabled=False))
    got = [directory.register("r1", "m", "a"), directory.counts()]
    assert got == [None, {}]
    return got


def case_oldest_streams_evacuate_first(P, clock):
    directory = P.rb.StreamDirectory(P.rb.RebalanceConfig())
    young = directory.register("young", "m", "a")
    clock.t += 0.0
    old = directory.register("old", "m", "a")
    old.started_at -= 100.0
    assert directory.apply_directive("a", "b", "drain", 1, 1) == 1
    assert old.pending is not None and young.pending is None
    return [(h.rid, h.pending) for h in (young, old)]


def case_no_stream_moves_in_a_hosts_first_window(P, clock):
    """A new stream's last-migration stamp is 0.0 on the monotonic clock,
    so while the host's clock reads less than stream_window_s (a host up
    under a minute) a directive marks nothing, in both packages (ROADMAP
    C21); the stream becomes eligible once the clock passes the window."""
    clock.t = 30.0
    directory = P.rb.StreamDirectory(P.rb.RebalanceConfig())
    handle = directory.register("r1", "m", "a")
    got = [directory.apply_directive("a", "b", "hotspot", 1, 1)]
    clock.t = 60.5
    got.append(directory.apply_directive("a", "b", "hotspot", 1, 2))
    assert got == [0, 1] and handle.pending == ("b", "hotspot", 2)
    return got


def _seeded(seed):
    def case(P, clock):
        """A seeded sequence: telemetry changes (occupancy, queue, slots,
        draining), TPS hints, gateway-side active counts, stream
        registrations and finishes, the pump's claims and outcomes,
        goodput readings, evacuations, ticks and clock steps."""
        rng = random.Random(seed)
        eps = [_Ep(P, f"e{i}") for i in range(4)]
        metrics = _Metrics()
        cfg = P.rb.RebalanceConfig(per_minute=4, max_concurrent=2,
                                   stream_window_s=30.0,
                                   high_water=0.75, low_water=0.3)
        directory = P.rb.StreamDirectory(cfg)
        reb, bus, load = _planner(P, eps, metrics=metrics, config=cfg,
                                  directory=directory)
        handles, out = [], []
        for step in range(160):
            clock.t += rng.choice([0.0, 0.5, 2.0, 7.5, 20.0])
            op = rng.random()
            ep = rng.choice(eps)
            if op < 0.25:
                ep.set(active=rng.randrange(0, 9), queue=rng.choice([0, 0, 3]),
                       slots=rng.choice([8, 8, 8, 0]),
                       draining=rng.random() < 0.08)
            elif op < 0.3:
                load.active[ep.id] = rng.randrange(0, 9)
                load.tps[f"{ep.id}:m:chat"] = {
                    "ema_tps": rng.choice([10.0, 50.0, 50.0])}
            elif op < 0.45:
                handles.append(directory.register(f"r{step}", "m", ep.id))
            elif op < 0.52 and handles:
                directory.unregister(handles.pop(rng.randrange(len(handles))))
            elif op < 0.67 and handles:
                h = rng.choice(handles)
                got = directory.claim(h)
                if got is not None:
                    directory.note_outcome(h, success=rng.random() < 0.7,
                                           target=got[0])
            elif op < 0.72:
                metrics.goodput = rng.choice([None, 0.99, 0.5])
            elif op < 0.75:
                reb.evacuate(ep.id, reason="restart")
            else:
                reb.tick()
            out.append((step, _state(reb, bus, metrics, handles),
                        directory.counts()))
        assert reb.directives_total > 0  # the sequence exercises the planner
        return out
    return case


CASES = {name[len("case_"):]: fn for name, fn in dict(globals()).items()
         if name.startswith("case_")}
CASES.update({f"seeded_{s}": _seeded(s) for s in range(4)})


@pytest.mark.parametrize("case", sorted(CASES))
def test_planner_matches_the_jax_planner(case, monkeypatch):
    seen = {}
    for side, P in PKGS.items():
        clock = _Clock()
        monkeypatch.setattr(time, "monotonic", clock)
        seen[side] = CASES[case](P, clock)
    assert seen["port"] == seen["ref"]


def test_config_from_env_matches(monkeypatch):
    knobs = {"LLMLB_REBALANCE": "0", "LLMLB_REBALANCE_INTERVAL": "0.25",
             "LLMLB_REBALANCE_HIGH": "0.1", "LLMLB_REBALANCE_LOW": "0.05",
             "LLMLB_REBALANCE_MAX_CONCURRENT": "3",
             "LLMLB_REBALANCE_PER_MINUTE": "9",
             "LLMLB_REBALANCE_STREAM_WINDOW": "5",
             "LLMLB_REBALANCE_MIN_GOODPUT": "0.5"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    ours, ref = (rebalance.RebalanceConfig.from_env(),
                 ref_rebalance.RebalanceConfig.from_env())
    assert vars(ours) == vars(ref)
    assert ours.enabled is False and ours.high_water == 0.1


# ================================================================= the pump

MESSAGES = [{"role": "user", "content": "move me between engines"}]
MAX_TOKENS = 40
MOVE_AFTER = 8  # ids the engines emit for the stream before the directive
EMIT_DELAY_S = 0.005  # a token's pace on every engine: the stream is live
SERVER_KW = dict(device="cpu", seed=0, num_slots=2, slot_capacity=512,
                 eos_id=-1, prefix_cache=False)


class _Server:
    """A port engine server whose engine paces each token and records,
    by gateway request id, the committed ids each adopted request came in
    with and the ids it emitted."""

    def __init__(self, **kw):
        self.engine = Engine.from_preset("debug-tiny",
                                         **{**SERVER_KW, **kw})
        core = self.engine.core
        self.parked: dict[str, list[int]] = {}
        self.emitted: dict[str, list[int]] = {}
        emit, submit = core._emit, core.submit

        def paced(slot_id, token):
            time.sleep(EMIT_DELAY_S)
            rid = gateway_rid(core.slots[slot_id].request.request_id)
            self.emitted.setdefault(rid, []).append(token)
            emit(slot_id, token)

        def watched(request):
            if request.parked is not None:
                self.parked[gateway_rid(request.request_id)] = list(
                    request.parked.tokens)
            return submit(request)

        core._emit, core.submit = paced, watched
        self.srv, self.thread = start_server(self.engine)
        self.url = "http://%s:%d" % self.srv.server_address[:2]

    def prefills(self) -> int:
        return self.engine.core.prefill_dispatches

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        self.engine.shutdown()


def _direct_ids(url: str) -> list[int]:
    body = {"model": "debug-tiny", "messages": MESSAGES, "temperature": 0,
            "max_tokens": MAX_TOKENS, "stream": True, "llmlb_replay": True}
    req = urllib.request.Request(url + "/v1/chat/completions",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        raw = resp.read()
    ids = []
    for frame in parse_sse_frames(raw):
        for d in frame["data"]:
            if d.startswith("{"):
                obj = json.loads(d)
                if obj.get("object") == "llmlb.replay":
                    ids.extend(obj["tokens"])
    return ids


@pytest.fixture(scope="module")
def servers():
    out = {"a": _Server(), "b": _Server(), "drained": _Server(),
           "no_ship": _Server(kv_ship=False)}
    try:
        req = urllib.request.Request(
            out["drained"].url + "/api/drain",
            data=json.dumps({"grace_s": 0}).encode(),
            headers={"Content-Type": "application/json"})
        urllib.request.urlopen(req, timeout=30).read()
        direct = _direct_ids(out["a"].url)
        assert len(direct) == MAX_TOKENS
        yield out, direct, []
    finally:
        for s in out.values():
            s.close()


class _Gateway:
    """One gateway, the JAX package's or the port's, in process."""

    @classmethod
    async def create(cls, side: str):
        self = cls()
        self.side = side
        if side == "ref":
            self.gw = await GatewayHarness.create()
            self.state = self.gw.state
            self.url = str(self.gw.client.make_url("")).rstrip("/")
            self.types = ref_types
            self.headers = await self.gw.inference_headers()
        else:
            self.gw = await _PortGateway.create()
            self.state, self.url, self.types = (self.gw.state, self.gw.url,
                                                gw_types)
            async with gh.ClientSession() as s:
                r = await s.post(self.url + "/api/auth/login", json={
                    "username": "admin", "password": ADMIN_PASSWORD})
                admin = {"Authorization":
                         "Bearer " + (await r.json())["token"]}
                r = await s.post(self.url + "/api/api-keys",
                                 json={"name": "t"}, headers=admin)
                self.headers = {"Authorization":
                                "Bearer " + (await r.json())["api_key"]}
        return self

    def register(self, server: _Server, name: str):
        """The server as an online `tpu` endpoint serving debug-tiny, added
        to the registry directly (as the reference's harness does)."""
        T = self.types
        ep = T.Endpoint(name=name, base_url=server.url,
                        endpoint_type=T.EndpointType.TPU,
                        status=T.EndpointStatus.ONLINE)
        self.state.registry.add(ep)
        self.state.registry.sync_models(ep.id, [T.EndpointModel(
            endpoint_id=ep.id, model_id="debug-tiny",
            canonical_name="debug-tiny",
            capabilities=[T.Capability.CHAT_COMPLETION])])
        return ep

    async def close(self):
        await self.gw.close()


def _norm(raw: bytes) -> list:
    """SSE frames with the per-response id and creation time masked."""
    out = []
    for frame in parse_sse_frames(raw):
        data = []
        for d in frame["data"]:
            obj = json.loads(d) if d.startswith("{") else d
            if isinstance(obj, dict):
                obj = {k: "*" if k in ("id", "created") else v
                       for k, v in obj.items()}
            data.append(obj)
        out.append((frame["event"], data))
    return out


async def _stream(gw: _Gateway, servers: dict,
                  on_live=None) -> tuple[int, bytes]:
    """One armed greedy chat stream through `gw`; once the engines have
    emitted MOVE_AFTER of its ids, `await on_live()`; the status and every
    byte the client got."""
    body = {"model": "debug-tiny", "messages": MESSAGES, "temperature": 0,
            "max_tokens": MAX_TOKENS, "stream": True}

    def emitted() -> int:
        return sum(len(ids) for s in servers.values()
                   for ids in s.emitted.values())

    async def read() -> tuple[int, bytes]:
        async with gh.ClientSession() as s:
            r = await s.post(gw.url + "/v1/chat/completions", json=body,
                             headers=gw.headers)
            return r.status, await r.read()

    before = emitted()
    task = asyncio.ensure_future(read())
    if on_live is not None:
        assert await _wait_for(
            lambda: emitted() - before >= MOVE_AFTER or task.done(), 10.0)
        assert not task.done(), "the stream ended before the directive"
        await on_live()
    return await task


async def _run_case(case: str, side: str, srv: dict) -> dict:
    gw = await _Gateway.create(side)
    try:
        st = gw.state
        if case in ("migrate", "off", "plain"):
            eps = [gw.register(srv["a"], "a"), gw.register(srv["b"], "b")]
        else:
            origin_srv = srv["a"] if case == "refuse" else srv["no_ship"]
            eps = [gw.register(origin_srv, "origin")]
        target_srv = {"refuse": srv["drained"], "abort": srv["a"]}.get(case)
        moved = {}

        async def on_live():
            if case == "off":
                moved["marked"] = [st.streams.apply_directive(
                    a.id, b.id, "hotspot", 1, 1)
                    for a, b in (eps, eps[::-1])]
                moved["registered"] = dict(st.streams._streams)
                return
            assert await _wait_for(lambda: len(st.streams._streams) == 1,
                                   3.0)
            handle = next(iter(st.streams._streams.values()))
            if target_srv is not None:
                eps.append(gw.register(target_srv, "target"))
            origin = next(e for e in eps if e.id == handle.endpoint_id)
            target = next(e for e in eps if e.id != origin.id)
            by_url = {s.url: s for s in srv.values()}
            moved.update(rid=handle.rid, handle=handle, target_id=target.id,
                         origin=by_url[origin.base_url],
                         target=by_url[target.base_url],
                         prefills=by_url[target.base_url].prefills())
            moved["marked"] = st.streams.apply_directive(
                origin.id, target.id, "hotspot", 1, 1)

        status, raw = await _stream(gw, srv,
                                    None if case == "plain" else on_live)
        summary = st.metrics.summary()
        return {"status": status, "frames": _norm(raw), "raw": raw,
                "migrations": summary["rebalance_migrations"],
                "resumes": summary["stream_resumes"],
                "interruptions": summary["stream_interruptions_total"],
                "streams": st.streams.snapshot(), **moved}
    finally:
        await gw.close()


def _check_case(case: str, got: dict, direct: list) -> None:
    assert got["status"] == 200
    assert b"event: error" not in got["raw"]
    assert_sse_protocol(got["raw"], "openai")
    assert got["resumes"] == {} and got["interruptions"] == 0
    assert got["streams"]["streams"] == 0  # unregistered at the end
    if case == "off":
        assert got["marked"] == [0, 0] and got["registered"] == {}
        assert got["migrations"] == {}
        return
    outcome = {"migrate": "success", "refuse": "refused",
               "abort": "aborted"}[case]
    assert got["marked"] == 1
    assert got["migrations"] == {f"hotspot/{outcome}": 1}
    origin, target, rid = got["origin"], got["target"], got["rid"]
    handle = got["handle"]
    emitted = origin.emitted[rid]
    assert emitted == direct[:len(emitted)]
    if case == "migrate":
        # the target adopted the committed ids with the shipped pages (no
        # prefill) and went on with the unmoved stream's ids
        committed = target.parked[rid]
        assert 0 < len(committed) < MAX_TOKENS
        assert committed + target.emitted[rid] == direct
        assert target.prefills() == got["prefills"]
        assert (handle.endpoint_id, handle.migrations) == (got["target_id"],
                                                           1)
    else:
        # the stream stayed on its origin to the end
        assert emitted == direct
        assert rid not in target.emitted
        assert handle.migrations == 0


@pytest.mark.parametrize("case", ["migrate", "refuse", "abort", "off"])
async def test_pump_matches_the_jax_gateway(servers, monkeypatch, case):
    srv, direct, unmoved = servers
    if not unmoved:  # the stream no directive touches, once a module
        unmoved.append(_norm((await _run_case("plain", "port", srv))["raw"]))
    if case == "off":
        monkeypatch.setenv("LLMLB_REBALANCE", "0")
    got = {}
    for side in ("ref", "port"):
        got[side] = await _run_case(case, side, srv)
        _check_case(case, got[side], direct)
    assert got["port"]["frames"] == got["ref"]["frames"]
    assert got["port"]["migrations"] == got["ref"]["migrations"]
    # the client's stream is the unmoved one, frame for frame
    assert got["port"]["frames"] == unmoved[0]


# ================================================================== gossip


@pytest.fixture(params=["ref", "port"])
def pkg(request):
    return GOSSIP_SIDES[request.param]


async def test_migrate_directive_reaches_a_sibling(tmp_path, monkeypatch,
                                                   pkg):
    s0, s1 = await _worker_states(pkg, tmp_path, monkeypatch, 2, port=45731)
    try:
        handle = s1.streams.register("r-1", "m", "engine-a")
        s0.gossip.publish("migrate", {
            "eid": "engine-a", "target": "engine-b", "reason": "drain",
            "max_streams": 1, "directive_id": 7})
        assert await _wait_for(lambda: handle.pending is not None, 1.0)
        assert handle.pending == ("engine-b", "drain", 7)
        assert s1.streams.inflight() == 1
        assert s0.streams.snapshot()["streams"] == 0  # never looped back
    finally:
        await s0.close()
        await s1.close()


async def test_planner_runs_on_the_primary_only(tmp_path, monkeypatch, pkg):
    monkeypatch.setenv("LLMLB_GOSSIP_DIR", str(tmp_path / "bus"))
    monkeypatch.setenv("LLMLB_REBALANCE_INTERVAL", "3600")
    monkeypatch.setenv("LLMLB_HEALTH_CHECK_INTERVAL", "3600")
    db_path = str(tmp_path / "gw.db")
    cfg = pkg.config.ServerConfig(port=45733, database_url=db_path)
    states = [await pkg.app_state.build_app_state(
        cfg, db=pkg.db.Database(db_path), start_background=True,
        worker=pkg.worker.WorkerInfo(index=i, count=2)) for i in range(2)]
    try:
        assert states[0].rebalancer is not None
        assert states[1].rebalancer is None
        assert states[0].rebalancer.directory is states[0].streams
        assert states[0].rebalancer.gossip is states[0].gossip
    finally:
        for s in states:
            await s.close()
