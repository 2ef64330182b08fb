"""KV page shipping and the host-RAM offload tier of the port, against the
JAX package: counterpart of tests/engine/test_kv_transfer.py.

- The KVSH wire: the port's blob is the JAX package's byte for byte (f32,
  bf16 and int8 sections), every header field round-trips between the two
  parsers, corrupted payloads raise the same labelled errors, and
  `kv_compat_reason` names dtype, page size and geometry as the reference
  does. The offload tier's budget, LRU and head-match rules.
- A blob the JAX engine exports (POST /v1/kv/export's park of a live
  stream) lands in the port's pool bit for bit, and the port's lands in
  the JAX engine's, for f32 and int8 pools; each adopted stream goes on
  with the JAX engine's uninterrupted greedy tokens.
- Over HTTP: a park and export on one port server and `/v1/resume` with
  the `kv_pages` on another give the uninterrupted tokens with no prefill
  dispatch on the adopter; the unchanged gateway's `_migrate_stream`
  between two port servers returns "success" (before this slice the
  port's server did not route /v1/kv/export, and every migration returned
  "aborted").
- A prefix evicted to the offload tier under page pressure restores, and
  the first-token logits of its hit equal the live-cache hit's; a parked
  row re-activates from the tier with no prefill.
- An incompatible or missing payload falls back to the replay, with the
  uninterrupted tokens, and counts its labelled reason.

debug-tiny in fp32 on the CPU (pools compare bit for bit, streams token
for token). One JAX EngineCore per pool dtype, module-scoped.
"""

import asyncio
import base64
import dataclasses
import http.client
import json
import time
import urllib.error
import urllib.request

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from llmlb_tpu.engine import kv_offload as jax_offload
from llmlb_tpu.engine import kv_transfer as jax_kv
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import ParkedState as JaxParked
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.gateway.api_openai import _migrate_stream
from llmlb_tpu.gateway.replay import ReplayState
from llmlb_tpu.gateway.types import EndpointType
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine import kv_offload as port_offload
from llmlb_tpu_torch.engine import kv_transfer as port_kv
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    ParkedState,
    Request,
    SamplingParams,
)
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer, default_chat_template
from llmlb_tpu_torch.engine.weights import params_from_numpy
from tests.support import GatewayHarness

CFG = get_preset("debug-tiny")
CORE_KW = dict(slot_capacity=256, prefill_buckets=(16, 32), kv_page_size=16,
               eos_id=-1, seed=0, prefix_cache=False)
PROMPT = list(range(40, 60))  # 20 tokens: two pages of 16
MAX_TOKENS = 40
PARK_AFTER = 8

# ---------------------------------------------------------------- the wire

MODS = {"jax": jax_kv, "port": port_kv}


def _header(mod, **over):
    base = dict(version=1, layers=2, page_size=4, num_kv_heads=2, head_dim=4,
                kv_dtype="float32", tokens=6, num_pages=2)
    base.update(over)
    return mod.KVWireHeader(**base)


def _sections(mod, header) -> dict:
    """Distinct values per section, in each package's array dtype (the JAX
    package holds bfloat16 as ml_dtypes', the port as raw int16 bits)."""
    out = {}
    for i, (name, (shape, dtype)) in enumerate(
            sorted(mod.expected_sections(header).items())):
        vals = (np.arange(int(np.prod(shape)), dtype=np.float64) % 97 + i
                ).reshape(shape)
        if dtype != "bfloat16":
            out[name] = vals.astype(dtype)
            continue
        bf = vals.astype(ml_dtypes.bfloat16)
        out[name] = bf if mod is jax_kv else bf.view(np.int16)
    return out


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16", "float16",
                                      "int8"])
def test_blobs_are_the_jax_packages_byte_for_byte(kv_dtype):
    blobs = {}
    for name, mod in MODS.items():
        header = _header(mod, kv_dtype=kv_dtype)
        blobs[name] = mod.serialize_kv_pages(header, _sections(mod, header))
    assert blobs["port"] == blobs["jax"]
    # each package parses the other's blob into the same bytes
    for a, b in (("jax", "port"), ("port", "jax")):
        parsed = MODS[b].parse_kv_payload(blobs[a])
        want = _sections(MODS[b], _header(MODS[b], kv_dtype=kv_dtype))
        assert sorted(parsed.sections) == sorted(want)
        for key, arr in want.items():
            got = parsed.sections[key]
            assert got.dtype == arr.dtype
            assert got.tobytes() == arr.tobytes()


@pytest.mark.parametrize("field", [f.name for f in dataclasses.fields(
    port_kv.KVWireHeader)])
def test_every_header_field_round_trips(field):
    """Each declared field takes a value of its own and crosses both ways;
    the field sets of the two packages are one."""
    assert [f.name for f in dataclasses.fields(port_kv.KVWireHeader)] == \
        [f.name for f in dataclasses.fields(jax_kv.KVWireHeader)]
    over = {"version": 1, "layers": 3, "page_size": 8, "num_kv_heads": 5,
            "head_dim": 6, "kv_dtype": "int8", "tokens": 7,
            "num_pages": 3}[field]
    for src, dst in (("port", "jax"), ("jax", "port")):
        header = _header(MODS[src], **{field: over})
        payload = MODS[src].serialize_kv_pages(header,
                                               _sections(MODS[src], header))
        got = MODS[dst].parse_kv_payload(payload).header
        assert getattr(got, field) == over
        assert dataclasses.asdict(got) == dataclasses.asdict(header)
    payload["extra"] = 1  # an undeclared field is refused
    with pytest.raises(port_kv.KVTransferError, match="unknown"):
        port_kv.parse_kv_header(payload)


def _corrupt_trailing(p):
    p["data"] = base64.b64encode(base64.b64decode(p["data"]) + b"\0"
                                 ).decode("ascii")


@pytest.mark.parametrize("mutate", [
    lambda p: p.pop("data"),
    lambda p: p.update(data="!!not-base64!!"),
    lambda p: p.update(data=p["data"][:16]),
    lambda p: p.update(data=p["data"][:-8] + p["data"][:8]),
    lambda p: p.update(tokens=0),
    lambda p: p.update(tokens=10_000),
    lambda p: p.update(layers=True),
    lambda p: p.update(kv_dtype="float8"),
    lambda p: p.update(num_pages=0),
    lambda p: p.update(version=2),
    _corrupt_trailing,
])
def test_corrupted_payloads_raise_the_references_errors(mutate):
    errors = {}
    for name, mod in MODS.items():
        header = _header(mod)
        payload = mod.serialize_kv_pages(header, _sections(mod, header))
        mutate(payload)
        with pytest.raises(mod.KVTransferError) as err:
            mod.parse_kv_payload(payload)
        errors[name] = (str(err.value), err.value.reason)
    assert errors["port"] == errors["jax"]


@pytest.mark.parametrize("over,reason", [
    ({}, None),
    ({"kv_dtype": "int8", "page_size": 8, "layers": 9}, "dtype"),
    ({"page_size": 8, "layers": 9}, "page_size"),
    ({"layers": 9}, "geometry"),
    ({"num_kv_heads": 1}, "geometry"),
    ({"head_dim": 8}, "geometry"),
])
def test_compat_reasons_are_the_references(over, reason):
    me = dict(layers=2, page_size=4, num_kv_heads=2, head_dim=4,
              kv_dtype="float32")
    for mod in MODS.values():
        assert mod.kv_compat_reason(_header(mod, **over), **me) == reason


# ------------------------------------------------------------ offload tier


def _kvp(mod, tokens=4, num_pages=1):
    header = _header(mod, tokens=tokens, num_pages=num_pages, page_size=4,
                     layers=1, num_kv_heads=1, head_dim=2)
    return mod.KVPages(header=header, sections=_sections(mod, header),
                       source="offload")


@pytest.mark.parametrize("impl", ["jax", "port"])
def test_offload_tier_budget_lru_head_match_and_parked(impl):
    mod = MODS[impl]
    Tier = {"jax": jax_offload, "port": port_offload}[impl].KVOffloadTier
    one = _kvp(mod).nbytes
    tier = Tier(budget_bytes=2 * one)
    assert tier.put_prefix(None, (1, 2, 3, 4), _kvp(mod))
    assert tier.put_prefix(None, (5, 6, 7, 8), _kvp(mod))
    assert tier.put_parked("rid-1", _kvp(mod))  # evicts the LRU entry
    assert tier.bytes_used == 2 * one and tier.evictions == 1
    assert tier.match_prefix(None, (1, 2, 3, 4), 4) is None
    assert tier.match_prefix("other", (5, 6, 7, 8), 4) is None
    assert tier.match_prefix(None, (5, 6, 9, 8), 4) is None
    got = tier.match_prefix(None, (5, 6, 7, 8, 9), 3)  # a longer entry's head
    assert got is not None and got[0] == (5, 6, 7, 8)
    assert tier.pop_parked("rid-1") is not None
    assert tier.pop_parked("rid-1") is None
    assert not Tier(budget_bytes=8).put_prefix(None, (1,), _kvp(mod))
    info = tier.info()
    assert (info["hits"], info["misses"], info["bytes"]) == (2, 4, 0)


# ------------------------------------------------------- the two engines


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


def _drain(events, timeout=120):
    toks = []
    while True:
        kind, value = events.get(timeout=timeout)
        if kind == "token":
            toks.append(int(value))
        elif kind == "error":
            raise AssertionError(f"engine error: {value}")
        else:
            return toks, value


def _first(events, n, timeout=120):
    toks = []
    while len(toks) < n:
        kind, value = events.get(timeout=timeout)
        assert kind == "token", (kind, value)
        toks.append(int(value))
    return toks


@pytest.fixture(scope="module", params=[None, "kv"], ids=["f32", "int8"])
def jax_core(request, weights):
    """A JAX engine of one pool dtype, and its uninterrupted greedy stream
    of PROMPT."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", decode_burst=1, num_slots=2,
                         quantize=request.param, **CORE_KW)
    core.start()
    try:
        ref, _ = _drain(core.submit(JaxRequest(
            prompt_ids=list(PROMPT), sampling=JaxSampling(
                temperature=0.0, max_tokens=MAX_TOKENS))).events)
        yield core, request.param, ref
    finally:
        core.stop()


def _port_core(weights, **kw) -> EngineCore:
    return EngineCore(CFG, params_from_numpy(weights[1], CFG, "cpu"),
                      device="cpu", **{**CORE_KW, "num_slots": 2, **kw})


def _step(core) -> None:
    """One iteration of the step loop's body, on this thread."""
    if core._park_rids:
        rids, core._park_rids = core._park_rids, set()
        core._park_requested(rids)
    core._try_insert()
    core._advance_prefill()
    core._decode_active()


def _run(core, request, limit=2000) -> tuple[list[int], str]:
    for _ in range(limit):
        _step(core)
        if request.finished_at is not None:
            return _drain(request.events)
    raise AssertionError("request did not finish")


def _rows(sections: dict, rows: int) -> dict:
    """Each section's first `rows` positions over its pages in order."""
    out = {}
    for name, a in sections.items():
        a = np.asarray(a)
        flat = a.reshape(a.shape[0], a.shape[1] * a.shape[2], *a.shape[3:])
        out[name] = flat[:, :rows]
    return out


def _same_rows(got: dict, want: dict, rows: int) -> None:
    got, want = _rows(got, rows), _rows(want, rows)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].tobytes() == want[name].tobytes(), name


def test_jax_export_lands_in_the_port_pool(jax_core, weights):
    """The JAX engine parks a live stream for a migration and exports its
    pages; the port adopts them: the landed rows are the JAX pool's bytes,
    no prefill runs, and the stream goes on with the JAX tokens."""
    core, mode, ref = jax_core
    req = core.submit(JaxRequest(
        prompt_ids=list(PROMPT), request_id="mig-j.0123abcd",
        sampling=JaxSampling(temperature=0.0, max_tokens=400)))
    committed = _first(req.events, PARK_AFTER)
    core.request_park("mig-j")
    deadline = time.monotonic() + 30
    payload = None
    while payload is None and time.monotonic() < deadline:
        payload = core.take_kv_export("mig-j")
        time.sleep(0.005)
    req.cancel()
    assert payload is not None, "the JAX engine exported nothing"
    kvp = port_kv.parse_kv_payload(payload)
    port = _port_core(weights, quantize=mode)
    try:
        assert port.kv_restore_reason(kvp.header) is None
        adopt = port.submit(Request(
            prompt_ids=list(PROMPT),
            sampling=SamplingParams(temperature=0.0, max_tokens=MAX_TOKENS),
            parked=ParkedState(len(committed), committed), kv_restore=kvp))
        port._try_insert()
        slot = next(i for i, s in enumerate(port.slots)
                    if s.request is adopt)
        n = len(PROMPT) + len(committed)
        landed = port._gather_kv_sections(port._slot_pages[slot])
        _same_rows(landed, kvp.sections, n - 1)
        assert int(port._seq_lens[slot]) == n - 1
        ids, reason = _run(port, adopt)
        assert committed + ids == ref and reason == "length"
        assert port.prefill_dispatches == 0
        info = port.kv_transfer_info()
        assert info["restored_total"] == 1
        assert info["restored_bytes_total"] == kvp.nbytes
    finally:
        port.stop()


def test_port_export_lands_in_the_jax_pool(jax_core, weights):
    core, mode, ref = jax_core
    port = _port_core(weights, quantize=mode)
    try:
        req = port.submit(Request(
            prompt_ids=list(PROMPT), request_id="mig-p.0123abcd",
            sampling=SamplingParams(temperature=0.0, max_tokens=400)))
        while len(port.slots[0].out_tokens) < PARK_AFTER:
            _step(port)
        committed = list(port.slots[0].out_tokens)
        port.request_park("mig-p")
        _step(port)
        payload = port.take_kv_export("mig-p")
        assert payload is not None and port.take_kv_export("mig-p") is None
        assert payload["tokens"] == len(PROMPT) + len(committed) - 1
        req.cancel()
        assert port.kv_transfer_info()["ship_total"] == 1
    finally:
        port.stop()
    kvp = jax_kv.parse_kv_payload(payload)
    landed = []
    land = core._land_kv_pages

    def spy(k, fresh):
        land(k, fresh)
        landed.append(core._gather_kv_sections(fresh))

    core._land_kv_pages = spy
    try:
        restored0 = core.kv_transfer_info()["restored_total"]
        ids, reason = _drain(core.submit(JaxRequest(
            prompt_ids=list(PROMPT), sampling=JaxSampling(
                temperature=0.0, max_tokens=MAX_TOKENS),
            parked=JaxParked(generated=len(committed), tokens=committed),
            kv_restore=kvp)).events)
    finally:
        del core._land_kv_pages
    assert committed + ids == ref and reason == "length"
    assert core.kv_transfer_info()["restored_total"] == restored0 + 1
    assert len(landed) == 1
    _same_rows(landed[0], kvp.sections, kvp.header.tokens)


# ------------------------------------------------------------------ HTTP

MESSAGES = [{"role": "user", "content": "ship my pages"}]


class _Server:
    def __init__(self, weights, **kw):
        self.engine = Engine.from_preset(
            "debug-tiny", device="cpu",
            params=params_from_numpy(weights[1], CFG, "cpu"),
            **{**CORE_KW, "num_slots": 2, "slot_capacity": 512, **kw})
        self.srv, self.thread = start_server(self.engine)
        self.host, self.port = self.srv.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        self.engine.shutdown()


def _body(max_tokens):
    return {"model": "debug-tiny", "messages": MESSAGES, "temperature": 0,
            "max_tokens": max_tokens, "stream": True, "llmlb_replay": True}


def _post(url, body, headers=None, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json",
                                          **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _replay_ids(raw: bytes) -> list[int]:
    ids = []
    for line in raw.split(b"\n"):
        if line.startswith(b"data: {"):
            obj = json.loads(line[len(b"data: "):])
            if obj.get("object") == "llmlb.replay":
                ids.extend(obj["tokens"])
    return ids


def _open_stream(server, body, rid):
    """An armed stream on `server`, read until PARK_AFTER replay ids; the
    open connection and the ids."""
    conn = http.client.HTTPConnection(server.host, server.port, timeout=60)
    conn.request("POST", "/v1/chat/completions", json.dumps(body),
                 {"Content-Type": "application/json", "X-Request-Id": rid})
    resp = conn.getresponse()
    ids = []
    while len(ids) < PARK_AFTER:
        ids.extend(_replay_ids(resp.readline()))
    return conn, ids


@pytest.fixture(scope="module")
def servers(weights):
    a, b = _Server(weights), _Server(weights)
    full = _replay_ids(_post(a.url + "/v1/chat/completions", _body(470)))
    assert len(full) == 470
    yield a, b, full
    a.close()
    b.close()


def test_park_export_and_resume_with_pages_over_http(servers):
    a, b, full = servers
    conn, ids = _open_stream(a, _body(470), "ship-1")
    out = json.loads(_post(a.url + "/v1/kv/export",
                           {"request_id": "ship-1", "park": True}))
    conn.close()  # the client leaves the origin: its copy is cancelled
    assert out["object"] == "llmlb.kv_export"
    pages = out["kv_pages"]
    prompt = ByteTokenizer(CFG.vocab_size).encode(
        default_chat_template(MESSAGES))
    assert pages["tokens"] >= len(prompt) + len(ids) - 1
    with pytest.raises(urllib.error.HTTPError) as err:  # taken once
        _post(a.url + "/v1/kv/export", {"request_id": "ship-1"})
    assert err.value.code == 404
    before = b.engine.core.prefill_dispatches
    raw = _post(b.url + "/v1/resume", {**_body(470), "committed_ids": ids,
                                       "kv_pages": pages})
    assert _replay_ids(raw) == full
    assert b.engine.core.prefill_dispatches == before
    with urllib.request.urlopen(b.url + "/api/health", timeout=30) as r:
        kv = json.loads(r.read())["kv_transfer"]
    assert kv["ship_enabled"] and kv["restored_total"] >= 1
    assert kv["ship_fallback_total"]["capacity"] == 0


def test_export_validation_and_drain_exemption(weights):
    s = _Server(weights)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(s.url + "/v1/kv/export", {"request_id": ""})
        assert err.value.code == 400
        assert json.loads(err.value.read())["error"]["message"] == \
            "'request_id' must be a non-empty string"
        _post(s.url + "/api/drain", {"grace_s": 30})
        # draining: new work is refused, the export still answers
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(s.url + "/v1/kv/export", {"request_id": "none"})
        assert err.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(s.url + "/v1/resume", {**_body(4), "committed_ids": []})
        assert err.value.code == 503
    finally:
        s.close()


async def test_gateway_migrates_a_stream_between_two_port_servers(servers):
    """The unchanged gateway's planner-directed migration: park on the
    origin (POST /v1/kv/export {"park": true}), then /v1/resume with the
    pages on the target. It returned "aborted" against the port before this
    slice (no /v1/kv/export route); now "success", and the target's stream
    carries the uninterrupted ids with no prefill dispatch."""
    a, b, full = servers
    gw = await GatewayHarness.create()
    try:
        eps = [gw.register_mock(s.url, ["debug-tiny"],
                                endpoint_type=EndpointType.TPU,
                                name=f"port{i}")
               for i, s in enumerate((a, b))]
        conn, ids = await asyncio.to_thread(_open_stream, a, _body(470),
                                            "mig-1")
        replay = ReplayState(_body(470), rid="mig-1")
        replay.origin = eps[0]
        replay.committed = list(ids)
        before = b.engine.core.prefill_dispatches
        migrated, outcome = await _migrate_stream(gw.state, replay,
                                                  eps[1].id, "debug-tiny")
        conn.close()
        assert outcome == "success"
        resumed, target, iterator, first = migrated
        assert target.id == eps[1].id
        raw = first + b"".join([chunk async for chunk in iterator])
        resumed.release()
        assert _replay_ids(raw) == full
        assert b.engine.core.prefill_dispatches == before
    finally:
        await gw.close()


# ----------------------------------------------------------- offload tier


def test_offloaded_prefix_restores_with_the_live_hits_logits(weights):
    """A: cold (donates its head), then a live-cache hit; B: its pages
    evict A's entry to the host tier; A again: the tier lands A's head
    back, and the hit's first-token logits equal the live hit's bit for
    bit, with one suffix dispatch."""
    rng = np.random.default_rng(11)
    a = [int(t) for t in rng.integers(1, CFG.vocab_size, size=48)]
    b = [int(t) for t in rng.integers(1, CFG.vocab_size, size=48)]
    core = _port_core(weights, prefill_buckets=(16,), slot_capacity=64,
                      kv_pages=6, prefix_cache=True,
                      kv_offload_bytes=1 << 28)
    logits = []
    activate = core._activate_group

    def spy(group, slot_ids, lens, out):
        logits.append(out[0].clone())
        activate(group, slot_ids, lens, out)

    core._activate_group = spy

    def run(prompt):
        return _run(core, core.submit(Request(
            prompt_ids=list(prompt),
            sampling=SamplingParams(temperature=0.0, max_tokens=4))))

    try:
        cold = run(a)
        live = run(a)
        run(b)
        assert core.kv_transfer_info()["offload"]["prefix_entries"] == 1
        before = core.prefill_dispatches
        restored = run(a)
        assert cold == live == restored
        assert core.prefill_dispatches - before == 1  # the suffix alone
        assert torch.equal(logits[3], logits[1])
        info = core.kv_transfer_info()
        p = core.stats().prefix
        # spills: A (for B's pages), then B (for A's suffix page)
        assert (info["ship_total"], info["restored_total"]) == (2, 1)
        assert (info["offload"]["spills"], info["offload"]["hits"]) == (2, 1)
        assert (p.prefix_hits_total, p.prefix_misses_total,
                p.prefix_evictions_total) == (2, 2, 2)
        # donations of A and B, A's restored head (32 tokens: a hit uses
        # at most n - 1), then A's 48-token head again at its finish, which
        # subsumes the restored entry
        assert p.prefix_insertions_total == 4
    finally:
        core.stop()


def test_parked_row_restores_from_the_tier_without_prefill(weights):
    """A priority-0 arrival parks the only slot's row; its pages spill to
    the tier, and it re-activates from them: one prefill in all (its own),
    and the uninterrupted tokens."""
    core = _port_core(weights, num_slots=1, kv_offload_bytes=1 << 28)
    try:
        solo, _ = _run(core, core.submit(Request(
            prompt_ids=list(PROMPT), sampling=SamplingParams(
                temperature=0.0, max_tokens=24, priority=2))))
        before = core.prefill_dispatches
        victim = core.submit(Request(
            prompt_ids=list(PROMPT), sampling=SamplingParams(
                temperature=0.0, max_tokens=24, priority=2)))
        while len(core.slots[0].out_tokens) < 5:
            _step(core)
        hi = core.submit(Request(prompt_ids=[2] * 8, sampling=SamplingParams(
            temperature=0.0, max_tokens=4, priority=0)))
        _run(core, hi)
        ids, _ = _run(core, victim)
        assert ids == solo
        assert core.prefill_dispatches - before == 2  # victim's and hi's
        info = core.kv_transfer_info()
        assert info["offload"]["spills"] == 1 and info["restored_total"] == 1
        assert core.stats().preempt_resumes_total == 1
    finally:
        core.stop()


# -------------------------------------------------------------- fallbacks


def _payload_for(weights, committed, **core_kw) -> dict:
    """An export of PROMPT + `committed` from a port core built with
    `core_kw` (its geometry or dtype may differ from the adopter's)."""
    core = _port_core(weights, **core_kw)
    try:
        req = core.submit(Request(
            prompt_ids=list(PROMPT), request_id="fb.0123abcd",
            sampling=SamplingParams(temperature=0.0, max_tokens=400)))
        while len(core.slots[0].out_tokens) < len(committed):
            _step(core)
        core.request_park("fb")
        _step(core)
        req.cancel()
        return core.take_kv_export("fb")
    finally:
        core.stop()


@pytest.mark.parametrize("case,reason", [
    ("page_size", "page_size"), ("int8", "dtype"), ("geometry", "geometry"),
    ("version", "version"), ("garbage", "error"), ("none", "absent"),
    ("ship_off", "disabled"),
])
def test_incompatible_payload_replays_and_counts_its_reason(weights, case,
                                                            reason):
    ref = Engine("debug-tiny", _port_core(weights),
                 ByteTokenizer(CFG.vocab_size))
    ref.core.start()
    try:
        full = [t for d in ref.stream(PROMPT, SamplingParams(
            temperature=0.0, max_tokens=24)) for t in d.token_ids]
    finally:
        ref.shutdown()
    committed = full[:PARK_AFTER]
    if case in ("page_size", "int8"):
        pages = _payload_for(weights, committed,
                             **({"kv_page_size": 8} if case == "page_size"
                                else {"quantize": "kv"}))
    elif case == "geometry":
        header = port_kv.KVWireHeader(
            version=1, layers=3, page_size=16, num_kv_heads=4, head_dim=16,
            kv_dtype="float32", tokens=27, num_pages=2)
        pages = port_kv.serialize_kv_pages(
            header, {k: np.zeros(shape, dt) for k, (shape, dt) in
                     port_kv.expected_sections(header).items()})
    else:
        pages = _payload_for(weights, committed)
        if case == "version":
            pages["version"] = 2
        elif case == "garbage":
            pages["data"] = pages["data"][:64]  # truncated
        elif case == "none":
            pages = None
    engine = Engine("debug-tiny", _port_core(
        weights, **({"kv_ship": False} if case == "ship_off" else {})),
        ByteTokenizer(CFG.vocab_size))
    engine.core.start()
    try:
        deltas = list(engine.adopt_stream(
            PROMPT, committed, SamplingParams(temperature=0.0,
                                              max_tokens=24),
            kv_pages=pages))
        assert [t for d in deltas for t in d.token_ids] == full
        info = engine.core.kv_transfer_info()
        assert info["restored_total"] == 0
        assert {k: v for k, v in info["ship_fallback_total"].items()
                if v} == {reason: 1}
        assert engine.core.stats().kv.kv_ship_fallback_total[reason] == 1
        assert info["ship_enabled"] is (case != "ship_off")
    finally:
        engine.shutdown()


def test_knobs_resolve_as_the_reference(monkeypatch, weights):
    monkeypatch.setenv("LLMLB_KV_SHIP", "0")
    monkeypatch.setenv("LLMLB_KV_OFFLOAD_BYTES", "4096")
    core = _port_core(weights)
    assert not core.kv_ship and core.kv_offload.budget_bytes == 4096
    monkeypatch.delenv("LLMLB_KV_SHIP")
    monkeypatch.setenv("LLMLB_KV_OFFLOAD_BYTES", "nope")
    core = _port_core(weights)
    assert core.kv_ship and core.kv_offload is None
    # the dense layout has no pages to ship or spill
    dense = _port_core(weights, kv_layout="dense", kv_offload_bytes=4096)
    assert not dense.kv_ship and dense.kv_offload is None
    assert dense.kv_transfer_info()["offload"] == {"enabled": False}
