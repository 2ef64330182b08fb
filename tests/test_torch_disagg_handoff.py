"""The port's cross-process handoff against the JAX package.

- The wire: the twins of tests/disagg/test_handoff_wire.py over the port's
  `disagg/wire.py` (every SamplingParams field survives with probe values;
  wrong versions, unknown sampling fields, malformed payloads and
  implausible lengths are refused; a KV page payload rides the envelope),
  and across the packages: the two SamplingParams declare the same fields,
  a JAX payload parses in the port and a port payload in the JAX package.
- Two port servers on the CPU, one `--role prefill` and one `--role
  decode`: POST /v1/handoff/prefill on the first, then /v1/handoff on the
  second, greedy, seeded and constrained, replayed (the envelope without
  its pages) and landed (with them: the adopter runs no prefill dispatch);
  each stream is the JAX engine's. The decode role's 409, a malformed
  payload's 400, `handoff_tokens` validation, both servers' role surfaces,
  and the flight records pairing across the two.
- The unchanged JAX gateway in front of the two servers: a prompt of at
  least PREFILL_HEAVY_TOKENS takes its two-phase route, and the client's
  stream carries the JAX engine's tokens.

debug-tiny in fp32, with its positions raised to 2048 in both packages so
that the gateway's prefill-heavy prompt fits a slot; one JAX EngineCore,
module-scoped, runs every reference stream.
"""

import dataclasses
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from llmlb_tpu.disagg import handoff_payload as jax_handoff_payload
from llmlb_tpu.disagg import parse_handoff as jax_parse_handoff
from llmlb_tpu.disagg.gateway import PREFILL_HEAVY_TOKENS
from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.gateway import token_accounting
from llmlb_tpu.gateway.types import Capability, EndpointType
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.structured import ConstraintCompiler as JaxCompiler
from llmlb_tpu_torch.disagg import (
    HANDOFF_WIRE_VERSION,
    HandoffError,
    handoff_payload,
    parse_handoff,
)
from llmlb_tpu_torch.engine.kv_transfer import (
    KV_WIRE_VERSION,
    KVWireHeader,
    expected_sections,
    parse_kv_payload,
    serialize_kv_pages,
)
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, SamplingParams
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer, default_chat_template
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.structured import inspect_request
from tests.support import GatewayHarness, assert_sse_protocol

EOS = 256
POSITIONS = 2048
CFG = dataclasses.replace(get_preset("debug-tiny"),
                          max_position_embeddings=POSITIONS)
JAX_CFG = dataclasses.replace(jax_preset("debug-tiny"),
                              max_position_embeddings=POSITIONS)
CORE_KW = dict(num_slots=4, slot_capacity=POSITIONS,
               prefill_buckets=(16, 32, 64), kv_page_size=16, eos_id=EOS,
               seed=0, prefix_cache=False)
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string", "maxLength": 8},
                         "n": {"enum": [0, 1, 2, 3]}},
          "required": ["name", "n"]}
# the gateway estimates len // 4 tokens a prompt here: this one is past
# the prefill-heavy threshold, and ~1130 byte tokens on the engines
HEAVY = "please summarize this document carefully. " * 26
MAX_TOKENS = 24
# name: (chat body fields, handoff_tokens)
CASES = {
    "greedy": ({"messages": [{"role": "user", "content": "the quick fox"}],
                "temperature": 0}, 1),
    "seeded": ({"messages": [{"role": "user", "content": "seeded handoff"}],
                "temperature": 0.9, "seed": 1234}, 4),
    "constrained": ({"messages": [{"role": "user", "content": "describe"}],
                     "temperature": 0, "max_tokens": 60,
                     "response_format": {"type": "json_schema", "json_schema": {
                         "name": "person", "schema": SCHEMA}}}, 2),
    "heavy": ({"messages": [{"role": "user", "content": HEAVY}],
               "temperature": 0}, 1),
}


def _prompt(name) -> list[int]:
    return ByteTokenizer(CFG.vocab_size).encode(
        default_chat_template(CASES[name][0]["messages"]))


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


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(JAX_CFG, jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def jax_streams(weights):
    """Each case alone on one idle JAX engine, uninterrupted."""
    core = JaxEngineCore(JAX_CFG, weights[0], decode_burst=1, **CORE_KW)
    core.constraint_compiler = JaxCompiler(JaxByteTokenizer(CFG.vocab_size),
                                           CFG.vocab_size)
    core.start()
    try:
        out = {}
        for name, (body, _k) in CASES.items():
            structured = inspect_request(body)
            sampling = JaxSampling(
                max_tokens=body.get("max_tokens", MAX_TOKENS),
                temperature=body["temperature"],
                seed=body.get("seed"),
                constraint=structured.spec if structured else None)
            out[name] = _drain(core.submit(JaxRequest(
                prompt_ids=_prompt(name), sampling=sampling)).events)
        return out
    finally:
        core.stop()


class _Server:
    def __init__(self, weights, role):
        core = EngineCore(CFG, params_from_numpy(weights[1], CFG, "cpu"),
                          device="cpu", role=role, **CORE_KW)
        self.engine = Engine("debug-tiny", core, ByteTokenizer(CFG.vocab_size))
        core.start()
        self.srv, self.thread = start_server(self.engine)
        self.url = "http://%s:%d" % self.srv.server_address[:2]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        self.engine.shutdown()


@pytest.fixture(scope="module")
def servers(weights):
    pre, dec = _Server(weights, "prefill"), _Server(weights, "decode")
    yield pre, dec
    pre.close()
    dec.close()


def _post(url, body, headers=None, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read()) if not body.get("stream") else \
            resp.read()


def _error(url, body, code):
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, body)
    assert err.value.code == code
    return json.loads(err.value.read())["error"]["message"]


def _stream_ids(raw: bytes) -> tuple[list[int], str | None]:
    """(replay ids, finish reason) of an armed chat SSE body."""
    ids, finish = [], None
    for line in raw.split(b"\n"):
        line = line.strip()
        if not line.startswith(b"data:") or line == b"data: [DONE]":
            continue
        obj = json.loads(line[len(b"data:"):])
        if obj.get("object") == "llmlb.replay":
            ids.extend(obj["tokens"])
        for choice in obj.get("choices") or []:
            finish = choice.get("finish_reason") or finish
    return ids, finish


# ----------------------------------------------------------------- the wire


def _distinct_value(field: dataclasses.Field):
    """A JSON-safe value that differs from the field's default, from its
    annotation (the reference test's rule)."""
    ann = str(field.type)
    if "dict" in ann:
        return {"probe": field.name, "n": 3}
    if "bool" in ann:
        return not field.default if isinstance(field.default, bool) else True
    if "float" in ann:
        return 0.125
    if "int" in ann:
        return 7
    if "str" in ann:
        return f"probe-{field.name}"
    raise AssertionError(f"SamplingParams.{field.name}: no probe for {ann!r}")


def _probe_params(cls=SamplingParams):
    return cls(**{f.name: _distinct_value(f)
                  for f in dataclasses.fields(cls)})


def _roundtrip(payload: dict) -> dict:
    return json.loads(json.dumps(payload))


def test_every_sampling_field_survives_the_handoff_wire():
    params = _probe_params()
    defaults = SamplingParams()
    for f in dataclasses.fields(SamplingParams):
        assert getattr(params, f.name) != getattr(defaults, f.name), f.name
    payload = _roundtrip(handoff_payload([1, 2, 3], [9, 9], params,
                                         stop=["\n\n"], request_id="rid-1"))
    prompt, committed, sampling, stop, rid, t = parse_handoff(payload)
    assert (prompt, committed, stop, rid) == ([1, 2, 3], [9, 9], ["\n\n"],
                                              "rid-1")
    assert t > 0 and sampling == params
    # the fields the reference names explicitly
    payload = _roundtrip(handoff_payload([5], [1], SamplingParams(
        priority=2, deadline_ms=1500.0, seed=42,
        constraint={"type": "json_object"},
        speculative={"enabled": True, "max_draft_tokens": 6})))
    s = parse_handoff(payload)[2]
    assert (s.priority, s.deadline_ms, s.seed) == (2, 1500.0, 42)
    assert s.constraint == {"type": "json_object"}
    assert s.speculative == {"enabled": True, "max_draft_tokens": 6}


def _valid() -> dict:
    return handoff_payload([1, 2], [3], SamplingParams())


@pytest.mark.parametrize("mutate, match", [
    (lambda p: p.update(version=HANDOFF_WIRE_VERSION + 1), "version"),
    (lambda p: p["sampling"].update(from_the_future=1), "from_the_future"),
    (lambda p: p.pop("prompt_ids"), "prompt_ids"),
    (lambda p: p.update(prompt_ids=[]), "prompt_ids"),
    (lambda p: p.update(prompt_ids=["x"]), "integers"),
    (lambda p: p.update(committed_ids="nope"), "committed_ids"),
    (lambda p: p.update(committed_ids=list(range(4_000_001))), "implausibly"),
    (lambda p: p.update(sampling=None), "sampling"),
    (lambda p: p.update(stop="raw-string"), "stop"),
    (lambda p: p.update(request_id=7), "request_id"),
])
def test_rejects_malformed_payloads_as_the_reference(mutate, match):
    """Each malformed payload is refused with the reference's message."""
    port, ref = _valid(), _valid()
    mutate(port)
    mutate(ref)
    with pytest.raises(HandoffError, match=match) as got:
        parse_handoff(port)
    with pytest.raises(ValueError) as want:
        jax_parse_handoff(ref)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("payload", [None, [1, 2, 3], "x"])
def test_rejects_non_object_payloads(payload):
    with pytest.raises(HandoffError, match="JSON object"):
        parse_handoff(payload)


def test_kv_pages_ride_the_handoff_envelope():
    header = KVWireHeader(version=KV_WIRE_VERSION, layers=3, page_size=8,
                          num_kv_heads=5, head_dim=4, kv_dtype="float32",
                          num_pages=2, tokens=13)
    sections = {name: np.arange(int(np.prod(shape)), dtype=dtype).reshape(
        shape) for name, (shape, dtype) in expected_sections(header).items()}
    kv = serialize_kv_pages(header, sections)
    payload = _roundtrip(handoff_payload([1, 2], [3], SamplingParams(),
                                         kv_pages=kv))
    parse_handoff(payload)  # an adopter that ignores the pages
    assert parse_kv_payload(payload["kv_pages"]).header == header


def test_the_two_packages_speak_one_wire():
    """A gateway may pair a JAX prefill engine with a port decode engine,
    and the other way round: the same fields, and each package's payload
    parses in the other to the same values."""
    assert ({f.name for f in dataclasses.fields(SamplingParams)}
            == {f.name for f in dataclasses.fields(JaxSampling)})
    theirs = _roundtrip(jax_handoff_payload(
        [4, 5], [6], _probe_params(JaxSampling), stop=["x"],
        request_id="r"))
    ours = _roundtrip(handoff_payload([4, 5], [6], _probe_params(),
                                      stop=["x"], request_id="r"))
    assert set(theirs) == set(ours)
    p1, p2 = parse_handoff(theirs), jax_parse_handoff(ours)
    assert p1[:2] == p2[:2] == ([4, 5], [6])
    assert dataclasses.asdict(p1[2]) == dataclasses.asdict(p2[2])
    assert p1[3:5] == p2[3:5] == (["x"], "r")


# ----------------------------------------------------- two port servers


def _handoff(servers, name, land, rid=None):
    """Prefill on the prefill server, adopt on the decode one: (the
    adopted stream's ids and finish, the envelope, the adopter's prefill
    dispatches)."""
    pre, dec = servers
    body, k = CASES[name]
    headers = {"X-Request-Id": rid} if rid else {}
    out = _post(pre.url + "/v1/handoff/prefill",
                {"max_tokens": MAX_TOKENS, **body, "handoff_tokens": k},
                headers)
    assert out["object"] == "llmlb.handoff" and out["finish"] is None, out
    assert out["usage"]["completion_tokens"] == k
    envelope = out["handoff"]
    assert len(envelope["committed_ids"]) == k
    assert "kv_pages" in envelope
    if not land:
        envelope = {key: v for key, v in envelope.items() if key != "kv_pages"}
    core = dec.engine.core
    before = (core.prefill_dispatches, core.stats().kv.kv_restored_total)
    raw = _post(dec.url + "/v1/handoff",
                {"handoff": envelope, "stream": True, "llmlb_replay": True,
                 "tool_name": out["tool_name"]}, headers)
    after = (core.prefill_dispatches, core.stats().kv.kv_restored_total)
    return _stream_ids(raw), envelope, (after[0] - before[0],
                                        after[1] - before[1])


@pytest.mark.parametrize("land", [False, True], ids=["replayed", "landed"])
@pytest.mark.parametrize("name", ["greedy", "seeded", "constrained"])
def test_handoff_stream_is_the_jax_stream(servers, jax_streams, name, land):
    (ids, finish), envelope, (prefills, restored) = _handoff(servers, name,
                                                             land)
    assert (ids, finish) == tuple(jax_streams[name])
    assert envelope["committed_ids"] == ids[:len(envelope["committed_ids"])]
    if land:
        assert (prefills, restored) == (0, 1)
    else:
        assert prefills > 0 and restored == 0
    if name == "constrained":
        assert finish == "stop"
        json.loads(ByteTokenizer(CFG.vocab_size).decode(ids))


def test_handoff_routes_refuse_what_the_reference_refuses(servers,
                                                          monkeypatch):
    pre, dec = servers
    body = {**CASES["greedy"][0], "max_tokens": 4}
    msg = _error(dec.url + "/v1/handoff/prefill", body, 409)
    assert "--role decode" in msg
    for bad in (0, 65, True, "x"):
        msg = _error(pre.url + "/v1/handoff/prefill",
                     {**body, "handoff_tokens": bad}, 400)
        assert "handoff_tokens" in msg
    monkeypatch.setenv("LLMLB_DISAGG_HANDOFF_TOKENS", "3")
    out = _post(pre.url + "/v1/handoff/prefill", body)
    assert len(out["handoff"]["committed_ids"]) == 3
    for envelope in (None, [1], {"version": 9}, {**out["handoff"],
                                                  "prompt_ids": []}):
        _error(dec.url + "/v1/handoff", {"handoff": envelope}, 400)
    _error(dec.url + "/v1/handoff",
           {"handoff": out["handoff"], "tool_name": 5}, 400)
    # an envelope whose pages are not an object replays
    got = _post(dec.url + "/v1/handoff",
                {"handoff": {**out["handoff"], "kv_pages": "junk"}})
    assert got["object"] == "chat.completion"
    assert got["usage"]["completion_tokens"] <= 4
    # a request done inside the window: its natural finish, no pages
    out = _post(pre.url + "/v1/handoff/prefill",
                {**body, "max_tokens": 2, "handoff_tokens": 4})
    assert out["finish"] == "length" and "kv_pages" not in out["handoff"]


def test_roles_are_advertised(servers):
    pre, dec = servers
    for s, role, caps in ((pre, "prefill", {"prefill"}),
                          (dec, "decode", {"decode"})):
        with urllib.request.urlopen(s.url + "/v1/models") as r:
            [entry] = json.loads(r.read())["data"]
        assert entry["role"] == role
        assert set(entry["capabilities"]) & {"prefill", "decode"} == caps
        for path in ("/api/health", "/api/system"):
            with urllib.request.urlopen(s.url + path) as r:
                info = json.loads(r.read())["disagg"]
            assert (info["role"], info["split"]) == (role, False)


def test_flight_records_pair_across_the_two_servers(servers):
    pre, dec = servers
    rid = "gw-handoff-fr-1"
    (ids, _), envelope, _ = _handoff(servers, "greedy", True, rid=rid)
    with urllib.request.urlopen(
            f"{pre.url}/api/requests/{rid}/timeline") as r:
        names = [e["event"] for e in json.loads(r.read())["events"]]
    assert names[0] == "admitted"
    assert "kv_shipped" in names and names[-1] == "handoff_emitted"
    assert names.index("kv_shipped") < names.index("finished")
    with urllib.request.urlopen(
            f"{dec.url}/api/requests/{rid}/timeline") as r:
        events = json.loads(r.read())["events"]
    names = [e["event"] for e in events]
    assert names[0] == "adopted" and names[-1] == "finished"
    assert "kv_restored" in names and "prefill_chunk" not in names
    adopted = events[0]["attrs"]
    assert adopted["committed"] == len(envelope["committed_ids"])
    assert adopted["wire_latency_s"] >= 0
    assert pre.engine.core.metrics.handoff_total["emitted"] >= 1
    assert dec.engine.core.metrics.handoff_total["adopted"] >= 1


# ---------------------------------------------------------------- gateway


async def test_gateway_two_phase_route_through_two_port_servers(
        servers, jax_streams, monkeypatch):
    """The unchanged gateway sends a prefill-heavy chat to the prefill
    server's /v1/handoff/prefill and the payload to the decode server's
    /v1/handoff; the client's stream is the JAX engine's."""
    # the estimate's offline form (len // 4), without a tokenizer download
    monkeypatch.setattr(token_accounting, "_encoder", _no_encoder)
    assert len(HEAVY) // 4 >= PREFILL_HEAVY_TOKENS
    pre, dec = servers
    gw = await GatewayHarness.create()
    try:
        for s, role in ((pre, "prefill"), (dec, "decode")):
            gw.register_mock(s.url, ["debug-tiny"],
                             endpoint_type=EndpointType.TPU, name=role,
                             capabilities=[Capability.CHAT_COMPLETION,
                                           Capability(role)])
        emitted = pre.engine.core.metrics.handoff_total["emitted"]
        adopted = dec.engine.core.metrics.handoff_total["adopted"]
        r = await gw.client.post(
            "/v1/chat/completions",
            json={**CASES["heavy"][0], "model": "debug-tiny", "stream": True,
                  "max_tokens": MAX_TOKENS},
            headers=await gw.inference_headers())
        assert r.status == 200, await r.text()
        raw = await r.read()
        assert_sse_protocol(raw, "openai")
        text, finish = "", None
        for line in raw.split(b"\n"):
            if line.startswith(b"data: {"):
                for ch in json.loads(line[6:]).get("choices") or []:
                    text += (ch.get("delta") or {}).get("content") or ""
                    finish = ch.get("finish_reason") or finish
        want, reason = jax_streams["heavy"]
        assert text == ByteTokenizer(CFG.vocab_size).decode(want)
        assert finish == reason
        assert gw.state.metrics.summary()["handoffs_total"] == 1
        assert pre.engine.core.metrics.handoff_total["emitted"] == emitted + 1
        assert dec.engine.core.metrics.handoff_total["adopted"] == adopted + 1
    finally:
        await gw.close()


def _no_encoder():
    raise RuntimeError("no tokenizer download in the tests")
