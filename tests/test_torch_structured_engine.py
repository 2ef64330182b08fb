"""Structured outputs on the port's engine against the JAX engine.

The same debug-tiny weights (JAX's `init_params(PRNGKey(0))`), prompts,
specs and byte vocabulary on both engines, with the tokenizer's EOS (256),
so a constrained stream ends with "stop" where its grammar accepts:

- a mixed batch (a json_schema, a json_object, a regex and a free row,
  admitted together) gives the JAX engine's streams token for token, on
  the grammar key at bursts of 1 and 4, on the host-mask fallback (a
  budget too small for two of the schemas: mixed bursts take k = 1 and
  count their fallbacks; the flip is one-way), with `fused_decode` off
  (the dense default), and with bursts replayed from stub graphs (each
  replay runs the eager body), whose keys carry the mode; the free row's
  tokens are its solo run's (C1);
- seeded constrained rows (json_schema, a forced tool call) give the JAX
  engine's seeded streams at a burst of 4, eager and replayed;
- a prefix-cache hit under a constraint gives the cold run's stream (C3);
- a constrained victim parked by a priority-0 arrival resumes with its
  cursor (the twin of tests/engine/test_preemption.py::
  test_constraint_cursor_parks_and_resumes), through the replay and from
  the offload tier (a landed row), with no violation;
- `Engine.adopt_stream` (behind /v1/resume) rebuilds the cursor from the
  committed ids, replayed and landed from another core's export;
- the unchanged gateway steers constrained chats to the port and away
  from an endpoint without `structured_outputs` (the twin of
  tests/gateway/test_structured_gateway.py::
  test_constrained_requests_steered_to_capable_endpoint), each carrying
  the JAX engine's tokens; the port's forced tool calls have the
  reference's `tool_calls` shapes, streamed and not.

One JAX EngineCore, module-scoped, runs every reference stream.
"""

import json
import urllib.error
import urllib.request

import jax
import jsonschema
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.gateway.types import Capability
from llmlb_tpu.models import llama as jllama
from llmlb_tpu.structured import ConstraintCompiler as JaxCompiler
from llmlb_tpu_torch.engine.decode_graph import BurstGraphs
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import (
    EngineCore,
    Request,
    SamplingParams,
)
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer, default_chat_template
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.structured import ConstraintCompiler
from tests.support import GatewayHarness, MockOpenAIEndpoint, parse_sse_frames

CFG = get_preset("debug-tiny")
EOS = 256
CORE_KW = dict(slot_capacity=128, prefill_buckets=(16, 32), kv_page_size=16,
               eos_id=EOS, seed=0)
PREEMPT = {"type": "object",
           "properties": {"name": {"type": "string", "maxLength": 8},
                          "n": {"enum": [0, 1, 2, 3]}},
           "required": ["name", "n"]}
GATEWAY = {"type": "object",
           "properties": {"city": {"enum": ["sf", "nyc"]},
                          "celsius": {"type": "boolean"}},
           "required": ["city", "celsius"]}
WEATHER = {"type": "object",
           "properties": {"location": {"type": "string", "maxLength": 12},
                          "unit": {"enum": ["c", "f"]}},
           "required": ["location", "unit"]}
SCHEMA_SPEC = {"type": "json_schema", "schema": PREEMPT}
TOOL_SPEC = {"type": "tool_call", "name": "get_weather", "schema": WEATHER}
GREEDY = dict(temperature=0.0)
# the mixed batch, admitted together: (prompt, spec)
MIXED = [(list(b"the quick brown fox"), SCHEMA_SPEC),
         (list(b"weather json"), {"type": "json_object"}),
         (list(b"give a number"), {"type": "regex", "pattern": r"-?[0-9]+"}),
         (list(b"free text here"), None)]
MAX_TOKENS = 60
# alone on the idle engine: (prompt, sampling, spec)
HIT_PROMPT = list(range(33, 73))  # 40 tokens: 32 of them a prefix hit
SOLO = {
    "schema": (MIXED[0][0], GREEDY, SCHEMA_SPEC),
    "schema-seeded": (MIXED[0][0], dict(temperature=0.9, top_p=0.95,
                                        seed=1234), SCHEMA_SPEC),
    "tool-seeded": (list(b"call the tool"), dict(temperature=0.8, seed=7),
                    TOOL_SPEC),
    "hit": (HIT_PROMPT, GREEDY, {"type": "json_schema", "schema": GATEWAY}),
}
GATEWAY_CHATS = [[{"role": "user", "content": f"req {i}"}] for i in range(2)]
GATEWAY_MAX = 48


def _chat_ids(messages) -> list[int]:
    return ByteTokenizer(CFG.vocab_size).encode(default_chat_template(messages))


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


@pytest.fixture(scope="module")
def jax_streams(weights):
    """The mixed batch admitted together, then each solo case and the
    gateway's chats alone, on one idle JAX engine."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", prefix_cache=False,
                         decode_burst=1, num_slots=4, **CORE_KW)
    core.constraint_compiler = JaxCompiler(JaxByteTokenizer(CFG.vocab_size),
                                           CFG.vocab_size)

    def submit(prompt, sampling, spec, max_tokens=MAX_TOKENS):
        return core.submit(JaxRequest(prompt_ids=list(prompt),
                                      sampling=JaxSampling(
                                          max_tokens=max_tokens,
                                          constraint=spec, **sampling)))

    mixed = [submit(p, GREEDY, spec) for p, spec in MIXED]
    core.start()  # everything queued before the loop starts: one group
    try:
        out = {"mixed": [_drain(r.events) for r in mixed]}
        for name, (p, sampling, spec) in SOLO.items():
            out[name] = _drain(submit(p, sampling, spec).events)
        out["gateway"] = [_drain(submit(
            _chat_ids(m), GREEDY, {"type": "json_schema", "schema": GATEWAY},
            GATEWAY_MAX).events) for m in GATEWAY_CHATS]
        assert core.metrics.constraint_violations_total == 0
        return out
    finally:
        core.stop()


class _StubGraph:
    """Stands in for torch.cuda.CUDAGraph: replay() runs the eager body."""

    def __init__(self, fn):
        self.replay = fn


def _core(weights, stub_graphs=False, **kw) -> EngineCore:
    core = EngineCore(CFG, params_from_numpy(weights[1], CFG, "cpu"),
                      device="cpu",
                      **{**CORE_KW, "num_slots": 4, "prefix_cache": False,
                         **kw})
    core.constraint_compiler = ConstraintCompiler(ByteTokenizer(CFG.vocab_size),
                                                  CFG.vocab_size)
    if stub_graphs:
        core._bursts = BurstGraphs(core._burst_body,
                                   lambda fn: (_StubGraph(fn), 0, None))
    return core


def _step(core) -> None:
    """One iteration of the step loop's body, on this thread."""
    core._try_insert()
    core._advance_prefill()
    core._decode_active()


def _req(prompt, spec, max_tokens=MAX_TOKENS, **sampling):
    return Request(prompt_ids=list(prompt), sampling=SamplingParams(
        max_tokens=max_tokens, constraint=spec, **{**GREEDY, **sampling}))


def _serve(core, requests, limit=3000):
    """Submit together, step until all ended; (tokens, reason) each."""
    for r in requests:
        core.submit(r)
    for _ in range(limit):
        if all(not r.events.empty() and r.finished_at for r in requests):
            break
        _step(core)
    return [_drain(r.events, timeout=1) for r in requests]


def _text(ids) -> str:
    return ByteTokenizer(CFG.vocab_size).decode(ids)


def test_reference_streams_end_at_grammar_acceptance(jax_streams):
    """The JAX streams the cases below hold the port to: every constrained
    one ends with "stop" and parses; the free row runs to max_tokens."""
    mixed = jax_streams["mixed"]
    assert [r for _t, r in mixed] == ["stop", "stop", "stop", "length"]
    jsonschema.validate(json.loads(_text(mixed[0][0])), PREEMPT)
    assert isinstance(json.loads(_text(mixed[1][0])), dict)
    assert _text(mixed[2][0]).lstrip("-").isdigit()
    for name in ("schema", "schema-seeded", "hit"):
        assert jax_streams[name][1] == "stop"
    jsonschema.validate(json.loads(_text(jax_streams["tool-seeded"][0])),
                        WEATHER)


# (name, core kwargs, budget MiB or None, stub graphs)
PATHS = [
    ("grammar-burst1", dict(decode_burst=1), None, False),
    ("grammar-burst4", dict(decode_burst=4), None, True),
    ("fallback-burst4", dict(decode_burst=4), "0.05", True),
    ("unfused-burst4", dict(decode_burst=4, fused_decode=False), None, False),
    ("dense-burst4", dict(decode_burst=4, kv_layout="dense"), None, False),
]


@pytest.mark.parametrize("name,kw,budget,stubs", PATHS,
                         ids=[p[0] for p in PATHS])
def test_mixed_batch_is_the_jax_engines(weights, jax_streams, monkeypatch,
                                        name, kw, budget, stubs):
    if budget is not None:
        # 25 rows of 512: the regex fits, the schema and json_object do not
        monkeypatch.setenv("LLMLB_GRAMMAR_TABLE_MB", budget)
    core = _core(weights, stub_graphs=stubs, **kw)
    got = _serve(core, [_req(p, spec) for p, spec in MIXED])
    assert got == jax_streams["mixed"]
    st = core.stats().structured
    assert st.structured_requests_total == 3
    assert st.constraint_violations_total == 0
    assert st.masked_decode_steps_total > 0
    info = core.structured_info()
    assert info["active_constrained_slots"] == 0
    keys = set(core.decode_graph_info()["keys"])
    if name.startswith("grammar"):
        assert core.fused_decode and not info["grammar_fallback"]
        assert st.constrained_burst_fallback_total == 0
        assert info["grammar_table"]["schemas"] == 3
        if stubs:
            assert keys == {"128/unseeded", "128/unseeded/grammar"}
    elif name.startswith("fallback"):
        # one-way: the first refused schema keeps host rows for every row
        assert info["grammar_fallback"]
        assert info["grammar_table"]["rejected"] == 2
        assert st.constrained_burst_fallback_total > 0
        assert "128/unseeded/mask" in keys
    else:
        assert not core.fused_decode and info["grammar_table"] == {
            "enabled": False}
        assert (st.constrained_burst_fallback_total
                == st.masked_decode_steps_total)
    if stubs:
        stats = core.stats()
        assert stats.decode_eager_bursts == stats.decode_graphs == len(keys)
    # C1: the free row's tokens are its solo run's
    assert _serve(core, [_req(*MIXED[3])]) == [jax_streams["mixed"][3]]


@pytest.mark.parametrize("stubs", [False, True], ids=["eager", "replayed"])
def test_seeded_constrained_rows_are_the_jax_engines(weights, jax_streams,
                                                     stubs):
    core = _core(weights, stub_graphs=stubs, decode_burst=4)
    for name in ("schema-seeded", "tool-seeded"):
        prompt, sampling, spec = SOLO[name]
        assert _serve(core, [_req(prompt, spec, **sampling)]) == [
            jax_streams[name]]
    if stubs:
        assert "128/seeded/grammar" in core.decode_graph_info()["keys"]


def test_prefix_hit_under_a_constraint_is_the_cold_run(weights, jax_streams):
    """C3: the second run takes 32 of its 40 prompt tokens from the cache
    and its constrained stream is the cold run's (and the JAX engine's)."""
    core = _core(weights, prefix_cache=True, decode_burst=4)
    prompt, sampling, spec = SOLO["hit"]
    cold = _serve(core, [_req(prompt, spec)])
    hit = _serve(core, [_req(prompt, spec)])
    assert core.stats().prefix.prefix_hits_total == 1
    assert core.stats().prefix.prefix_cached_tokens_total == 32
    assert cold == hit == [jax_streams["hit"]]


@pytest.mark.parametrize("tier", [False, True], ids=["replayed", "landed"])
def test_constraint_cursor_parks_and_resumes(weights, jax_streams, tier):
    """One slot: the priority-2 constrained victim emits 5 tokens, a
    priority-0 arrival parks it with its cursor, and the resumed stream
    is the JAX engine's uninterrupted one, valid JSON, no violation. With
    the offload tier the victim re-activates from its spilled pages (a
    landed row: no prefill, the parked cursor as it was)."""
    core = _core(weights, num_slots=1, decode_burst=4,
                 kv_offload_bytes=(1 << 26) if tier else 0)
    prompt, sampling, spec = SOLO["schema"]
    victim = core.submit(_req(prompt, spec, priority=2))
    while len(core.slots[0].out_tokens) < 5:
        _step(core)
    emitted = list(core.slots[0].out_tokens)
    cursor = core.slots[0].constraint
    hi = _serve(core, [_req([3, 1, 4, 1, 5], None, max_tokens=6,
                            priority=0)])
    assert hi[0][1] == "length"
    _step(core)  # the victim back in its slot, with the parked cursor
    assert core.slots[0].request is victim and victim.parked is None
    assert core.slots[0].constraint is cursor
    for _ in range(500):
        if victim.finished_at:
            break
        _step(core)
    got, reason = _drain(victim.events, timeout=1)
    assert (got, reason) == jax_streams["schema"]
    assert got[:len(emitted)] == emitted
    jsonschema.validate(json.loads(_text(got)), PREEMPT)
    st = core.stats()
    assert (st.preemptions_total, st.preempt_resumes_total) == (1, 1)
    assert st.structured.constraint_violations_total == 0
    assert st.structured.structured_requests_total == 1  # not counted again
    assert core.kv_transfer_info()["restored_total"] == (1 if tier else 0)


def _export(weights, committed: int) -> dict:
    """The KV export of the "schema" stream parked after `committed` ids on
    a core driven by hand."""
    core = _core(weights, num_slots=1)
    prompt, _sampling, spec = SOLO["schema"]
    req = _req(prompt, spec)
    req.request_id = "st.0123abcd"
    core.submit(req)
    while len(core.slots[0].out_tokens) < committed:
        _step(core)
    core.request_park("st")
    core._park_requested(core._park_rids)
    req.cancel()
    return core.take_kv_export("st")


@pytest.mark.parametrize("pages", [False, True], ids=["replayed", "landed"])
def test_adoption_rebuilds_the_cursor(weights, jax_streams, pages):
    want, reason = jax_streams["schema"]
    committed = want[:7]
    payload = _export(weights, len(committed)) if pages else None
    core = _core(weights, decode_burst=4)
    engine = Engine("debug-tiny", core, ByteTokenizer(CFG.vocab_size))
    core.start()
    try:
        deltas = list(engine.adopt_stream(
            MIXED[0][0], committed, SamplingParams(
                temperature=0.0, max_tokens=MAX_TOKENS,
                constraint=SCHEMA_SPEC), kv_pages=payload))
    finally:
        engine.shutdown()
    ids = [t for d in deltas for t in d.token_ids]
    assert (ids, deltas[-1].finish_reason) == (want, reason)
    assert core.kv_transfer_info()["restored_total"] == (1 if pages else 0)
    st = core.stats().structured
    assert st.constraint_violations_total == 0
    assert st.mask_cache_misses_total == 1


@pytest.fixture(scope="module")
def server(weights):
    """The port's server over the JAX weights, with the tokenizer's EOS."""
    engine = Engine.from_preset(
        "debug-tiny", device="cpu", params=params_from_numpy(
            weights[1], CFG, "cpu"),
        num_slots=4, slot_capacity=128, prefill_buckets=(16, 32, 64),
        kv_page_size=16, prefix_cache=False)
    srv, thread = start_server(engine)
    try:
        yield "http://%s:%d" % srv.server_address[:2], engine
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


async def test_gateway_steers_constrained_chats_to_the_port(server,
                                                           jax_streams):
    """Same model on two endpoints, a mock without structured_outputs and
    the port with it: every constrained chat lands on the port and carries
    the JAX engine's tokens; free chats still reach the mock."""
    base, engine = server
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as resp:
        caps = json.loads(resp.read())["data"][0]["capabilities"]
    assert "structured_outputs" in caps
    gw = await GatewayHarness.create()
    mock = await MockOpenAIEndpoint(model="debug-tiny").start()
    try:
        gw.register_mock(mock.url, ["debug-tiny"], name="blind")
        gw.register_mock(base, ["debug-tiny"], name="port0",
                         capabilities=[Capability.CHAT_COMPLETION,
                                       Capability.STRUCTURED_OUTPUTS])
        headers = await gw.inference_headers()
        for messages, (want, reason) in zip(GATEWAY_CHATS,
                                            jax_streams["gateway"]):
            r = await gw.client.post("/v1/chat/completions", json={
                "model": "debug-tiny", "max_tokens": GATEWAY_MAX,
                "temperature": 0.0, "messages": messages,
                "response_format": {"type": "json_schema", "json_schema": {
                    "name": "w", "schema": GATEWAY}}}, headers=headers)
            assert r.status == 200, await r.text()
            body = await r.json()
            content = body["choices"][0]["message"]["content"]
            assert (content, body["choices"][0]["finish_reason"]) == (
                _text(want), reason)
            jsonschema.validate(json.loads(content), GATEWAY)
        assert not mock.requests_seen, (
            "a constrained request reached a non-structured endpoint")
        for i in range(6):
            r = await gw.client.post("/v1/chat/completions", json={
                "model": "debug-tiny", "max_tokens": 2,
                "messages": [{"role": "user", "content": f"free {i}"}]},
                headers=headers)
            assert r.status == 200
    finally:
        await mock.stop()
        await gw.close()
    health = engine.health()["structured"]
    assert health["enabled"] and health["mask_cache_entries"] >= 1


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.read()


def test_forced_tool_call_shapes(server):
    """The reference's shapes: non-streamed, one tool call whose arguments
    are the constrained text; streamed, a first tool delta with id and
    name, then argument fragments; finish_reason "tool_calls" once the
    grammar ended the call. /v1/resume keeps the shape."""
    base, _engine = server
    body = {"model": "debug-tiny", "temperature": 0.0, "max_tokens": 60,
            "messages": [{"role": "user", "content": "call the tool"}],
            "tools": [{"type": "function", "function": {
                "name": "get_weather", "parameters": WEATHER}}],
            "tool_choice": {"type": "function",
                            "function": {"name": "get_weather"}}}
    whole = json.loads(_post(base + "/v1/chat/completions", body))
    choice = whole["choices"][0]
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["content"] is None
    [call] = choice["message"]["tool_calls"]
    assert call["type"] == "function" and call["id"].startswith("call_")
    assert call["function"]["name"] == "get_weather"
    jsonschema.validate(json.loads(call["function"]["arguments"]), WEATHER)
    for path, extra in (("/v1/chat/completions", {}),
                        ("/v1/resume", {"committed_ids": list(
                            call["function"]["arguments"].encode()[:4])})):
        raw = _post(base + path, {**body, **extra, "stream": True})
        chunks = [json.loads(d) for f in parse_sse_frames(raw)
                  for d in f["data"] if d != "[DONE]"]
        deltas = [c["choices"][0] for c in chunks if c.get("choices")]
        opener = deltas[1]["delta"]["tool_calls"][0]
        assert opener["index"] == 0 and opener["type"] == "function"
        assert opener["function"] == {"name": "get_weather", "arguments": ""}
        args = "".join(d["delta"]["tool_calls"][0]["function"]["arguments"]
                       for d in deltas[2:] if "tool_calls" in d["delta"])
        assert not any("content" in d["delta"] for d in deltas[1:])
        assert args == call["function"]["arguments"]
        assert deltas[-1]["finish_reason"] == "tool_calls"


def test_malformed_schema_is_400_naming_the_feature(server):
    base, _engine = server
    body = {"model": "debug-tiny", "max_tokens": 4,
            "messages": [{"role": "user", "content": "x"}],
            "response_format": {"type": "json_schema", "json_schema": {
                "name": "x", "schema": {"type": "object",
                                        "patternProperties": {}}}}}
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/v1/chat/completions", body)
    assert err.value.code == 400
    assert "patternProperties" in json.loads(err.value.read())["error"][
        "message"]


@pytest.mark.parametrize("env,layout,want", [
    ("", "paged", True), ("", "dense", False), ("1", "dense", True),
    ("off", "paged", False), ("junk", "paged", True), ("junk", "dense", False),
])
def test_fused_decode_resolves_as_the_reference(weights, monkeypatch, env,
                                                layout, want):
    """The kwarg, then LLMLB_FUSED_DECODE, then on for paged and off for
    dense (the reference's `fused_decode` rule); off, no grammar table."""
    monkeypatch.setenv("LLMLB_FUSED_DECODE", env)
    core = _core(weights, kv_layout=layout)
    assert core.fused_decode is want
    assert (core._grammar_tables is not None) is want
    assert _core(weights, kv_layout=layout,
                 fused_decode=not want).fused_decode is (not want)


def test_grammar_buffers_keep_their_addresses(weights, monkeypatch):
    """A captured grammar or mask graph reads the device table, the cursor
    vector and the host mask's device copy at fixed addresses: each is
    allocated once (the table at its first schema, the mask at the first
    fallback burst) and only written in place, across registrations, the
    fallback flip, bursts and slot reuse."""
    monkeypatch.setenv("LLMLB_GRAMMAR_TABLE_MB", "0.05")  # 25 rows of 512
    core = _core(weights, decode_burst=4)
    gram_state = core._d_gram_state.data_ptr()
    seen: dict[str, int] = {}

    def check():
        state = core._burst_state
        assert state.gram_state.data_ptr() == gram_state
        for name, t in (("table", state.gram_table),
                        ("mask", state.mask_bias)):
            if t is not None:
                assert seen.setdefault(name, t.data_ptr()) == t.data_ptr()

    regex = {"type": "regex", "pattern": r"-?[0-9]+"}
    reqs = [_req(MIXED[2][0], regex), _req(*MIXED[0]),
            _req(MIXED[1][0], {"type": "regex", "pattern": r"(yes|no)"}),
            _req(*MIXED[1])]
    for r in reqs:
        core.submit(r)
    for _ in range(400):
        if all(r.finished_at for r in reqs):
            break
        _step(core)
        check()
    assert all(r.finished_at for r in reqs)
    assert set(seen) == {"table", "mask"}
    assert seen["table"] == core._grammar_tables.table().data_ptr()
    info = core.structured_info()["grammar_table"]
    assert (info["schemas"], info["rejected"]) == (2, 2)
