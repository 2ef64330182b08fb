"""The port's HTTP server honours or refuses every request field it takes.

`priority`, `speculative` and the `X-Request-Deadline-Ms` header are
validated by the reference's rules: a malformed value is a 400 whose
message is the reference server's own (its `_priority_from`,
`_speculative_from` and `_deadline_from` run on the same input here), and
a well-formed one is carried on the request's SamplingParams. Structured
outputs are served as the reference serves them: a `response_format` of
json_object or json_schema and a `tool_choice` the reference constrains
(a function object, or "required" with one tool) become the request's
grammar constraint, the reference `inspect_request`'s spec, and a forced
tool call is answered in the `tool_calls` shape; "required" with several
tools is served unconstrained, and the malformed tool shapes get the
reference `_forced_tool`'s messages.
The length and stop fields are read under every name the reference reads
(`max_output_tokens`, `stop_sequences`). The engine flags the reference
takes (`--min-prefix-len`, `--role`, `--disagg-prefill-slots`) parse and
reach the core. One debug-tiny server on the CPU serves every case.
"""

import json
import urllib.error
import urllib.request

import pytest

from llmlb_tpu.engine import server as jax_server
from llmlb_tpu.structured.openai_api import _forced_tool, inspect_request
from llmlb_tpu_torch.engine import server as port_server
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine

CHAT = {"model": "debug-tiny", "temperature": 0, "max_tokens": 2,
        "messages": [{"role": "user", "content": "hi"}]}
TOOLS = [{"type": "function",
          "function": {"name": "get_weather",
                       "parameters": {"type": "object"}}}]
# a schema the grammar compiler takes (a bare {"type": "object"} compiles
# past its 65536-character cap: the reference refuses it too)
SCHEMA = {"type": "object", "properties": {"city": {"enum": ["sf", "nyc"]}},
          "required": ["city"]}
SCHEMA_TOOLS = [{"type": "function",
                 "function": {"name": "get_weather", "parameters": SCHEMA}}]


@pytest.fixture(scope="module")
def server():
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=2,
                                slot_capacity=64, prefill_buckets=(32,),
                                kv_page_size=16, eos_id=-1)
    srv, thread = start_server(engine)
    try:
        yield "http://%s:%d" % srv.server_address[:2]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


def _post(base: str, body: dict, headers: dict | None = None):
    req = urllib.request.Request(
        base + "/v1/chat/completions", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    return urllib.request.urlopen(req, timeout=120)


def _error_of(base: str, body: dict, headers: dict | None = None) -> str:
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base, body, headers)
    assert err.value.code == 400
    return json.loads(err.value.read())["error"]["message"]


def _served_spec(base: str, body: dict, monkeypatch) -> tuple[dict, dict]:
    """(the answer, the grammar spec the request was served with)."""
    specs = []
    stream = Engine.stream

    def spy(engine, prompt_ids, sampling, *args, **kwargs):
        specs.append(sampling.constraint)
        return stream(engine, prompt_ids, sampling, *args, **kwargs)

    monkeypatch.setattr(Engine, "stream", spy)
    with _post(base, body) as resp:
        assert resp.status == 200
        out = json.loads(resp.read())
    [spec] = specs
    return out, spec


def _reference_message(fn, arg) -> str:
    with pytest.raises(ValueError) as err:
        fn(arg)
    return str(err.value)


class _Headers(dict):
    """What the reference's _deadline_from reads: `request.headers`."""

    @property
    def headers(self):
        return self


@pytest.mark.parametrize("field,value", [
    ("priority", "urgent"),
    ("priority", 3),
    ("priority", True),
    ("speculative", "on"),
    ("speculative", {"enabled": "yes"}),
    ("speculative", {"max_draft_tokens": 0}),
])
def test_malformed_knobs_are_400_with_the_reference_message(server, field,
                                                            value):
    body = {**CHAT, field: value}
    message = _error_of(server, body)
    assert field in message
    ref = {"priority": jax_server._priority_from,
           "speculative": jax_server._speculative_from}[field]
    assert message == _reference_message(ref, body)


@pytest.mark.parametrize("raw", ["abc", "0", "-5"])
def test_malformed_deadline_header_is_400_with_the_reference_message(server,
                                                                     raw):
    headers = {"X-Request-Deadline-Ms": raw}
    message = _error_of(server, CHAT, headers)
    assert "X-Request-Deadline-Ms" in message
    assert message == _reference_message(jax_server._deadline_from,
                                         _Headers(headers))


@pytest.mark.parametrize("field,value", [
    ("response_format", {"type": "json_object"}),
    ("response_format", {"type": "json_schema",
                         "json_schema": {"name": "x", "schema": SCHEMA}}),
    ("tool_choice", "required"),
    ("tool_choice", {"type": "function",
                     "function": {"name": "get_weather"}}),
])
def test_unhonourable_structured_fields_are_400_naming_them(server, field,
                                                            value,
                                                            monkeypatch):
    """(Named for when the port refused these.) Each is now served, with
    the grammar spec the reference's inspect_request builds, and a forced
    tool call answers in the tool_calls shape."""
    body = {**CHAT, "tools": SCHEMA_TOOLS, field: value}
    out, spec = _served_spec(server, body, monkeypatch)
    want = inspect_request(body)
    assert spec == want.spec
    assert out["usage"]["completion_tokens"] == 2
    message = out["choices"][0]["message"]
    if want.tool_name is not None:
        assert message["content"] is None
        assert message["tool_calls"][0]["function"]["name"] == "get_weather"
    else:
        assert "tool_calls" not in message


@pytest.mark.parametrize("extra", [
    {"tool_choice": "required"},
    {"tool_choice": "required", "tools": []},
    {"tool_choice": "required", "tools": [{"type": "function"}]},
    {"tool_choice": "required", "tools": [{"function": {"name": ""}}]},
    {"tool_choice": {"type": "grammar"}, "tools": TOOLS},
    {"tool_choice": {"type": "function", "function": {}}, "tools": TOOLS},
    {"tool_choice": {"type": "function", "function": {"name": "nope"}},
     "tools": TOOLS},
    {"tool_choice": "always", "tools": TOOLS},
])
def test_malformed_tool_shapes_keep_the_reference_message(server, extra):
    body = {**CHAT, **extra}
    message = _error_of(server, body)
    assert message == _reference_message(_forced_tool, body)


def test_required_with_one_tool_is_refused_naming_the_field(server,
                                                           monkeypatch):
    """(Named for when the port refused it.) The one tool is forced, as
    the reference forces it: its arguments' grammar, the tool_calls
    shape."""
    body = {**CHAT, "tools": SCHEMA_TOOLS, "tool_choice": "required"}
    assert _forced_tool(body) is not None  # the reference would constrain
    out, spec = _served_spec(server, body, monkeypatch)
    assert spec == {"type": "tool_call", "name": "get_weather",
                    "schema": SCHEMA} == inspect_request(body).spec
    [call] = out["choices"][0]["message"]["tool_calls"]
    assert call["function"]["name"] == "get_weather"


@pytest.mark.parametrize("extra", [
    {"tools": TOOLS, "tool_choice": "required"},
    {"tools": TOOLS, "tool_choice": {"type": "function",
                                     "function": {"name": "get_weather"}}},
    {"response_format": {"type": "json_schema", "json_schema": {
        "name": "x", "schema": {"type": "object"}}}},
    {"response_format": {"type": "json_schema", "json_schema": {
        "name": "x", "schema": {"type": "object",
                                "patternProperties": {}}}}},
])
def test_uncompilable_schemas_keep_the_reference_message(server, extra):
    """A schema the compiler cannot take (too large, or a feature it does
    not support) is the reference's 400, naming the feature."""
    body = {**CHAT, **extra}
    assert _error_of(server, body) == _reference_message(inspect_request,
                                                         body)


@pytest.mark.parametrize("field", ["max_tokens", "max_completion_tokens",
                                   "max_output_tokens"])
def test_length_fields_are_the_references(field):
    body = {"input": "hi", field: 5}
    assert port_server._sampling_from(body).max_tokens == 5
    assert jax_server._sampling_from(body).max_tokens == 5


@pytest.mark.parametrize("body", [
    {"stop_sequences": ["\n\nHuman:"]},
    {"stop_sequences": "END"},
    {"stop": ["a"], "stop_sequences": ["b"]},
    {"stop": [], "stop_sequences": ["b", 3]},
])
def test_stop_fields_are_the_references(body):
    assert port_server._stops_from(body) == jax_server._stops_from(body)
    assert port_server._stops_from(body)


@pytest.mark.parametrize("extra,headers", [
    ({"priority": "high"}, None),
    ({"tool_choice": "auto", "tools": TOOLS}, None),
    ({"tool_choice": "required", "tools": TOOLS * 2}, None),
    ({"response_format": {"type": "text"}}, None),
    ({"speculative": {"enabled": False, "max_draft_tokens": 3}},
     {"X-Request-Deadline-Ms": "2500"}),
])
def test_well_formed_fields_still_answer_200(server, extra, headers):
    with _post(server, {**CHAT, **extra}, headers) as resp:
        assert resp.status == 200
        out = json.loads(resp.read())
    assert out["usage"]["completion_tokens"] == 2


def test_accepted_values_ride_on_the_sampling_params():
    sampling = port_server._sampling_from(
        {**CHAT, "priority": "low",
         "speculative": {"enabled": True, "max_draft_tokens": 4}},
        deadline_ms=port_server._deadline_from(
            {"X-Request-Deadline-Ms": "1500"}))
    assert sampling.priority == 2
    assert sampling.speculative == {"enabled": True, "max_draft_tokens": 4}
    assert sampling.deadline_ms == 1500.0
    default = port_server._sampling_from(CHAT)
    assert (default.priority, default.speculative, default.deadline_ms) == (
        1, None, None)


@pytest.mark.parametrize("argv,want", [
    (["--min-prefix-len", "64"], 64),
    (["--min-prefix-len", "0"], 1),
    ([], None),
])
def test_min_prefix_len_reaches_the_core(argv, want):
    """--min-prefix-len parses, as the reference's flag does, and reaches
    EngineCore.min_prefix_len as max(1, n); unset, the core's default (the
    cache's alignment) stands."""
    args = port_server.build_parser().parse_args(["--device", "cpu", *argv])
    core = EngineCore(get_preset("debug-tiny"), device="cpu",
                      **port_server.core_kwargs_from(args))
    assert core.min_prefix_len == (want or core.prefix_align)
    assert core.prefix_cache.min_len == core.min_prefix_len


def test_role_flags_reach_the_core():
    args = port_server.build_parser().parse_args(
        ["--device", "cpu", "--role", "split", "--disagg-prefill-slots", "0"])
    core = EngineCore(get_preset("debug-tiny"), device="cpu",
                      **port_server.core_kwargs_from(args))
    assert core.role == "split"
    assert len(core.split.prefill_pool) == 1  # max(1, n), as the reference
    with pytest.raises(SystemExit):
        port_server.build_parser().parse_args(["--role", "shard"])
