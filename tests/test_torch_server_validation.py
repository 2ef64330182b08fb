"""The port's HTTP server honours or refuses every request field it takes.

`priority`, `speculative` and the `X-Request-Deadline-Ms` header are
validated by the reference's rules: a malformed value is a 400 whose
message is the reference server's own (its `_priority_from`,
`_speculative_from` and `_deadline_from` run on the same input here), and
a well-formed one is carried on the request's SamplingParams. The port has
no constrained decoding, so a `response_format` other than text and a
forced `tool_choice` are 400s naming the field. One debug-tiny server on
the CPU serves every case.
"""

import json
import urllib.error
import urllib.request

import pytest

from llmlb_tpu.engine import server as jax_server
from llmlb_tpu_torch.engine import server as port_server
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine

CHAT = {"model": "debug-tiny", "temperature": 0, "max_tokens": 2,
        "messages": [{"role": "user", "content": "hi"}]}
TOOLS = [{"type": "function",
          "function": {"name": "get_weather",
                       "parameters": {"type": "object"}}}]


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
                         "json_schema": {"name": "x",
                                         "schema": {"type": "object"}}}),
    ("tool_choice", "required"),
    ("tool_choice", {"type": "function",
                     "function": {"name": "get_weather"}}),
])
def test_unhonourable_structured_fields_are_400_naming_them(server, field,
                                                            value):
    message = _error_of(server, {**CHAT, "tools": TOOLS, field: value})
    assert field in message


@pytest.mark.parametrize("extra,headers", [
    ({"priority": "high"}, None),
    ({"tool_choice": "auto", "tools": TOOLS}, None),
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
