"""Durable streams and graceful drain on the port's server, against the JAX
package: counterpart of tests/engine/test_drain.py.

- an armed chat stream (`llmlb_replay`) carries `llmlb.replay` frames with
  every committed id, and they are the JAX engine's uninterrupted tokens
  (greedy and seeded); `/v1/resume` from any committed prefix gives the
  full stream again;
- `/v1/resume` non-streaming, its validation message, and no replay frames
  on an unarmed stream; an adoption's committed ids go out before its
  first new token;
- drain: new work refused with 503, `Retry-After` and code `draining`;
  `/api/health` advertises it and the gateway's own health parser reads
  it; in-flight work finishing within the grace; a straggler parked and
  its socket shut down after it;
- two port servers behind the unchanged gateway: the `engine_abort` fault
  rule cuts the first stream mid-way, the gateway resumes it on the other
  server through `/v1/resume`, and the client's stream passes the SSE
  protocol checks and carries the JAX engine's greedy tokens.

Each drain builds its own server (drain is one-way); one JAX EngineCore,
module-scoped. debug-tiny in fp32 on the CPU: streams compare token for
token.
"""

import asyncio
import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.gateway.faults import FaultInjector, FaultRule
from llmlb_tpu.gateway.health import _parse_telemetry
from llmlb_tpu.gateway.types import EndpointType
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import SamplingParams
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer, default_chat_template
from llmlb_tpu_torch.engine.weights import params_from_numpy
from tests.support import GatewayHarness, assert_sse_protocol

MESSAGES = [{"role": "user", "content": "the quick brown fox"}]
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32, 64),
               kv_page_size=16, eos_id=-1, seed=0)
MAX_TOKENS = 16
SEEDED = dict(temperature=0.9, seed=1234)
SAMPLINGS = {"greedy": dict(temperature=0.0), "seeded": SEEDED}


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


def _prompt_ids() -> list[int]:
    return ByteTokenizer(512).encode(default_chat_template(MESSAGES))


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
    """The chat's uninterrupted JAX streams: greedy and seeded."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", prefix_cache=False,
                         decode_burst=1, **CORE_KW)
    core.start()
    try:
        return {name: _drain(core.submit(JaxRequest(
            prompt_ids=_prompt_ids(), sampling=JaxSampling(
                max_tokens=MAX_TOKENS, **s))).events)[0]
            for name, s in SAMPLINGS.items()}
    finally:
        core.stop()


def _engine(weights, slot_capacity=128) -> Engine:
    cfg = get_preset("debug-tiny")
    return Engine.from_preset(
        "debug-tiny", device="cpu", params=params_from_numpy(
            weights[1], cfg, "cpu"),
        **{**CORE_KW, "slot_capacity": slot_capacity})


class _Server:
    def __init__(self, weights, slot_capacity=128):
        self.engine = _engine(weights, slot_capacity)
        self.srv, self.thread = start_server(self.engine)
        self.host, self.port = self.srv.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        self.engine.shutdown()


@pytest.fixture(scope="module")
def server(weights):
    s = _Server(weights)
    yield s
    s.close()


def _body(max_tokens=MAX_TOKENS, stream=True, replay=True, sampling=None):
    body = {"model": "debug-tiny", "messages": MESSAGES,
            "max_tokens": max_tokens, "stream": stream,
            **(sampling or SAMPLINGS["greedy"])}
    if replay:
        body["llmlb_replay"] = True
    return body


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, dict(resp.headers), resp.read()


def _parse_stream(raw: bytes):
    """(content text, replay ids, finish reason) of a chat SSE body."""
    text, tokens, finish = [], [], None
    for line in raw.split(b"\n"):
        line = line.strip()
        if not line.startswith(b"data:"):
            continue
        data = line[len(b"data:"):].strip()
        if not data or data == b"[DONE]":
            continue
        obj = json.loads(data)
        if obj.get("object") == "llmlb.replay":
            tokens.extend(obj["tokens"])
            continue
        for choice in obj.get("choices") or []:
            text.append((choice.get("delta") or {}).get("content") or "")
            finish = choice.get("finish_reason") or finish
    return "".join(text), tokens, finish


# ------------------------------------------------------------- /v1/resume


@pytest.mark.parametrize("name", ["greedy", "seeded"])
def test_resume_replays_the_jax_stream(server, jax_streams, name):
    """The armed stream's replay frames carry every committed id, in order:
    the JAX engine's tokens. `/v1/resume` from 0, half and all of them
    gives the full stream again: the same text and the same ids."""
    body = _body(sampling=SAMPLINGS[name])
    status, _h, raw = _post(server.url + "/v1/chat/completions", body)
    assert status == 200
    text, tokens, finish = _parse_stream(raw)
    assert tokens == jax_streams[name] and finish == "length"
    assert text == ByteTokenizer(512).decode(tokens)
    for cut in (0, len(tokens) // 2, len(tokens)):
        status, _h, raw = _post(server.url + "/v1/resume",
                                {**body, "committed_ids": tokens[:cut]})
        assert status == 200
        assert _parse_stream(raw) == (text, tokens, "length"), cut


def test_resume_non_streaming_and_validation(server, jax_streams):
    ids = jax_streams["greedy"]
    body = _body(stream=False, replay=False)
    status, _h, raw = _post(server.url + "/v1/resume",
                            {**body, "committed_ids": ids[:5]})
    out = json.loads(raw)
    assert status == 200 and out["object"] == "chat.completion"
    assert out["choices"][0]["message"]["content"] == \
        ByteTokenizer(512).decode(ids)
    assert out["usage"]["completion_tokens"] == MAX_TOKENS
    for bad, message in (
            (["nope"], "'committed_ids' must be a list of token ids"),
            ([True], "'committed_ids' must be a list of token ids"),
            ([1 << 20], "committed token id 1048576 out of range for vocab "
                        "size 512")):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.url + "/v1/resume", {**body, "committed_ids": bad})
        assert err.value.code == 400
        assert json.loads(err.value.read())["error"]["message"] == message
    # a resume whose committed tokens already reach max_tokens, or hold a
    # stop string, ends at once
    status, _h, raw = _post(server.url + "/v1/resume",
                            {**body, "max_tokens": 5, "committed_ids": ids[:5]})
    out = json.loads(raw)
    assert out["choices"][0]["finish_reason"] == "length"
    assert out["usage"]["completion_tokens"] == 5
    text = ByteTokenizer(512).decode(ids)
    assert text, "the greedy ids decode to no text"
    stop = text[-1]
    status, _h, raw = _post(server.url + "/v1/resume",
                            {**body, "stop": [stop], "committed_ids": ids})
    out = json.loads(raw)
    assert out["choices"][0]["finish_reason"] == "stop"
    assert out["choices"][0]["message"]["content"] == text[:text.find(stop)]


def test_adoption_sends_committed_ids_before_the_first_new_token(
        server, jax_streams):
    """An adopted stream's first delta carries exactly the committed text
    and ids (its exact resume feeds them through decode steps before the
    first new token); the deltas after it complete the JAX stream."""
    ids = jax_streams["greedy"]
    deltas = server.engine.adopt_stream(
        _prompt_ids(), ids[:8], SamplingParams(max_tokens=MAX_TOKENS,
                                               temperature=0.0))
    first = next(deltas)
    assert first.token_ids == ids[:8] and first.finish_reason is None
    assert first.text == ByteTokenizer(512).decode(ids[:8])
    rest = list(deltas)
    assert [t for d in rest for t in d.token_ids] == ids[8:]
    assert rest[-1].finish_reason == "length"


def test_unarmed_stream_has_no_replay_frames(server):
    status, _h, raw = _post(server.url + "/v1/chat/completions",
                            _body(max_tokens=6, replay=False))
    assert status == 200 and b"llmlb.replay" not in raw
    assert raw.rstrip().endswith(b"data: [DONE]")


# ------------------------------------------------------------------ drain


def _health(url):
    with urllib.request.urlopen(url + "/api/health", timeout=30) as resp:
        return json.loads(resp.read())


def test_drain_refuses_new_work_with_retry_after(weights):
    s = _Server(weights)
    try:
        status, _h, raw = _post(s.url + "/api/drain", {"grace_s": 30})
        assert status == 200 and json.loads(raw)["draining"] is True
        health = _health(s.url)
        assert health["status"] == "draining"
        assert health["draining"]["draining"] is True
        assert "sched" in health
        # the unchanged gateway's probe parser reads it as draining
        info = _parse_telemetry(health)
        assert info.draining and 0 < info.drain_remaining_s <= 30
        for path in ("/v1/chat/completions", "/v1/completions",
                     "/v1/embeddings", "/v1/resume"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(s.url + path, _body(stream=False, replay=False))
            assert err.value.code == 503
            assert 1 <= int(err.value.headers["Retry-After"]) <= 30
            assert json.loads(err.value.read())["error"]["code"] == "draining"
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(s.url + "/api/drain", {"grace_s": -1})
        assert err.value.code == 400
    finally:
        s.close()


def test_drain_lets_inflight_work_finish_within_grace(weights):
    s = _Server(weights)
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(r=_post(
            s.url + "/v1/chat/completions", _body(max_tokens=40,
                                                  replay=False))))
        t.start()
        while not s.engine.core.stats().active_slots and t.is_alive():
            time.sleep(0.001)
        _post(s.url + "/api/drain", {"grace_s": 20})
        t.join(timeout=60)
        status, _h, raw = out["r"]
        assert status == 200 and raw.rstrip().endswith(b"data: [DONE]")
        assert _parse_stream(raw)[2] == "length"
        assert s.engine.core.stats().drain_parked_total == 0
        assert s.srv.drain.info()["aborted_connections"] == 0
    finally:
        s.close()


def test_drain_parks_stragglers_and_shuts_their_sockets(weights):
    """A stream still decoding when the grace is spent: its row parks (its
    committed tokens kept) and its connection is cut, with no [DONE]."""
    s = _Server(weights, slot_capacity=2048)
    try:
        conn = http.client.HTTPConnection(s.host, s.port, timeout=60)
        conn.request("POST", "/v1/chat/completions",
                     body=json.dumps(_body(max_tokens=1900)),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 200
        got = b""
        while got.count(b"llmlb.replay") < 3:  # decoding is under way
            got += resp.readline()
        status, _h, raw = _post(s.url + "/api/drain", {"grace_s": 0.05})
        assert json.loads(raw)["draining"] is True
        try:
            while True:
                line = resp.readline()
                if not line:
                    break
                got += line
        except (OSError, http.client.HTTPException):
            pass  # the cut itself
        conn.close()
        assert b"[DONE]" not in got
        s.srv.drain.wait(timeout=30)
        info = s.srv.drain.info()
        assert info["parked"] == 1 and info["aborted_connections"] == 1
        st = s.engine.core.stats()
        assert st.drain_parked_total == 1 and st.active_slots == 0
        assert _health(s.url)["draining"]["parked"] == 1
    finally:
        s.close()


# ------------------------------------------------------- gateway failover


async def test_gateway_resumes_a_cut_stream_on_the_other_port_server(
        weights, jax_streams):
    """Two port servers behind the unchanged gateway; the first stream is
    cut after about half its bytes (`engine_abort`), the gateway replays
    its committed ids onto the other server's /v1/resume, and the client
    gets one well-formed stream of the JAX engine's greedy tokens."""
    a, b = _Server(weights), _Server(weights)
    gw = await GatewayHarness.create()
    try:
        # how many bytes an armed stream of this chat takes
        _s, _h, armed = _post(a.url + "/v1/chat/completions", _body())
        for i, s in enumerate((a, b)):
            gw.register_mock(s.url, ["debug-tiny"],
                             endpoint_type=EndpointType.TPU, name=f"port{i}")
        gw.state.faults = FaultInjector()
        gw.state.faults.add_rule(FaultRule(
            kind="engine_abort", endpoint="*", path="chat",
            after_bytes=len(armed) // 2, max_fires=1))
        r = await gw.client.post("/v1/chat/completions",
                                 json=_body(replay=False),
                                 headers=await gw.inference_headers())
        assert r.status == 200, await r.text()
        raw = await r.read()
        assert b"event: error" not in raw
        assert_sse_protocol(raw, "openai")
        text, _tokens, finish = _parse_stream(raw)
        assert text == ByteTokenizer(512).decode(jax_streams["greedy"])
        assert finish == "length"
        summary = gw.state.metrics.summary()
        assert summary["stream_resumes"] == {"success": 1}
        resumed = summary["stream_resumed_tokens_total"]
        assert 0 < resumed < MAX_TOKENS
        # the resumed server re-activated one parked request
        assert sum(s.engine.core.stats().preempt_resumes_total
                   for s in (a, b)) == 1
    finally:
        await gw.close()
        await asyncio.to_thread(a.close)
        await asyncio.to_thread(b.close)
