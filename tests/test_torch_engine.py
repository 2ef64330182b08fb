"""The port's engine and HTTP server against the JAX paged engine.

Both cores get the reference's debug-tiny weights (carried across with
params_from_numpy) and the same prompts, submitted together: short ones
that prefill in one bucketed dispatch and one longer than the largest
bucket, which goes through chunked prefill. Greedy token streams must be
identical — for the port at decode burst 1 and 4.

The port's HTTP server serves the same weights, and the unchanged gateway
(tests/support.py GatewayHarness) fronts it: a chat through the gateway,
streamed and not, gives the JAX engine's greedy tokens for the same
prompt, and a stream the gateway arms with `llmlb_replay` completes as a
plain one does. The JAX engine runs once, for both.
"""

import collections
import json
import urllib.request

import aiohttp
import jax
import numpy as np
import pytest

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.gateway.detection import detect_endpoint_type
from llmlb_tpu.gateway.health import EndpointHealthChecker
from llmlb_tpu.gateway.types import EndpointType
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine import server as port_server
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer, default_chat_template
from llmlb_tpu_torch.engine.weights import params_from_numpy
from tests.support import GatewayHarness, assert_sse_protocol, parse_sse_frames

CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0)
PROMPT_LENS = (5, 12, 20, 70, 9)  # 70 > the largest bucket: chunked prefill
MAX_TOKENS = 10
# the gateway test's chat: 31 tokens once templated, one 32-token bucket in
# both engines
GATEWAY_CHAT = [{"role": "user", "content": "hi port"}]


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"), jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(21)
    return [rng.integers(0, 256, size=(n,)).tolist() for n in PROMPT_LENS]


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


def _run_jax(jparams, prompts, later=()):
    """Greedy streams of `prompts` submitted together, then of each of
    `later` alone on the idle engine."""
    core = JaxEngineCore(jax_preset("debug-tiny"), jparams, kv_layout="paged",
                         prefix_cache=False, decode_burst=1, **CORE_KW)

    def submit(p):
        return core.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
            temperature=0.0, max_tokens=MAX_TOKENS)))

    reqs = [submit(p) for p in prompts]
    core.start()  # everything queued before the loop starts: same groups
    try:
        out = [_drain(r.events) for r in reqs]
        return out + [_drain(submit(p).events) for p in later]
    finally:
        core.stop()


def _run_port(np_params, prompts, burst):
    cfg = get_preset("debug-tiny")
    core = EngineCore(cfg, params_from_numpy(np_params, cfg, "cpu"),
                      device="cpu", decode_burst=burst, **CORE_KW)
    reqs = [core.submit(Request(prompt_ids=list(p), sampling=SamplingParams(
        temperature=0.0, max_tokens=MAX_TOKENS))) for p in prompts]
    core.start()
    try:
        out = [_drain(r.events) for r in reqs]
        assert core.nan_logit_rows() == 0
        assert core.page_pool.available() == core.page_pool.total
        return out
    finally:
        core.stop()


def _chat_ids(messages) -> list[int]:
    """The prompt ids the port's server builds for a chat (debug-tiny)."""
    return ByteTokenizer(512).encode(default_chat_template(messages))


@pytest.fixture(scope="module")
def jax_run(weights, prompts):
    return _run_jax(weights[0], prompts, later=[_chat_ids(GATEWAY_CHAT)])


@pytest.fixture(scope="module")
def jax_streams(jax_run, prompts):
    return jax_run[:len(prompts)]


@pytest.fixture(scope="module")
def jax_chat_stream(jax_run):
    return jax_run[-1]


@pytest.mark.parametrize("burst", [1, 4])
def test_greedy_streams_identical_to_jax_engine(weights, prompts, jax_streams,
                                                burst):
    port = _run_port(weights[1], prompts, burst)
    assert [r for _t, r in jax_streams] == ["length"] * len(prompts)
    assert port == jax_streams


# ---------------------------------------------------------------- HTTP server


@pytest.fixture(scope="module")
def server(weights):
    """The port's server over the reference's debug-tiny weights."""
    engine = Engine.from_preset(
        "debug-tiny", device="cpu",
        params=params_from_numpy(weights[1], get_preset("debug-tiny"), "cpu"),
        num_slots=4, slot_capacity=128, prefill_buckets=(16, 32, 64),
        kv_page_size=16, eos_id=-1)
    srv, thread = start_server(engine)
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}", engine
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=120)


CHAT = {"model": "debug-tiny", "temperature": 0, "max_tokens": 6,
        "messages": [{"role": "user", "content": "hi there"}]}


def test_chat_completion_non_streaming(server):
    base, _engine = server
    with _post(base + "/v1/chat/completions", CHAT) as resp:
        body = json.loads(resp.read())
    assert body["object"] == "chat.completion"
    choice = body["choices"][0]
    assert choice["message"]["role"] == "assistant"
    assert choice["finish_reason"] == "length"
    assert body["usage"]["completion_tokens"] == 6
    assert body["usage"]["total_tokens"] == (body["usage"]["prompt_tokens"]
                                             + 6)


def test_chat_completion_streaming(server):
    base, _engine = server
    with _post(base + "/v1/chat/completions", {**CHAT, "stream": True}) as resp:
        assert resp.headers["Content-Type"] == "text/event-stream"
        lines = [ln.decode().strip() for ln in resp if ln.strip()]
    assert all(ln.startswith("data: ") for ln in lines)
    assert lines[-1] == "data: [DONE]"
    chunks = [json.loads(ln[6:]) for ln in lines[:-1]]
    assert chunks[0]["choices"][0]["delta"] == {"role": "assistant",
                                               "content": ""}
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)
    assert chunks[-2]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["choices"] == []
    assert chunks[-1]["usage"]["completion_tokens"] == 6
    # the streamed text is what the non-streaming call returns (greedy)
    text = "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks[:-1])
    with _post(base + "/v1/chat/completions", CHAT) as resp:
        assert json.loads(resp.read())["choices"][0]["message"]["content"] == text


def test_bad_request_is_400(server):
    base, _engine = server
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(base + "/v1/chat/completions", {"messages": []})
    assert err.value.code == 400
    assert "messages" in json.loads(err.value.read())["error"]["message"]


def test_models_health_and_system(server):
    base, engine = server
    status, models = _get(base + "/v1/models")
    assert status == 200 and models["data"][0]["id"] == "debug-tiny"
    status, health = _get(base + "/api/health")
    assert status == 200 and health["status"] == "ok"
    assert health["engine"]["num_slots"] == 4
    assert health["device"]["type"] == "cpu"
    status, system = _get(base + "/api/system")
    assert system["tpu_engine"] is True and system["backend"] == "cuda"
    assert system["device"] == "cpu"


async def test_gateway_detects_the_port_as_an_in_tree_engine(server):
    """The unchanged gateway detection classifies the port's server as TPU
    (the in-tree engine type) through /api/system."""
    base, _engine = server
    async with aiohttp.ClientSession() as session:
        assert await detect_endpoint_type(base, session) == EndpointType.TPU


# ------------------------------------------------------- gateway in front


def _content(chunks: list[dict]) -> str:
    return "".join(c["choices"][0]["delta"].get("content", "")
                   for c in chunks if c.get("choices"))


def _chunks(raw: bytes) -> list[dict]:
    return [json.loads(d) for f in parse_sse_frames(raw) for d in f["data"]
            if d != "[DONE]"]


async def test_gateway_proxies_chat_to_the_port(server, jax_chat_stream,
                                                monkeypatch):
    """The unchanged gateway registers the port's server, proxies a
    streamed and a non-streamed chat to it, and both carry the JAX engine's
    greedy tokens for the same prompt; the stream the gateway arms with
    `llmlb_replay` ends as the plain stream to the port does."""
    base, engine = server
    want_ids, want_reason = jax_chat_stream
    assert want_reason == "length" and len(want_ids) == MAX_TOKENS
    emitted = collections.defaultdict(list)  # request id -> tokens
    emit = engine.core._emit

    def record(slot_id, token):
        emitted[engine.core.slots[slot_id].request.request_id].append(token)
        emit(slot_id, token)

    monkeypatch.setattr(engine.core, "_emit", record)
    bodies = []  # what the port's server received
    chat = port_server._Handler._chat

    def spy(handler, body):
        bodies.append(body)
        chat(handler, body)

    monkeypatch.setattr(port_server._Handler, "_chat", spy)
    body = {"model": "debug-tiny", "temperature": 0, "max_tokens": MAX_TOKENS,
            "messages": GATEWAY_CHAT}

    gw = await GatewayHarness.create()
    # registration probes the endpoint's health and syncs its models
    gw.state.health_checker = EndpointHealthChecker(
        gw.state.registry, gw.state.load_manager, gw.state.db,
        gw.state.http, gw.state.events, interval_s=3600, timeout_s=5.0)
    try:
        r = await gw.client.post("/api/endpoints", json={
            "base_url": base, "name": "port0"},
            headers=await gw.admin_headers())
        assert r.status == 201, await r.text()
        created = await r.json()
        assert created["endpoint_type"] == "tpu"
        assert [m["model_id"] for m in created["models"]] == ["debug-tiny"]
        headers = await gw.inference_headers()

        r = await gw.client.post("/v1/chat/completions",
                                 json={**body, "stream": True},
                                 headers=headers)
        assert r.status == 200, await r.text()
        raw = await r.read()
        assert_sse_protocol(raw)
        armed = _chunks(raw)

        r = await gw.client.post("/v1/chat/completions", json=body,
                                 headers=headers)
        assert r.status == 200, await r.text()
        whole = await r.json()
    finally:
        await gw.close()

    # the plain stream, straight to the port
    async with aiohttp.ClientSession() as session:
        async with session.post(base + "/v1/chat/completions",
                                json={**body, "stream": True}) as resp:
            raw_plain = await resp.read()
    assert_sse_protocol(raw_plain)
    plain = _chunks(raw_plain)

    assert [b.get("llmlb_replay") for b in bodies] == [True, None, None]
    # three greedy runs of the prompt, each the JAX engine's tokens
    assert len(emitted) == 3
    assert all(t == want_ids for t in emitted.values()), (dict(emitted),
                                                          want_ids)
    text = ByteTokenizer(512).decode(want_ids)
    assert _content(armed) == _content(plain) == text
    assert whole["choices"][0]["message"]["content"] == text
    assert whole["choices"][0]["finish_reason"] == "length"
    for chunks in (armed, plain):
        assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["usage"]["completion_tokens"] == MAX_TOKENS
    assert whole["usage"]["completion_tokens"] == MAX_TOKENS
