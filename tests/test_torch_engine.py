"""The port's engine and HTTP server against the JAX paged engine.

Both cores get the reference's debug-tiny weights (carried across with
params_from_numpy) and the same prompts, submitted together: short ones
that prefill in one bucketed dispatch and one longer than the largest
bucket, which goes through chunked prefill. Greedy token streams must be
identical — for the port at decode burst 1 and 4.
"""

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
from llmlb_tpu.gateway.types import EndpointType
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.scheduler import EngineCore, Request, SamplingParams
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.weights import params_from_numpy

CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32),
               kv_page_size=16, eos_id=-1, seed=0)
PROMPT_LENS = (5, 12, 20, 70, 9)  # 70 > the largest bucket: chunked prefill
MAX_TOKENS = 10


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


def _run_jax(jparams, prompts):
    core = JaxEngineCore(jax_preset("debug-tiny"), jparams, kv_layout="paged",
                         prefix_cache=False, decode_burst=1, **CORE_KW)
    reqs = [core.submit(JaxRequest(prompt_ids=list(p), sampling=JaxSampling(
        temperature=0.0, max_tokens=MAX_TOKENS))) for p in prompts]
    core.start()  # everything queued before the loop starts: same groups
    try:
        return [_drain(r.events) for r in reqs]
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


@pytest.fixture(scope="module")
def jax_streams(weights, prompts):
    return _run_jax(weights[0], prompts)


@pytest.mark.parametrize("burst", [1, 4])
def test_greedy_streams_identical_to_jax_engine(weights, prompts, jax_streams,
                                                burst):
    port = _run_port(weights[1], prompts, burst)
    assert [r for _t, r in jax_streams] == ["length"] * len(prompts)
    assert port == jax_streams


# ---------------------------------------------------------------- HTTP server


@pytest.fixture(scope="module")
def server():
    engine = Engine.from_preset("debug-tiny", device="cpu", num_slots=4,
                                slot_capacity=128, prefill_buckets=(16, 32, 64),
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
