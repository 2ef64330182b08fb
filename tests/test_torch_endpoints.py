"""The port's other endpoints against the JAX package: `encode` and
`/v1/embeddings`, `/v1/completions` and `/v1/responses`.

- `llama.encode` against JAX `llama.encode` on the same converted weights
  (fp32, mixed lengths in one padded batch): within 1e-5 absolute, fp32
  sums of the same values in another order on unit vectors whose entries
  are ~0.06;
- `/v1/embeddings` (string, strings and token-id inputs) against the JAX
  `Engine.embed` of the same ids, within the same 1e-5, and each vector
  alone against its place in the batch; the reference's validation
  messages;
- `/v1/completions` and `/v1/responses`, streamed and not, carrying the JAX
  engine's greedy tokens for the same prompt ids, with the reference's
  shapes and validation messages;
- the request fields the reference reads under more than one name:
  `stop_sequences` stops a chat where `stop` does, `/v1/responses`
  takes `max_output_tokens`, and a chat with `tool_choice: "required"` over
  two tools is served unconstrained, as the reference serves it, with the
  JAX engine's greedy ids in its replay frames;
- `/v1/models` advertising `embeddings`;
- each endpoint once through the unchanged gateway, which registers the
  port's server through its own health probe.

One JAX EngineCore, module-scoped (its Engine wrapper serves `embed`).
"""

import asyncio
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.scheduler import Request as JaxRequest
from llmlb_tpu.engine.scheduler import SamplingParams as JaxSampling
from llmlb_tpu.engine.service import Engine as JaxEngine
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.gateway.health import EndpointHealthChecker
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tokenizer import ByteTokenizer, default_chat_template
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.models import llama
from tests.support import GatewayHarness, assert_sse_protocol

ATOL = 1e-5
CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32, 64),
               kv_page_size=16, eos_id=-1, seed=0)
MAX_TOKENS = 12
PROMPT = "Once upon a time"
INPUT = "Say something"
INSTRUCTIONS = "Be brief."
CHAT_MESSAGES = [{"role": "user", "content": "Which tool fits?"}]
TWO_TOOLS = [{"type": "function", "function": {"name": name, "parameters": {
    "type": "object"}}} for name in ("get_weather", "get_time")]
EMBED_INPUTS = ["hello world", "a much longer input sentence to embed here",
                "x"]
TOK = ByteTokenizer(512)


def _completion_ids() -> list[int]:
    return TOK.encode(PROMPT)


def _response_ids() -> list[int]:
    return TOK.encode(default_chat_template(
        [{"role": "system", "content": INSTRUCTIONS},
         {"role": "user", "content": INPUT}]))


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
            return toks


@pytest.fixture(scope="module")
def jax_engine(weights):
    """The JAX engine: greedy streams of the two prompts, and its Engine
    wrapper for embed."""
    core = JaxEngineCore(jax_preset("debug-tiny"), weights[0],
                         kv_layout="paged", prefix_cache=False,
                         decode_burst=1, **CORE_KW)
    core.start()
    try:
        streams = {name: _drain(core.submit(JaxRequest(
            prompt_ids=ids, sampling=JaxSampling(
                temperature=0.0, max_tokens=MAX_TOKENS))).events)
            for name, ids in (("completion", _completion_ids()),
                              ("response", _response_ids()),
                              ("chat", TOK.encode(default_chat_template(
                                  CHAT_MESSAGES))))}
        yield JaxEngine("debug-tiny", core, JaxByteTokenizer(512)), streams
    finally:
        core.stop()


@pytest.fixture(scope="module")
def server(weights):
    engine = Engine.from_preset(
        "debug-tiny", device="cpu",
        params=params_from_numpy(weights[1], get_preset("debug-tiny"), "cpu"),
        **CORE_KW)
    srv, thread = start_server(engine)
    host, port = srv.server_address[:2]
    try:
        yield f"http://{host}:{port}", engine
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


def _post(url, body, timeout=120):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _error(url, body) -> tuple[int, str]:
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(url, body)
    return err.value.code, json.loads(err.value.read())["error"]["message"]


def _data(raw: bytes) -> list[dict]:
    return [json.loads(line[len(b"data:"):]) for line in raw.split(b"\n")
            if line.startswith(b"data:") and line.strip() != b"data: [DONE]"]


# ---------------------------------------------------------------- encode


def test_encode_matches_jax(weights):
    rng = np.random.default_rng(5)
    lens = np.asarray([5, 16, 11, 1], np.int32)
    ids = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(0, 512, size=n)
    want = np.asarray(jllama.encode(weights[0], jax_preset("debug-tiny"),
                                    ids, lens))
    cfg = get_preset("debug-tiny")
    got = llama.encode(params_from_numpy(weights[1], cfg, "cpu"), cfg,
                       torch.from_numpy(ids), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=1e-6)


# ------------------------------------------------------------ embeddings


def test_embeddings_match_jax_engine(server, jax_engine):
    base, engine = server
    jax_eng, _ = jax_engine
    token_input = [3, 1, 4, 1, 5, 9, 2, 6]
    out = json.loads(_post(base + "/v1/embeddings", {
        "model": "debug-tiny", "input": EMBED_INPUTS + [token_input]}))
    assert out["object"] == "list" and out["model"] == "debug-tiny"
    batch = [TOK.encode(s) for s in EMBED_INPUTS] + [token_input]
    assert out["usage"] == {"prompt_tokens": sum(map(len, batch)),
                            "total_tokens": sum(map(len, batch))}
    got = np.asarray([d["embedding"] for d in out["data"]])
    assert [d["index"] for d in out["data"]] == [0, 1, 2, 3]
    want = np.asarray(asyncio.run(jax_eng.embed(batch)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # one input alone (a string, and a single token list) is the vector it
    # has in the batch
    for i, single in ((0, EMBED_INPUTS[0]), (3, token_input)):
        alone = json.loads(_post(base + "/v1/embeddings", {"input": single}))
        np.testing.assert_allclose(alone["data"][0]["embedding"], got[i],
                                   atol=ATOL, rtol=0)


def test_embeddings_validation(server):
    base, _engine = server
    url = base + "/v1/embeddings"
    for body, message in (
            ({}, "'input' is required"),
            ({"input": []}, "'input' must be a non-empty string or array"),
            ({"input": 5}, "'input' must be a non-empty string or array"),
            ({"input": [{"x": 1}]},
             "each input must be a string or token array"),
            ({"input": [[]]}, "each input must contain at least one token"),
            ({"input": [[1, 999]]},
             "token id 999 out of range for vocab size 512")):
        assert _error(url, body) == (400, message)


def test_models_advertise_embeddings(server):
    base, _engine = server
    with urllib.request.urlopen(base + "/v1/models", timeout=30) as resp:
        models = json.loads(resp.read())["data"]
    # the reference's list for a combined engine (role "both"), the
    # disaggregation roles included
    assert models[0]["capabilities"] == ["chat_completion", "structured_outputs",
                                         "embeddings", "prefill", "decode"]
    assert models[0]["role"] == "both"


# ----------------------------------------------------------- completions


@pytest.mark.parametrize("stream", [False, True])
def test_completions_carry_jax_tokens(server, jax_engine, stream):
    base, _engine = server
    want = TOK.decode(jax_engine[1]["completion"])
    raw = _post(base + "/v1/completions", {
        "model": "debug-tiny", "prompt": [PROMPT], "temperature": 0,
        "max_tokens": MAX_TOKENS, "stream": stream})
    if not stream:
        out = json.loads(raw)
        assert out["object"] == "text_completion"
        assert out["choices"][0]["text"] == want
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] == MAX_TOKENS
        return
    assert raw.rstrip().endswith(b"data: [DONE]")
    chunks = _data(raw)
    assert all(c["object"] == "text_completion" for c in chunks)
    assert "".join(c["choices"][0]["text"] for c in chunks) == want
    assert chunks[-1]["choices"][0]["finish_reason"] == "length"
    assert chunks[-1]["usage"]["completion_tokens"] == MAX_TOKENS


@pytest.mark.parametrize("field", ["stop", "stop_sequences"])
def test_stop_sequences_stop_where_stop_does(server, jax_engine, field):
    base, _engine = server
    want = TOK.decode(jax_engine[1]["chat"])
    stop = next((c for c in want[1:] if c != "\ufffd"), None)
    assert stop is not None, f"the greedy ids decode to {want!r}"
    for stream in (False, True):
        raw = _post(base + "/v1/chat/completions", {
            "model": "debug-tiny", "messages": CHAT_MESSAGES,
            "temperature": 0, "max_tokens": MAX_TOKENS, "stream": stream,
            field: [stop]})
        if stream:
            chunks = [c["choices"][0] for c in _data(raw) if c["choices"]]
            text = "".join(c["delta"].get("content") or "" for c in chunks)
        else:
            chunks = json.loads(raw)["choices"]
            text = chunks[0]["message"]["content"]
        assert text == want[:want.find(stop)]
        assert chunks[-1]["finish_reason"] == "stop"


def test_completions_validation(server):
    base, _engine = server
    url = base + "/v1/completions"
    assert _error(url, {"prompt": ""}) == (
        400, "'prompt' must be a non-empty string")
    assert _error(url, {"prompt": ["a", "b"]}) == (
        400, "only a single string prompt is supported")
    assert _error(url, {"prompt": "a", "top_p": 0}) == (
        400, "'top_p' must be in (0, 1]")


# ------------------------------------------------------------- responses


@pytest.mark.parametrize("stream", [False, True])
def test_responses_carry_jax_tokens(server, jax_engine, stream):
    base, _engine = server
    want = TOK.decode(jax_engine[1]["response"])
    raw = _post(base + "/v1/responses", {
        "model": "debug-tiny", "input": INPUT, "instructions": INSTRUCTIONS,
        "temperature": 0, "max_tokens": MAX_TOKENS, "stream": stream})
    if not stream:
        out = json.loads(raw)
    else:
        events = [ln[len(b"event: "):].decode() for ln in raw.split(b"\n")
                  if ln.startswith(b"event: ")]
        assert events[0] == "response.created"
        assert events[-1] == "response.completed"
        chunks = _data(raw)
        deltas = "".join(c["delta"] for c in chunks
                         if c["type"] == "response.output_text.delta")
        assert deltas == want
        out = chunks[-1]["response"]
    assert out["object"] == "response" and out["status"] == "completed"
    assert out["output"][0]["content"][0]["text"] == want
    assert out["usage"]["output_tokens"] == MAX_TOKENS
    assert out["usage"]["input_tokens"] == len(_response_ids())


def test_responses_take_max_output_tokens(server, jax_engine):
    base, _engine = server
    out = json.loads(_post(base + "/v1/responses", {
        "model": "debug-tiny", "input": INPUT, "instructions": INSTRUCTIONS,
        "temperature": 0, "max_output_tokens": 5}))
    assert out["usage"]["output_tokens"] == 5
    assert out["output"][0]["content"][0]["text"] == TOK.decode(
        jax_engine[1]["response"][:5])


def test_required_with_two_tools_serves_the_jax_tokens(server, jax_engine):
    base, _engine = server
    raw = _post(base + "/v1/chat/completions", {
        "model": "debug-tiny", "messages": CHAT_MESSAGES, "tools": TWO_TOOLS,
        "tool_choice": "required", "temperature": 0,
        "max_tokens": MAX_TOKENS, "stream": True, "llmlb_replay": True})
    frames = _data(raw)
    ids = [t for f in frames if f.get("object") == "llmlb.replay"
           for t in f["tokens"]]
    assert ids == jax_engine[1]["chat"]
    text = "".join(c["choices"][0]["delta"].get("content") or ""
                   for c in frames if c.get("choices"))
    assert text == TOK.decode(ids)


def test_responses_validation(server):
    base, _engine = server
    assert _error(base + "/v1/responses", {"input": 3}) == (
        400, "'input' must be a string or message array")


# --------------------------------------------------------------- gateway


async def test_endpoints_through_the_gateway(server, jax_engine):
    """The unchanged gateway registers the port's server (its probe syncs
    the `embeddings` capability from /v1/models) and proxies one request
    of each endpoint to it."""
    base, _engine = server
    jax_eng, streams = jax_engine
    gw = await GatewayHarness.create()
    gw.state.health_checker = EndpointHealthChecker(
        gw.state.registry, gw.state.load_manager, gw.state.db,
        gw.state.http, gw.state.events, interval_s=3600, timeout_s=5.0)
    try:
        r = await gw.client.post("/api/endpoints", json={
            "base_url": base, "name": "port0"},
            headers=await gw.admin_headers())
        assert r.status == 201, await r.text()
        headers = await gw.inference_headers()

        r = await gw.client.post("/v1/completions", json={
            "model": "debug-tiny", "prompt": PROMPT, "temperature": 0,
            "max_tokens": MAX_TOKENS}, headers=headers)
        assert r.status == 200, await r.text()
        assert (await r.json())["choices"][0]["text"] == TOK.decode(
            streams["completion"])

        r = await gw.client.post("/v1/responses", json={
            "model": "debug-tiny", "input": INPUT,
            "instructions": INSTRUCTIONS, "temperature": 0,
            "max_tokens": MAX_TOKENS, "stream": True}, headers=headers)
        assert r.status == 200, await r.text()
        raw = await r.read()
        completed = [c for c in _data(raw)
                     if c.get("type") == "response.completed"]
        assert completed[0]["response"]["output"][0]["content"][0][
            "text"] == TOK.decode(streams["response"])

        r = await gw.client.post("/v1/embeddings", json={
            "model": "debug-tiny", "input": EMBED_INPUTS[:2]},
            headers=headers)
        assert r.status == 200, await r.text()
        got = np.asarray([d["embedding"] for d in (await r.json())["data"]])
        want = np.asarray(await jax_eng.embed(
            [TOK.encode(s) for s in EMBED_INPUTS[:2]]))
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)

        r = await gw.client.post("/v1/chat/completions", json={
            "model": "debug-tiny", "temperature": 0, "max_tokens": 4,
            "stream": True, "messages": [{"role": "user", "content": "hi"}]},
            headers=headers)
        assert r.status == 200
        assert_sse_protocol(await r.read())
    finally:
        await gw.close()
