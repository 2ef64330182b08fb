"""The port's gateway client API over real engines, held against the JAX
stack.

- /v1/messages: the port's gateway in front of the port's engine server
  gives the JAX gateway-in-front-of-JAX-engine's greedy text, stop reason
  and usage on the same debug-tiny weights, plain and streamed (a
  well-formed Anthropic event stream), and the playground proxy gives the
  JAX stack's chat. A TPS benchmark of 4 requests x 8 tokens through each
  gateway completes with 4 successes and the JAX stack's record keys and
  counts (the benchmark samples at temperature 0.7 with no seed, so its
  text is not compared).
- Media: one port engine server with the small random ASR, TTS and image
  services (`from_random`) registered in the JAX gateway and in the port's
  gateway: each syncs its three models with their capabilities, and
  speech, two transcriptions, two images and the capability 404 and 400
  answer the same through both; an edit, which the server does not
  serve, gets its 404 through the port's gateway (ROADMAP C16).

One JAX EngineCore (module-scoped), debug-tiny in fp32 on the CPU.
"""

import asyncio
import base64
import json
import sys

import jax
import numpy as np
import pytest
from aiohttp.test_utils import TestServer

from llmlb_tpu.engine.presets import get_preset as jax_preset
from llmlb_tpu.engine.scheduler import EngineCore as JaxEngineCore
from llmlb_tpu.engine.server import create_engine_app
from llmlb_tpu.engine.service import Engine as JaxEngine
from llmlb_tpu.engine.tokenizer import ByteTokenizer as JaxByteTokenizer
from llmlb_tpu.models import llama as jllama
from llmlb_tpu_torch.engine.asr import AsrEngine
from llmlb_tpu_torch.engine.image import ImageEngine
from llmlb_tpu_torch.engine.presets import get_preset
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tts import TtsEngine, encode_wav
from llmlb_tpu_torch.engine.weights import params_from_numpy
from llmlb_tpu_torch.gateway import http as gh
from tests.support import ADMIN_PASSWORD, assert_sse_protocol, parse_sse_frames
from tests.test_torch_gateway_e2e import _jax_gateway, _PortGateway

CORE_KW = dict(num_slots=4, slot_capacity=128, prefill_buckets=(16, 32, 64),
               kv_page_size=16, eos_id=-1, seed=0)
MAX_TOKENS = 12


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    # the reference's token estimates by its ~4-characters fallback, as the
    # port's (its tiktoken path would fetch a BPE file over the network:
    # ROADMAP C15)
    monkeypatch.setitem(sys.modules, "tiktoken", None)


async def _login(s, base: str) -> tuple[dict, dict]:
    r = await s.post(base + "/api/auth/login", json={
        "username": "admin", "password": ADMIN_PASSWORD})
    admin = {"Authorization": "Bearer " + (await r.json())["token"]}
    r = await s.post(base + "/api/api-keys", json={"name": "t"},
                     headers=admin)
    inf = {"Authorization": "Bearer " + (await r.json())["api_key"]}
    return admin, inf


# ------------------------------------------------------------ /v1/messages


def _anthropic_stream(raw: bytes) -> tuple[str, str, dict]:
    text, stop, usage = [], None, {}
    for frame in parse_sse_frames(raw):
        for d in frame["data"]:
            obj = json.loads(d)
            if obj["type"] == "content_block_delta":
                text.append(obj["delta"]["text"])
            elif obj["type"] == "message_delta":
                stop, usage = obj["delta"]["stop_reason"], obj["usage"]
    return "".join(text), stop, usage


async def _messages(base: str, engine_url: str) -> dict:
    async with gh.ClientSession() as s:
        admin, inf = await _login(s, base)
        r = await s.post(base + "/api/endpoints", json={
            "base_url": engine_url, "name": "engine"}, headers=admin)
        ep = await r.json()
        assert r.status == 201, ep
        body = {"model": "debug-tiny", "max_tokens": MAX_TOKENS,
                "temperature": 0, "system": "Answer briefly.",
                "messages": [{"role": "user", "content": "the quick brown"}]}
        r = await s.post(base + "/v1/messages", json=body, headers=inf)
        plain = await r.json()
        assert r.status == 200, plain
        r = await s.post(base + "/v1/messages", json={**body, "stream": True},
                         headers=inf)
        raw = await r.read()
        assert_sse_protocol(raw, "anthropic")
        r = await s.post(base + f"/api/endpoints/{ep['id']}/chat/completions",
                         json={"model": "debug-tiny", "max_tokens": MAX_TOKENS,
                               "temperature": 0, "messages": body["messages"]},
                         headers=admin)
        play = await r.json()
        assert r.status == 200, play
        r = await s.post(base + "/api/benchmarks/tps", json={
            "model": "debug-tiny", "requests": 4, "concurrency": 2,
            "max_tokens": 8}, headers=admin)
        run_id = (await r.json())["run_id"]
        for _ in range(1200):
            r = await s.get(base + f"/api/benchmarks/tps/{run_id}",
                            headers=admin)
            run = await r.json()
            if run["status"] != "running":
                break
            await asyncio.sleep(0.05)
    return {
        "tps_run": (run["status"], sorted(run), run["requests"],
                    run["succeeded"], run["failed"], run["errors"],
                    {ep["name"] if k == ep["id"] else k: v["requests"]
                     for k, v in run["per_endpoint"].items()}),
        "plain": ([b["text"] for b in plain["content"]],
                  plain["stop_reason"], plain["usage"]),
        "stream": _anthropic_stream(raw),
        "playground": (play["choices"][0]["message"]["content"],
                       play["usage"]),
    }


@pytest.fixture(scope="module")
def weights():
    jparams = jllama.init_params(jax_preset("debug-tiny"),
                                 jax.random.PRNGKey(0))
    return jparams, {k: np.asarray(v) for k, v in jparams.items()}


async def test_messages_full_path_matches_the_jax_stack(weights):
    cfg = jax_preset("debug-tiny")
    jcore = JaxEngineCore(cfg, weights[0], kv_layout="paged",
                          prefix_cache=False, **CORE_KW)
    jcore.start()
    jengine = JaxEngine("debug-tiny", jcore, JaxByteTokenizer(cfg.vocab_size))
    jserver = TestServer(create_engine_app(jengine, owns_engine=False))
    await jserver.start_server()
    engine = Engine.from_preset(
        "debug-tiny", device="cpu",
        params=params_from_numpy(weights[1], get_preset("debug-tiny"), "cpu"),
        **CORE_KW)
    srv, thread = start_server(engine)
    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()
    try:
        ref = await _messages(jax_url, f"http://127.0.0.1:{jserver.port}")
        ours = await _messages(port.url, "http://%s:%d" % srv.server_address[:2])
        assert ours == ref
        text, stop, usage = ours["stream"]
        assert [text] == ours["plain"][0] and stop == "max_tokens"
        assert usage["output_tokens"] == MAX_TOKENS
        assert ours["plain"][2]["output_tokens"] == MAX_TOKENS
        assert ours["playground"][1]["completion_tokens"] == MAX_TOKENS
        assert ours["tps_run"][0] == "completed"
        assert ours["tps_run"][2:] == (4, 4, 0, [], {"engine": 4})
    finally:
        await gw.close()
        await port.close()
        await jserver.close()
        await asyncio.to_thread(jcore.stop)
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()


# ------------------------------------------------------------------- media


async def _media(base: str, server_url: str) -> list:
    out = []
    async with gh.ClientSession() as s:
        admin, inf = await _login(s, base)

        async def call(path, **kw):
            r = await s.post(base + path, headers=inf, **kw)
            raw = await r.read()
            ctype = r.headers.get("Content-Type", "").split(";")[0]
            if ctype == "application/json":
                obj = json.loads(raw)
                if isinstance(obj, dict):
                    obj.pop("created", None)
                    for d in obj.get("data") or []:
                        # the service draws fresh noise on every request:
                        # a PNG's signature and size, not its pixels
                        png = base64.b64decode(d.pop("b64_json"))
                        d["png"] = (png[:8], png[16:24])
                out.append((path, r.status, obj))
            else:
                out.append((path, r.status, ctype, raw))
            return raw

        speech = {"model": "tts-test", "input": "hello there",
                  "voice": "nova"}
        await call("/v1/audio/speech", json=speech)  # nothing registered
        r = await s.post(base + "/api/endpoints", json={
            "base_url": server_url, "name": "mm"}, headers=admin)
        ep = await r.json()
        out.append(("register", r.status, ep["endpoint_type"], sorted(
            (m["model_id"], m["capabilities"]) for m in ep["models"])))
        wav = await call("/v1/audio/speech", json=speech)
        form = gh.FormData()
        form.add_field("file", wav, filename="speech.wav",
                       content_type="audio/wav")
        form.add_field("model", "whisper-test")
        await call("/v1/audio/transcriptions", data=form)
        chirp = np.sin(2 * np.pi * np.cumsum(np.linspace(200, 2000, 16000))
                       / 16000).astype(np.float32)
        form = gh.FormData()
        form.add_field("file", encode_wav(chirp), filename="chirp.wav",
                       content_type="audio/wav")
        await call("/v1/audio/transcriptions", data=form)
        await call("/v1/images/generations", json={
            "model": "diffusion-test", "prompt": "a tiny square", "n": 2})
        await call("/v1/audio/speech", json={"model": "nope", "input": "x"})
        await call("/v1/audio/speech", json={"model": "tts-test"})
    return out


async def test_media_through_both_gateways_answer_the_same():
    engine = Engine.from_preset("debug-tiny", model_id="tpu-mm", device="cpu",
                                num_slots=2, slot_capacity=64,
                                prefill_buckets=(16, 32), kv_page_size=16)
    services = {
        "asr": AsrEngine.from_random(seed=1, model_id="whisper-test",
                                     device="cpu"),
        "tts": TtsEngine.from_random(seed=2, model_id="tts-test",
                                     device="cpu"),
        "image": ImageEngine.from_random(seed=3, model_id="diffusion-test",
                                         sample_steps=2, device="cpu")}
    srv, thread = start_server(engine, **services)
    url = "http://%s:%d" % srv.server_address[:2]
    gw, jax_url = await _jax_gateway()
    port = await _PortGateway.create()
    try:
        ref = await _media(jax_url, url)
        ours = await _media(port.url, url)
        assert ours == ref
        # a route the server does not serve: its 404 passes through the
        # port's gateway (ROADMAP C16: the JAX gateway's client may 502)
        async with gh.ClientSession() as s:
            _, inf = await _login(s, port.url)
            form = gh.FormData()
            form.add_field("image", b"\x89PNG\r\n\x1a\n", filename="a.png",
                           content_type="image/png")
            r = await s.post(port.url + "/v1/images/edits", data=form,
                             headers=inf)
            edit = (r.status, await r.json())
        assert edit == (404, {"error": {
            "message": "no route for POST /v1/images/edits",
            "type": "invalid_request_error", "code": None}})
        rec = {r[0]: r for r in ours}
        assert ours[0][1] == 404
        synced = dict(rec["register"][3])
        assert rec["register"][1:3] == (201, "tpu")
        assert (synced["whisper-test"], synced["tts-test"],
                synced["diffusion-test"]) == (
            ["audio_transcription"], ["audio_speech"], ["image_generation"])
        speech = [r for r in ours if r[0] == "/v1/audio/speech"][1]
        assert speech[1:3] == (200, "audio/wav") and speech[3][:4] == b"RIFF"
        transcripts = [r for r in ours if r[0] == "/v1/audio/transcriptions"]
        assert transcripts[0][2]["text"] == \
            services["asr"].transcribe_wav_bytes(speech[3])
        images = rec["/v1/images/generations"][2]["data"]
        assert [d["png"][0] for d in images] == [b"\x89PNG\r\n\x1a\n"] * 2
    finally:
        await gw.close()
        await port.close()
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        engine.shutdown()
