"""The port's multimodal routes, over its stdlib HTTP server and behind the
unchanged JAX gateway.

One debug-tiny port engine on the CPU with the reference's small random
ASR, TTS and image services (`from_random`): /v1/models lists each with
its capability, the three routes answer what the reference's answer (a
JSON transcript, an audio/wav body, base64 PNGs), an absent service is a
404 with the reference's message and a bad request a 400 with the
reference's message. The gateway twin of
tests/gateway/test_multimodal_e2e.py registers the port's server and
routes a speech, a transcription and an image request to it by
capability.
"""

import base64
import io
import json
import urllib.error
import urllib.request
import wave

import pytest

from llmlb_tpu_torch.engine import server as port_server
from llmlb_tpu_torch.engine.asr import AsrEngine
from llmlb_tpu_torch.engine.image import ImageEngine
from llmlb_tpu_torch.engine.server import start_server
from llmlb_tpu_torch.engine.service import Engine
from llmlb_tpu_torch.engine.tts import TtsEngine
from tests.support import GatewayHarness


@pytest.fixture(scope="module")
def engine():
    eng = Engine.from_preset("debug-tiny", model_id="tpu-mm", device="cpu",
                             num_slots=2, slot_capacity=64,
                             prefill_buckets=(16, 32), kv_page_size=16)
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def services():
    return {"asr": AsrEngine.from_random(seed=1, model_id="whisper-test",
                                         device="cpu"),
            "tts": TtsEngine.from_random(seed=2, model_id="tts-test",
                                         device="cpu"),
            "image": ImageEngine.from_random(seed=3, model_id="diffusion-test",
                                             sample_steps=2, device="cpu")}


def _serve(engine, **services):
    srv, thread = start_server(engine, **services)
    return srv, thread, "http://%s:%d" % srv.server_address[:2]


def _stop(srv, thread):
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)


def _post(url: str, data: bytes, ctype: str):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _post_json(url: str, body: dict):
    return _post(url, json.dumps(body).encode(), "application/json")


def _multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "port-multimodal-boundary"
    out = b""
    for name, (data, filename) in fields.items():
        disp = f'form-data; name="{name}"'
        if filename:
            disp += f'; filename="{filename}"'
        out += (f"--{boundary}\r\nContent-Disposition: {disp}\r\n"
                "Content-Type: application/octet-stream\r\n\r\n").encode()
        out += data + b"\r\n"
    return (out + f"--{boundary}--\r\n".encode(),
            f"multipart/form-data; boundary={boundary}")


def _message(raw: bytes) -> str:
    return json.loads(raw)["error"]["message"]


def test_routes_404_when_service_absent(engine):
    srv, thread, base = _serve(engine)
    try:
        for path, body, what in (
                ("/v1/audio/speech", {"input": "x"}, "speech"),
                ("/v1/images/generations", {"prompt": "x"}, "image"),
                ("/v1/audio/transcriptions", {}, "transcription")):
            status, _, raw = _post_json(base + path, body)
            assert status == 404
            assert _message(raw) == f"no {what} model is loaded on this engine"
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
            ids = [m["id"] for m in json.loads(r.read())["data"]]
        assert ids == ["tpu-mm"]
    finally:
        _stop(srv, thread)


def test_full_multimodal_server(engine, services):
    srv, thread, base = _serve(engine, **services)
    try:
        with urllib.request.urlopen(base + "/v1/models", timeout=30) as r:
            caps = {m["id"]: m["capabilities"]
                    for m in json.loads(r.read())["data"]}
        assert caps["whisper-test"] == ["audio_transcription"]
        assert caps["tts-test"] == ["audio_speech"]
        assert caps["diffusion-test"] == ["image_generation"]

        status, ctype, wav = _post_json(base + "/v1/audio/speech",
                                        {"input": "hi", "voice": "nova"})
        assert status == 200 and ctype == "audio/wav"
        with wave.open(io.BytesIO(wav), "rb") as wf:
            assert wf.getframerate() == 16000

        data, form = _multipart({"file": (wav, "a.wav"),
                                 "model": (b"whisper-test", None)})
        status, _, raw = _post(base + "/v1/audio/transcriptions", data, form)
        assert status == 200
        text = json.loads(raw)["text"]
        assert text == services["asr"].transcribe_wav_bytes(wav)

        status, _, raw = _post_json(base + "/v1/images/generations",
                                    {"prompt": "a tiny square", "n": 2})
        assert status == 200
        body = json.loads(raw)
        assert isinstance(body["created"], int) and len(body["data"]) == 2
        png = base64.b64decode(body["data"][0]["b64_json"])
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
    finally:
        _stop(srv, thread)


@pytest.mark.parametrize("path,body,message", [
    ("/v1/images/generations", {"n": 1}, "'prompt' is required"),
    ("/v1/images/generations", {"prompt": "x", "n": 11},
     "'n' must be between 1 and 10"),
    ("/v1/images/generations", {"prompt": "x", "n": "2"},
     "'n' must be between 1 and 10"),
    ("/v1/audio/speech", {}, "'input' is required"),
    ("/v1/audio/speech", {"input": ""}, "'input' is required"),
    ("/v1/audio/speech", {"input": "x", "speed": 9},
     "'speed' must be between 0.25 and 4.0"),
    ("/v1/audio/transcriptions", {"file": "x"},
     "multipart/form-data body required"),
])
def test_bad_requests_get_the_reference_400s(engine, services, path, body,
                                             message):
    srv, thread, base = _serve(engine, **services)
    try:
        status, _, raw = _post_json(base + path, body)
        assert status == 400
        assert _message(raw) == message
    finally:
        _stop(srv, thread)


def test_transcription_400s_on_form_faults(engine, services):
    srv, thread, base = _serve(engine, **services)
    try:
        data, form = _multipart({"model": (b"whisper-test", None)})
        status, _, raw = _post(base + "/v1/audio/transcriptions", data, form)
        assert status == 400 and _message(raw) == "'file' part is required"
        data, form = _multipart({"file": (b"not-a-wav", "x.mp3")})
        status, _, raw = _post(base + "/v1/audio/transcriptions", data, form)
        assert status == 400
        assert _message(raw).startswith("could not decode audio: ")
    finally:
        _stop(srv, thread)


def test_server_flags_build_the_services():
    args = port_server.build_parser().parse_args(
        ["--device", "cpu", "--asr", "random", "--tts", "random",
         "--image", "random"])
    built = port_server.services_from(args)
    assert isinstance(built["asr"], AsrEngine)
    assert isinstance(built["tts"], TtsEngine)
    assert isinstance(built["image"], ImageEngine)
    assert all(s.device.type == "cpu" for s in built.values())
    none = port_server.build_parser().parse_args(["--device", "cpu"])
    assert port_server.services_from(none) == {}


async def test_multimodal_capability_routing_through_gateway(engine,
                                                              services):
    """The unchanged gateway syncs the four models with their advertised
    capabilities and routes speech, a multipart transcription and an image
    request to the port; a model no endpoint serves is a 404."""
    import aiohttp

    from llmlb_tpu.gateway.health import EndpointHealthChecker

    srv, thread, engine_url = _serve(engine, **services)
    gw = await GatewayHarness.create()
    gw.state.health_checker = EndpointHealthChecker(
        gw.state.registry, gw.state.load_manager, gw.state.db,
        gw.state.http, gw.state.events, interval_s=3600, timeout_s=5.0)
    try:
        headers = await gw.admin_headers()
        r = await gw.client.post("/api/endpoints", json={
            "base_url": engine_url, "name": "tpu-mm"}, headers=headers)
        assert r.status == 201, await r.text()
        created = await r.json()
        by_id = {m["model_id"]: m for m in created["models"]}
        assert set(by_id) == {"tpu-mm", "whisper-test", "tts-test",
                              "diffusion-test"}
        assert by_id["tts-test"]["capabilities"] == ["audio_speech"]
        iheaders = await gw.inference_headers()

        r = await gw.client.post("/v1/audio/speech", json={
            "model": "tts-test", "input": "route me", "voice": "alloy"},
            headers=iheaders)
        assert r.status == 200, await r.text()
        wav = await r.read()
        assert wav == services["tts"].synthesize("route me", "alloy")

        form = aiohttp.FormData()
        form.add_field("file", wav, filename="x.wav", content_type="audio/wav")
        form.add_field("model", "whisper-test")
        r = await gw.client.post("/v1/audio/transcriptions", data=form,
                                 headers=iheaders)
        assert r.status == 200, await r.text()
        assert (await r.json())["text"] == \
            services["asr"].transcribe_wav_bytes(wav)

        r = await gw.client.post("/v1/images/generations", json={
            "model": "diffusion-test", "prompt": "tiny", "n": 1},
            headers=iheaders)
        assert r.status == 200, await r.text()
        png = base64.b64decode((await r.json())["data"][0]["b64_json"])
        assert png[:8] == b"\x89PNG\r\n\x1a\n"

        r = await gw.client.post("/v1/audio/speech", json={
            "model": "no-such-model", "input": "x"}, headers=iheaders)
        assert r.status == 404
    finally:
        await gw.close()
        _stop(srv, thread)
