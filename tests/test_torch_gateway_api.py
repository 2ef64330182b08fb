"""The port's gateway client API units held against the JAX gateway's.

- /v1/messages conversions (llmlb_tpu_torch/gateway/api_anthropic.py): the
  request (system prompts, content blocks, tool_use and tool_result,
  tools, tool_choice, the carried knobs) and the response (text,
  tool_calls, the stop-reason map) on seeded inputs.
- `AnthropicStreamEncoder` on seeded chunk scripts (text, parallel tool
  calls interleaved by index, usage in the last chunk) frame for frame,
  and across a cut: the primary stream's chunks, then a resumed stream
  that re-emits the whole text through `ChunkSplicer`, give one message
  with the uncut stream's frames.
- The cloud conversions (api_cloud.py) both ways for Anthropic and
  Gemini, and `pick_gguf` (api_models.py).
- The per-endpoint system probes (system_info.py) of each runtime kind
  against one stub runtime: the same answers through both packages.
- multipart/form-data (gateway/http.py): the port's reader reads what
  aiohttp's FormData writes, aiohttp's reader reads what the port's
  FormData writes, and the edge cases (quoted boundary, CRLF and
  delimiter-like bytes inside a file, preamble and epilogue, a body cut
  short, no boundary) end as they end in aiohttp's reader.
"""

import asyncio
import json

import aiohttp
import numpy as np
import pytest
from aiohttp import web as aweb
from aiohttp.test_utils import TestServer

from llmlb_tpu.gateway import api_anthropic as ref_anth
from llmlb_tpu.gateway import api_cloud as ref_cloud
from llmlb_tpu.gateway import api_models as ref_models
from llmlb_tpu.gateway import replay as ref_replay
from llmlb_tpu.gateway import system_info as ref_sysinfo
from llmlb_tpu.gateway import types as ref_types
from llmlb_tpu_torch.gateway import api_anthropic as anth
from llmlb_tpu_torch.gateway import api_cloud as cloud
from llmlb_tpu_torch.gateway import api_models as models
from llmlb_tpu_torch.gateway import http as gh
from llmlb_tpu_torch.gateway import replay
from llmlb_tpu_torch.gateway import system_info as sysinfo
from llmlb_tpu_torch.gateway import types as gtypes
from llmlb_tpu_torch.gateway.http import web

_MASKED = {"id", "created", "message_id"}


def _mask(obj):
    if isinstance(obj, dict):
        return {k: ("*" if k in _MASKED else _mask(v)) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _frames(events: list[bytes]) -> list[list]:
    out = []
    for ev in events:
        head, data = ev.decode().strip().split("\n")
        out.append([head[len("event: "):], json.loads(data[len("data: "):])])
    return out


# ------------------------------------------------------ seeded generators


def _words(rng, n) -> str:
    vocab = ["alpha", "beta", "gamma", " ", "é", "\n", '"q"', "{", "}", "x"]
    return "".join(vocab[int(i)] for i in rng.integers(len(vocab), size=n))


def _anthropic_body(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    body = {"model": "m", "max_tokens": int(rng.integers(1, 64)),
            "messages": []}
    if rng.integers(2):
        body["system"] = (_words(rng, 3) if rng.integers(2) else
                          [{"type": "text", "text": _words(rng, 2)},
                           "junk", {"type": "text", "text": _words(rng, 1)}])
    for turn in range(int(rng.integers(1, 5))):
        role = "user" if turn % 2 == 0 else "assistant"
        if rng.integers(3) == 0:
            body["messages"].append({"role": role, "content": _words(rng, 4)})
            continue
        blocks = []
        for b in range(int(rng.integers(0, 4))):
            kind = int(rng.integers(4))
            if kind == 0:
                blocks.append({"type": "text", "text": _words(rng, 2)})
            elif kind == 1:
                blocks.append({"type": "tool_use", "id": f"tu{seed}{turn}{b}",
                               "name": f"fn{b}",
                               "input": {"k": _words(rng, 1), "n": b}})
            elif kind == 2:
                content = ([{"type": "text", "text": _words(rng, 1)}, 7]
                           if rng.integers(2) else _words(rng, 2))
                blocks.append({"type": "tool_result",
                               "tool_use_id": f"tu{seed}{b}",
                               "content": content})
            else:
                blocks.append("not a block")
        body["messages"].append({"role": role, "content": blocks})
    for key, value in (("temperature", 0.5), ("top_p", 0.9), ("stream", True),
                       ("speculative", {"enabled": True}),
                       ("priority", "high"), ("lora", "ad1"),
                       ("stop_sequences", ["END"])):
        if rng.integers(2):
            body[key] = value
    if rng.integers(2):
        body["tools"] = [{"name": f"fn{i}", "description": "d",
                          "input_schema": {"type": "object"}}
                         for i in range(int(rng.integers(1, 3)))] + ["bad"]
    choice = int(rng.integers(5))
    if choice < 4:
        body["tool_choice"] = [{"type": "auto"}, {"type": "any"},
                               {"type": "tool", "name": "fn0"},
                               {"type": "none"}][choice]
    return body


def _openai_response(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    msg = {"role": "assistant"}
    if rng.integers(3):
        msg["content"] = _words(rng, 5) if rng.integers(4) else ""
    if rng.integers(2):
        msg["tool_calls"] = [
            {"id": f"call{i}", "type": "function", "function": {
                "name": f"fn{i}",
                "arguments": ('{"a": %d}' % i if rng.integers(3) else "{bad")}}
            for i in range(int(rng.integers(1, 3)))]
    finish = ["stop", "length", "tool_calls", "content_filter", "odd",
              None][int(rng.integers(6))]
    resp = {"choices": [{"index": 0, "message": msg,
                         "finish_reason": finish}]}
    if rng.integers(4):
        resp["usage"] = {"prompt_tokens": int(rng.integers(100)),
                         "completion_tokens": int(rng.integers(100))}
    return resp


def _chunk_script(seed: int, max_tools: int = 3) -> list[dict]:
    """OpenAI chunks: a role delta, text, tool-call fragments of up to
    `max_tools` tools interleaved across indexes (ids and names first),
    the finish, then usage alone in the last chunk."""
    rng = np.random.default_rng(seed)
    chunks = [{"id": "c", "object": "chat.completion.chunk", "created": 1,
               "choices": [{"index": 0, "delta": {"role": "assistant",
                                                  "content": ""}}]}]
    n_tools = int(rng.integers(0, max_tools + 1))
    pending = {i: ['{"i": ', str(i), ', "s": "', _words(rng, 2), '"}']
               for i in range(n_tools)}
    opened = set()
    for _ in range(int(rng.integers(2, 12))):
        delta = {}
        if rng.integers(2) or not pending:
            delta["content"] = _words(rng, int(rng.integers(1, 3)))
        else:
            tcs = []
            for i in list(pending):
                if rng.integers(2):
                    tc = {"index": i, "function": {}}
                    if i not in opened:
                        opened.add(i)
                        tc.update(id=f"call_{i}", type="function")
                        tc["function"]["name"] = f"tool{i}"
                    tc["function"]["arguments"] = pending[i].pop(0)
                    if not pending[i]:
                        del pending[i]
                    tcs.append(tc)
            if tcs:
                delta["tool_calls"] = tcs
        chunks.append({"id": "c", "object": "chat.completion.chunk",
                       "created": 1,
                       "choices": [{"index": 0, "delta": delta}]})
    finish = "tool_calls" if opened else ["stop", "length"][int(
        rng.integers(2))]
    chunks.append({"id": "c", "choices": [{"index": 0, "delta": {},
                                           "finish_reason": finish}]})
    if rng.integers(3):
        chunks.append({"id": "c", "choices": [], "usage": {
            "prompt_tokens": 11, "completion_tokens": len(chunks)}})
    return chunks


# ------------------------------------------------------------ conversions


@pytest.mark.parametrize("seed", range(12))
def test_anthropic_request_conversion_matches(seed):
    body = _anthropic_body(seed)
    assert anth.anthropic_request_to_openai(body) == \
        ref_anth.anthropic_request_to_openai(body)


@pytest.mark.parametrize("seed", range(10))
def test_openai_response_to_anthropic_matches(seed):
    resp = _openai_response(seed)
    ours = anth.openai_response_to_anthropic(resp, "m")
    ref = ref_anth.openai_response_to_anthropic(resp, "m")
    assert _mask(ours) == _mask(ref)
    assert ours["id"].startswith("msg_") and len(ours["id"]) == 28


def test_error_event_and_stop_reasons_match():
    assert anth.STOP_REASON_MAP == ref_anth.STOP_REASON_MAP
    for msg, kind in (("stream interrupted: X", "api_error"),
                      ('quote " and é', "overloaded_error")):
        assert anth.anthropic_error_event(msg, kind) == \
            ref_anth.anthropic_error_event(msg, kind)


# ---------------------------------------------------------- stream encoder


def _encode(mod, chunks, estimate=9) -> list[bytes]:
    enc = mod.AnthropicStreamEncoder("m", input_token_estimate=estimate)
    out = []
    for c in chunks:
        out += enc.feed(c)
    return out + enc.finish()


@pytest.mark.parametrize("seed", range(12))
def test_stream_encoder_matches_frame_for_frame(seed):
    chunks = _chunk_script(seed)
    ours, ref = _frames(_encode(anth, chunks)), _frames(_encode(ref_anth,
                                                                chunks))
    assert _mask(ours) == _mask(ref)
    names = [n for n, _ in ours]
    assert names[0] == "message_start" and names[-2:] == ["message_delta",
                                                          "message_stop"]
    assert names.count("message_start") == 1


def _spliced(mod, rmod, chunks, cut: int) -> list[bytes]:
    """_stream_transform's pump over a cut: chunks[:cut] (with replay
    frames) from the first engine, then the adopter's full re-emission
    through the splicer into the same encoder."""
    enc = mod.AnthropicStreamEncoder("m", input_token_estimate=9)
    state = rmod.ReplayState({"model": "m"})
    out = []
    armed = []
    for i, c in enumerate(chunks):
        armed.append({"object": rmod.REPLAY_OBJECT, "tokens": [i]})
        armed.append(c)
    for c in armed[:cut]:
        if state.note_openai_chunk(c):
            out += enc.feed(c)
    splicer = rmod.ChunkSplicer(state)
    state.mark_ledger_stale()
    for c in armed:
        if c.get("object") == rmod.REPLAY_OBJECT:
            state.note_openai_chunk(c)
            continue
        c = splicer.splice(json.loads(json.dumps(c)))
        if c is not None:
            out += enc.feed(c)
    return out + enc.finish()


@pytest.mark.parametrize("seed", range(8))
def test_a_resume_splices_into_the_open_message(seed):
    """Frame for frame as the JAX package across a cut, parallel tool calls
    included; with at most one tool call (the splicer drops the re-sent
    opening of the stream's one tool call, which is what the engines
    stream) the spliced message is the uncut one."""
    for max_tools in (3, 1):
        chunks = _chunk_script(100 + seed, max_tools)
        cut = 2 + 2 * (seed % max(1, len(chunks) - 1))
        ours = _frames(_spliced(anth, replay, chunks, cut))
        ref = _frames(_spliced(ref_anth, ref_replay, chunks, cut))
        assert _mask(ours) == _mask(ref)
    uncut = _frames(_encode(anth, chunks))
    assert _mask(ours) == _mask(uncut)
    assert [n for n, _ in ours].count("message_start") == 1


def test_stream_encoder_event_sequence():
    enc = anth.AnthropicStreamEncoder("m", input_token_estimate=9)
    out = []
    out += enc.feed({
        "choices": [{"delta": {"role": "assistant", "content": "he"}}]})
    out += enc.feed({"choices": [{"delta": {"content": "y"}}]})
    out += enc.feed({
        "choices": [{"delta": {"tool_calls": [{
            "index": 0, "id": "c1",
            "function": {"name": "f", "arguments": ""}}]}}]})
    out += enc.feed({
        "choices": [{"delta": {"tool_calls": [{
            "index": 0, "function": {"arguments": '{"x":1}'}}]},
            "finish_reason": "tool_calls"}]})
    out += enc.feed({
        "choices": [], "usage": {"prompt_tokens": 5, "completion_tokens": 3}})
    out += enc.finish()
    frames = _frames(out)
    events = [n for n, _ in frames]
    assert events[0] == "message_start"
    assert frames[0][1]["message"]["usage"]["input_tokens"] == 9
    first_stop = events.index("content_block_stop")
    assert events.index("content_block_start", first_stop) > first_stop
    assert events[-2:] == ["message_delta", "message_stop"]
    md = [p for n, p in frames if n == "message_delta"][0]
    assert md["usage"] == {"output_tokens": 3, "input_tokens": 5}
    assert md["delta"]["stop_reason"] == "tool_use"


def test_stream_encoder_interleaved_parallel_tool_calls():
    enc = anth.AnthropicStreamEncoder("m")
    out = []
    out += enc.feed({"choices": [{"delta": {"tool_calls": [
        {"index": 0, "id": "a", "function": {"name": "fa", "arguments": '{"a"'}},
    ]}}]})
    out += enc.feed({"choices": [{"delta": {"tool_calls": [
        {"index": 1, "id": "b", "function": {"name": "fb", "arguments": '{"b"'}},
    ]}}]})
    out += enc.feed({"choices": [{"delta": {"tool_calls": [
        {"index": 0, "function": {"arguments": ': 1}'}},
        {"index": 1, "function": {"arguments": ': 2}'}},
    ]}}]})
    out += enc.finish()
    frames = _frames(out)
    names = {p["index"]: p["content_block"]["name"] for n, p in frames
             if n == "content_block_start"}
    args = {}
    for n, p in frames:
        if n == "content_block_delta":
            args.setdefault(p["index"], []).append(p["delta"]["partial_json"])
    assert {names[i]: json.loads("".join(a)) for i, a in args.items()} == \
        {"fa": {"a": 1}, "fb": {"b": 2}}


# ------------------------------------------------------------------ cloud


@pytest.mark.parametrize("seed", range(6))
def test_cloud_conversions_match(seed):
    rng = np.random.default_rng(seed)
    msgs = []
    if rng.integers(2):
        msgs.append({"role": "system", "content": _words(rng, 2)})
    for i in range(int(rng.integers(1, 4))):
        content = (_words(rng, 3) if rng.integers(3) else
                   [{"type": "text", "text": _words(rng, 1)}, "x"])
        msgs.append({"role": ["user", "assistant"][i % 2],
                     "content": content if rng.integers(4) else None})
    body = {"model": "gpt", "messages": msgs}
    for key, value in (("temperature", 0.3), ("top_p", 0.5),
                       ("max_tokens", 17), ("max_completion_tokens", 9),
                       ("stream", True),
                       ("stop", "END" if rng.integers(2) else ["A", "B"])):
        if rng.integers(2):
            body[key] = value
    assert cloud._openai_to_anthropic_request(body, "claude") == \
        ref_cloud._openai_to_anthropic_request(body, "claude")
    assert cloud._openai_to_gemini_request(body) == \
        ref_cloud._openai_to_gemini_request(body)
    anth_resp = {"content": [{"type": "text", "text": _words(rng, 2)},
                             {"type": "tool_use"}, "x"],
                 "stop_reason": ["end_turn", "max_tokens", "stop_sequence",
                                 "odd"][int(rng.integers(4))],
                 "usage": {"input_tokens": 3, "output_tokens": 4}}
    if rng.integers(2):
        anth_resp["id"] = "msg_1"
    assert _mask(cloud._anthropic_to_openai_response(anth_resp, "a:c")) == \
        _mask(ref_cloud._anthropic_to_openai_response(anth_resp, "a:c"))
    gem = {"candidates": [{"content": {"parts": [
        {"text": _words(rng, 2)}, {"text": "!"}]},
        "finishReason": ["STOP", "MAX_TOKENS"][int(rng.integers(2))]}],
        "usageMetadata": {"promptTokenCount": 5, "candidatesTokenCount": 6}}
    if rng.integers(3) == 0:
        gem = {}
    assert _mask(cloud._gemini_to_openai_response(gem, "google:g")) == \
        _mask(ref_cloud._gemini_to_openai_response(gem, "google:g"))


def test_cloud_metrics_render_the_same():
    ours, ref = cloud.CloudMetrics(), ref_cloud.CloudMetrics()
    for provider, status, lat in (("openai", "200", 0.05), ("openai", "502",
                                                            3.0),
                                  ("anthropic", "200", 40.0),
                                  ("google", "error", 0.3)):
        ours.observe(provider, status, lat)
        ref.observe(provider, status, lat)
    assert ours.render_prometheus() == ref.render_prometheus()


@pytest.mark.parametrize("seed", range(6))
def test_pick_gguf_matches(seed):
    rng = np.random.default_rng(seed)
    names = ["model-Q4_K_M.gguf", "model-q8_0.gguf", "model-f16.gguf",
             "README.md", "config.json", "model.safetensors",
             "x-q4_0.GGUF", "tiny-Q2_K.gguf"]
    files = [names[int(i)] for i in rng.permutation(len(names))[
        :int(rng.integers(0, len(names) + 1))]]
    for policy in ("q4", "Q8", "f16", "none"):
        assert models.pick_gguf(files, policy) == \
            ref_models.pick_gguf(files, policy)


# -------------------------------------------------------------- multipart


async def _parts_handler(request):
    """The same handler body for both servers: every part as
    [name, filename, content type, bytes as latin-1], or the error."""
    try:
        reader = await request.multipart()
        out = []
        async for part in reader:
            data = await part.read(decode=False)
            out.append([part.name, part.filename,
                        part.headers.get("Content-Type"),
                        bytes(data).decode("latin-1")])
        return out, 200
    except ValueError as e:
        return {"error": str(e)}, 400


async def _port_server():
    async def handler(request):
        body, status = await _parts_handler(request)
        return web.json_response(body, status=status)

    app = web.Application()
    app.router.add_post("/", handler)
    runner = web.AppRunner(app, shutdown_timeout=1.0)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    return runner, "http://127.0.0.1:%d/" % runner.addresses[0][1]


async def _aiohttp_server():
    async def handler(request):
        body, status = await _parts_handler(request)
        return aweb.json_response(body, status=status)

    app = aweb.Application()
    app.router.add_post("/", handler)
    server = TestServer(app)
    await server.start_server()
    return server, f"http://127.0.0.1:{server.port}/"


FIELDS = [
    ("file", b"RIFF\r\n--not-the-boundary\r\n\r\n\x00\xff", "a.wav",
     "audio/wav"),
    ("model", "whisper-1", None, None),
    ("prompt", "héllo\r\nworld", None, None),
    ("image", bytes(range(256)) * 4, "img.png", "image/png"),
    ("mask", b"", "empty.png", None),
]


def _form(mod):
    form = mod.FormData()
    for name, value, filename, ctype in FIELDS:
        if filename is None:
            form.add_field(name, value)
        else:
            form.add_field(name, value, filename=filename, content_type=ctype)
    return form


def _expected():
    out = []
    for name, value, filename, ctype in FIELDS:
        if filename is None:
            out.append([name, None, "text/plain; charset=utf-8",
                        value.encode().decode("latin-1")])
        else:
            out.append([name, filename, ctype or "application/octet-stream",
                        value.decode("latin-1")])
    return out


EDGE_BODIES = [
    ("quoted boundary", b'--b c\r\nContent-Disposition: form-data; name="a"'
     b'\r\n\r\nval\r\n--b c--\r\n', 'multipart/form-data; boundary="b c"'),
    ("preamble and epilogue", b'preamble\r\n--b\r\nContent-Disposition: '
     b'form-data; name="a"\r\n\r\nval\r\n--b--\r\nepilogue',
     "multipart/form-data; boundary=b"),
    ("cut inside a part", b'--b\r\nContent-Disposition: form-data; '
     b'name="a"\r\n\r\nval', "multipart/form-data; boundary=b"),
    ("no closing delimiter", b'--b\r\nContent-Disposition: form-data; '
     b'name="a"\r\n\r\nval\r\n--b\r\n', "multipart/form-data; boundary=b"),
    ("empty body", b"", "multipart/form-data; boundary=b"),
    ("no delimiter", b"garbage", "multipart/form-data; boundary=b"),
    ("no boundary", b'--b\r\nContent-Disposition: form-data; name="a"\r\n'
     b'\r\nval\r\n--b--\r\n', "multipart/form-data"),
    ("rfc 5987 file name", b"--b\r\nContent-Disposition: form-data; "
     b"name=\"f\"; filename*=utf-8''na%C3%AFve.txt\r\n\r\nx\r\n--b--\r\n",
     "multipart/form-data; boundary=b"),
]


async def test_multipart_both_ways_against_aiohttp():
    runner, port_url = await _port_server()
    server, aio_url = await _aiohttp_server()
    try:
        async with aiohttp.ClientSession() as s:
            r = await s.post(port_url, data=_form(aiohttp))
            assert r.status == 200
            assert await r.json() == _expected()
            results = {}
            for label, body, ctype in EDGE_BODIES:
                got = []
                for url in (aio_url, port_url):
                    r = await s.post(url, data=body,
                                     headers={"Content-Type": ctype})
                    got.append((r.status, await r.json()))
                results[label] = got
        for label, (ref, ours) in results.items():
            assert ours == ref, label
        assert results["cut inside a part"][1][0] == 400
        async with gh.ClientSession() as s:
            r = await s.post(aio_url, data=_form(gh))
            assert r.status == 200
            assert await r.json() == _expected()
            r = await s.post(port_url, data=_form(gh))
            assert await r.json() == _expected()
            # no file, no content type: urlencoded, as aiohttp sends it
            form = gh.FormData()
            form.add_field("a", "1 2")
            form.add_field("b", "é")
            body, ctype = form.encode()
            assert (body, ctype) == (b"a=1+2&b=%C3%A9",
                                     "application/x-www-form-urlencoded")
    finally:
        await runner.cleanup()
        await server.close()


async def test_multipart_body_cut_short_is_a_value_error():
    """A client that declares more bytes than it sends: the reader raises
    ValueError (the media handlers answer 400) instead of waiting."""
    runner, url = await _port_server()
    try:
        host, port = url[len("http://"):-1].split(":")
        reader, writer = await asyncio.open_connection(host, int(port))
        part = (b'--b\r\nContent-Disposition: form-data; name="a"\r\n\r\n'
                b"val\r\n--b--\r\n")
        writer.write(b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: "
                     b"multipart/form-data; boundary=b\r\nContent-Length: "
                     + str(len(part) + 100).encode() + b"\r\n\r\n" + part)
        await writer.drain()
        writer.write_eof()
        head = await asyncio.wait_for(reader.read(), 30)
        writer.close()
        assert head.startswith(b"HTTP/1.1 400")
        assert b"Content-Length bytes" in head
    finally:
        await runner.cleanup()


def test_request_content_type_and_can_read_body_follow_aiohttp():
    class _Conn:
        reader = None
        peer = "127.0.0.1"

    def req(headers):
        return web.Request(web.Application(), "POST", "/", (1, 1),
                           gh.CIMultiDict(headers), _Conn())

    assert req({}).content_type == "application/octet-stream"
    assert req({"Content-Type": "Multipart/Form-Data; boundary=x"}
               ).content_type == "multipart/form-data"
    assert not req({}).can_read_body
    assert req({"Content-Length": "3"}).can_read_body


# ----------------------------------------------------------- system probes


async def _runtime_stub(slots: bool):
    """One stub answering every runtime kind's probe paths."""
    routes = {
        "/api/health": {"status": "ok", "tpu": {"device_kind": "H100",
                                                "chip_count": 1,
                                                "hbm_used_bytes": 5},
                        "engine": {"num_slots": 8, "active_slots": 2},
                        "disagg": {"role": "decode", "handoff_backlog": 1}},
        "/api/version": {"version": "0.5.1"},
        "/api/ps": {"models": [{"name": "llama3:8b", "size_vram": 5},
                               {"name": "cpu-model"}]},
        "/api/system": {"gpu": "stub", "vram": 1},
    }
    if slots:
        routes["/slots"] = [{"id": 0, "n_ctx": 8192, "is_processing": True},
                            {"id": 1, "n_ctx": 4096}]

    async def handler(request):
        if request.path == "/metrics":
            return web.Response(text="llamacpp:kv_cache_tokens 1234\nx 1\n",
                                content_type="text/plain")
        if request.path in routes:
            return web.json_response(routes[request.path])
        return web.json_response({"error": "not found"}, status=404)

    app = web.Application()
    app.router.add_get("/{tail:.*}", handler)
    runner = web.AppRunner(app, shutdown_timeout=1.0)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    return runner, "http://127.0.0.1:%d" % runner.addresses[0][1]


@pytest.mark.parametrize("kind,slots", [
    ("llama_cpp", True), ("llama_cpp", False), ("tpu", False),
    ("ollama", False), ("xllm", False), ("openai_compatible", False)])
async def test_system_probes_match(kind, slots):
    runner, url = await _runtime_stub(slots)
    try:
        ref_ep = ref_types.Endpoint(name="e", base_url=url, api_key="k",
                                    endpoint_type=ref_types.EndpointType(kind))
        ep = gtypes.Endpoint(name="e", base_url=url, api_key="k",
                             endpoint_type=gtypes.EndpointType(kind))
        async with aiohttp.ClientSession() as s:
            ref = await ref_sysinfo.get_endpoint_system_info(ref_ep, s)
        async with gh.ClientSession() as s:
            ours = await sysinfo.get_endpoint_system_info(ep, s)
    finally:
        await runner.cleanup()
    assert ours == ref
    assert (ours is None) == (kind == "openai_compatible")
