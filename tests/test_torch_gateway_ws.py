"""The port's WebSocket server (gateway/http.py's websocket section), held
against aiohttp's.

One echo handler is served twice, by aiohttp's `web` and by the port's
`http.web`; the same client exchanges go to both and must give the same
messages, close codes and handshake answers:

- aiohttp's own client (an independent implementation of the protocol):
  text frames of 0, 125, 126, 65535, 65536 and 70000 bytes (the 7-, 16-
  and 64-bit lengths), a binary frame (the handler answers it in text),
  ping and pong, a client close and a server close with their codes;
- a raw-socket client of this file: a fragmented message (text, then two
  continuations), a close frame with a code no peer may send (1002
  back), and the handshake's 400s.

Then the port alone: an unmasked client frame is refused with 1002; the
heartbeat pings a silent client and drops it within half a heartbeat, and
keeps a client that answers; and a gateway with a dashboard socket open
stops within its usual time, closing the socket with 1001.
"""

import asyncio
import base64
import hashlib
import os
import struct
import sys
import time

import aiohttp
import pytest
from aiohttp import web as aweb

from llmlb_tpu_torch.gateway import http as ph
from tests.support import ADMIN_PASSWORD
from tests.test_torch_gateway_e2e import _PortGateway

GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setitem(sys.modules, "tiktoken", None)
    monkeypatch.setenv("LLMLB_ADMIN_PASSWORD", ADMIN_PASSWORD)


def _handler(web, msg_type):
    async def echo(request):
        ws = web.WebSocketResponse(heartbeat=float(
            request.query.get("heartbeat", 30)))
        await ws.prepare(request)
        async for msg in ws:
            if msg.type == msg_type.TEXT:
                if msg.data == "close-me":
                    await ws.close(code=4001, message=b"bye")
                    break
                await ws.send_str(msg.data)
            elif msg.type == msg_type.BINARY:
                await ws.send_str(f"binary {msg.data.hex()}")
        return ws

    return echo


async def _serve(web, msg_type):
    app = web.Application()
    app.router.add_get("/ws", _handler(web, msg_type))
    runner = web.AppRunner(app, shutdown_timeout=2.0)
    await runner.setup()
    await web.TCPSite(runner, "127.0.0.1", 0).start()
    return runner, runner.addresses[0][1]


async def _both():
    return {"aiohttp": await _serve(aweb, aiohttp.WSMsgType),
            "port": await _serve(ph.web, ph.WSMsgType)}


# ------------------------------------------------------- a raw client


def _client_frame(opcode: int, payload: bytes, *, fin: bool = True,
                  masked: bool = True) -> bytes:
    b0 = (0x80 if fin else 0) | opcode
    n = len(payload)
    bit = 0x80 if masked else 0
    if n < 126:
        head = bytes([b0, bit | n])
    elif n < 65536:
        head = bytes([b0, bit | 126]) + struct.pack("!H", n)
    else:
        head = bytes([b0, bit | 127]) + struct.pack("!Q", n)
    if not masked:
        return head + payload
    key = os.urandom(4)
    return head + key + bytes(b ^ key[i % 4] for i, b in enumerate(payload))


async def _raw_open(port: int, extra: str = "", key: str | None = None):
    """Open a socket and send a handshake; (reader, writer, status line,
    headers, body of a refusal)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    key = key if key is not None else base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET /ws HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n{extra}\r\n").encode())
    await writer.drain()
    status = (await reader.readline()).decode().strip()
    headers = {}
    while True:
        line = (await reader.readline()).decode().strip()
        if not line:
            break
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    body = b""
    if not status.startswith("HTTP/1.1 101"):
        body = await reader.readexactly(int(headers.get("content-length", 0)))
    return reader, writer, status, headers, body


UPGRADE = "Upgrade: websocket\r\nConnection: Upgrade\r\n"
V13 = "Sec-WebSocket-Version: 13\r\n"


async def _read_frame(reader) -> tuple[int, bool, bytes]:
    b0, b1 = await reader.readexactly(2)
    assert not b1 & 0x80, "a server frame must not be masked"
    n = b1 & 0x7F
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    return b0 & 0x0F, bool(b0 & 0x80), await reader.readexactly(n)


async def _raw_exchanges(port: int) -> list:
    out = []
    # a fragmented text message, then a close with a reserved code
    reader, writer, status, headers, _ = await _raw_open(port, UPGRADE + V13)
    out.append(status)
    writer.write(_client_frame(0x1, b"frag", fin=False)
                 + _client_frame(0x0, b"ment", fin=False)
                 + _client_frame(0x9, b"mid")  # a ping between fragments
                 + _client_frame(0x0, b"ed"))
    await writer.drain()
    out.append(await _read_frame(reader))  # the pong
    out.append(await _read_frame(reader))  # the joined message, echoed
    writer.write(_client_frame(0x8, struct.pack("!H", 1005)))
    await writer.drain()
    out.append(await _read_frame(reader))  # the server's close: 1002
    out.append(await reader.read())  # then EOF
    writer.close()
    # the handshake's refusals
    for extra in ("Connection: Upgrade\r\n" + V13,
                  "Upgrade: websocket\r\n" + V13,
                  UPGRADE + "Sec-WebSocket-Version: 12\r\n"):
        *_, writer, status, headers, body = await _raw_open(port, extra)
        out.append((status, body))
        writer.close()
    *_, writer, status, headers, body = await _raw_open(port, UPGRADE + V13,
                                                       key="abc")
    out.append((status, body))
    writer.close()
    return out


# ------------------------------------------------------- both servers


async def _aiohttp_client_exchanges(port: int) -> list:
    out = []
    url = f"http://127.0.0.1:{port}/ws"
    async with aiohttp.ClientSession() as s:
        async with s.ws_connect(url) as ws:
            for n in (0, 125, 126, 65535, 65536, 70000):
                text = "".join(chr(97 + i % 26) for i in range(n))
                await ws.send_str(text)
                msg = await ws.receive()
                out.append((msg.type, n, msg.data == text))
            await ws.send_bytes(bytes(range(256)))
            msg = await ws.receive()
            want = f"binary {bytes(range(256)).hex()}"
            out.append((msg.type, msg.data == want))
            await ws.close(code=4000)
            out.append(("client close", ws.close_code))
        async with s.ws_connect(url, autoping=False) as ws:
            await ws.ping(b"are you there")
            msg = await ws.receive()
            out.append((msg.type, msg.data))
            await ws.pong(b"unsolicited")  # ignored by the server
            await ws.send_str("after the pong")
            out.append((await ws.receive()).data)
        async with s.ws_connect(url) as ws:
            await ws.send_str("close-me")
            msg = await ws.receive()
            out.append((msg.type, msg.data, msg.extra))
            msg = await ws.receive()
            out.append((msg.type, ws.close_code))
    return out


async def test_port_server_answers_as_aiohttp_does():
    servers = await _both()
    try:
        got = {}
        for name, (_, port) in servers.items():
            got[name] = (await _aiohttp_client_exchanges(port),
                         await _raw_exchanges(port))
        assert got["port"] == got["aiohttp"]
        sizes, raw = got["port"]
        assert [t for t, *_ in sizes[:6]] == [aiohttp.WSMsgType.TEXT] * 6
        assert all(ok for *_, ok in sizes[:7])
        assert sizes[7] == ("client close", 1000)
        assert sizes[8] == (aiohttp.WSMsgType.PONG, b"are you there")
        assert sizes[10][1:] == (4001, "bye")
        assert raw[0].startswith("HTTP/1.1 101")
        assert raw[1] == (0xA, True, b"mid")
        assert raw[2] == (0x1, True, b"fragmented")
        assert raw[3][0] == 0x8 and raw[3][2][:2] == struct.pack("!H", 1002)
        assert [r[0] for r in raw[5:]] == ["HTTP/1.1 400 Bad Request"] * 4
        assert raw[7][1] == b"Unsupported version: 12"
    finally:
        for runner, _ in servers.values():
            await runner.cleanup()


async def test_handshake_accept_and_an_unmasked_frame_refused_with_1002():
    runner, port = await _serve(ph.web, ph.WSMsgType)
    try:
        key = base64.b64encode(b"0123456789abcdef").decode()
        reader, writer, status, headers, _ = await _raw_open(
            port, UPGRADE + V13, key=key)
        assert status == "HTTP/1.1 101 Switching Protocols"
        assert headers["sec-websocket-accept"] == base64.b64encode(
            hashlib.sha1(key.encode() + GUID).digest()).decode()
        assert headers["upgrade"] == "websocket"
        writer.write(_client_frame(0x1, b"hello", masked=False))
        await writer.drain()
        opcode, fin, payload = await _read_frame(reader)
        assert (opcode, struct.unpack("!H", payload[:2])[0]) == (0x8, 1002)
        assert await reader.read() == b""
        writer.close()
    finally:
        await runner.cleanup()


async def test_heartbeat_drops_a_silent_client_and_keeps_one_that_answers():
    runner, port = await _serve(ph.web, ph.WSMsgType)
    url = f"http://127.0.0.1:{port}/ws?heartbeat=0.2"
    try:
        async with aiohttp.ClientSession() as s:
            async with s.ws_connect(url, autoping=False) as ws:
                t0 = time.monotonic()
                msg = await ws.receive()
                assert msg.type == aiohttp.WSMsgType.PING
                msg = await ws.receive()  # no pong: dropped at ~0.3 s
                assert msg.type in (aiohttp.WSMsgType.CLOSED,
                                    aiohttp.WSMsgType.CLOSE,
                                    aiohttp.WSMsgType.ERROR)
                assert time.monotonic() - t0 < 2.0
            async with s.ws_connect(url) as ws:  # autoping answers
                got = []

                async def pump():
                    async for m in ws:
                        got.append(m.data)

                task = asyncio.create_task(pump())
                await asyncio.sleep(1.0)  # five heartbeats
                await ws.send_str("still here")
                for _ in range(100):
                    if got:
                        break
                    await asyncio.sleep(0.01)
                assert got == ["still here"]
                await ws.close()
                await task
    finally:
        await runner.cleanup()


async def test_gateway_with_an_open_socket_stops_in_its_usual_time():
    port = await _PortGateway.create()
    async with aiohttp.ClientSession() as s:
        r = await s.post(port.url + "/api/auth/login", json={
            "username": "admin", "password": ADMIN_PASSWORD})
        token = (await r.json())["token"]
        ws = await s.ws_connect(port.url + "/ws/dashboard",
                                headers={"Authorization": f"Bearer {token}"})
        t0 = time.monotonic()
        closing = asyncio.create_task(port.close())
        msg = await ws.receive()
        await closing
        elapsed = time.monotonic() - t0
        assert (msg.type, msg.data) == (aiohttp.WSMsgType.CLOSE, 1001)
        assert msg.extra == "server shutdown"
        assert elapsed < 2.5, elapsed
        await ws.close()
