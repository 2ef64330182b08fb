"""The port gateway's HTTP layer (llmlb_tpu_torch/gateway/http.py): the part
of aiohttp the gateway uses, on the standard library.

- the router takes the reference's patterns (`{name}`, `{name:regex}`),
  answers 404 / 405 through the middlewares, and serves HEAD for GET;
- keep-alive: several requests on one connection, on both sides; chunked
  request bodies; the body cap; idle connections closed after the
  keep-alive timeout;
- SSE written frame by frame reaches the port's client frame by frame (the
  client holds the first frame before the handler writes the second);
- each client failure raises the class the reference's `except` clauses
  catch (`resilience.RETRYABLE_EXCEPTIONS`, and `asyncio.TimeoutError` for
  the timeouts the proxy books as "timeout");
- `FrameSplitter` splits seeded random chunkings of an SSE stream as the
  reference's does.

Everything runs on 127.0.0.1 ports the OS picks.
"""

import asyncio
import http.client
import json
import random
import socket

import pytest

from llmlb_tpu.gateway.replay import FrameSplitter as RefFrameSplitter
from llmlb_tpu_torch.gateway import http as gh
from llmlb_tpu_torch.gateway.http import web
from llmlb_tpu_torch.gateway.replay import FrameSplitter
from llmlb_tpu_torch.gateway.resilience import RETRYABLE_EXCEPTIONS


async def _serve(app: web.Application) -> tuple[web.AppRunner, str]:
    runner = web.AppRunner(app, shutdown_timeout=1.0)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    return runner, f"http://{host}:{port}"


async def _echo(request):
    return web.json_response({
        "path": request.path, "match": dict(request.match_info),
        "query": dict(request.query), "method": request.method,
    })


def _router_app() -> web.Application:
    app = web.Application()
    r = app.router
    r.add_get("/v1/models", _echo)
    r.add_get("/v1/models/{model_id:.+}", _echo)
    r.add_post("/api/endpoints/{endpoint_id}/sync", _echo)
    r.add_get("/api/endpoints/{endpoint_id}", _echo)
    r.add_delete("/api/api-keys/{key_id}", _echo)
    return app


@pytest.mark.parametrize("method,path,status,match", [
    ("GET", "/v1/models", 200, {}),
    ("GET", "/v1/models/org/name:7b", 200, {"model_id": "org/name:7b"}),
    ("GET", "/v1/models/a%20b", 200, {"model_id": "a b"}),
    ("POST", "/api/endpoints/e1/sync", 200, {"endpoint_id": "e1"}),
    ("GET", "/api/endpoints/e1", 200, {"endpoint_id": "e1"}),
    ("GET", "/api/endpoints/e1/extra", 404, None),
    ("DELETE", "/api/api-keys/k9", 200, {"key_id": "k9"}),
    ("POST", "/v1/models", 405, None),
    ("GET", "/nowhere", 404, None),
    ("HEAD", "/v1/models", 200, None),
])
async def test_router_patterns(method, path, status, match):
    runner, base = await _serve(_router_app())
    try:
        async with gh.ClientSession() as s:
            async with s.request(method, base + path + "?x=1") as r:
                assert r.status == status
                body = await r.read()
                if status == 405:
                    assert "GET" in r.headers["Allow"]
                if match is not None:
                    got = json.loads(body)
                    assert got["match"] == match
                    assert got["query"] == {"x": "1"}
                if method == "HEAD":
                    assert body == b""
    finally:
        await runner.cleanup()


async def test_middlewares_wrap_in_order_and_see_unrouted_paths():
    seen = []

    @web.middleware
    async def outer(request, handler):
        seen.append("outer")
        try:
            return await handler(request)
        except web.HTTPException as e:
            e.headers["X-Seen"] = "outer"
            raise

    @web.middleware
    async def inner(request, handler):
        seen.append("inner")
        if request.path == "/blocked":
            return web.json_response({"error": "no"}, status=401)
        return await handler(request)

    app = web.Application(middlewares=[outer, inner])
    app.router.add_get("/ok", _echo)
    runner, base = await _serve(app)
    try:
        async with gh.ClientSession() as s:
            async with s.get(base + "/ok") as r:
                assert r.status == 200
            async with s.get(base + "/blocked") as r:
                assert r.status == 401 and (await r.json()) == {"error": "no"}
            async with s.get(base + "/missing") as r:
                assert r.status == 404 and r.headers["X-Seen"] == "outer"
                assert await r.text() == "404: Not Found"
        assert seen == ["outer", "inner"] * 3
    finally:
        await runner.cleanup()


async def test_keep_alive_and_chunked_request_bodies():
    """Several requests ride one connection from a stdlib client and from the
    port's pooled client; a chunked request body arrives whole; a body over
    client_max_size is refused with 413."""
    peers = set()

    async def echo_body(request):
        peers.add(request._conn)
        data = await request.read()
        return web.Response(body=data[::-1], content_type="text/plain")

    app = web.Application(client_max_size=1000)
    app.router.add_post("/rev", echo_body)
    runner, base = await _serve(app)
    host, port = base[len("http://"):].split(":")
    try:
        def stdlib_client():
            conn = http.client.HTTPConnection(host, int(port), timeout=10)
            out = []
            for body in (b"abc", b"hello"):
                conn.request("POST", "/rev", body=body)
                out.append(conn.getresponse().read())
            conn.request("POST", "/rev", body=iter([b"chu", b"nked"]),
                         encode_chunked=True,
                         headers={"Transfer-Encoding": "chunked"})
            out.append(conn.getresponse().read())
            conn.request("POST", "/rev", body=b"x" * 2000)
            resp = conn.getresponse()
            out.append((resp.status, resp.read()))
            conn.close()
            return out

        got = await asyncio.to_thread(stdlib_client)
        assert got[:3] == [b"cba", b"olleh", b"dekn" + b"uhc"]
        assert got[3][0] == 413 and b"Maximum request body size" in got[3][1]
        assert len(peers) == 1  # one connection for the first three

        peers.clear()
        conn = gh.TCPConnector(limit_per_host=4, keepalive_timeout=30)
        async with gh.ClientSession(connector=conn) as s:
            for i in range(5):
                r = await s.post(base + "/rev", data=f"n{i}")
                assert await r.read() == f"n{i}"[::-1].encode()
        assert len(peers) == 1
    finally:
        await runner.cleanup()


async def test_idle_connections_close_after_the_keepalive_timeout():
    """A connection that sends no request head within `keepalive_timeout`
    is closed by the server: after a keep-alive response, and when it never
    sends one at all. A connection that keeps asking is served."""
    app = web.Application()
    app.router.add_get("/v1/models", _echo)
    runner = web.AppRunner(app, shutdown_timeout=1.0, keepalive_timeout=0.3)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    host, port = runner.addresses[0][:2]
    request = (f"GET /v1/models HTTP/1.1\r\nHost: {host}\r\n\r\n").encode()
    try:
        reader, writer = await asyncio.open_connection(host, port)
        for _ in range(3):  # each within the timeout: one connection serves
            writer.write(request)
            head = await reader.readuntil(b"\r\n\r\n")
            assert head.startswith(b"HTTP/1.1 200")
            length = int(head.split(b"Content-Length: ")[1].split(b"\r\n")[0])
            await reader.readexactly(length)
            await asyncio.sleep(0.1)
        assert await asyncio.wait_for(reader.read(), 5.0) == b""
        writer.close()

        reader, writer = await asyncio.open_connection(host, port)
        assert await asyncio.wait_for(reader.read(), 5.0) == b""
        writer.close()
        assert not runner._state.connections
    finally:
        await runner.cleanup()


async def test_sse_is_flushed_frame_by_frame():
    """The handler writes frame 2 only once the client holds frame 1, so
    the exchange completes only if each write reaches the wire by itself;
    the client reads the stream back with content.iter_any()."""
    got_first = asyncio.Event()
    frames = [b"data: {\"i\": %d}\n\n" % i for i in range(4)] + [
        b"data: [DONE]\n\n"]

    async def sse(request):
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(frames[0])
        await asyncio.wait_for(got_first.wait(), 10)
        for f in frames[1:]:
            await resp.write(f)
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_post("/sse", sse)
    runner, base = await _serve(app)
    try:
        async with gh.ClientSession() as s:
            r = await s.post(base + "/sse", json={})
            assert r.headers["Content-Type"] == "text/event-stream"
            assert r.headers["Transfer-Encoding"] == "chunked"
            body = b""
            async for chunk in r.content.iter_any():
                body += chunk
                if body == frames[0]:
                    got_first.set()
            r.release()
        assert got_first.is_set() and body == b"".join(frames)
        split = FrameSplitter().push(body)
        assert split == frames
    finally:
        await runner.cleanup()


async def test_a_stream_that_fails_after_its_head_ends_the_connection():
    """A handler that raises mid-stream cannot send a second head: the
    connection closes and the client's read fails with the body error the
    proxy catches; the server goes on serving."""
    async def broken(request):
        resp = web.StreamResponse(headers={
            "Content-Type": "text/event-stream"})
        await resp.prepare(request)
        await resp.write(b"data: {}\n\n")
        raise RuntimeError("mid-stream failure")

    app = web.Application()
    app.router.add_post("/broken", broken)
    app.router.add_get("/ok", _echo)
    runner, base = await _serve(app)
    try:
        async with gh.ClientSession() as s:
            r = await s.post(base + "/broken", json={})
            assert r.status == 200
            with pytest.raises(gh.ClientPayloadError):
                await r.read()
            async with s.get(base + "/ok") as r:
                assert r.status == 200
    finally:
        await runner.cleanup()


async def _stall_server(behaviour: str):
    """A raw asyncio server: 'silent' accepts and never answers, 'head'
    sends a head then stalls, 'close' closes before the head, 'short'
    sends half its Content-Length."""
    async def handle(reader, writer):
        await reader.readuntil(b"\r\n\r\n")
        if behaviour == "close":
            writer.close()
            return
        if behaviour == "head":
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n\r\nab")
            await writer.drain()
        if behaviour == "short":
            writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: 100\r\n\r\nab")
            await writer.drain()
            writer.close()
            return
        await asyncio.sleep(30)
        writer.close()

    server = await asyncio.start_server(handle, "127.0.0.1", 0)
    port = server.sockets[0].getsockname()[1]
    return server, f"http://127.0.0.1:{port}"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("case,expected,is_timeout", [
    ("refused", gh.ClientConnectorError, False),
    ("sock_read", gh.SocketTimeoutError, True),
    ("total", asyncio.TimeoutError, True),
    ("connect_pool", gh.ConnectionTimeoutError, True),
    ("disconnect", gh.ServerDisconnectedError, False),
    ("short_body", gh.ClientPayloadError, False),
])
async def test_client_failures_raise_what_the_proxy_catches(
        case, expected, is_timeout):
    server = None
    held = None
    s = gh.ClientSession(connector=gh.TCPConnector(limit_per_host=1))
    try:
        if case == "refused":
            url = f"http://127.0.0.1:{_free_port()}/x"
            call = s.get(url, timeout=gh.ClientTimeout(total=5))
        elif case == "sock_read":
            server, base = await _stall_server("silent")
            call = s.get(base + "/x", timeout=gh.ClientTimeout(
                total=10, sock_read=0.2))
        elif case == "total":
            server, base = await _stall_server("head")
            r = await s.get(base + "/x", timeout=gh.ClientTimeout(total=0.3))
            call = r.read()
        elif case == "connect_pool":
            server, base = await _stall_server("head")
            held = await s.get(base + "/a")  # holds the host's one slot
            call = s.get(base + "/b", timeout=gh.ClientTimeout(connect=0.2))
        elif case == "disconnect":
            server, base = await _stall_server("close")
            call = s.post(base + "/x", json={})
        else:
            server, base = await _stall_server("short")
            r = await s.get(base + "/x")
            call = r.read()
        with pytest.raises(expected) as info:
            await call
        err = info.value
        assert isinstance(err, RETRYABLE_EXCEPTIONS)
        assert isinstance(err, asyncio.TimeoutError) == is_timeout
    finally:
        if held is not None:
            held.release()
        await s.close()
        if server is not None:
            server.close()


@pytest.mark.parametrize("seed", range(6))
def test_frame_splitter_matches_the_reference(seed):
    rng = random.Random(seed)
    stream = b"".join(
        rng.choice([
            b"data: {\"choices\": [{\"delta\": {\"content\": \"%d\"}}]}\n\n"
            % i,
            b": keep-alive\n\n",
            b"data: {\"object\": \"llmlb.replay\", \"tokens\": [%d]}\n\n" % i,
            b"event: error\ndata: {\"error\": {}}\n\n",
        ]) for i in range(40)) + b"data: [DONE]\n\n" + b"data: {\"tail"
    cuts = sorted(rng.sample(range(1, len(stream)), 25))
    chunks = [stream[a:b] for a, b in zip([0] + cuts, cuts + [len(stream)])]
    ours, ref = FrameSplitter(), RefFrameSplitter()
    got = [ours.push(c) for c in chunks]
    assert got == [ref.push(c) for c in chunks]
    assert b"".join(f for fs in got for f in fs) == stream[:stream.rindex(
        b"\n\n") + 2]


_PIECES = [1, 65536, 100_000, 3, 70_000, 0, 12_345]


def _body(size: int) -> bytes:
    return random.Random(size).randbytes(size)


def _bodies_app() -> web.Application:
    async def fixed(request):
        return web.Response(body=_body(int(request.match_info["n"])),
                            content_type="application/octet-stream")

    async def chunked(request):
        resp = web.StreamResponse()
        await resp.prepare(request)
        for size in _PIECES:
            if size:
                await resp.write(_body(size))
            await asyncio.sleep(0)
        await resp.write_eof()
        return resp

    app = web.Application()
    app.router.add_get("/fixed/{n}", fixed)
    app.router.add_get("/chunked", chunked)
    return app


@pytest.mark.parametrize("path,n", [
    ("/fixed/0", 1024),                # an empty body
    ("/fixed/100", 1024),              # shorter than n
    ("/fixed/12288", 4096),            # an exact multiple of n
    ("/fixed/300007", 1 << 16),        # the update download's chunk size
    ("/chunked", 1 << 16),             # a chunked transfer
    ("/chunked", 1000),
])
async def test_iter_chunked_matches_aiohttp(path, n):
    """`content.iter_chunked(n)` yields the body in chunks of at most n
    bytes, as aiohttp's does on the same served body: the same bytes in
    all, never an empty chunk. How many chunks each client yields follows
    how the bytes arrived, so counts are not compared."""
    import aiohttp

    runner, base = await _serve(_bodies_app())
    want = (b"".join(_body(s) for s in _PIECES) if path == "/chunked"
            else _body(int(path.rsplit("/", 1)[1])))
    try:
        got = {}
        for name, session in (("port", gh.ClientSession),
                              ("aiohttp", aiohttp.ClientSession)):
            async with session() as s:
                async with s.get(base + path) as r:
                    assert r.status == 200
                    assert ("Transfer-Encoding" in r.headers) == (
                        path == "/chunked")
                    chunks = [c async for c in r.content.iter_chunked(n)]
            assert all(0 < len(c) <= n for c in chunks), name
            got[name] = b"".join(chunks)
        assert got["port"] == got["aiohttp"] == want
    finally:
        await runner.cleanup()
