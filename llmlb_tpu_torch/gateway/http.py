"""The part of aiohttp the gateway uses, on asyncio streams.

The reference gateway is written against aiohttp (`web` for the server,
`ClientSession` for the upstream calls). The port's gateway depends on
nothing beyond the standard library, so it keeps the reference's call sites
and gets the subset they use from here:

- server: `Application`, a router that takes aiohttp's patterns (`{name}`,
  `{name:regex}`), new-style middlewares (the first listed is the
  outermost), `Request` (`json()`, `read()`, `headers`, `query`,
  `match_info`, `remote`, `cookies`, per-request storage), `Response`,
  `json_response`, `StreamResponse` (`prepare`, `write`, `write_eof`, each
  write flushed as one chunk), `FileResponse`, `HTTPException` and its
  4xx subclasses, `AppRunner` and `TCPSite`. HTTP/1.1 with keep-alive;
  request bodies by `Content-Length` or chunked, read when the handler
  asks for them; `Request.multipart()` reads a multipart/form-data body
  part by part (see the multipart section); `WebSocketResponse` takes the
  connection over after a 101 (see the websocket section), and
  `AppRunner.cleanup` closes open sockets with 1001.
- client: `ClientSession` over a pool of keep-alive connections
  (`TCPConnector`), `ClientTimeout` (total, connect / sock_connect,
  sock_read), and a response whose `content.iter_any()` yields the body as
  it arrives (`Content-Length`, chunked, or until the server closes), and
  `content.iter_chunked(n)` the same in chunks of at most n bytes.
  `data=FormData(...)` sends a form, multipart when it carries a file.
- errors under aiohttp's names and bases, so that `except
  (http.ClientError, asyncio.TimeoutError, OSError)` catches what it
  catches in the reference: a refused connect is a `ClientConnectorError`
  (also an `OSError`), a connect or read timeout a `ServerTimeoutError`
  (also an `asyncio.TimeoutError`), the total timeout an
  `asyncio.TimeoutError`, a server gone before its answer a
  `ServerDisconnectedError`, a body cut short a `ClientPayloadError`.

`web` is this module itself, so `from ...gateway.http import web` followed
by `web.json_response` reads as it does in the reference.
"""

from __future__ import annotations

import asyncio
import base64
import collections.abc
import enum
import hashlib
import http as _stdhttp
import http.cookies
import json as _json
import logging
import mimetypes
import os
import re
import socket
import ssl as _ssl
import struct
import sys
import time
import typing
import urllib.parse
from email.utils import formatdate

log = logging.getLogger("llmlb_tpu_torch.gateway.http")

SERVER_NAME = f"Python/{sys.version_info[0]}.{sys.version_info[1]} llmlb_tpu_torch"
_MAX_LINE = 65536
_MAX_HEADERS = 256
_READ_SIZE = 65536


# ------------------------------------------------------------------ headers


class CIMultiDict(collections.abc.MutableMapping):
    """Ordered multi-valued mapping; keys compare case-insensitively
    (`case_sensitive=True` makes it the query string's MultiDict)."""

    def __init__(self, data=None, *, case_sensitive: bool = False):
        self._cs = case_sensitive
        self._items: list[tuple[str, str]] = []
        if data:
            self.update(data)

    def _k(self, key: str) -> str:
        return key if self._cs else key.lower()

    def __getitem__(self, key):
        k = self._k(key)
        for name, value in self._items:
            if self._k(name) == k:
                return value
        raise KeyError(key)

    def __setitem__(self, key, value) -> None:
        k = self._k(key)
        out, placed = [], False
        for name, v in self._items:
            if self._k(name) == k:
                if not placed:
                    out.append((key, str(value)))
                    placed = True
            else:
                out.append((name, v))
        if not placed:
            out.append((key, str(value)))
        self._items = out

    def __delitem__(self, key) -> None:
        k = self._k(key)
        kept = [(n, v) for n, v in self._items if self._k(n) != k]
        if len(kept) == len(self._items):
            raise KeyError(key)
        self._items = kept

    def __iter__(self):
        seen = set()
        for name, _ in self._items:
            if self._k(name) not in seen:
                seen.add(self._k(name))
                yield name

    def __len__(self) -> int:
        return len({self._k(n) for n, _ in self._items})

    def __contains__(self, key) -> bool:
        k = self._k(key)
        return any(self._k(n) == k for n, _ in self._items)

    def add(self, key: str, value) -> None:
        self._items.append((key, str(value)))

    def multi_items(self) -> list[tuple[str, str]]:
        return list(self._items)

    def copy(self) -> "CIMultiDict":
        new = CIMultiDict(case_sensitive=self._cs)
        new._items = list(self._items)
        return new

    def __repr__(self) -> str:
        return f"<CIMultiDict {self._items!r}>"


def MultiDict(data=None) -> CIMultiDict:  # noqa: N802  (aiohttp's name)
    return CIMultiDict(data, case_sensitive=True)


# ------------------------------------------------------------------- errors


class ClientError(Exception):
    """Base of every client-side failure (aiohttp.ClientError)."""


class ClientConnectionError(ClientError):
    pass


class ClientOSError(ClientConnectionError, OSError):
    pass


class ClientConnectorError(ClientOSError):
    """The connection could not be opened (refused, unreachable, DNS)."""


class ServerConnectionError(ClientConnectionError):
    pass


class ServerDisconnectedError(ServerConnectionError):
    """The server closed the connection before its response head."""

    def __init__(self, message: str = "Server disconnected"):
        super().__init__(message)


class ServerTimeoutError(ServerConnectionError, asyncio.TimeoutError):
    pass


class ConnectionTimeoutError(ServerTimeoutError):
    """`ClientTimeout.connect` / `sock_connect` passed."""


class SocketTimeoutError(ServerTimeoutError):
    """`ClientTimeout.sock_read` passed between two reads."""


class ClientPayloadError(ClientError):
    """The response body ended before its declared end, or is malformed."""


class ClientResponseError(ClientError):
    def __init__(self, status: int, message: str = ""):
        super().__init__(f"{status}, message={message!r}")
        self.status = status
        self.message = message


class HTTPException(Exception):
    """Raised by a handler (or the router) to answer with its status: the
    body is `"<status>: <reason>"` as text unless `text` is given."""

    status_code = 500

    def __init__(self, *, headers=None, reason: str | None = None,
                 text: str | None = None, content_type: str | None = None):
        self.reason = reason or _reason(self.status_code)
        self.text = text if text is not None else f"{self.status_code}: {self.reason}"
        super().__init__(self.text)
        self.headers = CIMultiDict(headers)
        self.content_type = content_type or "text/plain"

    @property
    def status(self) -> int:
        return self.status_code


class HTTPBadRequest(HTTPException):
    status_code = 400


class HTTPUnauthorized(HTTPException):
    status_code = 401


class HTTPForbidden(HTTPException):
    status_code = 403


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, method: str, allowed_methods, **kw):
        super().__init__(**kw)
        self.method = method
        self.allowed_methods = set(allowed_methods)
        self.headers["Allow"] = ",".join(sorted(self.allowed_methods))


class HTTPRequestEntityTooLarge(HTTPException):
    status_code = 413

    def __init__(self, max_size: int, actual_size: int, **kw):
        kw.setdefault("text", f"Maximum request body size {max_size} "
                      f"exceeded, actual body size {actual_size}")
        super().__init__(**kw)


def _reason(status: int) -> str:
    try:
        return _stdhttp.HTTPStatus(status).phrase
    except ValueError:
        return ""


# --------------------------------------------------------- shared framing


async def _read_line(reader: asyncio.StreamReader) -> bytes:
    try:
        line = await reader.readuntil(b"\n")
    except asyncio.IncompleteReadError as e:
        return e.partial
    except asyncio.LimitOverrunError:
        raise ValueError("header line too long")
    return line


async def _read_head(reader: asyncio.StreamReader) -> tuple[bytes, CIMultiDict] | None:
    """Start line and headers; None on a clean EOF before any byte."""
    first = await _read_line(reader)
    if not first:
        return None
    if not first.endswith(b"\n"):
        raise ValueError("truncated start line")
    headers = CIMultiDict()
    for _ in range(_MAX_HEADERS):
        line = await _read_line(reader)
        if not line.endswith(b"\n"):
            raise ValueError("truncated headers")
        line = line.rstrip(b"\r\n")
        if not line:
            return first.rstrip(b"\r\n"), headers
        name, sep, value = line.partition(b":")
        if not sep:
            raise ValueError(f"malformed header line {line[:80]!r}")
        headers.add(name.strip().decode("latin-1"),
                    value.strip().decode("latin-1"))
    raise ValueError("too many headers")


class _BodyReader:
    """Reads one message body off a connection: `Content-Length`, chunked,
    or up to EOF (`length=None, chunked=False`). `read_some` returns the
    bytes available now (b"" at the body's end) and raises `EOFError` when
    the connection ends before the body does."""

    def __init__(self, reader: asyncio.StreamReader, *, length: int | None,
                 chunked: bool):
        self._r = reader
        self._left = length
        self._chunked = chunked
        self._chunk_left = 0
        self.done = (length == 0) and not chunked

    async def read_some(self) -> bytes:
        if self.done:
            return b""
        r = self._r
        if self._chunked:
            if self._chunk_left == 0:
                size_line = await _read_line(r)
                if not size_line.endswith(b"\n"):
                    raise EOFError("connection closed inside a chunked body")
                try:
                    size = int(size_line.split(b";", 1)[0].strip(), 16)
                except ValueError:
                    raise ValueError(f"bad chunk size {size_line[:40]!r}")
                if size == 0:
                    while True:  # trailers, then the blank line
                        line = await _read_line(r)
                        if not line.endswith(b"\n"):
                            raise EOFError("connection closed in trailers")
                        if line in (b"\r\n", b"\n"):
                            break
                    self.done = True
                    return b""
                self._chunk_left = size
            data = await r.read(min(self._chunk_left, _READ_SIZE))
            if not data:
                raise EOFError("connection closed inside a chunk")
            self._chunk_left -= len(data)
            if self._chunk_left == 0:
                crlf = await _read_line(r)
                if not crlf.endswith(b"\n"):
                    raise EOFError("connection closed after a chunk")
            return data
        if self._left is None:
            data = await r.read(_READ_SIZE)
            if not data:
                self.done = True
            return data
        data = await r.read(min(self._left, _READ_SIZE))
        if not data:
            raise EOFError("connection closed before Content-Length bytes")
        self._left -= len(data)
        if self._left == 0:
            self.done = True
        return data


def _body_mode(headers: CIMultiDict) -> tuple[int | None, bool]:
    if "chunked" in headers.get("Transfer-Encoding", "").lower():
        return None, True
    cl = headers.get("Content-Length")
    if cl is not None:
        try:
            n = int(cl)
        except ValueError:
            raise ValueError(f"bad Content-Length {cl!r}")
        if n < 0:
            raise ValueError("negative Content-Length")
        return n, False
    return None, False


def _encode_head(start: str, headers: CIMultiDict) -> bytes:
    lines = [start] + [f"{k}: {v}" for k, v in headers.multi_items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


# ------------------------------------------------------------------- server


def middleware(fn):
    """aiohttp's marker for new-style `(request, handler)` middlewares."""
    fn.__middleware_version__ = 1
    return fn


class _Resource:
    def __init__(self, pattern: str):
        self.canonical = pattern
        parts = []
        i = 0
        regex = ""
        while i < len(pattern):
            if pattern[i] == "{":
                depth, j = 1, i + 1
                while j < len(pattern) and depth:
                    depth += {"{": 1, "}": -1}.get(pattern[j], 0)
                    j += 1
                spec = pattern[i + 1:j - 1]
                name, _, rx = spec.partition(":")
                regex += f"(?P<{name}>{rx or '[^{}/]+'})"
                parts.append(name)
                i = j
            else:
                regex += re.escape(pattern[i])
                i += 1
        self._re = re.compile(f"^{regex}$")
        self.names = parts
        self.routes: dict[str, object] = {}

    def match(self, path: str) -> dict | None:
        m = self._re.match(path)
        return m.groupdict() if m else None


class _Route:
    def __init__(self, method: str, handler, resource: _Resource | None):
        self.method = method
        self.handler = handler
        self.resource = resource


class MatchInfo(dict):
    def __init__(self, values: dict, route: _Route):
        super().__init__(values)
        self.route = route

    @property
    def handler(self):
        return self.route.handler


class UrlDispatcher:
    def __init__(self):
        self._resources: list[_Resource] = []
        self._by_pattern: dict[str, _Resource] = {}

    def add_route(self, method: str, path: str, handler):
        res = self._by_pattern.get(path)
        if res is None:
            res = _Resource(path)
            self._by_pattern[path] = res
            self._resources.append(res)
        method = method.upper()
        if method in res.routes:
            raise RuntimeError(f"route {method} {path} added twice")
        route = _Route(method, handler, res)
        res.routes[method] = route
        return route

    def add_get(self, path: str, handler, *, allow_head: bool = True):
        if allow_head:
            self.add_route("HEAD", path, handler)
        return self.add_route("GET", path, handler)

    def add_post(self, path: str, handler):
        return self.add_route("POST", path, handler)

    def add_put(self, path: str, handler):
        return self.add_route("PUT", path, handler)

    def add_patch(self, path: str, handler):
        return self.add_route("PATCH", path, handler)

    def add_delete(self, path: str, handler):
        return self.add_route("DELETE", path, handler)

    def resolve(self, method: str, path: str) -> MatchInfo:
        allowed: set[str] = set()
        for res in self._resources:
            values = res.match(path)
            if values is None:
                continue
            route = res.routes.get(method)
            if route is not None:
                return MatchInfo(values, route)
            allowed.update(res.routes)
        if allowed:
            async def not_allowed(request):
                raise HTTPMethodNotAllowed(method, allowed)

            return MatchInfo({}, _Route(method, not_allowed, None))

        async def not_found(request):
            raise HTTPNotFound()

        return MatchInfo({}, _Route(method, not_found, None))


class Application(collections.abc.MutableMapping):
    def __init__(self, *, middlewares=(), client_max_size: int = 1024 ** 2):
        self.router = UrlDispatcher()
        self.middlewares = list(middlewares)
        self._client_max_size = client_max_size
        self._state: dict = {}
        self.on_startup: list = []
        self.on_shutdown: list = []
        self.on_cleanup: list = []

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value) -> None:
        self._state[key] = value

    def __delitem__(self, key) -> None:
        del self._state[key]

    def __iter__(self):
        return iter(self._state)

    def __len__(self) -> int:
        return len(self._state)

    def _handler_for(self, match: MatchInfo):
        handler = match.route.handler
        for mw in reversed(self.middlewares):
            handler = _bind(mw, handler)
        return handler


def _bind(mw, inner):
    async def call(request):
        return await mw(request, inner)

    return call


class Request(collections.abc.MutableMapping):
    """One request on a connection. The body is read on the first `read()`
    (or `json()` / `text()`), capped at the application's client_max_size."""

    def __init__(self, app: Application, method: str, target: str,
                 version: tuple[int, int], headers: CIMultiDict,
                 conn: "_ServerConnection"):
        self.app = app
        self.method = method
        self.version = version
        self.headers = headers
        split = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(split.path or "/")
        self.query = MultiDict(urllib.parse.parse_qsl(split.query,
                                                      keep_blank_values=True))
        self.match_info: MatchInfo = MatchInfo({}, _Route(method, None, None))
        self._conn = conn
        self._store: dict = {}
        self._body: bytes | None = None
        length, chunked = _body_mode(headers)
        self._body_reader = _BodyReader(conn.reader, length=length or 0,
                                        chunked=chunked)
        self.body_exists = chunked or bool(length)
        self._continue_pending = (
            headers.get("Expect", "").lower() == "100-continue")
        self._cookies: dict | None = None

    # per-request storage, as aiohttp's Request is a MutableMapping
    def __getitem__(self, key):
        return self._store[key]

    def __setitem__(self, key, value) -> None:
        self._store[key] = value

    def __delitem__(self, key) -> None:
        del self._store[key]

    def __iter__(self):
        return iter(self._store)

    def __len__(self) -> int:
        return len(self._store)

    @property
    def remote(self) -> str | None:
        return self._conn.peer

    @property
    def host(self) -> str:
        return self.headers.get("Host") or socket.getfqdn()

    @property
    def scheme(self) -> str:
        return "http"

    @property
    def cookies(self) -> dict:
        if self._cookies is None:
            jar = http.cookies.SimpleCookie()
            try:
                jar.load(self.headers.get("Cookie", ""))
            except http.cookies.CookieError:
                jar = http.cookies.SimpleCookie()
            self._cookies = {k: m.value for k, m in jar.items()}
        return self._cookies

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("Connection", "").lower()
        if self.version >= (1, 1):
            return "close" not in conn
        return "keep-alive" in conn

    @property
    def content_type(self) -> str:
        """The body's media type, lower case and without parameters
        (aiohttp's default when the header is absent)."""
        raw = self.headers.get("Content-Type")
        if not raw:
            return "application/octet-stream"
        return raw.split(";", 1)[0].strip().lower()

    @property
    def can_read_body(self) -> bool:
        return self._body is None and self.body_exists

    async def multipart(self) -> "MultipartReader":
        return MultipartReader(self)

    async def read(self) -> bytes:
        return await self._read_body(self.app._client_max_size)

    async def _read_body(self, cap: int | None) -> bytes:
        if self._body is not None:
            return self._body
        if self._continue_pending:
            self._continue_pending = False
            self._conn.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        parts, size = [], 0
        try:
            while True:
                data = await self._body_reader.read_some()
                if not data:
                    break
                size += len(data)
                if cap and size > cap:
                    self._conn.broken = True
                    raise HTTPRequestEntityTooLarge(cap, size)
                parts.append(data)
        except (EOFError, ValueError) as e:
            self._conn.broken = True
            raise HTTPBadRequest(text=f"400: {e}")
        self._body = b"".join(parts)
        return self._body

    async def text(self) -> str:
        return (await self.read()).decode("utf-8")

    async def json(self, *, loads=_json.loads):
        body = await self.text()
        return loads(body)

    async def _drain(self) -> None:
        """Consume an unread body so the connection can take the next
        request (or mark it unusable)."""
        if self._body is None and self.body_exists:
            try:
                await asyncio.wait_for(self.read(), 30.0)
            except Exception:
                self._conn.broken = True


class StreamResponse:
    def __init__(self, *, status: int = 200, reason: str | None = None,
                 headers=None):
        self.status = status
        self.reason = reason
        self.headers = CIMultiDict(headers)
        self._cookies: list[str] = []
        self._prepared = False
        self._eof = False
        self._chunked = False
        self._writer: asyncio.StreamWriter | None = None
        self._request: Request | None = None
        self.force_close_connection = False
        self._length_check: int | None = None

    @property
    def prepared(self) -> bool:
        return self._prepared

    def force_close(self) -> None:
        self.force_close_connection = True

    def set_cookie(self, name: str, value: str, *, path: str = "/",
                   max_age=None, expires=None, domain=None,
                   secure: bool | None = None, httponly: bool | None = None,
                   samesite: str | None = None) -> None:
        parts = [f"{name}={value}"]
        if domain:
            parts.append(f"Domain={domain}")
        if expires:
            parts.append(f"expires={expires}")
        if max_age is not None:
            parts.append(f"Max-Age={max_age}")
        if path:
            parts.append(f"Path={path}")
        if samesite:
            parts.append(f"SameSite={samesite}")
        if secure:
            parts.append("Secure")
        if httponly:
            parts.append("HttpOnly")
        self._cookies.append("; ".join(parts))

    def del_cookie(self, name: str, *, path: str = "/", domain=None) -> None:
        self.set_cookie(name, '""', path=path, domain=domain, max_age=0,
                        expires="Thu, 01 Jan 1970 00:00:00 GMT")

    def _head_bytes(self, request: Request) -> bytes:
        h = self.headers
        if "Content-Type" not in h:
            h["Content-Type"] = "application/octet-stream"
        for c in self._cookies:
            h.add("Set-Cookie", c)
        h.setdefault("Date", formatdate(usegmt=True))
        h.setdefault("Server", SERVER_NAME)
        if "Content-Length" not in h and request.method != "HEAD" \
                and self.status not in (204, 304):
            if request.version >= (1, 1):
                h["Transfer-Encoding"] = "chunked"
                self._chunked = True
            else:
                self.force_close_connection = True
        if self.force_close_connection or not request.keep_alive:
            h["Connection"] = "close"
        elif request.version < (1, 1):
            h["Connection"] = "keep-alive"
        reason = self.reason if self.reason is not None else _reason(self.status)
        v = f"HTTP/{request.version[0]}.{request.version[1]}"
        return _encode_head(f"{v} {self.status} {reason}", h)

    async def prepare(self, request: Request) -> "StreamResponse":
        if self._prepared:
            return self
        self._request = request
        self._writer = request._conn.writer
        head = self._head_bytes(request)
        self._prepared = True
        request._conn.head_sent = True
        self._write_raw(head)
        await self._drain()
        return self

    def _write_raw(self, data: bytes) -> None:
        w = self._writer
        if w is None or w.transport.is_closing():
            raise ConnectionResetError("Cannot write to closing transport")
        w.write(data)

    async def _drain(self) -> None:
        try:
            await self._writer.drain()
        except (ConnectionError, RuntimeError) as e:
            raise ConnectionResetError(str(e) or "client disconnected")

    async def write(self, data: bytes) -> None:
        if not self._prepared:
            raise RuntimeError("write() before prepare()")
        if self._eof:
            raise RuntimeError("write() after write_eof()")
        if not data or (self._request is not None
                        and self._request.method == "HEAD"):
            return
        if self._chunked:
            self._write_raw(b"%x\r\n" % len(data) + bytes(data) + b"\r\n")
        else:
            self._write_raw(bytes(data))
        await self._drain()

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        if data:
            await self.write(data)
        self._eof = True
        if self._chunked:
            self._write_raw(b"0\r\n\r\n")
            await self._drain()


class Response(StreamResponse):
    def __init__(self, *, body=None, status: int = 200,
                 reason: str | None = None, text: str | None = None,
                 headers=None, content_type: str | None = None,
                 charset: str | None = None):
        super().__init__(status=status, reason=reason, headers=headers)
        if text is not None:
            if body is not None:
                raise ValueError("body and text are exclusive")
            charset = charset or "utf-8"
            body = text.encode(charset)
            content_type = content_type or "text/plain"
        self.text = text
        if body is None:
            body = b""
        elif isinstance(body, str):
            body = body.encode(charset or "utf-8")
        self.body = bytes(body)
        if content_type is not None:
            self.headers["Content-Type"] = (
                f"{content_type}; charset={charset}" if charset
                else content_type)
        elif text is None and "Content-Type" not in self.headers and body:
            self.headers["Content-Type"] = "application/octet-stream"
        self.charset = charset

    async def prepare(self, request: Request) -> "Response":
        if self._prepared:
            return self
        if self.status in (204, 304):
            self.headers.pop("Content-Length", None)
        else:
            self.headers["Content-Length"] = str(len(self.body))
        await super().prepare(request)
        if request.method != "HEAD" and self.body:
            self._write_raw(self.body)
            await self._drain()
        self._eof = True
        return self

    async def write_eof(self, data: bytes = b"") -> None:
        self._eof = True


def json_response(data=None, *, text: str | None = None, body=None,
                  status: int = 200, reason: str | None = None,
                  headers=None, content_type: str = "application/json",
                  dumps=_json.dumps) -> Response:
    if data is not None:
        if text or body:
            raise ValueError("only one of data, text, or body may be given")
        text = dumps(data)
    if text is None and body is None:
        text = dumps(None)
    return Response(text=text, body=body, status=status, reason=reason,
                    headers=headers, content_type=content_type,
                    charset="utf-8" if text is not None else None)


class FileResponse(Response):
    """aiohttp's FileResponse for small files: the file is read whole when
    the response is prepared, its content type guessed from its name as
    aiohttp guesses it (a fresh `mimetypes.MimeTypes()`, not the system's
    tables), and a missing file answers 404 with no body."""

    _types: "mimetypes.MimeTypes | None" = None

    def __init__(self, path, *, status: int = 200,
                 reason: str | None = None, headers=None):
        super().__init__(status=status, reason=reason, headers=headers)
        self._path = os.fspath(path)

    async def prepare(self, request: Request) -> "FileResponse":
        if self._prepared:
            return self
        try:
            with open(self._path, "rb") as f:
                self.body = f.read()
            mtime = os.stat(self._path).st_mtime
        except (FileNotFoundError, IsADirectoryError, NotADirectoryError):
            self.status, self.body = 404, b""
            return await super().prepare(request)
        if FileResponse._types is None:
            FileResponse._types = mimetypes.MimeTypes()
        if "Content-Type" not in self.headers:
            self.headers["Content-Type"] = (
                FileResponse._types.guess_type(self._path)[0]
                or "application/octet-stream")
        self.headers["Last-Modified"] = formatdate(mtime, usegmt=True)
        self.headers["Accept-Ranges"] = "bytes"
        return await super().prepare(request)


class _ServerConnection:
    def __init__(self, reader, writer):
        self.reader = reader
        self.writer = writer
        peer = writer.get_extra_info("peername")
        self.peer = peer[0] if isinstance(peer, tuple) else None
        self.broken = False
        self.head_sent = False  # the current response's head is written
        self.server: "_ServerState | None" = None
        self.task: asyncio.Task | None = None
        # set once a handler upgrades the connection (WebSocketResponse):
        # no more HTTP is read on it
        self.ws: "WebSocketResponse | None" = None


def _error_response(status: int, text: str | None = None) -> Response:
    reason = _reason(status)
    return Response(text=text or f"{status}: {reason}", status=status)


class _ServerState:
    def __init__(self, app: Application, shutdown_timeout: float,
                 keepalive_timeout: float):
        self.app = app
        self.shutdown_timeout = shutdown_timeout
        self.keepalive_timeout = keepalive_timeout
        self.connections: set[asyncio.Task] = set()
        self.idle: set[asyncio.StreamWriter] = set()
        self.sockets: set[_ServerConnection] = set()  # upgraded to WebSocket
        self.closing = False

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self.connections.add(task)
        conn = _ServerConnection(reader, writer)
        conn.server, conn.task = self, task
        try:
            await self._serve(conn)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self.connections.discard(task)
            self.idle.discard(writer)
            self.sockets.discard(conn)
            try:
                writer.close()
            except Exception:  # allow-silent: closing a dead socket
                pass

    async def _serve(self, conn: _ServerConnection) -> None:
        while True:
            self.idle.add(conn.writer)
            try:
                # aiohttp's keepalive_timeout: an idle connection closes
                # when no request head arrives within it (aiohttp times only
                # the wait between requests; here a fresh one counts too)
                head = await asyncio.wait_for(_read_head(conn.reader),
                                              self.keepalive_timeout)
            except asyncio.TimeoutError:
                return
            except ValueError:
                await self._send_plain(conn, _error_response(400))
                return
            finally:
                self.idle.discard(conn.writer)
            if head is None:
                return
            start, headers = head
            try:
                method, target, proto = start.decode("latin-1").split(" ", 2)
                major, minor = proto.split("/", 1)[1].split(".")
                version = (int(major), int(minor))
            except ValueError:
                await self._send_plain(conn, _error_response(400))
                return
            try:
                request = Request(self.app, method.upper(), target, version,
                                  headers, conn)
            except ValueError as e:
                await self._send_plain(conn, _error_response(400, str(e)))
                return
            resp = await self._dispatch(request)
            if resp is None or conn.ws is not None:
                return
            keep = (request.keep_alive and not resp.force_close_connection
                    and not conn.broken)
            if keep:
                await request._drain()
            if not keep or conn.broken or self.closing:
                return

    async def _dispatch(self, request: Request) -> StreamResponse | None:
        app = self.app
        match = app.router.resolve(request.method, request.path)
        request.match_info = match
        handler = app._handler_for(match)
        request._conn.head_sent = False
        try:
            resp = await handler(request)
        except HTTPException as e:
            if request._conn.head_sent:
                return None
            resp = Response(text=e.text, status=e.status, reason=e.reason,
                            headers=e.headers, content_type=e.content_type)
        except (ConnectionError, asyncio.CancelledError):
            return None
        except Exception:
            log.exception("error handling %s %s", request.method,
                          request.path)
            if request._conn.head_sent:
                # a streamed response failed after its head went out: no
                # second head can follow, so the connection closes and the
                # client sees the body end early, as with aiohttp
                return None
            resp = _error_response(500, "500 Internal Server Error\n\n"
                                   "Server got itself in trouble")
        if not isinstance(resp, StreamResponse):
            log.error("handler for %s returned %r, not a response",
                      request.path, type(resp).__name__)
            resp = _error_response(500)
        try:
            if not resp.prepared:
                await resp.prepare(request)
            await resp.write_eof()
        except (ConnectionError, RuntimeError):
            return None
        return resp

    async def _send_plain(self, conn: _ServerConnection, resp: Response) -> None:
        resp.force_close()
        fake = Request.__new__(Request)
        fake.method, fake.version, fake.headers = "GET", (1, 1), CIMultiDict()
        fake._conn = conn
        try:
            await resp.prepare(fake)
        except ConnectionError:
            pass


class AppRunner:
    # keepalive_timeout: aiohttp's AppRunner default (its RequestHandler's),
    # which the reference gateway serves with; only run_app passes 75 s
    def __init__(self, app: Application, *, shutdown_timeout: float = 60.0,
                 keepalive_timeout: float = 3630.0, access_log=None,
                 handle_signals: bool = False, **_kw):
        self.app = app
        self._state = _ServerState(app, shutdown_timeout, keepalive_timeout)
        self._sites: list["TCPSite"] = []

    async def setup(self) -> None:
        for cb in self.app.on_startup:
            await cb(self.app)

    @property
    def addresses(self) -> list:
        out = []
        for site in self._sites:
            if site._server is not None:
                out += [s.getsockname() for s in site._server.sockets]
        return out

    async def cleanup(self) -> None:
        for site in self._sites:
            await site.stop()
        st = self._state
        st.closing = True
        for w in list(st.idle):
            w.close()
        # open WebSockets get a close frame with 1001 (going away) and a
        # short wait for the peer's; their handlers are then cancelled,
        # not waited for
        sockets = list(st.sockets)
        if sockets:
            _, late = await asyncio.wait(
                [asyncio.ensure_future(c.ws.close(
                    code=WSCloseCode.GOING_AWAY, message=b"server shutdown"))
                 for c in sockets],
                timeout=min(st.shutdown_timeout, 2.0))
            for t in late:
                t.cancel()
            for c in sockets:
                c.ws._close_transport()
                for t in c.ws._tasks + [c.task]:
                    if t is not None:
                        t.cancel()
        pending = list(st.connections)
        if pending:
            done, still = await asyncio.wait(pending,
                                             timeout=st.shutdown_timeout)
            for t in still:
                t.cancel()
            if still:
                await asyncio.wait(still, timeout=1.0)
        for cb in self.app.on_shutdown:
            await cb(self.app)
        for cb in self.app.on_cleanup:
            await cb(self.app)


class TCPSite:
    def __init__(self, runner: AppRunner, host: str | None = None,
                 port: int | None = None, *, reuse_port: bool | None = None,
                 backlog: int = 128):
        self._runner = runner
        self._host = host
        self._port = 8080 if port is None else port
        self._reuse_port = reuse_port
        self._backlog = backlog
        self._server: asyncio.base_events.Server | None = None
        runner._sites.append(self)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._runner._state.handle, self._host, self._port,
            reuse_address=True, reuse_port=self._reuse_port,
            backlog=self._backlog, limit=_MAX_LINE,
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None


# ------------------------------------------------------------------- client


class ClientTimeout:
    """aiohttp's timeouts: `total` for the whole exchange (body included),
    `connect` for getting a connection (pool wait and TCP connect),
    `sock_connect` for the TCP connect alone, `sock_read` between reads."""

    __slots__ = ("total", "connect", "sock_read", "sock_connect")

    def __init__(self, total: float | None = None, connect: float | None = None,
                 sock_read: float | None = None,
                 sock_connect: float | None = None):
        self.total = total
        self.connect = connect
        self.sock_read = sock_read
        self.sock_connect = sock_connect

    def __repr__(self) -> str:
        return (f"ClientTimeout(total={self.total}, connect={self.connect}, "
                f"sock_read={self.sock_read}, "
                f"sock_connect={self.sock_connect})")


DEFAULT_TIMEOUT = ClientTimeout(total=300, sock_connect=30)


class _Deadline:
    def __init__(self, timeout: ClientTimeout):
        self.t = timeout
        self.end = (time.monotonic() + timeout.total
                    if timeout.total else None)

    def _left(self) -> float | None:
        return None if self.end is None else self.end - time.monotonic()

    async def run(self, aw, per_op: float | None, per_op_error):
        left = self._left()
        limits = [x for x in (left, per_op) if x is not None]
        if not limits:
            return await aw
        limit = min(limits)
        if limit <= 0:
            if hasattr(aw, "close"):
                aw.close()
            raise asyncio.TimeoutError()
        try:
            return await asyncio.wait_for(aw, limit)
        except asyncio.TimeoutError:
            if per_op is not None and limit == per_op and (
                    left is None or per_op < left):
                raise per_op_error() from None
            raise asyncio.TimeoutError() from None


class _Conn:
    __slots__ = ("reader", "writer", "key", "idle_since", "reused")

    def __init__(self, reader, writer, key):
        self.reader = reader
        self.writer = writer
        self.key = key
        self.idle_since = 0.0
        self.reused = False

    def close(self) -> None:
        try:
            self.writer.close()
        except Exception:  # allow-silent: closing a dead socket
            pass

    def open(self) -> bool:
        return (not self.writer.transport.is_closing()
                and not self.reader.at_eof())


class TCPConnector:
    """Keep-alive connection pool: at most `limit` connections in all and
    `limit_per_host` per (host, port, ssl) (0 = no cap); an idle connection
    is reused within `keepalive_timeout` seconds."""

    def __init__(self, *, limit: int = 100, limit_per_host: int = 0,
                 keepalive_timeout: float = 15.0, ssl=None):
        self.limit = limit
        self.limit_per_host = limit_per_host
        self.keepalive_timeout = keepalive_timeout
        self._ssl = ssl
        self._idle: dict[tuple, list[_Conn]] = {}
        self._total = asyncio.Semaphore(limit) if limit else None
        self._per_host: dict[tuple, asyncio.Semaphore] = {}
        self.closed = False

    async def _acquire_slots(self, key) -> None:
        if self.limit_per_host:
            sem = self._per_host.setdefault(
                key, asyncio.Semaphore(self.limit_per_host))
            await sem.acquire()
        if self._total is not None:
            try:
                await self._total.acquire()
            except BaseException:
                if self.limit_per_host:
                    self._per_host[key].release()
                raise

    def _release_slots(self, key) -> None:
        if self._total is not None:
            self._total.release()
        if self.limit_per_host:
            self._per_host[key].release()

    async def connect(self, key, deadline: _Deadline) -> _Conn:
        t = deadline.t
        await deadline.run(self._acquire_slots(key), t.connect,
                           lambda: ConnectionTimeoutError(
                               f"connection timeout to {key[0]}:{key[1]}"))
        try:
            pool = self._idle.get(key) or []
            while pool:
                conn = pool.pop()
                if conn.open() and (time.monotonic() - conn.idle_since
                                    < self.keepalive_timeout):
                    conn.reused = True
                    return conn
                conn.close()
            return await self._open(key, deadline)
        except BaseException:
            self._release_slots(key)
            raise

    async def _open(self, key, deadline: _Deadline) -> _Conn:
        host, port, use_ssl = key
        t = deadline.t
        per_op = min([x for x in (t.connect, t.sock_connect) if x],
                     default=None)
        ctx = None
        if use_ssl:
            ctx = self._ssl if isinstance(self._ssl, _ssl.SSLContext) \
                else _ssl.create_default_context()
        try:
            reader, writer = await deadline.run(
                asyncio.open_connection(host, port, ssl=ctx, limit=_MAX_LINE),
                per_op,
                lambda: ConnectionTimeoutError(
                    f"connection timeout to {host}:{port}"))
        except (asyncio.TimeoutError, ClientError):
            raise
        except OSError as e:
            raise ClientConnectorError(
                f"cannot connect to host {host}:{port} [{e.strerror or e}]"
            ) from e
        return _Conn(reader, writer, key)

    def release(self, conn: _Conn, *, reuse: bool) -> None:
        if reuse and not self.closed and conn.open():
            conn.idle_since = time.monotonic()
            conn.reused = False
            self._idle.setdefault(conn.key, []).append(conn)
        else:
            conn.close()
        self._release_slots(conn.key)

    async def close(self) -> None:
        self.closed = True
        for pool in self._idle.values():
            for conn in pool:
                conn.close()
        self._idle.clear()


class StreamReader:
    """The response body as aiohttp's `resp.content`: `iter_any()` yields
    the bytes as they arrive, `iter_chunked(n)` the same in pieces of at
    most n bytes, `read()` returns them all."""

    def __init__(self, resp: "ClientResponse"):
        self._resp = resp
        self._buf = b""

    async def readany(self) -> bytes:
        if self._buf:
            data, self._buf = self._buf, b""
            return data
        return await self._resp._next_bytes()

    async def read(self, n: int = -1) -> bytes:
        if n < 0:
            parts = [self._buf]
            self._buf = b""
            while True:
                data = await self._resp._next_bytes()
                if not data:
                    return b"".join(parts)
                parts.append(data)
        while len(self._buf) < n:
            data = await self._resp._next_bytes()
            if not data:
                break
            self._buf += data
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    async def iter_any(self):
        while True:
            data = await self.readany()
            if not data:
                return
            yield data

    async def iter_chunked(self, n: int):
        """The body as it arrives, in chunks of at most `n` bytes (as
        aiohttp's: a chunk may be shorter, so count bytes, not chunks)."""
        if n <= 0:
            raise ValueError("chunk size must be positive")
        while True:
            data = await self.readany()
            if not data:
                return
            if len(data) > n:
                data, self._buf = data[:n], data[n:]
            yield data


class ClientResponse:
    def __init__(self, method: str, url: str, conn: _Conn,
                 connector: TCPConnector, deadline: _Deadline,
                 status: int, reason: str, version: tuple[int, int],
                 headers: CIMultiDict):
        self.method = method
        self.url = url
        self.status = status
        self.reason = reason
        self.version = version
        self.headers = headers
        self._conn: _Conn | None = conn
        self._connector = connector
        self._deadline = deadline
        length, chunked = _body_mode(headers)
        no_body = method == "HEAD" or status in (204, 304) or status < 200
        self._reader = _BodyReader(conn.reader,
                                   length=0 if no_body else length,
                                   chunked=chunked and not no_body)
        self._until_close = (not no_body and length is None and not chunked)
        conn_hdr = headers.get("Connection", "").lower()
        self._keep_alive = (not self._until_close and "close" not in conn_hdr
                            and (version >= (1, 1) or "keep-alive" in conn_hdr))
        self._body: bytes | None = None
        self._body_done = self._reader.done
        self.content = StreamReader(self)
        if self._body_done:
            self._finish()

    async def _next_bytes(self) -> bytes:
        if self._body_done or self._conn is None:
            return b""
        try:
            data = await self._deadline.run(
                self._reader.read_some(), self._deadline.t.sock_read,
                lambda: SocketTimeoutError("timeout reading the response"))
        except (EOFError, ValueError) as e:
            self._abort()
            raise ClientPayloadError(f"response payload is not completed: {e}")
        except (ConnectionError, OSError) as e:
            if isinstance(e, (ClientError, asyncio.TimeoutError)):
                self._abort()
                raise
            self._abort()
            raise ClientPayloadError(
                f"response payload is not completed: {type(e).__name__}: {e}")
        except BaseException:
            self._abort()
            raise
        if not data:
            self._body_done = True
            self._finish()
        return data

    def _finish(self) -> None:
        if self._conn is not None:
            conn, self._conn = self._conn, None
            self._connector.release(conn, reuse=self._keep_alive)

    def _abort(self) -> None:
        if self._conn is not None:
            conn, self._conn = self._conn, None
            self._connector.release(conn, reuse=False)

    async def read(self) -> bytes:
        if self._body is None:
            self._body = await self.content.read()
        return self._body

    async def text(self, encoding: str | None = None) -> str:
        return (await self.read()).decode(encoding or "utf-8",
                                          errors="replace")

    async def json(self, *, content_type: str | None = "application/json",
                   loads=_json.loads):
        body = await self.read()
        if content_type is not None:
            ct = self.headers.get("Content-Type", "").lower()
            if content_type not in ct:
                raise ClientResponseError(
                    self.status,
                    f"Attempt to decode JSON with unexpected mimetype: {ct}")
        if not body.strip():
            return None
        return loads(body.decode("utf-8"))

    def release(self) -> None:
        """Give the connection back: to the pool when the body was read to
        its end, else closed (which is how the server sees a client that
        walked away mid-stream)."""
        if self._body_done:
            self._finish()
        else:
            self._abort()

    def close(self) -> None:
        self._abort()

    async def __aenter__(self) -> "ClientResponse":
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


class _RequestContextManager:
    """What `session.get/post` return: awaitable, and an async context
    manager that releases the response on exit."""

    def __init__(self, coro):
        self._coro = coro
        self._resp: ClientResponse | None = None

    def __await__(self):
        return self._coro.__await__()

    async def __aenter__(self) -> ClientResponse:
        self._resp = await self._coro
        return self._resp

    async def __aexit__(self, *exc) -> None:
        if self._resp is not None:
            self._resp.release()


class ClientSession:
    def __init__(self, *, connector: TCPConnector | None = None,
                 timeout: ClientTimeout | None = None, headers=None):
        self._connector = connector
        self._timeout = timeout or DEFAULT_TIMEOUT
        self._headers = CIMultiDict(headers)
        self.closed = False

    @property
    def connector(self) -> TCPConnector:
        if self._connector is None:
            self._connector = TCPConnector()
        return self._connector

    def request(self, method: str, url: str, **kw) -> _RequestContextManager:
        return _RequestContextManager(self._request(method, url, **kw))

    def get(self, url: str, **kw) -> _RequestContextManager:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> _RequestContextManager:
        return self.request("POST", url, **kw)

    def delete(self, url: str, **kw) -> _RequestContextManager:
        return self.request("DELETE", url, **kw)

    async def _request(self, method: str, url: str, *, json=None, data=None,
                       headers=None, timeout=None, params=None,
                       allow_redirects: bool = True) -> ClientResponse:
        if self.closed:
            raise RuntimeError("session is closed")
        if isinstance(timeout, (int, float)):
            timeout = ClientTimeout(total=float(timeout))
        deadline = _Deadline(timeout or self._timeout)
        split = urllib.parse.urlsplit(url)
        if split.scheme not in ("http", "https") or not split.hostname:
            raise ClientError(f"unsupported URL {url!r}")
        use_ssl = split.scheme == "https"
        port = split.port or (443 if use_ssl else 80)
        target = split.path or "/"
        query = split.query
        if params:
            extra = urllib.parse.urlencode(params, doseq=True)
            query = f"{query}&{extra}" if query else extra
        if query:
            target += "?" + query
        hdrs = self._headers.copy()
        for k, v in (headers or {}).items():
            hdrs[k] = v
        body = b""
        if json is not None:
            body = _json.dumps(json).encode("utf-8")
            hdrs.setdefault("Content-Type", "application/json")
        elif isinstance(data, FormData):
            body, ctype = data.encode()
            hdrs.setdefault("Content-Type", ctype)
        elif data is not None:
            body = data.encode("utf-8") if isinstance(data, str) else bytes(data)
        host_hdr = split.hostname if split.port is None else \
            f"{split.hostname}:{split.port}"
        if ":" in split.hostname and not split.hostname.startswith("["):
            host_hdr = f"[{split.hostname}]" + (
                f":{split.port}" if split.port else "")
        hdrs.setdefault("Host", host_hdr)
        hdrs.setdefault("Accept", "*/*")
        hdrs.setdefault("User-Agent", SERVER_NAME)
        if body or method in ("POST", "PUT", "PATCH"):
            hdrs["Content-Length"] = str(len(body))
        head = _encode_head(f"{method} {target} HTTP/1.1", hdrs)
        key = (split.hostname, port, use_ssl)
        for attempt in range(2):
            conn = await self.connector.connect(key, deadline)
            try:
                resp = await self._exchange(method, url, conn, deadline,
                                            head + body)
                return resp
            except _StaleConnection:
                self.connector.release(conn, reuse=False)
                if attempt:
                    raise ServerDisconnectedError()
            except BaseException:
                self.connector.release(conn, reuse=False)
                raise
        raise ServerDisconnectedError()  # pragma: no cover

    async def _exchange(self, method, url, conn: _Conn, deadline: _Deadline,
                        payload: bytes) -> ClientResponse:
        t = deadline.t
        try:
            conn.writer.write(payload)
            await deadline.run(conn.writer.drain(), t.sock_read,
                               lambda: SocketTimeoutError("timeout writing"))
            while True:
                head = await deadline.run(
                    _read_head(conn.reader), t.sock_read,
                    lambda: SocketTimeoutError(
                        "timeout waiting for the response head"))
                if head is None:
                    if conn.reused:
                        raise _StaleConnection()
                    raise ServerDisconnectedError()
                start, headers = head
                proto, _, rest = start.decode("latin-1").partition(" ")
                code, _, reason = rest.partition(" ")
                status = int(code)
                if status != 100:
                    break
        except (ConnectionResetError, BrokenPipeError) as e:
            if conn.reused:
                raise _StaleConnection() from e
            raise ServerDisconnectedError(str(e)) from e
        except ValueError as e:
            raise ClientPayloadError(f"malformed response head: {e}") from e
        major, minor = proto.split("/", 1)[1].split(".")
        return ClientResponse(method, url, conn, self.connector, deadline,
                              status, reason, (int(major), int(minor)),
                              headers)

    async def close(self) -> None:
        if not self.closed:
            self.closed = True
            if self._connector is not None:
                await self._connector.close()

    async def __aenter__(self) -> "ClientSession":
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()


class _StaleConnection(Exception):
    """A pooled keep-alive connection the server had already closed: the
    request is sent again once on a fresh connection."""


# ---------------------------------------------------------------- multipart
#
# multipart/form-data both ways, for the media routes: `Request.multipart()`
# on the server, `FormData` for the client. The server side buffers the
# whole body before it yields the first part (the media handlers buffer
# every part anyway, to re-send them on failover); like aiohttp's
# `multipart()` it is not capped by the application's client_max_size. A
# body that ends before the closing delimiter, has no starting delimiter or
# no boundary raises ValueError.


def _header_params(value: str) -> tuple[str, dict[str, str]]:
    """`main; k=v; k2="quoted; v"` → ("main", {k: v, k2: "quoted; v"})."""
    items, cur, quoted, i = [], [], False, 0
    while i < len(value):
        c = value[i]
        if quoted and c == "\\" and i + 1 < len(value):
            cur.append(c + value[i + 1])
            i += 2
            continue
        if c == '"':
            quoted = not quoted
        if c == ";" and not quoted:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(c)
        i += 1
    items.append("".join(cur))
    params = {}
    for item in items[1:]:
        k, sep, v = item.partition("=")
        if not sep:
            continue
        v = v.strip()
        if len(v) >= 2 and v[0] == v[-1] == '"':
            v = re.sub(r"\\(.)", r"\1", v[1:-1])
        params[k.strip().lower()] = v
    return items[0].strip().lower(), params


def _disposition_param(params: dict[str, str], key: str) -> str | None:
    ext = params.get(key + "*")  # RFC 5987: charset'lang'percent-encoded
    if ext is not None and ext.count("'") >= 2:
        charset, _, rest = ext.partition("'")
        try:
            return urllib.parse.unquote(rest.partition("'")[2],
                                        encoding=charset or "utf-8")
        except LookupError:  # a charset Python does not know
            raise ValueError(f"unknown charset {charset!r}") from None
    return params.get(key)


class BodyPartReader:
    """One part of a form: `name`, `filename`, `headers`, `read()`."""

    def __init__(self, headers: CIMultiDict, data: bytes):
        self.headers = headers
        self._data = data
        _, params = _header_params(headers.get("Content-Disposition", ""))
        self.name = _disposition_param(params, "name")
        self.filename = _disposition_param(params, "filename")

    async def read(self, *, decode: bool = False) -> bytearray:
        """The part's bytes; `decode=True` undoes a base64 or
        quoted-printable Content-Transfer-Encoding."""
        data = self._data
        if decode:
            import base64
            import binascii

            cte = self.headers.get("Content-Transfer-Encoding", "").lower()
            if cte == "base64":
                data = base64.b64decode(b"".join(data.split()))
            elif cte == "quoted-printable":
                data = binascii.a2b_qp(data)
            elif cte not in ("", "binary", "8bit", "7bit"):
                raise RuntimeError(f"unknown content transfer encoding: {cte}")
        return bytearray(data)


def _parse_part_headers(raw: bytes) -> CIMultiDict:
    headers = CIMultiDict()
    for line in raw.split(b"\r\n"):
        if not line:
            continue
        name, sep, value = line.partition(b":")
        if not sep:
            raise ValueError(f"malformed part header {line[:80]!r}")
        headers.add(name.strip().decode("latin-1"),
                    value.strip().decode("utf-8", errors="replace"))
    return headers


def parse_multipart(body: bytes, content_type: str) -> list[BodyPartReader]:
    """Every part of a multipart body, in order."""
    _, params = _header_params(content_type)
    boundary = params.get("boundary")
    if not boundary:
        raise ValueError(f"boundary missed for Content-Type: {content_type}")
    delim = b"--" + boundary.encode("latin-1")
    if body.startswith(delim):
        pos = len(delim)
    else:
        at = body.find(b"\r\n" + delim)
        if at < 0:
            raise ValueError(f"Could not find starting boundary {delim!r}")
        pos = at + 2 + len(delim)
    parts = []
    while True:
        if body.startswith(b"--", pos):
            return parts
        eol = body.find(b"\r\n", pos)
        if eol < 0 or body[pos:eol].strip(b" \t"):
            raise ValueError("Reading after EOF")
        start = eol + 2
        end = body.find(b"\r\n" + delim, start)
        if end < 0:
            raise ValueError("Reading after EOF")
        chunk = body[start:end]
        if chunk.startswith(b"\r\n"):  # no headers
            headers, data = CIMultiDict(), chunk[2:]
        else:
            head, sep, data = chunk.partition(b"\r\n\r\n")
            if not sep:
                raise ValueError("malformed part: no blank line after "
                                 "its headers")
            headers = _parse_part_headers(head)
        parts.append(BodyPartReader(headers, data))
        pos = end + 2 + len(delim)


class MultipartReader:
    """`async for part in await request.multipart()`, as in aiohttp."""

    def __init__(self, request: "Request"):
        self._request = request
        self._parts: list[BodyPartReader] | None = None

    async def next(self) -> BodyPartReader | None:
        if self._parts is None:
            try:
                body = await self._request._read_body(None)
            except HTTPBadRequest as e:  # the body ended before its length
                raise ValueError(e.text) from None
            self._parts = parse_multipart(
                body, self._request.headers.get("Content-Type", ""))
        return self._parts.pop(0) if self._parts else None

    def __aiter__(self) -> "MultipartReader":
        return self

    async def __anext__(self) -> BodyPartReader:
        part = await self.next()
        if part is None:
            raise StopAsyncIteration
        return part


def _quote_param(value: str) -> str:
    return (value.replace("\\", "%5C").replace('"', "%22")
            .replace("\r", "%0D").replace("\n", "%0A"))


class FormData:
    """aiohttp's FormData: fields in order, sent as multipart/form-data when
    any carries a file name, a content type or bytes (bytes without a file
    name take the field's name as one, as aiohttp 3 does), else as
    application/x-www-form-urlencoded."""

    def __init__(self):
        self._fields: list[tuple[str, object, str | None, str | None]] = []
        self.is_multipart = False

    def add_field(self, name: str, value, *, content_type: str | None = None,
                  filename: str | None = None) -> None:
        if isinstance(value, (bytes, bytearray, memoryview)) and \
                filename is None:
            filename = name
        if filename is not None or content_type is not None:
            self.is_multipart = True
        self._fields.append((name, value, filename, content_type))

    def encode(self) -> tuple[bytes, str]:
        """(body, Content-Type)."""
        if not self.is_multipart:
            body = urllib.parse.urlencode(
                [(n, v) for n, v, _, _ in self._fields], doseq=True)
            return body.encode(), "application/x-www-form-urlencoded"
        import uuid

        boundary = uuid.uuid4().hex
        out = []
        for name, value, filename, ctype in self._fields:
            if isinstance(value, str):
                data = value.encode("utf-8")
                ctype = ctype or "text/plain; charset=utf-8"
            else:
                data = bytes(value)
                ctype = ctype or "application/octet-stream"
            disp = f'form-data; name="{_quote_param(name)}"'
            if filename is not None:
                disp += f'; filename="{_quote_param(filename)}"'
            out.append(f"--{boundary}\r\nContent-Type: {ctype}\r\n"
                       f"Content-Disposition: {disp}\r\n\r\n"
                       .encode("utf-8") + data + b"\r\n")
        out.append(f"--{boundary}--\r\n".encode())
        return b"".join(out), f"multipart/form-data; boundary={boundary}"


# ---------------------------------------------------------------- websocket
#
# The server side of RFC 6455, as much of aiohttp's `WebSocketResponse` as
# the dashboard's socket uses: the handshake (`Upgrade: websocket`,
# `Connection: upgrade`, `Sec-WebSocket-Version: 13`, a 16-byte key;
# aiohttp's 400s otherwise) answered with 101, then frames both ways on
# the same connection, which the server loop no longer reads as HTTP.
# Server frames go unmasked with 7-, 16- or 64-bit lengths. A reader task
# takes the client's frames: each must be masked (else the socket closes
# with 1002, as for any protocol error), fragments are joined (4 MiB at
# most, aiohttp's default, else 1009), a ping is answered with a pong, and
# a close frame is echoed with 1000 (aiohttp's echo) before the transport
# closes. `heartbeat` pings when nothing has arrived for that long and
# closes the socket, as aiohttp does, when nothing arrives within half of
# it after. No extensions (the client's offer of compression is declined
# by not answering it) and no subprotocols.

_WS_GUID = b"258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
_WS_MAX_MSG_SIZE = 4 * 1024 * 1024
_WS_CLOSE_TIMEOUT = 10.0  # aiohttp's wait for the peer's close frame


class WSMsgType(enum.IntEnum):
    CONTINUATION = 0x0
    TEXT = 0x1
    BINARY = 0x2
    PING = 0x9
    PONG = 0xA
    CLOSE = 0x8
    CLOSING = 0x100
    CLOSED = 0x101
    ERROR = 0x102


class WSCloseCode(enum.IntEnum):
    OK = 1000
    GOING_AWAY = 1001
    PROTOCOL_ERROR = 1002
    UNSUPPORTED_DATA = 1003
    ABNORMAL_CLOSURE = 1006
    INVALID_TEXT = 1007
    POLICY_VIOLATION = 1008
    MESSAGE_TOO_BIG = 1009
    MANDATORY_EXTENSION = 1010
    INTERNAL_ERROR = 1011
    SERVICE_RESTART = 1012
    TRY_AGAIN_LATER = 1013
    BAD_GATEWAY = 1014


# codes a close frame may carry below 3000 (RFC 6455 7.4.1)
_WS_CLOSE_CODES = {int(c) for c in WSCloseCode} - {1006}


class WSMessage(typing.NamedTuple):
    """aiohttp's WSMessage: `data` is the text, the bytes, a close code or
    an exception by type, `extra` a close reason."""

    type: WSMsgType
    data: typing.Any
    extra: typing.Any


WS_CLOSED_MESSAGE = WSMessage(WSMsgType.CLOSED, None, None)
WS_CLOSING_MESSAGE = WSMessage(WSMsgType.CLOSING, None, None)


class WebSocketError(Exception):
    def __init__(self, code: int, message: str):
        self.code = code
        super().__init__(code, message)

    def __str__(self) -> str:
        return self.args[1]


def _ws_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked (server) frame."""
    n = len(payload)
    b0 = 0x80 | opcode
    if n < 126:
        head = struct.pack("!BB", b0, n)
    elif n < 65536:
        head = struct.pack("!BBH", b0, 126, n)
    else:
        head = struct.pack("!BBQ", b0, 127, n)
    return head + payload


def _ws_unmask(data: bytes, mask: bytes) -> bytes:
    n = len(data)
    if not n:
        return b""
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "big")
            ^ int.from_bytes(key, "big")).to_bytes(n, "big")


async def _ws_read_frame(reader: asyncio.StreamReader) -> tuple[int, bool,
                                                                bytes]:
    """(opcode, fin, payload) of one client frame; WebSocketError for a
    frame the server must refuse, IncompleteReadError at EOF."""
    b0, b1 = await reader.readexactly(2)
    fin, opcode, n = bool(b0 & 0x80), b0 & 0x0F, b1 & 0x7F
    if b0 & 0x70:
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                             "Received frame with non-zero reserved bits")
    if not b1 & 0x80:
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                             "Received an unmasked frame from the client")
    if opcode not in (0x0, 0x1, 0x2, 0x8, 0x9, 0xA):
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                             f"Unexpected opcode={opcode!r}")
    if n == 126:
        n = struct.unpack("!H", await reader.readexactly(2))[0]
    elif n == 127:
        n = struct.unpack("!Q", await reader.readexactly(8))[0]
    if opcode >= 0x8 and (not fin or n > 125):
        raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                             "Control frame fragmented or longer than 125")
    if n > _WS_MAX_MSG_SIZE:
        raise WebSocketError(WSCloseCode.MESSAGE_TOO_BIG,
                             f"Message size {n} exceeds limit "
                             f"{_WS_MAX_MSG_SIZE}")
    mask = await reader.readexactly(4)
    return opcode, fin, _ws_unmask(await reader.readexactly(n), mask)


class WebSocketResponse(StreamResponse):
    def __init__(self, *, heartbeat: float | None = None):
        super().__init__(status=101)
        self._heartbeat = heartbeat
        self._closed = False    # our close frame sent, or the socket lost
        self._closing = False   # the peer's close frame received
        self._close_code: int | None = None
        self._messages: asyncio.Queue | None = None
        self._peer_done: asyncio.Event | None = None  # the reader ended
        self._waiting = False
        self._last_seen = 0.0
        self._tasks: list[asyncio.Task] = []

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def close_code(self) -> int | None:
        return self._close_code

    def _handshake(self, request: Request) -> CIMultiDict:
        h = request.headers
        if request.method != "GET":
            raise HTTPMethodNotAllowed(request.method, ["GET"])
        if h.get("Upgrade", "").lower().strip() != "websocket":
            raise HTTPBadRequest(text=(
                f"No WebSocket UPGRADE hdr: {h.get('Upgrade')}\n Can "
                '"Upgrade" only to "WebSocket".'))
        if "upgrade" not in h.get("Connection", "").lower():
            raise HTTPBadRequest(
                text=f"No CONNECTION upgrade hdr: {h.get('Connection')}")
        version = h.get("Sec-WebSocket-Version", "")
        if version != "13":
            raise HTTPBadRequest(text=f"Unsupported version: {version}",
                                 headers={"Sec-WebSocket-Version": "13"})
        key = h.get("Sec-WebSocket-Key")
        try:
            if not key or len(base64.b64decode(key, validate=True)) != 16:
                raise ValueError(key)
        except ValueError:  # binascii.Error too
            raise HTTPBadRequest(text=f"Handshake error: {key!r}") from None
        accept = base64.b64encode(
            hashlib.sha1(key.encode() + _WS_GUID).digest()).decode()
        return CIMultiDict({"Upgrade": "websocket", "Connection": "upgrade",
                            "Sec-WebSocket-Accept": accept})

    async def prepare(self, request: Request) -> "WebSocketResponse":
        if self._prepared:
            return self
        self.headers.update(self._handshake(request))
        self.headers.setdefault("Date", formatdate(usegmt=True))
        self.headers.setdefault("Server", SERVER_NAME)
        conn = request._conn
        self._request, self._writer = request, conn.writer
        self._prepared = True
        conn.head_sent = True
        conn.ws = self
        if conn.server is not None:
            conn.server.sockets.add(conn)
        self._write_raw(_encode_head("HTTP/1.1 101 Switching Protocols",
                                     self.headers))
        await self._drain()
        self._last_seen = asyncio.get_running_loop().time()
        self._messages = asyncio.Queue(64)
        self._peer_done = asyncio.Event()
        self._tasks.append(asyncio.create_task(self._read_loop(conn.reader)))
        if self._heartbeat:
            self._tasks.append(asyncio.create_task(self._heartbeat_loop()))
        return self

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        self._write_raw(_ws_frame(opcode, payload))

    def _close_transport(self) -> None:
        if self._writer is not None:
            self._writer.close()

    def _deliver(self, msg: WSMessage) -> None:
        """A message for a receiver blocked now (the queue is empty while
        one waits); dropped when the queue is full, where none can be."""
        if not self._messages.full():
            self._messages.put_nowait(msg)

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        loop = asyncio.get_running_loop()
        parts: list[bytes] = []
        first_op = None
        try:
            while True:
                opcode, fin, payload = await _ws_read_frame(reader)
                self._last_seen = loop.time()
                if opcode == WSMsgType.PING:
                    self._send_frame(WSMsgType.PONG, payload)
                    continue
                if opcode == WSMsgType.PONG:
                    continue
                if opcode == WSMsgType.CLOSE:
                    await self._on_close_frame(payload)
                    return
                if opcode == WSMsgType.CONTINUATION:
                    if first_op is None:
                        raise WebSocketError(
                            WSCloseCode.PROTOCOL_ERROR,
                            "Continuation frame for non started message")
                elif first_op is not None:
                    raise WebSocketError(
                        WSCloseCode.PROTOCOL_ERROR,
                        "The opcode in non-fin frame is expected to be "
                        f"zero, got {opcode!r}")
                else:
                    first_op = opcode
                parts.append(payload)
                size = sum(map(len, parts))
                if size > _WS_MAX_MSG_SIZE:
                    raise WebSocketError(
                        WSCloseCode.MESSAGE_TOO_BIG,
                        f"Message size {size} exceeds limit "
                        f"{_WS_MAX_MSG_SIZE}")
                if not fin:
                    continue
                data, op, parts, first_op = b"".join(parts), first_op, [], None
                if op == WSMsgType.TEXT:
                    try:
                        msg = WSMessage(WSMsgType.TEXT, data.decode("utf-8"),
                                        None)
                    except UnicodeDecodeError:
                        raise WebSocketError(
                            WSCloseCode.INVALID_TEXT,
                            "Invalid UTF-8 text message") from None
                else:
                    msg = WSMessage(WSMsgType.BINARY, data, None)
                await self._messages.put(msg)
        except WebSocketError as e:
            if not self._closed:
                self._closed = True
                self._close_code = e.code
                try:
                    self._send_frame(WSMsgType.CLOSE,
                                     struct.pack("!H", e.code))
                    await self._drain()
                except ConnectionError:
                    pass
            self._close_transport()
            self._deliver(WSMessage(WSMsgType.ERROR, e, None))
        except (asyncio.IncompleteReadError, ConnectionError):
            if not self._closed:
                self._closed = True
                self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            self._deliver(WS_CLOSED_MESSAGE)
        finally:
            self._peer_done.set()

    async def _on_close_frame(self, payload: bytes) -> None:
        if len(payload) >= 2:
            code = struct.unpack("!H", payload[:2])[0]
            if code < 3000 and code not in _WS_CLOSE_CODES or code >= 5000:
                raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                     f"Invalid close code: {code}")
            try:
                reason = payload[2:].decode("utf-8")
            except UnicodeDecodeError:
                raise WebSocketError(WSCloseCode.INVALID_TEXT,
                                     "Invalid UTF-8 text message") from None
        elif payload:
            raise WebSocketError(WSCloseCode.PROTOCOL_ERROR,
                                 f"Invalid close frame: {payload!r}")
        else:
            code, reason = 0, ""
        self._closing = True
        self._close_code = code
        if not self._closed:
            self._closed = True
            try:
                self._send_frame(WSMsgType.CLOSE,
                                 struct.pack("!H", WSCloseCode.OK))
                await self._drain()
            except ConnectionError:
                pass
            self._close_transport()
        self._deliver(WSMessage(WSMsgType.CLOSE, code, reason))

    async def _heartbeat_loop(self) -> None:
        loop = asyncio.get_running_loop()
        hb = self._heartbeat
        while not self._closed:
            wait = self._last_seen + hb - loop.time()
            if wait > 0:
                await asyncio.sleep(wait)
                continue
            sent = loop.time()
            try:
                self._send_frame(WSMsgType.PING, b"")
            except ConnectionError:
                return
            await asyncio.sleep(hb / 2.0)
            if self._closed or self._last_seen >= sent:
                continue
            # no pong (nor anything else) within half a heartbeat
            self._closed = True
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            self._deliver(WSMessage(WSMsgType.ERROR, asyncio.TimeoutError(
                f"No PONG received after {hb / 2.0} seconds"), None))
            return

    async def receive(self) -> WSMessage:
        if self._messages is None:
            raise RuntimeError("Call .prepare() first")
        if self._waiting:
            raise RuntimeError("Concurrent call to receive() is not allowed")
        if self._messages.empty():
            if self._closed and (self._peer_done.is_set() or
                                 not self._closing):
                return WS_CLOSED_MESSAGE
            if self._closing:
                return WS_CLOSING_MESSAGE
        self._waiting = True
        try:
            return await self._messages.get()
        finally:
            self._waiting = False

    def __aiter__(self) -> "WebSocketResponse":
        return self

    async def __anext__(self) -> WSMessage:
        msg = await self.receive()
        if msg.type in (WSMsgType.CLOSE, WSMsgType.CLOSING,
                        WSMsgType.CLOSED):
            raise StopAsyncIteration
        return msg

    async def send_str(self, data: str) -> None:
        if self._writer is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed:
            raise ConnectionResetError("Cannot write to closing transport")
        self._send_frame(WSMsgType.TEXT, data.encode("utf-8"))
        await self._drain()

    async def close(self, *, code: int = WSCloseCode.OK,
                    message: bytes = b"") -> bool:
        """Send a close frame and wait up to 10 s for the peer's (the reader
        takes it), then close the transport. False if already closed."""
        if self._writer is None:
            raise RuntimeError("Call .prepare() first")
        if self._closed:
            return False
        self._closed = True
        try:
            self._send_frame(WSMsgType.CLOSE,
                             struct.pack("!H", code) + bytes(message))
            await self._drain()
        except ConnectionError:
            self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            self._close_transport()
            return True
        if self._waiting:  # wake a receiver, as aiohttp's CLOSING does
            self._deliver(WS_CLOSING_MESSAGE)
        if not self._closing:
            try:
                await asyncio.wait_for(self._peer_done.wait(),
                                       _WS_CLOSE_TIMEOUT)
            except asyncio.TimeoutError:
                self._close_code = WSCloseCode.ABNORMAL_CLOSURE
            except asyncio.CancelledError:
                self._close_code = WSCloseCode.ABNORMAL_CLOSURE
                self._close_transport()
                raise
        self._close_transport()
        return True

    async def write_eof(self, data: bytes = b"") -> None:
        if self._eof:
            return
        if self._prepared:
            await self.close()
        for t in self._tasks:
            t.cancel()
        self._eof = True


web = sys.modules[__name__]
