"""HTTP/1.1 on the standard library: the seam the REST serving plane stands on.

The reference serves its routes through aiohttp (``pathway_tpu/io/http/
_server.py``, ``web.AppRunner`` + ``web.TCPSite``). The port depends on no
package outside PyTorch's own, so this module speaks HTTP/1.1 itself on
``asyncio.start_server`` and answers as aiohttp answers the reference's
handlers, byte for byte where a client can see it:

- keep-alive by default on HTTP/1.1 (on HTTP/1.0 only when asked), and
  ``Connection: close``;
- request bodies framed by ``Content-Length`` or by chunked transfer coding
  (and ``Expect: 100-continue``), at most ``MAX_BODY`` bytes as aiohttp's
  ``client_max_size``;
- the query string parsed as ``request.rel_url.query`` parses it (``+`` as
  space, blank values kept, the last of a repeated key wins in a dict);
- :func:`json_response` equal to ``aiohttp.web.json_response``
  (``json.dumps`` with default separators, ``application/json;
  charset=utf-8``);
- ``404: Not Found``, ``405: Method Not Allowed`` (with ``Allow``) and the
  500 for a handler that raised, with aiohttp's plain-text bodies;
- routes matched by exact (percent-decoded) path.

A client that disconnects cancels its handler, as the reference's
``AppRunner(handler_cancellation=True)``: while a handler runs, the
connection keeps reading its socket, and end of file cancels the handler
task, whose ``CancelledError`` branch releases what the request held. Bytes
a client pipelines meanwhile are kept for its next request.
"""

from __future__ import annotations

import asyncio
import email.utils
import http
import json
import logging
import sys
from dataclasses import dataclass
from typing import Any, Awaitable, Callable
from urllib.parse import parse_qsl, unquote, urlsplit

_log = logging.getLogger(__name__)

#: request body bound (aiohttp's default ``client_max_size``)
MAX_BODY = 1024**2
#: request line + headers bound
MAX_HEAD = 64 * 1024
_READ_CHUNK = 64 * 1024
_SERVER = f"Python/{sys.version_info.major}.{sys.version_info.minor} pathway_tpu_torch"
_TEXT = "text/plain; charset=utf-8"


class BadRequest(Exception):
    """The bytes on the connection are not an HTTP/1.x request."""


class Headers:
    """Case-insensitive request headers; the first of a repeated name wins in
    :meth:`get`, as in aiohttp's ``CIMultiDict``."""

    __slots__ = ("_items",)

    def __init__(self, items: list[tuple[str, str]]):
        self._items = items

    def get(self, name: str, default: Any = None) -> Any:
        low = name.lower()
        for k, v in self._items:
            if k.lower() == low:
                return v
        return default


class Request:
    """One parsed request; the body is already read."""

    __slots__ = ("method", "path", "query_string", "version", "headers", "body")

    def __init__(self, method: str, path: str, query_string: str, version: str, headers: Headers, body: bytes):
        self.method = method
        self.path = path
        self.query_string = query_string
        self.version = version
        self.headers = headers
        self.body = body

    def query_items(self) -> list[tuple[str, str]]:
        """Every ``(name, value)`` of the query string in order."""
        return parse_qsl(self.query_string, keep_blank_values=True)

    @property
    def keep_alive(self) -> bool:
        conn = (self.headers.get("Connection") or "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn

    @property
    def charset(self) -> str | None:
        ctype = self.headers.get("Content-Type") or ""
        for part in ctype.split(";")[1:]:
            name, _, value = part.strip().partition("=")
            if name.lower() == "charset" and value:
                return value.strip('"')
        return None

    async def text(self) -> str:
        return self.body.decode(self.charset or "utf-8")

    async def json(self) -> Any:
        return json.loads(await self.text())


@dataclass
class Response:
    status: int
    body: bytes
    content_type: str
    headers: dict[str, str] | None = None

    def encode(self, *, keep_alive: bool, version: str, head: bool) -> bytes:
        """The response's bytes; the status line carries the request's
        ``version`` (HTTP/1.0 or HTTP/1.1), as aiohttp's does."""
        try:
            reason = http.HTTPStatus(self.status).phrase
        except ValueError:
            reason = ""
        lines = [f"{version} {self.status} {reason}"]
        lines += [f"{k}: {v}" for k, v in (self.headers or {}).items()]
        lines += [
            f"Content-Type: {self.content_type}",
            f"Content-Length: {len(self.body)}",
            f"Date: {email.utils.formatdate(usegmt=True)}",
            f"Server: {_SERVER}",
        ]
        # the version's default needs no header: HTTP/1.1 keeps the
        # connection, HTTP/1.0 closes it
        if version == "HTTP/1.0":
            if keep_alive:
                lines.append("Connection: keep-alive")
        elif not keep_alive:
            lines.append("Connection: close")
        head_bytes = ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")
        return head_bytes if head else head_bytes + self.body


def json_response(data: Any, *, status: int = 200, headers: dict[str, str] | None = None) -> Response:
    """``aiohttp.web.json_response``'s bytes: ``json.dumps(data)`` as UTF-8."""
    return Response(status, json.dumps(data).encode("utf-8"), "application/json; charset=utf-8", headers)


def text_response(status: int, text: str, headers: dict[str, str] | None = None) -> Response:
    return Response(status, text.encode("utf-8"), _TEXT, headers)


NOT_FOUND = text_response(404, "404: Not Found")
SERVER_ERROR = text_response(500, "500 Internal Server Error\n\nServer got itself in trouble")

Handler = Callable[[Request], Awaitable[Response]]


class _Connection:
    """One client connection's read side, buffered, so the watcher that
    detects a hang-up can keep bytes the client pipelines."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.buf = bytearray()
        self.eof = False

    async def fill(self) -> bool:
        """Read what the socket has; False at end of file."""
        data = await self.reader.read(_READ_CHUNK)
        if not data:
            self.eof = True
            return False
        self.buf += data
        return True

    async def read_until(self, sep: bytes, limit: int) -> bytes | None:
        start = 0
        while True:
            i = self.buf.find(sep, start)
            if i >= 0:
                out = bytes(self.buf[:i])
                del self.buf[: i + len(sep)]
                return out
            if len(self.buf) > limit:
                raise BadRequest("header section too large")
            start = max(0, len(self.buf) - len(sep) + 1)
            if not await self.fill():
                return None

    async def read_exactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            if not await self.fill():
                raise BadRequest("connection closed inside the body")
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out

    async def read_request(self) -> Request | None:
        """The next request, or None when the client closed between requests."""
        while self.buf.startswith(b"\r\n"):  # stray CRLF between requests
            del self.buf[:2]
        head = await self.read_until(b"\r\n\r\n", MAX_HEAD)
        if head is None:
            if self.buf.strip():
                raise BadRequest("connection closed inside the header section")
            return None
        lines = head.decode("latin-1").split("\r\n")
        while lines and not lines[0]:
            lines.pop(0)
        parts = lines[0].split(" ") if lines else []
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise BadRequest(f"bad request line {lines[:1]!r}")
        method, target, version = parts
        items: list[tuple[str, str]] = []
        for line in lines[1:]:
            name, sep, value = line.partition(":")
            if not sep or not name or name != name.strip():
                raise BadRequest(f"bad header line {line!r}")
            items.append((name, value.strip()))
        headers = Headers(items)
        if target.startswith(("http://", "https://")):
            split = urlsplit(target)
            path, query = split.path or "/", split.query
        else:
            path, _, query = target.partition("?")
        if (headers.get("Expect") or "").lower() == "100-continue":
            self.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        te = (headers.get("Transfer-Encoding") or "").lower()
        if "chunked" in te:
            body = await self._read_chunked()
        else:
            raw = headers.get("Content-Length")
            try:
                n = int(raw) if raw is not None else 0
            except ValueError:
                raise BadRequest(f"bad Content-Length {raw!r}") from None
            if n < 0:
                raise BadRequest(f"bad Content-Length {raw!r}")
            if n > MAX_BODY:
                raise _TooLarge(n)
            body = await self.read_exactly(n)
        return Request(method.upper(), unquote(path), query, version, headers, body)

    async def _read_chunked(self) -> bytes:
        body = bytearray()
        while True:
            line = await self.read_until(b"\r\n", MAX_HEAD)
            if line is None:
                raise BadRequest("connection closed inside a chunk size")
            try:
                size = int(line.split(b";", 1)[0].strip(), 16)
            except ValueError:
                raise BadRequest(f"bad chunk size {line[:32]!r}") from None
            if size == 0:
                while True:  # trailers, up to the blank line
                    trailer = await self.read_until(b"\r\n", MAX_HEAD)
                    if trailer is None:
                        raise BadRequest("connection closed inside the trailers")
                    if not trailer:
                        return bytes(body)
            if len(body) + size > MAX_BODY:
                raise _TooLarge(len(body) + size)
            body += await self.read_exactly(size)
            if await self.read_exactly(2) != b"\r\n":
                raise BadRequest("chunk not followed by CRLF")

    async def wait_hangup(self) -> None:
        """Return when the client closes its side; pipelined bytes are kept
        (up to MAX_HEAD + MAX_BODY, then the socket is left unread)."""
        while len(self.buf) <= MAX_HEAD + MAX_BODY:
            if not await self.fill():
                return
        await asyncio.Event().wait()  # cancelled when the handler finishes


class _TooLarge(BadRequest):
    def __init__(self, size: int):
        super().__init__(f"Maximum request body size {MAX_BODY} exceeded, actual body size {size}")


class HttpServer:
    """Routes by exact path, then by method; one task per connection, its
    requests answered in order."""

    def __init__(self, routes: dict[str, dict[str, Handler]]):
        self.routes = routes
        self._server: asyncio.Server | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._writers: set[asyncio.StreamWriter] = set()
        #: one future per request being answered, done once it is written
        self._busy: set[asyncio.Future] = set()
        self._closing = False

    async def start(self, host: str, port: int) -> None:
        self._server = await asyncio.start_server(self._serve, host, port, reuse_address=True)

    async def shutdown(self, timeout: float = 10.0) -> None:
        """Stop listening (the port is free when this returns), let the
        requests being answered finish writing (for ``timeout`` at most),
        then close every connection."""
        self._closing = True
        if self._server is not None:
            self._server.close()
        if self._busy:
            await asyncio.wait(set(self._busy), timeout=timeout)
        for w in list(self._writers):
            w.close()
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.wait(set(self._conn_tasks), timeout=timeout)
        if self._server is not None:
            await asyncio.wait_for(self._server.wait_closed(), timeout=timeout)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        self._writers.add(writer)
        conn = _Connection(reader, writer)
        try:
            while not self._closing:
                try:
                    req = await conn.read_request()
                except _TooLarge as e:
                    writer.write(text_response(413, str(e)).encode(keep_alive=False, version="HTTP/1.1", head=False))
                    break
                except BadRequest as e:
                    writer.write(text_response(400, f"400, message:\n  {e}").encode(keep_alive=False, version="HTTP/1.1", head=False))
                    break
                if req is None:
                    break
                done = asyncio.get_running_loop().create_future()
                self._busy.add(done)
                try:
                    resp = await self._answer_watched(conn, req)
                    if resp is None:  # the client hung up; its handler was cancelled
                        break
                    keep = req.keep_alive and resp.status != 500 and not self._closing
                    writer.write(resp.encode(keep_alive=keep, version=req.version, head=req.method == "HEAD"))
                    await writer.drain()
                finally:
                    self._busy.discard(done)
                    done.set_result(None)
                if not keep or conn.eof:
                    break
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            pass  # shutdown() closes idle connections this way
        finally:
            self._writers.discard(writer)
            self._conn_tasks.discard(task)
            writer.close()

    async def _answer_watched(self, conn: _Connection, req: Request) -> Response | None:
        """The handler's response, or None when the client closed its side
        first; then the handler task is cancelled and awaited."""
        handler_task = asyncio.ensure_future(self._answer(req))
        if conn.eof:
            return await handler_task
        watcher = asyncio.ensure_future(conn.wait_hangup())
        try:
            await asyncio.wait({handler_task, watcher}, return_when=asyncio.FIRST_COMPLETED)
        except asyncio.CancelledError:
            handler_task.cancel()
            watcher.cancel()
            raise
        if handler_task.done():
            watcher.cancel()
            await asyncio.gather(watcher, return_exceptions=True)
            return handler_task.result()
        handler_task.cancel()
        await asyncio.gather(handler_task, watcher, return_exceptions=True)
        return None

    async def _answer(self, req: Request) -> Response:
        methods = self.routes.get(req.path)
        if methods is None:
            return NOT_FOUND
        handler = methods.get(req.method)
        if handler is None:
            return text_response(405, "405: Method Not Allowed", {"Allow": ",".join(sorted(methods))})
        try:
            return await handler(req)
        except asyncio.CancelledError:
            raise
        except Exception:
            _log.exception("Error handling request %s %s", req.method, req.path)
            return SERVER_ERROR
