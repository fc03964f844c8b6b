"""HTTP/1.1 on asyncio streams: what the JAX router takes from aiohttp.

The server side stands in for ``aiohttp.web``: an ``Application`` with GET
and POST routes (``{name}`` path segments land in ``match_info``),
``Request`` (with ``multipart()`` for form uploads), ``Response``,
``StreamResponse`` and ``json_response``. It
keeps client connections alive (HTTP/1.1, as aiohttp does), takes request
bodies by ``Content-Length`` or chunked up to ``client_max_size``, answers
``Expect: 100-continue``, and writes a ``StreamResponse`` chunked, so SSE
events reach the client as they are written. While a handler runs, a
watcher reads the connection: end of file means the client went away, and
the handler is cancelled (aiohttp's handler cancellation), so the proxy's
``finally`` paths close the upstream request and the engine aborts it.

The client side stands in for ``aiohttp.ClientSession``: one connection
per request (``Connection: close``), a connect timeout (30 s by default)
and no total timeout. ``ClientResponse.content.iter_any()`` streams the
body as it arrives, whether it is sized by ``Content-Length``, chunked or
delimited by the server closing the connection (the port engine's
streams). Every transport failure raises a ``ClientError``; none of them
is an ``asyncio.TimeoutError``, so a caller's ``wait_for`` deadline stays
the only timeout of that kind.
"""

import asyncio
import email.message
import email.utils
import json
from typing import Awaitable, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qsl, urlsplit

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_REASONS = {100: "Continue", 200: "OK", 204: "No Content", 400: "Bad Request",
            401: "Unauthorized", 404: "Not Found", 405: "Method Not Allowed",
            409: "Conflict", 413: "Request Entity Too Large",
            500: "Internal Server Error", 501: "Not Implemented",
            502: "Bad Gateway", 503: "Service Unavailable",
            504: "Gateway Timeout"}
_READ = 1 << 16
_MAX_LINE = 1 << 16
_MAX_HEADERS = 256
#: Seconds a kept-alive connection may sit idle before its next request
#: (aiohttp's ``keepalive_timeout``).
KEEPALIVE_S = 75.0


class Headers:
    """Case-insensitive header mapping (names kept as first written)."""

    def __init__(self, items=None):
        self._d: Dict[str, Tuple[str, str]] = {}
        for k, v in (items.items() if isinstance(items, (dict, Headers))
                     else items or ()):
            self[k] = v

    def __setitem__(self, name: str, value) -> None:
        self._d[name.lower()] = (name, str(value))

    def __getitem__(self, name: str) -> str:
        return self._d[name.lower()][1]

    def __contains__(self, name) -> bool:
        return isinstance(name, str) and name.lower() in self._d

    def get(self, name: str, default=None):
        item = self._d.get(name.lower())
        return default if item is None else item[1]

    def items(self):
        return list(self._d.values())


class _Reader:
    """A connection's reader with its own buffer: the disconnect watcher
    may read bytes of a pipelined next request while a handler runs."""

    def __init__(self, reader: asyncio.StreamReader):
        self.reader = reader
        self.buf = bytearray()
        self.eof = False

    async def fill(self) -> None:
        data = await self.reader.read(_READ)
        if not data:
            self.eof = True
            raise asyncio.IncompleteReadError(bytes(self.buf), None)
        self.buf += data

    async def readline(self) -> bytes:
        while True:
            i = self.buf.find(b"\n")
            if i >= 0:
                line = bytes(self.buf[:i + 1])
                del self.buf[:i + 1]
                return line
            if len(self.buf) > _MAX_LINE:
                raise _BadRequest(400, "header line too long")
            await self.fill()

    async def readexactly(self, n: int) -> bytes:
        while len(self.buf) < n:
            await self.fill()
        out = bytes(self.buf[:n])
        del self.buf[:n]
        return out


class _BadRequest(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


async def _read_head(conn: _Reader) -> Tuple[str, Headers]:
    """The start line and the headers of one message."""
    line = await conn.readline()
    while line in (b"\r\n", b"\n"):      # tolerated between messages
        line = await conn.readline()
    headers = Headers()
    for _ in range(_MAX_HEADERS):
        h = await conn.readline()
        if h in (b"\r\n", b"\n"):
            return line.decode("latin-1").strip(), headers
        name, sep, value = h.decode("latin-1").partition(":")
        if not sep:
            raise _BadRequest(400, "malformed header line")
        headers[name.strip()] = value.strip()
    raise _BadRequest(400, "too many headers")


# =================================================================== server
class Request:
    """One inbound request: ``method``, ``path``, ``query``, ``headers``,
    ``match_info``, the ``app`` it arrived on, and per-request state
    (``request["key"]``, ``request.get``)."""

    def __init__(self, app: "Application", method: str, path: str,
                 query: Dict[str, str], headers: Headers, body: bytes,
                 version: str):
        self.app = app
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self.version = version
        self.match_info: Dict[str, str] = {}
        self._body = body
        self._state: dict = {}

    async def read(self) -> bytes:
        return self._body

    async def json(self):
        return json.loads(self._body)

    async def multipart(self) -> "MultipartReader":
        """The body's ``multipart/form-data`` parts (aiohttp's
        ``request.multipart()``); the body is already read, within
        ``client_max_size``."""
        return MultipartReader(self.headers.get("Content-Type") or "",
                               self._body)

    def get(self, key, default=None):
        return self._state.get(key, default)

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value) -> None:
        self._state[key] = value


class BodyPart:
    """One part of a multipart body: the ``name`` and ``filename`` of its
    ``Content-Disposition`` (None when absent), its ``headers``, and its
    bytes as sent (``read()``)."""

    def __init__(self, headers: Headers, data: bytes):
        self.headers = headers
        self._data = data
        disposition = email.message.Message()
        disposition["Content-Disposition"] = \
            headers.get("Content-Disposition") or ""
        name = disposition.get_param("name", header="Content-Disposition")
        self.name = (None if name is None
                     else email.utils.collapse_rfc2231_value(name))
        self.filename = disposition.get_filename()

    async def read(self) -> bytes:
        return self._data


class MultipartReader:
    """``multipart/form-data`` split at its boundary, part by part: ``async
    for part in reader``. Delimiter lines may end in CRLF or LF; the line
    break before a delimiter belongs to it, so a part's bytes come back
    exactly as sent. A body without the boundary parameter, its opening
    delimiter or its closing one raises ValueError."""

    def __init__(self, content_type: str, body: bytes):
        ctype = email.message.Message()
        ctype["Content-Type"] = content_type
        boundary = ctype.get_param("boundary")
        if ctype.get_content_maintype() != "multipart" or not boundary:
            raise ValueError(f"not a multipart body: {content_type!r}")
        self._parts = _split_multipart(
            body, b"--" + str(boundary).encode("latin-1"))

    def __aiter__(self):
        return self._iter()

    async def _iter(self):
        for part in self._parts:
            yield part


def _split_multipart(body: bytes, delim: bytes) -> List[BodyPart]:
    if body.startswith(delim):
        pos = len(delim)
    else:
        i = body.find(b"\n" + delim)
        if i < 0:
            raise ValueError("multipart body has no opening boundary")
        pos = i + 1 + len(delim)
    parts = []
    while True:
        if body.startswith(b"--", pos):
            return parts                          # the closing delimiter
        eol = body.find(b"\n", pos)
        if eol < 0 or body[pos:eol].strip():
            raise ValueError("malformed multipart boundary line")
        pos = eol + 1
        headers = Headers()
        while True:
            eol = body.find(b"\n", pos)
            if eol < 0:
                raise ValueError("multipart part headers do not end")
            line = body[pos:eol].rstrip(b"\r")
            pos = eol + 1
            if not line:
                break
            name, sep, value = line.decode("utf-8", "replace").partition(":")
            if not sep:
                raise ValueError("malformed multipart header line")
            headers[name.strip()] = value.strip()
        end = body.find(b"\n" + delim, pos - 1)
        if end < 0:
            raise ValueError("multipart body has no closing boundary")
        data_end = end - 1 if end > pos - 1 and body[end - 1:end] == b"\r" \
            else end
        parts.append(BodyPart(headers, body[pos:max(pos, data_end)]))
        pos = end + 1 + len(delim)


class Response:
    """A whole response: ``body`` (bytes) or ``text``."""

    def __init__(self, status: int = 200, body: bytes = b"",
                 headers: Optional[dict] = None,
                 content_type: Optional[str] = None,
                 text: Optional[str] = None):
        self.status = status
        self.headers = Headers(headers or {})
        if text is not None:
            body = text.encode()
            content_type = content_type or "text/plain"
        if content_type is not None:
            self.headers["Content-Type"] = (
                content_type + "; charset=utf-8"
                if content_type.startswith(("text/", "application/json"))
                and "charset" not in content_type else content_type)
        elif "Content-Type" not in self.headers:
            self.headers["Content-Type"] = "application/octet-stream"
        self.body = body
        self.prepared = False


def json_response(data, status: int = 200,
                  headers: Optional[dict] = None) -> Response:
    return Response(status=status, body=json.dumps(data).encode(),
                    headers=headers, content_type="application/json")


class StreamResponse:
    """A response whose body is written as it is produced (chunked)."""

    def __init__(self, status: int = 200, headers: Optional[dict] = None):
        self.status = status
        self.headers = Headers(headers or {})
        self.prepared = False
        self._writer: Optional[asyncio.StreamWriter] = None
        self._chunked = True
        self._eof = False

    async def prepare(self, request: Request) -> None:
        if self.prepared:
            return
        conn = request.get("_connection")
        request["_stream"] = self
        self._writer = conn.writer
        self._chunked = request.version == "HTTP/1.1"
        if not self._chunked:
            conn.keep_alive = False
        extra = {"Transfer-Encoding": "chunked"} if self._chunked else {}
        self._writer.write(_head(self.status, self.headers, extra,
                                 conn.keep_alive))
        self.prepared = True
        await self._writer.drain()

    async def write(self, data: bytes) -> None:
        if not self.prepared or self._eof:
            raise RuntimeError("write on a response that is not open")
        if not data:
            return
        if self._chunked:
            self._writer.write(b"%x\r\n%s\r\n" % (len(data), data))
        else:
            self._writer.write(data)
        await self._writer.drain()

    async def write_eof(self) -> None:
        if self._eof or not self.prepared:
            return
        self._eof = True
        if self._chunked:
            self._writer.write(b"0\r\n\r\n")
        await self._writer.drain()


def _head(status: int, headers: Headers, extra: dict,
          keep_alive: bool) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    for k, v in headers.items():
        if k.lower() not in ("connection", "content-length",
                             "transfer-encoding"):
            lines.append(f"{k}: {v}")
    for k, v in extra.items():
        lines.append(f"{k}: {v}")
    lines.append(f"Connection: {'keep-alive' if keep_alive else 'close'}")
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


Handler = Callable[[Request], Awaitable]


class _Router:
    def __init__(self):
        self.routes: List[Tuple[str, List[str], Handler]] = []

    def add_get(self, path: str, handler: Handler) -> None:
        self.routes.append(("GET", path.strip("/").split("/"), handler))

    def add_post(self, path: str, handler: Handler) -> None:
        self.routes.append(("POST", path.strip("/").split("/"), handler))

    def resolve(self, method: str, path: str):
        """(handler, match_info), or (None, status) for 404 / 405."""
        parts = path.strip("/").split("/")
        found_path = False
        for m, pattern, handler in self.routes:
            if len(pattern) != len(parts):
                continue
            info = {}
            for want, got in zip(pattern, parts):
                if want.startswith("{") and want.endswith("}"):
                    if not got:
                        break
                    info[want[1:-1]] = got
                elif want != got:
                    break
            else:
                found_path = True
                if m == method:
                    return handler, info
        return None, 405 if found_path else 404


class _ConnState:
    def __init__(self, writer: asyncio.StreamWriter):
        self.writer = writer
        self.keep_alive = True


class Application(dict):
    """Routes, startup/cleanup hooks and app-wide state (``app["key"]``)."""

    def __init__(self, client_max_size: int = 1 << 20):
        super().__init__()
        self.client_max_size = client_max_size
        self.router = _Router()
        self.on_startup: List[Callable] = []
        self.on_cleanup: List[Callable] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set = set()

    # --------------------------------------------------------- lifecycle
    async def start(self, host: str, port: int) -> int:
        """Run the startup hooks and listen; returns the bound port."""
        for hook in self.on_startup:
            await hook(self)
        self._server = await asyncio.start_server(self._serve, host, port,
                                                  limit=_MAX_LINE)
        return self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            for task in list(self._conns):
                task.cancel()
            await asyncio.gather(*self._conns, return_exceptions=True)
            await self._server.wait_closed()
            self._server = None
        for hook in self.on_cleanup:
            await hook(self)

    # -------------------------------------------------------- connections
    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns.add(task)
        conn = _Reader(reader)
        state = _ConnState(writer)
        try:
            served = 0
            while state.keep_alive:
                try:
                    if served and not conn.buf:
                        await asyncio.wait_for(conn.fill(), KEEPALIVE_S)
                    served += 1
                    request = await self._read_request(conn, state)
                except (asyncio.IncompleteReadError, asyncio.TimeoutError):
                    return              # client closed, or idle, between requests
                except _BadRequest as e:
                    state.keep_alive = False
                    await self._write(state, Response(
                        e.status, text=f"{e.status}: {e.message}"))
                    return
                if request is None:
                    return
                if not await self._dispatch(request, conn, state):
                    return
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except asyncio.CancelledError:
            pass
        finally:
            self._conns.discard(task)
            writer.close()

    async def _read_request(self, conn: _Reader,
                            state: _ConnState) -> Optional[Request]:
        line, headers = await _read_head(conn)
        parts = line.split()
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise _BadRequest(400, "malformed request line")
        method, target, version = parts
        conn_hdr = (headers.get("Connection") or "").lower()
        state.keep_alive = (
            "close" not in conn_hdr if version == "HTTP/1.1"
            else "keep-alive" in conn_hdr)
        if (headers.get("Expect") or "").lower() == "100-continue":
            state.writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
        if "chunked" in (headers.get("Transfer-Encoding") or "").lower():
            body = await self._read_chunked(conn)
        else:
            try:
                n = int(headers.get("Content-Length") or 0)
            except ValueError:
                raise _BadRequest(400, "bad Content-Length") from None
            if n < 0:
                raise _BadRequest(400, "bad Content-Length")
            if n > self.client_max_size:
                raise _BadRequest(
                    413, f"Maximum request body size {self.client_max_size} "
                         f"exceeded, actual body size {n}")
            body = await conn.readexactly(n) if n else b""
        path, _, query = target.partition("?")
        request = Request(self, method.upper(), path,
                          dict(parse_qsl(query, keep_blank_values=True)),
                          headers, body, version)
        request["_connection"] = state
        return request

    async def _read_chunked(self, conn: _Reader) -> bytes:
        body = bytearray()
        while True:
            size_line = (await conn.readline()).split(b";")[0].strip()
            try:
                size = int(size_line, 16)
            except ValueError:
                raise _BadRequest(400, "bad chunk size") from None
            if size == 0:
                while (await conn.readline()) not in (b"\r\n", b"\n"):
                    pass                            # trailers
                return bytes(body)
            if len(body) + size > self.client_max_size:
                raise _BadRequest(413, "Maximum request body size "
                                       f"{self.client_max_size} exceeded")
            body += await conn.readexactly(size)
            await conn.readline()

    async def _dispatch(self, request: Request, conn: _Reader,
                        state: _ConnState) -> bool:
        """Run one request's handler while watching for the client to
        go away. False: the connection is done."""
        handler, info = self.router.resolve(request.method, request.path)
        if handler is None:
            await self._write(state, Response(info, text=(
                "404: Not Found" if info == 404
                else "405: Method Not Allowed")))
            return state.keep_alive
        request.match_info = info
        work = asyncio.ensure_future(handler(request))
        watch = asyncio.ensure_future(self._watch(conn))
        try:
            await asyncio.wait({work, watch},
                               return_when=asyncio.FIRST_COMPLETED)
            if not work.done():
                # The client closed its side: cancel the handler (its
                # finally paths close the upstream request).
                work.cancel()
                await asyncio.gather(work, return_exceptions=True)
                return False
        except asyncio.CancelledError:
            work.cancel()
            await asyncio.gather(work, return_exceptions=True)
            raise
        finally:
            if not watch.done():
                watch.cancel()
                await asyncio.gather(watch, return_exceptions=True)
        try:
            response = work.result()
        except Exception:  # noqa: BLE001 — one request, not the server
            logger.exception("Error handling %s %s", request.method,
                             request.path)
            response = Response(500, text="500 Internal Server Error\n\n"
                                          "Server got itself in trouble")
            if getattr(request.get("_stream"), "prepared", False):
                return False
        if isinstance(response, StreamResponse):
            if not response.prepared:
                await response.prepare(request)
            if not response._eof:
                try:
                    await response.write_eof()
                except ConnectionError:
                    return False
            return state.keep_alive and not conn.eof
        await self._write(state, response)
        return state.keep_alive and not conn.eof

    @staticmethod
    async def _watch(conn: _Reader) -> None:
        """Return when the client's side of the connection ends; bytes
        it sends meanwhile (a pipelined request) stay buffered."""
        while True:
            try:
                await conn.fill()
            except asyncio.IncompleteReadError:
                return
            except ConnectionError:
                conn.eof = True
                return

    @staticmethod
    async def _write(state: _ConnState, response: Response) -> None:
        state.writer.write(_head(response.status, response.headers,
                                 {"Content-Length": len(response.body)},
                                 state.keep_alive) + response.body)
        await state.writer.drain()


def run_app(app: Application, host: str, port: int) -> None:
    """Serve ``app`` until SIGINT or SIGTERM, then run its cleanup."""
    import signal

    async def serve():
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await app.start(host, port)
        try:
            await stop.wait()
        finally:
            await app.stop()

    asyncio.run(serve())


# =================================================================== client
class ClientError(Exception):
    """A transport failure talking to a backend."""


class ClientConnectionError(ClientError):
    """The connection could not be opened, or broke."""


class ClientPayloadError(ClientError):
    """The response body ended before its framing said it would."""


class _Content:
    def __init__(self, response: "ClientResponse"):
        self._r = response

    def iter_any(self):
        return self._r._iter_body()


class ClientResponse:
    """A backend's response: ``status``, ``headers``, and the body as a
    stream (``content.iter_any()``) or whole (``read()``)."""

    def __init__(self, conn: _Reader, writer: asyncio.StreamWriter,
                 method: str, status: int, headers: Headers):
        self._conn = conn
        self._writer = writer
        self.status = status
        self.headers = headers
        self.content = _Content(self)
        self.closed = False
        te = (headers.get("Transfer-Encoding") or "").lower()
        if method == "HEAD" or status in (204, 304) or status < 200:
            self._mode, self._left = "none", 0
        elif "chunked" in te:
            self._mode, self._left = "chunked", 0
        elif headers.get("Content-Length") is not None:
            try:
                self._left = int(headers["Content-Length"])
            except ValueError:
                raise ClientPayloadError("bad Content-Length") from None
            self._mode = "length"
        else:
            self._mode, self._left = "close", 0

    async def _read_some(self, n: int) -> bytes:
        if self._conn.buf:
            out = bytes(self._conn.buf[:n])
            del self._conn.buf[:n]
            return out
        try:
            return await self._conn.reader.read(n)
        except (ConnectionError, OSError) as e:
            raise ClientConnectionError(f"connection broke: {e!r}") from e

    async def _iter_body(self):
        try:
            if self._mode == "length":
                while self._left > 0:
                    data = await self._read_some(min(self._left, _READ))
                    if not data:
                        raise ClientPayloadError(
                            "response payload is not completed")
                    self._left -= len(data)
                    yield data
            elif self._mode == "close":
                while True:
                    data = await self._read_some(_READ)
                    if not data:
                        return
                    yield data
            elif self._mode == "chunked":
                while True:
                    line = await self._line()
                    try:
                        size = int(line.split(b";")[0].strip(), 16)
                    except ValueError:
                        raise ClientPayloadError("bad chunk size") from None
                    if size == 0:
                        while (await self._line()) not in (b"\r\n", b"\n"):
                            pass
                        return
                    while size > 0:
                        data = await self._read_some(min(size, _READ))
                        if not data:
                            raise ClientPayloadError(
                                "response payload is not completed")
                        size -= len(data)
                        yield data
                    await self._line()
        finally:
            self.close()

    async def _line(self) -> bytes:
        try:
            return await self._conn.readline()
        except asyncio.IncompleteReadError:
            raise ClientPayloadError(
                "response payload is not completed") from None
        except (ConnectionError, OSError) as e:
            raise ClientConnectionError(f"connection broke: {e!r}") from e
        except _BadRequest as e:
            raise ClientPayloadError(e.message) from None

    async def read(self) -> bytes:
        return b"".join([c async for c in self._iter_body()])

    def close(self) -> None:
        """Drop the connection (the backend sees the client go away)."""
        if not self.closed:
            self.closed = True
            self._writer.close()

    release = close


class ClientSession:
    """Opens one connection per request; ``connect_timeout`` bounds the
    TCP connect and the wait for the response head is unbounded (the
    caller's deadline bounds it)."""

    def __init__(self, connect_timeout: float = 30.0):
        self.connect_timeout = connect_timeout
        self.closed = False

    async def request(self, method: str, url: str, data: bytes = None,
                      json_body=None, headers: Optional[dict] = None,
                      ) -> ClientResponse:
        if self.closed:
            raise RuntimeError("Session is closed")
        parts = urlsplit(url)
        if parts.scheme != "http" or not parts.hostname:
            raise ClientError(f"unsupported URL {url!r}")
        port = parts.port or 80
        if json_body is not None:
            data = json.dumps(json_body).encode()
        hdrs = Headers(headers or {})
        if json_body is not None and "Content-Type" not in hdrs:
            hdrs["Content-Type"] = "application/json"
        hdrs["Host"] = parts.netloc
        hdrs["Connection"] = "close"
        if data is not None or method in ("POST", "PUT"):
            hdrs["Content-Length"] = len(data or b"")
        target = (parts.path or "/") + (f"?{parts.query}" if parts.query else "")
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(parts.hostname, port, limit=_MAX_LINE),
                self.connect_timeout)
        except asyncio.TimeoutError:
            raise ClientConnectionError(
                f"connect to {parts.netloc} timed out") from None
        except OSError as e:
            raise ClientConnectionError(
                f"cannot connect to {parts.netloc}: {e!r}") from e
        try:
            head = [f"{method} {target} HTTP/1.1"]
            head += [f"{k}: {v}" for k, v in hdrs.items()]
            writer.write(("\r\n".join(head) + "\r\n\r\n").encode("latin-1")
                         + (data or b""))
            await writer.drain()
            conn = _Reader(reader)
            while True:
                line, rhead = await _read_head(conn)
                fields = line.split(None, 2)
                if len(fields) < 2 or not fields[0].startswith("HTTP/"):
                    raise ClientPayloadError(f"bad status line {line!r}")
                status = int(fields[1])
                if status != 100:
                    break
            return ClientResponse(conn, writer, method, status, rhead)
        except asyncio.IncompleteReadError:
            writer.close()
            raise ClientConnectionError(
                "server disconnected before the response head") from None
        except (ConnectionError, OSError) as e:
            writer.close()
            raise ClientConnectionError(f"connection broke: {e!r}") from e
        except (_BadRequest, ValueError) as e:
            writer.close()
            raise ClientPayloadError(f"malformed response: {e}") from e
        except BaseException:
            writer.close()
            raise

    async def post(self, url: str, data: bytes = None, json=None,
                   headers: Optional[dict] = None) -> ClientResponse:
        return await self.request("POST", url, data=data, json_body=json,
                                  headers=headers)

    async def close(self) -> None:
        self.closed = True
