"""OpenAI-compatible HTTP server for the port, on the standard library.

Counterpart of ``production_stack_tpu/server/api_server.py`` (which runs on
aiohttp) for what an engine behind the stack's router serves:

  * POST /v1/completions, POST /v1/chat/completions — JSON, or SSE with
    ``stream: true`` (events ``data: {...}`` ending in ``data: [DONE]``);
    ``max_tokens``, ``temperature``, ``top_p``, ``top_k``, ``seed``,
    ``stop``, ``ignore_eos``, presence/frequency penalties,
    ``stream_options.include_usage``, ``logprobs`` (completions: an int in
    [0, 5]; chat: a bool with ``top_logprobs`` in [0, 20]), ``n`` in
    [1, 16] (choice i samples with seed + i), multi-prompt completions
    (a list of strings or of token-id lists; choices prompt-major), and
    mid-stream resume (``resume_tokens``, ``resume_seed``);
  * GET /v1/models, /health, /metrics (Prometheus text, the reference's
    series), /version;
  * the KV tier's routes: GET /prefix_index (the device prefix index's
    digest, which the router's prefix-aware routing polls), POST /prewarm
    (pull the shared tier's hottest chains into the device prefix cache)
    and POST /disagg/prefill (the prefill hop of a disaggregated request:
    prefill, sample token 1, publish KV under the transfer key);
  * POST /v1/embeddings (mean-pooled, L2-normalised trunk states; ``input``
    a string or a list of strings) and POST /v1/rerank, /rerank (documents
    ordered by cosine similarity to the query, ``top_n``);
  * tool calling on chat completions (``tools``, ``tool_choice``;
    ``server/tool_calling.py``): schemas injected into the system message,
    a forced choice's JSON prefix appended to the prompt, ``tool_calls``
    parsed from the output (one buffered delta when streaming) with
    finish_reason "tool_calls";
  * the debug surface, registered only with ``debug_endpoints`` (else every
    /debug route is a plain 404): GET /debug/requests/{id} (a request's
    flight-recorder timeline and phases, by the engine's id, the client's
    ``x-request-id`` or the response id), GET /debug/timeline (recent
    requests, newest first; ``max_requests`` clamped to [0, 1024]), POST
    /debug/profile (a bounded torch.profiler window, ``duration_s`` in (0,
    300], 409 while one runs) and GET /debug/profile (its status), and the
    port's own GET /debug/kernels (the paged kernel's launch counts from
    its device counter, with ``engine.stats()``) and POST
    /debug/kernels/reset (set the counts to 0).

Tracing: with ``OTEL_EXPORTER_OTLP_ENDPOINT`` set (``OTEL_SERVICE_NAME``
names the service) every /v1 request is an OTLP server span "engine
<path>" continuing the client's ``traceparent``, and each of its requests'
recorder phases is exported as an "engine.<phase>" child span when it ends
(``tracing.py``).

The router's contract: bearer auth on /v1/*, /disagg/*, /debug/* and
/rerank when ``--api-key`` is set (401 otherwise); ``--max-queue-len`` sheds generation requests with 503 and
``Retry-After`` while the wait queue is that deep; SIGTERM drains (/health
turns 503 ``draining``, new POSTs 503, in-flight requests finish or are
aborted at ``--drain-timeout``; a second SIGTERM exits at once); with the
``x-pstpu-resume`` request header every streamed chunk of a single-choice
request carries ``pstpu: {toks, off, seed}``, what the router needs to
resume the stream on another engine. A role-split engine (``--role
prefill|decode``) answers plain generation requests 503 ``wrong_role``
unless they carry ``x-pstpu-disagg-fallback``; a decode hop arrives with
``x-pstpu-disagg: decode`` and ``x-pstpu-transfer-key`` on either
completion route, and its stream continues the published one.

HTTP/1.1 with one request per connection (``Connection: close``); a
streamed response is close-delimited.

Run: ``python -m production_stack_tpu_torch.server.api_server --model
llama-3b --port 8000`` (on the card; ``--device cpu`` for a CPU run).
``--model`` is a named config (random weights from ``--seed``) or a local
HuggingFace checkpoint directory (its weights, and its tokenizer where
``transformers`` loads it); ``--lora-modules NAME=PATH ...`` serves PEFT
adapters beside it, picked per request by ``model=NAME`` and listed on
/v1/models. With
``--tensor-parallel-size N`` the server process is tp rank 0 and starts N-1
worker processes (NCCL when the machine has N cards, gloo when the ranks
share one). ``--kv-offload-cpu`` and ``--kv-remote-url kv://host:port``
(the port's cache server: ``python -m
production_stack_tpu_torch.kv_offload.server``) turn the offload tiers on.
"""

import argparse
import asyncio
import contextvars
import hmac
import json
import os
import signal
import time
from dataclasses import replace
from typing import Optional, Tuple
from urllib.parse import parse_qs, unquote

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.disagg.transfer import (
    DISAGG_ENDPOINT_HEADER,
    DISAGG_FALLBACK_HEADER,
    DISAGG_KEY_HEADER,
    DISAGG_ROLE_HEADER,
    ENGINE_ROLES,
    RESUME_HEADER,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams, seed_base
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.profiling import (
    DeviceProfiler,
    ProfilerBusy,
    ProfilerNotReady,
)
from production_stack_tpu_torch.server.metrics import render_engine_metrics
from production_stack_tpu_torch.server.tool_calling import (
    StreamingToolBuffer,
    build_tool_context,
    inject_tool_messages,
    parse_tool_calls,
    validate_tools,
)
from production_stack_tpu_torch.tracing import get_tracer, reset_tracer
from production_stack_tpu_torch.utils import init_logger, random_uuid

logger = init_logger(__name__)

VERSION = "0.1.0"
_REASONS = {200: "OK", 400: "Bad Request", 401: "Unauthorized",
            404: "Not Found", 405: "Method Not Allowed", 409: "Conflict",
            413: "Payload Too Large", 500: "Internal Server Error",
            501: "Not Implemented", 503: "Service Unavailable"}
_MAX_BODY = 16 << 20
_TRACER_NAME = "pstpu-engine"
_DEBUG_REQUESTS = "/debug/requests/"
# Per request (each connection is its own task): the server span of a /v1
# request while tracing is on, and the status its response head carried.
_TRACE_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "pstpu_trace_span", default=None)
_STATUS: contextvars.ContextVar = contextvars.ContextVar(
    "pstpu_response_status", default=None)


def _error_body(status: int, message: str,
                etype: str = "invalid_request_error") -> dict:
    return {"error": {"message": message, "type": etype, "code": status,
                      "param": None}}


def _sse(obj: dict) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


class _HttpError(Exception):
    def __init__(self, status: int, message: str,
                 etype: str = "invalid_request_error",
                 headers: Optional[dict] = None):
        super().__init__(message)
        self.status, self.message, self.etype = status, message, etype
        self.headers = headers or {}


class OpenAIServer:
    def __init__(self, engine: ServingEngine, host: str = "127.0.0.1",
                 port: int = 8000, api_key: Optional[str] = None,
                 max_queue_len: int = 0, drain_timeout: float = 30.0):
        self.engine = engine
        self.host = host
        self.port = port
        self.model_name = engine.config.model_name
        self.api_key = api_key
        self.max_queue_len = max_queue_len
        self.drain_timeout = drain_timeout
        self._server: Optional[asyncio.base_events.Server] = None
        self._draining = False
        self._inflight = 0
        self._drained = asyncio.Event()
        self._drain_task: Optional[asyncio.Task] = None
        self.on_drained = None    # called after a SIGTERM drain (main: exit)
        self.on_second_sigterm = None
        # POST /debug/profile's torch.profiler window, armed and stopped on
        # the engine's worker thread; None without the debug surface.
        self.profiler = None
        if engine.config.debug_endpoints:
            self.profiler = DeviceProfiler(
                executor=engine._executor, lock=engine.runner.kv_io_lock,
                not_ready=lambda: (None if self.engine.is_healthy else
                                   "the engine is not serving yet (warm-up)"))

    async def start(self) -> None:
        """Start the engine loop and listen; ``port=0`` picks a free port
        (read it back from ``self.port``)."""
        await self.engine.start()
        self._drained = asyncio.Event()
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("Serving %s on http://%s:%d", self.model_name,
                    self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            try:
                # Waits for open connections; a stuck client does not hold
                # the exit.
                await asyncio.wait_for(self._server.wait_closed(), 5.0)
            except asyncio.TimeoutError:
                logger.warning("stopping with connections still open")
            self._server = None
        if self.profiler is not None:
            await self.profiler.close()
        await self.engine.stop()
        reset_tracer()  # posts the spans still queued

    # ---------------------------------------------------------------- drain
    def install_signal_handlers(self, loop) -> None:
        """SIGTERM drains; a second SIGTERM aborts what is in flight and
        calls ``on_second_sigterm`` (main: exit)."""
        loop.add_signal_handler(signal.SIGTERM, self._on_sigterm)

    def _on_sigterm(self) -> None:
        if self._drain_task is not None:
            logger.warning("Second SIGTERM: exiting without finishing drain")
            for rid in self.engine.active_request_ids():
                self.engine.abort(rid)
            if self.on_second_sigterm is not None:
                self.on_second_sigterm()
            return
        self._drain_task = asyncio.ensure_future(self._drain_and_exit())

    async def _drain_and_exit(self) -> None:
        await self.drain()
        if self.on_drained is not None:
            self.on_drained()

    async def drain(self) -> None:
        """Stop admitting; let in-flight requests finish for up to
        ``drain_timeout``, then abort the rest (aborts land between
        dispatches: an issued dispatch is fetched and its blocks freed)."""
        if self._draining:
            return
        self._draining = True
        if self._inflight == 0:
            self._drained.set()
        logger.info("Drain: admission stopped, %d request(s) in flight",
                    self._inflight)
        try:
            await asyncio.wait_for(self._drained.wait(), self.drain_timeout)
            logger.info("Drain complete: all in-flight requests finished")
        except asyncio.TimeoutError:
            stale = self.engine.active_request_ids()
            logger.warning("Drain timeout after %.1f s: aborting %d "
                           "request(s)", self.drain_timeout, len(stale))
            for rid in stale:
                self.engine.abort(rid)
            try:
                await asyncio.wait_for(self._drained.wait(), 5.0)
            except asyncio.TimeoutError:
                logger.warning("Drain: %d handler(s) still active at exit",
                               self._inflight)

    # ---------------------------------------------------------------- HTTP
    async def _read_request(self, reader) -> Tuple[str, str, str, dict, bytes]:
        line = await reader.readline()
        parts = line.decode("latin-1").strip().split()
        if len(parts) != 3:
            raise _HttpError(400, "malformed request line")
        method, target, _version = parts
        headers = {}
        while True:
            h = await reader.readline()
            if h in (b"\r\n", b"\n", b""):
                break
            name, _, value = h.decode("latin-1").partition(":")
            headers[name.strip().lower()] = value.strip()
        n = int(headers.get("content-length", "0") or 0)
        if n > _MAX_BODY:
            raise _HttpError(413, "request body too large")
        body = await reader.readexactly(n) if n else b""
        path, _, query = target.partition("?")
        return method, path, query, headers, body

    @staticmethod
    def _head(status: int, content_type: str, headers: Optional[dict] = None,
              length: Optional[int] = None) -> bytes:
        _STATUS.set(status)
        extra = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
        if length is not None:
            extra += f"Content-Length: {length}\r\n"
        return (
            f"HTTP/1.1 {status} {_REASONS.get(status, 'Error')}\r\n"
            f"Content-Type: {content_type}\r\nConnection: close\r\n"
            f"{extra}\r\n"
        ).encode()

    async def _send(self, writer, status: int, body: bytes,
                    content_type: str, headers: Optional[dict] = None) -> None:
        writer.write(self._head(status, content_type, headers, len(body)))
        writer.write(body)
        await writer.drain()

    async def _send_json(self, writer, status: int, obj: dict,
                         headers: Optional[dict] = None) -> None:
        await self._send(writer, status, json.dumps(obj).encode(),
                         "application/json", headers)

    async def _handle(self, reader, writer) -> None:
        try:
            try:
                method, path, query, headers, body = \
                    await self._read_request(reader)
                await self._route(writer, method, path, query, headers, body)
            except _HttpError as e:
                await self._send_json(writer, e.status,
                                      _error_body(e.status, e.message, e.etype),
                                      e.headers)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass  # client went away; generate()'s cleanup aborted its work
        except Exception as e:  # noqa: BLE001 — one bad request, not the server
            logger.exception("Request failed")
            try:
                await self._send_json(writer, 500, _error_body(
                    500, str(e), "internal_error"))
            except ConnectionError:
                pass
        finally:
            writer.close()

    def _routes(self, query: str) -> dict:
        routes = {
            ("GET", "/health"): self.health,
            ("GET", "/metrics"): self.metrics,
            ("GET", "/version"): self.version,
            ("GET", "/v1/models"): self.models,
            ("GET", "/prefix_index"):
                lambda w, h, b: self.prefix_index(w, parse_qs(query)),
            ("POST", "/prewarm"): self.prewarm,
            ("POST", "/disagg/prefill"): self.disagg_prefill,
            ("POST", "/v1/completions"): self.completions,
            ("POST", "/v1/chat/completions"): self.chat_completions,
            ("POST", "/v1/embeddings"): self.embeddings,
            ("POST", "/v1/rerank"): self.rerank,
            ("POST", "/rerank"): self.rerank,
        }
        if self.engine.config.debug_endpoints:
            # Not registered without the debug surface: /debug/* is then a
            # plain 404, like a path that never existed.
            routes.update({
                ("GET", "/debug/timeline"):
                    lambda w, h, b: self.debug_timeline(w, parse_qs(query)),
                ("POST", "/debug/profile"): self.debug_profile_start,
                ("GET", "/debug/profile"): self.debug_profile_status,
                ("GET", "/debug/kernels"): self.debug_kernels,
                ("POST", "/debug/kernels/reset"): self.debug_kernels_reset,
            })
        return routes

    def _match(self, method: str, path: str, query: str = ""):
        """The handler of a request, ``(writer, headers, body) -> None``;
        raises the 404 or 405."""
        routes = self._routes(query)
        handler = routes.get((method, path))
        if (handler is None and self.engine.config.debug_endpoints
                and path.startswith(_DEBUG_REQUESTS)
                and "/" not in path[len(_DEBUG_REQUESTS):]
                and path != _DEBUG_REQUESTS):
            # GET /debug/requests/{request_id}
            if method != "GET":
                raise _HttpError(405, f"{method} not allowed on {path}")
            rid = unquote(path[len(_DEBUG_REQUESTS):])
            return lambda w, h, b: self.debug_request(w, rid)
        if handler is None:
            if any(p == path for _, p in routes):
                raise _HttpError(405, f"{method} not allowed on {path}")
            raise _HttpError(404, f"route {path} not found")
        return handler

    async def _route(self, writer, method: str, path: str, query: str,
                     headers: dict, body: bytes) -> None:
        handler = self._match(method, path, query)
        tracer = get_tracer(_TRACER_NAME) if path.startswith("/v1") else None
        if tracer is None:
            await self._admit(writer, method, path, headers, body, handler)
            return
        # The engine's server span continues the caller's trace; the
        # request's phase spans parent under it (_emit_lifecycle_spans).
        span = tracer.start_span(
            f"engine {path}", parent=headers.get("traceparent"),
            attributes={"http.method": method, "model": self.model_name})
        _TRACE_SPAN.set(span)
        ok, status = True, None
        try:
            await self._admit(writer, method, path, headers, body, handler)
            status = _STATUS.get()
        except _HttpError as e:
            status = e.status
            raise
        except BaseException:
            ok = False
            raise
        finally:
            if status is not None:
                span.attributes["http.status_code"] = status
            tracer.end_span(span, ok=ok)

    async def _admit(self, writer, method: str, path: str, headers: dict,
                     body: bytes, handler) -> None:
        """Bearer auth, then (serving POSTs) the drain gate and the
        in-flight count, as the reference's middlewares."""
        if self.api_key and (path.startswith(("/v1", "/disagg", "/debug"))
                             or path == "/rerank"):
            got = headers.get("authorization", "")
            if not hmac.compare_digest(got.encode(),
                                       f"Bearer {self.api_key}".encode()):
                raise _HttpError(401, "Invalid or missing API key",
                                 "authentication_error")
        if method != "POST" or not (
                path.startswith(("/v1", "/disagg"))
                or path in ("/rerank", "/prewarm")):
            await handler(writer, headers, body)
            return
        if self._draining:
            raise _HttpError(503, "Server is draining (shutting down)",
                             "service_unavailable", {"Retry-After": "5"})
        self._inflight += 1
        try:
            await handler(writer, headers, body)
        finally:
            self._inflight -= 1
            if self._draining and self._inflight == 0:
                self._drained.set()

    # -------------------------------------------------------------- routes
    async def health(self, writer, headers: dict, body: bytes) -> None:
        if self._draining:
            await self._send_json(
                writer, 503, {"status": "draining", "inflight": self._inflight},
                {"Retry-After": "1"})
        elif self.engine.is_healthy:
            await self._send_json(writer, 200, {"status": "healthy"})
        else:
            await self._send_json(writer, 503, {"status": "unhealthy"},
                                  {"Retry-After": "1"})

    async def metrics(self, writer, headers: dict, body: bytes) -> None:
        text = render_engine_metrics(self.engine, self.model_name)
        await self._send(writer, 200, text.encode(), "text/plain")

    async def version(self, writer, headers: dict, body: bytes) -> None:
        await self._send_json(writer, 200, {"version": VERSION})

    async def prefix_index(self, writer, query: dict) -> None:
        """The device prefix index's digest: the first 16 hex chars of
        every content-addressed block hash and the block size they were
        chained at (the reference's ``/prefix_index``)."""
        try:
            max_entries = min(int(query.get("max_entries", ["8192"])[0]),
                              65536)
        except ValueError:
            raise _HttpError(400, "max_entries must be an integer")
        entries, truncated = self.engine.block_manager.prefix_digest(
            max_entries)
        await self._send_json(writer, 200, {
            "block_size": self.engine.config.block_size,
            "model": self.model_name,
            "entries": entries,
            "truncated": truncated,
        })

    async def debug_kernels(self, writer, headers: dict, body: bytes) -> None:
        """The paged kernel's launch counts by variant (its device counter,
        which counts graph replays; {} off the card), with the engine's
        stats, so a process driving this server can hold the counts to
        the decode steps. Waits for the device's queued work."""
        counts = (pa.launch_counts() if self.engine.runner.device.type == "cuda"
                  else {})
        await self._send_json(writer, 200, {"launch_counts": counts,
                                            "stats": self.engine.stats()})

    async def debug_kernels_reset(self, writer, headers: dict,
                                  body: bytes) -> None:
        if self.engine.runner.device.type == "cuda":
            pa.reset_launch_counts()
        await self._send_json(writer, 200, {"status": "ok"})

    # ------------------------------------------------- observability (debug)
    async def debug_request(self, writer, request_id: str) -> None:
        """A request's flight-recorder timeline: the engine's id, the
        client's x-request-id and the response id all resolve."""
        if self.engine.recorder is None:
            raise _HttpError(404, "Flight recorder disabled", "not_found")
        found = self.engine.recorder.get(request_id)
        if found is None:
            raise _HttpError(404, f"No flight record for {request_id!r} "
                                  f"(evicted from the ring, or never served "
                                  f"by this engine)", "not_found")
        await self._send_json(writer, 200, found)

    async def debug_timeline(self, writer, query: dict) -> None:
        """The most recent requests' summaries, newest first."""
        if self.engine.recorder is None:
            raise _HttpError(404, "Flight recorder disabled", "not_found")
        try:
            # Clamped both ways: 0 or less means none, never everything.
            max_requests = min(max(0, int(query.get("max_requests",
                                                     ["64"])[0])), 1024)
        except ValueError:
            raise _HttpError(400, "max_requests must be an integer")
        await self._send_json(writer, 200,
                              self.engine.recorder.timeline(max_requests))

    async def debug_profile_start(self, writer, headers: dict,
                                  raw: bytes) -> None:
        """Arm a bounded torch.profiler window (one at a time)."""
        if not self.profiler.available():
            raise _HttpError(404, "Device profiling unavailable", "not_found")
        body = self._parse(raw) if raw else {}
        duration = body.get("duration_s", 5.0)
        if isinstance(duration, bool) or not isinstance(
                duration, (int, float)) or not 0 < float(duration) <= 300:
            raise _HttpError(400, "'duration_s' must be a number in (0, 300]")
        trace_dir = body.get("trace_dir")
        if trace_dir is not None and not isinstance(trace_dir, str):
            raise _HttpError(400, "'trace_dir' must be a string path")
        try:
            info = await self.profiler.arm(float(duration),
                                           trace_dir=trace_dir)
        except ProfilerBusy as e:
            raise _HttpError(409, str(e), "conflict")
        except ProfilerNotReady as e:
            raise _HttpError(503, f"Profiler cannot start yet: {e}",
                             "service_unavailable", {"Retry-After": "1"})
        except Exception as e:  # noqa: BLE001 — a failed arm must not 500
            logger.exception("Device profiling arm failed")
            raise _HttpError(503, f"Profiler failed to start: {e}",
                             "service_unavailable", {"Retry-After": "1"})
        await self._send_json(writer, 200, {"status": "armed", **info})

    async def debug_profile_status(self, writer, headers: dict,
                                   body: bytes) -> None:
        await self._send_json(writer, 200, self.profiler.status())

    def _emit_lifecycle_spans(self, request_ids) -> None:
        """Export each request's recorder phases as OTLP spans under the
        /v1 request's server span (a no-op without tracing or a
        recorder)."""
        span = _TRACE_SPAN.get()
        rec = self.engine.recorder
        tracer = get_tracer(_TRACER_NAME)
        if span is None or rec is None or tracer is None:
            return
        for rid in request_ids:
            found = rec.get(rid)
            if not found:
                continue
            for record in found["records"]:
                for phase in record.get("phases", ()):
                    if phase["end"] < phase["start"]:
                        continue  # clock skew guard; zero length is valid
                    tracer.record_span(
                        f"engine.{phase['name']}", parent=span.traceparent,
                        start_s=phase["start"], end_s=phase["end"],
                        attributes={"request.id": rid, **phase["attrs"]})

    # ------------------------------------------------------------ embeddings
    def _check_base_model(self, body: dict) -> None:
        model = body.get("model", self.model_name)
        if model != self.model_name:
            raise _HttpError(404, f"Model '{model}' not found",
                             "model_not_found")

    async def embeddings(self, writer, headers: dict, raw: bytes) -> None:
        body = self._parse(raw)
        inputs = body.get("input")
        if inputs is None:
            raise _HttpError(400, "'input' is required")
        if isinstance(inputs, str):
            inputs = [inputs]
        if not inputs or not all(isinstance(x, str) for x in inputs):
            raise _HttpError(400, "'input' must be a string or list of "
                                  "strings")
        self._check_base_model(body)
        vecs, n_tokens = await self.engine.embed(inputs)
        await self._send_json(writer, 200, {
            "object": "list",
            "data": [{"object": "embedding", "index": i,
                      "embedding": vec.tolist()}
                     for i, vec in enumerate(vecs)],
            "model": self.model_name,
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })

    async def rerank(self, writer, headers: dict, raw: bytes) -> None:
        """Documents by cosine similarity of their embeddings to the
        query's (the embeddings are L2-normalised: a dot product)."""
        body = self._parse(raw)
        query = body.get("query")
        documents = body.get("documents")
        if not isinstance(query, str) or not isinstance(documents, list) \
                or not all(isinstance(d, str) for d in documents):
            raise _HttpError(400, "'query' (str) and 'documents' (list[str]) "
                                  "are required")
        self._check_base_model(body)
        if not documents:
            await self._send_json(writer, 200, {
                "id": random_uuid("rerank-"), "model": self.model_name,
                "results": [],
                "usage": {"prompt_tokens": 0, "total_tokens": 0}})
            return
        top_n = body.get("top_n")
        if top_n is None:
            top_n = len(documents)
        elif not isinstance(top_n, int) or top_n < 0:
            raise _HttpError(400, "'top_n' must be a non-negative integer")
        vecs, n_tokens = await self.engine.embed([query] + documents)
        scores = vecs[1:] @ vecs[0]
        order = scores.argsort()[::-1]
        await self._send_json(writer, 200, {
            "id": random_uuid("rerank-"),
            "model": self.model_name,
            "results": [{"index": int(i),
                         "document": {"text": documents[int(i)]},
                         "relevance_score": float(scores[int(i)])}
                        for i in order[:top_n]],
            "usage": {"prompt_tokens": n_tokens, "total_tokens": n_tokens},
        })

    async def prewarm(self, writer, headers: dict, raw: bytes) -> None:
        """Pull the shared KV tier's top-k hottest chains into the device
        prefix cache, between dispatches. Only KV bytes move: tokens never
        change."""
        body = self._parse(raw) if raw else {}
        top_k = body.get("top_k", 8)
        max_blocks = body.get("max_blocks", 256)
        for name, v in (("top_k", top_k), ("max_blocks", max_blocks)):
            if type(v) is not int or not 1 <= v <= 65536:
                raise _HttpError(400, f"'{name}' must be an integer in "
                                      f"[1, 65536]")
        result = await self.engine.prewarm(top_k=top_k, max_blocks=max_blocks)
        await self._send_json(writer, 200, {"status": "ok", **result})

    # ----------------------------------------------------- disagg (role split)
    def _role_gate(self, headers: dict) -> None:
        """503 (retryable) for a generation request a role-split engine
        does not serve end to end, unless the router flagged it as fallback
        or it is the decode hop this engine exists for."""
        role = self.engine.config.role
        if role == "unified" or headers.get(DISAGG_FALLBACK_HEADER):
            return
        if role == "decode" and headers.get(DISAGG_ROLE_HEADER) == "decode":
            return
        raise _HttpError(
            503, f"Engine serves disagg role {role!r}; plain generation "
                 f"requests must go to the unified pool (or carry "
                 f"{DISAGG_FALLBACK_HEADER})",
            "wrong_role", {"Retry-After": "1"})

    async def _fetch_handoff(self, headers: dict):
        """The decode hop's manifest (None when the request is not a decode
        hop). The bundle is read, checked against this engine's KV layout
        and only then consumed (delete-after-consume), so a bundle this
        engine cannot use stays for another."""
        if headers.get(DISAGG_ROLE_HEADER) != "decode":
            return None
        disagg = self.engine.disagg
        if disagg is None:
            raise _HttpError(503, "This engine has no disagg coordinator "
                                  "(--role)", "wrong_role",
                             {"Retry-After": "1"})
        key = headers.get(DISAGG_KEY_HEADER)
        if not key:
            raise _HttpError(400, f"{DISAGG_KEY_HEADER} header required")
        loop = asyncio.get_running_loop()
        mani = await loop.run_in_executor(None, disagg.fetch_handoff, key)
        if mani is None:
            raise _HttpError(503, f"Handoff transfer {key!r} unavailable",
                             "handoff_unavailable", {"Retry-After": "1"})
        cfg = self.engine.config
        if mani.finish_reason is None and (
                mani.block_size != cfg.block_size
                or mani.num_blocks > self.engine.block_manager.num_blocks - 1
                or len(mani.prompt_token_ids) >= cfg.max_model_len):
            raise _HttpError(503, "Handoff bundle incompatible with this "
                                  "engine's KV layout/capacity",
                             "handoff_incompatible", {"Retry-After": "1"})
        await loop.run_in_executor(None, disagg.consume_handoff, key)
        return mani

    async def disagg_prefill(self, writer, headers: dict, raw: bytes) -> None:
        """Hop 1 of a disaggregated request (router-internal, not
        streamed): prefill the prompt, sample token 1, publish KV and chain
        state under the transfer key, and report the outcome."""
        if self.engine.disagg is None:
            raise _HttpError(501, "Disagg handoff disabled (--role unified)",
                             "wrong_role")
        if self.engine.config.role == "decode":
            raise _HttpError(503, "Engine serves disagg role 'decode'; "
                                  "prefill hops belong to the prefill pool",
                             "wrong_role", {"Retry-After": "1"})
        key = headers.get(DISAGG_KEY_HEADER)
        if not key:
            raise _HttpError(400, f"{DISAGG_KEY_HEADER} header required")
        chat = headers.get(DISAGG_ENDPOINT_HEADER, "completions") == "chat"
        body = self._parse(raw)
        # A handoff carries no adapter (the reference's hop serves the base
        # model only).
        self._check(body, chat=chat, adapters=False)
        if chat:
            messages = body.get("messages")
            if not messages or not isinstance(messages, list):
                raise _HttpError(400, "'messages' is required")
            try:
                prompt = self.engine.tokenizer.apply_chat_template(
                    messages, add_generation_prompt=True)
            except (KeyError, TypeError) as e:
                raise _HttpError(400, f"Could not apply chat template: {e}")
            submit = {"prompt": prompt}
            sampling = SamplingParams.from_request(body,
                                                   default_max_tokens=256)
        else:
            prompt = body.get("prompt")
            if isinstance(prompt, list) and prompt and all(
                    type(x) is int for x in prompt):
                vocab = self.engine.tokenizer.vocab_size
                if any(not 0 <= t < vocab for t in prompt):
                    raise _HttpError(400, f"prompt token ids must be in "
                                          f"[0, {vocab})")
                submit = {"prompt_token_ids": list(prompt)}
            elif isinstance(prompt, str):
                submit = {"prompt": prompt}
            else:
                raise _HttpError(400, "disagg prefill requires a single "
                                      "string prompt or one list of token "
                                      "ids")
            sampling = SamplingParams.from_request(body, default_max_tokens=16)
        request_id = headers.get("x-request-id") or random_uuid("cmpl-")
        final = None
        try:
            async for out in self.engine.generate(
                    **submit, sampling=sampling, request_id=request_id,
                    handoff_key=key):
                final = out
        except ValueError as e:
            raise _HttpError(400, str(e))
        if final is None or final.finish_reason == "abort":
            raise _HttpError(503, "KV handoff publish failed",
                             "handoff_failed", {"Retry-After": "1"})
        await self._send_json(writer, 200, {
            "status": "handoff",
            "key": key,
            "finished": final.finish_reason != "handoff",
            "finish_reason": final.finish_reason,
            "prompt_tokens": final.num_prompt_tokens,
            "cached_tokens": final.num_cached_tokens,
        })

    def _served_models(self):
        """Base model plus registered LoRA adapter names: requesting
        model=<adapter> serves base + that adapter (vLLM --lora-modules
        convention; engine.lora_registry)."""
        names = [self.model_name]
        if self.engine.lora_registry is not None:
            names += self.engine.lora_registry.names
        return names

    def _lora_name(self, body: dict) -> Optional[str]:
        model = body.get("model", self.model_name)
        return model if model != self.model_name else None

    async def models(self, writer, headers: dict, body: bytes) -> None:
        created = int(time.time())
        await self._send_json(writer, 200, {"object": "list", "data": [{
            "id": name, "object": "model", "created": created,
            "owned_by": "production-stack-tpu", "root": None, "parent": None,
        } for name in self._served_models()]})

    @staticmethod
    def _parse(body: bytes) -> dict:
        try:
            obj = json.loads(body)
        except (json.JSONDecodeError, UnicodeDecodeError):
            raise _HttpError(400, "Request body is not valid JSON")
        if not isinstance(obj, dict):
            raise _HttpError(400, "Request body must be a JSON object")
        return obj

    def _check(self, body: dict, chat: bool, adapters: bool = True) -> None:
        """The model (the base model, or with ``adapters`` a registered LoRA
        adapter), and the reference's ``_check_unsupported``: 400 for an
        accepted but unimplemented parameter, never a silent drop."""
        model = body.get("model", self.model_name)
        served = self._served_models() if adapters else [self.model_name]
        if model not in served:
            raise _HttpError(404, f"Model '{model}' not found", "model_not_found")
        if body.get("logit_bias"):
            raise _HttpError(400, "'logit_bias' is not supported")
        if not chat and body.get("suffix"):
            raise _HttpError(400, "'suffix' is not supported")
        if not chat and body.get("echo"):
            raise _HttpError(400, "'echo' is not supported")
        n = body.get("n")
        if n is None:
            n = 1
        if not isinstance(n, int) or not 1 <= n <= 16:
            raise _HttpError(400, "'n' must be an integer in [1, 16]")
        best_of = body.get("best_of")
        if best_of is not None and best_of != n:
            raise _HttpError(400, "'best_of' != n is not supported")
        lp = body.get("logprobs")
        if chat:
            # A type check: 1 == True in Python.
            if lp is not None and type(lp) is not bool:
                raise _HttpError(400, "chat 'logprobs' must be a boolean "
                                      "(use 'top_logprobs' for the list width)")
            top = body.get("top_logprobs")
            if top is not None and (type(top) is not int or not 0 <= top <= 20):
                raise _HttpError(400, "'top_logprobs' must be in [0, 20]")
        elif lp is not None and (type(lp) is not int or not 0 <= lp <= 5):
            raise _HttpError(400, "'logprobs' must be an integer in [0, 5]")

    async def completions(self, writer, headers: dict, raw: bytes) -> None:
        self._role_gate(headers)
        body = self._parse(raw)
        prompt = body.get("prompt")

        def is_ids(p):
            return isinstance(p, list) and p and all(type(x) is int for x in p)

        if isinstance(prompt, str):
            prompts = [prompt]
        elif isinstance(prompt, list) and prompt and \
                all(isinstance(p, str) for p in prompt):
            prompts = list(prompt)
        elif is_ids(prompt):
            prompts = [list(prompt)]
        elif isinstance(prompt, list) and prompt and all(is_ids(p) for p in prompt):
            prompts = [list(p) for p in prompt]
        else:
            raise _HttpError(400, "'prompt' must be a non-empty string, list "
                                  "of strings, or list(s) of token ids")
        vocab = self.engine.tokenizer.vocab_size
        for p in prompts:
            if isinstance(p, list) and any(not 0 <= x < vocab for x in p):
                raise _HttpError(400, f"prompt token ids must be in [0, {vocab})")
        self._check(body, chat=False)
        sampling = SamplingParams.from_request(body, default_max_tokens=16)
        await self._generate(writer, headers, body, prompts, sampling,
                             chat=False,
                             handoff=await self._fetch_handoff(headers))

    async def chat_completions(self, writer, headers: dict, raw: bytes) -> None:
        self._role_gate(headers)
        body = self._parse(raw)
        messages = body.get("messages")
        if not messages or not isinstance(messages, list):
            raise _HttpError(400, "'messages' is required")
        self._check(body, chat=True)
        terr = validate_tools(body)
        if terr is not None:
            raise _HttpError(400, terr)
        tool_ctx = build_tool_context(body)
        try:
            if tool_ctx is not None:
                messages = inject_tool_messages(messages, tool_ctx)
            prompt = self.engine.tokenizer.apply_chat_template(
                messages, add_generation_prompt=True)
        except (KeyError, TypeError, ValueError, AttributeError) as e:
            # Malformed messages or tool history are the client's fault.
            raise _HttpError(400, f"Could not apply chat template: {e}")
        if tool_ctx is not None and tool_ctx.forced_prefix:
            # Prompt-side forcing: the assistant turn starts with the
            # call's JSON prefix (server/tool_calling.py).
            prompt += tool_ctx.forced_prefix
        sampling = SamplingParams.from_request(body, default_max_tokens=256)
        await self._generate(writer, headers, body, [prompt], sampling,
                             chat=True,
                             handoff=await self._fetch_handoff(headers),
                             tool_ctx=tool_ctx)

    # ------------------------------------------------------------ logprobs
    def _token_str(self, tid: int) -> str:
        return self.engine.tokenizer.decode([tid])

    def _completion_logprobs_slice(self, out, start: int, offset: int):
        """The completions-format logprobs block of tokens from ``start``,
        and the text offset after them (streamed chunks carry it on)."""
        tokens, token_lps, tops, offsets = [], [], [], []
        for tid, entry in zip(out.token_ids[start:],
                              (out.logprobs or [])[start:]):
            ts = self._token_str(tid)
            tokens.append(ts)
            offsets.append(offset)
            offset += len(ts)
            if entry is None:
                token_lps.append(None)
                tops.append(None)
                continue
            chosen, top = entry
            token_lps.append(chosen)
            tops.append({self._token_str(i): lp for i, lp in top} or None)
        return {"tokens": tokens, "token_logprobs": token_lps,
                "top_logprobs": tops, "text_offset": offsets}, offset

    def _chat_logprobs_content(self, out, start: int = 0) -> list:
        """The chat-format logprobs entries of tokens from ``start``."""
        content = []
        for tid, entry in zip(out.token_ids[start:],
                              (out.logprobs or [])[start:]):
            ts = self._token_str(tid)
            content.append({
                "token": ts,
                "logprob": entry[0] if entry else None,
                "bytes": list(ts.encode("utf-8")),
                "top_logprobs": [
                    {"token": self._token_str(i), "logprob": lp,
                     "bytes": list(self._token_str(i).encode("utf-8"))}
                    for i, lp in (entry[1] if entry else [])],
            })
        return content

    @staticmethod
    def _child_sampling(sampling: SamplingParams, c_idx: int,
                        num: int) -> SamplingParams:
        """Choice ``c_idx`` of a fan-out samples with seed + c_idx (an
        unseeded choice seeds from its own request id)."""
        if num == 1:
            return sampling
        return replace(sampling, seed=None if sampling.seed is None
                       else sampling.seed + c_idx)

    # ------------------------------------------------------------ generate
    def _check_resume(self, body: dict, sampling: SamplingParams,
                      num_choices: int, tool_ctx=None):
        """The request's resume tokens and seed, validated (the
        reference's rules)."""
        resume_tokens = body.get("resume_tokens")
        resume_seed = body.get("resume_seed")
        if resume_tokens is None:
            return None, None
        if not (isinstance(resume_tokens, list) and resume_tokens
                and all(type(t) is int for t in resume_tokens)):
            raise _HttpError(400, "'resume_tokens' must be a non-empty list "
                                  "of token ids")
        vocab = self.engine.tokenizer.vocab_size
        if any(not 0 <= t < vocab for t in resume_tokens):
            raise _HttpError(400, f"resume token ids must be in [0, {vocab})")
        if num_choices != 1:
            raise _HttpError(400, "mid-stream resume requires n=1 and a "
                                  "single prompt")
        if tool_ctx is not None:
            raise _HttpError(400, "mid-stream resume does not support tools")
        if len(resume_tokens) >= sampling.max_tokens:
            raise _HttpError(400, "resume_tokens must be shorter than "
                                  "max_tokens (the stream would already "
                                  "have finished)")
        if resume_seed is not None and type(resume_seed) is not int:
            raise _HttpError(400, "'resume_seed' must be an integer")
        return list(resume_tokens), resume_seed

    async def _generate(self, writer, headers: dict, body: dict, prompts: list,
                        sampling: SamplingParams, chat: bool,
                        handoff=None, tool_ctx=None) -> None:
        """Run len(prompts) * n generations and answer them as OpenAI
        choices (prompt-major), streamed or not. ``handoff``: a decode
        hop's manifest, whose token ids replace the prompt. ``tool_ctx``:
        the request's active tools (chat only)."""
        waiting = self.engine.scheduler.num_waiting
        if self.max_queue_len and waiting >= self.max_queue_len:
            raise _HttpError(503, f"Engine overloaded: {waiting} requests "
                                  f"waiting (bound {self.max_queue_len})",
                             "service_unavailable", {"Retry-After": "1"})
        request_id = random_uuid("chatcmpl-" if chat else "cmpl-")
        n = max(1, sampling.n)
        num_choices = len(prompts) * n
        resume_tokens, resume_seed = self._check_resume(body, sampling,
                                                        num_choices, tool_ctx)
        if handoff is not None and num_choices != 1:
            raise _HttpError(400, "disagg decode hop requires n=1 and a "
                                  "single prompt")
        fallback = bool(headers.get(DISAGG_FALLBACK_HEADER))
        n_resume = len(resume_tokens) if resume_tokens else 0
        max_len = self.engine.config.max_model_len
        for p in prompts:
            n_prompt = n_resume + (len(p) if isinstance(p, list)
                                   else len(self.engine.tokenizer.encode(p)))
            if n_prompt >= max_len:
                raise _HttpError(400, f"Prompt of {n_prompt} tokens (incl. "
                                      f"resume) exceeds max_model_len {max_len}")
        children = [
            (p_idx * n + c_idx, prompt,
             self._child_sampling(sampling, c_idx, num_choices),
             request_id if num_choices == 1
             else f"{request_id}-{p_idx * n + c_idx}")
            for p_idx, prompt in enumerate(prompts) for c_idx in range(n)]
        child_rids = [rid for *_, rid in children]
        if self.engine.recorder is not None:
            # The client's x-request-id and the response id both resolve to
            # the engine's per-choice ids on /debug/requests/{id}.
            ext = headers.get("x-request-id")
            if ext:
                self.engine.recorder.alias(ext, child_rids)
            if request_id != child_rids[0]:
                self.engine.recorder.alias(request_id, child_rids)

        lora = self._lora_name(body)

        def submit(prompt, sp, rid):
            kw = ({"prompt_token_ids": prompt} if isinstance(prompt, list)
                  else {"prompt": prompt})
            if lora is not None:
                kw["lora_adapter"] = lora
            if resume_tokens:
                kw.update(resume_tokens=resume_tokens, resume_seed=resume_seed)
            if handoff is not None:
                kw["handoff_state"] = handoff
            if fallback:
                kw["disagg_fallback"] = True
            return self.engine.generate(**kw, sampling=sp, request_id=rid)

        created = int(time.time())
        obj = ("chat.completion.chunk" if chat and body.get("stream")
               else "chat.completion" if chat else "text_completion")
        head = {"id": request_id, "object": obj, "created": created,
                "model": self.model_name}
        if body.get("stream"):
            await self._stream(writer, headers, body, sampling, chat, children,
                               submit, head, resume_tokens, resume_seed,
                               tool_ctx)
            self._emit_lifecycle_spans(child_rids)
            return

        async def collect(idx, prompt, sp, rid):
            text, final = "", None
            async for out in submit(prompt, sp, rid):
                text += out.text_delta
                final = out
            return idx, text, final

        try:
            results = await asyncio.gather(
                *[collect(*child) for child in children])
        except ValueError as e:
            for *_, rid in children:
                self.engine.abort(rid)
            raise _HttpError(400, str(e))
        choices, finals = [], []
        for idx, text, final in sorted(results, key=lambda r: r[0]):
            finals.append(final)
            if chat:
                tool_calls = None
                if tool_ctx is not None:
                    tool_calls = parse_tool_calls(
                        tool_ctx.full_text(text),
                        valid_names={t["function"]["name"]
                                     for t in tool_ctx.tools})
                if tool_calls is not None:
                    choice = {"index": idx,
                              "message": {"role": "assistant",
                                          "content": None,
                                          "tool_calls": tool_calls},
                              "finish_reason": "tool_calls"}
                else:
                    choice = {"index": idx,
                              "message": {"role": "assistant",
                                          "content": text},
                              "finish_reason": final.finish_reason}
                if sampling.logprobs is not None:
                    choice["logprobs"] = {
                        "content": self._chat_logprobs_content(final)}
            else:
                choice = {"index": idx, "text": text,
                          "finish_reason": final.finish_reason,
                          "logprobs": (
                              self._completion_logprobs_slice(final, 0, 0)[0]
                              if final.logprobs is not None else None)}
            choices.append(choice)
        self._emit_lifecycle_spans(child_rids)
        await self._send_json(writer, 200, {**head, "choices": choices,
                                            "usage": self._usage(finals)})

    async def _stream(self, writer, headers: dict, body: dict,
                      sampling: SamplingParams, chat: bool, children, submit,
                      head: dict, resume_tokens, resume_seed,
                      tool_ctx=None) -> None:
        num_choices = len(children)
        writer.write(self._head(200, "text/event-stream", {
            "Cache-Control": "no-cache", "x-request-id": head["id"]}))
        queue: asyncio.Queue = asyncio.Queue()

        async def pump(idx, prompt, sp, rid):
            try:
                async for out in submit(prompt, sp, rid):
                    await queue.put((idx, out, None))
            except Exception as e:  # noqa: BLE001 — relayed to the writer
                await queue.put((idx, None, e))

        tasks = [asyncio.ensure_future(pump(*child)) for child in children]
        n_resume = len(resume_tokens) if resume_tokens else 0
        want_lp = sampling.logprobs is not None
        # With stop strings a later match can trim tokens already sampled,
        # and with tools the text may turn out to be a call: the logprob
        # entries ride the finishing chunk.
        defer_lp = want_lp and (bool(sampling.stop) or tool_ctx is not None)
        # With tools, a choice's text is held until it cannot be a call.
        tool_bufs = ([StreamingToolBuffer(tool_ctx) for _ in range(num_choices)]
                     if tool_ctx is not None else None)
        # A resumed stream's client holds the role delta and the resumed
        # tokens already.
        first_sent = [bool(resume_tokens)] * num_choices
        lp_sent = [n_resume] * num_choices
        lp_offset = [0] * num_choices
        tok_sent = [n_resume] * num_choices
        meta = num_choices == 1 and bool(headers.get(RESUME_HEADER))
        meta_seed = 0
        if meta:
            # A resumed request samples with the relayed seed, the base a
            # further resume must carry on.
            meta_seed = (int(resume_seed) & 0xFFFFFFFF
                         if resume_tokens and resume_seed is not None
                         else seed_base(children[0][3], children[0][2]))
        finals = {}
        try:
            remaining = num_choices
            while remaining:
                idx, out, exc = await queue.get()
                if exc is not None:
                    raise exc
                finals[idx] = out
                remaining -= out.finished
                ready = bool(out.text_delta) or out.finished
                send_lp = (want_lp and out.logprobs is not None and ready
                           and (not defer_lp or out.finished))
                if chat:
                    content = out.text_delta
                    if tool_bufs is not None and content:
                        content = tool_bufs[idx].feed(content)
                    delta = {}
                    if not first_sent[idx] and (out.text_delta
                                                or not out.finished):
                        delta["role"] = "assistant"
                        first_sent[idx] = True
                    if content:
                        delta["content"] = content
                    finish_reason = out.finish_reason
                    if tool_bufs is not None and out.finished:
                        calls, residual = tool_bufs[idx].finish()
                        if calls is not None:
                            delta.pop("content", None)
                            delta["tool_calls"] = [{**c, "index": i}
                                                   for i, c in enumerate(calls)]
                            finish_reason = "tool_calls"
                        elif residual:
                            delta["content"] = delta.get("content", "") + residual
                    choice = {"index": idx, "delta": delta,
                              "finish_reason": finish_reason}
                    if send_lp:
                        new = self._chat_logprobs_content(out, lp_sent[idx])
                        lp_sent[idx] = len(out.token_ids)
                        if new:
                            choice["logprobs"] = {"content": new}
                    write_now = bool(delta) or out.finished
                else:
                    choice = {"index": idx, "text": out.text_delta,
                              "finish_reason": out.finish_reason}
                    if send_lp:
                        block, lp_offset[idx] = self._completion_logprobs_slice(
                            out, lp_sent[idx], lp_offset[idx])
                        lp_sent[idx] = len(out.token_ids)
                        if block["tokens"]:
                            choice["logprobs"] = block
                    write_now = ready
                if not write_now:
                    continue
                payload = {**head, "choices": [choice]}
                if meta:
                    # A stop-string trim can shrink token_ids below what was
                    # sent: the payload never claims unproduced tokens.
                    start = min(tok_sent[idx], len(out.token_ids))
                    payload["pstpu"] = {"toks": list(out.token_ids[start:]),
                                        "off": start, "seed": meta_seed}
                    tok_sent[idx] = len(out.token_ids)
                writer.write(_sse(payload))
                await writer.drain()
            if finals and (body.get("stream_options") or {}).get(
                    "include_usage"):
                writer.write(_sse({**head, "choices": [],
                                   "usage": self._usage(finals.values())}))
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        except (ConnectionError, asyncio.CancelledError):
            for *_, rid in children:
                self.engine.abort(rid)
            raise
        except Exception as e:  # noqa: BLE001 — headers are out: an SSE error
            for *_, rid in children:
                self.engine.abort(rid)
            logger.exception("Streaming generation failed")
            writer.write(_sse({"error": {"message": str(e),
                                         "type": "internal_error"}}))
            writer.write(b"data: [DONE]\n\n")
            await writer.drain()
        finally:
            for t in tasks:
                t.cancel()

    @staticmethod
    def _usage(outs) -> dict:
        """Usage summed over every choice."""
        outs = list(outs)
        p = sum(o.num_prompt_tokens for o in outs)
        c = sum(o.num_output_tokens for o in outs)
        return {"prompt_tokens": p, "completion_tokens": c,
                "total_tokens": p + c}


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="OpenAI-compatible server (PyTorch port)")
    p.add_argument("--model", default="llama-3b")
    p.add_argument("--served-model-name", default=None,
                   help="name advertised on /v1/models and in responses "
                        "(default: --model)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16")
    p.add_argument("--kv-cache-dtype", default="bfloat16",
                   choices=["bfloat16", "int8"],
                   help="KV-cache storage dtype: int8 stores K/V with "
                        "per-(slot, head) bf16 scales (~2x the blocks per "
                        "byte, half the decode kernel's pool bytes)")
    p.add_argument("--max-model-len", type=int, default=4096)
    p.add_argument("--block-size", type=int, default=16,
                   help="KV cache block size in tokens")
    p.add_argument("--num-kv-blocks", type=int, default=None,
                   help="KV pool size in blocks (default: sized from "
                        "--gpu-memory-utilization)")
    p.add_argument("--gpu-memory-utilization", type=float, default=0.9,
                   help="fraction of the card's free memory for the KV "
                        "pool (vLLM-compatible flag name)")
    p.add_argument("--no-enable-prefix-caching", action="store_true",
                   help="disable hash-chained prefix caching")
    p.add_argument("--max-num-seqs", type=int, default=64)
    p.add_argument("--max-num-batched-tokens", type=int, default=None,
                   help="prefill chunk token budget (default: EngineConfig "
                        "tuned value)")
    p.add_argument("--num-decode-steps", type=int, default=32)
    p.add_argument("--decode-loop", default="scan", choices=["scan", "while"],
                   help="fused-decode loop: scan runs all K steps of a "
                        "dispatch, while runs only the steps some row needs")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip capturing the decode CUDA graphs at startup "
                        "(decode then runs eagerly)")
    p.add_argument("--no-overlap-dispatch", action="store_true",
                   help="one batch kind per scheduling round (no prefill "
                        "issued while a decode is in flight)")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="dispatches outstanding at once (1 = strict "
                        "issue-fetch-apply; clamped to 2)")
    p.add_argument("--attn-impl", default="auto",
                   choices=["auto", "window", "paged", "xla", "pallas"],
                   help="decode attention path: auto picks the paged "
                        "flash-decode kernel on the card when it takes the "
                        "model, else the gathered window ('xla' and "
                        "'pallas' are the reference's names of window and "
                        "paged)")
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="tp ranks, one process each (heads split over them; "
                        "tp must divide both head counts)")
    p.add_argument("--sequence-parallel-size", type=int, default=1,
                   help="sp degree (ring-attention prefill): not ported "
                        "yet, 1 only")
    p.add_argument("--data-parallel-size", type=int, default=1,
                   help="dp replica count within this process: not ported "
                        "yet, 1 only")
    p.add_argument("--compilation-cache-dir", default=None,
                   help="the reference's persistent compile-cache "
                        "directory: a persistent graph cache is not ported "
                        "yet, so only unset or an empty string (disabled) "
                        "is accepted")
    p.add_argument("--no-overlap-weight-load", action="store_true",
                   help="load weights serially before warm-up: the port "
                        "always does (the reference overlaps the checkpoint "
                        "read with its compile prepass)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--api-key", default=os.environ.get("VLLM_API_KEY"),
                   help="require 'Authorization: Bearer <key>' on /v1/* "
                        "(default: $VLLM_API_KEY)")
    p.add_argument("--max-queue-len", type=int, default=0,
                   help="answer generation requests 503 + Retry-After while "
                        "the wait queue is at least this deep (0: never)")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="seconds a SIGTERM drain waits for in-flight "
                        "requests before aborting them")
    p.add_argument("--role", default="unified", choices=list(ENGINE_ROLES),
                   help="prefill/decode disaggregation role: 'prefill' "
                        "computes prompt KV + token 1 and publishes them to "
                        "the remote KV store; 'decode' restores published "
                        "KV and continues the stream; a non-unified role "
                        "requires --kv-remote-url or LMCACHE_REMOTE_URL")
    p.add_argument("--kv-remote-url", default=None,
                   help="shared KV store URL (kv://host:port) for the "
                        "offload tier and the disagg handoff (default: "
                        "$LMCACHE_REMOTE_URL)")
    p.add_argument("--kv-offload-cpu", action="store_true", default=None,
                   help="spill full KV blocks to a host-RAM tier and restore "
                        "from it (default: $LMCACHE_LOCAL_CPU == 'true')")
    p.add_argument("--kv-offload-max-cpu-gb", type=float, default=None,
                   help="host-RAM tier size in GB (default: "
                        "$LMCACHE_MAX_LOCAL_CPU_SIZE, else 4)")
    p.add_argument("--hbm-peak-gbps", type=float, default=None,
                   help="the card's peak HBM bandwidth in GB/s, the ceiling "
                        "of pstpu:live_hbm_bw_pct (default: looked up from "
                        "the card's name; H100 SXM 3350)")
    p.add_argument("--speculative-num-tokens", type=int, default=0,
                   help="speculative decoding: draft-ahead tokens N per "
                        "verify (0 disables). Spec-on output is "
                        "token-identical to spec-off for greedy and seeded "
                        "sampling; requires --speculative-model, the window "
                        "attention path, bf16 KV cache and tp=1")
    p.add_argument("--speculative-model", default=None,
                   help="the draft model (a named config; the target itself "
                        "for a self-draft); must share the target's "
                        "vocabulary — a mismatch is a clean startup error")
    p.add_argument("--speculative-draft-window", type=int, default=None,
                   help="draft-KV ring length in tokens per sequence "
                        "(default: EngineConfig's, 1024; 0 = full context)")
    p.add_argument("--speculative-adaptive", action="store_true",
                   help="per-sequence adaptive draft depth: an acceptance "
                        "EMA picks each row's gamma every dispatch; a batch "
                        "whose rows all sit at gamma 0 runs the plain decode "
                        "train. Requires --speculative-num-tokens > 0")
    p.add_argument("--lora-modules", nargs="*", default=[],
                   metavar="NAME=PATH",
                   help="LoRA adapters to serve (vLLM convention): "
                        "requests with model=NAME get base + adapter")
    p.add_argument("--speculative-tree-width", type=int, default=1,
                   help="token-tree width W: W - 1 extra depth-1 alternates "
                        "from the draft's own top-k in the same verify "
                        "forward (1 = linear speculation; max 8). Requires "
                        "--speculative-num-tokens > 0")
    p.add_argument("--flight-recorder-capacity", type=int, default=None,
                   help="flight-recorder ring size in request records "
                        "(default: EngineConfig tuned value, 256)")
    p.add_argument("--flight-recorder-max-events", type=int, default=None,
                   help="max events kept per flight record before overflow "
                        "counting starts (default: EngineConfig tuned "
                        "value, 512)")
    p.add_argument("--no-debug-endpoints", action="store_true",
                   help="disable the /debug surface (flight-recorder "
                        "timelines at /debug/requests/{id} and "
                        "/debug/timeline, torch.profiler captures at "
                        "/debug/profile, kernel counts at /debug/kernels): "
                        "/debug/* then 404s and nothing is recorded")
    return p.parse_args(argv)


def _parse_lora_modules(items) -> dict:
    """--lora-modules NAME=PATH entries -> dict, with a usable error."""
    out = {}
    for kv in items or []:
        if "=" not in kv:
            raise SystemExit(
                f"--lora-modules entries must be NAME=PATH (got {kv!r})"
            )
        name, path = kv.split("=", 1)
        out[name] = path
    return out


def config_from_args(args: argparse.Namespace) -> EngineConfig:
    """The engine's config from the server's flags."""
    return EngineConfig(
        model=args.model, served_model_name=args.served_model_name,
        device=args.device, dtype=args.dtype,
        kv_cache_dtype=args.kv_cache_dtype, max_model_len=args.max_model_len,
        block_size=args.block_size, num_kv_blocks=args.num_kv_blocks,
        hbm_utilization=args.gpu_memory_utilization,
        enable_prefix_caching=not args.no_enable_prefix_caching,
        max_num_seqs=args.max_num_seqs,
        num_decode_steps=args.num_decode_steps, decode_loop=args.decode_loop,
        enable_warmup=not args.no_warmup, pipeline_depth=args.pipeline_depth,
        overlap_dispatch=not args.no_overlap_dispatch,
        attn_impl=args.attn_impl, seed=args.seed,
        tensor_parallel_size=args.tensor_parallel_size,
        sequence_parallel_size=args.sequence_parallel_size,
        data_parallel_size=args.data_parallel_size,
        compilation_cache_dir=args.compilation_cache_dir,
        debug_endpoints=not args.no_debug_endpoints,
        hbm_peak_gbps=args.hbm_peak_gbps, role=args.role,
        speculative_num_tokens=args.speculative_num_tokens,
        speculative_model=args.speculative_model,
        speculative_adaptive=args.speculative_adaptive,
        speculative_tree_width=args.speculative_tree_width,
        # Unset flags keep the config's (environment) defaults.
        **{k: v for k, v in (
            ("kv_remote_url", args.kv_remote_url),
            ("kv_offload_cpu", args.kv_offload_cpu),
            ("kv_offload_max_cpu_gb", args.kv_offload_max_cpu_gb),
            ("speculative_draft_window", args.speculative_draft_window),
            ("max_num_batched_tokens", args.max_num_batched_tokens),
            ("flight_recorder_capacity", args.flight_recorder_capacity),
            ("flight_recorder_max_events", args.flight_recorder_max_events))
           if v is not None},
        lora_modules=_parse_lora_modules(args.lora_modules),
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = config_from_args(args)

    async def run():
        engine = ServingEngine(cfg)
        server = OpenAIServer(engine, args.host, args.port,
                              api_key=args.api_key,
                              max_queue_len=args.max_queue_len,
                              drain_timeout=args.drain_timeout)
        done = asyncio.Event()
        server.on_drained = done.set
        server.on_second_sigterm = done.set
        await server.start()
        server.install_signal_handlers(asyncio.get_running_loop())
        try:
            await done.wait()
        finally:
            await server.stop()
            engine.shutdown()

    asyncio.run(run())


if __name__ == "__main__":
    main()
