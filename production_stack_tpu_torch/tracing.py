"""Distributed tracing: OTLP/HTTP export and W3C trace-context propagation.

Counterpart of ``production_stack_tpu/tracing.py``, the same spans, wire
format and environment: configured by ``OTEL_EXPORTER_OTLP_ENDPOINT``
(enables) and ``OTEL_SERVICE_NAME`` (names), dependency-free. Spans are
exported as OTLP/HTTP JSON (the protocol's JSON mapping) from a background
thread, and cross-service context rides the W3C ``traceparent`` header: the
router starts a trace per request and the engine continues it, so one
trace covers route, proxy and engine handling, down to the engine's
per-request phases (``engine/flight_recorder.py:phases``).

Without ``OTEL_EXPORTER_OTLP_ENDPOINT`` every call is a no-op costing a
None check. A full export queue drops the span and counts it
(``spans_dropped_total``, rendered as ``pstpu:trace_spans_dropped_total``):
tracing never blocks serving.
"""

import json
import os
import queue
import secrets
import threading
import time
import urllib.request
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_FLUSH_INTERVAL_S = 2.0
_MAX_BATCH = 256

# OTLP span kinds (the two this stack emits): the serving side of an RPC
# vs the router's OUTBOUND proxy hop — collectors draw service graphs from
# this distinction, so the router's backend call must not claim SERVER.
SPAN_KIND_SERVER = 2
SPAN_KIND_CLIENT = 3


@dataclass
class Span:
    name: str
    trace_id: str                 # 32 hex chars
    span_id: str                  # 16 hex chars
    parent_span_id: Optional[str] = None
    start_ns: int = 0
    end_ns: int = 0
    attributes: Dict[str, object] = field(default_factory=dict)
    status_ok: bool = True
    kind: int = SPAN_KIND_SERVER
    # W3C trace-flags propagated from the incoming traceparent ("01" when
    # this process started the trace): hardcoding sampled here would
    # overrule an upstream not-sampled decision.
    flags: str = "01"
    # Span events: (name, time_ns, attributes) — retry/failover/resume
    # outcomes ride the span instead of being invisible in traces.
    events: List[tuple] = field(default_factory=list)

    def add_event(self, name: str,
                  attributes: Optional[Dict] = None) -> None:
        self.events.append((name, time.time_ns(), dict(attributes or {})))

    @property
    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"


def parse_traceparent(header: Optional[str]):
    """-> (trace_id, parent_span_id, trace_flags) or None (W3C
    trace-context v00).

    Strict: non-hex or all-zero ids are rejected (a malformed client header
    must start a fresh trace, not poison an OTLP export batch — collectors
    400 non-hex ids and the whole batch would be dropped). The trace-flags
    byte is propagated so a downstream span keeps the caller's sampled
    decision."""
    if not header:
        return None
    parts = header.split("-")
    if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
        return None
    trace_id, span_id = parts[1].lower(), parts[2].lower()
    # trace-flags is EXACTLY two hex chars; a short/long field is a
    # malformed header (fresh trace), not something to truncate and
    # re-emit as a non-conformant traceparent downstream.
    flags = parts[3].lower()
    if len(flags) != 2:
        return None
    try:
        t, s = int(trace_id, 16), int(span_id, 16)
        int(flags, 16)
    except ValueError:
        return None
    if t == 0 or s == 0:
        return None
    return trace_id, span_id, flags


class Tracer:
    """Per-process tracer with a background OTLP/HTTP JSON exporter."""

    def __init__(self, service_name: str, endpoint: str):
        self.service_name = service_name
        self.endpoint = endpoint.rstrip("/")
        self._queue: "queue.Queue[Span]" = queue.Queue(maxsize=4096)
        self._stop = threading.Event()
        # Queue-full spans are COUNTED, never silently dropped: exported as
        # pstpu:trace_spans_dropped_total / router_trace_spans_dropped_total
        # so an undersized exporter is visible on the dashboards. ``on_drop``
        # lets the router bump its prometheus_client counter in lockstep.
        self.spans_dropped_total = 0
        self.on_drop = None
        self._thread = threading.Thread(
            target=self._export_loop, daemon=True, name="otlp-exporter"
        )
        self._thread.start()
        logger.info("Tracing enabled: service=%s endpoint=%s",
                    service_name, self.endpoint)

    # ------------------------------------------------------------------ spans
    def start_span(self, name: str, parent: Optional[str] = None,
                   attributes: Optional[Dict] = None,
                   kind: int = SPAN_KIND_SERVER) -> Span:
        """``parent`` is an incoming traceparent header (or None to start a
        new trace)."""
        ctx = parse_traceparent(parent)
        if ctx:
            trace_id, parent_id, flags = ctx
        else:
            trace_id, parent_id, flags = secrets.token_hex(16), None, "01"
        return Span(
            name=name, trace_id=trace_id, span_id=secrets.token_hex(8),
            parent_span_id=parent_id, start_ns=time.time_ns(),
            attributes=dict(attributes or {}), kind=kind, flags=flags,
        )

    def end_span(self, span: Span, ok: bool = True) -> None:
        span.end_ns = time.time_ns()
        span.status_ok = ok
        self._enqueue(span)

    def record_span(self, name: str, parent: Optional[str],
                    start_s: float, end_s: float,
                    attributes: Optional[Dict] = None,
                    kind: int = SPAN_KIND_SERVER) -> Span:
        """Enqueue a retrospective span with explicit wall-clock bounds —
        the engine's per-request phase tree (queue-wait/prefill/decode/
        restore) is reconstructed from the flight recorder AFTER the
        request finishes, so its spans are recorded, not entered/exited."""
        span = self.start_span(name, parent, attributes, kind=kind)
        span.start_ns = int(start_s * 1e9)
        span.end_ns = int(end_s * 1e9)
        self._enqueue(span)
        return span

    def _enqueue(self, span: Span) -> None:
        try:
            self._queue.put_nowait(span)
        except queue.Full:
            # Tracing must never block serving — but the drop is counted.
            self.spans_dropped_total += 1
            if self.on_drop is not None:
                try:
                    self.on_drop()
                except Exception:  # noqa: BLE001 — counter hook best-effort
                    logger.debug("trace drop hook failed", exc_info=True)

    @contextmanager
    def span(self, name: str, parent: Optional[str] = None,
             attributes: Optional[Dict] = None,
             kind: int = SPAN_KIND_SERVER):
        s = self.start_span(name, parent, attributes, kind=kind)
        try:
            yield s
        except Exception:
            self.end_span(s, ok=False)
            raise
        self.end_span(s, ok=True)

    # ----------------------------------------------------------------- export
    def _export_loop(self) -> None:
        while not self._stop.is_set():
            batch: List[Span] = []
            try:
                batch.append(self._queue.get(timeout=_FLUSH_INTERVAL_S))
            except queue.Empty:
                continue
            while len(batch) < _MAX_BATCH:
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            try:
                self._post(batch)
            except Exception as e:  # noqa: BLE001 — dropped batch, keep going
                logger.debug("OTLP export failed: %s", e)

    def _post(self, spans: List[Span]) -> None:
        body = json.dumps(self._otlp_payload(spans)).encode()
        req = urllib.request.Request(
            f"{self.endpoint}/v1/traces", data=body,
            headers={"Content-Type": "application/json"}, method="POST",
        )
        # The response must be CLOSED, not just read: an exporter thread
        # leaking one socket per 2s flush eventually exhausts fds on
        # long-lived engines.
        resp = urllib.request.urlopen(req, timeout=5)
        try:
            resp.read()
        finally:
            resp.close()

    def _otlp_payload(self, spans: List[Span]) -> dict:
        def attr(k, v):
            if isinstance(v, bool):
                return {"key": k, "value": {"boolValue": v}}
            if isinstance(v, int):
                return {"key": k, "value": {"intValue": str(v)}}
            if isinstance(v, float):
                return {"key": k, "value": {"doubleValue": v}}
            return {"key": k, "value": {"stringValue": str(v)}}

        return {"resourceSpans": [{
            "resource": {"attributes": [
                attr("service.name", self.service_name),
            ]},
            "scopeSpans": [{
                "scope": {"name": "production_stack_tpu_torch"},
                "spans": [{
                    "traceId": s.trace_id,
                    "spanId": s.span_id,
                    **({"parentSpanId": s.parent_span_id}
                       if s.parent_span_id else {}),
                    "name": s.name,
                    "kind": s.kind,
                    "startTimeUnixNano": str(s.start_ns),
                    "endTimeUnixNano": str(s.end_ns),
                    "attributes": [attr(k, v)
                                   for k, v in s.attributes.items()],
                    **({"events": [{
                        "name": name,
                        "timeUnixNano": str(ts),
                        "attributes": [attr(k, v) for k, v in ev.items()],
                    } for name, ts, ev in s.events]} if s.events else {}),
                    "status": {"code": 1 if s.status_ok else 2},
                } for s in spans],
            }],
        }]}

    def close(self) -> None:
        self._stop.set()
        # drain what's queued
        batch: List[Span] = []
        while True:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        if batch:
            try:
                self._post(batch)
            # Best effort at shutdown: logging may already be torn down.
            except Exception:  # noqa: BLE001
                pass


_tracer: Optional[Tracer] = None
_init_done = False


def get_tracer(default_service: str = "production-stack-tpu") -> Optional[Tracer]:
    """Process singleton, configured from the standard OTEL env vars
    (OTEL_EXPORTER_OTLP_ENDPOINT enables; OTEL_SERVICE_NAME names)."""
    global _tracer, _init_done
    if not _init_done:
        _init_done = True
        endpoint = os.environ.get("OTEL_EXPORTER_OTLP_ENDPOINT")
        if endpoint:
            _tracer = Tracer(
                os.environ.get("OTEL_SERVICE_NAME", default_service),
                endpoint,
            )
    return _tracer


def spans_dropped_total() -> int:
    """Queue-full span drops of this process's tracer (0 when tracing is
    off) — the value behind pstpu:trace_spans_dropped_total on both engine
    metrics renderers."""
    return _tracer.spans_dropped_total if _tracer is not None else 0


def reset_tracer() -> None:
    """Test seam: drop the singleton so env changes take effect."""
    global _tracer, _init_done
    if _tracer is not None:
        _tracer.close()
    _tracer = None
    _init_done = False
