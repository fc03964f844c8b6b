"""Request proxy: model filtering, routing, resilient streaming relay.

Contract parity with reference src/vllm_router/services/request_service/request.py:
  * ``route_general_request`` — body parse, callbacks.pre_request
    short-circuit, model extraction + 400, rewriter hook, endpoint filtering
    by model, routing decision, proxy (:144-231).
  * ``process_request`` — async streaming relay with on_new_request /
    on_request_response (TTFT at first chunk) / on_request_complete stats
    hooks and semantic-cache store + callbacks.post_request on completion
    (:58-141).

On top of the reference contract the proxy path is wrapped in the
resilience layer (router/resilience.py):
  * pre-stream failures (connect refused/timed out, 502/503 from the
    backend) are retried with capped exponential backoff + jitter and
    failed over to the next-best backend from the routing policy, skipping
    open-circuit and already-tried backends;
  * per-request TTFT/total deadlines abort the backend call with a clean
    504 (``x-ttft-deadline`` / ``x-request-timeout`` header overrides);
  * mid-stream failures stay truncation-only (bytes are never resent) but
    mark the backend so its circuit can open.

Counterpart of ``production_stack_tpu/router/request_service.py`` on the
standard library: the client and server are ``router/http.py`` (asyncio
streams) where the JAX file uses aiohttp, and the disagg and resume headers
come from the port's ``disagg/headers.py`` (re-exported by
``disagg/transfer.py``). The response is relayed
chunk-by-chunk so SSE token streaming works end-to-end.
"""

import asyncio
import json
import time
from typing import Optional

from production_stack_tpu_torch.disagg.headers import (
    DISAGG_ENDPOINT_HEADER,
    DISAGG_FALLBACK_HEADER,
    DISAGG_KEY_HEADER,
    DISAGG_ROLE_HEADER,
    RESUME_HEADER,
)
from production_stack_tpu_torch.router import http as web
from production_stack_tpu_torch.router import metrics
from production_stack_tpu_torch.router.resilience import (
    RETRYABLE_STATUSES,
    Deadline,
    DeadlineExceeded,
    PreStreamFailure,
    ResilienceConfig,
    backoff_delay,
    get_resilience,
    get_slo_tracker,
)
from production_stack_tpu_torch.router.routing_logic import get_routing_logic
from production_stack_tpu_torch.router.service_discovery import get_service_discovery
from production_stack_tpu_torch.router.stats import (
    get_engine_stats_scraper,
    get_request_stats_monitor,
)
from production_stack_tpu_torch.protocols import ErrorResponse, random_uuid
from production_stack_tpu_torch.tracing import SPAN_KIND_CLIENT, get_tracer
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

#: Errors that mean the backend never delivered a usable response before
#: any byte reached the client — retry/failover is safe. ClientError covers
#: refused/reset/disconnected connections, connect timeouts and malformed
#: payloads; OSError covers raw socket failures (and ConnectionError).
#: asyncio.TimeoutError is an OSError too: every handler catches it first,
#: as the deadline it is (the client raises none of its own).
_CONNECT_ERRORS = (web.ClientError, OSError)


class _MidStreamBackendError(Exception):
    """Marker: the BACKEND stream failed after bytes reached the client
    (distinguishes backend read errors, which mark the breaker, from
    client-side write errors, which must not)."""


class _MidStreamDeadline(Exception):
    """Marker: the request's total deadline expired mid-stream — truncate
    the stream, never resume (the budget is spent regardless of backend)."""


class RoutedRequest:
    """Duck-typed view handed to RoutingInterface implementations."""

    def __init__(self, headers, json_body):
        self.headers = headers
        self.json_body = json_body
        # Set by the disagg flow ("prefill" / "decode") so the DisaggRouter
        # can tell the two hops apart; None on the unified path.
        self.disagg_hop: Optional[str] = None


def _error(status: int, message: str, etype: str = "invalid_request_error",
           headers: Optional[dict] = None):
    return web.json_response(
        ErrorResponse(message=message, type=etype, code=status).to_dict(),
        status=status, headers=headers,
    )


def _resilience_config() -> ResilienceConfig:
    mgr = get_resilience()
    return mgr.config if mgr is not None else ResilienceConfig()


def _slo_miss(headers) -> None:
    """Record an SLO miss for requests the router could not serve (shed,
    deadline abort, retry budget exhausted) — attainment must sag while
    work is being turned away, or the autoscaler never sees overload."""
    tracker = get_slo_tracker()
    if tracker is not None:
        tracker.observe_from_headers(headers, _resilience_config(), None)


def _next_backend(endpoints, tried, resilience, request_like) -> Optional[str]:
    """Pick the next backend from the routing policy, excluding already-tried
    and open-circuit backends. When every candidate has been tried already
    (single-backend restart case), previously tried backends become eligible
    again — the breaker still gates them."""
    def _allowed(pool):
        return [
            ep for ep in pool
            if resilience is None or resilience.allow(ep.url)
        ]

    candidates = _allowed([ep for ep in endpoints if ep.url not in tried])
    if not candidates:
        candidates = _allowed(endpoints)
    if not candidates:
        return None
    engine_stats = get_engine_stats_scraper().get_engine_stats()
    request_stats = get_request_stats_monitor().get_request_stats(time.time())
    return get_routing_logic().route_request(
        candidates, engine_stats, request_stats, request_like
    )


async def route_general_request(
    request: web.Request, endpoint: str,
    extra_headers: Optional[dict] = None,
    pool=None,
    request_like=None,
    body_override: Optional[dict] = None,
    deadline: Optional[Deadline] = None,
) -> web.StreamResponse:
    """Proxy `request` to the backend chosen by the routing logic, with
    retry/failover on pre-stream failures and per-request deadlines.

    The disagg flow reuses this loop for its decode hop and its
    unified-fallback path: ``extra_headers`` ride every backend attempt,
    ``pool`` restricts the candidates (role pools), ``request_like``
    overrides the object handed to the routing policy, ``body_override``
    supplies an already-policy-processed body (pre-request callbacks and
    the rewriter are then NOT re-applied), and ``deadline`` carries the
    caller's already-running budget instead of starting a fresh one."""
    app = request.app
    in_time = time.time()
    if body_override is not None:
        body = body_override
    else:
        try:
            # A PII REDACT pass may have replaced the body (router/pii.py).
            body_bytes = request.get("pii_redacted_body") \
                or await request.read()
            body = json.loads(body_bytes) if body_bytes else {}
        except (json.JSONDecodeError, UnicodeDecodeError):
            return _error(400, "Request body is not valid JSON")
    request_id = request.headers.get("x-request-id") or random_uuid("cmpl-")

    if body_override is None:
        callbacks = app.get("callbacks")
        if callbacks is not None:
            short = await callbacks.pre_request(request, body, endpoint)
            if short is not None:
                return short

    model = body.get("model")
    if not model:
        return _error(400, "Request body must contain a 'model' field")

    if body_override is None:
        rewriter = app.get("rewriter")
        if rewriter is not None:
            body = rewriter.rewrite(body, endpoint)
        # Cross-router resume (docs/ROUTER_SCALE.md): only on the direct
        # client entry — internal hops (disagg decode, unified fallback)
        # hand a processed body via body_override and must not re-inject.
        bad = _apply_client_resume(request.headers, body, endpoint)
        if bad is not None:
            return bad

    if pool is not None:
        endpoints = list(pool)
    else:
        endpoints = get_service_discovery().get_endpoint_info()
        endpoints = [
            ep for ep in endpoints
            if not ep.model_names or model in ep.model_names
        ]
    if not endpoints:
        return _error(
            404, f"Model '{model}' not served by any healthy backend",
            etype="model_not_found",
        )

    resilience = get_resilience()
    cfg = _resilience_config()
    if deadline is None:
        deadline = Deadline.from_request(request.headers, cfg)
    routed = request_like if request_like is not None \
        else RoutedRequest(request.headers, body)
    payload = json.dumps(body).encode()
    tried: set = set()
    attempt = 0
    last_failure: Optional[PreStreamFailure] = None
    all_attempts_shed = True   # ANDed over failures: every attempt a 503?

    import contextlib

    tracer = get_tracer("pstpu-router")

    while attempt < max(1, cfg.retry_max_attempts):
        attempt += 1
        backend_url = _next_backend(endpoints, tried, resilience, routed)
        if backend_url is None:
            _slo_miss(request.headers)
            return _error(
                503, "All backends unavailable (circuit open)",
                etype="service_unavailable", headers={"Retry-After": "1"},
            )
        if last_failure is not None and backend_url != last_failure.backend_url:
            metrics.router_failovers_total.labels(
                server=last_failure.backend_url).inc()
        tried.add(backend_url)
        route_time = time.time()
        metrics.router_queueing_delay_seconds.labels(server=backend_url).set(
            route_time - in_time
        )
        logger.debug("Routing request %s for model %s to %s (%.1f ms, try %d)",
                     request_id, model, backend_url,
                     (route_time - in_time) * 1e3, attempt)
        # One span per routed attempt (when tracing is enabled); its context
        # propagates to the engine via the W3C traceparent header (reference
        # tutorials/12-distributed-tracing.md). CLIENT kind: this is the
        # router's OUTBOUND proxy hop, and retry/failover/resume outcomes
        # land on it as span events (docs/OBSERVABILITY.md).
        span_cm = contextlib.nullcontext() if tracer is None else tracer.span(
            f"router.route {endpoint}",
            parent=request.headers.get("traceparent"),
            attributes={"backend": backend_url, "model": model,
                        "request.id": request_id, "attempt": attempt,
                        "queueing.delay_ms": (route_time - in_time) * 1e3},
            kind=SPAN_KIND_CLIENT,
        )
        try:
            with span_cm as span:
                return await proxy_request(
                    request, backend_url, endpoint, payload,
                    request_id, body=body, deadline=deadline,
                    traceparent=span.traceparent if span else None,
                    extra_headers=extra_headers,
                    # Mid-stream resume (docs/RESILIENCE.md): the relay can
                    # re-route an interrupted stream's continuation through
                    # the same candidate pool / routing policy.
                    endpoints=endpoints, tried=tried, span=span,
                )
        except DeadlineExceeded as e:
            metrics.router_deadline_exceeded_total.labels(
                server=e.backend_url, kind=e.kind
            ).inc()
            _slo_miss(request.headers)
            return _error(
                504, f"Request {e.kind} deadline exceeded",
                etype="deadline_exceeded",
            )
        except PreStreamFailure as e:
            last_failure = e
            all_attempts_shed = all_attempts_shed and e.status == 503
            if attempt >= max(1, cfg.retry_max_attempts):
                break
            metrics.router_retries_total.labels(server=e.backend_url).inc()
            delay = backoff_delay(attempt, cfg)
            rem = deadline.remaining_total()
            if rem is not None and rem <= delay:
                metrics.router_deadline_exceeded_total.labels(
                    server=e.backend_url, kind="total"
                ).inc()
                _slo_miss(request.headers)
                return _error(
                    504, "Request total deadline exceeded",
                    etype="deadline_exceeded",
                )
            await asyncio.sleep(delay)

    _slo_miss(request.headers)
    if last_failure is not None and all_attempts_shed:
        # EVERY attempt ended on a backend 503 — the pool is SHEDDING
        # (queue bound, drain), not broken. Propagate the shed semantics
        # (503 + Retry-After) instead of masking them as a 502 so clients
        # back off and retry rather than counting an error
        # (docs/SOAK.md accounting). Any non-503 failure in the mix
        # (connect refused, 502) means a genuinely broken backend and
        # stays a 502 regardless of attempt order.
        return _error(
            503, f"All backends shedding after {attempt} attempt(s)",
            etype="service_unavailable", headers={"Retry-After": "1"},
        )
    return _error(
        502, f"Backend request failed after {attempt} attempt(s): "
             f"{last_failure}",
        etype="bad_gateway",
    )


# Cross-router stream resume headers (docs/ROUTER_SCALE.md): a client that
# lost its router mid-stream reconnects to ANY peer replica carrying the
# {toks, off, seed} state it already received via the pstpu chunk payloads.
RESUME_TOKENS_HEADER = "x-pstpu-resume-tokens"
RESUME_SEED_HEADER = "x-pstpu-resume-seed"


def _apply_client_resume(headers, body, endpoint: str):
    """Fold the client's cross-router resume headers into the request body.

    The peer replica then re-enters the ordinary PR-9 resume machinery as
    if the interrupted relay had been its own: ``resume_tokens`` seeds the
    SseResumeParser (overlap re-emission deduped by token offset), the
    engine restores the prompt+delivered chain and continues
    token-identically (greedy and seeded), and the prefix-aware policy
    scores the full delivered chain. No router-to-router state transfer:
    the client IS the state channel. Returns an error response for
    malformed/ineligible resume requests, else None (body mutated)."""
    raw = headers.get(RESUME_TOKENS_HEADER)
    if raw is None:
        return None
    if not _resume_eligible(body, endpoint):
        return _error(
            400, f"{RESUME_TOKENS_HEADER} requires a single-choice "
                 f"streaming generation request (stream=true, n=1, no "
                 f"tools/logprobs)",
        )
    try:
        toks = [int(t) for t in raw.split(",") if t.strip()]
    except ValueError:
        return _error(
            400, f"{RESUME_TOKENS_HEADER} must be comma-separated token ids",
        )
    if not toks:
        return _error(
            400, f"{RESUME_TOKENS_HEADER} carried no token ids; reconnect "
                 f"without resume headers to restart the generation",
        )
    seed_raw = headers.get(RESUME_SEED_HEADER)
    if seed_raw is not None:
        try:
            body["resume_seed"] = int(seed_raw)
        except ValueError:
            return _error(
                400, f"{RESUME_SEED_HEADER} must be an integer seed",
            )
    body["resume_tokens"] = toks
    metrics.router_midstream_resumes_total.labels(outcome="peer").inc()
    logger.info(
        "Client-driven cross-router resume: %d delivered token(s), "
        "seed %s", len(toks), seed_raw,
    )
    return None


def _resume_eligible(body, endpoint: str) -> bool:
    """Only single-choice streaming generations are resumed mid-stream;
    anything else keeps PR-1 truncation-only semantics. Mirrors
    _disagg_eligible's single-stream constraints, plus: no logprobs (a
    resumed stream cannot retroactively carry the delivered region's
    deferred logprob entries on its finish chunk)."""
    if not isinstance(body, dict) or not body.get("stream"):
        return False
    if not endpoint.endswith("/completions"):
        return False
    if (body.get("n") or 1) != 1 or (body.get("best_of") or 1) != 1:
        return False
    if body.get("tools"):
        return False
    lp = body.get("logprobs")
    if lp is not None and lp is not False:
        # Includes logprobs: 0 (valid, and non-None to the engine) — a
        # spliced continuation cannot retroactively carry the delivered
        # region's logprob entries.
        return False
    if body.get("top_logprobs"):
        return False
    if not endpoint.endswith("chat/completions"):
        p = body.get("prompt")
        if isinstance(p, list):
            if not (p and all(type(x) is int for x in p)):
                return False
        elif not isinstance(p, str):
            return False
    return True


async def _attach_resume_stream(
    app, endpoint: str, body: dict, parser, tried: set, endpoints,
    deadline: Optional[Deadline], monitor, resilience, request_id: str,
    base_headers: dict, client_headers=None,
):
    """Attach a continuation backend for an interrupted SSE relay.

    Builds the resume request (original body + delivered token ids + the
    original engine's resolved sampler seed), picks a backend through the
    normal routing policy — the prefix-aware logic scores the delivered
    prompt+output chain, and the dead engine's blocks are likely resident
    in the shared tier — POSTs it, and secures the first chunk. Pre-stream
    failures of a resume attempt consume the normal retry budget (they are
    pre-stream for the CONTINUATION; nothing of it is on the wire yet),
    not the resume budget. Returns (url, resp, chunk_iter, first_chunk) or
    None — the caller degrades to truncation."""
    cfg = _resilience_config()
    session = app["client_session"]
    resume_body = dict(body)
    resume_body["resume_tokens"] = list(parser.delivered)
    resume_body["resume_seed"] = parser.seed
    payload = json.dumps(resume_body).encode()
    # Drop the dead hop's disagg-plane headers (a decode-hop's transfer key
    # is already consumed — carrying it would 503 every resume attempt) and
    # mark the continuation fallback traffic: it must be servable
    # end-to-end on ANY role (unified engines ignore the flag).
    headers = {
        name: val for name, val in base_headers.items()
        if not name.lower().startswith("x-pstpu-")
    }
    # Both synthetic headers are registry surface (PL011 —
    # tools/pstpu_lint/http_registry.py pins producer and consumer planes).
    headers[DISAGG_FALLBACK_HEADER] = "1"
    headers[RESUME_HEADER] = "1"
    # The routing policy sees the CLIENT's headers (session keys,
    # affinity hints), not the synthetic backend header set — a
    # session-routed continuation should land on the session's warm peer.
    routed = RoutedRequest(
        client_headers if client_headers is not None else base_headers,
        resume_body,
    )
    attempt = 0
    while attempt < max(1, cfg.retry_max_attempts):
        attempt += 1
        rem = deadline.remaining_total() if deadline is not None else None
        if rem is not None and rem <= 0:
            return None
        url = _next_backend(endpoints, tried, resilience, routed)
        if url is None:
            return None
        tried.add(url)
        if resilience is not None:
            resilience.on_dispatch(url)
        # Same x-request-id, new backend: the dead backend's monitor entry
        # was closed by the relay; the hop opens a fresh one so the
        # QPS/latency planes stay consistent across the splice.
        monitor.on_new_request(url, request_id, time.time())
        resp = None
        try:
            post = session.post(
                f"{url}{endpoint}", data=payload, headers=headers
            )
            resp = await (
                asyncio.wait_for(post, rem) if rem is not None else post
            )
            ctype = resp.headers.get("Content-Type", "")
            if resp.status in RETRYABLE_STATUSES:
                status = resp.status
                resp.close()
                raise PreStreamFailure(
                    url, f"resume attempt returned {status}", status=status
                )
            if resp.status != 200 or \
                    not ctype.startswith("text/event-stream"):
                # Deterministic reject (4xx / wrong response shape): every
                # backend would answer the same, and marking healthy peers'
                # breakers for correctly refusing a bad request would push
                # their circuits open — give up on resume instead.
                status = resp.status
                resp.close()
                monitor.on_request_complete(url, request_id, time.time())
                logger.warning(
                    "Resume attempt for %s at %s rejected with %s; "
                    "not retrying", request_id, url, status,
                )
                return None
            chunk_iter = resp.content.iter_any()
            rem = deadline.remaining_total() if deadline is not None else None
            try:
                get_first = chunk_iter.__anext__()
                first = await (
                    asyncio.wait_for(get_first, rem)
                    if rem is not None else get_first
                )
            except StopAsyncIteration:
                # Empty-body stream: the relay's EOF handling treats it as
                # another mid-stream failure (budget permitting).
                first = None
            return url, resp, chunk_iter, first
        except (PreStreamFailure, asyncio.TimeoutError,
                *_CONNECT_ERRORS) as e:
            if resp is not None and not resp.closed:
                # e.g. first-chunk timeout after a successful POST: the
                # engine must not keep generating into a stranded socket.
                resp.close()
            monitor.on_request_complete(url, request_id, time.time())
            if resilience is not None:
                resilience.record_failure(url)
            logger.warning("Resume attempt for %s at %s failed: %s",
                           request_id, url, e)
            if attempt < max(1, cfg.retry_max_attempts):
                # Same capped-jittered pacing as the pre-stream retry loop:
                # hammering the surviving pool the instant a peer died is
                # how one failure becomes two.
                delay = backoff_delay(attempt, cfg)
                rem = deadline.remaining_total() \
                    if deadline is not None else None
                if rem is not None and rem <= delay:
                    return None
                await asyncio.sleep(delay)
        except BaseException:
            # CancelledError (client gone mid-attach) / session closed:
            # neither the just-opened monitor entry nor an already-attached
            # response may leak — there is no expiry, and a stuck in-flight
            # count skews routing and autoscaling signals forever.
            if resp is not None and not resp.closed:
                resp.close()
            monitor.on_request_complete(url, request_id, time.time())
            raise
    return None


async def proxy_request(
    request: web.Request,
    backend_url: str,
    endpoint: str,
    payload: bytes,
    request_id: str,
    body: Optional[dict] = None,
    traceparent: Optional[str] = None,
    deadline: Optional[Deadline] = None,
    extra_headers: Optional[dict] = None,
    endpoints=None,
    tried: Optional[set] = None,
    span=None,
) -> web.StreamResponse:
    """Stream the backend response through to the client.

    Raises PreStreamFailure (retryable) or DeadlineExceeded while nothing
    has been sent to the client. Once bytes are on the wire:

      * non-streaming responses were fully BUFFERED router-side first, so
        a mid-body backend death is still a retryable pre-stream failure;
      * streaming (SSE) responses relay complete events through an
        incremental parser; a mid-stream backend failure is resumed on
        another backend (``endpoints``/``tried`` from the routing loop, up
        to max_midstream_resumes) by re-issuing the request with the
        delivered token ids + sampler seed — degrading to PR-1
        truncation-only semantics when resume is impossible.
    """
    app = request.app
    session = app["client_session"]
    resilience = get_resilience()
    if resilience is not None:
        resilience.on_dispatch(backend_url)
    monitor = get_request_stats_monitor()
    monitor.on_new_request(backend_url, request_id, time.time())

    # Forward the client's request id so router and engine logs/traces
    # correlate (it is also echoed back to the client below).
    headers = {"Content-Type": "application/json",
               "x-request-id": request_id}
    auth = request.headers.get("Authorization")
    if auth:
        headers["Authorization"] = auth
    if traceparent:
        headers["traceparent"] = traceparent
    if extra_headers:
        headers.update(extra_headers)
    if isinstance(body, dict) and body.get("stream"):
        # Ask the engine for the per-chunk resume payload (token ids +
        # resolved seed) so a mid-stream death is resumable. Direct API
        # clients never send this header and get pristine OpenAI chunks.
        headers[RESUME_HEADER] = "1"

    def _fail(reason: str, status: Optional[int] = None) -> PreStreamFailure:
        monitor.on_request_complete(backend_url, request_id, time.time())
        if resilience is not None:
            resilience.record_failure(backend_url)
        if span is not None:
            # The failure rides the attempt's span as an event, so a trace
            # shows WHY this hop retried/failed over instead of a bare
            # error status (docs/OBSERVABILITY.md).
            span.add_event("prestream_failure", {
                "backend": backend_url, "reason": reason,
                **({"status": status} if status is not None else {}),
            })
        logger.warning("Proxy to %s failed pre-stream: %s", backend_url, reason)
        return PreStreamFailure(backend_url, reason, status=status)

    def _deadline(kind: str) -> DeadlineExceeded:
        monitor.on_request_complete(backend_url, request_id, time.time())
        if span is not None:
            span.add_event("deadline_exceeded", {
                "backend": backend_url, "kind": kind,
            })
        logger.warning("Request %s %s deadline exceeded at %s",
                       request_id, kind, backend_url)
        return DeadlineExceeded(kind, backend_url)

    rem_ttft = deadline.remaining_ttft() if deadline is not None else None
    if rem_ttft is not None and rem_ttft <= 0:
        raise _deadline(deadline.binding_kind())

    backend_resp = None
    try:
        try:
            post = session.post(
                f"{backend_url}{endpoint}", data=payload, headers=headers
            )
            backend_resp = (
                await asyncio.wait_for(post, rem_ttft)
                if rem_ttft is not None else await post
            )
        except asyncio.TimeoutError:
            raise _deadline(deadline.binding_kind()) from None
        except _CONNECT_ERRORS as e:
            raise _fail(f"connect failed: {e!r}") from e

        if backend_resp.status in RETRYABLE_STATUSES:
            backend_resp.close()
            raise _fail(f"backend returned {backend_resp.status}",
                        status=backend_resp.status)

        # First chunk BEFORE preparing the client response: a TTFT-deadline
        # abort or a disconnect here can still become a clean 504/retry.
        chunks_iter = backend_resp.content.iter_any()
        rem_ttft = deadline.remaining_ttft() if deadline is not None else None
        first_chunk: Optional[bytes] = None
        try:
            get_first = chunks_iter.__anext__()
            first_chunk = (
                await asyncio.wait_for(get_first, rem_ttft)
                if rem_ttft is not None else await get_first
            )
        except StopAsyncIteration:
            first_chunk = None
        except asyncio.TimeoutError:
            backend_resp.close()
            raise _deadline(deadline.binding_kind()) from None
        except _CONNECT_ERRORS as e:
            backend_resp.close()
            raise _fail(f"stream failed before first byte: {e!r}") from e
    except (PreStreamFailure, DeadlineExceeded):
        if backend_resp is not None and not backend_resp.closed:
            backend_resp.close()
        raise
    except asyncio.CancelledError:
        if backend_resp is not None and not backend_resp.closed:
            backend_resp.close()
        raise
    except Exception as e:  # noqa: BLE001 — anything unanticipated pre-stream
        # e.g. RuntimeError("Session is closed") during router shutdown:
        # nothing reached the client yet, so it is still a clean, retryable
        # pre-stream failure (and the stats entry must be closed out).
        if backend_resp is not None and not backend_resp.closed:
            backend_resp.close()
        raise _fail(f"unexpected pre-stream failure: {e!r}") from e

    # First byte secured.
    tracker = get_slo_tracker()
    first_byte_s = (
        time.monotonic() - deadline.start if deadline is not None else None
    )
    stream_requested = (
        bool(body.get("stream")) if isinstance(body, dict) else None
    )

    if isinstance(body, dict) and not stream_requested:
        # ------------------- buffered non-streaming relay -----------------
        # The whole backend body is read BEFORE any byte reaches the
        # client, so a backend dying mid-body is still a retryable
        # pre-stream failure (the PR-1 retry/failover path) instead of a
        # truncated JSON body the client cannot detect.
        first_byte_wall = time.time()   # first chunk was secured just above
        chunks = [first_chunk] if first_chunk else []
        while True:
            rem = deadline.remaining_total() if deadline is not None else None
            try:
                get_next = chunks_iter.__anext__()
                chunk = (
                    await asyncio.wait_for(get_next, rem)
                    if rem is not None else await get_next
                )
            except StopAsyncIteration:
                break
            except asyncio.TimeoutError:
                backend_resp.close()
                raise _deadline("total") from None
            except asyncio.CancelledError:
                # Client gone mid-buffer: close out the stats entry (no
                # expiry exists) before propagating the cancellation.
                monitor.on_request_complete(backend_url, request_id,
                                            time.time())
                backend_resp.close()
                raise
            except Exception as e:  # noqa: BLE001 — mid-body backend failure
                backend_resp.close()
                raise _fail(f"backend failed mid-body: {e!r}") from e
            chunks.append(chunk)
        body_bytes = b"".join(chunks)
        if tracker is not None and deadline is not None:
            tracker.observe_from_headers(
                request.headers, _resilience_config(),
                None if backend_resp.status >= 500 else first_byte_s,
            )
        # TTFT plane gets the FIRST-byte instant (as the streaming relay
        # reports it), not the end-of-buffer time — buffering must not
        # inflate the monitor's per-backend latency stats.
        monitor.on_request_response(backend_url, request_id, first_byte_wall)
        monitor.on_request_complete(backend_url, request_id, time.time())
        if resilience is not None:
            # Relayed error responses are not breaker successes: a backend
            # stuck returning 500s must still trip its circuit eventually.
            if backend_resp.status >= 500:
                resilience.record_failure(backend_url)
            else:
                resilience.record_success(backend_url)
        status = backend_resp.status
        ctype = backend_resp.headers.get("Content-Type", "application/json")
        backend_resp.release()
        cache = app.get("semantic_cache")
        if cache is not None and status == 200:
            try:
                cache.store_response(body, body_bytes)
            except Exception:  # noqa: BLE001 — cache store is best-effort
                logger.exception("Semantic cache store failed")
        callbacks = app.get("callbacks")
        if callbacks is not None:
            await callbacks.post_request(request, body)
        return web.Response(
            status=status, body=body_bytes,
            headers={"Content-Type": ctype, "x-request-id": request_id},
        )

    # Streaming (and body-less) relays: record the soft SLO outcome at the
    # first byte (relayed 5xx bodies count as misses even when their first
    # byte was fast).
    if tracker is not None and deadline is not None:
        tracker.observe_from_headers(
            request.headers, _resilience_config(),
            None if backend_resp.status >= 500 else first_byte_s,
        )

    if (
        stream_requested
        and backend_resp.status == 200
        and backend_resp.headers.get(
            "Content-Type", ""
        ).startswith("text/event-stream")
    ):
        # -------------------- SSE relay with mid-stream resume ------------
        from production_stack_tpu_torch.router.sse import (
            DONE_EVENT,
            SseResumeParser,
        )

        cfg = _resilience_config()
        client_resume = body.get("resume_tokens")
        parser = SseResumeParser(
            delivered=client_resume
            if isinstance(client_resume, list) else None,
        )
        resume_ok = (
            endpoints is not None
            and cfg.max_midstream_resumes > 0
            and _resume_eligible(body, endpoint)
        )
        response = web.StreamResponse(
            status=backend_resp.status,
            headers={
                "Content-Type": backend_resp.headers.get(
                    "Content-Type", "text/event-stream"
                ),
                "x-request-id": request_id,
            },
        )
        cur_url, cur_resp, cur_iter = backend_url, backend_resp, chunks_iter
        chunk = first_chunk
        tried_pool: set = set(tried) if tried is not None else {backend_url}
        resumes = 0
        truncated = False
        entry_open = True   # monitor entry for cur_url still open
        first = True
        try:
            await response.prepare(request)
            while True:       # one iteration per attached backend stream
                try:
                    while chunk is not None:
                        now = time.time()
                        if first:
                            monitor.on_request_response(cur_url, request_id,
                                                        now)
                            first = False
                        else:
                            monitor.on_request_token(cur_url, request_id,
                                                     now)
                        for event in parser.feed(chunk):
                            # The write is deadline-bounded: a client that
                            # stops reading must not hold the request (and
                            # its backend connection) open past
                            # x-request-timeout.
                            rem = deadline.remaining_total() \
                                if deadline is not None else None
                            if rem is not None:
                                await asyncio.wait_for(
                                    response.write(event), rem
                                )
                            else:
                                await response.write(event)
                        if parser.violation:
                            # The resumed backend broke the resume protocol
                            # (no pstpu payload / mis-aligned framing): it
                            # may be replaying the answer from token 0.
                            # Abort it like any mid-stream failure — the
                            # budget decides resume-again vs truncate.
                            raise _MidStreamBackendError(RuntimeError(
                                "resumed backend broke the resume protocol"
                            ))
                        rem = deadline.remaining_total() \
                            if deadline is not None else None
                        try:
                            get_next = cur_iter.__anext__()
                            chunk = (
                                await asyncio.wait_for(get_next, rem)
                                if rem is not None else await get_next
                            )
                        except StopAsyncIteration:
                            chunk = None
                        except asyncio.TimeoutError:
                            # Mid-stream deadline: truncate, NEVER resume —
                            # the request's budget is spent no matter which
                            # backend would serve the tail.
                            metrics.router_deadline_exceeded_total.labels(
                                server=cur_url, kind="total"
                            ).inc()
                            logger.warning(
                                "Request %s total deadline exceeded "
                                "mid-stream at %s", request_id, cur_url,
                            )
                            raise _MidStreamDeadline() from None
                        except Exception as e:  # noqa: BLE001 — backend read
                            raise _MidStreamBackendError(e) from e
                    if parser.seed is not None and not parser.done \
                            and not parser.finished and not parser.degraded:
                        # The resume protocol guarantees a terminal [DONE];
                        # a clean EOF without one is a backend death the
                        # transport didn't surface as an error. A DEGRADED
                        # (passthrough) stream stops tracking [DONE], so
                        # its completeness is unknowable — never charge the
                        # backend or count a truncation for it.
                        raise _MidStreamBackendError(
                            RuntimeError("stream ended without [DONE]")
                        )
                except _MidStreamDeadline:
                    truncated = True
                    break
                except _MidStreamBackendError as e:
                    if resilience is not None:
                        resilience.record_failure(cur_url)
                    monitor.on_request_complete(cur_url, request_id,
                                                time.time())
                    entry_open = False
                    cur_resp.close()
                    if span is not None:
                        span.add_event("midstream_failure", {
                            "backend": cur_url,
                            "events_relayed": parser.events_relayed,
                            "reason": repr(e.__cause__ or e),
                        })
                    logger.warning(
                        "Proxy to %s failed mid-stream after %d relayed "
                        "event(s): %s", cur_url, parser.events_relayed,
                        e.__cause__ or e,
                    )
                    if parser.done or parser.finished:
                        # Semantically complete — at worst the [DONE]
                        # sentinel died with the backend (synthesized
                        # below). Nothing to resume.
                        break
                    parser.violation = False   # next attach starts clean
                    if not (
                        resume_ok and parser.resumable
                        # A death before ANY token was delivered has
                        # nothing to resume from (the engine rejects empty
                        # resume_tokens) — degrade to truncation.
                        and parser.delivered
                        and resumes < cfg.max_midstream_resumes
                        and not (deadline is not None and deadline.expired())
                    ):
                        truncated = True
                        break
                    resumes += 1
                    try:
                        attach = await _attach_resume_stream(
                            app, endpoint, body, parser, tried_pool,
                            endpoints, deadline, monitor, resilience,
                            request_id, headers,
                            client_headers=request.headers,
                        )
                    except asyncio.CancelledError:
                        raise
                    except Exception:  # noqa: BLE001 — must degrade, not
                        # masquerade as a client drop: a routing-policy or
                        # attach bug ends the stream as an ACCOUNTED
                        # truncation, with the real error logged.
                        logger.exception(
                            "Resume attach for %s failed unexpectedly",
                            request_id,
                        )
                        attach = None
                    if attach is None:
                        metrics.router_midstream_resumes_total.labels(
                            outcome="failed").inc()
                        if span is not None:
                            span.add_event("midstream_resume",
                                           {"outcome": "failed"})
                        truncated = True
                        break
                    metrics.router_midstream_resumes_total.labels(
                        outcome="resumed").inc()
                    if span is not None:
                        span.add_event("midstream_resume", {
                            "outcome": "resumed", "backend": attach[0],
                            "token_offset": len(parser.delivered),
                        })
                    logger.info(
                        "Request %s resumed on %s at token offset %d "
                        "(resume %d/%d)", request_id, attach[0],
                        len(parser.delivered), resumes,
                        cfg.max_midstream_resumes,
                    )
                    cur_url, cur_resp, cur_iter, chunk = attach
                    parser.begin_strict()
                    entry_open = True
                    first = True
                    continue
                break          # clean end of stream
            if not truncated and parser.seed is None:
                # Foreign (non-protocol) SSE streams may legally end
                # without a trailing blank line: forward the unterminated
                # tail instead of swallowing it. Protocol streams end on
                # the [DONE] boundary; truncations drop partial frames on
                # purpose.
                tail = parser.flush_residue()
                if tail:
                    await response.write(tail)
            if not truncated and parser.finished and not parser.done:
                await response.write(DONE_EVENT)
                parser.done = True
            if truncated:
                metrics.router_truncations_total.inc()
                if span is not None:
                    span.add_event("truncated", {"backend": cur_url})
            if entry_open:
                monitor.on_request_complete(cur_url, request_id, time.time())
                entry_open = False
                if truncated:
                    cur_resp.close()
                else:
                    if resilience is not None:
                        resilience.record_success(cur_url)
                    cur_resp.release()
            try:
                await response.write_eof()
            except (ConnectionResetError, RuntimeError):
                pass
            callbacks = app.get("callbacks")
            if callbacks is not None:
                await callbacks.post_request(request, body)
            return response
        except asyncio.CancelledError:
            if entry_open:
                monitor.on_request_complete(cur_url, request_id, time.time())
            cur_resp.close()
            raise
        except Exception as e:  # noqa: BLE001 — CLIENT-side write failure
            # The client went away (or stalled past the deadline)
            # mid-relay: not the backend's fault — the breaker is NOT
            # marked and the stream is NOT resumed (client drops are not
            # backend failures; there is no reader left to splice for).
            if entry_open:
                monitor.on_request_complete(cur_url, request_id, time.time())
            if isinstance(e, asyncio.TimeoutError):
                metrics.router_deadline_exceeded_total.labels(
                    server=cur_url, kind="total"
                ).inc()
                if not parser.done:
                    # The write-side deadline cut the stream short: count
                    # it like the read-side mid-stream deadline does.
                    metrics.router_truncations_total.inc()
            logger.info("Client for request %s dropped mid-stream (%s)",
                        request_id, e)
            cur_resp.close()
            return response

    # ---------------- raw relay (body-less / non-SSE stream bodies) -------
    response = web.StreamResponse(
        status=backend_resp.status,
        headers={
            "Content-Type": backend_resp.headers.get(
                "Content-Type", "application/json"
            ),
            "x-request-id": request_id,
        },
    )
    completed = False   # guards double on_request_complete if write_eof fails
    try:
        await response.prepare(request)
        first = True
        chunk = first_chunk
        while chunk is not None:
            now = time.time()
            if first:
                monitor.on_request_response(backend_url, request_id, now)
                first = False
            else:
                monitor.on_request_token(backend_url, request_id, now)
            rem = deadline.remaining_total() if deadline is not None else None
            # The write is also deadline-bounded: a client that stops
            # reading must not hold the request (and its backend
            # connection) open past x-request-timeout.
            if rem is not None:
                await asyncio.wait_for(response.write(chunk), rem)
            else:
                await response.write(chunk)
            rem = deadline.remaining_total() if deadline is not None else None
            try:
                get_next = chunks_iter.__anext__()
                chunk = (
                    await asyncio.wait_for(get_next, rem)
                    if rem is not None else await get_next
                )
            except StopAsyncIteration:
                chunk = None
            except asyncio.TimeoutError:
                # Mid-stream deadline: truncate; never resend bytes.
                metrics.router_deadline_exceeded_total.labels(
                    server=backend_url, kind="total"
                ).inc()
                logger.warning("Request %s total deadline exceeded "
                               "mid-stream at %s", request_id, backend_url)
                backend_resp.close()
                monitor.on_request_complete(backend_url, request_id,
                                            time.time())
                completed = True
                await response.write_eof()
                return response
            except Exception as e:  # noqa: BLE001 — backend read failure
                raise _MidStreamBackendError(e) from e
        monitor.on_request_complete(backend_url, request_id, time.time())
        completed = True
        await response.write_eof()
    except _MidStreamBackendError as e:
        if not completed:
            monitor.on_request_complete(backend_url, request_id, time.time())
        if resilience is not None:
            resilience.record_failure(backend_url)
        logger.warning("Proxy to %s failed mid-stream: %s",
                       backend_url, e.__cause__)
        backend_resp.close()
        # Headers/body already on the wire: abort the stream so the client
        # sees truncation instead of a corrupted second response.
        try:
            await response.write_eof()
        except (ConnectionResetError, RuntimeError):
            pass
        return response
    except Exception as e:  # noqa: BLE001 — CLIENT-side write failure
        # The client went away (or stalled past the deadline) mid-relay:
        # not the backend's fault, so the breaker is NOT marked.
        if not completed:
            monitor.on_request_complete(backend_url, request_id, time.time())
        if isinstance(e, asyncio.TimeoutError):
            metrics.router_deadline_exceeded_total.labels(
                server=backend_url, kind="total"
            ).inc()
        logger.info("Client for request %s dropped mid-stream (%s)",
                    request_id, e)
        backend_resp.close()
        return response

    if resilience is not None:
        # Relayed error responses are not breaker successes: a backend
        # stuck returning 500s must still trip its circuit eventually.
        if backend_resp.status >= 500:
            resilience.record_failure(backend_url)
        else:
            resilience.record_success(backend_url)
    backend_resp.release()

    callbacks = app.get("callbacks")
    if callbacks is not None:
        await callbacks.post_request(request, body)
    return response


async def resilient_json_request(
    app, endpoint: str, body: dict, headers: Optional[dict] = None,
    endpoints=None, request_like=None, deadline: Optional[Deadline] = None,
) -> dict:
    """One non-streaming request through routing + resilience, for callers
    without an inbound web.Request (the batch processor, the disagg prefill
    hop). Retries/fails over on connect errors and 502/503 like the proxy
    path; raises RuntimeError once the retry budget is exhausted.
    ``endpoints`` restricts the candidate pool (disagg role pools);
    ``request_like`` overrides the object handed to the routing policy;
    ``deadline`` bounds each attempt and the backoff sleeps with the
    caller's remaining total budget (raises DeadlineExceeded).

    NOTE: keep breaker/metric semantics in sync with route_general_request /
    proxy_request above (same attempt loop over a different transport)."""
    import os

    model = body.get("model")
    if endpoints is None:
        endpoints = [
            ep for ep in get_service_discovery().get_endpoint_info()
            if not ep.model_names or model in ep.model_names
        ]
    if not endpoints:
        raise RuntimeError(f"No backend serves model {model!r}")
    resilience = get_resilience()
    cfg = _resilience_config()
    session = app["client_session"]
    routed = request_like if request_like is not None \
        else RoutedRequest(headers or {}, body)
    # Forward auth + correlation id to the backend, plus any disagg-plane
    # x-pstpu-* headers (transfer key, endpoint kind). Engines behind
    # --api-key accept the shared VLLM_API_KEY (the discovery probe's
    # convention) when the caller supplies no Authorization of its own.
    fwd_headers = {}
    for name, val in (headers or {}).items():
        if name.lower().startswith("x-pstpu-"):
            fwd_headers[name] = val
    for name in ("Authorization", "x-request-id"):
        val = (headers or {}).get(name) or (headers or {}).get(name.lower())
        if val:
            fwd_headers[name] = val
    if "Authorization" not in fwd_headers and os.environ.get("VLLM_API_KEY"):
        fwd_headers["Authorization"] = f"Bearer {os.environ['VLLM_API_KEY']}"
    tried: set = set()
    attempt = 0
    last_error: Optional[Exception] = None
    last_failed_url: Optional[str] = None
    while attempt < max(1, cfg.retry_max_attempts):
        attempt += 1
        rem = deadline.remaining_total() if deadline is not None else None
        if rem is not None and rem <= 0:
            raise DeadlineExceeded("total", last_failed_url or "routing")
        url = _next_backend(endpoints, tried, resilience, routed)
        if url is None:
            raise RuntimeError("All backends unavailable (circuit open)")
        if last_failed_url is not None and url != last_failed_url:
            metrics.router_failovers_total.labels(
                server=last_failed_url).inc()
        tried.add(url)
        if resilience is not None:
            resilience.on_dispatch(url)

        async def _attempt(url=url):
            resp = await session.post(
                f"{url}{endpoint}", json=body, headers=fwd_headers
            )
            try:
                if resp.status in RETRYABLE_STATUSES:
                    raise PreStreamFailure(
                        url, f"backend returned {resp.status}",
                        status=resp.status,
                    )
                return resp.status, await resp.read()
            finally:
                resp.close()

        try:
            status, data = await (
                asyncio.wait_for(_attempt(), rem)
                if rem is not None else _attempt()
            )
            if resilience is not None:
                # Same breaker semantics as the proxy path: relayed 5xx
                # (e.g. a wedged backend's 500s) are failures, not successes.
                if status >= 500:
                    resilience.record_failure(url)
                else:
                    resilience.record_success(url)
            return json.loads(data)
        except (PreStreamFailure, asyncio.TimeoutError,
                *_CONNECT_ERRORS) as e:
            if isinstance(e, asyncio.TimeoutError) and rem is not None:
                # Our wait_for deadline fired: the caller's budget ran out
                # mid-attempt and a wedged backend must not hold the
                # request past it.
                if resilience is not None:
                    resilience.record_failure(url)
                raise DeadlineExceeded("total", url) from None
            last_error = e
            last_failed_url = url
            if resilience is not None:
                resilience.record_failure(url)
            logger.warning("Batch request to %s failed: %s", url, e)
            if attempt < max(1, cfg.retry_max_attempts):
                metrics.router_retries_total.labels(server=url).inc()
                delay = backoff_delay(attempt, cfg)
                rem = deadline.remaining_total() \
                    if deadline is not None else None
                if rem is not None and rem <= delay:
                    raise DeadlineExceeded("total", url) from None
                await asyncio.sleep(delay)
    raise RuntimeError(
        f"Backend request failed after {attempt} attempt(s): {last_error}"
    )


# ---------------------------------------------------------------- disagg flow
def _disagg_eligible(body: dict, endpoint: str) -> bool:
    """Only single-choice, single-prompt generation requests take the
    two-hop path; fan-outs, tool calling, and multi-prompt batches stay on
    the unified path (the handoff manifest carries exactly one stream)."""
    if not endpoint.endswith("/completions"):
        return False
    if (body.get("n") or 1) != 1 or (body.get("best_of") or 1) != 1:
        return False
    if body.get("tools"):
        return False
    if not endpoint.endswith("chat/completions"):
        p = body.get("prompt")
        if isinstance(p, list):
            # A single list of token ids is fine; lists of strings/lists
            # are multi-prompt fan-outs.
            if not (p and all(type(x) is int for x in p)):
                return False
        elif not isinstance(p, str):
            return False
    return True


async def route_disagg_request(
    request: web.Request, endpoint: str
) -> web.StreamResponse:
    """Two-hop disaggregated flow (docs/DISAGG.md):

      1. prefill hop — non-streaming POST /disagg/prefill to the
         least-loaded prefill engine (resilient_json_request: retry +
         failover + breaker); the engine prefills, samples token 1, and
         publishes KV + chain state under a router-minted transfer key.
      2. decode hop — the original request streams from a decode engine
         picked by cache affinity, carrying the transfer key; the engine
         rehydrates the KV and continues from token 1, so the client sees
         ONE ordinary (SSE or JSON) response.

    Any failure — ineligible request, empty role pool, prefill publish
    error, decode pool exhausted — degrades to unified serving: the
    request is re-routed as a plain single-hop request carrying the
    fallback header that unlocks end-to-end serving on role-split engines.
    Never an error while any engine can still serve."""
    from production_stack_tpu_torch.router.routing_logic import DisaggRouter

    app = request.app
    cfg = _resilience_config()
    deadline = Deadline.from_request(request.headers, cfg)
    body: dict = {}

    async def fallback(reason: str) -> web.StreamResponse:
        metrics.router_disagg_fallbacks_total.labels(reason=reason).inc()
        logger.info("Disagg request degrading to unified serving (%s)",
                    reason)
        # body_override: policy (callbacks/rewriter) already ran below and
        # must not re-apply; the deadline budget keeps running.
        return await route_general_request(
            request, endpoint, extra_headers={DISAGG_FALLBACK_HEADER: "1"},
            body_override=body, deadline=deadline,
        )

    if RESUME_TOKENS_HEADER in request.headers:
        # Cross-router resume: the delivered chain's KV lives on the engine
        # (or the shared tier) already — a fresh prefill hop would waste it
        # and the handoff manifest can't represent a mid-generation splice.
        # The unified path owns resume (policy hooks run there, once).
        return await route_general_request(request, endpoint)
    try:
        body_bytes = request.get("pii_redacted_body") or await request.read()
        body = json.loads(body_bytes) if body_bytes else {}
    except (json.JSONDecodeError, UnicodeDecodeError):
        return _error(400, "Request body is not valid JSON")
    # Same pre-request policy surface as route_general_request: the
    # callbacks short-circuit and the rewriter must not be bypassable by
    # the routing mode. They run exactly ONCE — the fallback path hands
    # the processed body onward via body_override, which tells
    # route_general_request to skip both.
    callbacks = app.get("callbacks")
    if callbacks is not None:
        short = await callbacks.pre_request(request, body, endpoint)
        if short is not None:
            return short
    model = body.get("model")
    if not model:
        return _error(400, "Request body must contain a 'model' field")
    rewriter = app.get("rewriter")
    if rewriter is not None:
        body = rewriter.rewrite(body, endpoint)
    logic = get_routing_logic()
    if not isinstance(logic, DisaggRouter):
        return await route_general_request(request, endpoint)
    endpoints = [
        ep for ep in get_service_discovery().get_endpoint_info()
        if not ep.model_names or model in ep.model_names
    ]
    if not endpoints:
        return _error(
            404, f"Model '{model}' not served by any healthy backend",
            etype="model_not_found",
        )
    engine_stats = get_engine_stats_scraper().get_engine_stats()
    pools = logic.split_pools(endpoints, engine_stats)
    if not _disagg_eligible(body, endpoint):
        return await fallback("ineligible")
    resilience = get_resilience()

    def _alive(pool):
        return [ep for ep in pool
                if resilience is None or resilience.allow(ep.url)]

    if not _alive(pools["prefill"]) or not _alive(pools["decode"]):
        return await fallback("pool_empty")

    request_id = request.headers.get("x-request-id") or random_uuid("cmpl-")
    key = f"pstpu-transfer:{random_uuid(request_id + ':')}"
    kind = "chat" if endpoint.endswith("chat/completions") else "completions"

    # ------------------------------------------------------------- hop 1
    # The deadline budget (constructed at request entry, above) spans BOTH
    # hops: the prefill hop spends from it and the decode hop gets only
    # the remainder — a per-hop clock would let the total run to 2x the
    # promised bound.
    hop1 = RoutedRequest(request.headers, body)
    hop1.disagg_hop = "prefill"
    hop1_headers = {
        DISAGG_KEY_HEADER: key,
        DISAGG_ENDPOINT_HEADER: kind,
        "x-request-id": request_id,
    }
    auth = request.headers.get("Authorization")
    if auth:
        hop1_headers["Authorization"] = auth
    try:
        pre = await resilient_json_request(
            app, "/disagg/prefill", body, headers=hop1_headers,
            endpoints=pools["prefill"], request_like=hop1,
            deadline=deadline,
        )
    except DeadlineExceeded as e:
        metrics.router_deadline_exceeded_total.labels(
            server=e.backend_url, kind=e.kind
        ).inc()
        return _error(
            504, "Request total deadline exceeded",
            etype="deadline_exceeded",
        )
    except (RuntimeError, ValueError) as e:
        # RuntimeError: retry budget exhausted. ValueError (incl.
        # JSONDecodeError): a 200 with a non-JSON body (interposed proxy) —
        # either way the hop failed, so degrade, never 500.
        logger.warning("Disagg prefill hop failed: %s", e)
        return await fallback("prefill_failed")
    if pre.get("status") != "handoff":
        logger.warning("Disagg prefill hop refused: %s", pre)
        return await fallback("prefill_refused")
    metrics.router_disagg_handoffs_total.inc()

    # ------------------------------------------------------------- hop 2
    # The general attempt loop does the heavy lifting (retry/failover/
    # breaker/deadline/tracing) against the decode pool; its own policy
    # hooks are skipped via body_override (they ran above).
    hop2 = RoutedRequest(request.headers, body)
    hop2.disagg_hop = "decode"
    resp = await route_general_request(
        request, endpoint,
        extra_headers={DISAGG_ROLE_HEADER: "decode", DISAGG_KEY_HEADER: key},
        pool=pools["decode"], request_like=hop2, body_override=body,
        deadline=deadline,
    )
    if resp.status in (502, 503) and not resp.prepared:
        # Loop-generated failure (decode pool down/exhausted), nothing on
        # the wire yet: the transfer may or may not have been consumed —
        # unified fallback recomputes the prefill, which is wasteful but
        # correct (deterministic per-sequence sampling). Backend-relayed
        # 502/503s never reach here (RETRYABLE_STATUSES are retried).
        return await fallback("decode_failed")
    return resp
