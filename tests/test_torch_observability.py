"""The port's observability surface against the JAX package's: the flight
recorder (its unit cases fed to both recorders, and a served request's
timeline over both servers' ``/debug/requests/{id}``), the debug routes'
404 without the debug surface and 401 without the key, the torch.profiler
window's lifecycle, the tracer (``tracing.py``: the JAX tests' cases, and
both servers' spans under a client ``traceparent`` at a stub OTLP
collector, dropped spans counted and rendered), and the HTTP contract:
every ``engine``-plane route of ``tools/pstpu_lint/http_registry.py``
registered, every flag of the JAX server's ``parse_args`` parsed, the
flags of unported features refused.

Both servers serve the same float32 ``tiny-llama-128dh`` weights on the
CPU (the harness of ``tests/test_torch_surface.py``).
"""

import argparse
import asyncio
import json
import os
import queue

import pytest
from aiohttp import web

from production_stack_tpu import tracing as jax_tracing
from production_stack_tpu.engine import flight_recorder as jfr
from production_stack_tpu.server import api_server as jax_api
from production_stack_tpu_torch import tracing
from production_stack_tpu_torch.engine import flight_recorder as pfr
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.server import api_server as port_api
from production_stack_tpu_torch.server.api_server import OpenAIServer
from tests.test_torch_surface import _events, _http, _port_engine, _Servers
from tools.pstpu_lint import http_registry

KEY = "sk-obs"
TIME_KEYS = {"t", "created", "start", "end", "last_event_t", "wait_s", "ms",
             "seconds"}


def _strip(obj):
    """``obj`` without its timestamps and durations (any depth)."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items() if k not in TIME_KEYS}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


# ------------------------------------------------------- recorder: units
def _ring(m):
    rec = m.FlightRecorder(capacity=3)
    for i in range(5):
        rec.start(f"r{i}")
        rec.event(f"r{i}", "enqueue", {"prompt_tokens": 1})
    return rec, ["r0", "r1", "r2", "r4"], 64


def _cap(m):
    rec = m.FlightRecorder(capacity=2, max_events=8)
    rec.start("r")
    for _ in range(20):
        rec.event("r", "decode_fetch", {"tokens": 1})
    rec.finish("r", reason="length", output_tokens=20)
    return rec, ["r"], 64


def _unknown(m):
    rec = m.FlightRecorder(capacity=2)
    rec.event("ghost", "decode_fetch", {"tokens": 1})
    rec.finish("ghost")
    return rec, ["ghost"], 64


def _alias(m):
    rec = m.FlightRecorder(capacity=4)
    rec.start("cmpl-1-0")
    rec.start("cmpl-1-1")
    rec.alias("client-id", ["cmpl-1-0", "cmpl-1-1"])
    return rec, ["client-id", "cmpl-1-0", "nope"], 1


def _folding(m):
    rec = m.FlightRecorder(capacity=4)
    rec.start("r", prompt_tokens=10)
    r = rec._records["r"]
    t0 = 1.7e9
    r.events = [
        (t0, "enqueue", {"prompt_tokens": 10}),
        (t0 + 0.05, "schedule", {"wait_s": 0.05}),
        (t0 + 0.05, "prefill_issue", {"step": 0, "chunk": 10, "start": 0}),
        (t0 + 0.04, "restore", {"tokens": 32, "seconds": 0.02}),
        (t0 + 0.15, "prefill_fetch", {"step": 0, "final": True,
                                      "cached_tokens": 0}),
        (t0 + 0.16, "decode_issue", {"step": 1, "rows": 1, "k": 8}),
        (t0 + 0.30, "decode_fetch", {"step": 1, "tokens": 8,
                                     "spec_accepted_batch": 3,
                                     "spec_drafts_batch": 4}),
        (t0 + 0.31, "handoff_publish", {"ok": True}),
        (t0 + 0.46, "finish", {"reason": "length", "output_tokens": 12}),
    ]
    return rec, ["r"], 0


def _never_dispatched(m):
    rec = m.FlightRecorder(capacity=2)
    rec.start("r")
    rec.event("r", "enqueue", {"prompt_tokens": 10}, t=1.7e9)
    rec.finish("r", reason="abort")
    return rec, ["r"], -5


@pytest.mark.parametrize("case", [_ring, _cap, _unknown, _alias, _folding,
                                  _never_dispatched])
def test_recorder_cases_match_jax(case):
    """The JAX recorder tests' cases, fed to both recorders: equal
    ``get`` (records, events, phases), ``timeline`` and eviction counts,
    timestamps aside; phases equal with their times too where the events
    carry explicit times."""
    jrec, keys, max_requests = case(jfr)
    prec, _, _ = case(pfr)
    for key in keys:
        assert _strip(prec.get(key)) == _strip(jrec.get(key))
    assert _strip(prec.timeline(max_requests)) == \
        _strip(jrec.timeline(max_requests))
    assert prec.records_evicted_total == jrec.records_evicted_total
    if case is _folding:
        # Explicit event times: the phases are equal with their times.
        assert pfr.phases(prec._records["r"]) == jfr.phases(jrec._records["r"])


# ---------------------------------------------------- recorder: served
def _event_view(record):
    """A record's events without times: (name, data) in order."""
    return [(e["event"], {k: v for k, v in e.items()
                          if k not in TIME_KEYS and k != "event"})
            for e in record["events"]]


@pytest.mark.parametrize("path,body", [
    ("/v1/completions", {"prompt": "abc", "max_tokens": 9,
                         "temperature": 0, "ignore_eos": True}),
    ("/v1/chat/completions", {"messages": [{"role": "user",
                                            "content": "hello"}],
                              "max_tokens": 6, "temperature": 0,
                              "ignore_eos": True, "stream": True}),
])
async def test_served_request_timeline_matches_jax(path, body):
    """A served greedy request's ``/debug/requests/{x-request-id}`` on both
    servers: the same events in the same order with the same data (steps,
    chunks, rows, K, tokens per fetch, finish reason), the same phase names
    and attributes; the response id resolves too; the phases tile the
    request (queue wait ends where prefill starts); ``/debug/timeline``
    lists it."""
    async with _Servers() as s:
        hdr = {"x-request-id": "client-1"}
        (js, jtext), (ps, ptext) = await s.raw("POST", path, body, hdr)
        assert js == ps == 200
        got = {}
        for name, text in (("jax", jtext), ("port", ptext)):
            rid = (_events(text)[0][0]["id"] if body.get("stream")
                   else json.loads(text)["id"])
            got[name + "_rid"] = rid
        (j1, jdbg), (p1, pdbg) = await s.raw("GET", "/debug/requests/client-1")
        st, _, by_id = await _http(s.port, "GET",
                                   f"/debug/requests/{got['port_rid']}")
        (_, jtl), (_, ptl) = await s.raw("GET", "/debug/timeline")
        st404, _, _ = await _http(s.port, "GET", "/debug/requests/nope")
    assert j1 == p1 == st == 200 and st404 == 404
    jrec = json.loads(jdbg)["records"][0]
    prec = json.loads(pdbg)["records"][0]
    assert json.loads(by_id)["records"][0]["events"] == prec["events"]
    assert _event_view(prec) == _event_view(jrec)
    names = [e["event"] for e in prec["events"]]
    assert names[0] == "enqueue" and names[-1] == "finish"
    assert "prefill_issue" in names and "decode_issue" in names
    assert _strip(prec["phases"]) == _strip(jrec["phases"])
    ph = {p["name"]: p for p in prec["phases"]}
    assert ph["queue_wait"]["end"] == ph["prefill"]["start"]
    assert ph["prefill"]["end"] <= ph["decode"]["start"]
    assert [r["request_id"] for r in json.loads(ptl)["requests"]] == \
        [prec["request_id"]]
    assert len(json.loads(jtl)["requests"]) == 1


DEBUG_ROUTES = [("GET", "/debug/requests/x"), ("GET", "/debug/timeline"),
                ("POST", "/debug/profile"), ("GET", "/debug/profile"),
                ("GET", "/debug/kernels"), ("POST", "/debug/kernels/reset")]


@pytest.mark.parametrize("method,path", DEBUG_ROUTES)
async def test_debug_routes_404_without_the_debug_surface(method, path):
    """``debug_endpoints=False`` (``--no-debug-endpoints``): every /debug
    route is a plain 404 on both servers (the port's /debug/kernels
    included), serving goes on, and nothing is recorded."""
    async with _Servers(debug_endpoints=False) as s:
        (js, _), (ps, _) = await s.raw(
            method, path, {} if method == "POST" else None)
        (jc, _), (pc, _) = await s.raw("POST", "/v1/completions", {
            "prompt": "abc", "max_tokens": 2, "temperature": 0})
        assert s.port_server.engine.recorder is None
        assert s.port_server.profiler is None
    assert js == ps == 404
    assert jc == pc == 200


@pytest.mark.parametrize("method,path", DEBUG_ROUTES)
async def test_debug_routes_need_the_key(method, path):
    """With an API key every /debug route is 401 without it on both
    servers (timelines leak prompt sizes; a profile arms device tracing),
    and the port's answers with it."""
    async with _Servers(api_key=KEY) as s:
        (js, _), (ps, _) = await s.raw(
            method, path, {} if method == "POST" else None)
        auth = {"Authorization": f"Bearer {KEY}"}
        body = {"duration_s": 0.1} if path == "/debug/profile" else (
            {} if method == "POST" else None)
        ok, _, _ = await _http(s.port, method, path, body, auth)
        (_, jtl), (_, ptl) = await s.raw(
            "GET", "/debug/timeline?max_requests=-5", headers=auth)
        await asyncio.sleep(0.3)    # a profile window armed above ends
    assert js == ps == 401
    assert ok == (404 if path == "/debug/requests/x" else 200)
    assert json.loads(ptl)["requests"] == json.loads(jtl)["requests"] == []


async def test_profile_capture_lifecycle():
    """POST /debug/profile arms a torch.profiler window (200), a second arm
    meanwhile is 409, a bad body 400; the status reads finished and the
    trace file holds the capture's events."""
    trace_dir = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                             f"pstpu-obs-profile-{os.getpid()}")
    async with _Servers() as s:
        p = s.port
        st0, _, status0 = await _http(p, "GET", "/debug/profile")
        st1, _, armed = await _http(p, "POST", "/debug/profile",
                                    {"duration_s": 0.5, "trace_dir": trace_dir})
        st2, _, _ = await _http(p, "POST", "/debug/profile", {"duration_s": 0.2})
        st3, _, _ = await _http(p, "POST", "/debug/profile", {"duration_s": "x"})
        st4, _, _ = await _http(p, "POST", "/debug/profile", {"duration_s": 301})
        await _http(p, "POST", "/v1/completions", {
            "prompt": "profiled", "max_tokens": 4, "temperature": 0})
        for _ in range(100):
            status = json.loads((await _http(p, "GET", "/debug/profile"))[2])
            if status["active"] is None:
                break
            await asyncio.sleep(0.05)
    assert st0 == 200 and json.loads(status0)["available"] is True
    assert st1 == 200 and json.loads(armed)["status"] == "armed"
    assert (st2, st3, st4) == (409, 400, 400)
    assert status["active"] is None
    last = status["last"]
    assert last["trace_dir"] == trace_dir and "error" not in last
    with open(last["trace_file"]) as f:
        trace = json.load(f)
    assert trace["traceEvents"]


async def test_preempt_and_restore_hooks_record():
    """The scheduler's hooks reach the recorder (the JAX test's wiring
    check): a preempt event, a restore event with its tokens, and the
    restore round-trip histogram."""
    eng = _port_engine()
    try:
        eng.recorder.start("r1")
        eng.scheduler.on_preempt("r1")
        eng.scheduler.on_restore("r1", 32, 0.015)
        got = eng.recorder.get("r1")["records"][0]
    finally:
        eng.shutdown()
    assert [e["event"] for e in got["events"]] == ["preempt", "restore"]
    assert got["events"][1]["tokens"] == 32
    assert eng.lifecycle.restore_round_trip.count == 1


# --------------------------------------------------------------- tracing
TID, SID = "ab" * 16, "cd" * 8


@pytest.mark.parametrize("header", [
    f"00-{TID}-{SID}-01", f"00-{TID}-{SID}-00", None, "garbage",
    f"00-{TID}-short-01", f"00-{'0' * 32}-{SID}-01", f"00-{TID}-{SID}-0",
    f"00-{TID}-{SID}-012", f"00-{TID.upper()}-{SID}-01",
    f"00-{'zz' * 16}-{SID}-01"])
def test_parse_traceparent_matches_jax(header):
    assert tracing.parse_traceparent(header) == \
        jax_tracing.parse_traceparent(header)


def _bare(m, maxsize=4):
    """A tracer of module ``m`` without its exporter thread."""
    t = m.Tracer.__new__(m.Tracer)
    t.service_name = "svc"
    t._queue = queue.Queue(maxsize=maxsize)
    t.spans_dropped_total = 0
    t.on_drop = None
    return t


def test_sampled_flag_propagates_not_hardcoded():
    t = _bare(tracing)
    span = t.start_span("x", parent=f"00-{TID}-{SID}-00")
    assert span.flags == "00"
    assert span.traceparent == f"00-{TID}-{span.span_id}-00"
    assert t.start_span("y", parent=None).traceparent.endswith("-01")


def test_queue_full_spans_are_counted_not_silent():
    t = _bare(tracing, maxsize=1)
    hits = []
    t.on_drop = lambda: hits.append(1)
    t.end_span(t.start_span("a"))
    t.end_span(t.start_span("b"))
    assert t.spans_dropped_total == 1 and hits == [1]


def test_otlp_payload_matches_jax():
    """The same span through both exporters' payload builders: the same
    OTLP JSON but for the scope's name."""
    payloads = []
    for m in (jax_tracing, tracing):
        t = _bare(m)
        span = t.start_span("router.route", parent=f"00-{TID}-{SID}-01",
                            attributes={"a": 1, "b": 0.5, "c": True, "d": "x"},
                            kind=m.SPAN_KIND_CLIENT)
        span.span_id, span.start_ns, span.end_ns = SID, 10, 1010
        span.events.append(("prestream_failure", 20,
                            {"backend": "http://e1", "status": 503}))
        p = t._otlp_payload([span])
        p["resourceSpans"][0]["scopeSpans"][0].pop("scope")
        payloads.append(p)
    assert payloads[0] == payloads[1]
    otlp = payloads[1]["resourceSpans"][0]["scopeSpans"][0]["spans"][0]
    assert otlp["kind"] == 3 and otlp["parentSpanId"] == SID


class _Collector:
    """A stub OTLP/HTTP collector (aiohttp), spans by scope name."""

    def __init__(self):
        self.batches = []

    async def start(self):
        app = web.Application()

        async def traces(req):
            self.batches.append(json.loads(await req.read()))
            return web.json_response({})

        app.router.add_post("/v1/traces", traces)
        self.runner = web.AppRunner(app)
        await self.runner.setup()
        site = web.TCPSite(self.runner, "127.0.0.1", 0)
        await site.start()
        port = site._server.sockets[0].getsockname()[1]
        return f"http://127.0.0.1:{port}"

    def spans(self, scope):
        return [(rs, sp) for b in self.batches for rs in b["resourceSpans"]
                for ss in rs["scopeSpans"] if ss["scope"]["name"] == scope
                for sp in ss["spans"]]

    async def wait(self, scope, n, seconds=15.0):
        for _ in range(int(seconds / 0.05)):
            if len(self.spans(scope)) >= n:
                break
            await asyncio.sleep(0.05)
        return self.spans(scope)


def _reset_both():
    jax_tracing.reset_tracer()
    tracing.reset_tracer()


async def test_spans_export_and_parent_child_linkage():
    col = _Collector()
    base = await col.start()
    try:
        router = tracing.Tracer("router-test", base)
        with router.span("router.route /v1/chat/completions",
                         attributes={"backend": "http://e1"}) as parent:
            engine = tracing.Tracer("engine-test", base)
            with engine.span("engine /v1/chat/completions",
                             parent=parent.traceparent):
                pass
        router.close()
        engine.close()
        spans = await col.wait("production_stack_tpu_torch", 2)
    finally:
        await col.runner.cleanup()
    by = {sp["name"]: (rs, sp) for rs, sp in spans}
    rrs, rsp = by["router.route /v1/chat/completions"]
    ers, esp = by["engine /v1/chat/completions"]
    svc = [a["value"]["stringValue"] for rs in (rrs, ers)
           for a in rs["resource"]["attributes"] if a["key"] == "service.name"]
    assert svc == ["router-test", "engine-test"]
    assert esp["traceId"] == rsp["traceId"]
    assert esp["parentSpanId"] == rsp["spanId"] and "parentSpanId" not in rsp


def test_tracer_disabled_without_env(monkeypatch):
    monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT", raising=False)
    tracing.reset_tracer()
    assert tracing.get_tracer() is None and tracing.spans_dropped_total() == 0
    tracing.reset_tracer()


def _span_view(sp):
    """A span without ids and times: name, kind, attribute keys (and the
    values that are not timing), status."""
    attrs = {a["key"]: next(iter(a["value"].values()))
             for a in sp["attributes"]}
    for k in ("request.id", "seconds"):
        attrs.pop(k, None)
    return sp["name"], sp["kind"], attrs, sp["status"]


@pytest.mark.parametrize("stream", [False, True])
async def test_server_spans_match_jax(monkeypatch, stream):
    """A /v1 request with a client traceparent, to both servers with an
    OTLP endpoint set: each exports the server span "engine <path>" (kind
    2, the caller's trace id, parented to the caller's span, method, model
    and status attributes) and the request's phase spans (engine.
    queue_wait / prefill / decode, kind 2, parented to the server span,
    with the phases' attributes), equal between the two apart from ids and
    times; the phase spans lie inside the server span."""
    col = _Collector()
    base = await col.start()
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", base)
    monkeypatch.setenv("OTEL_SERVICE_NAME", "pstpu-obs")
    _reset_both()
    try:
        async with _Servers() as s:
            (js, _), (ps, _) = await s.raw(
                "POST", "/v1/completions",
                {"prompt": "traced", "max_tokens": 6, "temperature": 0,
                 "ignore_eos": True, "stream": stream},
                {"traceparent": f"00-{TID}-{SID}-01"})
            (jm, _), (pm, _) = await s.raw("GET", "/metrics")
            got = {scope: await col.wait(scope, 4) for scope in
                   ("production_stack_tpu", "production_stack_tpu_torch")}
    finally:
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT")
        _reset_both()
        await col.runner.cleanup()
    assert js == ps == jm == pm == 200
    views = {}
    for scope, spans in got.items():
        spans = [sp for _, sp in spans]
        server = [sp for sp in spans if sp["name"] == "engine /v1/completions"]
        assert len(server) == 1, scope
        server = server[0]
        assert server["traceId"] == TID and server["parentSpanId"] == SID
        phases = [sp for sp in spans if sp["name"].startswith("engine.")]
        assert {sp["name"] for sp in phases} == {
            "engine.queue_wait", "engine.prefill", "engine.decode"}
        for sp in phases:
            assert sp["traceId"] == TID
            assert sp["parentSpanId"] == server["spanId"]
            assert int(server["startTimeUnixNano"]) <= \
                int(sp["startTimeUnixNano"]) <= int(sp["endTimeUnixNano"]) \
                <= int(server["endTimeUnixNano"])
        views[scope] = sorted(_span_view(sp) for sp in [server] + phases)
    assert views["production_stack_tpu_torch"] == views["production_stack_tpu"]


async def test_dropped_spans_are_counted_and_rendered(monkeypatch):
    """A full export queue drops the server span and the phase spans of a
    request on both servers: the same count in both, and the port renders
    it as ``pstpu:trace_spans_dropped_total`` (``stats()`` reads it)."""
    monkeypatch.setenv("OTEL_EXPORTER_OTLP_ENDPOINT", "http://127.0.0.1:9")
    _reset_both()
    tracers = [m.get_tracer("pstpu-engine") for m in (jax_tracing, tracing)]
    for t in tracers:
        t._stop.set()           # no export: the queue stays full
        t._thread.join(timeout=5)
        t._queue = queue.Queue(maxsize=1)
        t._queue.put_nowait(None)
    try:
        async with _Servers() as s:
            (js, _), (ps, _) = await s.raw("POST", "/v1/completions", {
                "prompt": "dropped", "max_tokens": 5, "temperature": 0,
                "ignore_eos": True})
            (_, jm), (_, pm) = await s.raw("GET", "/metrics")
            stats = s.port_server.engine.stats()
    finally:
        for t in tracers:
            t._queue = queue.Queue()
        monkeypatch.delenv("OTEL_EXPORTER_OTLP_ENDPOINT")
        _reset_both()
    assert js == ps == 200
    assert tracers[1].spans_dropped_total == tracers[0].spans_dropped_total == 4
    assert stats["trace_spans_dropped_total"] == 4

    def rendered(text):
        line = [ln for ln in text.splitlines()
                if ln.startswith("pstpu:trace_spans_dropped_total{")]
        return float(line[0].rpartition(" ")[2])

    assert rendered(pm) == rendered(jm) == 4


# ------------------------------------------------------ routes and flags
ENGINE_ROUTES = [r for r in http_registry.ROUTES if "engine" in r.planes]


@pytest.mark.parametrize("route", ENGINE_ROUTES,
                         ids=[f"{r.method} {r.path}" for r in ENGINE_ROUTES])
def test_every_engine_route_is_registered(route):
    """Every route the registry lists for the engine plane resolves to a
    handler on the port's server (its path parameters filled in), and a
    debug route only with the debug surface on."""
    path = route.path.replace("{request_id}", "req-1")
    servers = {}
    for debug in (True, False):
        eng = _port_engine(debug_endpoints=debug)
        servers[debug] = OpenAIServer(eng, port=0)
        eng.shutdown()
    assert callable(servers[True]._match(route.method, path))
    if route.debug:
        with pytest.raises(port_api._HttpError) as e:
            servers[False]._match(route.method, path)
        assert e.value.status == 404
    else:
        assert callable(servers[False]._match(route.method, path))


def _jax_parser():
    """The JAX server's ArgumentParser, caught as it parses."""
    caught = {}
    orig = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        caught["p"] = self
        return orig(self, args, namespace)

    argparse.ArgumentParser.parse_args = grab
    try:
        jax_api.parse_args(["--model", "tiny-llama"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return caught["p"]


JAX_ACTIONS = [a for a in _jax_parser()._actions if a.option_strings
               and a.dest != "help"]

SAMPLE = {"--lora-modules": ["a=/nonexistent"], "--kv-remote-url":
          ["kv://127.0.0.1:1"], "--compilation-cache-dir": [""],
          "--served-model-name": ["served"], "--speculative-model":
          ["tiny-llama"], "--api-key": ["k"]}


def _sample(action):
    """A value the JAX server accepts for ``action`` (its default where it
    has one)."""
    flag = action.option_strings[0]
    if action.nargs == 0:
        return [flag]
    if flag in SAMPLE:
        return [flag] + SAMPLE[flag]
    if action.choices:
        return [flag, str(action.default or list(action.choices)[0])]
    if action.default is not None:
        return [flag, str(action.default)]
    return [flag, {int: "8", float: "0.5"}.get(action.type, "x")]


@pytest.mark.parametrize("action", JAX_ACTIONS,
                         ids=[a.option_strings[0] for a in JAX_ACTIONS])
def test_every_jax_flag_parses_on_the_port(action):
    """Every flag of the JAX server's ``parse_args`` parses on the port at
    a value the JAX server accepts, to the same destination and value;
    the engine config builds from it."""
    argv = ["--model", "tiny-llama", "--device", "cpu"] + _sample(action)
    jargs = jax_api.parse_args(argv[:2] + argv[4:])
    pargs = port_api.parse_args(argv)
    assert getattr(pargs, action.dest) == getattr(jargs, action.dest)
    if action.dest.startswith("speculative_") and action.dest != \
            "speculative_num_tokens":
        return    # needs --speculative-num-tokens, in both packages
    cfg = port_api.config_from_args(pargs)
    assert cfg.device == "cpu"


@pytest.mark.parametrize("flag,value,departs", [
    ("--sequence-parallel-size", "1", False),
    ("--sequence-parallel-size", "2", True),
    ("--data-parallel-size", "1", False),
    ("--data-parallel-size", "4", True),
    ("--compilation-cache-dir", "", False),
    ("--compilation-cache-dir", "/var/cache/pstpu", False),
    (None, None, False),
])
def test_unported_flags_refused_unless_inert(flag, value, departs):
    """Every one of these flags is served now: sp and dp at any degree
    (``departs``: other than the inert 1) and the compilation cache
    directory (the warm-up manifest's) reach the config as given, and the
    mesh counts the ranks."""
    argv = ["--model", "tiny-llama", "--device", "cpu"]
    if flag:
        argv += [flag, value]
    args = port_api.parse_args(argv)
    cfg = port_api.config_from_args(args)
    if flag == "--compilation-cache-dir":
        assert cfg.compilation_cache_dir == value
    elif flag:
        dest = flag[2:].replace("-", "_")
        assert getattr(cfg, dest) == int(value)
        assert cfg.mesh_devices == int(value)
    assert (cfg.mesh_devices > 1) == departs


def test_chart_flags_build_a_port_engine():
    """The values the Helm chart renders for an engine (memory fraction,
    prefix caching off, recorder sizes, no overlapped load) parse and reach
    the engine's config."""
    args = port_api.parse_args([
        "--model", "tiny-llama", "--device", "cpu", "--block-size", "8",
        "--gpu-memory-utilization", "0.5", "--no-enable-prefix-caching",
        "--max-num-batched-tokens", "128", "--flight-recorder-capacity",
        "16", "--flight-recorder-max-events", "64", "--no-overlap-weight-load",
        "--no-debug-endpoints", "--attn-impl", "xla"])
    cfg = port_api.config_from_args(args)
    assert (cfg.block_size, cfg.hbm_utilization, cfg.enable_prefix_caching,
            cfg.max_num_batched_tokens, cfg.flight_recorder_capacity,
            cfg.flight_recorder_max_events, cfg.debug_endpoints) == \
        (8, 0.5, False, 128, 16, 64, False)
    assert cfg.overlap_weight_load is False
    assert cfg.resolved_attn_impl(resolve_model_config("tiny-llama")) == \
        "window"
    eng = _port_engine(flight_recorder_capacity=2, flight_recorder_max_events=8)
    try:
        assert (eng.recorder.capacity, eng.recorder.max_events) == (2, 8)
    finally:
        eng.shutdown()


def test_event_schema_matches_jax():
    assert pfr.EVENT_NAMES == jfr.EVENT_NAMES
