"""The port's router end to end on the CPU, held against the JAX router.

Fake engines (``tests/fake_engine.py``, aiohttp) and port engines
(``tiny-llama-128dh``, float32, the JAX params through numpy) stand behind
each router in turn, on the same ports, and the same client requests go
through both: status, the registered headers and bodies up to ids and
timestamps, session affinity, failover before the stream starts, a backend
dying mid-stream resumed on the other, a TTFT deadline's 504, a breaker
that opens, both disagg hops over the port's Python cache server, a client
disconnect that aborts the engine's request, and two requests on one
kept-alive connection. Last, the router as a process: started by
``launch.launch_router`` under an import hook that refuses jax, jaxlib,
aiohttp, prometheus_client and requests (the gated router and both
controllers too), and by ``launch.py --router-args``."""

import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import time

import aiohttp
import pytest
from aiohttp.test_utils import TestServer

from production_stack_tpu.utils import SingletonMeta as JaxSingletons
from production_stack_tpu_torch.kv_offload import server as pserver
from production_stack_tpu_torch.server.api_server import OpenAIServer
from production_stack_tpu_torch.utils import SingletonMeta as PortSingletons
from tests.fake_engine import BASE_TOKEN, FakeEngine
from tests.test_router_e2e import router_args
from tests.test_torch_kv_offload import _thread_server
from tests.test_torch_surface import MODEL, _events, _port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUTERS = ("jax", "port")


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    PortSingletons._instances.clear()
    yield
    PortSingletons._instances.clear()


class Router:
    """The JAX router (aiohttp TestServer) or the port's (its own
    server), on the same args."""

    def __init__(self, which, args):
        self.which, self.args = which, args

    async def __aenter__(self):
        if self.which == "jax":
            from production_stack_tpu.router.app import build_app

            JaxSingletons._instances.clear()
            self._srv = TestServer(build_app(self.args))
            await self._srv.start_server()
            port = self._srv.port
        else:
            from production_stack_tpu_torch.router.app import build_app

            PortSingletons._instances.clear()
            self._app = build_app(self.args)
            port = await self._app.start("127.0.0.1", 0)
        self.url = f"http://127.0.0.1:{port}"
        self.session = aiohttp.ClientSession()
        return self

    async def __aexit__(self, *exc):
        await self.session.close()
        if self.which == "jax":
            await self._srv.close()
        else:
            await self._app.stop()

    async def call(self, method, path, body=None, headers=None):
        """(status, registered headers, normalized body) of one request."""
        async with self.session.request(method, self.url + path, json=body,
                                        headers=headers or {}) as resp:
            raw = await resp.read()
            hdrs = {k: resp.headers.get(k) for k in
                    ("Content-Type", "x-request-id", "Retry-After")}
            if (hdrs["x-request-id"] or "").startswith("cmpl-"):
                hdrs["x-request-id"] = "cmpl-<minted>"
            return resp.status, hdrs, _normalize(raw, resp.headers)

    async def counter(self, series):
        async with self.session.get(self.url + "/metrics") as resp:
            text = await resp.text()
        for line in text.splitlines():
            if line.startswith(series + " "):
                return float(line.rsplit(" ", 1)[1])
        return 0.0

    async def health(self):
        async with self.session.get(self.url + "/health") as resp:
            return resp.status, await resp.json()


_VOLATILE = ("id", "created", "system_fingerprint", "seed")


def _scrub(obj):
    if isinstance(obj, dict):
        return {k: _scrub(v) for k, v in obj.items() if k not in _VOLATILE}
    if isinstance(obj, list):
        return [_scrub(v) for v in obj]
    return obj


def _normalize(raw, headers):
    """A body up to ids and timestamps; an error message up to its
    transport detail (the two routers' client libraries name their
    exceptions differently)."""
    ctype = headers.get("Content-Type", "")
    text = raw.decode()
    if ctype.startswith("text/event-stream"):
        evs, done = _events(text)
        return [_scrub(e) for e in evs], done
    try:
        obj = json.loads(text)
    except ValueError:
        return text
    if isinstance(obj, dict) and isinstance(obj.get("error"), dict):
        err = dict(obj["error"])
        err["message"] = err["message"].split(": http")[0]
        return {"error": err}
    if isinstance(obj, dict) and obj.get("object") == "list":
        for m in obj.get("data", []):
            m.pop("created", None)
    return _scrub(obj)


class Fakes:
    """Fake engines on fixed ports, shared by both routers; ``reset``
    clears what a run left on them."""

    def __init__(self, n, **kw):
        self.engines = [FakeEngine(model="m1", speed=2000.0, **kw)
                        for _ in range(n)]

    async def __aenter__(self):
        self.servers = [TestServer(e.build_app()) for e in self.engines]
        for s in self.servers:
            await s.start_server()
        self.urls = [f"http://127.0.0.1:{s.port}" for s in self.servers]
        return self

    async def __aexit__(self, *exc):
        for s in self.servers:
            await s.close()

    def reset(self):
        for e in self.engines:
            e.heal()
            e.requests_seen.clear()
            e.headers_seen.clear()

    def seen(self):
        return [len(e.requests_seen) for e in self.engines]


def _args(urls, routing="roundrobin", **kw):
    return router_args(urls, ["m1"] * len(urls), routing=routing, **kw)


# ------------------------------------------------------------ fake engines
CALLS = [
    ("GET", "/v1/models", None, None),
    ("POST", "/v1/chat/completions", {"model": "m1", "max_tokens": 3,
     "messages": [{"role": "user", "content": "hi"}]}, {"x-request-id": "rid-1"}),
    ("POST", "/v1/chat/completions", {"model": "m1", "max_tokens": 4, "stream": True,
     "messages": [{"role": "user", "content": "hi"}]}, {"x-request-id": "rid-2"}),
    ("POST", "/v1/completions", {"model": "m1", "prompt": "x", "max_tokens": 2}, None),
    ("POST", "/v1/completions", {"model": "m1", "prompt": "x", "max_tokens": 5,
     "stream": True}, {"x-request-id": "rid-3"}),
    ("POST", "/v1/embeddings", {"model": "m1", "input": "x"}, None),
    ("POST", "/v1/chat/completions", {"messages": []}, None),
    ("POST", "/v1/chat/completions", {"model": "nope", "messages": []}, None),
    ("POST", "/v1/files", {}, None),
    ("GET", "/v1/batches/b1", None, None),
    ("GET", "/v1/unknown", None, None),
]


async def test_bodies_headers_and_spread_equal_the_jax_router():
    async with Fakes(2) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            async with Router(which, _args(fakes.urls)) as r:
                out = [await r.call(*c) for c in CALLS]
                st, hv = await r.health()
                out.append((st, sorted(hv), sorted(hv["circuit_breakers"].values())))
                # the raw bytes of an invalid JSON body
                async with r.session.post(r.url + "/v1/completions",
                                          data=b"{not json") as resp:
                    out.append((resp.status, (await resp.json())["error"]["message"]))
            runs[which] = (out, fakes.seen())
        assert runs["port"] == runs["jax"]
        statuses = [o[0] for o in runs["jax"][0]]
        assert statuses == [200, 200, 200, 200, 200, 200, 400, 404, 501, 501,
                            404, 200, 400]
        assert runs["jax"][0][2][1]["x-request-id"] == "rid-2"


async def test_session_affinity_equals_the_jax_router():
    async with Fakes(3) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            async with Router(which, _args(fakes.urls, "session",
                                           session_key="x-user-id")) as r:
                where = []
                for rnd in range(3):
                    for user in ("ann", "bob", "cid", "dee"):
                        before = fakes.seen()
                        st, _, _ = await r.call("POST", "/v1/chat/completions", {
                            "model": "m1", "max_tokens": 2, "stream": True,
                            "messages": [{"role": "user", "content": f"{user} {rnd}"}]},
                            {"x-user-id": user})
                        assert st == 200
                        where.append((user, [a - b for a, b in
                                             zip(fakes.seen(), before)].index(1)))
            runs[which] = where
        assert runs["port"] == runs["jax"]
        for user in ("ann", "bob", "cid", "dee"):
            assert len({e for u, e in runs["jax"] if u == user}) == 1


async def test_failover_before_the_stream_equals_the_jax_router():
    async with Fakes(2) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            fakes.engines[0].fail_for(60.0, 503)
            fakes.engines[1].refuse_connections = False
            async with Router(which, _args(fakes.urls, breaker_min_requests=50)) as r:
                retries0 = await r.counter(f'router_retries_total{{server="{fakes.urls[0]}"}}')
                fo0 = await r.counter(f'router_failovers_total{{server="{fakes.urls[0]}"}}')
                out = []
                for i in range(4):
                    out.append(await r.call("POST", "/v1/completions", {
                        "model": "m1", "prompt": "x", "max_tokens": 3,
                        "stream": bool(i % 2)}))
                out.append(await r.counter(
                    f'router_retries_total{{server="{fakes.urls[0]}"}}') - retries0)
                out.append(await r.counter(
                    f'router_failovers_total{{server="{fakes.urls[0]}"}}') - fo0)
            runs[which] = (out, fakes.seen())
        assert runs["port"] == runs["jax"]
        assert all(o[0] == 200 for o in runs["jax"][0][:4])
        assert runs["jax"][0][4] >= 1 and runs["jax"][0][5] >= 1


async def test_midstream_death_resumed_on_the_other_engine_like_jax():
    """A backend dies after 3 SSE chunks: the client gets one whole stream
    (every token once, [DONE], no 5xx) spliced from the survivor."""
    async with Fakes(2) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            async with Router(which, _args(fakes.urls)) as r:
                resumed0 = await r.counter('router_midstream_resumes_total{outcome="resumed"}')
                await r.call("POST", "/v1/completions",
                             {"model": "m1", "prompt": "probe", "max_tokens": 1})
                victim = next(e for e in fakes.engines if not e.requests_seen)
                victim.die_after_chunks, victim.die_once = 3, True
                st, _, (evs, done) = await r.call("POST", "/v1/completions", {
                    "model": "m1", "prompt": "x", "max_tokens": 8, "stream": True})
                toks = [t for e in evs for t in e.get("pstpu", {}).get("toks", [])]
                text = "".join(e["choices"][0].get("text", "") for e in evs)
                resumed = await r.counter(
                    'router_midstream_resumes_total{outcome="resumed"}') - resumed0
                resume = [b for e in fakes.engines for _, b in e.requests_seen
                          if b.get("resume_tokens")]
            runs[which] = (st, done, toks, text, resumed, len(resume))
        assert runs["port"] == runs["jax"]
        assert runs["jax"] == (200, True, [BASE_TOKEN + i for i in range(8)],
                               "Hello " * 8, 1.0, 1)


async def test_ttft_deadline_answers_504_like_jax():
    async with Fakes(1) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            fakes.engines[0].extra_latency = 3.0
            async with Router(which, _args(fakes.urls)) as r:
                t0 = time.monotonic()
                st, hv, body = await r.call("POST", "/v1/completions", {
                    "model": "m1", "prompt": "x", "max_tokens": 2, "stream": True},
                    {"x-ttft-deadline": "0.3"})
                took = time.monotonic() - t0
            runs[which] = (st, hv["Content-Type"], body)
            assert took < 2.9, (which, took)
        assert runs["port"] == runs["jax"]
        assert runs["jax"][0] == 504


async def test_breaker_opens_like_jax():
    async with Fakes(2) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            fakes.engines[0].refuse_connections = True
            async with Router(which, _args(fakes.urls, breaker_min_requests=2,
                                           breaker_open_duration=30.0)) as r:
                sts = [(await r.call("POST", "/v1/completions", {
                    "model": "m1", "prompt": "x", "max_tokens": 2}))[0]
                    for _ in range(6)]
                st, hv = await r.health()
                state = await r.counter(
                    f'router_circuit_state{{router="router",server="{fakes.urls[0]}"}}')
            runs[which] = (sts, hv["circuit_breakers"][fakes.urls[0]],
                           hv["circuit_breakers"][fakes.urls[1]], fakes.seen()[1])
            assert state in (0.0, 1.0)
        assert runs["port"] == runs["jax"]
        assert runs["jax"][:3] == ([200] * 6, "open", "closed")


def _keep_alive(url):
    """Two requests on one HTTP/1.1 connection: (statuses, one socket)."""
    host, port = url[len("http://"):].split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        out, socks = [], []
        for _ in range(2):
            conn.request("POST", "/v1/completions", body=json.dumps(
                {"model": "m1", "prompt": "x", "max_tokens": 2, "stream": True}),
                headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            out.append((resp.status, resp.read().decode().endswith("data: [DONE]\n\n")))
            socks.append(conn.sock)
        return out, socks[0] is socks[1] and socks[0] is not None
    finally:
        conn.close()


async def test_two_requests_on_one_kept_alive_connection():
    async with Fakes(1) as fakes:
        runs = {}
        for which in ROUTERS:
            fakes.reset()
            async with Router(which, _args(fakes.urls)) as r:
                runs[which] = await asyncio.get_running_loop().run_in_executor(
                    None, _keep_alive, r.url)
        assert runs["port"] == runs["jax"] == ([(200, True), (200, True)], True)


# ------------------------------------------------------------ port engines
class PortEngines:
    def __init__(self, n, **over):
        self.servers = [OpenAIServer(_port_engine(**over), port=0) for _ in range(n)]

    async def __aenter__(self):
        for s in self.servers:
            await s.start()
        self.urls = [f"http://127.0.0.1:{s.port}" for s in self.servers]
        return self

    async def __aexit__(self, *exc):
        for s in self.servers:
            if s._server is not None:
                await s.stop()
            s.engine.shutdown()


def _port_args(urls, routing="roundrobin", **kw):
    return router_args(urls, [MODEL] * len(urls), routing=routing, **kw)


async def test_port_engines_behind_each_router_give_equal_bodies():
    """Greedy and seeded chats and completions, streamed and not, through
    each router to two port engines: equal bodies up to ids."""
    bodies = [
        {"model": MODEL, "max_tokens": 6, "temperature": 0.0, "ignore_eos": True,
         "messages": [{"role": "user", "content": "route me"}]},
        {"model": MODEL, "max_tokens": 6, "temperature": 0.9, "seed": 5,
         "ignore_eos": True, "stream": True,
         "messages": [{"role": "user", "content": "route me too"}]},
        {"model": MODEL, "max_tokens": 5, "temperature": 0.0, "ignore_eos": True,
         "prompt": "the quick brown fox"},
        {"model": MODEL, "max_tokens": 5, "temperature": 0.0, "ignore_eos": True,
         "prompt": "the quick brown fox", "stream": True},
    ]
    async with PortEngines(2) as pe:
        runs = {}
        for which in ROUTERS:
            async with Router(which, _port_args(pe.urls)) as r:
                out = []
                for b in bodies:
                    path = "/v1/chat/completions" if "messages" in b else "/v1/completions"
                    out.append(await r.call("POST", path, b))
            runs[which] = out
        assert runs["port"] == runs["jax"]
        assert all(o[0] == 200 for o in runs["jax"])
        # The router opts into the resume payload on streams.
        evs, done = runs["jax"][1][2]
        assert done and sum(len(e["pstpu"]["toks"]) for e in evs) == 6


async def test_client_disconnect_aborts_the_engine_request():
    """A client that goes away mid-stream: the router closes its upstream
    request and the port engine aborts it (nothing left running), through
    either router."""
    async with PortEngines(1, max_model_len=256) as pe:
        eng = pe.servers[0].engine
        for which in ROUTERS:
            async with Router(which, _port_args(pe.urls)) as r:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", int(r.url.rsplit(":", 1)[1]))
                body = json.dumps({"model": MODEL, "prompt": "go on " * 4,
                                   "max_tokens": 200, "ignore_eos": True,
                                   "temperature": 0.0, "stream": True}).encode()
                writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
                             b"Content-Type: application/json\r\n"
                             b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
                await writer.drain()
                got = b""
                while b"data: " not in got:
                    got += await asyncio.wait_for(reader.read(4096), 60)
                assert eng.active_request_ids(), which
                writer.close()
                deadline = time.monotonic() + 30
                while (eng.active_request_ids()
                       or eng.stats()["num_requests_running"]) and \
                        time.monotonic() < deadline:
                    await asyncio.sleep(0.05)
                assert not eng.active_request_ids(), which
                assert eng.stats()["num_requests_running"] == 0, which


async def test_disagg_hops_give_the_jax_routers_tokens():
    """``--routing-logic disagg`` in front of a prefill-role and a
    decode-role port engine over the port's Python cache server: the
    prefill hop, then the decode hop's stream, with the JAX router's
    tokens; one handoff per request in both."""
    url, stop = _thread_server(pserver.serve_python)
    from tests.test_disagg import _router_args

    try:
        pre = OpenAIServer(_port_engine(role="prefill", kv_remote_url=url,
                                        enable_prefix_caching=False), port=0)
        dec = OpenAIServer(_port_engine(role="decode", kv_remote_url=url), port=0)
        await pre.start()
        await dec.start()
        urls = [f"http://127.0.0.1:{s.port}" for s in (pre, dec)]
        runs = {}
        for which in ROUTERS:
            async with Router(which, _router_args(urls, [MODEL, MODEL],
                                                  ["prefill", "decode"])) as r:
                h0 = await r.counter("router_disagg_handoffs_total")
                out = []
                for sp in (dict(temperature=0.0), dict(temperature=0.9, seed=11)):
                    out.append(await r.call("POST", "/v1/chat/completions", {
                        "model": MODEL, "stream": True, "max_tokens": 10,
                        "ignore_eos": True, **sp,
                        "messages": [{"role": "user", "content": "tell me a story"}]},
                        {"x-user-id": "u1"}))
                out.append(await r.call("POST", "/v1/completions", {
                    "model": MODEL, "prompt": "a completion, disaggregated",
                    "max_tokens": 6, "temperature": 0.0, "ignore_eos": True},
                    {"x-user-id": "u2"}))
                out.append(await r.counter("router_disagg_handoffs_total") - h0)
            runs[which] = out
        assert runs["port"] == runs["jax"]
        assert runs["jax"][-1] == 3.0
        assert [o[0] for o in runs["jax"][:3]] == [200, 200, 200]
        assert pre.engine.stats()["decode_dispatches_total"] == 0
    finally:
        for s in (pre, dec):
            await s.stop()
            s.engine.shutdown()
        stop()


# ------------------------------------------------------------------ process
HOOK = '''import sys
REFUSED = ("jax", "jaxlib", "aiohttp", "prometheus_client", "requests")
LOG = {log!r}
with open(LOG, "a") as f:
    f.write("installed\\n")

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            with open(LOG, "a") as f:
                f.write(name + "\\n")
            raise ImportError(f"{{name}} is refused on the card's installation")
        return None

sys.meta_path.insert(0, Refuse())
'''


async def test_router_process_serves_without_jax_aiohttp_prometheus_requests(
        tmp_path, monkeypatch):
    """``launch_router`` starts ``python -m
    production_stack_tpu_torch.router.app`` under an import hook refusing
    jax, jaxlib, aiohttp, prometheus_client and requests (as on the card's
    machine): it serves a streamed chat from a port engine through session
    and prefix-aware routing, and its /metrics carries the engine under
    ``server``."""
    from production_stack_tpu_torch.launch import launch_router

    hook_dir = tmp_path / "hook"
    hook_dir.mkdir()
    log = tmp_path / "imports.log"
    (hook_dir / "sitecustomize.py").write_text(HOOK.format(log=str(log)))
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(hook_dir)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                           if p]))
    loop = asyncio.get_running_loop()
    async with PortEngines(1) as pe:
        for flags in (["--routing-logic", "session", "--session-key", "x-user-id"],
                      ["--routing-logic", "prefix-aware", "--prefix-tokenizer",
                       MODEL, "--session-key", "x-user-id"]):
            router = await loop.run_in_executor(None, lambda: launch_router(
                pe.urls, [MODEL], flags + ["--engine-stats-interval", "1"],
                str(tmp_path)))
            try:
                async with aiohttp.ClientSession() as s:
                    async with s.post(router.url + "/v1/chat/completions", json={
                            "model": MODEL, "stream": True, "max_tokens": 6,
                            "temperature": 0.0, "ignore_eos": True,
                            "messages": [{"role": "user", "content": "hello"}]},
                            headers={"x-user-id": "u"}) as resp:
                        assert resp.status == 200
                        evs, done = _events(await resp.text())
                    assert done and sum(len(e["pstpu"]["toks"]) for e in evs) == 6
                    async with s.get(router.url + "/metrics") as resp:
                        text = await resp.text()
                assert f'vllm:router_ttft_seconds_count{{server="{pe.urls[0]}"}} 1.0' \
                    in text
            finally:
                assert router.stop() == 0, open(router.log_path).read()
    assert log.read_text().splitlines() == ["installed", "installed"], \
        log.read_text()


async def _gated_router_round(tmp_path, base_env):
    """The gated router (batch API, PII redaction, the semantic cache) as a
    process in front of a fake engine: a multipart upload run as a batch, a
    chat answered from the cache the second time, the series."""
    from production_stack_tpu_torch.launch import launch_router

    loop = asyncio.get_running_loop()
    async with Fakes(1) as fakes:
        router = await loop.run_in_executor(None, lambda: launch_router(
            fakes.urls, ["m1"], [
                "--enable-batch-api", "--file-storage-path", str(tmp_path / "files"),
                "--feature-gates", "SemanticCache=true,PIIDetection=true",
                "--pii-action", "redact", "--engine-stats-interval", "1"],
            str(tmp_path)))
        try:
            async with aiohttp.ClientSession() as s:
                form = aiohttp.FormData()
                form.add_field("file", json.dumps({"custom_id": "c0", "body": {
                    "model": "m1", "max_tokens": 2,
                    "messages": [{"role": "user", "content": "hi"}]}}).encode(),
                    filename="batch.jsonl")
                async with s.post(router.url + "/v1/files", data=form) as resp:
                    up = await resp.json()
                async with s.post(router.url + "/v1/batches",
                                  json={"input_file_id": up["id"]}) as resp:
                    batch = await resp.json()
                for _ in range(100):
                    await asyncio.sleep(0.2)
                    async with s.get(router.url + f"/v1/batches/{batch['id']}") as resp:
                        batch = await resp.json()
                    if batch["status"] == "completed":
                        break
                assert batch["request_counts"]["completed"] == 1, batch
                chat = {"model": "m1", "max_tokens": 2, "messages": [
                    {"role": "user", "content": "mail bob@example.com"}]}
                bodies = []
                for _ in range(2):
                    async with s.post(router.url + "/v1/chat/completions",
                                      json=chat) as resp:
                        bodies.append(await resp.json())
                async with s.get(router.url + "/metrics") as resp:
                    text = await resp.text()
            assert "cached" not in bodies[0] and bodies[1]["cached"] is True
            assert "vllm:semantic_cache_hits_total 1.0" in text
            assert "vllm:pii_requests_scanned_total 2.0" in text
            seen = json.dumps(fakes.engines[0].requests_seen)
            assert "bob@example.com" not in seen and "[REDACTED:email]" in seen
        finally:
            assert router.stop() == 0, open(router.log_path).read()


async def _controller_round(tmp_path, base_env, what):
    """``python -m production_stack_tpu_torch.controller`` (the operator)
    or ``.controller.lora_main`` against a fake Kubernetes API until it has
    reconciled its CR, then SIGTERM."""
    from tests.test_lora_controller import FakeK8s as FakeLoraK8s
    from tests.test_lora_controller import _peft_checkpoint
    from tests.test_staticroute_operator import FakeK8s, _cr, _serve

    if what == "operator":
        fake = FakeK8s()
        fake.staticroutes[("default", "route-a")] = _cr()
        module, extra = "production_stack_tpu_torch.controller", []
        done = lambda: fake.status_updates and fake.configmaps  # noqa: E731
    else:
        fake = FakeLoraK8s()
        src = tmp_path / "src"
        _peft_checkpoint(src)
        fake.adapters["a"] = {"metadata": {"name": "a", "namespace": "default"},
                              "spec": {"adapterSource": {
                                  "type": "local", "adapterName": "x",
                                  "adapterPath": str(src)}}}
        module = "production_stack_tpu_torch.controller.lora_main"
        extra = ["--adapters-dir", str(tmp_path / "shared")]
        done = lambda: fake.statuses.get("a", [{}])[-1].get("phase") == "Ready"  # noqa: E731
    runner, base = await _serve(fake.app())
    proc = subprocess.Popen(
        [sys.executable, "-m", module, "--api-base", base, "--namespace", "default",
         *extra], cwd=REPO, env=base_env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        for _ in range(300):
            if done() or proc.poll() is not None:
                break
            await asyncio.sleep(0.1)
        assert done(), proc.poll()
        assert proc.poll() is None
    finally:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
        await runner.cleanup()
    if what == "operator":
        cm = fake.configmaps[("default", "route-a-dynamic-config")]
        assert json.loads(cm["data"]["dynamic_config.json"])["static_models"] == "m1"
        assert fake.status_updates[-1][2]["configMapRef"] == "route-a-dynamic-config"
    else:
        assert (tmp_path / "shared" / "x" / "adapter_config.json").exists(), out


@pytest.mark.parametrize("what", ["gated-router", "operator", "lora-controller"])
async def test_gated_router_and_controllers_run_without_jax_aiohttp_prometheus_requests(
        tmp_path, monkeypatch, what):
    """The gated router (``launch_router`` with the batch API, PII
    redaction and the semantic cache), the StaticRoute operator and the
    LoraAdapter controller as processes under the import hook that refuses
    jax, jaxlib, aiohttp, prometheus_client and requests: each serves or
    reconciles, and none of them imports a refused module."""
    hook_dir = tmp_path / "hook"
    hook_dir.mkdir()
    log = tmp_path / "imports.log"
    (hook_dir / "sitecustomize.py").write_text(HOOK.format(log=str(log)))
    path = os.pathsep.join([str(hook_dir), REPO] + [
        p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p])
    monkeypatch.setenv("PYTHONPATH", path)
    env = dict(os.environ, PYTHONPATH=path)
    if what == "gated-router":
        await _gated_router_round(tmp_path, env)
    else:
        await _controller_round(tmp_path, env, what)
    assert log.read_text().splitlines() == ["installed"], log.read_text()


def test_launch_router_args_starts_the_router_before_cpu_engines(tmp_path):
    """``python -m production_stack_tpu_torch.launch --router-args ...``:
    the JSON line carries ``router_url``; a request through it is served;
    SIGTERM stops the router and drains the engine."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu_torch.launch",
         "--model", "tiny-llama", "--device", "cpu", "--num-engines", "1",
         "--log-dir", str(tmp_path), "--router-args",
         "--routing-logic session --session-key x-user-id", "--",
         "--max-model-len", "128", "--num-kv-blocks", "32", "--max-num-seqs", "2",
         "--no-warmup"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO)
    try:
        line = ""
        deadline = time.monotonic() + 240
        while not line.startswith("{") and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line or proc.poll() is None, "launcher exited"
        info = json.loads(line)
        conn = http.client.HTTPConnection(info["router_url"][len("http://"):],
                                          timeout=60)
        conn.request("POST", "/v1/completions", body=json.dumps({
            "model": "tiny-llama", "prompt": "hi", "max_tokens": 3,
            "temperature": 0.0, "ignore_eos": True}),
            headers={"Content-Type": "application/json", "x-user-id": "u"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200 and body["usage"]["completion_tokens"] == 3
        conn.close()
        assert info["router_pid"] not in info["pids"]
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(90)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0
    logs = "".join(open(p).read() for p in info["logs"])
    assert "Drain complete" in logs
