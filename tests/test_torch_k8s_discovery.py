"""The port's ``K8sPodIPServiceDiscovery`` (``http.client`` in a daemon
thread) held against the JAX class (aiohttp on a loop of its own) on the
same fake Kubernetes pods API (``tests/test_k8s_discovery.py``'s
``FakeK8sPods``): the endpoint lists and the API calls of the four
scenarios there (watch events and readiness, reconnect with LIST
reconciliation and resourceVersion, an API error, model probes), then
pstpu-role labels, a kept discovery age, an event over 64 KiB, the
VLLM_API_KEY probe, the in-cluster HTTPS endpoint with its certificate
fallback, health, and both routers started with ``--service-discovery
k8s`` in front of a fake engine."""

import asyncio
import os
import ssl
import time

import pytest
from aiohttp import web
from aiohttp.test_utils import TestServer

from production_stack_tpu.router import service_discovery as jax_sd
from production_stack_tpu_torch.router import service_discovery as port_sd
from production_stack_tpu_torch.utils import SingletonMeta as PortSingletons
from tests.fake_engine import FakeEngine
from tests.test_k8s_discovery import FakeK8sPods, _pod, _serve, _shutdown
from tests.test_torch_router_e2e import ROUTERS, Router, _args

SD = {"jax": jax_sd, "port": port_sd}
TLS_PEM = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fake_kube_api.pem")


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    PortSingletons._instances.clear()
    yield
    PortSingletons._instances.clear()


def _view(disc):
    return sorted((ep.url, tuple(ep.model_names), ep.pod_name, ep.role)
                  for ep in disc.get_endpoint_info())


async def _settle(disc, want, timeout=5.0):
    """The endpoint view once it equals ``want`` (or at the deadline)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if _view(disc) == want:
            break
        await asyncio.sleep(0.02)
    return _view(disc)


def _disc(which, base, **kw):
    return SD[which].K8sPodIPServiceDiscovery(
        namespace="default", port=kw.pop("port", 9000), api_base=base, token="",
        **kw)


async def _watching(fake, timeout=5.0):
    """Until a watch stream is open on ``fake`` (an event pushed before
    then would be lost)."""
    deadline = time.monotonic() + timeout
    while not fake._watchers and time.monotonic() < deadline:
        await asyncio.sleep(0.02)


A = ("http://127.0.0.1:9000", (), "pod-a", None)
B = ("http://127.0.0.2:9000", (), "pod-b", None)


async def _watch_and_readiness(which):
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _pod("pod-a")
    srv, base = await _serve(fake.app())
    disc = _disc(which, base, probe_models=False)
    trace = []
    try:
        trace.append(await _settle(disc, [A]))
        await _watching(fake)
        for etype, pod, want in (
                ("MODIFIED", _pod("pod-a", ready=False), []),
                ("MODIFIED", _pod("pod-a", ready=True), [A]),
                ("ADDED", _pod("pod-b", ip="127.0.0.2"), [A, B]),
                ("DELETED", _pod("pod-b", ip="127.0.0.2"), [A])):
            fake.push(etype, pod)
            trace.append(await _settle(disc, want))
        fake.push("ADDED", _pod("pod-c", with_ip=False))
        await asyncio.sleep(0.2)
        trace.append(_view(disc))
        trace.append(disc.get_health())
    finally:
        await _shutdown(disc, fake, srv)
    return trace, fake.list_calls, fake.watch_calls


async def _reconnect(which):
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _pod("pod-a")
    srv, base = await _serve(fake.app())
    disc = _disc(which, base, probe_models=False, label_selector="app=engine")
    trace = []
    try:
        trace.append(await _settle(disc, [A]))
        await _watching(fake)
        # The pod dies while the stream is down: the DELETED event is never
        # delivered, so the reconnect's LIST must reconcile it away.
        del fake.pods["pod-a"]
        fake.end_watch()
        trace.append(await _settle(disc, []))
        deadline = time.monotonic() + 5
        while len(fake.watch_calls) < 2 and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
    finally:
        await _shutdown(disc, fake, srv)
    return trace, fake.list_calls[:2], fake.watch_calls[:2]


async def _api_error(which):
    fake = FakeK8sPods()
    fake.fail_next_list = True
    fake.pods["pod-a"] = _pod("pod-a")
    srv, base = await _serve(fake.app())
    disc = _disc(which, base, probe_models=False)
    try:
        trace = [await _settle(disc, [A], timeout=8.0), len(fake.list_calls)]
    finally:
        await _shutdown(disc, fake, srv)
    return trace, fake.list_calls[:2], fake.watch_calls[:1]


async def _probed(which):
    engine = FakeEngine(model="m-probed")
    esrv = TestServer(engine.build_app())
    await esrv.start_server()
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _pod("pod-a")
    srv, base = await _serve(fake.app())
    disc = _disc(which, base, port=esrv.port)
    want = [(f"http://127.0.0.1:{esrv.port}", ("m-probed",), "pod-a", None)]
    try:
        trace = [await _settle(disc, want)]
    finally:
        await _shutdown(disc, fake, srv)
        await esrv.close()
    return [[(u.rsplit(":", 1)[0],) + tuple(rest) for u, *rest in v] for v in trace], \
        fake.list_calls, fake.watch_calls[:1]


SCENARIOS = {"watch_and_readiness": _watch_and_readiness, "reconnect": _reconnect,
             "api_error": _api_error, "probed": _probed}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
async def test_endpoint_lists_and_api_calls_equal_jax(scenario):
    runs = {w: await SCENARIOS[scenario](w) for w in ROUTERS}
    assert runs["port"] == runs["jax"]
    trace, lists, watches = runs["jax"]
    if scenario == "reconnect":
        # each watch resumes from its own LIST's resourceVersion
        assert [w["resourceVersion"] for w in watches] == ["101", "102"]
        assert all(c["labelSelector"] == "app=engine" for c in lists + watches)
    if scenario == "api_error":
        assert trace == [[A], 2]


def _labelled(name, role, ip="127.0.0.1", big=0):
    pod = _pod(name, ip=ip)
    pod["metadata"]["labels"] = {"pstpu-role": role} if role is not None else {}
    if big:
        pod["metadata"]["annotations"] = {"blob": "x" * big}
    return pod


async def _labels_and_ages(which):
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _labelled("pod-a", " Prefill ")
    srv, base = await _serve(fake.app())
    disc = _disc(which, base, probe_models=False)
    trace = []
    try:
        trace.append(await _settle(disc, [A[:3] + ("prefill",)]))
        born = disc.get_endpoint_info()[0].added_timestamp
        await _watching(fake)
        # a typo'd role is role-less; the pod keeps its discovery age
        fake.push("MODIFIED", _labelled("pod-a", "bogus"))
        trace.append(await _settle(disc, [A]))
        trace.append(disc.get_endpoint_info()[0].added_timestamp == born)
        # an event over 64 KiB (a pod's managedFields, env, volumes)
        fake.push("MODIFIED", _labelled("pod-a", "decode", big=300_000))
        trace.append(await _settle(disc, [A[:3] + ("decode",)]))
        fake.push("ADDED", _labelled("pod-b", "unified", ip="127.0.0.2", big=100_000))
        trace.append(await _settle(disc, [A[:3] + ("decode",), B[:3] + ("unified",)]))
        # a new IP is a new endpoint: a fresh age
        fake.push("MODIFIED", _labelled("pod-a", "decode", ip="127.0.0.3"))
        want = [B[:3] + ("unified",), ("http://127.0.0.3:9000", (), "pod-a", "decode")]
        trace.append(await _settle(disc, want))
        trace.append(disc.get_endpoint_info()[0].added_timestamp > born
                     if disc.get_endpoint_info()[0].pod_name == "pod-a" else
                     disc.get_endpoint_info()[1].added_timestamp > born)
        trace.append(disc.get_health())
        disc._watch_alive = time.time() - 121
        trace.append(disc.get_health())
    finally:
        await _shutdown(disc, fake, srv)
    return trace


async def test_roles_ages_large_events_and_health_equal_jax():
    runs = {w: await _labels_and_ages(w) for w in ROUTERS}
    assert runs["port"] == runs["jax"]
    assert runs["jax"][2] is True and runs["jax"][-2:] == [True, False]


async def _probe_auth(which, monkeypatch):
    seen = []

    async def models(request):
        seen.append(request.headers.get("Authorization"))
        return web.json_response({"object": "list", "data": [{"id": "m-a"},
                                                             {"id": "m-b"}]})

    app = web.Application()
    app.router.add_get("/v1/models", models)
    esrv = TestServer(app)
    await esrv.start_server()
    monkeypatch.setenv("VLLM_API_KEY", "sekret")
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _pod("pod-a")
    srv, base = await _serve(fake.app())
    disc = _disc(which, base, port=esrv.port)
    try:
        view = await _settle(disc, [(f"http://127.0.0.1:{esrv.port}", ("m-a", "m-b"),
                                     "pod-a", None)])
    finally:
        await _shutdown(disc, fake, srv)
        await esrv.close()
    return [v[1:] for v in view], seen[:1]


async def test_model_probe_authenticates_like_jax(monkeypatch):
    runs = {w: await _probe_auth(w, monkeypatch) for w in ROUTERS}
    assert runs["port"] == runs["jax"] == ([(("m-a", "m-b"), "pod-a", None)],
                                           ["Bearer sekret"])


async def _serve_tls(app):
    """The fake API server over HTTPS (a throwaway self-signed certificate
    for 127.0.0.1): the in-cluster endpoint's scheme."""
    ctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
    ctx.load_cert_chain(TLS_PEM)
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0, ssl_context=ctx)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1]


class _TlsServer:
    def __init__(self, runner):
        self.runner = runner

    async def close(self):
        await self.runner.cleanup()


async def _in_cluster(which, monkeypatch):
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _pod("pod-a")
    runner, port = await _serve_tls(fake.app())
    monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
    monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(port))
    disc = SD[which].K8sPodIPServiceDiscovery(namespace="default", port=9000,
                                              probe_models=False)
    try:
        base = disc._api_base
        view = await _settle(disc, [A])
    finally:
        await _shutdown(disc, fake, _TlsServer(runner))
    return base == f"https://127.0.0.1:{port}", view, disc._token


async def test_in_cluster_https_endpoint_equals_jax(monkeypatch):
    """No service-account CA here: both fall back to an unverified TLS
    context, and find no token."""
    runs = {w: await _in_cluster(w, monkeypatch) for w in ROUTERS}
    assert runs["port"] == runs["jax"] == (True, [A], None)


async def test_close_ends_the_watch_thread_at_once():
    """``close()`` shuts the open stream's socket: the thread leaves without
    waiting for the next event."""
    fake = FakeK8sPods()
    fake.pods["pod-a"] = _pod("pod-a")
    srv, base = await _serve(fake.app())
    disc = _disc("port", base, probe_models=False)
    try:
        assert await _settle(disc, [A]) == [A]
        await _watching(fake)
        disc.close()
        t0 = time.monotonic()
        while disc._thread.is_alive() and time.monotonic() - t0 < 5:
            await asyncio.sleep(0.02)
        assert not disc._thread.is_alive()
        assert time.monotonic() - t0 < 2
    finally:
        await _shutdown(disc, fake, srv)


async def test_routers_with_k8s_discovery_serve_and_drop_an_unready_pod(monkeypatch):
    """Both routers started with ``--service-discovery k8s`` (the chart's
    default) find a ready pod on the in-cluster HTTPS endpoint, serve a
    chat through it, and drop it when it turns unready: /v1/models empty,
    chats 404 (no backend serves the model)."""
    engine = FakeEngine(model="m1", speed=2000.0)
    esrv = TestServer(engine.build_app())
    await esrv.start_server()
    runs = {}
    for which in ROUTERS:
        fake = FakeK8sPods()
        pod = _pod("engine-0")
        pod["metadata"]["labels"] = {"app": "engine"}
        fake.pods["engine-0"] = pod
        runner, port = await _serve_tls(fake.app())
        monkeypatch.setenv("KUBERNETES_SERVICE_HOST", "127.0.0.1")
        monkeypatch.setenv("KUBERNETES_SERVICE_PORT", str(port))
        args = _args(["http://unused:1"], service_discovery="k8s",
                     k8s_namespace="default", k8s_port=esrv.port,
                     k8s_label_selector="app=engine")
        chat = {"model": "m1", "max_tokens": 3,
                "messages": [{"role": "user", "content": "hi"}]}
        out = []
        try:
            async with Router(which, args) as r:
                for _ in range(100):
                    st, _, models = await r.call("GET", "/v1/models")
                    if models["data"]:
                        break
                    await asyncio.sleep(0.05)
                out.append((st, models))
                out.append(await r.call("POST", "/v1/chat/completions", chat))
                out.append((await r.health())[0])
                await _watching(fake)
                unready = _pod("engine-0", ready=False)
                unready["metadata"]["labels"] = {"app": "engine"}
                t0 = time.monotonic()
                fake.push("MODIFIED", unready)
                while time.monotonic() - t0 < 5:
                    st, _, models = await r.call("GET", "/v1/models")
                    if not models["data"]:
                        break
                    await asyncio.sleep(0.05)
                out.append((st, models, time.monotonic() - t0 < 5))
                out.append((await r.call("POST", "/v1/chat/completions", chat))[0])
            out.append([c.get("labelSelector") for c in fake.list_calls[:1]])
        finally:
            fake.closing = True
            for _ in range(5):
                fake.end_watch()
                await asyncio.sleep(0.05)
            await runner.cleanup()
        runs[which] = out
    await esrv.close()
    assert runs["port"] == runs["jax"]
    out = runs["jax"]
    assert len(out[0][1]["data"]) == 1 and out[1][0] == 200
    assert out[3][1]["data"] == [] and out[3][2] and out[4] == 404
