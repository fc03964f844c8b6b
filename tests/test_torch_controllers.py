"""The port's two controllers (``production_stack_tpu_torch/controller/``,
on ``urllib``) held against the JAX ones (aiohttp) on the same fake
Kubernetes APIs (``tests/test_staticroute_operator.py`` and
``tests/test_lora_controller.py``): the StaticRoute operator's ConfigMaps,
status patches, health thresholds and requeue periods, its ConfigMap
hot-reloading the port's router, and its run loop; the LoraAdapter
controller's phases for a local copy, a missing source, a directory that is
no PEFT checkpoint, an unknown source type, the huggingface path without
its package, an unchanged Ready CR and an edited one; and both entry
points' flags and in-cluster defaults."""

import asyncio
import json
import os
import sys

import aiohttp
import pytest
from aiohttp import web

from production_stack_tpu.controller import __main__ as jax_main
from production_stack_tpu.controller import lora_main as jax_lora_main
from production_stack_tpu.controller import loraadapter as jax_lora
from production_stack_tpu.controller import staticroute as jax_sr
from production_stack_tpu_torch.controller import __main__ as port_main
from production_stack_tpu_torch.controller import lora_main as port_lora_main
from production_stack_tpu_torch.controller import loraadapter as port_lora
from production_stack_tpu_torch.controller import staticroute as port_sr
from production_stack_tpu_torch.utils import SingletonMeta as PortSingletons
from tests.test_lora_controller import FakeK8s as FakeLoraK8s
from tests.test_lora_controller import _peft_checkpoint
from tests.test_staticroute_operator import FakeK8s, _cr, _serve

SR = {"jax": jax_sr, "port": port_sr}
LORA = {"jax": jax_lora, "port": port_lora}
WHICH = ("jax", "port")


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    PortSingletons._instances.clear()
    yield
    PortSingletons._instances.clear()


def _untimed(obj):
    """A status up to its timestamps."""
    if isinstance(obj, dict):
        return {k: _untimed(v) for k, v in obj.items()
                if k not in ("lastAppliedTime", "lastTransitionTime", "lastUpdated")}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_untimed(v) for v in obj)
    return obj


class _Client:
    """Each package's client: the JAX reconcilers take an aiohttp session,
    the port's a ``KubeClient``."""

    def __init__(self, which):
        self.which = which

    async def __aenter__(self):
        if self.which == "jax":
            self.obj = aiohttp.ClientSession()
            return {"session": self.obj}
        self.obj = port_sr.KubeClient()
        return {"client": self.obj}

    async def __aexit__(self, *exc):
        await self.obj.close()


CRS = [
    _cr(),
    _cr(name="route-b", backends="http://e1:8000,http://e2:8000", models="m1,m2",
        logic="session", session_key="x-user-id"),
    _cr(name="route-c", ns="serving", logic="cache_aware_load_balancing",
        session_key="x-s", router_ref={"kind": "Service", "name": "missing"}),
    _cr(name="route-d", router_ref={"kind": "Deployment", "name": "x"},
        health={"periodSeconds": 120}),
]


async def _reconcile_all(which):
    fake = FakeK8s()
    runner, base = await _serve(fake.app())
    try:
        async with _Client(which) as kw:
            rec = SR[which].StaticRouteReconciler(base, token="t0k", **kw)
            statuses = [await rec.reconcile(cr) for cr in CRS]
            # a second pass updates (PUT) what the first created (POST)
            statuses.append(await rec.reconcile(_cr(logic="session",
                                                    session_key="x-user-id")))
    finally:
        await runner.cleanup()
    requeue = [rec.requeue_after(SR[which].StaticRoute.from_manifest(cr)) for cr in CRS]
    return (_untimed(statuses), fake.configmaps, _untimed(fake.status_updates),
            requeue, [vars(SR[which].StaticRoute.from_manifest(cr)) for cr in CRS])


async def test_configmaps_status_patches_and_requeue_equal_jax():
    runs = {w: await _reconcile_all(w) for w in WHICH}
    jr, pr = runs["jax"], runs["port"]
    assert pr[:4] == jr[:4]
    assert [{k: (vars(v) if k == "health_check" else v) for k, v in d.items()}
            for d in pr[4]] == \
        [{k: (vars(v) if k == "health_check" else v) for k, v in d.items()}
         for d in jr[4]]
    statuses, cms, patches, requeue, _ = jr
    assert json.loads(cms[("default", "route-a-dynamic-config")]["data"][
        "dynamic_config.json"])["routing_logic"] == "session"
    assert [s["conditions"][0]["type"] for s in statuses] == ["HealthCheckSkipped"] * 5
    assert requeue == [300.0, 300.0, 60.0, 120.0]
    assert len(patches) == 5


async def _health_run(which):
    fake = FakeK8s()
    hits = {"n": 0}

    async def health(req):
        hits["n"] += 1
        if hits["n"] in (1, 2, 5):
            return web.json_response({"status": "bad"}, status=503)
        if hits["n"] == 6:
            await asyncio.sleep(2.0)         # over the probe's timeout
        return web.json_response({"status": "healthy"})

    router_app = web.Application()
    router_app.router.add_get("/health", health)
    router_runner, router_base = await _serve(router_app)
    fake.services[("default", "router-svc")] = {
        "spec": {"clusterIP": "127.0.0.1",
                 "ports": [{"port": int(router_base.rsplit(":", 1)[1])}]}}
    api_runner, base = await _serve(fake.app())
    cr = _cr(router_ref={"kind": "Service", "name": "router-svc"},
             health={"successThreshold": 2, "failureThreshold": 2,
                     "timeoutSeconds": 1})
    try:
        async with _Client(which) as kw:
            rec = SR[which].StaticRouteReconciler(base, **kw)
            seq = []
            for _ in range(8):
                st = await rec.reconcile(cr)
                c = st["conditions"][0]
                seq.append((c["type"], c["reason"],
                            c["message"].replace(router_base, "<router>")))
    finally:
        await api_runner.cleanup()
        await router_runner.cleanup()
    return seq, json.dumps(_untimed(fake.status_updates)[-1]).replace(
        router_base, "<router>")


async def test_health_thresholds_equal_jax():
    runs = {w: await _health_run(w) for w in WHICH}
    assert runs["port"] == runs["jax"]
    assert [t for t, *_ in runs["jax"][0]] == [
        "HealthCheckPending", "HealthCheckFailed", "HealthCheckPending",
        "HealthCheckSucceeded", "HealthCheckPending", "HealthCheckFailed",
        "HealthCheckPending", "HealthCheckSucceeded"]


async def test_configmap_hot_reloads_the_port_router(tmp_path):
    """The port's reconciler renders the ConfigMap; its dynamic_config.json,
    written where a router mounts it (the kubelet's part), swaps the port
    router's routing logic through its DynamicConfigWatcher."""
    from production_stack_tpu_torch.router.dynamic_config import (
        DynamicConfigWatcher,
        DynamicRouterConfig,
    )
    from production_stack_tpu_torch.router.routing_logic import (
        RoundRobinRouter,
        SessionRouter,
        get_routing_logic,
        initialize_routing_logic,
    )

    fake = FakeK8s()
    runner, base = await _serve(fake.app())
    cfg_path = tmp_path / "dynamic_config.json"
    key = ("default", "route-a-dynamic-config")
    try:
        rec = port_sr.StaticRouteReconciler(base, client=port_sr.KubeClient())
        await rec.reconcile(_cr(logic="roundrobin"))
        cfg_path.write_text(fake.configmaps[key]["data"]["dynamic_config.json"])
        assert DynamicRouterConfig.from_json(str(cfg_path)).routing_logic == "roundrobin"
        initialize_routing_logic("roundrobin")
        watcher = DynamicConfigWatcher(str(cfg_path), watch_interval=0.05)
        try:
            await asyncio.sleep(0.3)
            assert isinstance(get_routing_logic(), RoundRobinRouter)
            await rec.reconcile(_cr(logic="session", session_key="x-user-id"))
            cfg_path.write_text(fake.configmaps[key]["data"]["dynamic_config.json"])
            for _ in range(100):
                await asyncio.sleep(0.05)
                if isinstance(get_routing_logic(), SessionRouter):
                    break
            assert isinstance(get_routing_logic(), SessionRouter)
            assert watcher.get_current_config()["routing_logic"] == "session"
        finally:
            watcher.close()
    finally:
        await runner.cleanup()


async def _run_loop(which):
    """``run()`` with a stop event, on a client of its own: one pass over
    the namespace's CRs, then the stop."""
    fake = FakeK8s()
    for cr in CRS[:2]:
        fake.staticroutes[("default", cr["metadata"]["name"])] = cr
    runner, base = await _serve(fake.app())
    try:
        rec = SR[which].StaticRouteReconciler(base)
        stop = asyncio.Event()
        task = asyncio.ensure_future(rec.run("default", stop_event=stop))
        for _ in range(200):
            await asyncio.sleep(0.02)
            if len(fake.status_updates) >= 2:
                break
        stop.set()
        await asyncio.wait_for(task, 10)
    finally:
        await runner.cleanup()
    owned = getattr(rec, "_session", None) if which == "jax" else rec._client
    return sorted(fake.configmaps), _untimed(fake.status_updates)[:2], owned


async def test_run_loop_equals_jax():
    runs = {w: await _run_loop(w) for w in WHICH}
    assert runs["port"] == runs["jax"]
    assert runs["jax"][2] is None and len(runs["jax"][0]) == 2


# -------------------------------------------------------------------- LoRA
def _adapter(name, source, ns="default", status=None, base="tiny-llama"):
    obj = {"metadata": {"name": name, "namespace": ns},
           "spec": {"baseModel": base, "adapterSource": source}}
    if status is not None:
        obj["status"] = status
    return obj


async def _lora_run(which, tmp, monkeypatch):
    src = tmp / "src" / "my-adapter"
    if not src.exists():
        _peft_checkpoint(src)
        notpeft = tmp / "src" / "not-peft"
        notpeft.mkdir()
        (notpeft / "weights.bin").write_bytes(b"\0")
    shared = tmp / which / "shared"
    shared.mkdir(parents=True)
    # The huggingface path without its package (made unimportable here,
    # so nothing is downloaded): Failed, with the ImportError's message.
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    local = {"type": "local", "adapterName": "my-adapter", "adapterPath": str(src)}
    crs = [
        _adapter("a", local),
        _adapter("b", {"type": "local", "adapterName": "missing",
                       "adapterPath": str(tmp / "nope")}),
        _adapter("c", {"type": "local", "adapterName": "np",
                       "adapterPath": str(tmp / "src" / "not-peft")}),
        _adapter("d", {"type": "s3", "adapterName": "x"}),
        _adapter("e", {"type": "huggingface", "adapterName": "hf",
                       "repository": "org/adapter"}),
        _adapter("f", {"type": "huggingface", "adapterName": "hf2"}),
    ]
    fake = FakeLoraK8s()
    for cr in crs:
        fake.adapters[cr["metadata"]["name"]] = cr
    runner, base = await _serve(fake.app())
    try:
        async with _Client(which) as kw:
            rec = LORA[which].LoraAdapterReconciler(base, str(shared), **kw)
            phases = [await rec.reconcile(cr) for cr in crs]
            ready = dict(fake.statuses["a"][-1])
            # Ready and unchanged: skipped, no patch; an edited spec
            # re-resolves.
            n = sum(len(v) for v in fake.statuses.values())
            phases.append(await rec.reconcile(_adapter("a", local, status=ready)))
            skipped = sum(len(v) for v in fake.statuses.values()) == n
            phases.append(await rec.reconcile(_adapter("a", local, status=ready,
                                                       base="tiny-llama-2")))
            listed = len(await rec.list_adapters("default"))
    finally:
        await runner.cleanup()
    statuses = json.loads(json.dumps(_untimed(fake.statuses)).replace(
        str(shared), "<shared>"))
    copied = sorted(os.listdir(shared / "my-adapter"))
    return phases, skipped, listed, statuses, copied


async def test_lora_phases_equal_jax(tmp_path, monkeypatch):
    runs = {w: await _lora_run(w, tmp_path, monkeypatch) for w in WHICH}
    assert runs["port"] == runs["jax"]
    phases, skipped, listed, statuses, copied = runs["jax"]
    assert phases == ["Ready", "Failed", "Failed", "Failed", "Failed", "Failed",
                      "Ready", "Ready"]
    assert skipped and listed == 6
    assert [s["phase"] for s in statuses["a"]] == ["Downloading", "Ready",
                                                   "Downloading", "Ready"]
    assert statuses["a"][1]["adapterPath"] == "<shared>/my-adapter"
    assert "huggingface_hub" in statuses["e"][-1]["message"]
    assert statuses["f"][-1]["message"] == "huggingface source needs 'repository'"
    assert copied == ["adapter_config.json", "adapter_model.safetensors"]


async def _lora_loop(which, tmp):
    src = tmp / which / "src"
    _peft_checkpoint(src)
    fake = FakeLoraK8s()
    fake.adapters["a"] = _adapter("a", {"type": "local", "adapterName": "x",
                                        "adapterPath": str(src)})
    runner, base = await _serve(fake.app())
    try:
        rec = LORA[which].LoraAdapterReconciler(base, str(tmp / which))
        stop = asyncio.Event()
        task = asyncio.ensure_future(rec.run("default", period=0.05, stop_event=stop))
        for _ in range(200):
            await asyncio.sleep(0.02)
            if fake.statuses.get("a", [{}])[-1].get("phase") == "Ready":
                break
        stop.set()
        await asyncio.wait_for(task, 10)
    finally:
        await runner.cleanup()
    return [s["phase"] for s in fake.statuses["a"]][:2]


async def test_lora_run_loop_equals_jax(tmp_path):
    runs = {w: await _lora_loop(w, tmp_path) for w in WHICH}
    assert runs["port"] == runs["jax"] == ["Downloading", "Ready"]


# ------------------------------------------------------------ entry points
@pytest.mark.parametrize("argv,env,token", [
    ([], {}, False),
    (["--namespace", "serving", "--api-base", "http://127.0.0.1:1"], {}, True),
    ([], {"WATCH_NAMESPACE": "ns-env", "KUBERNETES_SERVICE_HOST": "10.0.0.1",
          "KUBERNETES_SERVICE_PORT": "6443"}, True),
    ([], {"KUBERNETES_SERVICE_HOST": "k"}, False),
], ids=["defaults", "flags", "in-cluster-env", "host-only"])
def test_entry_points_take_the_jax_flags_and_defaults(tmp_path, monkeypatch, argv,
                                                      env, token):
    """Each controller's ``main``: the reconciler it builds (API base, the
    service account's token when one is mounted, the adapters directory)
    and the namespace it runs on."""
    for k in ("WATCH_NAMESPACE", "KUBERNETES_SERVICE_HOST", "KUBERNETES_SERVICE_PORT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    sa = tmp_path / "sa"
    sa.mkdir()
    if token:
        (sa / "token").write_text("  tok-en\n")
    got = {}
    for which, mains in (("jax", (jax_main, jax_lora_main)),
                         ("port", (port_main, port_lora_main))):
        seen = []
        for mod, cls, extra in (
                (mains[0], "StaticRouteReconciler", []),
                (mains[1], "LoraAdapterReconciler",
                 ["--adapters-dir", str(tmp_path / which / "adapters")])):
            class Rec:
                def __init__(self, api_base, *rest, token=None, cls=cls):
                    seen.append((cls, api_base, rest, token))

                async def run(self, namespace):
                    seen.append(("run", namespace))

            monkeypatch.setattr(mod, cls, Rec)
            monkeypatch.setattr(mod, "_SA", str(sa))
            mod.main(argv + extra)
        got[which] = json.loads(json.dumps(seen).replace(str(tmp_path / which), "<dir>"))
        assert os.path.isdir(tmp_path / which / "adapters")
    assert got["port"] == got["jax"]
