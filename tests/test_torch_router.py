"""Port engines behind the stack's router.

The real router (``production_stack_tpu.router``, built as
``tests/test_router_e2e.py`` builds it) proxies to a port engine serving
the JAX engine's float32 weights on the CPU: its streamed chat carries the
JAX engine's tokens, and its engine-stats scraper reads the port's
``/metrics``. The port's exposition has the JAX renderer's series names and
label sets, every one in the stack's metric registry. Then the server
surface an engine behind the router needs: ``/version``, bearer auth,
queue-depth admission, SIGTERM drain, and the launcher's engine processes.
"""

import asyncio
import functools
import json
import os
import re
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import metrics as jax_metrics
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu.server.metrics import (
    render_engine_metrics as jax_render,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.metrics import EngineMetricsCollector
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.launch import launch_engines
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.server.api_server import OpenAIServer
from production_stack_tpu_torch.server.metrics import render_engine_metrics
from tests.test_router_e2e import router_args
from tests.test_torch_surface import _events, _http
from tools.pstpu_lint.metrics_registry import ENGINE_TEXT, REGISTRY

MODEL = "tiny-llama-128dh"
COMMON = dict(model=MODEL, max_model_len=256, block_size=16, num_kv_blocks=96,
              attn_impl="window", num_decode_steps=4, dtype="float32",
              max_num_batched_tokens=64, max_num_seqs=8)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.float32)


def _port_engine(**over):
    return ServingEngine(
        EngineConfig(**{**COMMON, **over}, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                               resolve_model_config(MODEL), torch.float32))


def _series(text):
    """{series name: label names} of an exposition (histogram samples under
    their family's name, without ``le``)."""
    hist = set(re.findall(r"^# TYPE (\S+) histogram$", text, re.M))
    out = {name: frozenset() for name in
           re.findall(r"^# TYPE (\S+) \w+$", text, re.M)}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, labels = line.split(" ")[0].partition("{")
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in hist:
                name = name[:-len(suffix)]
        keys = frozenset(re.findall(r'(\w+)="', labels)) - {"le"}
        out[name] = out[name] | keys
    return out


async def test_router_streams_a_port_engine_like_jax_and_scrapes_it():
    """Chat through the router to a port engine (greedy and seeded): the
    tokens of the JAX engine's stream; the router's scraper then reads the
    port's gauges (live throughput, the request counts)."""
    from production_stack_tpu.router.app import build_app
    from production_stack_tpu.router.stats.engine_stats import (
        get_engine_stats_scraper,
    )

    jclient = TestClient(TestServer(
        JaxServer(JaxEngine(JaxConfig(**COMMON), params=_jax_params()))
        .build_app()))
    await jclient.start_server()
    server = OpenAIServer(_port_engine(), port=0)
    await server.start()
    url = f"http://127.0.0.1:{server.port}"
    router = TestClient(TestServer(build_app(router_args([url], [MODEL]))))
    await router.start_server()
    hdr = {"x-pstpu-resume": "1"}
    try:
        for extra in ({"temperature": 0.0}, {"temperature": 0.9, "seed": 5}):
            body = {"model": MODEL, "stream": True, "max_tokens": 10,
                    "ignore_eos": True, **extra,
                    "messages": [{"role": "user", "content": "route me"}]}
            got = []
            for client in (router, jclient):
                resp = await client.post("/v1/chat/completions", json=body,
                                         headers=hdr)
                assert resp.status == 200
                evs, done = _events(await resp.text())
                assert done and evs[-1]["choices"][0]["finish_reason"] == \
                    "length"
                got.append(([t for e in evs for t in e["pstpu"]["toks"]],
                            "".join(e["choices"][0]["delta"].get("content", "")
                                    for e in evs)))
            assert got[0] == got[1] and len(got[0][0]) == 10
        # The scraper keeps the snapshot of its last pass, which may have
        # read the engine while the router's last stream still ran there
        # (a request running, the live gauge already set by the first
        # stream). Read a snapshot of a pass that BEGAN after the streams
        # ended: the pass completing after one that completed after them.
        scraper = get_engine_stats_scraper()
        t_done, passes, stats = time.time(), [], None
        for _ in range(300):
            last = scraper._last_scrape
            if last > t_done and last not in passes:
                passes.append(last)
            if len(passes) >= 2:
                stats = scraper.get_engine_stats().get(url)
                if stats is not None:
                    break
            await asyncio.sleep(0.1)
        assert len(passes) >= 2, "no scrape pass after the streams ended"
        assert stats is not None, f"{url} was not scraped"
        assert stats.live_tok_per_s > 0
        assert (stats.num_running_requests, stats.num_queuing_requests) == \
            (0, 0)
    finally:
        await router.close()
        await jclient.close()
        await server.stop()
        server.engine.shutdown()


async def test_exposition_matches_the_jax_renderer_and_the_registry():
    """On one served port engine's stats(): the port's series names and
    label sets equal the JAX renderer's, every name is registered for the
    engine text surface, and the prometheus_client collector yields the
    same families."""
    eng = _port_engine()
    await eng.start()
    try:
        async for _ in eng.generate(prompt="metrics", sampling=SamplingParams(
                max_tokens=6, temperature=0.0, ignore_eos=True)):
            pass
    finally:
        await eng.stop()
    text = render_engine_metrics(eng, MODEL)
    shim = types.SimpleNamespace(
        stats=eng.stats, histograms=jax_metrics.RequestLatencyHistograms(),
        lifecycle=jax_metrics.LifecycleHistograms(),
        dispatch_hists=jax_metrics.DispatchDurationHistograms())
    mine, ref = _series(text), _series(jax_render(shim, MODEL))
    assert mine == ref
    registered = {s.name: s.labels for s in REGISTRY if ENGINE_TEXT in s.surfaces}
    assert set(mine) <= set(registered), set(mine) - set(registered)
    assert all(mine[n] <= set(registered[n]) for n in mine)
    assert 'vllm:generation_tokens_total{model_name="%s"} 6' % MODEL in text
    assert re.search(r'pstpu:hbm_kv_bytes\{model_name="%s",device="rank0:cpu"\} '
                     r"[1-9]" % MODEL, text)
    fams = list(EngineMetricsCollector(eng).collect())
    names = {f.name + ("_total" if f.type == "counter" else "") for f in fams}
    assert names == set(mine)
    eng.shutdown()


SPEC_SERIES = ("pstpu:spec_enabled", "pstpu:spec_draft_tokens_total",
               "pstpu:spec_accepted_tokens_total", "pstpu:spec_acceptance_rate",
               "pstpu:spec_acceptance_rate_window", "pstpu:spec_draft_depth",
               "pstpu:spec_tree_nodes_total", "pstpu:spec_acceptance_ema",
               "pstpu:spec_gamma0_dispatches_total")


async def test_spec_on_exposition_matches_the_jax_renderer():
    """A speculative port engine (self-draft, tree width 2, adaptive): its
    exposition has the JAX renderer's series and label sets, the spec
    series read its counters (non-zero after traffic), the decode_spec
    train's histogram counts its dispatches, and every name is
    registered."""
    eng = _port_engine(speculative_num_tokens=3, speculative_model=MODEL,
                       speculative_tree_width=2, speculative_adaptive=True)
    await eng.start()
    try:
        async for _ in eng.generate(prompt="metrics", sampling=SamplingParams(
                max_tokens=12, temperature=0.0, ignore_eos=True)):
            pass
    finally:
        await eng.stop()
    text = render_engine_metrics(eng, MODEL)
    shim = types.SimpleNamespace(
        stats=eng.stats, histograms=jax_metrics.RequestLatencyHistograms(),
        lifecycle=jax_metrics.LifecycleHistograms(),
        dispatch_hists=jax_metrics.DispatchDurationHistograms())
    mine = _series(text)
    assert mine == _series(jax_render(shim, MODEL))
    registered = {s.name for s in REGISTRY if ENGINE_TEXT in s.surfaces}
    assert set(mine) <= registered
    st = eng.stats()
    values = {}
    for line in text.splitlines():
        name = line.split("{")[0]
        if name in SPEC_SERIES:
            values[name] = float(line.rsplit(" ", 1)[1])
    assert set(values) == set(SPEC_SERIES)
    for name in SPEC_SERIES:
        key = name.split(":")[1]
        assert values[name] == pytest.approx(float(st[key])), name
    for name in ("pstpu:spec_enabled", "pstpu:spec_draft_tokens_total",
                 "pstpu:spec_accepted_tokens_total",
                 "pstpu:spec_tree_nodes_total", "pstpu:spec_draft_depth"):
        assert values[name] > 0, name
    # The EMA gauge averages live sequences: the finished one is forgotten.
    assert values["pstpu:spec_acceptance_ema"] == 0.0
    spec_count = re.search(
        r'pstpu:dispatch_duration_seconds_count\{model_name="%s",'
        r'train="decode_spec"\} (\d+)' % MODEL, text)
    assert spec_count and int(spec_count.group(1)) == \
        st["decode_dispatches_total"] > 0
    eng.shutdown()


async def test_version_auth_admission_and_drain():
    """/version; 401 without the bearer token on /v1/* (not on /health or
    /metrics); 503 + Retry-After while the wait queue is at the bound;
    drain: /health 503 draining, a new POST 503 + Retry-After, the stream
    in flight finishes with max_tokens, and every block comes back."""
    eng = _port_engine()
    server = OpenAIServer(eng, port=0, api_key="sk-test", max_queue_len=2,
                          drain_timeout=60.0)
    await server.start()
    port = server.port
    auth = {"Authorization": "Bearer sk-test"}
    body = {"prompt": "drain me", "max_tokens": 40, "temperature": 0.0,
            "ignore_eos": True, "stream": True}
    try:
        st, _, v = await _http(port, "GET", "/version")
        assert (st, json.loads(v)) == (200, {"version": "0.1.0"})
        for path in ("/health", "/metrics"):
            assert (await _http(port, "GET", path))[0] == 200
        st, _, err = await _http(port, "POST", "/v1/completions", body)
        assert st == 401 and json.loads(err)["error"]["type"] == \
            "authentication_error"
        st, _, _ = await _http(port, "GET", "/v1/models",
                               headers={"Authorization": "Bearer wrong"})
        assert st == 401
        # Admission: a wait queue held at the bound sheds the request.
        held = [object(), object()]
        eng.scheduler.waiting.extend(held)
        st, hdrs, _ = await _http(port, "POST", "/v1/completions", body, auth)
        for h in held:
            eng.scheduler.waiting.remove(h)
        assert st == 503 and hdrs["retry-after"] == "1"
        free0 = eng.block_manager.num_free_blocks
        stream = asyncio.create_task(
            _http(port, "POST", "/v1/completions", body, auth))
        while eng.scheduler.num_running == 0:
            assert not stream.done(), "the stream ended before it was seen"
            await asyncio.sleep(0.01)
        drain = asyncio.create_task(server.drain())
        await asyncio.sleep(0)
        st, hdrs, h = await _http(port, "GET", "/health")
        assert st == 503 and json.loads(h) == {"status": "draining",
                                              "inflight": 1}
        assert hdrs["retry-after"] == "1"
        st, hdrs, _ = await _http(port, "POST", "/v1/completions", body, auth)
        assert st == 503 and hdrs["retry-after"] == "5"
        st, _, text = await stream
        await drain
        evs, done = _events(text)
        assert st == 200 and done
        assert evs[-1]["choices"][0]["finish_reason"] == "length"
        assert eng.block_manager.num_free_blocks == free0
        assert eng.scheduler.num_running == 0
    finally:
        await server.stop()
        eng.shutdown()


async def test_drain_timeout_aborts_and_returns_blocks():
    """A stream longer than the drain timeout is aborted at the timeout,
    its dispatch in flight is fetched first, and its blocks come back."""
    eng = _port_engine()
    server = OpenAIServer(eng, port=0, drain_timeout=0.2)
    await server.start()
    try:
        free0 = eng.block_manager.num_free_blocks
        stream = asyncio.create_task(_http(server.port, "POST",
                                           "/v1/completions", {
            "prompt": "too long", "max_tokens": 200, "temperature": 0.0,
            "ignore_eos": True, "stream": True}))
        while eng.scheduler.num_running == 0:
            assert not stream.done(), "the stream ended before it was seen"
            await asyncio.sleep(0.01)
        await server.drain()
        st, _, text = await stream
        evs, done = _events(text)
        assert st == 200 and done
        assert evs[-1]["choices"][0]["finish_reason"] == "abort"
        for _ in range(100):
            if eng.block_manager.num_free_blocks == free0:
                break
            await asyncio.sleep(0.01)
        assert eng.block_manager.num_free_blocks == free0
    finally:
        await server.stop()
        eng.shutdown()


def test_launch_entry_runs_the_decode_train():
    """``entry()``: the decode train of one 4-row, 4-step dispatch at
    tiny-llama and its inputs; run on the CPU it runs eagerly and writes
    every row's 4 tokens."""
    from production_stack_tpu_torch.launch import entry

    fn, (bf, k) = entry(device="cpu")
    assert fn(bf, k) is False
    assert tuple(bf.toks_all.shape) == (4, 4) and k == 4
    assert bool((bf.last[:4] == bf.toks_all[-1]).all())


@pytest.mark.parametrize("n_engines", [1])
def test_launch_engines_starts_and_sigterms_cpu_engines(n_engines, tmp_path):
    handle = launch_engines(
        "tiny-llama", n_engines,
        ["--max-model-len", "128", "--num-kv-blocks", "32", "--max-num-seqs",
         "2", "--served-model-name", "tiny"],
        device="cpu", log_dir=str(tmp_path), startup_timeout_s=120)
    try:
        assert len(handle.urls) == n_engines == len(handle.ready_seconds)
        port = int(handle.urls[0].rsplit(":", 1)[1])
        st, _, body = asyncio.run(_http(port, "GET", "/v1/models"))
        assert st == 200 and json.loads(body)["data"][0]["id"] == "tiny"
        assert handle.argvs[0][1:3] == ["-m",
                                        "production_stack_tpu_torch.server.api_server"]
    finally:
        codes = handle.stop(timeout_s=60)
    assert codes == [0] * n_engines
    assert "Drain complete" in open(handle.log_paths[0]).read()


async def test_router_routes_model_a_to_a_port_engine_with_adapters(tmp_path):
    """The real router in front of a port engine serving two PEFT adapters
    beside its base model (the static discovery lists the engine under each
    served name): ``model=a`` through the router gives the tokens of
    ``model=a`` straight at the engine, and they differ from the base
    model's."""
    from production_stack_tpu.router.app import build_app
    from tests.test_torch_lora import ALL7, write_adapter

    mc = resolve_model_config(MODEL)
    lora = {"a": write_adapter(tmp_path / "a", mc, 4, ("wq", "wv"), 1, alpha=8),
            "b": write_adapter(tmp_path / "b", mc, 8, ALL7, 2, alpha=16)}
    server = OpenAIServer(_port_engine(lora_modules=lora), port=0)
    await server.start()
    url = f"http://127.0.0.1:{server.port}"
    router = TestClient(TestServer(build_app(
        router_args([url] * 3, [MODEL, "a", "b"]))))
    await router.start_server()
    hdr = {"x-pstpu-resume": "1"}
    try:
        got = {}
        for model in (MODEL, "a"):
            body = {"model": model, "stream": True, "max_tokens": 8,
                    "ignore_eos": True, "temperature": 0.0,
                    "messages": [{"role": "user", "content": "route me"}]}
            resp = await router.post("/v1/chat/completions", json=body,
                                     headers=hdr)
            assert resp.status == 200
            evs, done = _events(await resp.text())
            assert done
            st, _, text = await _http(server.port, "POST",
                                      "/v1/chat/completions", body, hdr)
            direct, _ = _events(text)
            got[model] = [t for e in evs for t in e["pstpu"]["toks"]]
            assert got[model] == [t for e in direct for t in e["pstpu"]["toks"]]
            assert len(got[model]) == 8
        assert got["a"] != got[MODEL]
        resp = await router.get("/v1/models")
        assert {m["id"] for m in (await resp.json())["data"]} == {MODEL, "a", "b"}
    finally:
        await router.close()
        await server.stop()
        server.engine.shutdown()


def test_launch_engines_pass_each_engine_its_own_environment(tmp_path, monkeypatch):
    """``per_engine_env[i]`` reaches engine i's process over the launcher's
    environment, and no other engine's: the KV tier's restore knobs have
    no flag, and the disagg pair's prefill engine sets its own."""
    from production_stack_tpu_torch import launch

    envs = []

    class Proc:
        returncode = None

        def __init__(self, argv, env, **kw):
            envs.append(env)

        def poll(self):
            return None

    monkeypatch.setattr(launch.subprocess, "Popen", Proc)
    monkeypatch.setattr(launch, "_healthy", lambda url: True)
    monkeypatch.setenv("PSTPU_KV_RESTORE_LINK_GBPS", "2.0")
    launch_engines("tiny-llama", 2, device="cpu", log_dir=str(tmp_path),
                   per_engine_env=[{"PSTPU_KV_RESTORE_LINK_GBPS": "1e-9"}, {}])
    assert [e["PSTPU_KV_RESTORE_LINK_GBPS"] for e in envs] == ["1e-9", "2.0"]
    assert all(e["PYTHONPATH"].split(os.pathsep)[0] == launch._PKG_PARENT for e in envs)


def test_launch_engines_pass_a_checkpoint_directory_and_adapters(tmp_path):
    """A checkpoint directory as ``--model`` and ``--lora-modules`` after
    ``--`` reach every engine as they were given (relative paths here: the
    engine runs in the launcher's working directory): the engine serves
    the directory's weights and lists the adapter."""
    import chip_smoke
    from production_stack_tpu_torch.models import llama
    from tests.test_torch_lora import write_adapter

    mc = resolve_model_config("tiny-llama")
    d = tmp_path / "ckpt"
    chip_smoke.write_hf_checkpoint(
        torch, llama.init_params(mc, torch.Generator().manual_seed(1),
                                 torch.float32), mc, str(d))
    a = write_adapter(tmp_path / "a", mc, 4, ("wq", "wv"), 1, alpha=8)
    rel = os.path.relpath(d)
    handle = launch_engines(
        rel, 1, ["--max-model-len", "128", "--num-kv-blocks", "32",
                 "--max-num-seqs", "2", "--served-model-name", "tiny",
                 "--dtype", "float32", "--lora-modules",
                 f"a={os.path.relpath(a)}"],
        device="cpu", log_dir=str(tmp_path / "logs"), startup_timeout_s=120)
    try:
        argv = handle.argvs[0]
        assert argv[argv.index("--model") + 1] == rel
        assert argv[argv.index("--lora-modules") + 1] == f"a={os.path.relpath(a)}"
        port = int(handle.urls[0].rsplit(":", 1)[1])
        st, _, body = asyncio.run(_http(port, "GET", "/v1/models"))
        assert st == 200
        assert [m["id"] for m in json.loads(body)["data"]] == ["tiny", "a"]
        st, _, body = asyncio.run(_http(port, "POST", "/v1/completions", {
            "model": "a", "prompt": "hi", "max_tokens": 3,
            "temperature": 0.0, "ignore_eos": True}))
        assert st == 200 and json.loads(body)["usage"]["completion_tokens"] == 3
    finally:
        assert handle.stop(timeout_s=60) == [0]
