"""The PyTorch port's serving engine against the JAX package's.

Greedy tokens must be identical: both engines serve the same weights (the
JAX params exported through numpy) in float32 on the CPU, the JAX engine's
paged path runs its Pallas kernel in interpret mode, the port's runs the
kernel's plain version. float32 because bf16 argmax near-ties on random
weights are not a signal. Both engines run the strict loop here
(``async_pipeline=False``): tokens do not depend on it, but the pools, which
the int8 cases compare block by block, do (the pipelined loop may allocate
blocks in another order); ``tests/test_torch_pipeline.py`` holds the
pipelined loops.
Seeded tokens must be identical too: the port computes the JAX package's
threefry Gumbel field bit for bit. With ``kv_cache_dtype="int8"`` the two
engines' pools are compared after serving.
"""

import asyncio
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.kv_cache import BlockPoolManager as JaxPool
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.engine.scheduler import Scheduler as JaxScheduler
from production_stack_tpu.engine.scheduler import Sequence as JaxSequence
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.kv_cache import BlockPoolManager
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.scheduler import Scheduler, Sequence
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import (
    kv_pools_from_jax,
    params_from_jax,
)
from production_stack_tpu_torch.server.api_server import OpenAIServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = "tiny-llama-128dh"


async def _serve_all(engine, sampling_cls, prompts, max_tokens,
                     samplings=None):
    """Serve every prompt concurrently (greedy unless ``samplings`` gives
    each prompt's sampling fields); returns each request's tokens."""
    await engine.start()

    async def one(p, extra):
        toks = None
        fields = dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
        fields.update(extra)
        async for out in engine.generate(prompt=p,
                                         sampling=sampling_cls(**fields)):
            toks = out.token_ids
        return toks

    try:
        return await asyncio.gather(*[
            one(p, samplings[i] if samplings else {})
            for i, p in enumerate(prompts)])
    finally:
        await engine.stop()


def _jax_and_port_engines(common):
    """A JAX engine and a port engine (CPU) over the same f32 weights."""
    jparams = jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.float32)
    strict = dict(async_pipeline=False, overlap_dispatch=False)
    jeng = JaxEngine(JaxConfig(**common, **strict), params=jparams)
    eng = ServingEngine(
        EngineConfig(**common, **strict, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               resolve_model_config(MODEL), torch.float32))
    return jeng, eng


def _compare_int8_pools(jeng, eng):
    """The two engines' int8 pools and scales on every block but the null
    block 0 (the padding sink, written in no fixed order). The fp32 K/V of
    the two frameworks may differ by ulps, which can move a value across a
    rounding boundary: up to 0.1% of payload elements may differ by 1 and
    of scales by 1 bf16 ulp; the counts are printed."""
    r = jeng.runner
    want = kv_pools_from_jax(np.asarray(r.kv_k), np.asarray(r.kv_v),
                             np.asarray(r.kv_k_scale), np.asarray(r.kv_v_scale))
    tr = eng.runner
    got = (tr.kv_k, tr.kv_v, tr.kv_k_scale, tr.kv_v_scale)
    bs = eng.config.block_size
    for name, a, c in zip(("k", "v", "k_scale", "v_scale"), got, want):
        assert a.dtype == c.dtype and a.shape == c.shape, name
        a, c = a[:, :, bs:], c[:, :, bs:]
        if a.dtype == torch.int8:
            diff = (a.int() - c.int()).abs()
        else:
            diff = (a.view(torch.int16).int() - c.view(torch.int16).int()).abs()
        n_diff = int((diff > 0).sum())
        print(f"int8 pool {name}: {n_diff} of {diff.numel()} elements differ "
              f"(max {int(diff.max())})")
        assert int(diff.max()) <= 1 and n_diff <= 1e-3 * diff.numel(), name
    assert int((tr.kv_k_scale[:, :, bs:] != 0).sum()) > 0   # pools were written


# (attn_impl, block_size, num_kv_blocks, prompts, max_tokens,
# kv_cache_dtype): the first two of each dtype include a multi-chunk prefill
# (150 tokens against a 64-token budget); window-preempt runs the pool dry
# so decode preempts and the victim re-prefills. The paged cases use
# 64-token pages: the JAX side's Pallas interpret-mode compile unrolls one
# DMA per page of a 512-token superpage.
_PROMPTS = ["hello world this is request 0 ", "x" * 150]
CASES = {
    "paged": ("paged", 64, 32, _PROMPTS, 12, "bfloat16"),
    "window": ("window", 16, 128, _PROMPTS, 12, "bfloat16"),
    "window-preempt": ("window", 16, 12, [f"request {i} " * 4 for i in range(3)],
                       40, "bfloat16"),
    "paged-int8": ("paged", 64, 32, _PROMPTS, 12, "int8"),
    "window-int8": ("window", 16, 128, _PROMPTS, 12, "int8"),
}


@pytest.mark.parametrize("case", list(CASES))
async def test_engine_greedy_tokens_match_jax(case):
    impl, bs, blocks, prompts, max_tokens, kv_dtype = CASES[case]
    common = dict(model=MODEL, max_model_len=256, block_size=bs,
                  num_kv_blocks=blocks, attn_impl=impl, num_decode_steps=8,
                  dtype="float32", max_num_batched_tokens=64,
                  kv_cache_dtype=kv_dtype)
    jeng, eng = _jax_and_port_engines(common)
    want = await _serve_all(jeng, JaxSampling, prompts, max_tokens)
    assert eng.runner.attn_impl == impl
    got = await _serve_all(eng, SamplingParams, prompts, max_tokens)
    eng.shutdown()
    assert got == want
    assert all(len(t) == max_tokens for t in got)
    if case == "window-preempt":
        assert eng.stats()["num_preemptions"] > 0
    if kv_dtype == "int8":
        _compare_int8_pools(jeng, eng)
        st = eng.stats()
        assert st["kv_cache_dtype"] == "int8"
        assert st["kv_quant_bytes_saved_total"] > 0


@pytest.mark.parametrize("impl", ["window", "paged"])
async def test_engine_seeded_tokens_match_jax(impl):
    """Seeded rows (top-p, top-k, and unfiltered) batched with a greedy
    one: every token equals the JAX engine's, from the first sampled token
    (prefill) through the fused decode steps."""
    common = dict(model=MODEL, max_model_len=256, block_size=64,
                  num_kv_blocks=32, attn_impl=impl, num_decode_steps=8,
                  dtype="float32", max_num_batched_tokens=64)
    samplings = [dict(temperature=0.8, top_p=0.9, seed=1234),
                 dict(temperature=0.8, top_k=50, seed=7),
                 dict(temperature=1.0, seed=2**32 - 1),
                 {}]
    prompts = ["seeded prompt one ", "y" * 90, "third", "greedy row"]
    jeng, eng = _jax_and_port_engines(common)
    want = await _serve_all(jeng, JaxSampling, prompts, 20, samplings)
    got = await _serve_all(eng, SamplingParams, prompts, 20, samplings)
    eng.shutdown()
    assert got == want
    assert all(len(t) == 20 for t in got)


@pytest.mark.parametrize("impl,bs,blocks", [("window", 16, 128),
                                             ("paged", 64, 32)])
async def test_engine_bf16_greedy_tokens_match_jax(impl, bs, blocks):
    """bf16 weights, activations and pools in both engines: greedy tokens
    are identical. This needs the port's bf16 ``silu`` to be jitted
    ``jax.nn.silu`` bit for bit (with ``F.silu`` the paged case's sixth
    token differs)."""
    common = dict(model=MODEL, max_model_len=256, block_size=bs,
                  num_kv_blocks=blocks, attn_impl=impl, num_decode_steps=8,
                  dtype="bfloat16", max_num_batched_tokens=64)
    jparams = jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.bfloat16)
    jeng = JaxEngine(JaxConfig(**common, async_pipeline=False,
                               overlap_dispatch=False), params=jparams)
    eng = ServingEngine(
        EngineConfig(**common, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               resolve_model_config(MODEL), torch.bfloat16))
    want = await _serve_all(jeng, JaxSampling, _PROMPTS, 12)
    got = await _serve_all(eng, SamplingParams, _PROMPTS, 12)
    eng.shutdown()
    assert eng.runner.kv_k.dtype == torch.bfloat16
    assert got == want and all(len(t) == 12 for t in got)


def _describe(batch):
    if batch is None:
        return None
    return (batch.kind, [s.request_id for s in batch.seqs],
            list(batch.chunk_starts), list(batch.chunk_lens),
            batch.num_steps, list(batch.decode_steps))


def test_scheduler_makes_the_same_batches_as_jax():
    """A scripted arrival trace on a pool small enough to starve prompts
    and preempt decodes: both schedulers form the same batches."""
    common = dict(model="tiny-llama", max_model_len=128, block_size=4,
                  num_decode_steps=8, max_num_seqs=4,
                  max_num_batched_tokens=32, max_prefill_seqs=2)
    js = JaxScheduler(JaxConfig(**common), JaxPool(16, 4))
    ts = Scheduler(EngineConfig(**common, device="cpu"), BlockPoolManager(16, 4))
    arrivals = {0: [("a", 10, 30)], 1: [("b", 40, 20), ("c", 5, 40)],
                3: [("d", 33, 25)], 9: [("e", 12, 40), ("a2", 10, 10)]}
    batches = 0
    for step in range(200):
        for rid, n, mt in arrivals.get(step, []):
            toks = [(7 * len(rid) + i) % 200 + 1 for i in range(n)]
            if rid == "a2":
                toks = [(7 + i) % 200 + 1 for i in range(n)]  # shares a's prefix
            js.add_sequence(JaxSequence(rid, list(toks), JaxSampling(max_tokens=mt)))
            ts.add_sequence(Sequence(rid, list(toks), SamplingParams(max_tokens=mt)))
        jb, tb = js.schedule(), ts.schedule()
        assert _describe(tb) == _describe(jb), f"step {step}"
        if jb is None:
            continue
        batches += 1
        if jb.kind == "prefill":
            fake = [[(step + i) % 97 + 1] for i in range(len(jb.seqs))]
        else:
            fake = [[(step * 3 + i + j) % 97 + 1 for j in range(n)]
                    for i, n in enumerate(jb.decode_steps)]
        js.update_after_step(jb, fake)
        ts.update_after_step(tb, fake)
    assert batches > 10 and not ts.has_work() and not js.has_work()
    assert ts.num_preemptions_total == js.num_preemptions_total > 0
    assert ts.block_manager.prefix_hits_total == js.block_manager.prefix_hits_total > 0
    for rid in ("a", "b", "c", "d", "e", "a2"):
        assert ts.seqs[rid].output_token_ids == js.seqs[rid].output_token_ids


def _http(method, url, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers.get("Content-Type"), resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


async def test_stdlib_server_routes():
    eng = ServingEngine(EngineConfig(model="tiny-llama", device="cpu",
                                     dtype="float32", max_model_len=128,
                                     num_kv_blocks=64, num_decode_steps=4))
    server = OpenAIServer(eng, "127.0.0.1", 0)
    await server.start()
    base = f"http://127.0.0.1:{server.port}"
    loop = asyncio.get_running_loop()

    async def call(*args):
        return await loop.run_in_executor(None, _http, *args)

    try:
        st, _, body = await call("GET", base + "/health")
        assert st == 200 and json.loads(body) == {"status": "healthy"}
        st, _, body = await call("GET", base + "/v1/models")
        assert st == 200 and json.loads(body)["data"][0]["id"] == "tiny-llama"
        st, _, body = await call("POST", base + "/v1/completions", {
            "prompt": "hello", "max_tokens": 5, "temperature": 0,
            "ignore_eos": True})
        out = json.loads(body)
        assert st == 200 and out["object"] == "text_completion"
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"] == {"prompt_tokens": 5, "completion_tokens": 5,
                                "total_tokens": 10}
        st, ctype, body = await call("POST", base + "/v1/chat/completions", {
            "messages": [{"role": "user", "content": "hi"}], "max_tokens": 6,
            "temperature": 0.9, "seed": 3, "stream": True, "ignore_eos": True,
            "stream_options": {"include_usage": True}})
        assert st == 200 and ctype == "text/event-stream"
        events = [ln[len("data: "):] for ln in body.decode().split("\n\n")
                  if ln.startswith("data: ")]
        assert events[-1] == "[DONE]"
        chunks = [json.loads(e) for e in events[:-1]]
        assert all(c["object"] == "chat.completion.chunk" for c in chunks)
        assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
        assert chunks[-2]["choices"][0]["finish_reason"] == "length"
        assert chunks[-1]["usage"]["completion_tokens"] == 6
        st, _, _ = await call("GET", base + "/v1/nope")
        assert st == 404
        st, _, body = await call("POST", base + "/v1/completions", None)
        assert st == 400 and "error" in json.loads(body)
    finally:
        await server.stop()
        eng.shutdown()


def test_cuda_is_the_default_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    assert EngineConfig().device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        ServingEngine(EngineConfig(model="tiny-llama"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """In a fresh interpreter (conftest imports jax into this one): every
    module of the port, the tensor-parallel modules and the worker entry
    point (what a spawned rank imports), the metrics, roofline and
    launcher modules, the KV tier's modules (offload tiers, the cache
    server, the disagg handoff) and the observability and tool-calling
    modules and every module of the router and of both controllers among
    them, and chip_smoke.py,
    import without jax; and without prometheus_client, ml_dtypes, aiohttp
    or requests (the card's machine may not have them)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import production_stack_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "need = {'production_stack_tpu_torch.' + m for m in "
        "('parallel.mesh', 'parallel.sharding', 'parallel.worker', "
        "'server.metrics', 'engine.metrics', 'perf.roofline', 'launch', "
        "'kv_offload.serde', 'kv_offload.chain_lru', 'kv_offload.host_pool', "
        "'kv_offload.remote', 'kv_offload.server', 'kv_offload.manager', "
        "'disagg.transfer', 'disagg.coordinator', 'tracing', 'profiling', "
        "'engine.flight_recorder', 'server.tool_calling', 'utils', 'protocols', "
        "'router.app', 'router.http', 'router.parser', 'router.metrics', "
        "'router.request_service', 'router.routing_logic', 'router.resilience', "
        "'router.service_discovery', 'router.sse', 'router.ring', "
        "'router.dynamic_config', 'router.feature_gates', 'router.rewriter', "
        "'router.callbacks', 'router.log_stats', 'router.stats.engine_stats', "
        "'router.stats.request_stats', 'router.files_service', "
        "'router.batch_service', 'router.pii', 'router.semantic_cache', "
        "'controller.staticroute', 'controller.loraadapter', "
        "'controller.lora_main', 'controller.__main__')}\n"
        "assert need <= set(mods), need - set(mods)\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', "
        "'production_stack_tpu', 'prometheus_client', 'ml_dtypes', 'aiohttp', "
        "'requests')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 48


async def test_stop_strings_cut_text_and_tokens():
    """A stop string ends the request at its first occurrence: the text stops
    before it, tokens sampled past it (the fused decode overshoots) are
    dropped, and the finish reason is "stop" (the JAX engine's
    _process_output rules). The string is taken from the unstopped output."""
    cfg = EngineConfig(model=MODEL, device="cpu", dtype="float32",
                       max_model_len=256, num_kv_blocks=64,
                       attn_impl="window", num_decode_steps=8)
    eng = ServingEngine(cfg)

    async def run(sampling):
        text, last = "", None
        async for out in eng.generate(prompt="stop here: ", sampling=sampling):
            text += out.text_delta
            last = out
        return text, last

    await eng.start()
    try:
        full, _ = await run(SamplingParams(max_tokens=24, temperature=0.0,
                                           ignore_eos=True))
        real = [i for i, ch in enumerate(full) if ch != "\ufffd"]
        assert len(real) >= 3, full
        stop = full[real[2]]
        text, last = await run(SamplingParams(
            max_tokens=24, temperature=0.0, ignore_eos=True, stop=[stop]))
    finally:
        await eng.stop()
        eng.shutdown()
    assert text == full[:full.index(stop)]
    assert last.finish_reason == "stop"
    assert eng.tokenizer.decode(last.token_ids).startswith(text)
    assert len(last.token_ids) < 24


async def test_abort_frees_blocks():
    """A client that stops reading aborts its request; the loop applies the
    abort between dispatches and every KV block returns to the pool."""
    eng = ServingEngine(EngineConfig(model="tiny-llama", device="cpu",
                                     dtype="float32", max_model_len=256,
                                     num_kv_blocks=64, num_decode_steps=4,
                                     enable_prefix_caching=False))
    await eng.start()
    try:
        gen = eng.generate(prompt="abort me " * 4, sampling=SamplingParams(
            max_tokens=200, temperature=0.0, ignore_eos=True))
        first = await gen.__anext__()
        assert not first.finished
        await gen.aclose()
        for _ in range(200):
            if eng.stats()["num_requests_running"] == 0 and \
                    eng.block_manager.num_used_blocks == 0:
                break
            await asyncio.sleep(0.01)
        assert eng.stats()["num_requests_running"] == 0
        assert eng.block_manager.num_used_blocks == 0
    finally:
        await eng.stop()
        eng.shutdown()


def test_engine_config_validation():
    llama3b = resolve_model_config("llama-3b")
    tiny = resolve_model_config("tiny-llama")          # head_dim 32
    # The loop and warm-up fields default as the JAX package's do.
    for name in ("async_pipeline", "pipeline_depth", "overlap_dispatch",
                 "decode_loop", "enable_warmup"):
        assert getattr(EngineConfig(), name) == getattr(JaxConfig(), name), name
    assert (EngineConfig().async_pipeline, EngineConfig().pipeline_depth,
            EngineConfig().overlap_dispatch, EngineConfig().decode_loop) == \
        (True, 2, True, "scan")
    with pytest.raises(ValueError, match="decode_loop"):
        EngineConfig(decode_loop="unrolled")
    with pytest.raises(ValueError, match="dtype"):
        EngineConfig(dtype="int4")
    assert EngineConfig(device="cuda").resolved_attn_impl(llama3b) == "paged"
    assert EngineConfig(device="cpu").resolved_attn_impl(llama3b) == "window"
    assert EngineConfig(device="cpu", attn_impl="paged").resolved_attn_impl(
        llama3b) == "paged"
    # The kernel takes bf16 only: fp32 on the card can't force it.
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(device="cuda", dtype="float32",
                     attn_impl="paged").resolved_attn_impl(llama3b)
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(device="cpu", attn_impl="paged").resolved_attn_impl(tiny)
    with pytest.raises(ValueError, match="attn_impl"):
        EngineConfig(attn_impl="nope").resolved_attn_impl(llama3b)
    cfg = EngineConfig(model="llama-3b", max_model_len=4096)
    assert cfg.kv_cache_bytes_per_token(llama3b) == 2 * 28 * 8 * 128 * 2
    assert cfg.window_bytes_per_block(llama3b) == 16 * 2 * 28 * 8 * 128 * 2
    assert cfg.max_blocks_per_seq == 256


async def test_length_limit_matches_jax():
    """Rows that reach max_model_len mid-dispatch: the scheduler's per-row
    step budget and the runner's position clamp at max_model_len - 1 give
    the JAX engine's tokens and finish reasons."""
    jparams = jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.float32)
    common = dict(model=MODEL, max_model_len=64, num_kv_blocks=32,
                  attn_impl="window", num_decode_steps=8, dtype="float32")
    prompts = ["z" * 50, "y" * 41]
    want = await _serve_all(
        JaxEngine(JaxConfig(**common, async_pipeline=False,
                            overlap_dispatch=False), params=jparams),
        JaxSampling, prompts, 40)
    eng = ServingEngine(
        EngineConfig(**common, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               resolve_model_config(MODEL), torch.float32))
    got = await _serve_all(eng, SamplingParams, prompts, 40)
    eng.shutdown()
    assert got == want
    assert [len(t) for t in got] == [64 - 50, 64 - 41]


async def test_seeded_tokens_do_not_depend_on_the_batch():
    """A seeded request samples the same tokens alone and batched with
    others: each row's noise comes from its own seed schedule."""
    cfg = EngineConfig(model="tiny-llama", device="cpu", dtype="float32",
                       max_model_len=256, num_kv_blocks=64, num_decode_steps=8)
    eng = ServingEngine(cfg)
    seeded = SamplingParams(max_tokens=20, temperature=0.8, top_p=0.9, seed=7,
                            ignore_eos=True)

    async def one(prompt, sampling):
        toks = None
        async for out in eng.generate(prompt=prompt, sampling=sampling):
            toks = out.token_ids
        return toks

    await eng.start()
    try:
        alone = await one("seeded prompt", seeded)
        batched = await asyncio.gather(
            one("another prompt", SamplingParams(max_tokens=12, temperature=0.0,
                                                 ignore_eos=True)),
            one("seeded prompt", seeded),
            one("a third one", SamplingParams(max_tokens=30, temperature=1.0,
                                              seed=3, ignore_eos=True)),
        )
    finally:
        await eng.stop()
        eng.shutdown()
    assert batched[1] == alone and len(alone) == 20


@pytest.mark.parametrize("impl", ["paged", "window"])
async def test_bf16_engine_runs_on_cpu(impl):
    """The bf16 path the card runs (pools, ring and activations in bf16,
    f32 scores and logits) serves on the CPU through the kernel's plain
    version."""
    eng = ServingEngine(EngineConfig(model=MODEL, device="cpu",
                                     dtype="bfloat16", max_model_len=256,
                                     num_kv_blocks=64, attn_impl=impl,
                                     num_decode_steps=8))
    assert eng.runner.kv_k.dtype == torch.bfloat16
    got = await _serve_all(eng, SamplingParams, ["bf16 " * 20, "x"], 17)
    eng.shutdown()
    assert [len(t) for t in got] == [17, 17]
    assert all(0 <= t < 512 for row in got for t in row)
