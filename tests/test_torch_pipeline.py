"""The port's pipelined engine loop, device token chaining, padded decode
rows and decode graph families, against the JAX package and against the
port's own strict loop.

On the CPU the decode train (engine/decode_graphs.py) runs its head, step
and tail eagerly: the code a CUDA graph replays on the card. The JAX engine
runs its Pallas kernel in interpret mode. Weights are shared (the JAX params
through numpy) and float32, as in tests/test_torch_engine.py.
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as jsampling
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu_torch.engine import decode_graphs
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import (
    SamplingParams,
    gumbel_noise,
    token_seed,
    token_seeds,
)
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.utils import prefill_t_floor

MODEL = "tiny-llama-128dh"
CPU = torch.device("cpu")
# The three loop modes every parity workload must agree across (the
# reference's tests/test_pipeline.py LOOP_MODES).
LOOP_MODES = (
    ("strict", dict(async_pipeline=False, overlap_dispatch=False)),
    ("pipeline", dict(async_pipeline=True, overlap_dispatch=False)),
    ("overlap", dict(async_pipeline=True, overlap_dispatch=True)),
)
# Two greedy and two seeded rows (top-p, top-k), one multi-chunk prompt.
_PROMPTS = ["hello world this is request 0 ", "x" * 150, "seeded one ",
            "a seeded top-k row"]
_SAMPLINGS = [{}, {}, dict(temperature=0.8, top_p=0.9, seed=1234),
              dict(temperature=0.8, top_k=50, seed=7)]
# (attn_impl, block_size, num_kv_blocks, kv_cache_dtype): paged cases use
# 64-token pages (the Pallas interpret-mode compile unrolls one DMA per
# page of a 512-token superpage).
CASES = {
    "paged": ("paged", 64, 32, "bfloat16"),
    "window": ("window", 16, 128, "bfloat16"),
    "paged-int8": ("paged", 64, 32, "int8"),
}


def _common(case):
    impl, bs, blocks, kv_dtype = CASES[case]
    return dict(model=MODEL, max_model_len=256, block_size=bs,
                num_kv_blocks=blocks, attn_impl=impl, num_decode_steps=8,
                dtype="float32", max_num_batched_tokens=64, max_num_seqs=8,
                kv_cache_dtype=kv_dtype)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.float32)


def _port_params():
    return params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                           resolve_model_config(MODEL), torch.float32)


def _record_families(runner):
    """Record the family of every dispatch ``runner`` issues: a decode's
    (b, mb, K) as its train runs it; a prefill's as the reference's (b, t,
    mb, has_window), its row family (1, or the max prefill bucket) with the
    runner's own buckets. Returns the (decode, prefill) sets it fills."""
    decode, prefill = set(), set()
    run, issue = runner.decode_train.run, runner.execute_async
    pb_max = max(f[0] for f in runner.reachable_prefill_families())

    def run_and_record(key, bf, n_steps):
        decode.add(key[:3])
        return run(key, bf, n_steps)

    def issue_and_record(batch):
        if batch.kind != "decode":
            rows = 1 if len(batch.seqs) == 1 else pb_max
            prefill.add((rows, *runner.prefill_shape(batch)))
        return issue(batch)

    runner.decode_train.run = run_and_record
    runner.execute_async = issue_and_record
    return decode, prefill


async def _serve(engine, sampling_cls, prompts, max_tokens, samplings=None):
    """All prompts submitted before the loop starts (so every mode sees
    the same arrivals); each request's tokens."""
    async def one(p, extra):
        toks = None
        fields = dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
        fields.update(extra)
        async for out in engine.generate(prompt=p,
                                         sampling=sampling_cls(**fields)):
            toks = out.token_ids
        return toks

    tasks = [asyncio.create_task(one(p, samplings[i] if samplings else {}))
             for i, p in enumerate(prompts)]
    await asyncio.sleep(0)
    await engine.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        await engine.stop()


@functools.lru_cache(maxsize=None)
def _jax_tokens(case):
    """The strict JAX engine's tokens for ``case`` (computed once)."""
    jeng = JaxEngine(JaxConfig(**_common(case), async_pipeline=False,
                               overlap_dispatch=False), params=_jax_params())
    return asyncio.run(_serve(jeng, JaxSampling, _PROMPTS, 12, _SAMPLINGS))


@pytest.mark.parametrize("case", list(CASES))
async def test_pipelined_port_matches_jax(case):
    """The port with the reference's default loop (pipelined, overlapped)
    gives the JAX engine's greedy and seeded tokens; its decodes chained
    start tokens on the device and overlapped their fetches."""
    want = await asyncio.get_running_loop().run_in_executor(
        None, _jax_tokens, case)
    eng = ServingEngine(EngineConfig(**_common(case), device="cpu"),
                        params=_port_params())
    assert (eng.config.async_pipeline, eng.config.overlap_dispatch) == (True, True)
    got = await _serve(eng, SamplingParams, _PROMPTS, 12, _SAMPLINGS)
    st = eng.stats()
    eng.shutdown()
    assert got == want
    assert all(len(t) == 12 for t in got)
    assert st["overlapped_fetches_total"] > 0
    assert st["chained_dispatches_total"] > 0
    assert st["num_requests_running"] == st["num_requests_waiting"] == 0


async def test_penalty_rows_match_jax_in_the_pipelined_loop():
    """Presence/frequency penalties (counts built from APPLIED tokens: the
    loop drains its dispatches before a penalty batch): the pipelined port
    gives the JAX engine's tokens, alone (b = 1, the graph-captured penalty
    variant) and batched with a plain row."""
    common = _common("window")
    samplings = [dict(presence_penalty=0.7, frequency_penalty=0.4),
                 dict(temperature=0.9, seed=5, frequency_penalty=1.1)]
    prompts = ["penalized prompt ", "second penalized one"]

    def jax_tokens():
        def serve(n):
            jeng = JaxEngine(JaxConfig(**common, async_pipeline=False,
                                       overlap_dispatch=False),
                             params=_jax_params())
            return asyncio.run(_serve(jeng, JaxSampling, prompts[:n], 14,
                                      samplings[:n]))
        return serve(1), serve(2)

    want = await asyncio.get_running_loop().run_in_executor(None, jax_tokens)
    got, fams = [], set()
    for n in (1, 2):
        eng = ServingEngine(EngineConfig(**common, device="cpu"),
                            params=_port_params())
        decode, _ = _record_families(eng.runner)
        got.append(await _serve(eng, SamplingParams, prompts[:n], 14,
                                samplings[:n]))
        eng.shutdown()
        fams |= {f[0] for f in decode}
    assert tuple(got) == want
    assert fams == {1, 2}


def _tiny_cfg(**over):
    base = dict(model="tiny-llama", device="cpu", max_model_len=512,
                num_kv_blocks=256, num_decode_steps=8, dtype="float32",
                max_num_seqs=4, max_num_batched_tokens=128)
    base.update(over)
    return EngineConfig(**base)


async def test_prefill_arrives_mid_decode_parity():
    """A prompt submitted while a decode is in flight: the overlap loop
    issues its prefill beside the decode, and both streams' tokens equal
    the strict loop's (tests/test_pipeline.py's shape)."""
    outs = {}
    for name, over in LOOP_MODES:
        engine = ServingEngine(_tiny_cfg(**over))
        await engine.start()
        try:
            results = {}

            async def collect(key, prompt, sp):
                async for o in engine.generate(prompt=prompt, sampling=sp):
                    results[key] = o.token_ids

            long_task = asyncio.create_task(collect(
                "long", "steady decode stream goes on",
                SamplingParams(temperature=0.0, max_tokens=48,
                               ignore_eos=True)))
            for _ in range(400):
                if engine.stats()["decode_dispatches_total"] > 0:
                    break
                await asyncio.sleep(0.005)
            late_task = asyncio.create_task(collect(
                "late", "a late arriving prompt with some extra words",
                SamplingParams(temperature=0.9, seed=7, max_tokens=12,
                               ignore_eos=True)))
            await asyncio.wait_for(asyncio.gather(long_task, late_task), 120)
            outs[name] = results
            if name == "overlap":
                assert engine.stats()["dispatch_overlap_ratio"] > 0
        finally:
            await engine.stop()
            engine.shutdown()
    assert outs["overlap"] == outs["strict"]
    assert outs["pipeline"] == outs["strict"]
    assert len(outs["overlap"]["long"]) == 48
    assert len(outs["overlap"]["late"]) == 12


async def test_abort_mid_flight_parity():
    """Aborting a stream while its chained dispatches are in flight frees
    its blocks, and the engine goes on serving the strict loop's tokens."""
    outs = {}
    for name, over in LOOP_MODES:
        engine = ServingEngine(_tiny_cfg(enable_prefix_caching=False, **over))
        await engine.start()
        try:
            agen = engine.generate(
                prompt="a long one", request_id="victim",
                sampling=SamplingParams(temperature=0.0, max_tokens=400,
                                        ignore_eos=True))
            async for o in agen:
                if o.num_output_tokens >= 8:
                    break
            await agen.aclose()   # client disconnect -> abort
            for _ in range(400):
                if engine.scheduler.num_running == 0 and \
                        engine.block_manager.num_used_blocks == 0:
                    break
                await asyncio.sleep(0.005)
            assert engine.scheduler.num_running == 0
            assert engine.block_manager.num_used_blocks == 0
            toks = []
            async for o in engine.generate(
                    prompt="after abort", sampling=SamplingParams(
                        temperature=0.0, max_tokens=6, ignore_eos=True)):
                toks = o.token_ids
            outs[name] = toks
        finally:
            await engine.stop()
            engine.shutdown()
    assert len(outs["strict"]) == 6
    assert outs["pipeline"] == outs["overlap"] == outs["strict"]


async def test_preemption_with_dispatch_in_flight_parity():
    """Pool pressure preempts rows while (up to two) dispatches are in
    flight: epochs discard the stale tokens, recompute gives the same
    ones, in every loop mode and as an unpressured run."""
    async def run_all(engine):
        async def run(i):
            toks = []
            async for o in engine.generate(
                    prompt=f"user {i} prompt text",
                    sampling=SamplingParams(temperature=0.0, max_tokens=40,
                                            ignore_eos=True)):
                toks = o.token_ids
            return toks
        await engine.start()
        try:
            return await asyncio.gather(*[run(i) for i in range(3)])
        finally:
            await engine.stop()
            engine.shutdown()

    small = dict(max_model_len=256, max_num_seqs=3, max_num_batched_tokens=64)
    calm = await run_all(ServingEngine(_tiny_cfg(**small)))
    for name, over in LOOP_MODES:
        engine = ServingEngine(_tiny_cfg(num_kv_blocks=10, **small, **over))
        got = await run_all(engine)
        if name == "overlap":
            assert engine.scheduler.num_preemptions_total > 0, \
                "workload no longer exercises preemption"
        assert got == calm, name
    assert all(len(t) == 40 for t in calm)


class _JaxFamilies:
    """The JAX runner's family enumeration on a stub carrying what it
    reads: the config, the attention path and the window budgets."""
    reachable_decode_families = JaxRunner.reachable_decode_families
    reachable_prefill_families = JaxRunner.reachable_prefill_families

    def __init__(self, runner):
        self.config = JaxConfig(
            model=MODEL, max_model_len=runner.config.max_model_len,
            block_size=runner.config.block_size,
            max_num_seqs=runner.config.max_num_seqs,
            max_num_batched_tokens=runner.config.max_num_batched_tokens,
            num_decode_steps=runner.config.num_decode_steps)
        self.attn_impl = runner.attn_impl
        self.decode_window_blocks = runner.decode_window_blocks
        self.prefill_window_blocks = runner.prefill_window_blocks


@pytest.mark.parametrize("max_num_seqs", [1, 4, 8])
@pytest.mark.parametrize("impl", ["paged", "window"])
def test_reachable_families_equal_jax(impl, max_num_seqs):
    """The port's decode and prefill families are the JAX runner's (decode
    without the reference's cached-window flag, which the port has no use
    for: it keeps no persistent window)."""
    runner = ModelRunner(EngineConfig(
        model=MODEL, device="cpu", attn_impl=impl, max_model_len=1024,
        block_size=16, num_kv_blocks=64, max_num_seqs=max_num_seqs,
        max_num_batched_tokens=256, num_decode_steps=32),
        resolve_model_config(MODEL))
    ref = _JaxFamilies(runner)
    assert set(runner.reachable_decode_families()) == {
        f[:3] for f in ref.reachable_decode_families()}
    assert set(runner.reachable_prefill_families()) == set(
        ref.reachable_prefill_families())
    keys = runner.decode_graph_keys()
    assert len(keys) == len(set(keys))
    fams = set(runner.reachable_decode_families())
    # The reference's warm variants: (penalties, logprobs bucket) (False, 0)
    # and (False, 8) of every family, (True, 0) at b = 1; none speculative.
    assert {k[:3] for k in keys if k[3:5] == (False, 0)} == fams
    assert {k[:3] for k in keys if k[3:5] == (False, 8)} == fams
    assert {k[:3] for k in keys if k[3]} == {f for f in fams if f[0] == 1}
    assert all(k[3:] in ((False, 0, False), (False, 8, False),
                         (True, 0, False)) for k in keys)
    # Prefill, the reference's warm rule: the default variant of every
    # family, the first logprob bucket at b = 1, penalties only at (1,
    # t_floor, full_mb, False).
    pkeys = runner.prefill_graph_keys()
    assert len(pkeys) == len(set(pkeys))
    pfams = set(ref.reachable_prefill_families())
    t_floor = prefill_t_floor(runner.config.max_num_batched_tokens)
    want = {f + (False, 0) for f in pfams}
    want |= {f + (False, 8) for f in pfams if f[0] == 1}
    want |= {f + (True, 0) for f in pfams
             if f[0] == 1 and f[1] == t_floor and not f[3]}
    assert set(pkeys) == want
    assert any(k[0] > 1 for k in pkeys) == (max_num_seqs > 1)


@pytest.mark.parametrize("impl", ["paged", "window"])
async def test_served_dispatches_fall_inside_reachable_families(impl):
    """Every dispatch of a served run (single and multi-row prefill,
    chunked and windowed prefill, decode at several row counts and K) is of
    a reachable family, so warmup's graphs cover serving."""
    cfg = _tiny_cfg(model=MODEL, attn_impl=impl, block_size=16,
                    num_kv_blocks=96, max_model_len=256, max_num_seqs=8,
                    max_num_batched_tokens=64, num_decode_steps=16)
    eng = ServingEngine(cfg, params=_port_params())
    decode, prefill = _record_families(eng.runner)
    prompts = ["a", "b" * 100, "c" * 20, "d" * 70, "e" * 5]
    got = await _serve(eng, SamplingParams, prompts, 24)
    eng.shutdown()
    r = eng.runner
    assert all(len(t) == 24 for t in got)
    assert decode <= set(r.reachable_decode_families())
    assert prefill <= set(r.reachable_prefill_families())
    assert len({f[0] for f in decode}) >= 2
    assert any(f[3] for f in prefill)


def test_device_seed_gumbel_matches_jax():
    """Seeds derived on the device (``token_seeds``, the reference's
    ``_derive_seeds``) and the Gumbel field from them, masked by a device
    row mask, equal the JAX package's bit for bit."""
    base = np.array([0, 1234, 2**32 - 1, 7, 99], np.uint32)
    gen0 = np.array([0, 5, 2**32 - 1, 100, 3], np.uint32)
    j = 3
    jseeds = JaxRunner._derive_seeds(None, jnp.asarray(base), jnp.asarray(gen0),
                                     jnp.int32(j))
    want = np.asarray(jsampling._gumbel(jseeds, (5, 512)))
    # Seeds ride the packed int32 buffer as uint32 bit patterns.
    tseeds = token_seeds(torch.from_numpy(base.view(np.int32)),
                         torch.from_numpy(gen0.view(np.int32)).long() + j)
    np.testing.assert_array_equal(tseeds.numpy(), np.asarray(jseeds))
    assert tseeds.tolist() == [token_seed(int(b), int(g) + j)
                               for b, g in zip(base, gen0)]
    rows = torch.tensor([True, True, False, True, True])
    got = gumbel_noise(tseeds, 512, CPU, rows=rows).numpy()
    np.testing.assert_array_equal(got[rows.numpy()].view(np.int32),
                                  want[rows.numpy()].view(np.int32))
    assert not got[2].any()


async def test_padding_rows_change_no_live_row():
    """Three rows decode padded to b = 4 with max_num_seqs 8, unpadded
    with max_num_seqs 3: the same tokens, and the same pool outside the
    null block (padding rows write only there)."""
    outs, pools = [], []
    for max_num_seqs in (3, 8):
        eng = ServingEngine(
            _tiny_cfg(max_num_seqs=max_num_seqs, async_pipeline=False,
                      num_kv_blocks=64, max_model_len=128),
            params=ServingEngine(_tiny_cfg()).runner.params)
        fams, _ = _record_families(eng.runner)
        outs.append(await _serve(eng, SamplingParams,
                                 ["one", "two two", "three three three"], 20,
                                 [{}, dict(temperature=1.0, seed=5), {}]))
        assert {f[0] for f in fams} == ({3} if max_num_seqs == 3 else {4})
        bs = eng.config.block_size
        pools.append((eng.runner.kv_k[:, :, bs:], eng.runner.kv_v[:, :, bs:]))
        eng.shutdown()
    assert outs[0] == outs[1]
    assert all(len(t) == 20 for t in outs[0])
    assert torch.equal(pools[0][0], pools[1][0])
    assert torch.equal(pools[0][1], pools[1][1])


async def test_warmup_keeps_the_pool_and_while_loop_tokens_match():
    """CPU warmup runs every family's dummy dispatch (budget 0, table 0):
    the pool outside the null block is untouched. decode_loop="while"
    (steps no row needs are skipped) gives the "scan" tokens."""
    params = ServingEngine(_tiny_cfg()).runner.params
    runner = ModelRunner(_tiny_cfg(), resolve_model_config("tiny-llama"),
                         params=params)
    torch.manual_seed(0)
    for pool in (runner.kv_k, runner.kv_v):
        pool.normal_()
    before = (runner.kv_k.clone(), runner.kv_v.clone())
    runner.warmup()
    bs = runner.config.block_size
    assert len(runner.decode_graph_keys()) >= 3
    assert torch.equal(runner.kv_k[:, :, bs:], before[0][:, :, bs:])
    assert torch.equal(runner.kv_v[:, :, bs:], before[1][:, :, bs:])
    eng = ServingEngine(_tiny_cfg(enable_warmup=True, decode_loop="while"),
                        params=params)
    prompts = ["while loop", "scan loop too"]
    samplings = [dict(max_tokens=13), dict(temperature=0.7, seed=3)]
    got = await _serve(eng, SamplingParams, prompts, 10, samplings)
    want = await _serve(ServingEngine(_tiny_cfg(), params=params),
                        SamplingParams, prompts, 10, samplings)
    eng.shutdown()
    assert got == want
    assert [len(t) for t in got] == [13, 10]


def test_launch_counts_stay_zero_off_the_card():
    """The launch counts live on the card and are taken by the kernel:
    a served CPU run (its paged decode takes the plain version) counts
    nothing, and a reset leaves every variant at 0."""
    pa.reset_launch_counts()
    before = pa.launch_counts()
    assert set(before) == set(pa.VARIANTS)
    eng = ServingEngine(_tiny_cfg(model=MODEL, attn_impl="paged",
                                  block_size=16))
    got = asyncio.run(_serve(eng, SamplingParams, ["count me"], 9))
    eng.shutdown()
    assert len(got[0]) == 9 and eng.runner.decode_steps_total > 0
    assert pa.launch_counts() == before


@pytest.mark.cuda
def test_replayed_launches_are_counted_per_replay():
    """On the card: the kernel counts its own launches, so each replay of
    a graph that captured one call counts once, under its variant."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((2, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
    pool = torch.randn((1, 2, 64, 128), generator=gen,
                       device=dev).to(torch.bfloat16)
    bt = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32, device=dev)
    lens = torch.tensor([30, 9], dtype=torch.int32, device=dev)
    want = pa.paged_flash_decode_stats(q, pool, pool, bt, lens, 0,
                                       block_size=16)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = pa.paged_flash_decode_stats(q, pool, pool, bt, lens, 0,
                                          block_size=16)
    pa.reset_launch_counts()
    for _ in range(3):
        graph.replay()
    assert pa.launch_counts() == {**dict.fromkeys(pa.VARIANTS, 0), pa.BF16: 3}
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_decode_arena_is_shared_by_families():
    """Every family's buffers are views at the start of one arena per
    buffer (sized for the largest), so captured graphs share them."""
    runner = ModelRunner(_tiny_cfg(max_num_seqs=8),
                         resolve_model_config("tiny-llama"))
    train = runner.decode_train
    keys = runner.decode_graph_keys()
    train.reserve(keys)
    big = max(keys, key=lambda k: k[0] * k[2])
    small = min(keys, key=lambda k: k[0] * k[2])
    a, b = train.buffers(*big), train.buffers(*small)
    assert a.ring_k.data_ptr() == b.ring_k.data_ptr()
    assert a.toks_all.data_ptr() == b.toks_all.data_ptr()
    assert tuple(b.ring_k.shape)[2:4] == (small[0], small[2])
    assert decode_graphs.NUM_SCALARS == 14
