"""The port's prefill chunk over static buffers (engine/prefill_graphs.py)
against the JAX runner's ``_prefill_impl``, family by family, and the warm
set a served engine replays.

Both runners take the same ``ScheduledBatch`` of the same sequences (block
ids given by hand) through ``execute_async``: the JAX runner pads its rows
to its two row families and runs ``_prefill_impl`` at that family, the
port pads to the same family and runs ``PrefillTrain``'s functions eagerly
over their arena (the functions a CUDA graph replays on the card). Weights
are the JAX params carried across by ``params_from_jax``; float32 unless a
case says bf16. Sampled tokens must be equal; pools and draft rings are
compared on every slot but the null block (the padding sink): float32
within ``TOL`` (tests/test_torch_model.py's), bf16 within two bf16
rounding steps, int8 as tests/test_torch_engine.py's
``_compare_int8_pools`` states (payload 1, scales 1 bf16 ulp, on at most
0.1% of elements).
"""

import asyncio
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.engine.scheduler import ScheduledBatch as JaxBatch
from production_stack_tpu.engine.scheduler import Sequence as JaxSequence
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.scheduler import ScheduledBatch, Sequence
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from tests.test_torch_engine import _compare_int8_pools
from tests.test_torch_lora import write_adapter

MODEL = "tiny-llama"
MC = resolve_model_config(MODEL)
BS = 16
# Prefill chunks of at most 64 tokens (t_floor 64), 16 blocks per sequence,
# row families 1 and 8.
BASE = dict(model=MODEL, dtype="float32", max_model_len=256, block_size=BS,
            num_kv_blocks=64, max_num_seqs=8, max_num_batched_tokens=64,
            num_decode_steps=8, attn_impl="window", async_pipeline=False,
            overlap_dispatch=False)
TOL = 2e-4
BF16_STEP = 2.0 ** -7       # one bf16 rounding step, relative


@functools.lru_cache(maxsize=None)
def _jax_params(dtype: str):
    return jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0),
                    jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)


def _pair(**over):
    """A JAX engine and a port engine (CPU) over the same weights."""
    fields = dict(BASE, **over)
    jparams = _jax_params(fields["dtype"])
    jeng = JaxEngine(JaxConfig(**fields), params=jparams)
    tdtype = torch.bfloat16 if fields["dtype"] == "bfloat16" else torch.float32
    teng = ServingEngine(
        EngineConfig(**fields, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, jparams), MC, tdtype))
    return jeng, teng


def _prompt(seed: int, n: int):
    return [int(x) for x in
            np.random.default_rng(seed).integers(3, MC.vocab_size, size=n)]


def _seqs(rows, tag="row"):
    """Each package's sequences of ``rows``: (prompt ids, block ids,
    sampling fields, adapter index, output ids already generated), request
    ids ``<tag>-<i>``."""
    out = []
    for seq_cls, samp_cls in ((Sequence, SamplingParams),
                              (JaxSequence, JaxSampling)):
        seqs = []
        for i, (ids, blocks, fields, adapter, outputs) in enumerate(rows):
            s = seq_cls(f"{tag}-{i}", list(ids), samp_cls(
                max_tokens=16, ignore_eos=True, **fields))
            s.block_ids = list(blocks)
            s.adapter_idx = adapter
            s.output_token_ids = list(outputs)
            seqs.append(s)
        out.append(seqs)
    return out


def _dispatch(jeng, teng, seqs, starts, lens):
    """One prefill chunk through both runners: (port tokens and logprobs,
    JAX's, the port's family key)."""
    train = teng.runner.prefill_train
    keys = []

    def recorded(key, bf, eager=False):
        keys.append(key)
        return type(train).run(train, key, bf, eager)

    train.run = recorded
    try:
        got = teng.runner.execute_async(ScheduledBatch(
            "prefill", seqs[0], chunk_starts=starts, chunk_lens=lens)).fetch()
    finally:
        del train.run
    want = jeng.runner.execute_async(JaxBatch(
        "prefill", seqs[1], chunk_starts=starts, chunk_lens=lens), 0).fetch()
    for group in seqs:
        for s, st, ln in zip(group, starts, lens):
            s.num_computed_tokens = st + ln
    assert len(keys) == 1
    return got, want, keys[0]


def _close_logprobs(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for g_row, w_row in zip(got, want):
        assert (g_row is None) == (w_row is None)
        for (gc, gtop), (wc, wtop) in zip(g_row or [], w_row or []):
            assert abs(gc - wc) <= TOL
            assert [i for i, _ in gtop] == [i for i, _ in wtop]
            np.testing.assert_allclose([v for _, v in gtop],
                                       [v for _, v in wtop], rtol=TOL, atol=TOL)


def _close_pools(jeng, teng):
    tr, jr = teng.runner, jeng.runner
    if tr.kv_quantized:
        _compare_int8_pools(jeng, teng)
        return
    bf16 = tr.kv_k.dtype == torch.bfloat16
    for t, j in ((tr.kv_k, jr.kv_k), (tr.kv_v, jr.kv_v)):
        got = t[:, :, BS:].float().numpy()
        want = np.asarray(j[:, :, BS:]).astype(np.float32)
        if bf16:
            np.testing.assert_allclose(got, want, rtol=2 * BF16_STEP,
                                       atol=2 * BF16_STEP * np.abs(want).max())
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert float(tr.kv_k[:, :, BS:].float().abs().sum()) > 0


def _close_rings(jeng, teng):
    """The draft rings of every live slot (the port's trash slot past them
    left out: the JAX runner drops those writes)."""
    tr, jr = teng.runner, jeng.runner
    s = tr.spec_num_slots
    np.testing.assert_allclose(tr.spec_k[:, :, :s].numpy(),
                               np.asarray(jr.spec_k), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tr.spec_v[:, :, :s].numpy(),
                               np.asarray(jr.spec_v), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(tr.spec_pos[:s].numpy(),
                                  np.asarray(jr.spec_pos))


def _blocks(i: int, n: int = 4):
    return list(range(1 + i * n, 1 + (i + 1) * n))


# case -> (engine fields, row sampling fields, adapters)
CASES = {
    "f32": ({}, [{}, dict(temperature=0.8, seed=3), dict(temperature=0.7,
                                                         top_k=20, seed=9)]),
    "bf16": (dict(dtype="bfloat16"), [{}, {}, {}]),
    "int8": (dict(kv_cache_dtype="int8"), [{}, dict(temperature=0.9, seed=1),
                                           {}]),
    "spec": (dict(speculative_num_tokens=3, speculative_model=MODEL),
             [{}, dict(temperature=0.8, seed=5), {}]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_families_match_jax(case):
    """Three rows take two chunks: a first chunk (no window) and a second
    over the history window, both padded to b = 8 (the
    ``max_prefill_seqs`` bucket: (8, 64, 16, False), then (8, 64, 4,
    True)); then one row's two-chunk prompt at b = 1 ((1, 64, 16, False),
    (1, 64, 16, True)). Tokens equal the JAX runner's; the pools (and a
    speculative engine's draft rings, where padding rows write only the
    trash slot) stay within the stated tolerance after every chunk."""
    over, samplings = CASES[case]
    jeng, teng = _pair(**over)
    try:
        rows = [(_prompt(10 + i, 52 - 5 * i), _blocks(i), samplings[i], 0, [])
                for i in range(3)]
        seqs = _seqs(rows)
        got, want, key = _dispatch(jeng, teng, seqs, [0] * 3, [32] * 3)
        assert key == (8, 64, 16, False, False, 0)
        assert got[0] == want[0] == [[], [], []]
        lens = [len(r[0]) - 32 for r in rows]
        got, want, key = _dispatch(jeng, teng, seqs, [32] * 3, lens)
        assert key == (8, 64, 4, True, False, 0)
        assert got[0] == want[0] and all(len(t) == 1 for t in got[0])
        _close_pools(jeng, teng)
        long_row = _seqs([(_prompt(20, 100), _blocks(5, 8), samplings[1], 0,
                           [])], tag="long")
        got, want, key = _dispatch(jeng, teng, long_row, [0], [64])
        assert key == (1, 64, 16, False, False, 0) and got[0] == [[]]
        got, want, key = _dispatch(jeng, teng, long_row, [64], [36])
        assert key == (1, 64, 8, True, False, 0)
        assert got[0] == want[0] and len(got[0][0]) == 1
        _close_pools(jeng, teng)
        if case == "spec":
            _close_rings(jeng, teng)
            # Padding rows named the trash slot and wrote nothing else.
            assert sorted(teng.runner._spec_slots.values()) == sorted(
                jeng.runner._spec_slots.values())
    finally:
        teng.shutdown()


@pytest.mark.parametrize("rows_n", [1, 3])
def test_penalty_and_logprob_variants_match_jax(rows_n):
    """A re-prefill with output tokens and penalties, and logprob rows of
    both buckets (8 and 20): at b = 1 the penalty variant and the first
    logprob bucket are captured families, at b = 8 every one of them runs
    eagerly; tokens, logprobs and pools equal the JAX runner's."""
    jeng, teng = _pair()
    try:
        fields = [dict(presence_penalty=0.7, frequency_penalty=0.4,
                       temperature=0.8, seed=2),
                  dict(logprobs=3), dict(logprobs=15, temperature=0.6, seed=4)]
        rows = [(_prompt(30 + i, 30), _blocks(i), fields[i], 0,
                 _prompt(40 + i, 6)) for i in range(rows_n)]
        seqs = _seqs(rows)
        got, want, key = _dispatch(jeng, teng, seqs, [0] * rows_n,
                                   [36] * rows_n)
        assert got[0] == want[0]
        _close_logprobs(got[1], want[1])
        _close_pools(jeng, teng)
        want_key = ((1, 64, 16, False, True, 0) if rows_n == 1
                    else (8, 64, 16, False, True, 20))
        assert key == want_key
        warm = set(teng.runner.prefill_graph_keys())
        assert (key in warm) == (rows_n == 1)
        logprob_row = _seqs([(_prompt(50, 30), _blocks(6), fields[1], 0, [])],
                            tag="lp")
        got, want, key = _dispatch(jeng, teng, logprob_row, [0], [30])
        assert key == (1, 64, 16, False, False, 8) and key in warm
        assert got[0] == want[0]
        _close_logprobs(got[1], want[1])
    finally:
        teng.shutdown()


@pytest.fixture(scope="module")
def adapter_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("prefill-adapters")
    return {"a": write_adapter(d / "a", MC, 4, ("wq", "wv", "w_down"), 1,
                               alpha=8)}


def test_lora_rows_mixed_with_base_rows_match_jax(adapter_dirs):
    """One padded batch of a base row, an adapter row and a base row (the
    adapter index rides packed scalar row 8; padding rows take adapter 0):
    tokens and pools equal the JAX runner's, and the adapter moves its
    row's tokens off the base model's."""
    jeng, teng = _pair(lora_modules=dict(adapter_dirs))
    try:
        prompt = _prompt(60, 40)
        rows = [(prompt, _blocks(i), dict(temperature=0.0), i % 2, [])
                for i in range(3)]
        seqs = _seqs(rows)
        got, want, key = _dispatch(jeng, teng, seqs, [0] * 3, [40] * 3)
        assert key == (8, 64, 16, False, False, 0)
        assert got[0] == want[0]
        assert got[0][0] == got[0][2]
        _close_pools(jeng, teng)
        base, adapted = teng.runner.kv_v[:, :, BS:5 * BS], \
            teng.runner.kv_v[:, :, 5 * BS:9 * BS]
        assert not torch.equal(base, adapted)
    finally:
        teng.shutdown()


@pytest.mark.parametrize("case", ["int8", "spec"])
def test_dummy_dispatches_write_only_the_null_block(case):
    """CPU warm-up runs every prefill family's all-zero dummy dispatch:
    the pool outside the null block (and, speculative, every draft-ring
    slot but the trash slot) is untouched, and every key of
    ``prefill_graph_keys`` counts as warmed."""
    over = (dict(kv_cache_dtype="int8") if case == "int8" else
            dict(speculative_num_tokens=3, speculative_model=MODEL))
    eng = ServingEngine(EngineConfig(**BASE, **over, device="cpu"))
    r = eng.runner
    torch.manual_seed(0)
    pools = [p for p in (r.kv_k, r.kv_v, r.kv_k_scale, r.kv_v_scale)
             if p is not None]
    for p in pools:
        p.copy_(torch.randint(-100, 100, p.shape).to(p.dtype))
    rings = []
    if r.spec_n:
        r.spec_k.normal_()
        r.spec_v.normal_()
        r.spec_pos.random_(0, 100)
        rings = [r.spec_k, r.spec_v]
    before = [p.clone() for p in pools]
    ring_before = [t.clone() for t in rings] + (
        [r.spec_pos.clone()] if r.spec_n else [])
    r.warmup()
    for p, b in zip(pools, before):
        assert torch.equal(p[:, :, BS:], b[:, :, BS:])
    s = r.spec_num_slots if r.spec_n else 0
    for t, b in zip(rings, ring_before):
        assert torch.equal(t[:, :, :s], b[:, :, :s])
    if r.spec_n:
        assert torch.equal(r.spec_pos[:s], ring_before[-1][:s])
    assert r.prefill_train.warmed == set(r.prefill_graph_keys())
    eng.shutdown()


async def _serve(engine, prompts, samplings, max_tokens=12):
    async def one(p, extra):
        toks = None
        async for out in engine.generate(prompt_token_ids=p, sampling=SamplingParams(
                max_tokens=max_tokens, ignore_eos=True, **extra)):
            toks = out.token_ids
        return toks

    # Every request is queued before the loop starts: multi-row prefills.
    tasks = [asyncio.create_task(one(p, s)) for p, s in zip(prompts, samplings)]
    await asyncio.sleep(0)
    await engine.start()
    try:
        return await asyncio.gather(*tasks)
    finally:
        await engine.stop()


async def test_served_engine_runs_warm_families_and_chains_from_prefill():
    """A served CPU engine with warm-up and the overlapped two-slot loop:
    every prefill dispatch of default-variant requests (single and
    multi-row, chunked, windowed) is a warmed key and none counts as
    eager; decodes chain start tokens from a prefill's last-token vector,
    a copy, not the arena's; tokens equal the strict cold engine's. Then a
    top-bucket logprob request's prefill counts as eager."""
    # A 256-token budget: two rows per multi-row prefill (padded to 8).
    fields = dict(BASE, max_model_len=512, num_kv_blocks=96,
                  max_num_batched_tokens=256)
    strict_fields = dict(fields)
    fields.update(async_pipeline=True, overlap_dispatch=True,
                  enable_warmup=True)
    eng = ServingEngine(EngineConfig(**fields, device="cpu"),
                        params=params_from_jax(jax.tree.map(
                            np.asarray, _jax_params("float32")), MC,
                            torch.float32))
    r = eng.runner
    train = r.prefill_train
    keys, pushed = [], []
    run, push = train.run, r._push_last

    def recorded(key, bf, eager=False):
        keys.append(key)
        return run(key, bf, eager)

    def push_last(last):
        pushed.append(last.data_ptr())
        return push(last)

    train.run = recorded
    r._push_last = push_last
    prompts = [_prompt(70 + i, n) for i, n in enumerate((5, 300, 20, 70, 33))]
    greedy = dict(temperature=0.0)
    samplings = [greedy, dict(temperature=0.8, seed=1), greedy, greedy,
                 dict(temperature=0.5, top_p=0.8, seed=2)]
    got = await _serve(eng, prompts, samplings)
    st = eng.stats()
    warm = set(r.prefill_graph_keys())
    assert keys and set(keys) <= warm
    assert {k[0] for k in keys} == {1, 8} and any(k[3] for k in keys)
    assert st["prefill_eager_dispatches_total"] == 0
    assert st["chained_dispatches_total"] > 0
    assert train.buffers(*keys[0]).last.data_ptr() not in pushed
    strict = ServingEngine(EngineConfig(**strict_fields, device="cpu"),
                           params=r.params)
    assert got == await _serve(strict, prompts, samplings)
    assert strict.stats()["prefill_eager_dispatches_total"] > 0  # no warm-up
    strict.shutdown()
    await _serve(eng, [_prompt(80, 9)], [dict(logprobs=15, **greedy)])
    assert keys[-1] == (1, 128, 32, False, False, 20) and keys[-1] not in warm
    assert eng.stats()["prefill_eager_dispatches_total"] == 1
    eng.shutdown()
