"""Tensor parallelism in the PyTorch port against the JAX package's.

Everything runs on the CPU in float32: the port's tp ranks are processes of
``torch.distributed`` over gloo (rank 0 in this process, the workers spawned
by the engine through the port's own launcher, without jax); the JAX
package shards over the conftest's 8 host devices, and its paged kernel runs
in interpret mode. The checks:
  * each rank's ``shard_params`` equals, bit for bit, the addressable shard
    on device r of ``jax.device_put(leaf, param_shardings(...))``, and the
    pool slices equal the shards of ``kv_pool_sharding`` /
    ``kv_scale_sharding``, the replication fallback's whole leaves
    included;
  * ``paged_flash_decode_stats_tp``, each rank's call gathered over 2
    ranks, equals JAX ``paged_flash_decode_stats_tp(..., interpret=True)``
    (unquantized pools to 2e-4, int8 pools to 1e-5, as the single-device
    tests hold the kernel; rows with kv_len 0 exactly (0, -inf, 0));
  * engine tokens at tp = 2 (and 4 on the window path), greedy and seeded,
    equal the JAX engine's at tp = 1 on the same weights (which JAX's own
    tests hold equal to its tp > 1), and the ranks' token digests agree;
  * config errors name the flags (tp degrees that divide no head count
    now build, the int8 refusal stays); a lost worker fails the engine
    within the collective timeout.
The tests run with one intra-op thread (the ranks share this machine's
cores; a worker runs with rank 0's thread count).
"""

import asyncio
import dataclasses
import os
import signal
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu.ops.pallas import paged_attention as jpa
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu.parallel.sharding import (
    kv_pool_sharding,
    kv_scale_sharding,
    param_shardings,
)
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import (
    kv_pools_from_jax,
    params_from_jax,
)
from production_stack_tpu_torch.ops import paged_attention as tpa
from production_stack_tpu_torch.parallel.mesh import rank_order_sum
from production_stack_tpu_torch.parallel.sharding import (
    shard_kv_pool,
    shard_params,
)
from production_stack_tpu_torch.server.api_server import parse_args

TOL = 2e-4        # unquantized pools, f32: summation order only
ATOL_INT8 = 1e-5  # int8 pools, f32
PALLAS_BS = 64


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _leaves(params):
    for k, v in params.items():
        if k == "layers":
            for n, t in v.items():
                yield (k, n), t
        else:
            yield (k,), v


def _get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _shard_on(arr, device):
    return np.asarray(next(s.data for s in arr.addressable_shards
                           if s.device == device))


# ------------------------------------------------------------------ sharding
@pytest.mark.parametrize("model,tp", [("tiny-llama-8kv", 2),
                                      ("tiny-llama-8kv", 4),
                                      ("tiny-llama-128dh", 2),
                                      ("tiny-llama", 4),
                                      ("tiny-llama-128dh", 3),
                                      ("tiny-llama-128dh", 4)])
def test_shards_equal_jax_addressable_shards(model, tp):
    jmc, mc = jax_resolve(model), resolve_model_config(model)
    jparams = jax_init(jmc, jax.random.PRNGKey(0), jnp.float32)
    mesh = make_mesh(tp=tp)
    placed = jax.device_put(jparams, param_shardings(jmc, mesh, jparams))
    np_tree = jax.tree.map(np.asarray, jparams)
    full = params_from_jax(np_tree, mc, torch.float32)
    rng = np.random.default_rng(tp)
    pool = rng.standard_normal((2, mc.num_kv_heads, 32, mc.head_dim_)).astype(np.float32)
    scale = rng.standard_normal(pool.shape[:-1]).astype(np.float32)
    jpool = jax.device_put(jnp.asarray(pool), kv_pool_sharding(jmc, mesh))
    jscale = jax.device_put(jnp.asarray(scale), kv_scale_sharding(jmc, mesh))
    devices = mesh.devices.reshape(-1)
    for r in range(tp):
        mine = shard_params(full, mc, r, tp)
        direct = params_from_jax(np_tree, mc, torch.float32, rank=r, tp=tp)
        for path, leaf in _leaves(mine):
            want = _shard_on(_get(placed, path), devices[r])
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=str(path))
            np.testing.assert_array_equal(_get(direct, path).numpy(), want)
        np.testing.assert_array_equal(shard_kv_pool(_t(pool), r, tp).numpy(),
                                      _shard_on(jpool, devices[r]))
        np.testing.assert_array_equal(shard_kv_pool(_t(scale), r, tp).numpy(),
                                      _shard_on(jscale, devices[r]))


@pytest.mark.parametrize("model,tp,tied", [("tiny-llama-8kv", 2, False),
                                           ("tiny-llama-8kv", 4, True),
                                           ("tiny-llama-128dh", 3, False),
                                           ("tiny-llama-128dh", 3, True),
                                           ("tiny-llama", 4, False)])
def test_tp_plan_follows_the_shard_shapes(model, tp, tied):
    """Each rank's ``TPPlan`` reduces or gathers exactly the products whose
    leaves ``shard_params`` split (a replicated ``wo``, ``w_down``, embed
    or head is never summed over the ranks), and is built once per
    (config, tp size, rank)."""
    mc = dataclasses.replace(resolve_model_config(model), tie_word_embeddings=tied)
    full = llama.init_params(mc, torch.Generator().manual_seed(0),
                             torch.float32, torch.device("cpu"))
    fl = full["layers"]
    for r in range(tp):
        mine = shard_params(full, mc, r, tp)
        ml = mine["layers"]
        group = types.SimpleNamespace(size=tp, rank=r)
        plan = llama.tp_plan(mc, group)
        assert plan is llama.tp_plan(mc, types.SimpleNamespace(size=tp, rank=r))
        assert plan.mlp_reduce == (ml["w_down"].shape[-2] < fl["w_down"].shape[-2])
        assert plan.embed_split == (mine["embed"].shape[-1] < full["embed"].shape[-1])
        head = "embed" if tied else "lm_head"
        assert plan.head_split == (mine[head].shape[-1] < full[head].shape[-1])
        o_rows = ml["wo"].shape[-2]
        if o_rows < fl["wo"].shape[-2]:
            assert plan.o_cols is not None
            assert plan.o_cols[1] - plan.o_cols[0] == o_rows
        else:
            assert plan.o_cols is None
        kv_split = ml["wk"].shape[-1] < fl["wk"].shape[-1]
        pool_split = mc.num_kv_heads % tp == 0
        assert plan.kv_gather == (kv_split and not pool_split)


def test_init_params_shards_are_the_tp1_draw():
    """Each rank draws every leaf in full from the same seed and keeps its
    slice: the ranks' shards are the tp=1 params' slices, bit for bit."""
    mc = resolve_model_config("tiny-llama-8kv")

    def draw(rank, tp):
        gen = torch.Generator().manual_seed(3)
        return llama.init_params(mc, gen, torch.float32, torch.device("cpu"),
                                 rank=rank, tp=tp)

    full = draw(0, 1)
    for r in range(2):
        got = draw(r, 2)
        want = shard_params(full, mc, r, 2)
        for path, leaf in _leaves(want):
            assert torch.equal(_get(got, path), leaf), path


class _ThreadRank:
    """One rank of a tp group whose ranks are threads of this process: the
    collectives of ``parallel/mesh.py:TPGroup`` (gather in rank order,
    ``rank_order_sum``) over a barrier."""

    def __init__(self, rank, size, slots, barrier):
        self.rank, self.size, self._slots, self._barrier = rank, size, slots, barrier

    def _gather(self, x):
        self._slots[self.rank] = x
        self._barrier.wait()
        parts = list(self._slots)
        self._barrier.wait()
        return parts

    def all_gather(self, x, dim=-1):
        return torch.cat(self._gather(x), dim=dim)

    def all_reduce(self, x):
        return rank_order_sum(self._gather(x), x.dtype)


def _thread_ranks(fn, tp):
    """``fn(rank, group)`` on ``tp`` threads forming one tp group; returns
    each rank's result."""
    slots, barrier, got = [None] * tp, threading.Barrier(tp), [None] * tp

    def run(r):
        got[r] = fn(r, _ThreadRank(r, tp, slots, barrier))

    threads = [threading.Thread(target=run, args=(r,)) for r in range(tp)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
        assert not th.is_alive()
    return got


def _forward_logits(params, mc, toks, tp=None):
    b, t = toks.shape
    pos = torch.arange(t)[None].repeat(b, 1)
    h, _, _ = llama.forward(params, mc, toks, pos, torch.full((b,), t), tp=tp)
    return llama.compute_logits(params, mc, h, llama.lm_head_f32(params, mc),
                                tp=tp)


@pytest.mark.parametrize("tied", [False, True])
def test_sharded_forward_matches_tp1_in_f32(tied):
    """The sharded forward and head (ranks as threads, f32): the logits of
    every rank are bit-identical and equal tp = 1's up to summation order
    (1e-5), for an untied head (vocab slices all-gathered) and a tied one
    (partial logits over D all-reduced)."""
    mc = dataclasses.replace(resolve_model_config("tiny-llama-8kv"),
                             tie_word_embeddings=tied)
    full = llama.init_params(mc, torch.Generator().manual_seed(1),
                             torch.float32, torch.device("cpu"))
    toks = torch.randint(0, mc.vocab_size, (2, 24),
                         generator=torch.Generator().manual_seed(2))
    want = _forward_logits(full, mc, toks)
    got = _thread_ranks(lambda r, g: _forward_logits(
        shard_params(full, mc, r, 2), mc, toks, g), 2)
    assert torch.equal(got[0], got[1])
    torch.testing.assert_close(got[0], want, rtol=1e-5, atol=1e-5)


def test_tp_logit_bound_covers_a_32_layer_proxy():
    """The rounding model behind chip_smoke.py's teacher-forced logit bound
    (``tp_logit_bound``), on a proxy of llama-3-8b: its depth (32 layers)
    and GQA ratio at a narrow width, random weights, bf16 on the CPU. The
    tp = 2 forward (the sharded params and collectives, the two ranks as
    threads) against the tp = 1 forward over the same tokens: the logits
    differ by less than the model's one-source bound (the CPU has no
    second source: its GEMM orders do not depend on the shapes here), and
    the two ranks' logits are bit-identical."""
    mc = dataclasses.replace(
        resolve_model_config("llama-3-8b"), hidden_size=512,
        intermediate_size=1792, num_heads=8, num_kv_heads=2, head_dim=64,
        vocab_size=8192, name="proxy")
    gen = torch.Generator().manual_seed(0)
    full = llama.init_params(mc, gen, torch.bfloat16, torch.device("cpu"))
    toks = torch.randint(0, mc.vocab_size, (2, 96), generator=gen)
    want = _forward_logits(full, mc, toks)
    got = _thread_ranks(lambda r, g: _forward_logits(
        shard_params(full, mc, r, 2), mc, toks, g), 2)
    assert torch.equal(got[0], got[1])
    diff = (got[0] - want).abs()
    bound = chip_smoke.tp_logit_bound(mc.num_layers, want.numel(), sources=1)
    print(f"proxy: max |logit diff| {diff.max().item():.4f}, mean "
          f"{diff.mean().item():.5f}, one-source bound {bound:.4f}")
    assert 0 < diff.max().item() <= bound


# ---------------------------------------------------------------- the tp op
@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_tp_matches_jax_shard_map(quant):
    tp, b, hkv, g, dh, bs, mb = 2, 4, 4, 2, 128, PALLAS_BS, 10
    h = hkv * g
    rng = np.random.default_rng(11)
    num_blocks = b * mb + 1
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    shape = (2, hkv, num_blocks * bs, dh)
    kp = rng.standard_normal(shape).astype(np.float32)
    vp = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_blocks))[: b * mb].reshape(b, mb)
    bt = bt.astype(np.int32)
    lens = np.asarray([0, 1, 37, 520], np.int32)
    ks = vs = None
    if quant:
        from production_stack_tpu.ops.quantization import quantize_kv
        kp, ks = (np.asarray(a) for a in quantize_kv(jnp.asarray(kp)))
        vp, vs = (np.asarray(a) for a in quantize_kv(jnp.asarray(vp)))
    layer = 1
    jo, jm, jl = jpa.paged_flash_decode_stats_tp(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), layer, make_mesh(tp=tp), block_size=bs,
        interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    tk, tv, tks, tvs = kv_pools_from_jax(kp, vp, ks, vs)
    parts = []
    for r in range(tp):
        sl = slice(r * h // tp, (r + 1) * h // tp)
        sc = {} if not quant else dict(k_scale=shard_kv_pool(tks, r, tp),
                                       v_scale=shard_kv_pool(tvs, r, tp))
        parts.append(tpa.paged_flash_decode_stats_tp(
            _t(q)[:, sl].contiguous(), shard_kv_pool(tk, r, tp),
            shard_kv_pool(tv, r, tp), _t(bt), _t(lens), layer,
            block_size=bs, **sc))
    to, tm, tl = (torch.cat(x, dim=1).numpy() for x in zip(*parts))
    atol, rtol = (ATOL_INT8, 1e-6) if quant else (TOL, TOL)
    live = lens > 0
    np.testing.assert_allclose(to, np.asarray(jo), rtol=0 if quant else TOL,
                               atol=atol)
    np.testing.assert_allclose(tm[live], np.asarray(jm)[live], rtol=rtol, atol=atol)
    np.testing.assert_allclose(tl[live], np.asarray(jl)[live], rtol=rtol, atol=atol)
    assert np.all(to[0] == 0) and np.all(tl[0] == 0) and np.all(tm[0] == -np.inf)
    assert np.all(np.asarray(jm)[0] == -np.inf)
    with pytest.raises(ValueError, match="GQA groups"):
        tpa.paged_flash_decode_stats_tp(
            _t(q)[:, :3].contiguous(), shard_kv_pool(tk, 0, tp),
            shard_kv_pool(tv, 0, tp), _t(bt), _t(lens), layer, block_size=bs)


@pytest.mark.cuda
def test_cuda_tp_kernel_matches_plain_version_per_rank():
    """On the card: each rank's slice at llama-3-8b's per-rank heads at tp=2
    (H 16, Hkv 4, Dh 128) through the kernel against its plain version, with
    the kernel phase's tolerances; every call is one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    b, h, hkv, dh, bs, mb = 4, 32, 8, 128, 16, 40
    nb = b * mb + 1
    q = torch.from_numpy(rng.standard_normal((b, h, dh))).to(dev, torch.bfloat16)
    kp = torch.from_numpy(rng.standard_normal((2, hkv, nb * bs, dh))).to(dev, torch.bfloat16)
    vp = torch.from_numpy(rng.standard_normal((2, hkv, nb * bs, dh))).to(dev, torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(np.arange(1, nb))[:b * mb].reshape(b, mb)
                          .astype(np.int32)).to(dev)
    lens = torch.tensor([0, 1, 37, 620], dtype=torch.int32, device=dev)
    for r in range(2):
        ql = q[:, r * 16:(r + 1) * 16].contiguous()
        kl, vl = shard_kv_pool(kp, r, 2), shard_kv_pool(vp, r, 2)
        before = tpa.launch_counts()[tpa.BF16]
        out, m, l = tpa.paged_flash_decode_stats_tp(ql, kl, vl, bt, lens, 1,
                                                    block_size=bs)
        assert tpa.launch_counts()[tpa.BF16] == before + 1
        ro, rm, rl = tpa.paged_flash_decode_stats_ref(ql, kl, vl, bt, lens, 1,
                                                      block_size=bs)
        torch.testing.assert_close(out.float(), ro.float(), atol=2e-3, rtol=1e-2)
        torch.testing.assert_close(m[1:], rm[1:], rtol=1e-3, atol=1e-5)
        torch.testing.assert_close(l[1:], rl[1:], rtol=1e-3, atol=1e-5)


# ------------------------------------------------------------------ engines
_PROMPTS = ["hello world this is request 0 ", "x" * 150, "seeded prompt one ",
            "third"]
_SAMPLINGS = [{}, {}, dict(temperature=0.8, top_p=0.9, seed=1234),
              dict(temperature=1.0, top_k=50, seed=7)]
# (model, attn_impl, block_size, num_kv_blocks, kv_cache_dtype, tp): the
# paged cases take the setup of tests/test_paged_decode.py (tp=2 on
# tiny-llama-128dh, 64-token pages for the Pallas side), the window cases
# that of tests/test_parallel_parity.py (tiny-llama-8kv).
CASES = {
    "paged-tp2": ("tiny-llama-128dh", "paged", 64, 32, "bfloat16", 2),
    "paged-int8-tp2": ("tiny-llama-128dh", "paged", 64, 32, "int8", 2),
    "window-tp2": ("tiny-llama-8kv", "window", 16, 128, "bfloat16", 2),
    "window-tp4": ("tiny-llama-8kv", "window", 16, 128, "bfloat16", 4),
}


def _common(case):
    model, impl, bs, blocks, kv, _ = CASES[case]
    return dict(model=model, max_model_len=256, block_size=bs,
                num_kv_blocks=blocks, attn_impl=impl, num_decode_steps=8,
                dtype="float32", max_num_batched_tokens=64,
                kv_cache_dtype=kv)


async def _serve(engine, sampling_cls, max_tokens=12):
    async def one(p, extra):
        toks = None
        fields = dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True)
        fields.update(extra)
        async for out in engine.generate(prompt=p,
                                         sampling=sampling_cls(**fields)):
            toks = out.token_ids
        return toks

    await engine.start()
    try:
        return await asyncio.gather(*[one(p, s)
                                      for p, s in zip(_PROMPTS, _SAMPLINGS)])
    finally:
        await engine.stop()


_JAX_TOKENS = {}


async def _jax_tokens(model, common, tp=1):
    key = (tuple(sorted(common.items())), tp)
    if key not in _JAX_TOKENS:
        jparams = jax_init(jax_resolve(model), jax.random.PRNGKey(0), jnp.float32)
        eng = JaxEngine(JaxConfig(**common, tensor_parallel_size=tp,
                                  async_pipeline=False, overlap_dispatch=False),
                        params=jparams)
        _JAX_TOKENS[key] = await _serve(eng, JaxSampling)
    return _JAX_TOKENS[key]


def _check_reports(eng, tp):
    reports = eng.tp_reports
    assert [r["rank"] for r in reports] == list(range(tp))
    assert len({r["token_digest"] for r in reports}) == 1, reports
    assert len({r["dispatches"] for r in reports}) == 1, reports
    assert len({r["hbm_kv_bytes"] for r in reports}) == 1
    assert all(r["launch_counts"] == dict.fromkeys(tpa.VARIANTS, 0)
               for r in reports)                       # CPU: plain version
    assert all(eng.mesh.procs[i].returncode == 0 for i in range(tp - 1))


@pytest.mark.parametrize("case", list(CASES))
async def test_tp_engine_tokens_match_jax(case):
    """Greedy and seeded tokens of the port at tp > 1 equal the JAX
    engine's at tp = 1 on the same weights; every rank ends with the same
    token digest and dispatch count."""
    model, impl, _, blocks, kv, tp = CASES[case]
    common = _common(case)
    want = await _jax_tokens(model, common)
    jparams = jax_init(jax_resolve(model), jax.random.PRNGKey(0), jnp.float32)
    eng = ServingEngine(
        EngineConfig(**common, device="cpu", tensor_parallel_size=tp,
                     tp_timeout_s=120),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               resolve_model_config(model), torch.float32))
    try:
        assert eng.runner.attn_impl == impl
        assert eng.runner.kv_k.shape[1] == \
            resolve_model_config(model).num_kv_heads // tp
        st = eng.stats()
        got = await _serve(eng, SamplingParams)
    finally:
        eng.shutdown()
    assert got == want
    assert all(len(t) == 12 for t in got)
    assert (st["mesh_tp_size"], st["mesh_devices"], st["tp_backend"]) == (tp, tp, "gloo")
    per_rank = EngineConfig(**common, device="cpu").kv_cache_bytes_per_block(
        resolve_model_config(model)) * blocks // tp
    assert list(st["hbm_kv_bytes_per_device"].values()) == [per_rank] * tp
    assert st["kv_pool_bytes"] == per_rank * tp
    _check_reports(eng, tp)


async def test_tp2_matches_jax_tp2_paged():
    """One JAX engine at tp = 2 (its shard_mapped kernel, interpret mode)
    against the port at tp = 2, on the paged case."""
    model = CASES["paged-tp2"][0]
    common = _common("paged-tp2")
    want = await _jax_tokens(model, common, tp=2)
    assert want == await _jax_tokens(model, common)
    eng = ServingEngine(
        EngineConfig(**common, device="cpu", tensor_parallel_size=2,
                     tp_timeout_s=120),
        params=params_from_jax(jax.tree.map(np.asarray, jax_init(
            jax_resolve(model), jax.random.PRNGKey(0), jnp.float32)),
            resolve_model_config(model), torch.float32))
    try:
        got = await _serve(eng, SamplingParams)
    finally:
        eng.shutdown()
    assert got == want


async def test_tp2_from_seed_matches_tp1_from_seed():
    """The workers draw their own shards from the seed (no params handed
    over, the card's path): tokens equal the tp=1 engine's from the same
    seed."""
    cfg = dict(model="tiny-llama-8kv", device="cpu", dtype="float32",
               max_model_len=256, num_kv_blocks=64, num_decode_steps=8,
               seed=5, tp_timeout_s=120)
    base = ServingEngine(EngineConfig(**cfg))
    want = await _serve(base, SamplingParams)
    base.shutdown()
    eng = ServingEngine(EngineConfig(**cfg, tensor_parallel_size=2))
    try:
        got = await _serve(eng, SamplingParams)
    finally:
        eng.shutdown()
    assert got == want
    _check_reports(eng, 2)
    assert eng.stats()["decode_eager_dispatches_total"] == 0   # CPU: not counted


async def test_tp2_logprobs_match_tp1():
    """Logprobs at tp = 2 (the bucket rides each dispatch's descriptor;
    rank 0 returns its copy) equal tp = 1's within f32 rounding, with the
    same tokens; every rank runs the same dispatches."""
    cfg = dict(model="tiny-llama-8kv", device="cpu", dtype="float32",
               max_model_len=256, num_kv_blocks=64, num_decode_steps=4,
               seed=5, tp_timeout_s=120)
    samplings = [SamplingParams(max_tokens=9, temperature=0.0, ignore_eos=True,
                                logprobs=3),
                 SamplingParams(max_tokens=9, temperature=0.8, seed=2,
                                ignore_eos=True, logprobs=12)]

    async def serve(engine):
        async def one(p, sp):
            final = None
            async for out in engine.generate(prompt=p, sampling=sp):
                final = out
            return final

        await engine.start()
        try:
            return await asyncio.gather(*[one(p, sp) for p, sp in
                                          zip(_PROMPTS, samplings)])
        finally:
            await engine.stop()

    base = ServingEngine(EngineConfig(**cfg))
    want = await serve(base)
    base.shutdown()
    eng = ServingEngine(EngineConfig(**cfg, tensor_parallel_size=2))
    try:
        got = await serve(eng)
    finally:
        eng.shutdown()
    _check_reports(eng, 2)
    for g, w, sp in zip(got, want, samplings):
        assert g.token_ids == w.token_ids and len(g.logprobs) == 9
        for (gc, gt), (wc, wt) in zip(g.logprobs, w.logprobs):
            assert abs(gc - wc) <= 1e-4 and len(gt) == len(wt) == sp.logprobs
            assert max(abs(a[1] - b[1]) for a, b in zip(gt, wt)) <= 1e-4


# ------------------------------------------------------------ config errors
def test_tp_config_errors_name_the_flags():
    """The reference's refusals, named; a tp that divides no head count
    builds (the replication fallback): the pool holds every kv head on
    every rank, decode takes the window path, and ``shard_params`` keeps
    each leaf whose split dim tp does not divide whole."""
    with pytest.raises(ValueError, match=r"--kv-cache-dtype int8 with "
                                         r"--tensor-parallel-size 4.*2/2 heads"):
        EngineConfig(model="tiny-llama-128dh", kv_cache_dtype="int8",
                     tensor_parallel_size=4)
    with pytest.raises(ValueError, match=r"--tensor-parallel-size/--sequence-"
                                         r"parallel-size/--data-parallel-size "
                                         r"must all be >= 1"):
        EngineConfig(tensor_parallel_size=0)
    mc = resolve_model_config("tiny-llama-128dh")
    tp3 = EngineConfig(model="tiny-llama-128dh", device="cpu",
                       tensor_parallel_size=3)
    assert tp3.local_kv_heads(mc) == 2 and tp3.resolved_attn_impl(mc) == "window"
    assert tp3.kv_wire_bytes_per_token(mc) == tp3.kv_cache_bytes_per_token(mc)
    with pytest.raises(ValueError, match=r"attn_impl='paged' requires"):
        EngineConfig(model="tiny-llama-128dh", device="cpu", attn_impl="paged",
                     tensor_parallel_size=3).resolved_attn_impl(mc)
    full = llama.init_params(mc, torch.Generator().manual_seed(0),
                             torch.float32, torch.device("cpu"))
    sharded = shard_params(full, mc, 1, 4)
    assert sharded["layers"]["wq"].shape[-1] == mc.num_heads * mc.head_dim_ // 4
    assert torch.equal(shard_params(full, mc, 2, 3)["layers"]["wq"],
                       full["layers"]["wq"])
    cfg = EngineConfig(model="tiny-llama-128dh", device="cpu",
                       attn_impl="paged", tensor_parallel_size=2)
    assert cfg.resolved_attn_impl(mc) == "paged"
    assert cfg.local_kv_heads(mc) == 1
    llama8b = resolve_model_config("llama-3-8b")
    per_rank = EngineConfig(model="llama-3-8b", tensor_parallel_size=2)
    assert per_rank.kv_cache_bytes_per_token(llama8b) == 2 * 32 * 4 * 128 * 2
    args = parse_args(["--model", "llama-3-8b", "--tensor-parallel-size", "2"])
    assert args.tensor_parallel_size == 2


# -------------------------------------------------------------- lost ranks
async def test_lost_worker_fails_the_engine_within_the_timeout():
    """A worker that stops answering (SIGSTOP): the next dispatch's
    collective times out, the request raises within the timeout, the engine
    reports unhealthy and stops without hanging. A worker that dies
    (SIGKILL) is seen at once."""
    timeout = 8.0
    cfg = dict(model="tiny-llama-8kv", device="cpu", dtype="float32",
               max_model_len=128, num_kv_blocks=32, num_decode_steps=4,
               tensor_parallel_size=2, tp_timeout_s=timeout)

    async def one(eng):
        toks = None
        async for out in eng.generate(prompt="lost rank", sampling=SamplingParams(
                max_tokens=4, temperature=0.0, ignore_eos=True)):
            toks = out.token_ids
        return toks

    eng = ServingEngine(EngineConfig(**cfg))
    await eng.start()
    try:
        assert len(await one(eng)) == 4 and eng.is_healthy
        proc = eng.mesh.procs[0]
        os.kill(proc.pid, signal.SIGSTOP)
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="engine unavailable"):
            await asyncio.wait_for(one(eng), timeout + 30)
        assert time.monotonic() - t0 < timeout + 30
        assert not eng.is_healthy
        with pytest.raises(RuntimeError, match="engine unavailable"):
            await one(eng)
    finally:
        await asyncio.wait_for(eng.stop(), 30)
        eng.shutdown()
    assert proc.poll() is not None

    eng = ServingEngine(EngineConfig(**cfg))
    await eng.start()
    try:
        proc = eng.mesh.procs[0]
        proc.kill()
        proc.wait()
        assert not eng.is_healthy
        with pytest.raises(RuntimeError, match="exited"):
            await one(eng)
    finally:
        await asyncio.wait_for(eng.stop(), 30)
        eng.shutdown()


async def _serve_lora(engine, adapters):
    async def one(p, extra, ad):
        toks = None
        fields = dict(max_tokens=12, temperature=0.0, ignore_eos=True)
        fields.update(extra)
        async for out in engine.generate(prompt=p, lora_adapter=ad,
                                         sampling=SamplingParams(**fields)):
            toks = out.token_ids
        return toks

    await engine.start()
    try:
        return await asyncio.gather(*[
            one(p, s, ad) for p, s, ad in zip(_PROMPTS, _SAMPLINGS, adapters)])
    finally:
        await engine.stop()


async def test_tp2_checkpoint_and_adapters_match_tp1(tmp_path):
    """Every rank loads its shard of one checkpoint directory and its slice
    of two PEFT adapters (column-parallel targets split B's columns,
    row-parallel ones A's rows, their partial deltas all-reduced with the
    partial products): greedy and seeded tokens of a batch mixing the base
    model and both adapters, float32, equal the tp = 1 engine's on the same
    directories; the adapters move tokens."""
    from tests.test_torch_lora import ALL7, write_adapter

    mc = resolve_model_config("tiny-llama-8kv")
    d = str(tmp_path / "ckpt")
    chip_smoke.write_hf_checkpoint(
        torch, llama.init_params(mc, torch.Generator().manual_seed(2),
                                 torch.float32), mc, d)
    lora = {"a": write_adapter(tmp_path / "a", mc, 4, ("wq", "wv"), 1, alpha=8),
            "b": write_adapter(tmp_path / "b", mc, 8, ALL7, 2, alpha=16)}
    cfg = dict(model=d, device="cpu", dtype="float32", max_model_len=256,
               num_kv_blocks=64, num_decode_steps=8, tp_timeout_s=120,
               lora_modules=lora)
    mix = [None, "a", "b", "a"]
    base = ServingEngine(EngineConfig(**cfg))
    want = await _serve_lora(base, mix)
    plain = await _serve_lora(base, [None] * 4)
    base.shutdown()
    eng = ServingEngine(EngineConfig(**cfg, tensor_parallel_size=2))
    try:
        got = await _serve_lora(eng, mix)
    finally:
        eng.shutdown()
    assert got == want
    assert got[0] == plain[0] and all(got[i] != plain[i] for i in (1, 2, 3))
    _check_reports(eng, 2)
