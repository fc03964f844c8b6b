"""The paged-decode kernels' domain against the Pallas kernel's.

The port's gate (``supports_paged_decode``) is the Pallas kernel's
(``supports_pallas_decode``) for every compute dtype and pool kind, and the
port's engine refuses ``attn_impl="paged"`` exactly where the JAX engine
does. Inside that domain the plain version (the wrappers' CPU path) holds
the Pallas kernel in interpret mode at the shapes past the served one (head
dims 32 and 256, 24 and 32 query heads per kv head), over bf16 and int8
pools, and the JAX XLA path at block size 1 (interpret mode would unroll
512 page DMAs per superpage). Inputs come from numpy seeds; everything
computes in f32 on the CPU, so the two sides differ only in summation
order: tolerance 2e-4, as in ``test_torch_ops.py``. The tensor-core
kernel's own arithmetic at those shapes (``tests/paged_decode_model.py``)
is held to the Pallas kernel within the smoke's tolerances of q's dtype.
Pallas comparisons use 64-token pages (interpret-mode compile time grows
with pages per superpage). Engines of both packages serve the same f32
weights with ``attn_impl="paged"``; their greedy tokens must be equal.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.ops import quantization as jquant
from production_stack_tpu.ops.pallas import paged_attention as jpa
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import kv_pools_from_jax, params_from_jax
from production_stack_tpu_torch.ops import paged_attention as tpa

TOL = 2e-4
PALLAS_BS = 64
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
HEAD_DIMS = (1, 2, 8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512)
BLOCK_SIZES = (1, 2, 3, 4, 12, 16, 64, 512, 1024)
GROUPS = (1, 7, 16, 17, 24, 32, 64)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("head_dim", HEAD_DIMS)
def test_gate_equals_the_pallas_gate(head_dim):
    """Case for case over block sizes, query heads per kv head, compute
    dtypes and pool kinds: the port admits exactly what the Pallas gate
    admits, and every admitted case maps to exactly one variant whose kernel
    takes it: the tensor-core kernel for bf16 and f16 q at Dh 32, 64, 128
    and 256 at any G (head groups of 16) and block size (4-tile chunks at
    one-token pages, so a block's page list holds them; Dh 256 as two
    column blocks), the generic kernel for the rest (float32; bf16 and f16
    at Dh 1-16 and above 256), its q and acc within its shared memory."""
    for bs in BLOCK_SIZES:
        want = jpa.supports_pallas_decode(head_dim, bs)
        assert tpa.supports_paged_decode(head_dim, bs) == want, (head_dim, bs)
        if not want:
            continue
        for g in GROUPS:
            for dtype in DTYPES:
                for quant in (False, True):
                    variant = tpa.variant_of(dtype, quant, head_dim, g, bs)
                    mma = tpa.uses_mma(dtype, head_dim)
                    assert mma == (dtype in (torch.bfloat16, torch.float16)
                                   and head_dim in (32, 64, 128, 256))
                    takers = [v for v in tpa.VARIANTS if v == variant]
                    assert len(takers) == 1
                    hb = tpa.heads_per_block(dtype, head_dim, g, bs)
                    cap = tpa.chunk_tiles_cap(dtype, head_dim, bs)
                    if mma:
                        assert variant == tpa.MMA[(dtype, quant)]
                        assert hb == min(g, 16)
                        assert tpa.column_blocks(dtype, head_dim) == \
                            (2 if head_dim == 256 else 1)
                        assert cap * tpa.TILE_TOKENS // bs + 1 <= tpa.MMA_PAGE_LIST
                    else:
                        assert variant == tpa.GENERIC[(dtype, quant)]
                        assert 1 <= hb <= min(g, tpa.GENERIC_HEADS)
                        assert 8 * hb * head_dim <= tpa.GENERIC_SMEM_BUDGET
                        assert tpa.column_blocks(dtype, head_dim) == 1
                        assert cap == tpa.MAX_CHUNK_TILES


_MODELS = ("tiny-llama", "tiny-llama-128dh", "llama-1b", "llama-3b")


@pytest.mark.parametrize("model", _MODELS)
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_paged_refusals_equal_the_jax_engine(model, dtype):
    """``attn_impl="paged"`` on ``device="cuda"`` configs (no card needed:
    resolving reads no device) raises in the port exactly where the JAX
    engine's ``resolved_attn_impl`` raises, over tp 1 / 2 / 3, block sizes
    1 and 16, speculation on and off."""
    mc_port, mc_jax = resolve_model_config(model), jax_resolve(model)
    seen = set()
    for tp in (1, 2, 3):
        for bs in (1, 16):
            for spec in (False, True):
                fields = dict(model=model, dtype=dtype, attn_impl="paged",
                              tensor_parallel_size=tp, block_size=bs)
                if spec:
                    fields.update(speculative_num_tokens=3,
                                  speculative_model=model)
                got, want = [], []
                for cls, mc, extra, out in (
                        (EngineConfig, mc_port, {"device": "cuda"}, got),
                        (JaxConfig, mc_jax, {}, want)):
                    try:
                        out.append(cls(**fields, **extra).resolved_attn_impl(mc))
                    except ValueError:
                        out.append("raises")
                assert got == want, (model, dtype, tp, bs, spec, got, want)
                seen.add(got[0])
    assert seen <= {"paged", "raises"}


def _case(seed, b, h, hkv, dh, kv_lens, bs=PALLAS_BS, mb=10, quant=False):
    """q (f32), pools (bf16 values; int8 with bf16 scales), block tables
    and lengths, as numpy arrays for both frameworks."""
    rng = np.random.default_rng(seed)
    num_blocks = b * mb + 1
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    shape = (2, hkv, num_blocks * bs, dh)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_blocks))[: b * mb].reshape(b, mb)
    if quant:
        kq, ks = jquant.quantize_kv(jnp.asarray(k))
        vq, vs = jquant.quantize_kv(jnp.asarray(v))
        pools = tuple(np.asarray(a) for a in (kq, vq, ks, vs))
    else:
        pools = (np.asarray(jnp.asarray(k, jnp.bfloat16)),
                 np.asarray(jnp.asarray(v, jnp.bfloat16)), None, None)
    return q, pools, bt.astype(np.int32), np.asarray(kv_lens, np.int32)


def _port_pools(pools):
    k, v, ks, vs = pools
    if ks is not None:
        return kv_pools_from_jax(k, v, ks, vs)
    bf = [_t(np.asarray(x).view(np.uint16).view(np.int16)).view(torch.bfloat16)
          for x in (k, v)]
    return bf[0], bf[1], None, None


def _jax_pools(pools):
    return [None if x is None else jnp.asarray(x) for x in pools]


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv,dh", [(4, 2, 32), (12, 4, 256), (24, 1, 128),
                                      (32, 1, 64)],
                         ids=["dh32", "dh256", "g24", "g32"])
def test_plain_version_matches_pallas_interpret(h, hkv, dh, quant):
    """The plain version against the Pallas kernel in interpret mode, f32
    q over bf16 or int8 pools, at head dims 32 and 256 and 24 and 32 query
    heads per kv head: out, m and l within 2e-4; an empty row is (0, -inf,
    0) in both."""
    q, pools, bt, lens = _case(dh + h, 4, h, hkv, dh, [0, 1, 37, 520],
                               quant=quant)
    jk, jv, jks, jvs = _jax_pools(pools)
    jo, jm, jl = jpa.paged_flash_decode_stats(
        jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        jnp.asarray([1], jnp.int32), block_size=PALLAS_BS, interpret=True,
        k_scale=jks, v_scale=jvs)
    tk, tv, tks, tvs = _port_pools(pools)
    before = tpa.launch_counts()
    to, tm, tl = tpa.paged_flash_decode_stats(
        _t(q), tk, tv, _t(bt), _t(lens), 1, block_size=PALLAS_BS,
        k_scale=tks, v_scale=tvs)
    assert tpa.launch_counts() == before                      # CPU: plain version
    live = lens > 0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.numpy()[live], np.asarray(jm)[live],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=TOL, atol=TOL)
    assert np.all(to.numpy()[0] == 0) and np.all(tl.numpy()[0] == 0)
    assert np.all(tm.numpy()[0] == -np.inf)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("h,hkv,dh", [(24, 8, 128), (12, 4, 256)],
                         ids=["dh128", "dh256"])
def test_plain_version_at_block_size_1_matches_xla(h, hkv, dh, quant):
    """Block size 1 (one-token pages; the Pallas gate admits it at
    Dh >= 128): the plain version's out against the JAX package's XLA
    paged path on the same pages, within 2e-4."""
    q, pools, bt, lens = _case(dh + 1, 4, h, hkv, dh, [1, 5, 64, 200], bs=1,
                               mb=256, quant=quant)
    jk, jv, jks, jvs = _jax_pools(pools)
    tk, tv, tks, tvs = _port_pools(pools)
    for layer in (0, 1):
        ref = jattn.paged_attention_xla(
            jnp.asarray(q)[:, None], jk[layer], jv[layer], jnp.asarray(bt),
            jnp.asarray(lens), jnp.asarray(lens - 1)[:, None], block_size=1,
            k_scale=None if jks is None else jks[layer],
            v_scale=None if jvs is None else jvs[layer])
        to, _, _ = tpa.paged_flash_decode_stats(
            _t(q), tk, tv, _t(bt), _t(lens), layer, block_size=1,
            k_scale=tks, v_scale=tvs)
        np.testing.assert_allclose(to.numpy(), np.asarray(ref)[:, 0],
                                   rtol=TOL, atol=TOL)


_MODEL_SHAPES = {"dh32": (4, 2, 32), "dh256": (12, 4, 256), "g24": (24, 1, 128),
                 "g32": (32, 1, 64), "llama-3b": (24, 8, 128)}


@pytest.mark.parametrize("quant", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "f16"])
@pytest.mark.parametrize("shape,bs", [("dh32", PALLAS_BS), ("dh256", PALLAS_BS),
                                      ("g24", PALLAS_BS), ("g32", PALLAS_BS),
                                      ("llama-3b", 1), ("dh256", 1)],
                         ids=["dh32", "dh256", "g24", "g32", "bs1", "bs1-dh256"])
def test_kernel_numerics_model_matches_pallas(shape, bs, dtype, quant):
    """The tensor-core kernel's arithmetic at the half-precision shapes past
    the served one (``paged_decode_model.kernel_model``: q unscaled in
    bf16 or f16, P = hi + lo in q's dtype over compute-dtype pools and in
    bf16 over int8 pools, head groups of 16 at G 24 / 32, two column blocks
    at Dh 256, 4-tile chunks at one-token pages) against the Pallas kernel
    in interpret mode on the same values: out within ``chip_smoke.OUT_TOLS``
    of q's dtype, m and l within the stats tolerances. Block size 1 runs on
    the 64-token case's pool, each page split into 64 one-token pages (the
    Pallas side at block size 64: interpret mode would unroll 512 page DMAs
    per superpage)."""
    import chip_smoke
    from paged_decode_model import chunk_plan, kernel_model

    h, hkv, dh = _MODEL_SHAPES[shape]
    q, pools, bt, lens = _case(dh + h, 4, h, hkv, dh, [0, 1, 37, 520], quant=quant)
    q = torch.from_numpy(q).to(dtype)
    k, v, ks, vs = pools
    if quant:
        tk, tv, tks, tvs = kv_pools_from_jax(k, v, ks, vs)
        jk, jv, jks, jvs = _jax_pools(pools)
    else:
        tk, tv = (_t(np.asarray(x, np.float32)).to(dtype) for x in (k, v))
        jk, jv = (jnp.asarray(x.float().numpy()) for x in (tk, tv))
        tks = tvs = jks = jvs = None
    jo, jm, jl = jpa.paged_flash_decode_stats(
        jnp.asarray(q.float().numpy()), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        jnp.asarray([1], jnp.int32), block_size=PALLAS_BS, interpret=True,
        k_scale=jks, v_scale=jvs)
    if bs == 1:
        bt = (bt[:, :, None] * PALLAS_BS + np.arange(PALLAS_BS)).reshape(4, -1)
    hb = tpa.heads_per_block(dtype, dh, h // hkv, bs)
    chunk_tiles, _ = tpa.launch_plan(
        4, hkv, bt.shape[1] * bs, 132,
        -(-(h // hkv) // hb) * tpa.column_blocks(dtype, dh),
        tpa.chunk_tiles_cap(dtype, dh, bs))
    assert len(chunk_plan(520, bt.shape[1] * bs, bs, chunk_tiles)) > 1
    mo, mm, ml = kernel_model(q, tk, tv, _t(bt.astype(np.int32)), _t(lens), 1,
                              block_size=bs, chunk_tiles=chunk_tiles,
                              k_scale=tks, v_scale=tvs)
    assert mo.dtype == dtype
    live = torch.from_numpy(lens > 0)
    _, row_rel, ok = chip_smoke.out_error(torch, mo, _t(jo), live)
    assert ok, row_rel
    for got, want in ((mm, jm), (ml, jl)):
        assert chip_smoke.stats_close(torch, got[live], _t(want)[live])
    assert torch.all(mo[0] == 0) and torch.all(mm[0] == -np.inf)
    assert torch.all(ml[0] == 0)


async def _serve(engine, sampling_cls, prompts, max_tokens):
    await engine.start()

    async def one(p):
        toks = None
        async for out in engine.generate(
                prompt=p, sampling=sampling_cls(max_tokens=max_tokens,
                                                temperature=0.0,
                                                ignore_eos=True)):
            toks = out.token_ids
        return toks

    try:
        return await asyncio.gather(*[one(p) for p in prompts])
    finally:
        await engine.stop()


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-llama-128dh"])
def test_paged_engine_tokens_equal_jax(model):
    """A port engine with ``attn_impl="paged"`` (its decode through the
    plain version) and a JAX engine with ``attn_impl="paged"`` (the Pallas
    kernel in interpret mode) on the same float32 weights: greedy tokens
    equal. tiny-llama's head dim is 32 (four tokens per 128-lane row in the
    Pallas kernel)."""
    common = dict(model=model, max_model_len=256, block_size=PALLAS_BS,
                  num_kv_blocks=32, attn_impl="paged", num_decode_steps=8,
                  dtype="float32", max_num_batched_tokens=64,
                  async_pipeline=False, overlap_dispatch=False)
    jparams = jax_init(jax_resolve(model), jax.random.PRNGKey(0), jnp.float32)
    jeng = JaxEngine(JaxConfig(**common), params=jparams)
    eng = ServingEngine(
        EngineConfig(**common, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, jparams),
                               resolve_model_config(model), torch.float32))
    assert jeng.runner.attn_impl == "paged" and eng.runner.attn_impl == "paged"
    prompts = ["hello world this is request 0 ", "x" * 150]
    want = asyncio.run(_serve(jeng, JaxSampling, prompts, 12))
    got = asyncio.run(_serve(eng, SamplingParams, prompts, 12))
    eng.shutdown()
    assert got == want
    assert all(len(t) == 12 for t in got)
