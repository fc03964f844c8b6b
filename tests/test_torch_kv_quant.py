"""The PyTorch port's int8 KV cache against the JAX package's.

Inputs are made from numpy seeds and handed to both frameworks on the CPU.
Quantization and the dequantizing window gather are held bit for bit; the
paged decode over int8 pools (the port's plain version, the JAX package's
Pallas kernel in interpret mode) to 1e-5 in f32, where the two differ only
in summation order (the Pallas kernel accumulates over 512-token
superpages). Pallas comparisons use 64-token pages to keep interpret-mode
compile time down; the CUDA kernel is checked at block size 16 by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from paged_decode_model import chunk_plan, kernel_model
from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.ops import quantization as jquant
from production_stack_tpu.ops.pallas import paged_attention as jpa
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import kv_pools_from_jax
from production_stack_tpu_torch.ops import attention as tattn
from production_stack_tpu_torch.ops import paged_attention as tpa
from production_stack_tpu_torch.ops import quantization as tquant

PALLAS_BS = 64
ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _bits(x):
    """Raw bits of a torch or JAX array (bf16 compared as uint16)."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().view(np.uint16) if x.dtype == torch.int16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _kv_cases():
    """Normal draws plus the edge rows: all zero, an exact +-127 tie on
    the amax element, and elements exactly halfway between two levels
    (scale 0.5: x = (n + 0.5) / 2 rounds half to even)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6, 3, 64)).astype(np.float32) * 3.0
    x[0, 0] = 0.0
    x[0, 1, :] = 0.0
    x[0, 1, 5] = -2.5                                 # amax on a negative value
    halves = (np.arange(64) % 40 - 20 + 0.5) / 2.0    # n + 0.5 levels at scale 0.5
    halves[0] = 63.5                                  # amax = 127 * 0.5
    x[1, 0] = halves
    x[1, 1] = -halves
    x[1, 2] = np.float32(1e-30)                       # tiny scale
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_identical_to_jax(dtype):
    x = _kv_cases()
    jx = jnp.asarray(x).astype(dtype)
    tx = _t(x).to(getattr(torch, dtype))
    jq, js = jquant.quantize_kv(jx)
    tq, ts = tquant.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == tquant.SCALE_DTYPE
    np.testing.assert_array_equal(_bits(tq), _bits(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    assert np.all(tq.numpy()[0, 0] == 0) and ts[0, 0].item() == 0.0
    assert np.abs(tq.numpy()[1, 0]).max() == 127
    for out in ("float32", "bfloat16"):
        jd = jquant.dequantize_kv(jq, js, jnp.dtype(out))
        td = tquant.dequantize_kv(tq, ts, getattr(torch, out))
        np.testing.assert_array_equal(_bits(td), _bits(jd))


def _int8_pools(seed, n_layers, hkv, num_slots, dh):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n_layers, hkv, num_slots, dh)).astype(np.float32)
    v = rng.standard_normal((n_layers, hkv, num_slots, dh)).astype(np.float32)
    kq, ks = jquant.quantize_kv(jnp.asarray(k))
    vq, vs = jquant.quantize_kv(jnp.asarray(v))
    return tuple(np.asarray(a) for a in (kq, vq, ks, vs))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_int8_gather_window_is_bit_identical_to_jax(out_dtype):
    n_layers, hkv, dh, bs, nb = 2, 2, 16, 4, 10
    kq, vq, ks, vs = _int8_pools(1, n_layers, hkv, nb * bs, dh)
    bt = np.array([[3, 1, 7], [9, 2, 0]], np.int32)
    jk, jv = jattn.gather_window(
        jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt), bs,
        jnp.asarray(ks), jnp.asarray(vs), out_dtype=jnp.dtype(out_dtype))
    tk_, tv_, tks, tvs = kv_pools_from_jax(kq, vq, ks, vs)
    tk, tv = tattn.gather_window(tk_, tv_, _t(bt), bs, tks, tvs,
                                 out_dtype=getattr(torch, out_dtype))
    np.testing.assert_array_equal(_bits(tk), _bits(jk))
    np.testing.assert_array_equal(_bits(tv), _bits(jv))


def test_kv_pools_from_jax_keeps_the_bits():
    kq, vq, ks, vs = _int8_pools(2, 1, 2, 8, 16)
    a = kv_pools_from_jax(kq, vq, ks, vs)
    b = kv_pools_from_jax(kq, vq, ks.view(np.uint16), vs.view(np.uint16))
    for x, y, want in zip(a, b, (kq, vq, ks, vs)):
        np.testing.assert_array_equal(_bits(x), _bits(want))
        np.testing.assert_array_equal(_bits(y), _bits(want))
    assert a[2].dtype == torch.bfloat16 and a[0].dtype == torch.int8
    with pytest.raises(ValueError, match="both"):
        kv_pools_from_jax(kq, vq, ks, None)


def _case(seed, b, h, hkv, dh, kv_lens, n_layers=2, bs=PALLAS_BS, mb=10):
    rng = np.random.default_rng(seed)
    num_blocks = b * mb + 1
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kq, vq, ks, vs = _int8_pools(seed + 100, n_layers, hkv, num_blocks * bs, dh)
    bt = rng.permutation(np.arange(1, num_blocks))[: b * mb].reshape(b, mb)
    return q, kq, vq, ks, vs, bt.astype(np.int32), np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("dh", [64, 128])
def test_int8_paged_decode_matches_pallas_interpret(dh):
    b, hkv, g = 4, 2, 3
    h = hkv * g
    q, kq, vq, ks, vs, bt, lens = _case(dh, b, h, hkv, dh, [0, 1, 37, 520])
    layer = 1
    jo, jm, jl = jpa.paged_flash_decode_stats(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray([layer], jnp.int32), block_size=PALLAS_BS,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tk, tv, tks, tvs = kv_pools_from_jax(kq, vq, ks, vs)
    before = tpa.launch_counts()
    to, tm, tl = tpa.paged_flash_decode_stats(
        _t(q), tk, tv, _t(bt), _t(lens), layer, block_size=PALLAS_BS,
        k_scale=tks, v_scale=tvs)
    assert tpa.launch_counts() == before                      # CPU: plain version
    live = lens > 0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=ATOL)
    np.testing.assert_allclose(tm.numpy()[live], np.asarray(jm)[live],
                               rtol=1e-6, atol=ATOL)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=1e-6, atol=ATOL)
    assert np.all(to.numpy()[0] == 0) and np.all(tl.numpy()[0] == 0)
    assert np.all(tm.numpy()[0] == -np.inf)
    # The dense int8 reference of both packages, for the live rows.
    ref = jattn.paged_attention_xla(
        jnp.asarray(q)[:, None], jnp.asarray(kq[layer]), jnp.asarray(vq[layer]),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(lens - 1)[:, None],
        block_size=PALLAS_BS, k_scale=jnp.asarray(ks[layer]),
        v_scale=jnp.asarray(vs[layer]))
    tref = tattn.paged_attention_xla(
        _t(q)[:, None], tk[layer], tv[layer], _t(bt), _t(lens),
        _t(lens - 1)[:, None], block_size=PALLAS_BS, k_scale=tks[layer],
        v_scale=tvs[layer])
    np.testing.assert_allclose(tref.numpy()[live], np.asarray(ref)[live],
                               rtol=0, atol=ATOL)
    np.testing.assert_allclose(to.numpy()[live], np.asarray(ref)[live, 0],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("heads", ["llama-3b", "llama-1b"])
@pytest.mark.parametrize("chunk_tiles", [None, 1])
def test_int8_kernel_numerics_model_within_smoke_tolerance(heads, chunk_tiles):
    """The int8 kernel's arithmetic (``paged_decode_model.kernel_model``:
    int8 K/V exact in bf16, the K scale on the fp32 score, P times the V
    scale split into bf16 hi + lo, l over the unscaled weights, chunks
    merged as the kernel merges them) against the quantized Pallas kernel
    in interpret mode, at llama-3b and llama-1b head shapes: within
    chip_smoke.py's out/m/l tolerance, with NaN scales past kv_len."""
    h, hkv, dh = {"llama-3b": (24, 8, 128), "llama-1b": (32, 4, 64)}[heads]
    q, kq, vq, ks, vs, bt, lens = _case(dh + 3, 4, h, hkv, dh, [0, 1, 37, 520])
    q = q.astype(jnp.bfloat16).astype(np.float32)
    jo, jm, jl = jpa.paged_flash_decode_stats(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray([1], jnp.int32), block_size=PALLAS_BS,
        interpret=True, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    tk, tv, tks, tvs = kv_pools_from_jax(kq, vq, ks, vs)
    for i, n in enumerate(lens):      # stale scales past kv_len
        for p in range(n, bt.shape[1] * PALLAS_BS):
            slot = bt[i, p // PALLAS_BS] * PALLAS_BS + p % PALLAS_BS
            tks[:, :, slot] = float("nan")
            tvs[:, :, slot] = float("nan")
    mb_tokens = bt.shape[1] * PALLAS_BS
    if chunk_tiles is None:
        chunk_tiles, _ = tpa.launch_plan(4, hkv, mb_tokens, 132)
    assert len(chunk_plan(520, mb_tokens, PALLAS_BS, chunk_tiles)) > 1
    mo, mm, ml = kernel_model(
        _t(q).to(torch.bfloat16), tk, tv, _t(bt), _t(lens), 1,
        block_size=PALLAS_BS, chunk_tiles=chunk_tiles, k_scale=tks,
        v_scale=tvs)
    live = torch.from_numpy(lens > 0)
    _, row_rel, ok = chip_smoke.out_error(torch, mo, _t(jo), live)
    assert ok, row_rel
    for got, want in ((mm, jm), (ml, jl)):
        assert chip_smoke.stats_close(torch, got[live], _t(want)[live])
    assert torch.all(mo[0] == 0) and torch.all(mm[0] == -np.inf)
    assert torch.all(ml[0] == 0)


def test_int8_ref_ignores_poisoned_scales():
    """Scales past kv_len and in the block-table padding may hold any bf16
    of a freed block, NaN included; it must never reach the output."""
    b, h, hkv, dh, bs = 2, 4, 2, 64, 16
    q, kq, vq, ks, vs, bt, lens = _case(3, b, h, hkv, dh, [20, 5], bs=bs, mb=4)
    tk, tv, tks, tvs = kv_pools_from_jax(kq, vq, ks, vs)
    clean = tpa.paged_flash_decode_stats_ref(
        _t(q), tk, tv, _t(bt), _t(lens), 0, block_size=bs, k_scale=tks,
        v_scale=tvs)
    for i, n in enumerate(lens):
        for p in range(n, bt.shape[1] * bs):
            slot = bt[i, p // bs] * bs + p % bs
            tks[:, :, slot] = float("nan")
            tvs[:, :, slot] = float("nan")
            tk[:, :, slot] = 127
            tv[:, :, slot] = -127
    dirty = tpa.paged_flash_decode_stats_ref(
        _t(q), tk, tv, _t(bt), _t(lens), 0, block_size=bs, k_scale=tks,
        v_scale=tvs)
    for a, c in zip(clean, dirty):
        np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
def test_paged_attention_wrappers_match_jax(quant):
    """``paged_attention_decode`` and the by-shape dispatch
    ``paged_attention`` (T == 1 to the decode wrapper, T > 1 to the dense
    reference) against their JAX counterparts."""
    b, hkv, g, dh = 3, 2, 2, 64
    h = hkv * g
    q, kq, vq, ks, vs, bt, lens = _case(7, b, h, hkv, dh, [5, 130, 64])
    if quant:
        jk, jv, jks, jvs = (jnp.asarray(a[0]) for a in (kq, vq, ks, vs))
        tk, tv, tks, tvs = (t[0] for t in kv_pools_from_jax(kq, vq, ks, vs))
    else:
        rng = np.random.default_rng(8)
        kf = rng.standard_normal(kq.shape[1:]).astype(np.float32)
        vf = rng.standard_normal(kq.shape[1:]).astype(np.float32)
        jk, jv, jks, jvs = jnp.asarray(kf), jnp.asarray(vf), None, None
        tk, tv, tks, tvs = _t(kf), _t(vf), None, None
    q4 = q[:, None]
    want = jpa.paged_attention_decode_pallas(
        jnp.asarray(q4), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        block_size=PALLAS_BS, interpret=True, k_scale=jks, v_scale=jvs)
    got = tpa.paged_attention_decode(
        _t(q4), tk, tv, _t(bt), _t(lens), block_size=PALLAS_BS, k_scale=tks,
        v_scale=tvs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    disp = tpa.paged_attention(
        _t(q4), tk, tv, _t(bt), _t(lens), _t(lens - 1)[:, None],
        block_size=PALLAS_BS, k_scale=tks, v_scale=tvs)
    np.testing.assert_array_equal(disp.numpy(), got.numpy())
    # A 3-token chunk takes the dense path in both packages.
    rng = np.random.default_rng(9)
    q3 = rng.standard_normal((b, 3, h, dh)).astype(np.float32)
    pos3 = (lens[:, None] - 3 + np.arange(3)[None, :]).astype(np.int32)
    want3 = jpa.paged_attention_pallas(
        jnp.asarray(q3), jk, jv, jnp.asarray(bt), jnp.asarray(lens),
        jnp.asarray(pos3), block_size=PALLAS_BS, interpret=True,
        k_scale=jks, v_scale=jvs)
    got3 = tpa.paged_attention(
        _t(q3), tk, tv, _t(bt), _t(lens), _t(pos3), block_size=PALLAS_BS,
        k_scale=tks, v_scale=tvs)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="T=1"):
        tpa.paged_attention_decode(_t(q3), tk, tv, _t(bt), _t(lens),
                                   block_size=PALLAS_BS)


def test_int8_pool_holds_1_9x_the_blocks_of_bf16():
    """Same memory budget, same model: the int8 pool (payload + scales)
    derives 2*Dh/(Dh+2) = 1.97x the blocks at Dh = 128; the prefill window
    reservation stays in compute-dtype bytes."""
    mc = resolve_model_config("tiny-llama-128dh")
    blocks, stats = {}, {}
    for kv in ("bfloat16", "int8"):
        eng = ServingEngine(EngineConfig(
            model="tiny-llama-128dh", device="cpu", dtype="bfloat16",
            kv_cache_dtype=kv, attn_impl="paged", max_model_len=4096,
            hbm_utilization=0.02))
        blocks[kv] = eng.runner.num_kv_blocks
        stats[kv] = eng.stats()
        eng.shutdown()
    assert blocks["int8"] >= 1.9 * blocks["bfloat16"]
    assert stats["int8"]["kv_cache_dtype"] == "int8"
    per_tok = 2 * mc.num_layers * mc.num_kv_heads
    assert stats["int8"]["kv_pool_bytes"] == blocks["int8"] * 16 * per_tok * 130
    assert stats["bfloat16"]["kv_pool_bytes"] == \
        blocks["bfloat16"] * 16 * per_tok * 256
    assert stats["int8"]["kv_quant_bytes_saved_total"] == 0


def test_unknown_kv_cache_dtype_raises():
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        EngineConfig(kv_cache_dtype="fp8")
    assert EngineConfig(kv_cache_dtype="int8").kv_cache_quantized
    assert not EngineConfig().kv_cache_quantized
    llama3b = resolve_model_config("llama-3b")
    cfg = EngineConfig(kv_cache_dtype="int8")
    assert cfg.kv_cache_bytes_per_token(llama3b) == 2 * 28 * 8 * (128 + 2)
    assert cfg.resolved_attn_impl(llama3b) == "paged"


@pytest.mark.cuda
def test_cuda_int8_kernel_matches_plain_version():
    """On the card: the int8 variant against its plain version, with NaN
    scales past kv_len. Tolerances as the bf16 kernel's (one bf16 rounding
    of out; m, l in fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    q, kq, vq, ks, vs, bt, lens = _case(5, 4, 24, 8, 128, [0, 1, 37, 520], bs=16)
    pools = [t.to(dev) for t in kv_pools_from_jax(kq, vq, ks, vs)]
    for i, n in enumerate(lens):
        for p in range(n, bt.shape[1] * 16):
            slot = bt[i, p // 16] * 16 + p % 16
            pools[2][:, :, slot] = float("nan")
            pools[3][:, :, slot] = float("nan")
    qt = _t(q).to(dev, torch.bfloat16)
    bt_t, lens_t = _t(bt).to(dev), _t(lens).to(dev)
    before = tpa.launch_counts()[tpa.INT8]
    out, m, l = tpa.paged_flash_decode_stats(
        qt, pools[0], pools[1], bt_t, lens_t, 1, block_size=16,
        k_scale=pools[2], v_scale=pools[3])
    ro, rm, rl = tpa.paged_flash_decode_stats_ref(
        qt, pools[0], pools[1], bt_t, lens_t, 1, block_size=16,
        k_scale=pools[2], v_scale=pools[3])
    assert tpa.launch_counts()[tpa.INT8] == before + 1
    torch.testing.assert_close(out.float(), ro.float(), atol=2e-3, rtol=1e-2)
    torch.testing.assert_close(m[1:], rm[1:], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(l[1:], rl[1:], rtol=1e-3, atol=1e-5)
