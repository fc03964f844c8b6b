"""The PyTorch port's attention ops against the JAX package's.

Inputs are made from numpy seeds and handed to both frameworks; everything
runs in float32 on the CPU, where the port's ops (and the paged-decode
wrapper, through its plain version) are ordinary tensor code. The Pallas
kernel runs in interpret mode, as tests/test_pallas_kernel.py runs it.
Tolerance 2e-4: both sides compute in f32 and differ only in summation order
(the Pallas kernel accumulates over 512-token superpages, the port over the
whole row). The Pallas comparisons use 64-token pages: interpret mode
unrolls one DMA per page of a superpage, and its compile time grows with
that count (the CUDA kernel is checked at block size 16 by chip_smoke.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import chip_smoke
from paged_decode_model import chunk_plan, kernel_model

from production_stack_tpu.ops import attention as jattn
from production_stack_tpu.ops.pallas.paged_attention import (
    paged_flash_decode_stats as jax_paged_stats,
    supports_pallas_decode,
)
from production_stack_tpu_torch.ops import attention as tattn
from production_stack_tpu_torch.ops import paged_attention as tpa

TOL = 2e-4


def _t(x):
    return torch.from_numpy(np.asarray(x))


PALLAS_BS = 64


def _pool_case(seed, b, h, hkv, dh, kv_lens, n_layers=2, bs=PALLAS_BS, mb=10):
    rng = np.random.default_rng(seed)
    num_blocks = b * mb + 1
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((n_layers, hkv, num_blocks * bs, dh)).astype(np.float32)
    vp = rng.standard_normal((n_layers, hkv, num_blocks * bs, dh)).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_blocks))[: b * mb].reshape(b, mb)
    return q, kp, vp, bt.astype(np.int32), np.asarray(kv_lens, np.int32)


@pytest.mark.parametrize("dh", [64, 128])
def test_paged_decode_matches_pallas_interpret_and_xla(dh):
    b, hkv, g, bs = 4, 2, 3, PALLAS_BS
    h = hkv * g
    q, kp, vp, bt, lens = _pool_case(dh, b, h, hkv, dh, [0, 1, 37, 520])
    layer = 1
    jo, jm, jl = jax_paged_stats(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray([layer], jnp.int32),
        block_size=bs, interpret=True,
    )
    before = tpa.launch_counts()
    to, tm, tl = tpa.paged_flash_decode_stats(
        _t(q), _t(kp), _t(vp), _t(bt), _t(lens), layer, block_size=bs)
    assert tpa.launch_counts() == before                      # CPU: plain version
    live = lens > 0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.numpy()[live], np.asarray(jm)[live],
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               rtol=TOL, atol=TOL)
    # kv_len == 0 is exactly (0, -inf, 0) in both.
    assert np.all(to.numpy()[0] == 0) and np.all(tl.numpy()[0] == 0)
    assert np.all(tm.numpy()[0] == -np.inf)
    assert np.all(np.asarray(jm)[0] == -np.inf)
    # Against the dense reference for the live rows (the kv_len == 0 row's
    # softmax over an all-masked row is not defined there).
    ref = jattn.paged_attention_xla(
        jnp.asarray(q)[:, None], jnp.asarray(kp[layer]), jnp.asarray(vp[layer]),
        jnp.asarray(bt), jnp.asarray(lens), jnp.asarray(lens - 1)[:, None],
        block_size=bs,
    )
    np.testing.assert_allclose(to.numpy()[live], np.asarray(ref)[live, 0],
                               rtol=TOL, atol=TOL)
    tref = tattn.paged_attention_xla(
        _t(q)[:, None], _t(kp[layer]), _t(vp[layer]), _t(bt), _t(lens),
        _t(lens - 1)[:, None], block_size=bs)
    np.testing.assert_allclose(tref.numpy()[live], np.asarray(ref)[live],
                               rtol=TOL, atol=TOL)


def test_paged_decode_ref_ignores_poisoned_slots():
    """Slots past kv_len and the block-table padding may hold stale data of
    freed blocks; NaN there must never reach the output (0 * NaN)."""
    b, h, hkv, dh, bs = 2, 4, 2, 64, 16
    q, kp, vp, bt, lens = _pool_case(3, b, h, hkv, dh, [20, 5], bs=bs, mb=4)
    clean = tpa.paged_flash_decode_stats_ref(
        _t(q), _t(kp), _t(vp), _t(bt), _t(lens), 0, block_size=bs)
    for i, n in enumerate(lens):
        for p in range(n, bt.shape[1] * bs):
            slot = bt[i, p // bs] * bs + p % bs
            kp[:, :, slot] = np.nan
            vp[:, :, slot] = np.nan
    dirty = tpa.paged_flash_decode_stats_ref(
        _t(q), _t(kp), _t(vp), _t(bt), _t(lens), 0, block_size=bs)
    for a, c in zip(clean, dirty):
        np.testing.assert_array_equal(a.numpy(), c.numpy())


@pytest.mark.parametrize("head_dim,block_size,admitted", [
    (128, 16, True), (64, 16, True), (32, 16, True), (256, 16, True),
    (96, 16, False), (48, 16, False), (192, 16, False),
    (128, 2, True), (64, 512, True), (128, 1, True), (512, 1, True),
    (64, 1, False), (32, 2, False), (1, 128, True), (1, 64, False),
    (128, 12, False), (128, 24, False), (128, 1024, False),
])
def test_supports_paged_decode_gate(head_dim, block_size, admitted):
    """The Pallas kernel's gate: a head dim dividing 128 or a multiple of
    it, a block size dividing the 512-token superpage and divisible by the
    pack factor 128 // Dh. No dtype and no query-group limit enters: the
    generic kernel takes what the tensor-core kernel does not."""
    assert tpa.supports_paged_decode(head_dim, block_size) == admitted
    assert supports_pallas_decode(head_dim, block_size) == admitted


_LEN = st.one_of(st.sampled_from([0, 1, 15, 16, 63, 64, 4095, 4096, 5000]),
                 st.integers(0, 4096))


@settings(max_examples=200, deadline=None)
@given(lens=st.lists(_LEN, min_size=1, max_size=64),
       block_size=st.sampled_from([1, 2, 16, 64, 512]),
       hkv=st.sampled_from([1, 4, 8]),
       g=st.sampled_from([1, 3, 16, 17, 24, 64]),
       dtype=st.sampled_from([torch.bfloat16, torch.float32]),
       head_dim=st.sampled_from([128, 256]))
def test_split_plan_covers_every_tile_once(lens, block_size, hkv, g, dtype,
                                            head_dim):
    """The device-side work split (``chunk_plan``, under the host's
    ``launch_plan``, with the head groups and column blocks of the kernel
    that takes the shape: the tensor-core kernel's groups of 16 heads and
    two column blocks at Dh 256, the generic kernel's groups of 8): every
    (row, 64-token tile) lies in exactly one chunk of at most chunk_tiles
    tiles, within the grid's max_chunks; no chunk reaches past kv_len
    (clamped to the block table) or reads a block-table entry at or past
    cdiv(kv_len, block_size), and a chunk's entries fit its block's page
    list (257 on the tensor-core kernel: one-token pages take 4-tile
    chunks); a zero-length row has no chunk."""
    max_tokens = 4096                      # Mb * block_size of the tables
    mma = tpa.uses_mma(dtype, head_dim)
    hb = tpa.heads_per_block(dtype, head_dim, g, block_size)
    assert hb == min(g, 16 if mma else 8)
    columns = tpa.column_blocks(dtype, head_dim)
    assert columns == (2 if mma and head_dim == 256 else 1)
    cap = tpa.chunk_tiles_cap(dtype, head_dim, block_size)
    chunk_tiles, max_chunks = tpa.launch_plan(len(lens), hkv, max_tokens, 132,
                                              -(-g // hb) * columns, cap)
    assert 1 <= chunk_tiles <= cap <= tpa.MAX_CHUNK_TILES
    assert max_chunks * chunk_tiles * tpa.TILE_TOKENS >= max_tokens
    pages_max = chunk_tiles * tpa.TILE_TOKENS // block_size + 1
    assert pages_max <= (tpa.MMA_PAGE_LIST if mma else
                         tpa.MAX_CHUNK_TILES * tpa.TILE_TOKENS + 1)
    for n in lens:
        kv_len = min(n, max_tokens)
        plan = chunk_plan(n, max_tokens, block_size, chunk_tiles)
        assert len(plan) <= max_chunks
        covered = []
        for c, begin, end, page0, n_pages in plan:
            assert 0 <= begin < end <= kv_len
            assert end - begin <= chunk_tiles * tpa.TILE_TOKENS
            assert begin == c * chunk_tiles * tpa.TILE_TOKENS
            covered += range(begin // tpa.TILE_TOKENS,
                             -(-end // tpa.TILE_TOKENS))
            assert page0 == begin // block_size
            assert page0 + n_pages <= -(-kv_len // block_size)
            assert page0 + n_pages == -(-end // block_size)  # every page in use
            assert n_pages <= pages_max
        assert covered == list(range(-(-kv_len // tpa.TILE_TOKENS)))
        assert (plan == []) == (kv_len == 0)


def _bf16_values(x):
    return x.astype(jnp.bfloat16).astype(np.float32)


@pytest.mark.parametrize("heads", ["llama-3b", "llama-1b"])
@pytest.mark.parametrize("chunk_tiles", [None, 1])
def test_kernel_numerics_model_within_smoke_tolerance(heads, chunk_tiles):
    """The kernel's arithmetic (``paged_decode_model.kernel_model``: bf16 q
    unscaled, fp32 scores, per-warp online softmax, P = hi + lo in bf16,
    chunk partials merged as the kernel merges them) against the Pallas
    kernel in interpret mode on the same bf16 values, at llama-3b (H=24,
    Hkv=8, Dh=128) and llama-1b (H=32, Hkv=4, Dh=64) head shapes: within
    chip_smoke.py's out/m/l tolerance, with the row of 520 tokens split
    into the launch plan's chunks or into one chunk per tile."""
    h, hkv, dh = {"llama-3b": (24, 8, 128), "llama-1b": (32, 4, 64)}[heads]
    q, kp, vp, bt, lens = _pool_case(dh + 1, 4, h, hkv, dh, [0, 1, 37, 520])
    q, kp, vp = (_bf16_values(x) for x in (q, kp, vp))
    jo, jm, jl = jax_paged_stats(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
        jnp.asarray(lens), jnp.asarray([1], jnp.int32), block_size=PALLAS_BS,
        interpret=True)
    if chunk_tiles is None:
        chunk_tiles, _ = tpa.launch_plan(4, hkv, bt.shape[1] * PALLAS_BS, 132)
    assert len(chunk_plan(520, bt.shape[1] * PALLAS_BS, PALLAS_BS,
                              chunk_tiles)) > 1
    mo, mm, ml = kernel_model(
        _t(q).to(torch.bfloat16), _t(kp).to(torch.bfloat16),
        _t(vp).to(torch.bfloat16), _t(bt), _t(lens), 1, block_size=PALLAS_BS,
        chunk_tiles=chunk_tiles)
    live = torch.from_numpy(lens > 0)
    _, row_rel, ok = chip_smoke.out_error(torch, mo, _t(jo), live)
    assert ok, row_rel
    for got, want in ((mm, jm), (ml, jl)):
        assert chip_smoke.stats_close(torch, got[live], _t(want)[live])
    assert torch.all(mo[0] == 0) and torch.all(mm[0] == -np.inf)
    assert torch.all(ml[0] == 0)


@pytest.mark.parametrize("t,with_win,with_ring", [
    (8, True, True), (8, False, False), (512, True, False),
])
def test_window_attention_matches_jax(t, with_win, with_ring):
    rng = np.random.default_rng(t)
    b, hkv, g, dh, s, r = 2, 2, 2, 16, 24, 4
    h = hkv * g
    q = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    kc = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    start = np.array([5, 19], np.int32)
    positions = (start[:, None] + np.arange(t)[None, :]).astype(np.int32)
    chunk_lens = np.array([t, t - 3], np.int32)
    args = {}
    if with_win:
        args.update(win_k=rng.standard_normal((hkv, b, s, dh)).astype(np.float32),
                    win_v=rng.standard_normal((hkv, b, s, dh)).astype(np.float32),
                    win_len=start)
    if with_ring:
        ring_pos = np.full((b, r), 2**30, np.int32)
        ring_pos[:, :2] = start[:, None] - 2 + np.arange(2)[None, :]
        args.update(ring_k=rng.standard_normal((hkv, b, r, dh)).astype(np.float32),
                    ring_v=rng.standard_normal((hkv, b, r, dh)).astype(np.float32),
                    ring_pos=ring_pos)
    j = jattn.window_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(positions),
        jnp.asarray(chunk_lens), **{k: jnp.asarray(v) for k, v in args.items()})
    o = tattn.window_attention(
        _t(q), _t(kc), _t(vc), _t(positions), _t(chunk_lens),
        **{k: _t(v) for k, v in args.items()})
    np.testing.assert_allclose(o.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_dense_decode_stats_and_merge_match_jax():
    rng = np.random.default_rng(7)
    # The paged segment below reuses the shapes of the Dh=64 case of
    # test_paged_decode_matches_pallas_interpret_and_xla (one compile).
    b, hkv, g, dh, s = 4, 2, 3, 64, 6
    h = hkv * g
    neg = float(np.finfo(np.float32).min)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    keys = rng.standard_normal((hkv, b, s, dh)).astype(np.float32)
    vals = rng.standard_normal((hkv, b, s, dh)).astype(np.float32)
    bias = np.zeros((b, s), np.float32)
    bias[0] = neg            # row 0: every key masked
    bias[1, 3:] = neg
    bias[3, 1:] = neg
    jd = jattn.dense_decode_stats(jnp.asarray(q), jnp.asarray(keys),
                                  jnp.asarray(vals), jnp.asarray(bias))
    td = tattn.dense_decode_stats(_t(q), _t(keys), _t(vals), _t(bias))
    for a, c in zip(td, jd):
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=TOL, atol=TOL)
    assert np.all(td[1].numpy()[0] == -np.inf) and np.all(td[2].numpy()[0] == 0)
    # Merge with a second segment (row 0 then equals that segment alone).
    _, k2, v2, bt, lens = _pool_case(9, b, h, hkv, dh, [3, 600, 0, 64])
    jp = jax_paged_stats(jnp.asarray(q), jnp.asarray(k2), jnp.asarray(v2),
                         jnp.asarray(bt), jnp.asarray(lens),
                         jnp.asarray([1], jnp.int32), block_size=PALLAS_BS,
                         interpret=True)
    tp = tpa.paged_flash_decode_stats(_t(q), _t(k2), _t(v2), _t(bt), _t(lens),
                                      1, block_size=PALLAS_BS)
    jm = jattn.merge_attention_segments(*jp, *jd)
    tm = tattn.merge_attention_segments(*tp, *td)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tm.numpy()[0], tp[0].numpy()[0], atol=1e-6)
    np.testing.assert_allclose(tm.numpy()[2], td[0].numpy()[2], atol=1e-6)


def test_gather_window_and_pool_scatter_match_jax():
    rng = np.random.default_rng(11)
    n_layers, hkv, dh, bs, nb = 2, 2, 8, 4, 10
    kp = rng.standard_normal((n_layers, hkv, nb * bs, dh)).astype(np.float32)
    vp = rng.standard_normal((n_layers, hkv, nb * bs, dh)).astype(np.float32)
    bt = np.array([[3, 1, 7], [9, 2, 0]], np.int32)
    jk, jv = jattn.gather_window(jnp.asarray(kp), jnp.asarray(vp),
                                 jnp.asarray(bt), bs)
    tk, tv = tattn.gather_window(_t(kp), _t(vp), _t(bt), bs)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    k_new = rng.standard_normal((2, 3, hkv, dh)).astype(np.float32)
    v_new = rng.standard_normal((2, 3, hkv, dh)).astype(np.float32)
    slots = np.array([[5, 6, 0], [17, 30, 31]], np.int32)
    jk2, jv2 = jattn.write_kv_to_pool(jnp.asarray(kp[0]), jnp.asarray(vp[0]),
                                      jnp.asarray(k_new), jnp.asarray(v_new),
                                      jnp.asarray(slots))
    tk2, tv2 = tattn.write_kv_to_pool(_t(kp[0]).clone(), _t(vp[0]).clone(),
                                      _t(k_new), _t(v_new), _t(slots))
    np.testing.assert_array_equal(tk2.numpy(), np.asarray(jk2))
    np.testing.assert_array_equal(tv2.numpy(), np.asarray(jv2))


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """On the card: the CUDA kernel against its plain version in bf16. Both
    round fp32 sums (in another order) to bf16 once, so out agrees within
    one bf16 step (atol 2e-3, rtol 1e-2) and, since a typical |out| is only
    a few hundredths, each row within 5e-3 of its norm; m, l within 1e-3."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; the kernel has no CPU mode")
    # Full-precision f32 products in the plain version.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    q, kp, vp, bt, lens = _pool_case(5, 4, 24, 8, 128, [0, 1, 37, 520])
    args = [torch.from_numpy(x).to(dev) for x in (q, kp, vp)]
    args = [a.to(torch.bfloat16) for a in args]
    bt_t, lens_t = torch.from_numpy(bt).to(dev), torch.from_numpy(lens).to(dev)
    before = tpa.launch_counts()[tpa.BF16]
    out, m, l = tpa.paged_flash_decode_stats(*args, bt_t, lens_t, 1, block_size=16)
    ro, rm, rl = tpa.paged_flash_decode_stats_ref(*args, bt_t, lens_t, 1,
                                                  block_size=16)
    assert tpa.launch_counts()[tpa.BF16] == before + 1
    torch.testing.assert_close(out.float(), ro.float(), atol=2e-3, rtol=1e-2)
    diff = (out[1:].float() - ro[1:].float()).norm(dim=-1)
    assert (diff / ro[1:].float().norm(dim=-1)).max().item() <= 5e-3
    torch.testing.assert_close(m[1:], rm[1:], rtol=1e-3, atol=1e-5)
    torch.testing.assert_close(l[1:], rl[1:], rtol=1e-3, atol=1e-5)
