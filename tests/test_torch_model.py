"""The PyTorch port's llama forward, logits and sampler against the JAX
package's, on shared weights (the JAX params exported through numpy into
``params_from_jax``), in float32 on the CPU.

Forward/logit tolerance 2e-4: both sides compute in f32 and differ only in
summation order (matmul blocking, the Pallas kernel's superpages). The
sampler is held token for token: both are fed the same Gumbel field. The
paged branch uses 128-token pages to keep the Pallas interpret-mode compile
short (it unrolls one DMA per page of a 512-token superpage).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine import sampling as jsampling
from production_stack_tpu.models import llama as jllama
from production_stack_tpu.models.config import resolve_model_config as jresolve
from production_stack_tpu.ops.attention import gather_window as jgather
from production_stack_tpu_torch.engine import sampling as tsampling
from production_stack_tpu_torch.models import llama as tllama
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.ops.attention import gather_window as tgather

TOL = 2e-4
CONFIGS = ["tiny-llama", "tiny-llama-8kv", "tiny-llama-128dh"]


def _t(x):
    return torch.from_numpy(np.array(x))


def _shared(name):
    jcfg = jresolve(name)
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tcfg = resolve_model_config(name)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, torch.float32)
    return jcfg, jp, tcfg, tp


def _pools(cfg, seed, b, mb, bs=16):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    shape = (cfg.num_layers, cfg.num_kv_heads, nb * bs, cfg.head_dim_)
    kp = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    vp = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    bt = (1 + rng.permutation(b * mb)).reshape(b, mb).astype(np.int32)
    return kp, vp, bt


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL, atol=TOL)


def test_bf16_silu_matches_jitted_jax_on_every_input():
    """All 65,536 bf16 bit patterns (NaNs, infinities and subnormals
    included) through the port's ``silu`` and ``jax.jit(jax.nn.silu)``:
    the same 16 bits each. ``F.silu`` differs on ~1,900 of them."""
    bits = np.arange(65536, dtype=np.uint16)
    want = np.asarray(jax.jit(jax.nn.silu)(
        jnp.asarray(bits).view(jnp.bfloat16))).view(np.uint16)
    x = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    got = tllama.silu(x).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    f32 = np.random.default_rng(0).standard_normal(65536).astype(np.float32) * 30
    np.testing.assert_array_equal(
        tllama._xla_exp_f32(_t(f32)).numpy().view(np.uint32),
        np.asarray(jax.jit(jnp.exp)(f32)).view(np.uint32))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_window_branch_matches_jax(name):
    """A prefill continuation chunk: gathered history window + causal chunk."""
    jcfg, jp, tcfg, tp = _shared(name)
    b, t, bs, mb = 2, 8, 16, 4
    kp, vp, bt = _pools(jcfg, 1, b, mb)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (b, t)).astype(np.int32)
    start = np.array([20, 3], np.int32)
    pos = (start[:, None] + np.arange(t)[None, :]).astype(np.int32)
    lens = np.array([t, 5], np.int32)
    jwk, jwv = jgather(jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt), bs)
    jh, jk, jv = jllama.forward(jp, jcfg, jnp.asarray(toks), jnp.asarray(pos),
                                jnp.asarray(lens), jwk, jwv, jnp.asarray(start))
    twk, twv = tgather(_t(kp), _t(vp), _t(bt), bs)
    th, tk, tv = tllama.forward(tp, tcfg, _t(toks), _t(pos), _t(lens),
                                twk, twv, _t(start))
    _close(th.numpy(), jh)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    _close(tllama.compute_logits(tp, tcfg, th).numpy(),
           jllama.compute_logits(jp, jcfg, jh))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_paged_branch_matches_jax(name):
    """A decode step: the pool segment through the paged decode (JAX: the
    Pallas kernel in interpret mode; port: the kernel's plain version) plus
    the in-dispatch ring and the current token."""
    jcfg, jp, tcfg, tp = _shared(name)
    b, bs, mb, r = 3, 128, 2, 4
    kp, vp, bt = _pools(jcfg, 3, b, mb, bs)
    rng = np.random.default_rng(4)
    pos0 = np.array([0, 17, 140], np.int32)       # kv_lens = pos0 (row 0 empty)
    step = 2                                      # two ring entries written
    pos = (pos0 + step)[:, None].astype(np.int32)
    toks = rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32)
    shape = (jcfg.num_layers, jcfg.num_kv_heads, b, r, jcfg.head_dim_)
    ring_k = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    ring_v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    ring_pos = np.full((b, r), 2**30, np.int32)
    ring_pos[:, :step] = pos0[:, None] + np.arange(step)[None, :]
    ones = np.ones((b,), np.int32)
    jpaged = (jnp.asarray(kp), jnp.asarray(vp), None, None, jnp.asarray(bt),
              jnp.asarray(pos0), bs, True, None)
    jh, jk, jv = jllama.forward(
        jp, jcfg, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(ones),
        None, None, None, jnp.asarray(ring_k), jnp.asarray(ring_v),
        jnp.asarray(ring_pos), paged=jpaged)
    th, tk, tv = tllama.forward(
        tp, tcfg, _t(toks), _t(pos), _t(ones), None, None, None,
        _t(ring_k), _t(ring_v), _t(ring_pos),
        paged=(_t(kp), _t(vp), None, None, _t(bt), _t(pos0), bs))
    _close(th.numpy(), jh)
    _close(tk.numpy(), jk)
    _close(tv.numpy(), jv)
    _close(tllama.compute_logits(tp, tcfg, th[:, 0]).numpy(),
           jllama.compute_logits(jp, jcfg, jh[:, 0]))


def test_sample_tokens_matches_jax_with_shared_gumbel():
    """Greedy, unfiltered, top-k, top-p and combined rows; the JAX
    sampler's own Gumbel field is handed to the port's."""
    rng = np.random.default_rng(5)
    b, v = 8, 512
    logits = (3.0 * rng.standard_normal((b, v))).astype(np.float32)
    temps = np.array([0.0, 1.0, 0.7, 1.0, 0.9, 1.3, 0.0, 0.5], np.float32)
    top_k = np.array([-1, -1, 5, -1, 20, 3, 4, -1], np.int32)
    top_p = np.array([1.0, 1.0, 1.0, 0.9, 0.8, 1.0, 0.5, 0.3], np.float32)
    for trial in range(4):
        seeds = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
        g = np.asarray(jsampling._gumbel(jnp.asarray(seeds), (b, v)))
        want = np.asarray(jsampling.sample_tokens(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_k),
            jnp.asarray(top_p), jnp.asarray(seeds)))
        got = tsampling.sample_tokens(_t(logits), _t(temps), _t(top_k),
                                      _t(top_p), _t(g))
        np.testing.assert_array_equal(got.numpy(), want)
        assert got[0].item() == int(np.argmax(logits[0]))


@pytest.mark.parametrize("seed", [0, 1, 1234, 2**32 - 1])
def test_threefry_gumbel_matches_jax(seed):
    """The port's noise against jax.random on the CPU: the threefry bits
    and the uniform exactly, and the Gumbel field too (the port reproduces
    XLA's f32 log, so it is within 0 of the 2 ulp allowed)."""
    key = jax.random.PRNGKey(np.uint32(seed))
    tiny = np.finfo(np.float32).tiny
    for v in (256, 128256):
        want = np.asarray(jax.random.bits(key, (v,), jnp.uint32))
        bits = tsampling.random_bits([seed], v, torch.device("cpu"))
        np.testing.assert_array_equal(bits[0].numpy(), want.astype(np.int64))
        u = tsampling.uniform_from_bits(bits)[0].numpy()
        np.testing.assert_array_equal(
            u.view(np.int32),
            np.asarray(jax.random.uniform(key, (v,), jnp.float32, minval=tiny,
                                          maxval=1.0)).view(np.int32))
        g = tsampling.gumbel_noise([seed], v, torch.device("cpu"))[0].numpy()
        jg = np.asarray(jax.random.gumbel(key, (v,), jnp.float32))
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - jg.view(np.int32).astype(np.int64))
        assert ulps.max() <= 2, (v, int(ulps.max()), int((ulps > 0).sum()))
        assert np.array_equal(g, jg)
    # The sampler's own batched field (vmap over per-row keys).
    seeds = np.array([seed, 7], np.uint32)
    jrows = np.asarray(jsampling._gumbel(jnp.asarray(seeds), (2, 256)))
    trows = tsampling.gumbel_noise([int(x) for x in seeds], 256,
                                   torch.device("cpu"))
    np.testing.assert_array_equal(trows.numpy(), jrows)


def test_port_noise_is_per_row_and_seeded():
    """A row's noise depends on its seed only, never on its batch."""
    s = [tsampling.token_seed(12345, i) for i in range(3)]
    a = tsampling.gumbel_noise(s, 64, torch.device("cpu"))
    b = tsampling.gumbel_noise([s[2], 99, s[0]], 64, torch.device("cpu"),
                               rows=[True, False, True])
    torch.testing.assert_close(a[2], b[0], rtol=0, atol=0)
    torch.testing.assert_close(a[0], b[2], rtol=0, atol=0)
    assert torch.all(b[1] == 0)
    assert tsampling.token_seed(2**32 - 1, 5) == \
        (int(np.uint32(2**32 - 1)) * 1000003 + 5) & 0xFFFFFFFF


def test_apply_penalties_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((2, 16)).astype(np.float32)
    counts = rng.integers(0, 3, (2, 16)).astype(np.int32)
    pres = np.array([0.5, 0.0], np.float32)
    freq = np.array([0.25, 1.0], np.float32)
    want = jsampling.apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                                     jnp.asarray(pres), jnp.asarray(freq))
    got = tsampling.apply_penalties(_t(logits), _t(counts), _t(pres), _t(freq))
    _close(got.numpy(), want)
