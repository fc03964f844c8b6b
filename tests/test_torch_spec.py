"""Speculative decoding in the PyTorch port against the JAX package's.

The bar of ``tests/test_speculative.py`` holds here too: spec-on tokens
equal spec-off tokens, greedy and seeded, in linear, tree and adaptive
modes, with the self draft and the cross-arch ``tiny-opt`` draft. Port
engines serve the JAX engines' own float32 weights on the CPU (exported
through numpy), so their spec-on tokens also equal the JAX spec-on
engine's, and, acceptance being deterministic, so do the acceptance
counters. The pieces are held to the JAX functions on the same arrays:
the accept rules (bit-equal, on the reference's pinned traces and on seeded
sweeps), the tree layout, the adaptive controller, ``window_attention``
with the tree bias and the OPT forward (atol 1e-5), and the config
refusals with their messages.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine import sampling as jsampling
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.runner import (
    SpecGammaController as JaxController,
    resolved_seed_base,
)
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models import opt as jopt
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.ops import tree_mask as jtree
from production_stack_tpu.ops.attention import (
    window_attention as jax_window_attention,
)
from production_stack_tpu_torch.engine import sampling as tsampling
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.runner import SpecGammaController
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models import opt as topt
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.ops import tree_mask as ttree
from production_stack_tpu_torch.ops.attention import window_attention

BASE = dict(
    model="tiny-llama", max_model_len=256, block_size=4, num_kv_blocks=128,
    max_num_seqs=8, max_num_batched_tokens=32, attn_impl="window",
    dtype="float32", num_decode_steps=8,
)
# The tree and adaptive engines of the reference's round-10 fixture.
BASE_R10 = dict(BASE, max_num_seqs=4)
MODES = {
    "off": BASE,
    "self": dict(BASE, speculative_num_tokens=3,
                 speculative_model="tiny-llama"),
    "opt": dict(BASE, speculative_num_tokens=3, speculative_model="tiny-opt"),
    "tree": dict(BASE_R10, speculative_num_tokens=3,
                 speculative_model="tiny-llama", speculative_tree_width=3),
    "adaptive": dict(BASE_R10, speculative_num_tokens=3,
                     speculative_model="tiny-llama", speculative_tree_width=3,
                     speculative_adaptive=True),
}
GREEDY = dict(temperature=0.0, max_tokens=24, ignore_eos=True)
SEEDED = dict(temperature=0.9, seed=1234, max_tokens=24, ignore_eos=True)
FILTERED = dict(temperature=0.8, top_p=0.9, top_k=50, seed=5, max_tokens=16,
                ignore_eos=True)
COUNTERS = ("spec_draft_tokens_total", "spec_accepted_tokens_total",
            "spec_tree_nodes_total", "spec_gamma0_dispatches_total",
            "spec_live_cycles_total")


# ------------------------------------------------------------ accept rules
def _port_accept(props, samples, budget, gamma=None):
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32))  # noqa: E731
    emit, acc = tsampling.speculative_accept(
        t(props), t(samples), t(budget), None if gamma is None else t(gamma))
    return emit.numpy(), acc.numpy()


def _jax_accept(props, samples, budget, gamma=None):
    j = lambda a: jnp.asarray(np.asarray(a, np.int32))  # noqa: E731
    emit, acc = jsampling.speculative_accept(
        j(props), j(samples), j(budget), None if gamma is None else j(gamma))
    return np.asarray(emit), np.asarray(acc)


# The reference's pinned linear traces (tests/test_speculative.py).
LINEAR_CASES = [
    ([[5, 6, 7]], [[5, 6, 7, 8]], [10], None),
    ([[5, 9, 7]], [[5, 6, 7, 8]], [10], None),
    ([[9, 6, 7]], [[5, 6, 7, 8]], [10], None),
    ([[5, 6, 7]], [[5, 6, 7, 8]], [2], None),
    ([[5, 6, 7]], [[5, 6, 7, 8]], [0], None),
    ([[1, 2, 3], [1, 2, 3]], [[1, 2, 3, 4], [9, 2, 3, 4]], [10, 10], None),
    ([[1, 2, 3], [1, 2, 3]], [[1, 2, 3, 4], [1, 2, 3, 4]], [10, 10], [1, 0]),
]


@pytest.mark.parametrize("case", range(len(LINEAR_CASES)))
def test_speculative_accept_matches_jax_on_pinned_traces(case):
    props, samples, budget, gamma = LINEAR_CASES[case]
    got, want = _port_accept(props, samples, budget, gamma), \
        _jax_accept(props, samples, budget, gamma)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n", [1, 3, 5])
def test_speculative_accept_matches_jax_on_seeded_sweeps(n):
    rng = np.random.default_rng(n)
    for _ in range(20):
        b = 6
        props = rng.integers(0, 3, (b, n))
        samples = rng.integers(0, 3, (b, n + 1))
        budget = rng.integers(-1, 9, b)
        gamma = rng.integers(0, n + 1, b)
        for gm in (None, gamma):
            got = _port_accept(props, samples, budget, gm)
            want = _jax_accept(props, samples, budget, gm)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def _tree_both(v_toks, z, budget, gamma, n, w):
    parents, depths = jtree.tree_structure(n, w)
    a = lambda x: np.asarray(x, np.int32)  # noqa: E731
    want = jsampling.speculative_tree_accept(
        jnp.asarray(a(v_toks)), jnp.asarray(a(z)), parents, depths,
        jnp.asarray(a(budget)), jnp.asarray(a(gamma)))
    got = tsampling.speculative_tree_accept(
        torch.from_numpy(a(v_toks)), torch.from_numpy(a(z)), parents, depths,
        torch.from_numpy(a(budget)), torch.from_numpy(a(gamma)))
    return [g.numpy() for g in got], [np.asarray(x) for x in want]


_VT = [10, 11, 20, 21, 12, 13]
TREE_CASES = [
    ([_VT], [[11, 12, 0, 0, 13, 99]], [10], [3]),
    ([_VT], [[20, 0, 77, 0, 0, 0]], [10], [3]),
    ([_VT], [[55, 0, 0, 0, 0, 0]], [10], [3]),
    ([_VT], [[11, 12, 0, 0, 13, 99]], [10], [1]),
    ([_VT], [[11, 12, 0, 0, 13, 99]], [10], [0]),
    ([_VT], [[11, 12, 0, 0, 13, 99]], [2], [3]),
    ([_VT], [[11, 12, 0, 0, 13, 99]], [0], [3]),
    ([_VT, _VT, _VT],
     [[11, 12, 0, 0, 13, 99], [20, 0, 7, 0, 0, 0], [55, 0, 0, 0, 0, 0]],
     [10, 10, 10], [3, 3, 3]),
]


@pytest.mark.parametrize("case", range(len(TREE_CASES)))
def test_tree_accept_matches_jax_on_pinned_traces(case):
    got, want = _tree_both(*TREE_CASES[case], n=3, w=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("n,w", [(3, 3), (2, 4), (4, 2)])
def test_tree_accept_matches_jax_on_seeded_sweeps(n, w):
    rng = np.random.default_rng(10 * n + w)
    for _ in range(20):
        b, t = 5, n + w
        v_toks = rng.integers(0, 4, (b, t))
        z = rng.integers(0, 4, (b, t))
        got, want = _tree_both(v_toks, z, rng.integers(-1, 9, b),
                               rng.integers(0, n + 1, b), n, w)
        for g, x in zip(got, want):
            np.testing.assert_array_equal(g, x)


def test_tree_layout_matches_jax():
    for n, w in ((1, 1), (3, 1), (3, 3), (4, 8), (16, 8)):
        for fn in ("tree_structure",):
            for g, x in zip(getattr(ttree, fn)(n, w), getattr(jtree, fn)(n, w)):
                np.testing.assert_array_equal(g, x)
        parents, _ = jtree.tree_structure(n, w)
        np.testing.assert_array_equal(ttree.ancestor_matrix(parents),
                                      jtree.ancestor_matrix(parents))
        np.testing.assert_array_equal(ttree.tree_attention_bias(parents),
                                      np.asarray(jtree.tree_attention_bias(parents)))
        np.testing.assert_array_equal(ttree.main_chain_indices(n, w),
                                      jtree.main_chain_indices(n, w))
    with pytest.raises(ValueError, match="n_spec"):
        ttree.tree_structure(0, 1)


def test_adaptive_gamma_and_controller_match_jax():
    for alpha in np.linspace(-0.1, 1.1, 25):
        for n_max in (1, 3, 16):
            for thr in (0.1, 0.5, 0.9, 2.0):
                assert tsampling.adaptive_gamma(alpha, n_max, thr) == \
                    jsampling.adaptive_gamma(alpha, n_max, thr)
    # The reference's scripted traces, through both controllers.
    for decay, thr, probe in ((0.5, 0.5, 0), (1.0, 0.5, 3), (0.35, 0.5, 16)):
        mine = SpecGammaController(3, decay, thr, probe)
        ref = JaxController(3, decay, thr, probe)
        trace = [(3, 0)] * 6 + [(3, 3)] * 6 + [(0, 0), (2, 1), (3, 0)] * 4
        for drafted, acc in trace:
            for c in (mine, ref):
                c.update("r", drafted, acc)
            assert [mine.gamma("r") for _ in range(3)] == \
                [ref.gamma("r") for _ in range(3)]
            assert mine.ema("r") == ref.ema("r")
            assert mine.mean_ema() == ref.mean_ema()
        mine.forget("r")
        assert mine.gamma("r") == 3 and mine.mean_ema() == 0.0


def test_top_k_like_jax_orders_ties_as_jax():
    """Tied values: jax.lax.top_k's selection (the lowest ids among values
    tied at the k-th place) and order (lower id first), bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, (8, 64)).astype(np.float32)
    x[0] = 1.0
    x[1, ::3] = 5.0
    for k in (1, 3, 7, 20, 64):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tsampling.top_k_like_jax(torch.from_numpy(x), k)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ------------------------------------------------------------------ model
def test_window_attention_with_chunk_bias_matches_jax():
    """The tree verify's attention: window + ring + chunk under the tree
    bias (siblings share a position and must not see each other)."""
    rng = np.random.default_rng(7)
    b, h, hkv, dh, s, r = 3, 4, 2, 16, 12, 6
    n, w = 3, 3
    parents, depths = jtree.tree_structure(n, w)
    t = n + w
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    q, kc, vc = f(b, t, h, dh), f(b, t, hkv, dh), f(b, t, hkv, dh)
    wk, wv, rk, rv = f(hkv, b, s, dh), f(hkv, b, s, dh), f(hkv, b, r, dh), \
        f(hkv, b, r, dh)
    pos0 = np.array([9, 12, 14], np.int32)
    positions = (pos0[:, None] + depths[None, :]).astype(np.int32)
    win_len = np.array([8, 12, 5], np.int32)
    ring_pos = np.array([[8, 2**30, 2**30, 2**30, 2**30, 2**30],
                         [2**30] * 6, [5, 6, 7, 8, 2**30, 2**30]], np.int32)
    lens = np.full((b,), t, np.int32)
    bias = ttree.tree_attention_bias(parents)
    want = np.asarray(jax_window_attention(
        *(jnp.asarray(a) for a in (q, kc, vc, positions, lens, wk, wv,
                                   win_len, rk, rv, ring_pos)),
        chunk_bias=jnp.asarray(bias)))
    got = window_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, positions, lens, wk, wv,
                                        win_len, rk, rv, ring_pos)),
        chunk_bias=torch.from_numpy(bias)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # Without the bias siblings attend each other: the bias matters here.
    plain = window_attention(
        *(torch.from_numpy(a) for a in (q, kc, vc, positions, lens, wk, wv,
                                        win_len, rk, rv, ring_pos))).numpy()
    assert np.abs(plain - want).max() > 1e-3


def test_opt_forward_and_logits_match_jax():
    """tiny-opt's forward over a chunk with a window and a ring, and its
    tied-head logits, on the JAX package's weights."""
    mc = resolve_model_config("tiny-opt")
    jparams = jopt.init_params(jax_resolve("tiny-opt"), jax.random.PRNGKey(2),
                               jnp.float32)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), mc,
                              torch.float32)
    rng = np.random.default_rng(2)
    b, t, s, r = 2, 5, 8, 4
    nl, hkv, dh = mc.num_layers, mc.num_kv_heads, mc.head_dim_
    toks = rng.integers(0, mc.vocab_size, (b, t)).astype(np.int32)
    pos = (np.array([[8], [6]]) + np.arange(t)[None, :]).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    wk, wv, rk, rv = f(nl, hkv, b, s, dh), f(nl, hkv, b, s, dh), \
        f(nl, hkv, b, r, dh), f(nl, hkv, b, r, dh)
    win_len = np.array([6, 5], np.int32)
    ring_pos = np.array([[6, 7, 2**30, 2**30], [5, 2**30, 2**30, 2**30]],
                        np.int32)
    args = (toks, pos, lens, wk, wv, win_len, rk, rv, ring_pos)
    jh, jk, jv = jopt.forward(jparams, jax_resolve("tiny-opt"),
                              *(jnp.asarray(a) for a in args))
    th, tk, tv = topt.forward(tparams, mc, *(torch.from_numpy(a) for a in args))
    for g, w in ((th, jh), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)
    jl = jopt.compute_logits(jparams, jax_resolve("tiny-opt"), jh)
    tl = topt.compute_logits(tparams, mc, th)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5, rtol=0)


# ----------------------------------------------------------------- config
REFUSALS = [
    dict(BASE, speculative_num_tokens=3, speculative_model="facebook/opt-125m"),
    dict(BASE, speculative_num_tokens=3),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         kv_cache_dtype="int8"),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         tensor_parallel_size=2),
    dict(BASE, speculative_num_tokens=17, speculative_model="tiny-llama"),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         speculative_tree_width=9),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         speculative_tree_width=0),
    dict(BASE, speculative_adaptive=True),
    dict(BASE, speculative_tree_width=3),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         speculative_ema_decay=0.0),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         speculative_gamma_threshold=0.0),
    dict(BASE, speculative_num_tokens=3, speculative_model="tiny-llama",
         speculative_probe_period=-1),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_config_refusals_match_jax(case):
    """Each pairing the reference refuses, with its message."""
    fields = REFUSALS[case]
    with pytest.raises(ValueError) as jerr:
        JaxConfig(**fields)
    with pytest.raises(ValueError) as terr:
        EngineConfig(**fields, device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_attn_impl_with_spec_matches_jax():
    """``auto`` resolves to the window path with speculation, on the card
    too (the port's own default there is the paged kernel); ``paged`` with
    speculation is an error, as in the reference."""
    fields = dict(BASE, model="tiny-llama-128dh", dtype="bfloat16",
                  speculative_num_tokens=3,
                  speculative_model="tiny-llama-128dh")
    mc = resolve_model_config("tiny-llama-128dh")
    for device in ("cpu", "cuda"):
        cfg = EngineConfig(**{**fields, "attn_impl": "auto"}, device=device)
        assert cfg.resolved_attn_impl(mc) == "window"
        assert cfg.speculative_ring_len == 256
    jcfg = JaxConfig(**{**fields, "attn_impl": "paged"})
    with pytest.raises(ValueError) as jerr:
        jcfg.resolved_attn_impl(jax_resolve("tiny-llama-128dh"))
    cfg = EngineConfig(**{**fields, "attn_impl": "paged"}, device="cuda")
    with pytest.raises(ValueError, match="window") as terr:
        cfg.resolved_attn_impl(mc)
    assert str(terr.value) == str(jerr.value).replace(
        "Pallas flash-decode", "paged flash-decode")
    assert EngineConfig(**BASE, device="cpu",
                        speculative_draft_window=0, speculative_num_tokens=2,
                        speculative_model="tiny-llama").speculative_ring_len == 256


# ---------------------------------------------------------------- engines
def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def engines():
    """A JAX engine and a port engine per mode, the port's on the JAX
    engine's weights (target, and the tiny-opt draft)."""
    loop = asyncio.new_event_loop()
    eng = {}
    for mode, fields in MODES.items():
        jeng = JaxEngine(JaxConfig(**fields))
        r = jeng.runner
        mc = resolve_model_config(fields["model"])
        params = params_from_jax(_np_tree(r.params), mc, torch.float32)
        draft = None
        if fields.get("speculative_model") == "tiny-opt":
            draft = params_from_jax(_np_tree(r.spec_params),
                                    resolve_model_config("tiny-opt"),
                                    torch.float32)
        teng = ServingEngine(EngineConfig(**fields, device="cpu"),
                             params=params, draft_params=draft)
        eng[mode] = (jeng, teng)
    for pair in eng.values():
        for e in pair:
            loop.run_until_complete(e.start())
    yield eng, loop
    for pair in eng.values():
        for e in pair:
            loop.run_until_complete(e.stop())
    for _, teng in eng.values():
        teng.shutdown()
    loop.close()


async def _collect(engine, prompt, sampling, request_id, **kw):
    text, outs = "", []
    async for out in engine.generate(prompt=prompt, sampling=sampling,
                                     request_id=request_id, **kw):
        text += out.text_delta
        outs.append(out)
    return text, outs


def _run(loop, engine, prompt, sampling, request_id, **kw):
    return loop.run_until_complete(
        _collect(engine, prompt, sampling, request_id, **kw))


def _counters(engine):
    return {k: getattr(engine.runner, k) for k in COUNTERS}


@pytest.mark.parametrize("mode", ["self", "opt", "tree", "adaptive"])
def test_spec_tokens_and_counters_match_spec_off_and_jax(engines, mode):
    """Greedy, seeded, and seeded with top-p / top-k: the port's spec-on
    tokens equal its spec-off tokens and the JAX spec-on engine's; the
    acceptance counters (drafts, accepted, tree nodes, gamma-0 dispatches,
    live cycles) grow by the JAX engine's amounts on the same requests."""
    eng, loop = engines
    for tag, kw in (("g", GREEDY), ("s", SEEDED), ("f", FILTERED)):
        prompt = f"four mode parity {mode}"
        rid = f"fm-{tag}-{mode}"
        _, off = _run(loop, eng["off"][1], prompt, SamplingParams(**kw),
                      rid + "-off")
        jeng, teng = eng[mode]
        j0, t0 = _counters(jeng), _counters(teng)
        _, jon = _run(loop, jeng, prompt, JaxSampling(**kw), rid)
        _, ton = _run(loop, teng, prompt, SamplingParams(**kw), rid)
        assert ton[-1].token_ids == off[-1].token_ids, (tag, mode)
        assert ton[-1].token_ids == jon[-1].token_ids, (tag, mode)
        assert len(ton[-1].token_ids) == kw["max_tokens"]
        jd = {k: v - j0[k] for k, v in _counters(jeng).items()}
        td = {k: v - t0[k] for k, v in _counters(teng).items()}
        assert td == jd, (tag, mode)
        assert td["spec_draft_tokens_total"] > 0
    st = teng.stats()
    assert st["spec_enabled"] == 1 and 0.0 <= st["spec_acceptance_rate"] <= 1.0
    # The finished streams returned their draft-ring slots and controller
    # state.
    assert rid not in teng.runner._spec_slots
    if teng.runner._spec_controller is not None:
        assert rid not in teng.runner._spec_controller._ema


def test_self_draft_accepts_and_cross_draft_rejects(engines):
    eng, _ = engines
    self_st, opt_st = eng["self"][1].stats(), eng["opt"][1].stats()
    assert self_st["spec_acceptance_rate"] > 0.9
    assert opt_st["spec_acceptance_rate"] < 0.5
    assert eng["tree"][1].stats()["spec_tree_nodes_total"] == \
        5 * eng["tree"][1].stats()["spec_live_cycles_total"]
    off = eng["off"][1].stats()
    assert off["spec_enabled"] == 0 and off["spec_draft_tokens_total"] == 0


def test_spec_logprobs_match_spec_off_and_jax(engines):
    eng, loop = engines
    sp = dict(temperature=0.0, max_tokens=8, ignore_eos=True, logprobs=3)
    _, off = _run(loop, eng["off"][1], "logprob parity", SamplingParams(**sp),
                  "lp-off")
    _, on = _run(loop, eng["self"][1], "logprob parity", SamplingParams(**sp),
                 "lp-on")
    _, jon = _run(loop, eng["self"][0], "logprob parity", JaxSampling(**sp),
                  "lp-jax")
    assert on[-1].token_ids == off[-1].token_ids == jon[-1].token_ids
    assert len(on[-1].logprobs) == len(off[-1].logprobs) == 8
    for (c_off, top_off), (c_on, top_on), (c_j, top_j) in zip(
            off[-1].logprobs, on[-1].logprobs, jon[-1].logprobs):
        assert [t for t, _ in top_on] == [t for t, _ in top_off] == \
            [t for t, _ in top_j]
        assert c_on == pytest.approx(c_off, abs=1e-4)
        assert c_on == pytest.approx(c_j, abs=1e-4)


def test_variable_budgets_and_concurrency(engines):
    """Co-batched rows with budgets 3, 13 and 22: each stops at its own
    budget, with the spec-off engine's tokens at the same concurrency."""
    eng, loop = engines

    async def batch(e, tag):
        return await asyncio.gather(*[
            _collect(e, f"stream {i}", SamplingParams(
                temperature=0.0, max_tokens=m, ignore_eos=True), f"{tag}-{i}")
            for i, m in enumerate((3, 13, 22))])

    off = loop.run_until_complete(batch(eng["off"][1], "vb-off"))
    for mode in ("self", "tree"):
        on = loop.run_until_complete(batch(eng[mode][1], f"vb-{mode}"))
        for (_, o), (_, s) in zip(off, on):
            assert s[-1].token_ids == o[-1].token_ids, mode
        assert [s[-1].num_output_tokens for _, s in on] == [3, 13, 22]


def test_stop_string_inside_a_draft_window(engines):
    """A stop string taken from the middle of the greedy output (inside
    some draft/verify window): spec-on truncation equals spec-off's."""
    eng, loop = engines
    sp = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True)
    base_text, _ = _run(loop, eng["off"][1], "tell me a story", sp,
                        "stop-base")
    assert len(base_text) > 8
    mid = len(base_text) // 2
    stop = base_text[mid:mid + 3]
    idx = base_text.find(stop)
    assert idx > 0
    sp_stop = SamplingParams(temperature=0.0, max_tokens=40, ignore_eos=True,
                             stop=[stop])
    off_text, off = _run(loop, eng["off"][1], "tell me a story", sp_stop,
                         "stop-off")
    for mode in ("self", "tree", "adaptive"):
        on_text, on = _run(loop, eng[mode][1], "tell me a story", sp_stop,
                           f"stop-{mode}")
        assert on_text == off_text == base_text[:idx], mode
        assert on[-1].token_ids == off[-1].token_ids, mode
        assert on[-1].finish_reason == off[-1].finish_reason == "stop", mode


def test_resume_of_a_spec_on_stream_is_token_identical(engines):
    """Resume replays accepted tokens only: a spec-on stream resumed on a
    spec-on engine (its prefix a cache hit: the draft ring catches up) and
    on the spec-off engine continues token for token."""
    eng, loop = engines
    sp = SamplingParams(temperature=0.9, seed=77, max_tokens=14,
                        ignore_eos=True)
    _, full = _run(loop, eng["self"][1], "resume a speculative stream", sp,
                   "sr-full")
    toks = full[-1].token_ids
    assert len(toks) == 14
    for mode in ("self", "adaptive", "off"):
        _, res = _run(loop, eng[mode][1], "resume a speculative stream", sp,
                      f"sr-{mode}", resume_tokens=toks[:5],
                      resume_seed=resolved_seed_base("sr-full", sp))
        assert res[-1].token_ids == toks, mode
        assert res[-1].num_output_tokens == 14


def test_gamma0_pinned_engine_degrades_to_the_plain_train(engines):
    """Every row at gamma 0 takes the plain decode train: no drafts, no
    live cycles, the gamma-0 counter moves, the dispatches are tagged
    off-degrade, and the tokens are spec-off's (12 tokens in 8-step
    trains: two dispatches)."""
    eng, loop = engines
    e = eng["adaptive"][1]
    ctl = e.runner._spec_controller
    thr, probe = ctl.threshold, ctl.probe_period
    ctl.threshold, ctl.probe_period = 2.0, 0
    before = _counters(e)
    modes = []
    issue = e.runner.execute_async

    def record(batch):
        handle = issue(batch)
        if batch.kind == "decode":
            modes.append(batch.spec_mode)
        return handle

    e.runner.execute_async = record
    sp = SamplingParams(temperature=0.0, max_tokens=12, ignore_eos=True)
    try:
        _, outs = _run(loop, e, "degrade check", sp, "g0-1")
    finally:
        ctl.threshold, ctl.probe_period = thr, probe
        e.runner.execute_async = issue
    after = _counters(e)
    assert after["spec_draft_tokens_total"] == before["spec_draft_tokens_total"]
    assert after["spec_live_cycles_total"] == before["spec_live_cycles_total"]
    assert after["spec_gamma0_dispatches_total"] == \
        before["spec_gamma0_dispatches_total"] + 2
    assert modes == ["off-degrade"] * 2
    _, off = _run(loop, eng["off"][1], "degrade check", sp, "g0-off")
    assert outs[-1].token_ids == off[-1].token_ids


def test_prefix_cache_hit_catches_the_draft_ring_up(engines):
    """A second request over a cached prefix never prefills it here: the
    draft ingests it before its first chunk, so the self-draft still
    accepts nearly everything, and the tokens are spec-off's."""
    eng, loop = engines
    e = eng["self"][1]
    prompt = "a long shared prefix " * 4
    sp = SamplingParams(temperature=0.0, max_tokens=16, ignore_eos=True)
    _run(loop, e, prompt, sp, "pc-1")
    hits0 = e.stats()["prefix_cache_hits"]
    a0 = _counters(e)
    _, on = _run(loop, e, prompt + "tail", sp, "pc-2")
    a1 = _counters(e)
    assert e.stats()["prefix_cache_hits"] > hits0
    drafted = a1["spec_draft_tokens_total"] - a0["spec_draft_tokens_total"]
    accepted = a1["spec_accepted_tokens_total"] - a0["spec_accepted_tokens_total"]
    assert drafted > 0 and accepted >= 0.8 * drafted
    _, off = _run(loop, eng["off"][1], prompt + "tail", sp, "pc-off")
    assert on[-1].token_ids == off[-1].token_ids


def test_spec_warmup_families_and_graph_keys():
    """Warm-up runs (on the CPU: eagerly) every speculative family, and
    the plain families only for the adaptive engine's gamma-0 dispatches;
    a spec-off engine's keys are unchanged (no speculative family)."""
    small = dict(BASE, max_num_seqs=2, enable_warmup=True, device="cpu")
    keys = {}
    for mode in ("off", "self", "adaptive"):
        fields = {**MODES[mode], **small}
        if mode == "adaptive":
            fields["max_num_seqs"] = 2
        e = ServingEngine(EngineConfig(**fields))
        keys[mode] = e.runner.decode_graph_keys()
        e.runner.warmup()
        e.shutdown()
    assert keys["off"] and not any(k[5] for k in keys["off"])
    assert keys["self"] and all(k[5] for k in keys["self"])
    plain = {k[:5] for k in keys["off"]}
    assert {k[:5] for k in keys["adaptive"] if not k[5]} == plain
    assert {k[:5] for k in keys["adaptive"] if k[5]} == plain


def test_opt_target_serves_like_jax():
    """The reference's runner serves an OPT target (window path); so does
    the port, with the JAX engine's greedy tokens on its weights."""
    fields = dict(BASE, model="tiny-opt")
    jeng = JaxEngine(JaxConfig(**fields))
    teng = ServingEngine(
        EngineConfig(**fields, device="cpu"),
        params=params_from_jax(_np_tree(jeng.runner.params),
                               resolve_model_config("tiny-opt"),
                               torch.float32))
    loop = asyncio.new_event_loop()
    try:
        outs = []
        for e, cls in ((jeng, JaxSampling), (teng, SamplingParams)):
            loop.run_until_complete(e.start())
            _, o = _run(loop, e, "an opt target", cls(**GREEDY), "opt-t")
            loop.run_until_complete(e.stop())
            outs.append(o[-1].token_ids)
        assert outs[0] == outs[1] and len(outs[0]) == 24
        assert teng.runner.attn_impl == "window"
    finally:
        teng.shutdown()
        loop.close()
