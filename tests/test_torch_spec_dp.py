"""Speculative decoding at data parallelism in the PyTorch port against the
JAX package's.

At dp > 1 every replica runs rank 0's work: the speculative dispatches
(``SPEC_DECODE``), the draft catch-ups (``SPEC_INGEST``) and the fresh
slots (``SPEC_RESET``) are descriptors, a prefill's draft pass runs in its
chunk on every rank, and every replica runs rank 0's cycle count. Held here
on the CPU in float32 (the port's replicas are gloo processes, the JAX
package lays dp over the conftest's host devices), on the fixtures of
``tests/test_torch_spec.py``:
  * linear, tree and adaptive modes: greedy and seeded tokens, and the
    speculative counters, at dp = 2 equal the port's at dp = 1 and the JAX
    engine's at dp = 2, and the spec-off engine's tokens;
  * both replicas' KV pools and draft rings (digests of their raw bits)
    are equal after serving, and again after a prefix-cache hit whose
    draft catch-up ran on every replica;
  * ``stats()`` and /metrics carry rank 0's speculative counters beside
    the mesh's degree;
  * a draft of another family (``tiny-opt``) given as params reaches the
    workers by broadcast: the replicas' rings stay equal.
The tests run with one intra-op thread (the ranks share this machine's
cores; a worker runs with rank 0's thread count).
"""

import asyncio

import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.server.metrics import render_engine_metrics
from tests.test_torch_sp import _check_replicas
from tests.test_torch_spec import COUNTERS, MODES, _np_tree

TIMEOUT_S = 120.0
DP_MODES = {"linear": MODES["self"], "tree": MODES["tree"],
            "adaptive": MODES["adaptive"]}
# The port's cycle count beside the reference's counters.
PORT_COUNTERS = COUNTERS + ("spec_cycles_run_total",)
PREFIX = "a shared system prompt that the draft has to catch up on " * 2
PROMPTS = ["speculation on two replicas", "a second stream",
           "the third stream runs at a longer budget"]
SAMPLINGS = (dict(temperature=0.0, max_tokens=16, ignore_eos=True),
             dict(temperature=0.9, seed=77, max_tokens=12, ignore_eos=True))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


async def _round(engine, sampling_cls, prompts, kw, tag):
    async def one(i, p):
        toks = []
        async for o in engine.generate(prompt=p, sampling=sampling_cls(**kw),
                                       request_id=f"{tag}-{i}"):
            toks = o.token_ids
        return toks

    return await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])


async def _serve(engine, sampling_cls, reports=False):
    """Every round's tokens and counter growth: each sampling over the
    prompts at once, then the prefix's first stream and, once it is
    cached, a stream over it (its draft ring catches up); with
    ``reports``, every rank's report after the rounds and after the
    prefix-cache round."""
    r = engine.runner
    out, seen = [], []
    for i, kw in enumerate(SAMPLINGS):
        c0 = {k: getattr(r, k) for k in PORT_COUNTERS if hasattr(r, k)}
        toks = await _round(engine, sampling_cls, PROMPTS, kw, f"s{i}")
        out.append((toks, {k: getattr(r, k) - v for k, v in c0.items()}))
    if reports:
        seen.append(await engine.rank_reports(pool_digest=True))
    hits0 = engine.stats()["prefix_cache_hits"]
    for j, p in enumerate((PREFIX + "first tail", PREFIX + "second tail")):
        c0 = {k: getattr(r, k) for k in PORT_COUNTERS if hasattr(r, k)}
        toks = await _round(engine, sampling_cls, [p], SAMPLINGS[0], f"p{j}")
        out.append((toks, {k: getattr(r, k) - v for k, v in c0.items()}))
    assert engine.stats()["prefix_cache_hits"] > hits0
    if reports:
        seen.append(await engine.rank_reports(pool_digest=True))
    return out, seen


async def _port(fields, params, draft=None, **mesh):
    """The port's rounds (``_serve``), and its ``stats()`` and /metrics
    text after them."""
    if mesh:
        mesh = dict(mesh, tp_timeout_s=TIMEOUT_S)
    eng = ServingEngine(EngineConfig(**fields, **mesh, device="cpu"),
                        params=params, draft_params=draft)
    try:
        await eng.start()
        try:
            out, seen = await _serve(eng, SamplingParams, reports=bool(mesh))
            return out, seen, eng.stats(), render_engine_metrics(
                eng, fields["model"])
        finally:
            await eng.stop()
    finally:
        eng.shutdown()


def _same_replicas(seen):
    """Each report set: equal pools, rings and catch-up counts on both
    replicas; the prefix-cache round ran catch-ups on both."""
    for reports in seen:
        _check_replicas(reports, dp=2)
        digests = {r["spec_digest"] for r in reports}
        assert len(digests) == 1 and None not in digests, reports
        assert len({r["spec_ingests"] for r in reports}) == 1, reports
    assert seen[-1][1]["spec_ingests"] > seen[0][1]["spec_ingests"]


@pytest.mark.parametrize("mode", list(DP_MODES))
async def test_spec_dp2_matches_dp1_and_jax_dp2(mode):
    """Tokens and counters at dp = 2 equal the port's at dp = 1 and the JAX
    engine's at dp = 2, round by round; the replicas' pools and rings are
    equal, before and after the prefix-cache round."""
    fields = DP_MODES[mode]
    jeng = JaxEngine(JaxConfig(**fields, data_parallel_size=2))
    params = params_from_jax(_np_tree(jeng.runner.params),
                             resolve_model_config(fields["model"]),
                             torch.float32)
    await jeng.start()
    try:
        want, _ = await _serve(jeng, JaxSampling)
    finally:
        await jeng.stop()
    one, *_ = await _port(fields, params)
    two, seen, st, text = await _port(fields, params, data_parallel_size=2)
    assert [t for t, _ in two] == [t for t, _ in one] == [t for t, _ in want]
    assert [c for _, c in two] == [c for _, c in one]
    for (_, mine), (_, ref) in zip(two, want):
        assert {k: mine[k] for k in ref} == ref
    assert sum(c["spec_draft_tokens_total"] for _, c in two) > 0
    _same_replicas(seen)
    # Rank 0's counters, beside the mesh's degree, in stats() and /metrics.
    drafted = sum(c["spec_draft_tokens_total"] for _, c in two)
    assert st["mesh_dp_size"] == 2 and st["mesh_devices"] == 2
    assert st["spec_enabled"] == 1 and st["spec_draft_tokens_total"] == drafted
    label = f'{{model_name="{fields["model"]}"}}'
    assert f"pstpu:mesh_devices{label} 2" in text
    assert f"pstpu:spec_draft_tokens_total{label} {drafted}" in text
    off, *_ = await _port(MODES["off"], params)
    assert [t for t, _ in two] == [t for t, _ in off]


async def test_cross_family_draft_params_reach_every_replica():
    """A ``tiny-opt`` draft given as params (the JAX engine's): the workers
    take it by broadcast, so both replicas' rings stay equal, and the
    tokens and counters equal dp = 1's."""
    fields = MODES["opt"]
    jeng = JaxEngine(JaxConfig(**fields))
    params = params_from_jax(_np_tree(jeng.runner.params),
                             resolve_model_config(fields["model"]),
                             torch.float32)
    draft = params_from_jax(_np_tree(jeng.runner.spec_params),
                            resolve_model_config("tiny-opt"), torch.float32)
    one, *_ = await _port(fields, params, draft)
    two, seen, *_ = await _port(fields, params, draft, data_parallel_size=2)
    assert two == one
    _same_replicas(seen)
