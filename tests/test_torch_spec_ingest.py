"""The draft's catch-up ingest (engine/ingest_graphs.py) against the JAX
runner's ``_spec_ingest_jit``, and its warm-up.

Both runners take the same sequence through ``_spec_catch_up``: the JAX
runner runs its compiled ingest program for the bucket, the port stages
its packed inputs and runs ``IngestTrain.body`` eagerly over its arena
(the function a CUDA graph replays on the card). tiny-llama-128dh drafts
for itself on the JAX engine's float32 weights (``params_from_jax``); one
case drafts with tiny-opt for tiny-llama, past tiny-opt's position table.
The slot's ring positions must be equal, its K and V within ``TOL``
(tests/test_torch_prefill_graphs.py's float32 bound).
"""

import jax
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.engine.scheduler import Sequence as JaxSequence
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.scheduler import Sequence
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax

MODEL = "tiny-llama-128dh"
R = 64                      # ring length: buckets 16, 32 and 64
BASE = dict(model=MODEL, dtype="float32", max_model_len=256, block_size=16,
            num_kv_blocks=64, max_num_seqs=2, max_num_batched_tokens=64,
            num_decode_steps=4, attn_impl="window", speculative_num_tokens=2,
            speculative_model=MODEL, speculative_draft_window=R)
# tiny-opt's table holds 512 positions: a 1,024-token context clamps.
OPT = dict(BASE, model="tiny-llama", speculative_model="tiny-opt",
           max_model_len=1024)
TOL = 2e-4
# (fields, [(request, context length, upto)], the port's buckets). A
# request's calls run in order, so a second call continues the first.
CASES = {
    "bucket16": (BASE, [("a", 12, 12)], [16]),
    "bucket32": (BASE, [("a", 27, 27)], [32]),
    "continuation": (BASE, [("a", 45, 20), ("a", 45, 45)], [32]),
    "longer_than_ring": (BASE, [("a", 150, 10), ("a", 150, 150)], [16, 64]),
    "two_slots": (BASE, [("a", 40, 40), ("b", 70, 70)], [64]),
    "opt_clamp": (OPT, [("a", 600, 600)], [64]),
}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(fields):
    """A JAX engine and a port engine (CPU) over the JAX engine's weights,
    target and draft."""
    jeng = JaxEngine(JaxConfig(**fields))
    r = jeng.runner
    params = params_from_jax(_np_tree(r.params),
                             resolve_model_config(fields["model"]),
                             torch.float32)
    draft = None
    if fields["speculative_model"] != fields["model"]:
        draft = params_from_jax(
            _np_tree(r.spec_params),
            resolve_model_config(fields["speculative_model"]), torch.float32)
    teng = ServingEngine(EngineConfig(**fields, device="cpu"), params=params,
                         draft_params=draft)
    return jeng, teng


def _ids(rid: str, n: int):
    seed = sum(map(ord, rid))
    return [int(x) for x in
            np.random.default_rng(seed).integers(3, 512, size=n)]


def _catch_up(jeng, teng, rid, n, upto):
    ids = _ids(rid, n)
    for runner, seq_cls, samp_cls in (
            (jeng.runner, JaxSequence, JaxSampling),
            (teng.runner, Sequence, SamplingParams)):
        seq = seq_cls(rid, list(ids), samp_cls(max_tokens=4))
        runner._spec_catch_up(seq, upto)


def _close_slot(jeng, teng, rid):
    jr, tr = jeng.runner, teng.runner
    js, ts = jr._spec_slots[rid], tr._spec_slots[rid]
    assert ts == js
    np.testing.assert_array_equal(tr.spec_pos[ts].numpy(),
                                  np.asarray(jr.spec_pos[js]))
    for got, want in ((tr.spec_k, jr.spec_k), (tr.spec_v, jr.spec_v)):
        np.testing.assert_allclose(got[:, :, ts].numpy(),
                                   np.asarray(want[:, :, js]),
                                   rtol=TOL, atol=TOL)
    assert int((tr.spec_pos[ts] < 2**30).sum()) > 0


@pytest.mark.parametrize("case", sorted(CASES))
def test_catch_up_rings_match_jax(case):
    fields, calls, buckets = CASES[case]
    jeng, teng = _pair(fields)
    try:
        for rid, n, upto in calls:
            _catch_up(jeng, teng, rid, n, upto)
        for rid in {c[0] for c in calls}:
            _close_slot(jeng, teng, rid)
        train = teng.runner.ingest_train
        assert sorted(train.host_by_bucket) == buckets
        assert teng.runner.spec_ingests_total == len(calls)
    finally:
        teng.shutdown()


def test_the_clamp_bites_in_the_opt_case():
    """The opt case's positions run past tiny-opt's table: the clamp it
    holds to JAX is exercised."""
    fields = CASES["opt_clamp"][0]
    teng = ServingEngine(EngineConfig(**fields, device="cpu"))
    try:
        r = teng.runner
        assert r.spec_draft_max_pos == 512 < 600 - R
    finally:
        teng.shutdown()


def _digest_and_rings(r):
    return (r.spec_digest(),
            [t.clone() for t in (r.spec_k, r.spec_v, r.spec_pos)])


def test_a_dummy_ingest_changes_no_slot():
    """Every bucket's warm-up dispatch (length 0 into the trash slot)
    leaves the live slots' digest, and every slot's bits, the trash slot's
    included, as they were."""
    teng = ServingEngine(EngineConfig(**BASE, device="cpu"))
    try:
        r = teng.runner
        for rid, n in (("a", 30), ("b", 100)):
            r._spec_catch_up(Sequence(rid, _ids(rid, n), SamplingParams()), n)
        digest, before = _digest_and_rings(r)
        train = r.ingest_train
        assert train.buckets() == [16, 32, 64]
        for t in train.buckets():
            train.dummy_dispatch(t)
        after_digest, after = _digest_and_rings(r)
        assert after_digest == digest
        for a, b in zip(before, after):
            assert torch.equal(a, b)
    finally:
        teng.shutdown()


def test_cpu_warmup_dispatches_each_bucket_once():
    teng = ServingEngine(EngineConfig(**BASE, device="cpu"))
    try:
        r = teng.runner
        train = r.ingest_train
        seen = []
        real = train.dummy_dispatch
        train.dummy_dispatch = lambda t: seen.append(t) or real(t)
        r.warmup()
        assert seen == [16, 32, 64]
        assert train.warmed == {16, 32, 64}
        # After warm-up a catch-up on the CPU is not an eager one.
        r._spec_catch_up(Sequence("a", _ids("a", 20), SamplingParams()), 20)
        st = teng.stats()
        assert st["spec_ingest_eager_total"] == 0
        assert st["spec_ingests_total"] == 1
        assert list(st["spec_ingest_host_ms_by_bucket"]) == [32]
    finally:
        teng.shutdown()


def test_an_eager_ingest_after_warm_up_is_counted():
    """A bucket warm-up did not cover (as a graph set aside on the card)
    counts in ``spec_ingest_eager_total``; ``spec_ingests`` counts every
    catch-up."""
    teng = ServingEngine(EngineConfig(**BASE, device="cpu"))
    try:
        r = teng.runner
        r.warmup()
        r.ingest_train.warmed.discard(16)
        r._spec_catch_up(Sequence("a", _ids("a", 10), SamplingParams()), 10)
        r._spec_catch_up(Sequence("b", _ids("b", 20), SamplingParams()), 20)
        st = teng.stats()
        assert st["spec_ingest_eager_total"] == 1
        assert st["spec_ingests_total"] == r.spec_ingests_total == 2
    finally:
        teng.shutdown()


def test_a_cold_speculative_start_counts_the_jax_families():
    """A cold start with no cache directory counts every family it warmed,
    the ingest buckets included, as the JAX runner's ``n_warmed`` does: the
    JAX count less its cached-window decode twins, which the port does not
    have (the window path keeps no persistent decode window), counted from
    the JAX warm-up's own decode dispatches. The ingest buckets are the JAX
    warm-up's own."""
    fields = dict(BASE, max_num_seqs=1, max_model_len=64,
                  max_num_batched_tokens=32)
    # "" turns the JAX engine's default persistent cache off: every
    # family it warms is a miss.
    jeng = JaxEngine(JaxConfig(**fields, compilation_cache_dir=""))
    jr = jeng.runner
    assert jr.compilation_cache_path is None
    ingest_ts = []
    real = jr._spec_ingest_jit

    def counted(*args, t):
        ingest_ts.append(t)
        return real(*args, t=t)

    jr._spec_ingest_jit = counted
    # The cached-window twins are the decode dispatches the JAX warm-up
    # itself makes with ``use_cached_window``.
    cached_calls = []
    real_decode = jr._decode

    def decode_spy(*args, **kwargs):
        cached_calls.append(kwargs["use_cached_window"])
        return real_decode(*args, **kwargs)

    jr._decode = decode_spy
    jr.warmup()
    cached_twins = sum(cached_calls)
    assert cached_twins > 0
    teng = ServingEngine(EngineConfig(**fields, device="cpu",
                                      enable_warmup=True))
    try:
        r = teng.runner
        r.warmup()
        assert ingest_ts == r.ingest_train.buckets() == [16, 32, 64]
        assert r.startup_cache_miss_families == (
            len(r.decode_graph_keys()) + len(r.prefill_graph_keys())
            + len(ingest_ts))
        assert r.startup_cache_miss_families == \
            jr.startup_cache_miss_families - cached_twins
        assert r.startup_deferred_families == 0
    finally:
        teng.shutdown()
