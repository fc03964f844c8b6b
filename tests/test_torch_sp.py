"""Sequence parallelism, data parallelism and the replication fallback in
the PyTorch port against the JAX package's.

Everything runs on the CPU in float32: the port's ranks are processes of
``torch.distributed`` over gloo (rank 0 in this process, the workers spawned
by the engine through the port's own launcher, without jax); the JAX
package lays its (dp, sp, tp) mesh over the conftest's 8 host devices. The
checks:
  * the ring op: the port's plain ring (``ring_attention`` /
    ``ring_attention_kv``, sp 2 and 4) against the JAX functions within
    2e-4 (the JAX test's tolerance), with window slots at the sentinel
    position; the distributed ring over 2 gloo ranks against the plain
    ring bit for bit, with sp - 1 exchanges per call;
  * engines (tiny-llama-8kv, ``max_num_batched_tokens`` 128): greedy tokens
    at sp = 2 equal the JAX engine's at sp = 2, with first-chunk and
    continuation rings seen on rank 0; tp = 2 x sp = 2 and dp = 2 equal the
    port at tp = 1; dp = 2 x sp = 2 x tp = 2 equals the JAX engine's; the
    ranks' pools equal those of their (0, 0, t) twins; ``/metrics`` shows
    the sp degree;
  * the fallback: tiny-llama at tp = 4 (kv heads replicated),
    tiny-llama-128dh at tp = 3 (every split dim indivisible) and at tp = 4
    (q split mid-head) against the JAX engine at the same tp;
  * the KV tier at sp = 2: whole blocks read back as a tp = 1 runner's
    bytes, every replica's pool holding them; a host-pool restore serves
    its twin's tokens.
The tests run with one intra-op thread (the ranks share this machine's
cores; a worker runs with rank 0's thread count).
"""

import asyncio
import pathlib
import sys

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
from production_stack_tpu.ops import ring_attention as jring
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.ops import ring_attention as ring
from production_stack_tpu_torch.parallel.mesh import RankMesh
from production_stack_tpu_torch.server.metrics import render_engine_metrics
from tests.test_torch_kv_offload import _arrays, _spilled

TOL = 2e-4
TIMEOUT_S = 120.0
# The reference's three prompts (tests/test_parallel_parity.py) and its
# ~300-token prompt, which a 128-token budget prefills in >= 2 chunks.
PROMPTS = [
    "the quick brown fox jumps over the lazy dog and keeps running " * 3,
    "pack my box with five dozen liquor jugs while the band plays on " * 2,
    "sphinx of black quartz judge my vow said the typesetter quietly",
]
LONG_PROMPT = " ".join(f"ctx{i}" for i in range(48))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- ring op
def _ring_inputs(seed, b=2, s=32, h=4, hkv=2, dh=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, dh), (b, s, hkv, dh), (b, s, hkv, dh)))
    return q, k, v


def _window_inputs(seed, b=2, s_win=32, t=32, hkv=2, dh=16):
    """A continuation chunk's ring inputs: t queries after a window of
    s_win slots whose rows hold win_len valid slots (the rest at the
    sentinel position), then the chunk's own keys."""
    rng = np.random.default_rng(seed)
    win_len = np.asarray([20, s_win], np.int32)
    k, v = (rng.standard_normal((b, s_win + t, hkv, dh)).astype(np.float32)
            for _ in range(2))
    slots = np.arange(s_win, dtype=np.int32)
    pos_w = np.where(slots[None] < win_len[:, None], slots[None],
                     ring.WINDOW_SENTINEL).astype(np.int32)
    q_pos = (win_len[:, None] + np.arange(t, dtype=np.int32)[None]).astype(np.int32)
    kv_pos = np.concatenate([pos_w, q_pos], axis=1)
    return k, v, q_pos, kv_pos


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_matches_jax_ring_attention(sp):
    mesh = make_mesh(dp=1, sp=sp, tp=1, devices=jax.devices()[:sp])
    q, k, v = _ring_inputs(0)
    pos = np.tile(np.arange(q.shape[1], dtype=np.int32)[None], (q.shape[0], 1))
    want = np.asarray(jring.ring_attention(*map(jnp.asarray, (q, k, v, pos)),
                                           mesh))
    got = ring.ring_attention(*map(torch.from_numpy, (q, k, v, pos)), sp)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_kv_matches_jax_with_sentinel_window_slots(sp):
    mesh = make_mesh(dp=1, sp=sp, tp=1, devices=jax.devices()[:sp])
    q = _ring_inputs(1)[0]
    k, v, q_pos, kv_pos = _window_inputs(2)
    want = np.asarray(jring.ring_attention_kv(
        *map(jnp.asarray, (q, q_pos, k, v, kv_pos)), mesh))
    got = ring.ring_attention_kv(
        *map(torch.from_numpy, (q, q_pos, k, v, kv_pos)), sp)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


# One rank of the distributed ring: builds the tests' inputs from their
# seeds, runs its shard of both ring kinds and reports its outputs' bytes
# and the ring's exchange count to rank 0.
_RING_RANK = r"""
import sys, torch
torch.set_num_threads(1)
sys.path.insert(0, {root!r})
from tests.test_torch_sp import ring_rank_outputs
from production_stack_tpu_torch.parallel.mesh import RankMesh
mesh = RankMesh.join(int(sys.argv[1]), 1, 2, 1, int(sys.argv[2]),
                     torch.device("cpu"), {timeout!r})
try:
    mesh.gather_object(ring_rank_outputs(mesh.sp))
finally:
    mesh.close()
"""


def ring_rank_outputs(sp_ring):
    """This rank's distributed ring outputs of the two ring tests' inputs
    (numpy, first chunk then continuation) and its exchange count."""
    n = sp_ring.size
    s = sp_ring.rank
    q, k, v = _ring_inputs(0)
    pos = np.tile(np.arange(q.shape[1], dtype=np.int32)[None], (q.shape[0], 1))
    part = slice(s * q.shape[1] // n, (s + 1) * q.shape[1] // n)
    t = torch.from_numpy
    first = ring.ring_attention_shard(
        t(q[:, part]), t(pos[:, part]), t(k[:, part]), t(v[:, part]),
        t(pos[:, part]), sp_ring, "first")
    q2 = _ring_inputs(1)[0]
    k2, v2, q_pos, kv_pos = _window_inputs(2)
    kpart = slice(s * k2.shape[1] // n, (s + 1) * k2.shape[1] // n)
    cont = ring.ring_attention_shard(
        t(q2[:, part]), t(q_pos[:, part]), t(k2[:, kpart]), t(v2[:, kpart]),
        t(kv_pos[:, kpart]), sp_ring, "continuation")
    return {"first": first.numpy(), "continuation": cont.numpy(),
            "exchanges": sp_ring.exchanges, "rings": dict(sp_ring.rings)}


def test_distributed_ring_equals_plain_ring_bit_for_bit():
    """Two gloo ranks (this process and a worker) run the ring of both
    kinds: each rank's output equals the plain ring's rows of its shard
    bit for bit (the same arithmetic in the same order), and each call
    made sp - 1 = 1 exchange."""
    root = str(pathlib.Path(__file__).resolve().parents[1])
    code = _RING_RANK.format(root=root, timeout=TIMEOUT_S)
    mesh = RankMesh.launch(1, 2, 1, torch.device("cpu"), TIMEOUT_S,
                           lambda r, port: [sys.executable, "-c", code, str(r),
                                            str(port)])
    try:
        reports = mesh.gather_object(ring_rank_outputs(mesh.sp))
    finally:
        mesh.close()
    q, k, v = _ring_inputs(0)
    pos = np.tile(np.arange(q.shape[1], dtype=np.int32)[None], (q.shape[0], 1))
    first = ring.ring_attention(*map(torch.from_numpy, (q, k, v, pos)), 2)
    q2 = _ring_inputs(1)[0]
    k2, v2, q_pos, kv_pos = _window_inputs(2)
    cont = ring.ring_attention_kv(
        *map(torch.from_numpy, (q2, q_pos, k2, v2, kv_pos)), 2)
    for s, rep in enumerate(reports):
        part = slice(s * 16, (s + 1) * 16)
        assert rep["first"].tobytes() == first[:, part].contiguous().numpy().tobytes()
        assert rep["continuation"].tobytes() == \
            cont[:, part].contiguous().numpy().tobytes()
        assert rep["exchanges"] == 2 and rep["rings"] == {"first": 1,
                                                          "continuation": 1}


# ----------------------------------------------------------------- engines
MODEL = "tiny-llama-8kv"
COMMON = dict(model=MODEL, max_model_len=512, num_kv_blocks=256,
              num_decode_steps=4, dtype="float32", max_num_batched_tokens=128)


def _jax_params(model=MODEL):
    return jax_init(jax_resolve(model), jax.random.PRNGKey(0), jnp.float32)


def _port_params(model=MODEL):
    return params_from_jax(jax.tree.map(np.asarray, _jax_params(model)),
                           resolve_model_config(model), torch.float32)


async def _generate_all(engine, sampling_cls, prompts, max_tokens=16):
    async def one(p):
        toks = []
        async for o in engine.generate(prompt=p, sampling=sampling_cls(
                temperature=0.0, max_tokens=max_tokens, ignore_eos=True)):
            toks = o.token_ids
        return toks

    return await asyncio.gather(*[one(p) for p in prompts])


async def _jax_tokens(prompts, max_tokens=16, common=COMMON, **mesh):
    eng = JaxEngine(JaxConfig(**common, **mesh),
                    params=_jax_params(common["model"]))
    await eng.start()
    try:
        return await _generate_all(eng, JaxSampling, prompts, max_tokens)
    finally:
        await eng.stop()


async def _port_run(prompts, max_tokens=16, common=COMMON, spy=None, **mesh):
    """The port's tokens of ``prompts`` and every rank's report (pool
    digests included) after serving them; its stats and /metrics text."""
    if any(v > 1 for v in mesh.values()):
        mesh = dict(mesh, tp_timeout_s=TIMEOUT_S)
    eng = ServingEngine(EngineConfig(**common, **mesh, device="cpu"),
                        params=_port_params(common["model"]))
    try:
        await eng.start()
        try:
            toks = await _generate_all(eng, SamplingParams, prompts, max_tokens)
            reports = (await eng.rank_reports(pool_digest=True)
                       if eng.mesh is not None else None)
            st = eng.stats()
            text = render_engine_metrics(eng, common["model"])
        finally:
            await eng.stop()
    finally:
        eng.shutdown()
    return toks, reports, st, text, eng


def _check_replicas(reports, sp=1, tp=1, dp=1):
    """Every rank reports its grid point; ranks of one tp rank hold equal
    pools and sampled the same tokens; every rank ran every dispatch."""
    coords = [tuple(r["coords"]) for r in reports]
    assert coords == [(d, s, t) for d in range(dp) for s in range(sp)
                      for t in range(tp)]
    for t in range(tp):
        twins = [r for r in reports if r["coords"][2] == t]
        assert len({r["pool_digest"] for r in twins}) == 1, twins
    assert len({r["token_digest"] for r in reports}) == 1
    assert len({r["dispatches"] for r in reports}) == 1


async def test_sp2_matches_jax_sp2_and_rings_every_chunk(monkeypatch):
    """sp = 2: the reference's three prompts and its ~300-token prompt
    (two 128-token chunks and a tail), greedy tokens equal the JAX
    engine's at sp = 2; rank 0 rang first chunks and continuation chunks
    (a spy on the ring op, and the ring's own counts); both ranks' pools
    are equal; ``/metrics`` reads the sp degree."""
    calls = {"first": 0, "continuation": 0}
    orig = ring.ring_attention_shard

    def spy(*a, **kw):
        calls[a[6]] += 1
        return orig(*a, **kw)

    monkeypatch.setattr(ring, "ring_attention_shard", spy)
    prompts = PROMPTS + [LONG_PROMPT]
    want = await _jax_tokens(prompts, sequence_parallel_size=2)
    got, reports, st, text, _ = await _port_run(prompts,
                                                sequence_parallel_size=2)
    assert got == want and all(len(t) == 16 for t in got)
    assert calls["first"] > 0 and calls["continuation"] > 0, calls
    assert reports[0]["rings"] == calls == reports[1]["rings"]
    _check_replicas(reports, sp=2)
    assert (st["mesh_sp_size"], st["mesh_tp_size"], st["mesh_devices"]) == (2, 1, 2)
    assert 'pstpu:mesh_sp_size{model_name="tiny-llama-8kv"} 2' in text
    assert 'pstpu:mesh_devices{model_name="tiny-llama-8kv"} 2' in text


@pytest.mark.parametrize("mesh", [dict(tensor_parallel_size=2,
                                       sequence_parallel_size=2),
                                  dict(data_parallel_size=2)],
                         ids=["tp2-sp2", "dp2"])
async def test_mesh_tokens_match_the_port_at_tp1(mesh):
    """tp = 2 x sp = 2 (rings inside each tp rank's ring, tp collectives
    inside each sp rank's group) and dp = 2 (two replicas): greedy tokens
    equal the port's at tp = 1; replicas of one tp rank hold equal pools."""
    prompts = PROMPTS + [LONG_PROMPT]
    want, *_ = await _port_run(prompts)
    got, reports, st, *_ = await _port_run(prompts, **mesh)
    assert got == want
    _check_replicas(reports, sp=mesh.get("sequence_parallel_size", 1),
                    tp=mesh.get("tensor_parallel_size", 1),
                    dp=mesh.get("data_parallel_size", 1))
    assert st["mesh_devices"] == len(reports)


async def test_dp2_sp2_tp2_matches_jax():
    """Every axis > 1, 8 ranks: greedy tokens equal the JAX engine's on
    the same (dp, sp, tp) mesh; rings on every (d, t) ring."""
    mesh = dict(data_parallel_size=2, sequence_parallel_size=2,
                tensor_parallel_size=2)
    want = await _jax_tokens(PROMPTS, 8, **mesh)
    got, reports, *_ = await _port_run(PROMPTS, 8, **mesh)
    assert got == want
    _check_replicas(reports, sp=2, tp=2, dp=2)
    assert all(r["rings"]["first"] > 0 for r in reports)


# ------------------------------------------------------------ the fallback
FALLBACK = {"tiny-llama-tp4": ("tiny-llama", 4),
            "tiny-llama-128dh-tp3": ("tiny-llama-128dh", 3),
            "tiny-llama-128dh-tp4": ("tiny-llama-128dh", 4)}


@pytest.mark.parametrize("case", list(FALLBACK))
async def test_fallback_tp_matches_jax(case):
    """tiny-llama at tp = 4 (4 query heads split one per rank, its 2 kv
    heads replicated with a split wk / wv gathered; window path),
    tiny-llama-128dh at tp = 3 (every split dim indivisible: all leaves
    replicated, no collective) and at tp = 4 (wq's 64-column slices end
    mid-head: q gathered): greedy tokens equal the JAX engine's at the
    same tp; every rank holds the whole pool, all equal."""
    model, tp = FALLBACK[case]
    common = dict(COMMON, model=model)
    mc = resolve_model_config(model)
    want = await _jax_tokens(PROMPTS, common=common, tensor_parallel_size=tp)
    got, reports, st, _, eng = await _port_run(PROMPTS, common=common,
                                               tensor_parallel_size=tp)
    assert got == want
    assert eng.runner.attn_impl == "window"
    assert eng.runner.kv_k.shape[1] == mc.num_kv_heads
    assert len({r["pool_digest"] for r in reports}) == 1
    _check_replicas(reports, tp=tp)


# ----------------------------------------------------------- the KV tier
BLOCKS = [3, 7, 11, 2, 9]


def test_sp2_blocks_are_whole_in_every_replica():
    """An sp = 2 engine seeded through ``write_blocks`` (each replica takes
    the blob) reads back the same bytes, which equal a tp = 1 runner's
    holding the same contents; both sp ranks' pools are equal."""
    cfg = dict(model=MODEL, dtype="bfloat16", max_model_len=128, block_size=4,
               num_kv_blocks=16, max_num_seqs=4, max_num_batched_tokens=64)
    mc = resolve_model_config(MODEL)
    shape = (len(BLOCKS), mc.num_layers, mc.num_kv_heads, 4, mc.head_dim_)
    port_in, _ = _arrays("bfloat16", shape, seed=11)
    eng = ServingEngine(EngineConfig(**cfg, device="cpu",
                                     sequence_parallel_size=2,
                                     tp_timeout_s=TIMEOUT_S))
    try:
        eng.runner.write_blocks(BLOCKS, *port_in)
        got = eng.runner.read_blocks(BLOCKS)
        reports = eng.runner.tp_query(pool_digest=True)
    finally:
        eng.shutdown()
    r1 = ModelRunner(EngineConfig(**cfg, device="cpu"), mc)
    r1.write_blocks(BLOCKS, *port_in)
    want = r1.read_blocks(BLOCKS)
    assert [a.tobytes() for a in got[:2]] == [a.tobytes() for a in want[:2]]
    assert [a.tobytes() for a in got[:2]] == [a.tobytes() for a in port_in[:2]]
    assert reports[0]["pool_digest"] == reports[1]["pool_digest"] == \
        r1.pool_digest()


async def test_sp2_host_pool_restore_serves_the_twin_tokens():
    """An sp = 2 engine with the host tier serves a long prompt cold (rung
    chunks), spills its full blocks, drops its device prefix cache and
    serves it again restored from the host pool: tokens equal the cold
    ones, blocks were restored, and both ranks' pools stay equal."""
    eng = ServingEngine(EngineConfig(
        **COMMON, device="cpu", sequence_parallel_size=2,
        tp_timeout_s=TIMEOUT_S, kv_offload_cpu=True,
        kv_offload_max_cpu_gb=0.5), params=_port_params())
    eng.offload.flush_interval = 0.02
    try:
        await eng.start()
        try:
            cold = await _generate_all(eng, SamplingParams, [LONG_PROMPT], 8)
            await _spilled(eng, eng.block_manager.prefix_index_size)
            eng.block_manager.reset_prefix_cache()
            again = await _generate_all(eng, SamplingParams, [LONG_PROMPT], 8)
            restored = eng.offload.restored_tokens_total
            reports = await eng.rank_reports(pool_digest=True)
        finally:
            await eng.stop()
    finally:
        eng.shutdown()
    assert again == cold and len(cold[0]) == 8
    assert restored >= 16 * 16
    assert reports[0]["pool_digest"] == reports[1]["pool_digest"]


# --------------------------------------------------------------- refusals
def test_mesh_config_refusals_name_the_flags():
    """The reference's refusals on a mesh (speculation at sp > 1, int8 KV
    with heads tp does not divide), each naming its flags, and no other:
    speculation at dp > 1 and an OPT model at tp > 1 build, as in the
    reference; an OPT model at sp or dp > 1 builds, its prefill unrung."""
    spec = dict(speculative_num_tokens=2, speculative_model="tiny-llama")
    with pytest.raises(ValueError, match=r"--sequence-parallel-size > 1"):
        EngineConfig(model="tiny-llama", sequence_parallel_size=2, **spec)
    cfg = EngineConfig(model="tiny-llama", data_parallel_size=2, **spec)
    assert cfg.mesh_devices == 2 and cfg.speculative_enabled
    with pytest.raises(ValueError, match=r"int8 with --tensor-parallel-size 3"):
        EngineConfig(model="tiny-llama-8kv", kv_cache_dtype="int8",
                     tensor_parallel_size=3)
    for tp in (2, 4):
        cfg = EngineConfig(model="tiny-opt", device="cpu",
                           tensor_parallel_size=tp)
        assert cfg.mesh_devices == tp
    cfg = EngineConfig(model="tiny-opt", device="cpu", sequence_parallel_size=2,
                       data_parallel_size=2)
    assert cfg.mesh_devices == 4
    assert cfg.kv_cache_bytes_per_token(resolve_model_config("tiny-opt")) == \
        cfg.kv_wire_bytes_per_token(resolve_model_config("tiny-opt"))
