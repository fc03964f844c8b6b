"""The OPT family at tensor parallelism in the PyTorch port against the JAX
package's.

Everything runs on the CPU in float32 on ``tiny-opt`` (D 64, 2 heads of
32, F 128): the port's ranks are gloo processes spawned by the engine, the
JAX package shards over the conftest's 8 host devices. The checks:
  * each rank's ``shard_params`` of the JAX tree (and ``params_from_jax``
    at that rank) equals, bit for bit, the addressable shard on device r of
    ``jax.device_put(params, param_shardings(...))``, at tp 2 and at tp 4
    (where ``wq``'s 16-column slices end mid-head); a seeded init at tp > 1
    keeps the ranks' slices of the tp = 1 draw; each rank's ``TPPlan``
    reduces exactly the products whose leaves are split;
  * the sharded forward and tied head (ranks as threads): every rank's
    teacher-forced logits are bit-identical and within 1e-4 of tp = 1's;
  * engines: greedy tokens at tp 2, tp 4 (the fallback: the 2 heads cut
    mid-head, the pool replicated) and tp 2 x sp 2 equal the JAX engine's
    on the same mesh; ranks of one tp rank hold equal pools;
  * an OPT checkpoint written as an HF directory loads at tp 2 and 4 to
    the shards of its tp = 1 load;
  * an OPT block blob written at tp 2 or 4 restores bit for bit at tp 1.
The tests run with one intra-op thread (the ranks share this machine's
cores; a worker runs with rank 0's thread count).
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.opt import init_params as jax_opt_init
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu.parallel.sharding import param_shardings
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.kv_offload import serde
from production_stack_tpu_torch.models import opt
from production_stack_tpu_torch.models.config import (
    ModelConfig,
    resolve_model_config,
)
from production_stack_tpu_torch.models.tp_plan import tp_plan
from production_stack_tpu_torch.models.weights import (
    load_hf_params,
    params_from_jax,
)
from production_stack_tpu_torch.parallel.sharding import shard_params
from tests.test_torch_parallel import (
    _get,
    _leaves,
    _shard_on,
    _thread_ranks,
)
from tests.test_torch_sp import PROMPTS, LONG_PROMPT, _check_replicas, _generate_all

MODEL = "tiny-opt"
TIMEOUT_S = 120.0
LOGIT_TOL = 1e-4   # f32 logits at tp > 1 against tp = 1: summation order
COMMON = dict(model=MODEL, max_model_len=512, num_kv_blocks=256,
              num_decode_steps=4, dtype="float32", max_num_batched_tokens=128)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_params():
    """The JAX init, with every bias and layer-norm leaf (zeros and ones
    there) drawn from a seeded numpy generator, so that a replicated bias
    counted once per rank, or a split one misplaced, shows."""
    params = jax_opt_init(jax_resolve(MODEL), jax.random.PRNGKey(0),
                          jnp.float32)
    rng = np.random.default_rng(5)

    def draw(leaf, base):
        return jnp.asarray(base + 0.1 * rng.standard_normal(leaf.shape),
                           jnp.float32)

    layers = dict(params["layers"])
    for name in ("bq", "bk", "bv", "bo", "fc1_b", "fc2_b", "ln1_b", "ln2_b"):
        layers[name] = draw(layers[name], 0.0)
    for name in ("ln1_w", "ln2_w"):
        layers[name] = draw(layers[name], 1.0)
    return dict(params, layers=layers,
                final_ln_w=draw(params["final_ln_w"], 1.0),
                final_ln_b=draw(params["final_ln_b"], 0.0))


def _np_tree():
    return jax.tree.map(np.asarray, _jax_params())


def _port_params():
    return params_from_jax(_np_tree(), resolve_model_config(MODEL),
                           torch.float32)


# ------------------------------------------------------------------ sharding
@pytest.mark.parametrize("tp", [2, 4])
def test_opt_shards_equal_jax_addressable_shards(tp):
    """Every leaf of the OPT tree, every rank: ``fc1`` / ``fc1_b`` split by
    columns, ``fc2`` by rows, ``embed`` and ``pos_embed`` on D, ``bo``,
    ``fc2_b`` and the layer norms replicated, as the JAX package places
    them."""
    jmc, mc = jax_resolve(MODEL), resolve_model_config(MODEL)
    jparams = _jax_params()
    mesh = make_mesh(tp=tp)
    placed = jax.device_put(jparams, param_shardings(jmc, mesh, jparams))
    np_tree = jax.tree.map(np.asarray, jparams)
    full = params_from_jax(np_tree, mc, torch.float32)
    devices = mesh.devices.reshape(-1)
    for r in range(tp):
        mine = shard_params(full, mc, r, tp)
        direct = params_from_jax(np_tree, mc, torch.float32, rank=r, tp=tp)
        for path, leaf in _leaves(mine):
            want = _shard_on(_get(placed, path), devices[r])
            np.testing.assert_array_equal(leaf.numpy(), want, err_msg=str(path))
            np.testing.assert_array_equal(_get(direct, path).numpy(), want)
        layers = mine["layers"]
        assert layers["fc1"].shape[-1] == mc.intermediate_size // tp
        assert layers["fc2"].shape[-2] == mc.intermediate_size // tp
        assert mine["pos_embed"].shape[-1] == mc.hidden_size // tp
        assert layers["fc2_b"].shape[-1] == layers["bo"].shape[-1] == \
            mc.hidden_size


@pytest.mark.parametrize("tp", [2, 4])
def test_opt_init_and_empty_params_are_the_tp1_shards(tp):
    """A seeded init at tp > 1 keeps each rank's slice of the tp = 1 draw
    (the ranks together hold the tp = 1 engine's weights), and
    ``empty_params`` allocates the shards' shapes."""
    mc = resolve_model_config(MODEL)
    full = opt.init_params(mc, torch.Generator().manual_seed(3),
                           torch.float32, CPU)
    for r in range(tp):
        got = opt.init_params(mc, torch.Generator().manual_seed(3),
                              torch.float32, CPU, rank=r, tp=tp)
        want = shard_params(full, mc, r, tp)
        empty = opt.empty_params(mc, torch.float32, CPU, rank=r, tp=tp)
        for path, leaf in _leaves(want):
            assert torch.equal(_get(got, path), leaf), path
            assert _get(empty, path).shape == leaf.shape, path


@pytest.mark.parametrize("tp", [2, 4])
def test_opt_tp_plan_follows_the_shard_shapes(tp):
    """The plan of each rank reads OPT's leaves: ``mlp_reduce`` where
    ``fc2`` is split, ``embed_split`` where ``embed`` (and ``pos_embed``)
    are, the tied head split with them; at tp 4 the rank's ``wq`` columns
    end mid-head (``q_gather``) and the pool is replicated (``kv_gather``),
    each rank's ``wo`` rows taking its columns of the heads' output."""
    mc = resolve_model_config(MODEL)
    full = opt.empty_params(mc, torch.float32, torch.device("meta"))
    dh = mc.head_dim_
    for r in range(tp):
        plan = tp_plan(mc, types.SimpleNamespace(size=tp, rank=r))
        mine = opt.empty_params(mc, torch.float32, torch.device("meta"),
                                rank=r, tp=tp)
        lay, whole = mine["layers"], full["layers"]
        assert plan.mlp_reduce == (lay["fc2"].shape[-2] < whole["fc2"].shape[-2])
        assert plan.embed_split == (mine["embed"].shape[-1]
                                    < full["embed"].shape[-1])
        assert plan.embed_split == (mine["pos_embed"].shape[-1]
                                    < full["pos_embed"].shape[-1])
        assert plan.tied and plan.head_split == plan.embed_split
        o0, o1 = plan.o_cols
        assert o1 - o0 == lay["wo"].shape[-2]
        cols = lay["wq"].shape[-1]
        assert (plan.h1 - plan.h0) * dh >= cols
        assert plan.q_gather == (tp == 4) and plan.kv_gather == (tp == 4)


def _forward_logits(params, mc, toks, tp=None):
    b, t = toks.shape
    pos = torch.arange(t)[None].repeat(b, 1)
    h, k, v = opt.forward(params, mc, toks, pos, torch.full((b,), t), tp=tp)
    return opt.compute_logits(params, mc, h, opt.lm_head_f32(params, mc),
                              tp=tp), k


@pytest.mark.parametrize("tp", [2, 4])
def test_opt_sharded_forward_matches_tp1_teacher_forced(tp):
    """The sharded forward and tied head, ranks as threads, the JAX tree's
    weights: every rank's logits are bit-identical and within 1e-4 of tp =
    1's; the new K/V each rank returns are its pool's heads of tp = 1's
    (its own head where tp divides the heads, all of them where the pool
    is replicated)."""
    mc = resolve_model_config(MODEL)
    full = _port_params()
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, mc.vocab_size, (2, 24)))
    want, k_full = _forward_logits(full, mc, toks)
    got = _thread_ranks(lambda r, g: _forward_logits(
        shard_params(full, mc, r, tp), mc, toks, g), tp)
    for logits, _ in got[1:]:
        assert torch.equal(logits, got[0][0])
    torch.testing.assert_close(got[0][0], want, rtol=0, atol=LOGIT_TOL)
    for r, (_, k) in enumerate(got):
        heads = (k_full[:, r:r + 1] if tp == mc.num_heads else k_full)
        torch.testing.assert_close(k, heads, rtol=0, atol=LOGIT_TOL)


# ------------------------------------------------------------------ engines
async def _jax_tokens(prompts, max_tokens=16, **mesh):
    eng = JaxEngine(JaxConfig(**COMMON, **mesh), params=_jax_params())
    await eng.start()
    try:
        return await _generate_all(eng, JaxSampling, prompts, max_tokens)
    finally:
        await eng.stop()


async def _port_run(prompts, max_tokens=16, **mesh):
    eng = ServingEngine(EngineConfig(**COMMON, **mesh, device="cpu",
                                     tp_timeout_s=TIMEOUT_S),
                        params=_port_params())
    try:
        await eng.start()
        try:
            toks = await _generate_all(eng, SamplingParams, prompts,
                                       max_tokens)
            reports = (await eng.rank_reports(pool_digest=True)
                       if eng.mesh is not None else None)
        finally:
            await eng.stop()
    finally:
        eng.shutdown()
    return toks, reports, eng


MESHES = {"tp2": dict(tensor_parallel_size=2),
          "tp4": dict(tensor_parallel_size=4),
          "tp2-sp2": dict(tensor_parallel_size=2, sequence_parallel_size=2)}


@pytest.mark.parametrize("case", list(MESHES))
async def test_opt_engine_tokens_match_jax_on_the_same_mesh(case):
    """Greedy tokens of the reference's prompts and a two-chunk prompt
    equal the JAX engine's on the same mesh, exactly; the window path
    serves; the pool splits its heads at tp 2 and is replicated at tp 4;
    ranks of one tp rank hold equal pools and sampled the same tokens."""
    mesh = MESHES[case]
    prompts = PROMPTS + [LONG_PROMPT]
    want = await _jax_tokens(prompts, **mesh)
    got, reports, eng = await _port_run(prompts, **mesh)
    assert got == want and all(len(t) == 16 for t in got)
    mc = resolve_model_config(MODEL)
    tp = mesh["tensor_parallel_size"]
    assert eng.runner.attn_impl == "window"
    assert eng.runner.kv_k.shape[1] == (mc.num_heads // tp
                                        if mc.num_heads % tp == 0
                                        else mc.num_heads)
    _check_replicas(reports, sp=mesh.get("sequence_parallel_size", 1), tp=tp)
    # The reference rings the llama family only: no OPT chunk rang.
    assert all(not r["rings"] or not any(r["rings"].values())
               for r in reports)


# --------------------------------------------------------------- checkpoint
@pytest.mark.parametrize("tp", [2, 4])
def test_opt_checkpoint_loads_at_tp_to_the_shards_of_its_tp1_load(tmp_path, tp):
    """An OPT checkpoint saved by transformers (an HF directory of
    safetensors) loads at tp > 1 to each rank's ``shard_params`` of its
    tp = 1 load, bit for bit, every leaf present."""
    from tests.test_torch_checkpoint import _hf_model

    model = _hf_model("opt")
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = ModelConfig.from_pretrained_dir(str(tmp_path))
    assert cfg.arch == "opt"
    full = load_hf_params(cfg, str(tmp_path), torch.float32, CPU)
    for rank in range(tp):
        got = load_hf_params(cfg, str(tmp_path), torch.float32, CPU,
                             rank=rank, tp=tp)
        want = shard_params(full, cfg, rank, tp)
        assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
        for path, leaf in _leaves(want):
            assert torch.equal(_get(got, path), leaf), path


# ----------------------------------------------------------------- KV tier
@pytest.mark.parametrize("tp", [2, 4])
async def test_opt_blocks_served_at_tp_restore_bit_for_bit_at_tp1(tp):
    """A tp > 1 OPT engine serves a prompt; the blocks it wrote read back
    as whole blocks (every head), pack into blobs, and restore bit for bit
    into a tp = 1 runner (read back and packed again: the same blobs). The
    tp = 1 engine serving the same prompt holds the same blocks, and its
    embeddings (every rank's ``EMBED`` forward) equal tp's, within f32
    summation order."""
    cfg = dict(COMMON, block_size=16)
    mc = resolve_model_config(MODEL)
    blocks = list(range(1, 5))

    async def serve(**mesh):
        eng = ServingEngine(EngineConfig(**cfg, **mesh, device="cpu",
                                         tp_timeout_s=TIMEOUT_S),
                            params=_port_params())
        try:
            await eng.start()
            try:
                toks = await _generate_all(eng, SamplingParams, [LONG_PROMPT],
                                           8)
                return (toks, eng.runner.read_blocks(blocks),
                        eng.runner.embed([[5, 6, 7, 8, 9], [10, 11]]))
            finally:
                await eng.stop()
        finally:
            eng.shutdown()

    toks_tp, arrays, emb_tp = await serve(tensor_parallel_size=tp)
    toks_1, arrays_1, emb_1 = await serve()
    assert toks_tp == toks_1
    np.testing.assert_allclose(emb_tp, emb_1, rtol=0, atol=LOGIT_TOL)
    k, v = arrays[:2]
    assert k.shape == (len(blocks), mc.num_layers, mc.num_kv_heads, 16,
                       mc.head_dim_)
    blobs = [serde.pack_block(k[i], v[i]) for i in range(len(blocks))]
    r1 = ModelRunner(EngineConfig(**cfg, device="cpu"), mc)
    again = [7, 9, 11, 13]
    parts = [serde.unpack_block(b) for b in blobs]
    r1.write_blocks(again, np.stack([p[0] for p in parts]),
                    np.stack([p[1] for p in parts]))
    back = r1.read_blocks(again)
    assert [serde.pack_block(back[0][i], back[1][i])
            for i in range(len(again))] == blobs
    for got, want in zip(arrays[:2], arrays_1[:2]):
        np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL)
