"""LoRA serving in the PyTorch port against the JAX package's
(``tests/test_lora.py``'s bar, and parity with the JAX engine).

Adapters are PEFT checkpoint directories the test writes (random A and B
from a numpy seed, f32 and bf16 safetensors), registered in both engines
through ``lora_modules`` and read by each package's own loader. Engines
serve tiny-llama in float32 on the CPU over the JAX engine's weights; the
JAX side keeps its registry in bf16 (its engine's default), and so does
the port. Tokens must be equal, greedy and seeded, in a batch that mixes
the base model and two adapters, with speculation on, and after a prefix
spilled under an adapter by the JAX engine is restored from the shared
store. The port's server answers /v1/models and an unknown model as the
JAX server does.
"""

import asyncio
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.kv_cache import _block_hash as jax_block_hash
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.engine.scheduler import Sequence as JaxSequence
from production_stack_tpu.models import lora as jlora
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.kv_cache import _block_hash
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.scheduler import Sequence
from production_stack_tpu_torch.models import lora as tlora
from production_stack_tpu_torch.models import opt as topt
from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.server.api_server import (
    OpenAIServer,
    _parse_lora_modules,
    config_from_args,
    parse_args,
)
from tests.test_torch_surface import _http

MODEL = "tiny-llama"
MC = resolve_model_config(MODEL)
BASE = dict(model=MODEL, max_model_len=256, block_size=4, num_kv_blocks=128,
            max_num_seqs=8, max_num_batched_tokens=64, attn_impl="window",
            dtype="float32", num_decode_steps=4)
GREEDY = dict(temperature=0.0, max_tokens=12, ignore_eos=True)
SEEDED = dict(temperature=0.9, seed=1234, max_tokens=12, ignore_eos=True)
PROMPT = "the quick brown fox jumps over the lazy dog"


def write_adapter(path, cfg, rank, targets, seed, alpha, dtype=torch.float32,
                  scale=3.0):
    """A PEFT adapter directory: random A [r, in] and B [out, r] per layer
    and target from a numpy seed (B scaled so the adapter moves tokens)."""
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    tensors = {}
    for li in range(cfg.num_layers):
        for target in targets:
            din, dout = tlora._target_dims(cfg, target)
            mod = tlora.TARGET_TO_PEFT[target]
            grp = "mlp" if target.startswith("w_") else "self_attn"
            pre = f"base_model.model.model.layers.{li}.{grp}.{mod}"
            a = rng.standard_normal((rank, din)) * din ** -0.5
            b = rng.standard_normal((dout, rank)) * scale * rank ** -0.5
            tensors[f"{pre}.lora_A.weight"] = torch.from_numpy(a).to(dtype)
            tensors[f"{pre}.lora_B.weight"] = torch.from_numpy(b).to(dtype)
    safetensors_io.save_file(tensors, os.path.join(path, "adapter_model.safetensors"))
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": alpha,
                   "target_modules": [tlora.TARGET_TO_PEFT[t] for t in targets]}, f)
    return str(path)


ALL7 = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


@pytest.fixture(scope="module")
def adapters(tmp_path_factory):
    d = tmp_path_factory.mktemp("adapters")
    return {
        "a": write_adapter(d / "a", MC, 4, ("wq", "wv"), 1, alpha=8),
        "b": write_adapter(d / "b", MC, 8, ALL7, 2, alpha=16,
                           dtype=torch.bfloat16),
    }


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(adapters, **over):
    """A JAX engine and a port engine (CPU) over the same f32 weights, with
    the same two adapters registered from disk."""
    fields = dict(BASE, **over, lora_modules=dict(adapters))
    jeng = JaxEngine(JaxConfig(**fields))
    params = params_from_jax(_np_tree(jeng.runner.params), MC, torch.float32)
    teng = ServingEngine(EngineConfig(**fields, device="cpu"), params=params)
    return jeng, teng


@pytest.fixture(scope="module")
def engines(adapters):
    loop = asyncio.new_event_loop()
    jeng, teng = _pair(adapters)
    for e in (jeng, teng):
        loop.run_until_complete(e.start())
    yield jeng, teng, loop
    for e in (jeng, teng):
        loop.run_until_complete(e.stop())
    teng.shutdown()
    loop.close()


async def _gen(engine, adapter, sampling, prompt=PROMPT, rid=None):
    toks = []
    async for o in engine.generate(prompt=prompt, sampling=sampling,
                                   request_id=rid, lora_adapter=adapter):
        toks = o.token_ids
    return toks


def _mixed(loop, engine, sampling_cls, tag, prompt=PROMPT):
    """One batch: the base model, a, b and a again, greedy then seeded."""
    async def go():
        return await asyncio.gather(*[
            _gen(engine, ad, sampling_cls(**kw), prompt, f"{tag}-{i}")
            for i, (ad, kw) in enumerate(((None, GREEDY), ("a", GREEDY),
                                          ("b", SEEDED), ("a", SEEDED)))])
    return loop.run_until_complete(go())


# ------------------------------------------------------------ the adapters
@pytest.mark.parametrize("name", ["a", "b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_load_peft_adapter_matches_jax_bit_for_bit(adapters, name, dtype):
    """The port's loader (its own safetensors reader) gives the JAX
    loader's A and B (transposed, alpha / r folded into B), bit for bit."""
    tdt = getattr(torch, dtype)
    got = tlora.load_peft_adapter(name, adapters[name], MC, dtype=tdt)
    want = jlora.load_peft_adapter(name, adapters[name], jax_resolve(MODEL),
                                   dtype=getattr(jnp, dtype))
    assert got.rank == want.rank and set(got.layers) == set(want.layers)
    for target, (a, b) in want.layers.items():
        ga, gb = got.layers[target]
        for g, w in ((ga, a), (gb, b)):
            w = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
            assert g.dtype == tdt and tuple(g.shape) == tuple(w.shape)
            assert torch.equal(g.float(), w), target


def test_registry_stacks_match_jax_bit_for_bit(adapters):
    """Both adapters stacked: index 0 all zeros, ranks padded to r_max,
    the JAX registry's arrays bit for bit."""
    jreg = jlora.LoRARegistry(jax_resolve(MODEL))
    treg = tlora.LoRARegistry(MC)
    for name, path in adapters.items():
        jreg.add(jlora.load_peft_adapter(name, path, jax_resolve(MODEL)))
        treg.add(tlora.load_peft_adapter(name, path, MC))
    js, ts = jreg.stacks(), treg.stacks()
    assert set(js) == set(ts) == set(ALL7)
    for target in js:
        for g, w in zip(ts[target], js[target]):
            assert tuple(g.shape) == tuple(w.shape)
            assert g.shape[1] == 3 and g.shape[-1 if g is ts[target][0] else -2] == 8
            assert torch.equal(g.float(), torch.from_numpy(
                np.asarray(w.astype(jnp.float32))))
        assert int(ts[target][0][:, 0].abs().sum()) == 0
    assert treg.names == jreg.names == ["a", "b"]
    assert treg.adapter_index(None) == 0 and treg.adapter_index("b") == 2
    with pytest.raises(KeyError):
        treg.adapter_index("nope")
    with pytest.raises(ValueError, match="duplicate"):
        treg.add(tlora.load_peft_adapter("a", adapters["a"], MC))


def test_lora_delta_matches_jax_and_the_zero_adapter_adds_zero():
    """Per-row delta over a mixed index vector (f32, atol 1e-5), and the
    PEFT math x @ A.T @ B.T * alpha / r; index 0 gives exactly 0."""
    rng = np.random.default_rng(3)
    na, din, r, dout = 3, 32, 4, 24
    a = rng.standard_normal((na, din, r)).astype(np.float32)
    b = rng.standard_normal((na, r, dout)).astype(np.float32)
    a[0] = 0
    b[0] = 0
    x = rng.standard_normal((4, 3, din)).astype(np.float32)
    idx = np.array([0, 2, 1, 2], np.int32)
    got = tlora.lora_delta(torch.from_numpy(x), torch.from_numpy(a),
                           torch.from_numpy(b), torch.from_numpy(idx)).numpy()
    want = np.asarray(jlora.lora_delta(jnp.asarray(x), jnp.asarray(a),
                                       jnp.asarray(b), jnp.asarray(idx)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[1], x[1] @ a[2] @ b[2], rtol=1e-5, atol=1e-5)
    assert np.all(got[0] == 0)
    # bf16 stacks against f32 activations: cast up, as jnp.einsum promotes.
    bf = torch.from_numpy(a).to(torch.bfloat16)
    got_bf = tlora.lora_delta(torch.from_numpy(x), bf, torch.from_numpy(b),
                              torch.from_numpy(idx))
    assert got_bf.dtype == torch.float32


def test_init_random_adapter_is_seeded_and_nonzero():
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    a1 = tlora.init_random_adapter("x", MC, g1, rank=4, targets=ALL7)
    a2 = tlora.init_random_adapter("x", MC, g2, rank=4, targets=ALL7)
    for t in ALL7:
        for u, v in zip(a1.layers[t], a2.layers[t]):
            assert torch.equal(u, v) and bool(u.abs().sum() > 0)
    assert tuple(a1.layers["w_down"][0].shape) == (
        MC.num_layers, MC.intermediate_size, 4)


def test_shard_stacks_follow_the_base_weights():
    """Column-parallel targets split B's output columns, row-parallel ones
    A's input rows; the slices of all ranks tile the stacks."""
    reg = tlora.LoRARegistry(MC, dtype=torch.float32)
    reg.add(tlora.init_random_adapter("x", MC, torch.Generator().manual_seed(0),
                                      rank=4, targets=ALL7))
    full = reg.stacks()
    parts = [tlora.shard_stacks(full, r, 2) for r in range(2)]
    for t, (a, b) in full.items():
        if t in ("wo", "w_down"):
            assert torch.equal(torch.cat([p[t][0] for p in parts], dim=-2), a)
            assert all(p[t][1] is b for p in parts)
        else:
            assert torch.equal(torch.cat([p[t][1] for p in parts], dim=-1), b)
            assert all(p[t][0] is a for p in parts)
    assert tlora.stack_bytes(full) == sum(
        x.numel() * 4 for pair in full.values() for x in pair)


def test_opt_refuses_lora():
    cfg = resolve_model_config("tiny-opt")
    params = topt.init_params(cfg, torch.Generator().manual_seed(0),
                              torch.float32)
    ids = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(AssertionError, match="llama-family"):
        topt.forward(params, cfg, ids, ids, torch.full((1,), 2, dtype=torch.int32),
                     lora=(torch.zeros(1), {}))
    with pytest.raises(ValueError, match="llama-family"):
        tlora.load_registry({"a": "/nonexistent"}, cfg)


# ------------------------------------------------------------ the engine
def test_mixed_batch_tokens_match_jax(engines):
    """One batch mixing the base model and both adapters, greedy and
    seeded: the port's tokens equal the JAX engine's; adapters move tokens
    off the base model's, and a's two rows differ only by their sampling."""
    jeng, teng, loop = engines
    want = _mixed(loop, jeng, JaxSampling, "jm")
    got = _mixed(loop, teng, SamplingParams, "tm")
    assert got == want
    base = loop.run_until_complete(_gen(teng, None, SamplingParams(**GREEDY)))
    assert got[0] == base
    assert got[1] != base and got[2] != base


def test_adapter_rows_do_not_depend_on_the_batch(engines):
    """An adapter row alone equals the same row beside others (the
    reference's stable-across-batching bar)."""
    jeng, teng, loop = engines
    alone = loop.run_until_complete(_gen(teng, "b", SamplingParams(**SEEDED)))
    mixed = _mixed(loop, teng, SamplingParams, "alone")
    assert alone == mixed[2]


def test_prefix_cache_not_shared_across_adapters(engines):
    """The same prompt under a and then under the base model: the second
    finds no cached block (the hit counter does not move), and its tokens
    equal a fresh base-model run's; the adapter's chain keys equal the JAX
    package's."""
    jeng, teng, loop = engines
    prompt = "a prompt long enough to fill several blocks of four tokens"
    sp = SamplingParams(**GREEDY)
    bm = teng.block_manager
    loop.run_until_complete(_gen(teng, "a", sp, prompt))
    hits0 = bm.prefix_hits_total
    base_after = loop.run_until_complete(_gen(teng, None, sp, prompt))
    assert bm.prefix_hits_total == hits0
    again = loop.run_until_complete(_gen(teng, "a", sp, prompt))
    assert bm.prefix_hits_total > hits0
    bm.reset_prefix_cache()
    assert base_after == loop.run_until_complete(_gen(teng, None, sp, prompt))
    assert again == loop.run_until_complete(_gen(teng, "a", sp, prompt))
    toks = list(range(40, 52))
    tseq = Sequence(request_id="k", prompt_token_ids=toks, sampling=sp,
                    adapter_idx=1, adapter_name="a")
    jseq = JaxSequence(request_id="k", prompt_token_ids=toks,
                       sampling=JaxSampling(**GREEDY), adapter_idx=1,
                       adapter_name="a")
    assert tseq.hash_seed == jseq.hash_seed == b"lora:a"
    assert Sequence(request_id="z", prompt_token_ids=toks,
                    sampling=sp).hash_seed == b""
    assert _block_hash(tseq.hash_seed, toks[:4]) == \
        jax_block_hash(jseq.hash_seed, toks[:4])


def test_unknown_and_unregistered_adapters(engines):
    jeng, teng, loop = engines
    with pytest.raises(KeyError):
        loop.run_until_complete(_gen(teng, "nope", SamplingParams(**GREEDY)))
    with pytest.raises(KeyError):
        loop.run_until_complete(_gen(jeng, "nope", JaxSampling(**GREEDY)))
    plain = ServingEngine(EngineConfig(**BASE, device="cpu"))

    async def go():
        await plain.start()
        try:
            with pytest.raises(ValueError, match="no LoRA adapters are registered"):
                await _gen(plain, "a", SamplingParams(**GREEDY))
        finally:
            await plain.stop()

    loop.run_until_complete(go())
    plain.shutdown()


def test_spec_on_with_an_adapter_matches_jax(adapters):
    """A self-drafting engine (N = 3) serving the mixed batch: tokens equal
    the JAX spec-on engine's and the port's spec-off engine's; the draft
    runs the base model (the reference's), so an adapter row's acceptance
    may drop, never its tokens."""
    spec = dict(speculative_num_tokens=3, speculative_model=MODEL,
                max_num_seqs=4)
    jeng, teng = _pair(adapters, **spec)
    _, toff = _pair(adapters, max_num_seqs=4)
    loop = asyncio.new_event_loop()
    try:
        for e in (jeng, teng, toff):
            loop.run_until_complete(e.start())
        want = _mixed(loop, jeng, JaxSampling, "js")
        got = _mixed(loop, teng, SamplingParams, "ts")
        off = _mixed(loop, toff, SamplingParams, "to")
        assert got == want == off
        assert teng.runner.spec_draft_tokens_total == \
            jeng.runner.spec_draft_tokens_total
        assert teng.runner.spec_accepted_tokens_total == \
            jeng.runner.spec_accepted_tokens_total
    finally:
        for e in (jeng, teng, toff):
            loop.run_until_complete(e.stop())
        teng.shutdown()
        toff.shutdown()
        loop.close()


def test_disagg_handoff_under_an_adapter_is_refused(engines):
    """As the JAX engine: a prefill hop or a decode hop with an adapter is
    a ValueError before anything is scheduled."""
    jeng, teng, loop = engines
    for eng, sp in ((teng, SamplingParams(**GREEDY)),
                    (jeng, JaxSampling(**GREEDY))):
        eng.disagg = object()  # a coordinator's presence is all it checks

        async def go(eng=eng, sp=sp):
            async for _ in eng.generate(prompt="x", sampling=sp,
                                        handoff_key="k", lora_adapter="a"):
                pass

        try:
            with pytest.raises(ValueError,
                               match="disagg handoff does not support LoRA"):
                loop.run_until_complete(go())
        finally:
            eng.disagg = None


def test_prefix_spilled_under_an_adapter_restores_only_under_it(adapters):
    """The JAX engine serves a prompt under adapter a and spills its full
    blocks to the port's cache server; a port engine on the same store
    restores none of them for the base model (its chain is another
    namespace) and all of them under a, whose tokens then equal the JAX
    engine's."""
    from production_stack_tpu_torch.launch import launch_kv_server

    kv = launch_kv_server(max_bytes=1 << 24, force_python=True)
    prompt = "a prefix of several blocks spilled under one adapter " * 2
    sp = dict(temperature=0.0, max_tokens=6, ignore_eos=True)
    loop = asyncio.new_event_loop()
    try:
        jeng, teng = _pair(adapters, kv_remote_url=kv.url)
        jeng.offload.flush_interval = 0.02
        toks = jeng.tokenizer.encode(prompt)
        n_full = (len(toks) - 1) // BASE["block_size"]

        async def spill():
            await jeng.start()
            try:
                out = await _gen(jeng, "a", JaxSampling(**sp), prompt)
                while jeng.offload.spilled_blocks_total < n_full:
                    await asyncio.sleep(0.02)
                return out
            finally:
                await jeng.stop()

        want = loop.run_until_complete(spill())

        async def restore():
            await teng.start()
            try:
                base = await _gen(teng, None, SamplingParams(**sp), prompt)
                r_base = teng.offload.restored_tokens_total
                got = await _gen(teng, "a", SamplingParams(**sp), prompt)
                return base, r_base, got, teng.offload.restored_tokens_total
            finally:
                await teng.stop()

        base, r_base, got, r_all = loop.run_until_complete(restore())
        teng.shutdown()
    finally:
        loop.close()
        kv.stop()
    assert r_base == 0
    assert r_all == n_full * BASE["block_size"]
    assert got == want and got != base


async def test_server_models_and_unknown_model_answer_as_jax(adapters):
    """/v1/models lists the base model and both adapters; ``model=a``
    serves the adapter (the JAX server's tokens); an unknown model is the
    JAX server's 404 with the same body; ``--lora-modules`` parses into the
    config with the JAX server's error text."""
    jeng, teng = _pair(adapters)
    jclient = TestClient(TestServer(JaxServer(jeng).build_app()))
    await jclient.start_server()
    server = OpenAIServer(teng, port=0)
    await server.start()
    try:
        resp = await jclient.get("/v1/models")
        want = [m["id"] for m in (await resp.json())["data"]]
        st, _, text = await _http(server.port, "GET", "/v1/models")
        assert st == 200
        assert [m["id"] for m in json.loads(text)["data"]] == want == \
            [MODEL, "a", "b"]
        for model in ("a", "nope"):
            body = {"model": model, "prompt": PROMPT, "max_tokens": 6,
                    "temperature": 0.0, "ignore_eos": True}
            resp = await jclient.post("/v1/completions", json=body)
            jst, jbody = resp.status, await resp.json()
            st, _, text = await _http(server.port, "POST", "/v1/completions",
                                      body)
            assert st == jst
            got = json.loads(text)
            if model == "nope":
                assert st == 404 and got == jbody
                assert got["error"]["type"] == "model_not_found"
            else:
                assert st == 200
                assert got["choices"][0]["text"] == jbody["choices"][0]["text"]
                assert got["model"] == jbody["model"] == MODEL
    finally:
        await jclient.close()
        await server.stop()
        teng.shutdown()
    cfg = config_from_args(parse_args(
        ["--model", MODEL, "--lora-modules", "a=/x/a", "b=/y=z"]))
    assert cfg.lora_modules == {"a": "/x/a", "b": "/y=z"}
    with pytest.raises(SystemExit, match="NAME=PATH"):
        _parse_lora_modules(["oops"])
