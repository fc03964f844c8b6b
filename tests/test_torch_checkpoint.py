"""HuggingFace checkpoint directories and tokenizers in the PyTorch port
against the JAX package's loader and ``transformers``.

Tiny llama, qwen2 and OPT models are made by ``transformers`` from a torch
seed and saved with ``save_pretrained`` (safetensors, sharded with an index,
or ``pytorch_model.bin``), as ``tests/test_weights_loading.py`` does. The
port's loader reads them with its own safetensors reader: its params equal
the JAX loader's bit for bit, and its float32 forward gives
``transformers``' logits (rtol / atol 2e-3) and the JAX forward's (atol
1e-4). The reader and writer are held to the ``safetensors`` package in
both directions. A tokenizer built here (a byte-level BPE in
``PreTrainedTokenizerFast`` with a chat template) behaves as the JAX
``HFTokenizer``, and the port's server answers a chat request with it as the
JAX server does.
"""

import asyncio
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

import chip_smoke
from production_stack_tpu.engine import tokenizer as jtok
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models import get_model_fns as jax_model_fns
from production_stack_tpu.models.config import ModelConfig as JaxModelConfig
from production_stack_tpu.models.weights import load_hf_params as jax_load
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu_torch.engine import tokenizer as ttok
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models import get_model_fns, llama
from production_stack_tpu_torch.models import safetensors_io as stio
from production_stack_tpu_torch.models.config import (
    ModelConfig,
    resolve_model_config,
)
from production_stack_tpu_torch.models.weights import load_hf_params
from production_stack_tpu_torch.parallel.sharding import shard_params
from production_stack_tpu_torch.server.api_server import OpenAIServer
from tests.test_torch_surface import _http

transformers = pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKENS = [3, 17, 42, 99, 5, 61, 7]
FAMILIES = ("llama", "qwen2", "opt")
CPU = torch.device("cpu")


def _hf_model(family, vocab=128, seed=0, layers=2, tied=False):
    torch.manual_seed(seed)
    if family == "llama":
        cfg = transformers.LlamaConfig(
            vocab_size=vocab, hidden_size=64, intermediate_size=128,
            num_hidden_layers=layers, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            rms_norm_eps=1e-5, tie_word_embeddings=tied)
        model = transformers.LlamaForCausalLM(cfg)
    elif family == "qwen2":
        cfg = transformers.Qwen2Config(
            vocab_size=vocab, hidden_size=64, intermediate_size=128,
            num_hidden_layers=layers, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            rms_norm_eps=1e-6, tie_word_embeddings=tied)
        model = transformers.Qwen2ForCausalLM(cfg)
        # HF initializes the qkv biases to zero: make them count.
        with torch.no_grad():
            for layer in model.model.layers:
                for p in (layer.self_attn.q_proj, layer.self_attn.k_proj,
                          layer.self_attn.v_proj):
                    p.bias.normal_(0, 0.1)
    else:
        cfg = transformers.OPTConfig(
            vocab_size=vocab, hidden_size=64, ffn_dim=128,
            num_hidden_layers=layers, num_attention_heads=4,
            max_position_embeddings=128, do_layer_norm_before=True,
            word_embed_proj_dim=64)
        model = transformers.OPTForCausalLM(cfg)
    return model.eval().to(torch.float32)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{family: (directory, the transformers model)}."""
    out = {}
    for family in FAMILIES:
        model = _hf_model(family)
        d = str(tmp_path_factory.mktemp(family))
        model.save_pretrained(d, safe_serialization=True)
        out[family] = (d, model)
    return out


def _port_logits(d, dtype=torch.float32):
    cfg = ModelConfig.from_pretrained_dir(d)
    _, forward, logits_fn, _ = get_model_fns(cfg)
    params = load_hf_params(cfg, d, dtype, CPU)
    t = len(TOKENS)
    hidden, _, _ = forward(params, cfg, torch.tensor([TOKENS], dtype=torch.int32),
                           torch.arange(t, dtype=torch.int32)[None],
                           torch.tensor([t], dtype=torch.int32))
    return logits_fn(params, cfg, hidden[0]).numpy()


def _jax_params_and_logits(d):
    cfg = JaxModelConfig.from_pretrained_dir(d)
    _, forward, logits_fn = jax_model_fns(cfg)
    params = jax_load(cfg, d, jnp.float32)
    t = len(TOKENS)
    hidden, _, _ = forward(params, cfg, jnp.asarray([TOKENS], jnp.int32),
                           jnp.arange(t, dtype=jnp.int32)[None],
                           jnp.asarray([t], jnp.int32))
    return params, np.asarray(logits_fn(params, cfg, hidden[0]))


def _assert_params_equal_jax(got, want):
    assert set(got) == set(want)
    assert set(got["layers"]) == set(want["layers"])
    pairs = [(got[k], want[k]) for k in got if k != "layers"] + \
        [(got["layers"][k], want["layers"][k]) for k in got["layers"]]
    for g, w in pairs:
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert g.dtype == torch.bfloat16
            assert np.array_equal(g.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert g.dtype == torch.float32 and np.array_equal(g.numpy(), w)


# ------------------------------------------------------------ the loader
@pytest.mark.parametrize("family", FAMILIES)
def test_port_forward_on_hf_checkpoint_matches_transformers(checkpoints, family):
    d, model = checkpoints[family]
    with torch.no_grad():
        ref = model(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(_port_logits(d), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("family", FAMILIES)
def test_loaded_params_and_forward_match_jax(checkpoints, family):
    """The port's loaded params equal the JAX loader's bit for bit (the
    config too, field by field); the forwards agree to 1e-4."""
    d, _ = checkpoints[family]
    cfg = ModelConfig.from_pretrained_dir(d)
    jcfg = JaxModelConfig.from_pretrained_dir(d)
    assert {f: getattr(cfg, f) for f in cfg.__dataclass_fields__} == \
        {f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}
    assert cfg.attention_bias == (family == "qwen2")
    jparams, jlogits = _jax_params_and_logits(d)
    _assert_params_equal_jax(load_hf_params(cfg, d, torch.float32, CPU),
                             jparams)
    np.testing.assert_allclose(_port_logits(d), jlogits, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", ["llama", "opt"])
def test_bf16_load_matches_jax_bit_for_bit(checkpoints, family):
    d, _ = checkpoints[family]
    cfg = ModelConfig.from_pretrained_dir(d)
    _assert_params_equal_jax(
        load_hf_params(cfg, d, torch.bfloat16, CPU),
        jax_load(JaxModelConfig.from_pretrained_dir(d), d, jnp.bfloat16))


@pytest.mark.parametrize("layout", ["sharded-index", "bin", "tied"])
def test_sharded_bin_and_tied_checkpoints(tmp_path, layout):
    """A checkpoint in several safetensors shards with an index, a
    ``pytorch_model.bin`` one, and a tied-embedding one (no lm_head leaf):
    loaded as the JAX loader loads them, and their logits are
    ``transformers``'."""
    model = _hf_model("llama", seed=3, tied=layout == "tied")
    d = str(tmp_path / layout)
    if layout == "sharded-index":
        model.save_pretrained(d, safe_serialization=True, max_shard_size="40KB")
        assert os.path.exists(os.path.join(d, stio.INDEX_FILE))
        assert len(stio.checkpoint_files(d)) > 1
    else:
        model.save_pretrained(d, safe_serialization=layout != "bin")
    cfg = ModelConfig.from_pretrained_dir(d)
    params = load_hf_params(cfg, d, torch.float32, CPU)
    assert ("lm_head" in params) == (layout != "tied")
    _assert_params_equal_jax(params, jax_load(
        JaxModelConfig.from_pretrained_dir(d), d, jnp.float32))
    with torch.no_grad():
        ref = model(torch.tensor([TOKENS])).logits[0].numpy()
    np.testing.assert_allclose(_port_logits(d), ref, rtol=2e-3, atol=2e-3)


def _llama_tensors(cfg, layers_of):
    """An HF llama state dict of zeros where the leaf ``suffix`` of layer i
    is written at ``layers_of(suffix, i)`` (None: left out)."""
    d, f, dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    shapes = {
        "self_attn.q_proj.weight": (h * dh, d),
        "self_attn.k_proj.weight": (hkv * dh, d),
        "self_attn.v_proj.weight": (hkv * dh, d),
        "self_attn.o_proj.weight": (d, h * dh),
        "mlp.gate_proj.weight": (f, d), "mlp.up_proj.weight": (f, d),
        "mlp.down_proj.weight": (d, f),
        "input_layernorm.weight": (d,), "post_attention_layernorm.weight": (d,),
    }
    out = {"model.embed_tokens.weight": torch.zeros(cfg.vocab_size, d),
           "model.norm.weight": torch.zeros(d)}
    for suffix, shape in shapes.items():
        for i in range(cfg.num_layers):
            idx = layers_of(suffix, i)
            if idx is not None:
                out[f"model.layers.{idx}.{suffix}"] = torch.zeros(shape)
    return out


@pytest.mark.parametrize("case", ["missing-layer", "absent-leaf", "extra-layer"])
def test_incomplete_checkpoints_are_refused_as_jax_refuses(tmp_path, case):
    """The JAX loader's refusals, with its messages: a leaf whose layer
    indices leave a hole (the right count, layer 0 twice); a leaf with no
    tensor at all; a layer past the config. Nothing falls back to random
    weights."""
    cfg = resolve_model_config("tiny-llama")
    layers_of = {
        "missing-layer": lambda s, i: 0 if s == "self_attn.q_proj.weight" else i,
        "absent-leaf": lambda s, i: None if s == "mlp.up_proj.weight" else i,
        "extra-layer": lambda s, i: i + (1 if s == "mlp.up_proj.weight" else 0),
    }[case]
    stio.save_file(_llama_tensors(cfg, layers_of),
                   str(tmp_path / "model.safetensors"))
    match = {"missing-layer": "missing layer", "absent-leaf": "no tensors at all",
             "extra-layer": "indexes layer 2"}[case]
    with pytest.raises(ValueError, match=match):
        load_hf_params(cfg, str(tmp_path), torch.float32, CPU)
    with pytest.raises(ValueError, match=match):
        jax_load(JaxModelConfig(**{f: getattr(cfg, f)
                                   for f in cfg.__dataclass_fields__}),
                 str(tmp_path), np.float32)


def test_an_empty_directory_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="No \\*.safetensors"):
        load_hf_params(resolve_model_config("tiny-llama"), str(tmp_path),
                       device=CPU)


@pytest.mark.parametrize("family", ["llama", "qwen2"])
def test_tp2_shards_equal_shard_params_of_the_tp1_load(checkpoints, family):
    """Each tp rank's load (what a worker process runs) equals its slice of
    the tp = 1 load, bit for bit."""
    d, _ = checkpoints[family]
    cfg = ModelConfig.from_pretrained_dir(d)
    full = load_hf_params(cfg, d, torch.float32, CPU)
    for rank in range(2):
        got = load_hf_params(cfg, d, torch.float32, CPU, rank=rank, tp=2)
        want = shard_params(full, cfg, rank, 2)
        assert set(got) == set(want) and set(got["layers"]) == set(want["layers"])
        for k in want["layers"]:
            assert torch.equal(got["layers"][k], want["layers"][k]), k
        for k in want:
            if k != "layers":
                assert torch.equal(got[k], want[k]), k


# ------------------------------------------------------ the file format
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_reader_and_writer_match_the_safetensors_package(tmp_path, dtype):
    """Files written by the package read back through the port's reader,
    and files the port's writer wrote read back through the package, bit
    for bit (with metadata, a scalar and an empty tensor)."""
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(7)
    tdt = getattr(torch, dtype)
    tensors = {
        "w": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).to(tdt),
        "b": torch.from_numpy(rng.standard_normal((3,)).astype(np.float32)).to(tdt),
        "s": torch.tensor(1.5, dtype=tdt),
        "e": torch.zeros((0, 4), dtype=tdt),
    }
    meta = {"format": "pt", "note": "x"}
    a, b = str(tmp_path / "pkg.safetensors"), str(tmp_path / "port.safetensors")
    st.save_file(tensors, a, metadata=meta)
    stio.save_file(tensors, b, metadata=meta)
    for path in (a, b):
        mine = {name: t.clone() for name, t in stio.iter_file(path)}
        for got in (mine, st.load_file(path)):
            assert set(got) == set(tensors)
            for k, t in tensors.items():
                assert got[k].dtype == t.dtype and got[k].shape == t.shape
                assert torch.equal(got[k], t), (path, k)
        header, _ = stio.read_header(path)
        assert header["__metadata__"] == meta
    with open(b, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
    assert n % 8 == 0


def test_chip_smoke_writer_round_trips_a_named_config(tmp_path):
    """The smoke script's checkpoint writer (HF names, [out, in], two
    shards and an index, config.json from the ModelConfig): the loader
    gives back the written params bit for bit, and the resolved config is
    the named one in every field but the name."""
    mc = resolve_model_config("tiny-llama-8kv")
    params = llama.init_params(mc, torch.Generator().manual_seed(4),
                               torch.bfloat16)
    d = str(tmp_path / "ckpt")
    info = chip_smoke.write_hf_checkpoint(torch, params, mc, d, num_shards=2)
    assert len(info["files"]) == 2 and os.path.exists(
        os.path.join(d, stio.INDEX_FILE))
    got_cfg = resolve_model_config(d)
    assert {f: getattr(got_cfg, f) for f in mc.__dataclass_fields__ if f != "name"} \
        == {f: getattr(mc, f) for f in mc.__dataclass_fields__ if f != "name"}
    loaded = load_hf_params(got_cfg, d, torch.bfloat16, CPU)
    assert chip_smoke.params_equal(torch, loaded, params) == []
    loaded["layers"]["wk"][1, 0, 0] += 1
    assert chip_smoke.params_equal(torch, loaded, params) == ["layers.wk"]
    jp = jax_load(JaxModelConfig.from_pretrained_dir(d), d, jnp.bfloat16)
    assert np.array_equal(np.asarray(jp["embed"]).view(np.int16),
                          params["embed"].view(torch.int16).numpy())


# ------------------------------------------------------------ the engine
def _pair_from_dir(d, **over):
    fields = dict(model=d, max_model_len=128, block_size=4, num_kv_blocks=64,
                  max_num_seqs=4, max_num_batched_tokens=32,
                  attn_impl="window", dtype="float32", num_decode_steps=4,
                  **over)
    return JaxEngine(JaxConfig(**fields)), \
        ServingEngine(EngineConfig(**fields, device="cpu"))


async def _serve(engine, sampling_cls, prompts):
    await engine.start()

    async def one(i, p):
        kw = dict(temperature=0.0) if i % 2 == 0 else dict(temperature=0.9,
                                                           seed=11 + i)
        toks = None
        async for o in engine.generate(prompt_token_ids=p, sampling=sampling_cls(
                max_tokens=8, ignore_eos=True, **kw)):
            toks = o.token_ids
        return toks

    try:
        return await asyncio.gather(*[one(i, p) for i, p in enumerate(prompts)])
    finally:
        await engine.stop()


async def test_engine_on_a_checkpoint_directory_matches_jax(checkpoints):
    """Both engines load the same directory (``--model <dir>``): greedy and
    seeded tokens are equal; the port records its load time; the
    ``dummy`` load format draws from the seed as a named config does."""
    d, _ = checkpoints["llama"]
    jeng, teng = _pair_from_dir(d)
    prompts = [TOKENS, [9, 8, 7, 6, 5], [1] * 11, [100, 2, 30]]
    want = await _serve(jeng, JaxSampling, prompts)
    got = await _serve(teng, SamplingParams, prompts)
    assert got == want and all(len(t) == 8 for t in got)
    st = teng.stats()
    assert st["startup_weight_load_seconds"] > 0
    teng.shutdown()
    dummy = ServingEngine(EngineConfig(model=d, device="cpu", dtype="float32",
                                       num_kv_blocks=16, max_model_len=64,
                                       load_format="dummy", seed=3))
    drawn = llama.init_params(dummy.model_config,
                              torch.Generator().manual_seed(3), torch.float32)
    assert chip_smoke.params_equal(torch, dummy.runner.params, drawn) == []
    dummy.shutdown()


def test_speculative_draft_loads_from_a_directory(checkpoints, tmp_path):
    """One loader for the target and the draft: a draft directory's params
    are the loader's, on the port as on the JAX runner."""
    d, _ = checkpoints["llama"]
    draft = _hf_model("llama", seed=9, layers=1)
    dd = str(tmp_path / "draft")
    draft.save_pretrained(dd, safe_serialization=True)
    fields = dict(model=d, speculative_num_tokens=2, speculative_model=dd,
                  max_model_len=64, num_kv_blocks=16, max_num_seqs=2,
                  dtype="float32", attn_impl="window")
    teng = ServingEngine(EngineConfig(**fields, device="cpu"))
    jeng = JaxEngine(JaxConfig(**fields))
    _assert_params_equal_jax(teng.runner.spec_params, jeng.runner.spec_params)
    teng.shutdown()


def test_port_reads_checkpoints_without_safetensors_or_transformers():
    """A fresh interpreter whose ``safetensors``, ``transformers`` and
    ``tokenizers`` cannot be imported (the card's machine has none): a
    checkpoint directory still loads, and ``get_tokenizer`` falls back to
    the byte tokenizer with the JAX package's warning."""
    code = (
        "import sys, os, tempfile, torch\n"
        "for m in ('safetensors', 'transformers', 'tokenizers'):\n"
        "    sys.modules[m] = None\n"
        "import chip_smoke\n"
        "from production_stack_tpu_torch.models import llama\n"
        "from production_stack_tpu_torch.models.config import resolve_model_config\n"
        "from production_stack_tpu_torch.models.weights import load_hf_params\n"
        "from production_stack_tpu_torch.engine.tokenizer import get_tokenizer\n"
        "mc = resolve_model_config('tiny-llama')\n"
        "p = llama.init_params(mc, torch.Generator().manual_seed(0), torch.bfloat16)\n"
        "d = tempfile.mkdtemp()\n"
        "chip_smoke.write_hf_checkpoint(torch, p, mc, d)\n"
        "open(os.path.join(d, 'tokenizer_config.json'), 'w').write('{}')\n"
        "q = load_hf_params(resolve_model_config(d), d, torch.bfloat16, 'cpu')\n"
        "assert chip_smoke.params_equal(torch, q, p) == []\n"
        "print(type(get_tokenizer(d, mc)).__name__)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[-1] == "ByteTokenizer"
    assert "HF tokenizer load failed" in proc.stderr
    assert "using ByteTokenizer" in proc.stderr


# ------------------------------------------------------------ tokenizer
CHAT_TEMPLATE = (
    "{% for m in messages %}<|{{ m['role'] }}|>{{ m['content'] }}\n"
    "{% endfor %}{% if add_generation_prompt %}<|assistant|>{% endif %}")


def _build_tokenizer(d, chat_template=True):
    """A byte-level BPE (vocab 320) trained here, wrapped in
    PreTrainedTokenizerFast and saved into ``d``."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=320, special_tokens=["<s>", "</s>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    corpus = ["the quick brown fox jumps over the lazy dog",
              "serving a checkpoint directory with its tokenizer",
              "héllo wörld — naïve café ünïcode"] * 20
    tok.train_from_iterator(corpus, trainer)
    fast = transformers.PreTrainedTokenizerFast(
        tokenizer_object=tok, bos_token="<s>", eos_token="</s>",
        chat_template=CHAT_TEMPLATE if chat_template else None)
    fast.save_pretrained(d)


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    """A tiny llama (vocab 320) with its tokenizer in one directory."""
    d = str(tmp_path_factory.mktemp("tok"))
    _hf_model("llama", vocab=320, seed=5).save_pretrained(d, safe_serialization=True)
    _build_tokenizer(d)
    return d


TEXTS = ["the quick brown fox", "héllo wörld — naïve café", "", "a\nb  c"]


def test_hf_tokenizer_matches_jax(tok_dir):
    mc = ModelConfig.from_pretrained_dir(tok_dir)
    t = ttok.get_tokenizer(tok_dir, mc)
    j = jtok.get_tokenizer(tok_dir, JaxModelConfig.from_pretrained_dir(tok_dir))
    assert type(t).__name__ == type(j).__name__ == "HFTokenizer"
    assert (t.vocab_size, t.eos_token_id, t.bos_token_id) == \
        (j.vocab_size, j.eos_token_id, j.bos_token_id)
    for text in TEXTS:
        for special in (False, True):
            ids = t.encode(text, add_special_tokens=special)
            assert ids == j.encode(text, add_special_tokens=special)
            assert t.decode(ids) == j.decode(ids)
            assert t.decode(ids, skip_special_tokens=False) == \
                j.decode(ids, skip_special_tokens=False)
    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "héllo"}]
    for gen in (True, False):
        assert t.apply_chat_template(msgs, add_generation_prompt=gen) == \
            j.apply_chat_template(msgs, add_generation_prompt=gen)
    assert t.apply_chat_template(msgs).endswith("<|assistant|>")
    # Incremental detokenization: the same deltas, token by token (the
    # multi-byte characters split across tokens are held back alike).
    ids = t.encode(TEXTS[1])
    td, jd = ttok.IncrementalDetokenizer(t), jtok.IncrementalDetokenizer(j)
    deltas = [(td.step(ids[:i]), jd.step(ids[:i])) for i in range(1, len(ids) + 1)]
    assert all(a == b for a, b in deltas)
    assert "".join(a for a, _ in deltas) + td.step(ids, flush=True) == TEXTS[1]


def test_tokenizer_without_a_chat_template_uses_the_fallback(tmp_path):
    d = str(tmp_path)
    _build_tokenizer(d, chat_template=False)
    mc = resolve_model_config("tiny-llama")
    t, j = ttok.HFTokenizer(d), jtok.HFTokenizer(d)
    msgs = [{"role": "user", "content": "x"}]
    assert t.apply_chat_template(msgs) == j.apply_chat_template(msgs) == \
        "<|user|>\nx\n<|assistant|>\n"
    assert type(ttok.get_tokenizer("tiny-llama", mc)).__name__ == "ByteTokenizer"


async def test_server_serves_chat_with_the_hf_tokenizer_as_jax(tok_dir):
    """The port's server and the JAX server, each on the same checkpoint
    directory with its tokenizer: a greedy chat completion has the same
    text, token counts and finish reason."""
    fields = dict(model=tok_dir, max_model_len=128, block_size=4,
                  num_kv_blocks=64, max_num_seqs=4, attn_impl="window",
                  dtype="float32", num_decode_steps=4)
    jclient = TestClient(TestServer(JaxServer(JaxEngine(JaxConfig(**fields)))
                                    .build_app()))
    await jclient.start_server()
    server = OpenAIServer(ServingEngine(EngineConfig(**fields, device="cpu")),
                          port=0)
    await server.start()
    body = {"model": tok_dir, "max_tokens": 12, "temperature": 0.0,
            "ignore_eos": True,
            "messages": [{"role": "user", "content": "the quick brown fox"}]}
    try:
        assert type(server.engine.tokenizer).__name__ == "HFTokenizer"
        resp = await jclient.post("/v1/chat/completions", json=body)
        assert resp.status == 200
        want = await resp.json()
        st, _, text = await _http(server.port, "POST", "/v1/chat/completions", body)
        assert st == 200
        got = json.loads(text)
        assert got["choices"][0]["message"] == want["choices"][0]["message"]
        assert got["choices"][0]["finish_reason"] == \
            want["choices"][0]["finish_reason"] == "length"
        assert got["usage"] == want["usage"]
        assert got["usage"]["completion_tokens"] == 12
    finally:
        await jclient.close()
        await server.stop()
        server.engine.shutdown()


def test_the_loader_reads_to_the_card_unless_asked_for_the_cpu(checkpoints):
    """With no device given the loader writes to the card: here, without
    one, it raises rather than load onto the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    d, _ = checkpoints["llama"]
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        load_hf_params(ModelConfig.from_pretrained_dir(d), d)
