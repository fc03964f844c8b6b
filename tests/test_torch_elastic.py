"""Fast start in the PyTorch port (``docs/ELASTIC.md`` §1-2 of the JAX
package): the weights filled in place on a ``weight-loader`` thread beside
warm-up (``overlap_weight_load``), and ``compilation_cache_dir`` as the
directory of the reference's warm-up manifest, which lets a start of a
configuration that warmed fully before defer every non-default sampling
variant to its first dispatch.

On the CPU warm-up runs dummy dispatches instead of capturing graphs, and
a deferred variant's first use runs its dummy dispatch there, so the
tests hold what the card shares with the CPU: the order of the draws
(an overlapped load equals a serial one bit for bit), the tokens and
logprobs of every boot (serial, overlapped, manifest-verified) against
each other and against the JAX engine on the same float32 params, the
manifest's key, the deferred variants and their count against the JAX
runner's, and the failures (a broken checkpoint, a failed first-use
capture, an unusable directory), on a plain and on a speculative engine.
"""

import asyncio
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax

MODEL = "tiny-llama-128dh"
CPU = torch.device("cpu")
# A small serving shape: 4 rows, two prefill row families, chunked prefill.
SHAPE = dict(max_model_len=256, block_size=16, num_kv_blocks=64,
             max_num_seqs=4, max_num_batched_tokens=64, num_decode_steps=8,
             attn_impl="xla", dtype="float32")
PROMPTS = ["a short prompt", "b" * 90, "the third request", "d" * 20]


def _samplings(cls, n=4, **extra):
    """Greedy and seeded rows, alternating."""
    return [cls(max_tokens=8, ignore_eos=True, **extra,
                **(dict(temperature=0.0) if i % 2 == 0
                   else dict(temperature=0.8, top_p=0.9, seed=7 + i)))
            for i in range(n)]


async def _serve(engine, prompts, samplings):
    """Every prompt at once on a started engine; (tokens, logprobs) each."""

    async def one(p, sp):
        last = None
        async for o in engine.generate(prompt=p, sampling=sp):
            last = o
        return list(last.token_ids), last.logprobs

    return await asyncio.gather(*[one(p, sp)
                                  for p, sp in zip(prompts, samplings)])


def _port(model=MODEL, **over):
    fields = dict(SHAPE, model=model, enable_warmup=True)
    fields.update(over)
    return ServingEngine(EngineConfig(**fields, device="cpu"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The JAX package's f32 params of ``MODEL`` (seed 0), and a checkpoint
    directory of the same values written through ``params_from_jax``."""
    jparams = jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.float32)
    mc = resolve_model_config(MODEL)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), mc,
                             torch.float32)
    d = str(tmp_path_factory.mktemp("ckpt") / "model")
    chip_smoke.write_hf_checkpoint(torch, params, mc, d)
    return jparams, params, d


async def test_overlapped_serial_and_verified_boots_serve_the_jax_tokens(
        ckpt, tmp_path):
    """A serial boot, an overlapped cold boot (it writes the manifest) and
    an overlapped verified boot of the checkpoint directory serve the JAX
    engine's greedy and seeded tokens on the same params; the loader ran
    and joined."""
    jparams, _, d = ckpt
    jeng = JaxEngine(JaxConfig(**SHAPE, model=MODEL), params=jparams)
    await jeng.start()
    try:
        want = await _serve(jeng, PROMPTS, _samplings(JaxSampling))
    finally:
        await jeng.stop()
    cache = str(tmp_path / "cache")
    got = {}
    for name, over in (("serial", {}),
                       ("cold", dict(overlap_weight_load=True,
                                     compilation_cache_dir=cache)),
                       ("verified", dict(overlap_weight_load=True,
                                         compilation_cache_dir=cache))):
        eng = _port(model=d, **over)
        overlapped = eng.runner._param_thread is not None
        assert overlapped == (name != "serial"), name
        await eng.start()
        try:
            got[name] = await _serve(eng, PROMPTS, _samplings(SamplingParams))
            st = eng.stats()
        finally:
            await eng.stop()
            eng.shutdown()
        assert st["weights_ready"] and eng.runner._param_thread is None
        assert st["startup_weight_load_seconds"] > 0
        assert (st["startup_deferred_families"] > 0) == (name == "verified")
        if name == "serial":
            assert st["startup_compile_seconds"] == 0.0
    assert [t for t, _ in want] == [t for t, _ in got["serial"]]
    assert got["serial"] == got["cold"] == got["verified"]


@pytest.mark.parametrize("model", ["tiny-llama", "tiny-opt"])
def test_an_overlapped_load_draws_the_serial_weights(model):
    """The loader draws into the preallocated leaves from the same
    generator in the same order: bf16 params and the f32 head equal a
    serial start's bit for bit."""
    fields = dict(model=model, device="cpu", dtype="bfloat16",
                  max_model_len=128, num_kv_blocks=16, max_num_seqs=2,
                  attn_impl="xla", enable_warmup=True, seed=5)
    mc = resolve_model_config(model)
    serial = ModelRunner(EngineConfig(**fields), mc)
    over = ModelRunner(EngineConfig(**fields, overlap_weight_load=True), mc)
    assert serial._param_thread is None and over._param_thread is not None
    over.wait_for_weights()
    assert over.weights_ready
    assert chip_smoke.params_equal(torch, over.params, serial.params) == []
    assert torch.equal(over.head_f32, serial.head_f32)
    assert over.num_kv_blocks == serial.num_kv_blocks
    # The loader's largest transient: its largest draw (a top-level leaf
    # or one layer of a stack) in f32 and in bf16 at once. Reserved when
    # the card's pool is sized; the CPU's fixed budget reserves nothing.
    largest = max([t.numel() for k, t in serial.params.items()
                   if k != "layers"]
                  + [t[0].numel() for t in serial.params["layers"].values()])
    assert over._loader_peak_bytes(mc) == largest * (4 + 2)
    assert over.loader_reserve_bytes == serial.loader_reserve_bytes == 0


async def test_a_checkpoint_missing_a_tensor_fails_the_start(ckpt, tmp_path):
    """The loader's error is the start's: an overlapped boot of a
    directory without ``mlp.up_proj`` fails ``start()`` with the serial
    path's ValueError, and its weights never count as ready."""
    _, params, _ = ckpt
    broken = {k: v for k, v in params.items() if k != "layers"}
    broken["layers"] = {k: v for k, v in params["layers"].items()
                        if k != "w_up"}
    d = str(tmp_path / "broken")
    chip_smoke.write_hf_checkpoint(torch, broken, resolve_model_config(MODEL),
                                   d)
    with pytest.raises(ValueError, match="no tensors at all for \\['w_up'\\]"):
        _port(model=d)
    eng = _port(model=d, overlap_weight_load=True)
    with pytest.raises(ValueError, match="no tensors at all for \\['w_up'\\]"):
        await eng.start()
    assert not eng.runner.weights_ready
    with pytest.raises(ValueError, match="w_up"):
        eng.runner.wait_for_weights()
    eng.shutdown()


def test_the_manifest_key_and_when_it_is_written(tmp_path, monkeypatch):
    """One configuration, one manifest path (under a directory per card and
    toolchain); another KV dtype, model, block count or row count keys
    another. It is written, atomically, only after a warm-up that ran to
    its end."""
    cache = str(tmp_path / "cache")
    base = dict(model="tiny-llama", device="cpu", dtype="float32",
                max_model_len=128, num_kv_blocks=32, max_num_seqs=2,
                max_num_batched_tokens=32, num_decode_steps=4,
                attn_impl="xla", enable_warmup=True,
                compilation_cache_dir=cache)

    def path(**over):
        cfg = EngineConfig(**{**base, **over})
        return ModelRunner(cfg, resolve_model_config(cfg.model)
                           )._warmup_manifest_path()

    p = path()
    assert p == path()
    assert os.path.dirname(p) == os.path.join(
        cache, f"cpu-cpu-torch{torch.__version__}-cuda{torch.version.cuda}"
        .replace("+", "-"))
    assert os.path.basename(p).startswith("pstpu-warmup-") and p.endswith(".ok")
    others = [path(kv_cache_dtype="int8"), path(model="tiny-llama-128dh"),
              path(num_kv_blocks=48), path(max_num_seqs=4)]
    assert len({p, *others}) == 5
    cfg = EngineConfig(**base)
    runner = ModelRunner(cfg, resolve_model_config(cfg.model))
    calls = {"n": 0}
    real = runner.prefill_train.dummy_dispatch

    def flaky(key):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("warm-up stopped half way")
        return real(key)

    monkeypatch.setattr(runner.prefill_train, "dummy_dispatch", flaky)
    with pytest.raises(RuntimeError, match="half way"):
        runner.warmup()
    assert not os.path.exists(p)
    monkeypatch.setattr(runner.prefill_train, "dummy_dispatch", real)
    runner.warmup()
    assert os.path.exists(p)
    assert os.listdir(os.path.dirname(p)) == [os.path.basename(p)]


def _jax_deferred(tmp_path) -> tuple:
    """The JAX runner's deferred count and decode families at
    ``tests/test_warmup_coverage.py``'s xla shapes, from its own manifest
    path and one ``warmup()``."""
    jeng = JaxEngine(JaxConfig(
        model="tiny-llama", max_model_len=256, block_size=8,
        num_kv_blocks=256, max_num_seqs=2, num_decode_steps=8,
        max_num_batched_tokens=128, attn_impl="xla",
        compilation_cache_dir=""))
    r = jeng.runner
    os.makedirs(tmp_path)
    r.compilation_cache_path = str(tmp_path)
    with open(r._warmup_manifest_path(), "w") as f:
        f.write("complete\n")
    r.warmup()
    return r.startup_deferred_families, r.reachable_decode_families()


def test_a_verified_boot_defers_what_the_jax_runner_defers(tmp_path):
    """A verified boot dummy-dispatches only the default variants (no
    penalties, no logprobs) and counts the rest by the reference's rule,
    len(variants) - 1 per family: the JAX runner's count at the same
    shapes, folded over the reference's cached-window flag, which doubles
    its window-path decode families (Queue 3 item 4; ``max_num_seqs`` 2 is
    a power of two, so the port's top bucket adds none)."""
    jax_count, jax_fams = _jax_deferred(tmp_path / "jax")

    def rule(fams):
        return sum(2 if f[0] == 1 else 1 for f in fams)

    fold = rule(jax_fams) - rule({f[:3] for f in jax_fams})
    cache = str(tmp_path / "port")
    fields = dict(model="tiny-llama", max_model_len=256, block_size=8,
                  num_kv_blocks=256, max_num_seqs=2, num_decode_steps=8,
                  max_num_batched_tokens=128, attn_impl="xla",
                  dtype="float32", enable_warmup=True,
                  compilation_cache_dir=cache)
    runs = []
    for _ in range(2):
        eng = ServingEngine(EngineConfig(**fields, device="cpu"))
        r = eng.runner
        seen = []
        for train in (r.decode_train, r.prefill_train):
            real = train.dummy_dispatch
            train.dummy_dispatch = (
                lambda key, real=real: seen.append(key) or real(key))
        r.warmup()
        runs.append((r, seen))
        eng.shutdown()
    (cold, cold_seen), (warm, warm_seen) = runs
    keys, pkeys = cold.decode_graph_keys(), cold.prefill_graph_keys()
    assert sorted(cold_seen) == sorted(keys + pkeys)
    assert cold.startup_cache_miss_families == len(keys) + len(pkeys)
    assert cold.startup_deferred_families == 0
    defaults = [k for k in keys if not (k[3] or k[4])] + \
        [k for k in pkeys if not (k[4] or k[5])]
    assert sorted(warm_seen) == sorted(defaults)
    assert warm.startup_cache_miss_families == len(defaults)
    assert warm.startup_cache_hit_families == 0
    assert warm.decode_train.deferred | warm.prefill_train.deferred == \
        set(keys + pkeys) - set(defaults)
    assert warm.startup_deferred_families == jax_count - fold > 0
    assert warm.num_kv_blocks == cold.num_kv_blocks


async def _cold_and_verified(cache, **over):
    """Logprobs at b = 1, presence and frequency penalties, and logprobs at
    b > 1, served by a cold boot (it writes the manifest) and then by a
    verified boot of the same configuration: {name: (each round's tokens
    and logprobs, each round's first-use captures, the stats)}."""
    rounds = [
        (PROMPTS[:1], [SamplingParams(max_tokens=8, ignore_eos=True,
                                      temperature=0.0, logprobs=3)]),
        (PROMPTS[2:3], [SamplingParams(max_tokens=8, ignore_eos=True,
                                       temperature=0.8, seed=3,
                                       presence_penalty=0.5,
                                       frequency_penalty=0.3)]),
        (PROMPTS[1:3], _samplings(SamplingParams, n=2, logprobs=2)),
    ]
    out = {}
    for name in ("cold", "verified"):
        eng = _port(model="tiny-llama", compilation_cache_dir=cache,
                    overlap_weight_load=True, **over)
        await eng.start()
        try:
            got, firsts = [], []
            for prompts, samplings in rounds:
                n0 = eng.runner.deferred_captures_total
                got.append(await _serve(eng, prompts, samplings))
                firsts.append(eng.runner.deferred_captures_total - n0)
            st = eng.stats()
        finally:
            await eng.stop()
            eng.shutdown()
        out[name] = (got, firsts, st)
    cold, warm = out["cold"], out["verified"]
    assert cold[0] == warm[0]
    assert all(lp is not None for _, lp in cold[0][0] + cold[0][2])
    assert cold[1] == [0, 0, 0] and cold[2]["deferred_captures_total"] == 0
    assert cold[2]["startup_deferred_families"] == 0
    assert warm[2]["startup_deferred_families"] > 0
    assert all(n > 0 for n in warm[1])
    assert warm[2]["deferred_capture_seconds_total"] > 0
    assert warm[2]["prefill_eager_dispatches_total"] == \
        cold[2]["prefill_eager_dispatches_total"]
    return out


async def test_deferred_variants_serve_the_cold_boots_tokens(tmp_path):
    """Logprobs at b = 1, presence and frequency penalties, and logprobs at
    b > 1 on a verified boot: each first use runs the deferred variant's
    warm-up path in front of the dispatch, which then serves tokens and
    logprobs equal to a cold boot's; the cold boot defers nothing."""
    await _cold_and_verified(str(tmp_path / "cache"))


async def test_a_verified_speculative_boot_serves_the_cold_boots_tokens(
        tmp_path):
    """The same rounds on a self-draft speculative engine (its load stays
    serial): the verified boot defers the speculative train's logprob and
    penalty variants as well, captures them at their first use and serves
    the cold boot's tokens and logprobs."""
    out = await _cold_and_verified(
        str(tmp_path / "cache"), speculative_num_tokens=3,
        speculative_model="tiny-llama")
    st = out["verified"][2]
    assert not st["startup_compile_seconds"] and st["weights_ready"]


def test_a_failed_first_use_capture_raises_and_drops_the_manifest(
        tmp_path, monkeypatch):
    """A deferred variant whose first-use capture fails raises out of its
    dispatch (no eager run stands in), stays deferred, and its manifest is
    deleted so the next start warms every variant."""
    cache = str(tmp_path / "cache")
    fields = dict(model="tiny-llama", device="cpu", dtype="float32",
                  max_model_len=128, num_kv_blocks=32, max_num_seqs=2,
                  max_num_batched_tokens=32, num_decode_steps=4,
                  attn_impl="xla", enable_warmup=True,
                  compilation_cache_dir=cache)
    mc = resolve_model_config("tiny-llama")
    ModelRunner(EngineConfig(**fields), mc).warmup()    # cold: the manifest
    r = ModelRunner(EngineConfig(**fields), mc)
    r.warmup()
    manifest = r._warmup_manifest_path()
    assert os.path.exists(manifest)
    train = r.decode_train
    key = sorted(train.deferred)[0]

    def broken(k):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(train, "dummy_dispatch", broken)
    with pytest.raises(RuntimeError, match="capture failed"):
        r._first_use(train, key)
    assert key in train.deferred and r.deferred_captures_total == 0
    assert not os.path.exists(manifest)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_an_unusable_cache_directory_warms_fully(tmp_path):
    """A cache directory that cannot be made (here: under a regular file)
    is a warning, not a failed start: warm-up covers every variant and no
    manifest is kept."""
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    cfg = EngineConfig(model="tiny-llama", device="cpu", dtype="float32",
                       max_model_len=128, num_kv_blocks=32, max_num_seqs=2,
                       max_num_batched_tokens=32, num_decode_steps=4,
                       attn_impl="xla", enable_warmup=True,
                       compilation_cache_dir=str(blocker / "cache"))
    # The port's loggers do not propagate to the root logger.
    records = _Records()
    port_log = logging.getLogger("production_stack_tpu_torch")
    port_log.addHandler(records)
    try:
        r = ModelRunner(cfg, resolve_model_config("tiny-llama"))
    finally:
        port_log.removeHandler(records)
    assert r.compilation_cache_path is None
    assert any("unusable" in m for m in records.messages)
    r.warmup()
    assert r._warmup_manifest_path() is None
    assert r.startup_deferred_families == 0
    assert r.startup_cache_miss_families == \
        len(r.decode_graph_keys()) + len(r.prefill_graph_keys())
    assert not r.decode_train.deferred and not r.prefill_train.deferred
