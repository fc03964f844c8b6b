"""The port's KV tier at tensor parallelism against the JAX package's.

A tp > 1 port engine reads and writes whole logical blocks: every rank
selects or writes its own kv heads and rank 0 gathers or scatters them
(``KV_READ`` / ``KV_WRITE`` descriptors, ``parallel/mesh.py``), so a blob
holds the same ``[n, L, Hkv, bs, Dh]`` payload (and an int8 pool's ``[n, L,
Hkv, bs]`` scales) that a tp = 1 pool and the JAX package write. Held here
on the CPU (the port's ranks are gloo processes, the JAX package shards over
the conftest's 8 host devices):
  * block bytes: a port tp = 2 pool's blobs equal a JAX tp = 2 runner's and
    a port tp = 1 runner's for the same contents, bf16 and int8, and restore
    bit for bit into port tp = 1 / tp = 2 and JAX tp = 1 / tp = 4 (the
    counterpart of ``tests/test_multichip_serving.py``'s
    ``test_tp2_spill_restores_bit_exactly_on_tp1_and_tp4``);
  * served engines (``tiny-llama-128dh``, the JAX params through numpy,
    float32 compute): the host pool, the remote tier, ``/prewarm``,
    ``/prefix_index`` and the prefill/decode handoff at tp = 2, across
    meshes both ways; tokens equal the cold stream's, the unified engine's
    and the JAX engine's at the same tp, and the tier's failure counters
    stay 0;
  * a rank lost during a block read fails the engine within
    ``tp_timeout_s``, with one descriptor sent and no retry;
  * the restore cost model counts whole blocks, as the JAX engine's does.
"""

import asyncio
import json
import signal
import threading
import time

import numpy as np
import pytest
import torch

from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.runner import ModelRunner as JaxRunner
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.kv_offload import serde as jserde
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.parallel.mesh import make_mesh
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.kv_offload import manager, remote, serde
from production_stack_tpu_torch.kv_offload import server as pserver
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.sharding import (
    join_kv_blocks,
    shard_kv_blocks,
)
from production_stack_tpu_torch.server.api_server import OpenAIServer
from production_stack_tpu_torch.server.metrics import render_engine_metrics
from tests.test_torch_kv_offload import (
    _arrays,
    _prompt_hashes,
    _series_value,
    _spilled,
    _thread_server,
)
from tests.test_torch_surface import COMMON, _http, _jax_engine, _port_engine
from aiohttp.test_utils import TestClient, TestServer

TP_TIMEOUT_S = 60.0
BS = 16
PREFIX = "a system prompt every stream of this tier shares, block by block " * 2
PROMPTS = [PREFIX + "| first tail", PREFIX + "| the second tail"]
SAMPLINGS = (dict(temperature=0.0, max_tokens=8, ignore_eos=True),
             dict(temperature=0.8, top_p=0.9, seed=1234, max_tokens=8,
                  ignore_eos=True))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(tp=1, **over):
    if tp > 1:
        # A tp_timeout_s the test gives wins over the default.
        over = dict({"tp_timeout_s": TP_TIMEOUT_S, **over},
                    tensor_parallel_size=tp)
    return _port_engine(**over)


def _jax(tp=1, **over):
    return _jax_engine(tensor_parallel_size=tp, **over)


async def _serve(engine, sampling_cls=SamplingParams, prompts=PROMPTS):
    """Each prompt with its sampling, one after another: the token ids."""
    out = []
    for p, sp in zip(prompts, SAMPLINGS):
        last = None
        async for o in engine.generate(prompt=p, sampling=sampling_cls(**sp)):
            last = o
        out.append(last.token_ids)
    return out


def _gate_spills(engine):
    """Hold the JAX engine's spill thread until the returned event is set.
    At tp > 1 on the CPU backend, a spill read (one multi-device program)
    while a dispatch runs (another) can leave both threads waiting on their
    results for good, so the JAX side spills only while it is idle."""
    gate = threading.Event()
    spill = engine.offload._spill_batch

    def gated(batch):
        gate.wait()
        return spill(batch)

    engine.offload._spill_batch = gated
    return gate


def _failures(engine):
    st = engine.stats()
    return {k: st.get(k, 0) for k in (
        "kv_spill_failures_total", "kv_restore_failures_total",
        "kv_handoff_failures_total")}


def _blocks_bytes(arrays):
    return [None if a is None else a.tobytes() for a in arrays]


def _blobs(arrays, pack):
    k, v, ks, vs = arrays
    return [pack(k[i], v[i], None if ks is None else ks[i],
                 None if vs is None else vs[i]) for i in range(len(k))]


def _unpacked(blobs, unpack):
    parts = [unpack(b) for b in blobs]
    return [None if parts[0][j] is None else np.stack([p[j] for p in parts])
            for j in range(4)]


# ------------------------------------------------------------ block bytes
BLOCKS = [3, 7, 11, 2, 9]
AGAIN = [1, 4, 5, 6, 8]


def _block_cfg(kv):
    """tiny-llama-8kv: 8 kv heads, split over 2 and 4 ranks."""
    return dict(model="tiny-llama-8kv", dtype="bfloat16", max_model_len=128,
                block_size=4, num_kv_blocks=16, kv_cache_dtype=kv,
                max_num_seqs=4, max_num_batched_tokens=64)


def _jax_runner(kv, tp):
    cfg = JaxConfig(**_block_cfg(kv), tensor_parallel_size=tp)
    return JaxRunner(cfg, jax_resolve(cfg.model), make_mesh(1, 1, tp))


def test_block_batches_split_and_join_as_the_pool_heads():
    """``shard_kv_blocks`` takes the heads ``shard_kv_pool`` gives a rank
    (contiguous ranges), and ``join_kv_blocks`` is its inverse."""
    x = torch.arange(3 * 2 * 8 * 4 * 5).view(3, 2, 8, 4, 5)
    for tp in (1, 2, 4):
        parts = [shard_kv_blocks(x, r, tp) for r in range(tp)]
        assert all(p.shape[2] == 8 // tp for p in parts)
        assert torch.equal(parts[-1][:, :, -1], x[:, :, -1])
        assert torch.equal(join_kv_blocks(parts), x)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_tp2_blocks_are_whole_and_restore_on_every_mesh(kv, monkeypatch):
    """A port tp = 2 pool seeded through ``write_blocks`` reads back the
    same bytes (in several block-exchange chunks; the pools written in
    place, each rank holding its contiguous heads); its ``pack_block``
    blobs equal those of a JAX tp = 2 runner and of a port tp = 1 runner
    holding the same contents; each blob restores bit for bit into port
    tp = 1 and tp = 2 and into JAX tp = 1 and tp = 4."""
    mc = resolve_model_config("tiny-llama-8kv")
    shape = (len(BLOCKS), mc.num_layers, mc.num_kv_heads, 4, mc.head_dim_)
    port_in, jax_in = _arrays("int8" if kv == "int8" else "bfloat16", shape,
                              seed=11)
    # Two blocks of a rank's K pool per collective: three chunks.
    row = mc.num_layers * (mc.num_kv_heads // 2) * 4 * mc.head_dim_ * (
        1 if kv == "int8" else 2)
    monkeypatch.setattr(mesh, "BLOCK_IO_CHUNK_BYTES", 2 * row)
    eng = ServingEngine(EngineConfig(**_block_cfg(kv), device="cpu",
                                     tensor_parallel_size=2,
                                     tp_timeout_s=TP_TIMEOUT_S))
    try:
        r2 = eng.runner
        assert r2._io_chunk() == 2
        ptrs = [t.data_ptr() for t in r2._pools()]
        r2.write_blocks(BLOCKS, *port_in)
        got = r2.read_blocks(BLOCKS)
        assert _blocks_bytes(got) == _blocks_bytes(port_in)
        assert [t.data_ptr() for t in r2._pools()] == ptrs
        # rank 0 holds heads [0, Hkv/2) of every block it wrote
        mine = r2._block_view(r2.kv_k)[:, :, BLOCKS].movedim(2, 0)
        want = shard_kv_blocks(torch.from_numpy(port_in[0].view(np.int16)
                                                if kv != "int8" else port_in[0]),
                               0, 2)
        assert mine.contiguous().view(want.dtype).numpy().tobytes() == \
            want.numpy().tobytes()
        blobs = _blobs(got, serde.pack_block)
        # each blob back into the tp = 2 pool at other blocks
        r2.write_blocks(AGAIN, *_unpacked(blobs, serde.unpack_block))
        assert _blocks_bytes(r2.read_blocks(AGAIN)) == _blocks_bytes(port_in)
        assert r2.read_blocks([])[0].shape == (0,) + shape[1:]
    finally:
        eng.shutdown()
    r1 = ModelRunner(EngineConfig(**_block_cfg(kv), device="cpu"), mc)
    r1.write_blocks(BLOCKS, *port_in)
    assert _blobs(r1.read_blocks(BLOCKS), serde.pack_block) == blobs
    r1.write_blocks(AGAIN, *_unpacked(blobs, serde.unpack_block))
    assert _blocks_bytes(r1.read_blocks(AGAIN)) == _blocks_bytes(port_in)
    j2 = _jax_runner(kv, 2)
    j2.write_blocks(BLOCKS, *jax_in)
    assert _blobs(j2.read_blocks(BLOCKS), jserde.pack_block) == blobs
    for tp in (1, 4):
        j = _jax_runner(kv, tp)
        j.write_blocks(AGAIN, *_unpacked(blobs, jserde.unpack_block))
        assert _blobs(j.read_blocks(AGAIN), jserde.pack_block) == blobs


# --------------------------------------------------------- served engines
SERIES = ("kv_offload_blocks", "kv_restore_saved_tokens_total",
          "kv_shared_tier_hits_total", "kv_shared_tier_misses_total",
          "kv_chain_evictions_total", "kv_quant_bytes_saved_total",
          "prefix_index_size")


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
async def test_tp2_host_pool_restore_matches_cold_and_jax_tp2(kv):
    """A port tp = 2 engine with the host tier serves the prompts cold,
    spills every full block (whole blocks gathered over the ranks), drops
    its device prefix cache and serves them again from the host pool:
    greedy and seeded tokens equal the cold ones and the JAX tp = 2
    engine's with the same tier; both restore the same tokens and render
    the same KV-tier series on ``/metrics`` and list the same prefix
    digest; no failure is counted."""
    from production_stack_tpu.server.metrics import (
        render_engine_metrics as jax_render,
    )

    got = {}
    for side, make, scls, render in (
            ("port", _port, SamplingParams, render_engine_metrics),
            ("jax", _jax, JaxSampling, jax_render)):
        e = make(2, kv_offload_cpu=True, kv_offload_max_cpu_gb=0.5,
                 kv_cache_dtype=kv)
        e.offload.flush_interval = 0.02
        # the port's spills run beside its dispatches; the JAX side's wait
        gate = _gate_spills(e) if side == "jax" else threading.Event()
        await e.start()
        try:
            cold = await _serve(e, scls)
            # what /prefix_index lists (both servers answer prefix_digest)
            digest = sorted(e.block_manager.prefix_digest()[0])
            gate.set()
            await _spilled(e, e.block_manager.prefix_index_size)
            gate.clear()
            e.block_manager.reset_prefix_cache()
            again = await _serve(e, scls)
            gate.set()
            text = render(e, COMMON["model"])
            got[side] = (cold, again, e.offload.restored_tokens_total, digest,
                         [_series_value(text, f"pstpu:{n}") for n in SERIES])
            if side == "port":
                fails = _failures(e)
                n_full = len(_prompt_hashes(e.tokenizer.encode(PROMPTS[0]),
                                            BS))
        finally:
            gate.set()
            await e.stop()
            if side == "port":
                e.shutdown()
    assert got["port"] == got["jax"]
    cold, again, restored, digest, _ = got["port"]
    assert len(digest) >= n_full
    assert again == cold and all(len(t) == 8 for t in cold)
    assert restored >= n_full * BS
    assert not any(fails.values()), fails


async def test_tp2_spill_prewarms_at_tp2_and_restores_on_tp1():
    """A port tp = 2 engine spills to the port's cache server and answers
    ``/prefix_index`` with its ``prefix_digest``; a fresh tp = 2 engine
    behind the port's server takes ``POST /prewarm``, answering as the JAX
    server at tp = 2 does on the same store, and serves the prompts from
    its device prefix cache with the same tokens; then a fresh tp = 1
    engine restores the prompts from the store: its pool bytes equal the
    blobs, its tokens the tp = 2 engine's."""
    url, stop = _thread_server(pserver.serve_python)
    try:
        a = _port(2, kv_remote_url=url)
        a.offload.flush_interval = 0.02
        srv = OpenAIServer(a, port=0)
        await srv.start()
        try:
            cold = await _serve(a)
            st, _, text = await _http(srv.port, "GET", "/prefix_index")
            entries, truncated = a.block_manager.prefix_digest()
            assert st == 200 and json.loads(text)["entries"] == entries
            assert len(entries) >= 2 and not truncated
            n_stored = a.block_manager.prefix_index_size
            await _spilled(a, n_stored)
            assert not any(_failures(a).values())
        finally:
            await srv.stop()
            a.shutdown()
        hashes = _prompt_hashes(a.tokenizer.encode(PROMPTS[0]), BS)
        # the JAX server first: it only prewarms, leaving the store as it
        # found it for the port's (which then serves, and spills)
        jc = TestClient(TestServer(JaxServer(
            _jax(2, kv_remote_url=url)).build_app()))
        await jc.start_server()
        resp = await jc.post("/prewarm", json={"top_k": 4})
        jst, jres = resp.status, await resp.json()
        await jc.close()
        srv = OpenAIServer(_port(2, kv_remote_url=url), port=0)
        await srv.start()
        try:
            st, _, text = await _http(srv.port, "POST", "/prewarm",
                                      {"top_k": 4})
            res = json.loads(text)
            eng = srv.engine
            hits0 = eng.block_manager.prefix_hits_total
            out = await _serve(eng)
            assert out == cold
            assert eng.block_manager.prefix_hits_total - hits0 >= \
                2 * len(hashes) * BS
            assert eng.offload.restored_tokens_total == 0
            assert eng.stats()["prewarmed_blocks_total"] == n_stored
            assert not any(_failures(eng).values())
        finally:
            await srv.stop()
            srv.engine.shutdown()
        assert st == jst == 200
        res.pop("seconds")
        jres.pop("seconds")
        assert res == jres, (res, jres)
        assert res["blocks"] == n_stored >= len(hashes)
        b = _port(1, kv_remote_url=url)
        await b.start()
        try:
            out = await _serve(b)
            assert out == cold
            assert b.offload.restored_tokens_total >= len(hashes) * BS
            c = remote.RemoteKVClient(url)
            blobs = c.multi_get(hashes)
            c.close()
            for h, blob in zip(hashes, blobs):
                blk = b.block_manager._hash_to_block[h]
                k, v, _, _ = serde.unpack_block(serde.unpack_chain(blob)[1])
                assert _blocks_bytes(b.runner.read_blocks([blk])) == [
                    k[None].tobytes(), v[None].tobytes(), None, None]
            assert not any(_failures(b).values())
        finally:
            await b.stop()
            b.shutdown()
    finally:
        stop()


async def _hop(pre, dec, sp, key, prompt):
    """Both hops of one request through the engine API: the prefill engine
    publishes under ``key``, the decode engine restores and continues."""
    outs = [o async for o in pre.generate(
        prompt=prompt, sampling=SamplingParams(**sp), handoff_key=key)]
    assert outs[-1].finished and outs[-1].finish_reason == "handoff"
    mani = dec.disagg.fetch_handoff(key)
    assert mani is not None and mani.num_blocks > 0
    dec.disagg.consume_handoff(key)
    last = None
    async for o in dec.generate(handoff_state=mani,
                                sampling=SamplingParams(**sp)):
        last = o
    return last.token_ids


async def test_handoff_between_tp2_and_tp1_both_ways():
    """A tp = 2 prefill engine hands off to a tp = 1 decode engine through
    the store, then a tp = 1 prefill engine to a tp = 2 decode engine:
    greedy and seeded tokens equal the unified tp = 1 engine's on the same
    request, and neither side counts a failure."""
    url, stop = _thread_server(pserver.serve_python)
    uni = _port(1)
    await uni.start()
    try:
        want = await _serve(uni)
    finally:
        await uni.stop()
        uni.shutdown()
    try:
        for n, (tp_pre, tp_dec) in enumerate(((2, 1), (1, 2))):
            pre = _port(tp_pre, role="prefill", kv_remote_url=url)
            dec = _port(tp_dec, role="decode", kv_remote_url=url)
            await pre.start()
            await dec.start()
            try:
                got = [await _hop(pre, dec, sp, f"t:{n}:{i}", p)
                       for i, (p, sp) in enumerate(zip(PROMPTS, SAMPLINGS))]
                assert got == want, (tp_pre, tp_dec)
                for e in (pre, dec):
                    assert not any(_failures(e).values())
                assert pre.stats()["decode_dispatches_total"] == 0
                assert dec.stats()["prefill_dispatches_total"] == 0
            finally:
                for e in (pre, dec):
                    await e.stop()
                    e.shutdown()
    finally:
        stop()


async def test_rank_lost_during_a_block_read_fails_the_engine():
    """Rank 1 is killed right after the spill thread's ``KV_READ``
    descriptor went out: the read fails without a retry (one descriptor),
    the spill counts its failure, and the engine is unhealthy within
    ``tp_timeout_s``; later requests raise and the engine stops."""
    timeout = 8.0
    eng = _port(2, kv_offload_cpu=True, tp_timeout_s=timeout)
    eng.offload.flush_interval = 0.02
    sent = []
    send = eng.mesh.send_header
    proc = eng.mesh.procs[0]

    def send_header(kind, *args):
        send(kind, *args)
        if kind == mesh.KV_READ:
            sent.append(args)
            if len(sent) == 1:
                proc.send_signal(signal.SIGKILL)
                proc.wait()
                t_kill.append(time.monotonic())

    t_kill = []
    eng.mesh.send_header = send_header
    await eng.start()
    try:
        try:
            await _serve(eng, prompts=PROMPTS[:1])
        except RuntimeError as e:
            assert "engine unavailable" in str(e)
        deadline = time.monotonic() + timeout + 30
        while (eng.offload.spill_failures_total == 0 or eng.is_healthy) \
                and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert t_kill and eng.offload.spill_failures_total > 0
        assert time.monotonic() - t_kill[0] < timeout + 30
        assert not eng.is_healthy and len(sent) == 1
        with pytest.raises(RuntimeError, match="engine unavailable"):
            await _serve(eng, prompts=PROMPTS[:1])
        assert len(sent) == 1
    finally:
        await asyncio.wait_for(eng.stop(), 30)
        eng.shutdown()


def test_restore_cost_model_counts_whole_blocks_as_jax():
    """At tp = 2 the manager reckons the bytes of the whole block that
    crosses the link (every kv head), as the JAX engine's does: for the
    same prefix, store, link and prefill knobs both restore or decline the
    same tokens, including at a link rate where one rank's bytes alone
    would have restored."""
    url, stop = _thread_server(pserver.serve_python)
    mc = resolve_model_config(COMMON["model"])
    tokens = list(range(3, 3 + 4 * BS + 1))
    shape = (mc.num_layers, mc.num_kv_heads, BS, mc.head_dim_)
    c = remote.RemoteKVClient(url)
    prev = b""
    for i in range(4):
        from production_stack_tpu_torch.engine.kv_cache import _block_hash
        h = _block_hash(prev, tokens[i * BS:(i + 1) * BS])
        k, v, _, _ = _arrays("float32", shape, seed=i)[0]
        c.put(h, serde.pack_chain(prev, serde.pack_block(k, v)))
        prev = h
    c.close()
    port = _port(2, kv_remote_url=url)
    jx = _jax(2, kv_remote_url=url)
    try:
        bpt = port.offload.bytes_per_token
        assert bpt == jx.offload.bytes_per_token
        assert bpt == EngineConfig(**COMMON, device="cpu") \
            .kv_cache_bytes_per_token(mc)
        p = port.offload.prefill_tok_s
        edge = bpt * p / 1e9    # the link rate where restore ties recompute
        decisions = {}
        for side, e in (("port", port), ("jax", jx)):
            row = []
            for g in (0.4 * edge, 0.75 * edge, 1.5 * edge, 3 * edge):
                e.offload.link_gbps = g
                bm = e.block_manager
                blocks, cached = bm.allocate_prompt(tokens)
                restored = e.offload.try_restore(tokens, blocks, cached)
                bm.free_blocks(blocks)
                row.append((restored,
                            e.offload.restore_declined_tokens_total))
            decisions[side] = row
        assert decisions["port"] == decisions["jax"]
        assert [r for r, _ in decisions["port"]] == [0, 0, 4 * BS, 4 * BS]
        # one rank's bytes alone would have restored at 0.75 of the edge
        assert manager.restore_beats_recompute(
            4 * BS, bpt // 2, 0.75 * edge, p)
        assert port.offload.restore_failures_total == 0
    finally:
        port.shutdown()
        stop()


def test_launcher_gives_each_engine_its_role_and_tp(monkeypatch):
    """``launch.py --roles prefill,decode --tensor-parallel-sizes 2,1``
    starts a tp = 2 prefill engine and a tp = 1 decode engine (the flags
    reach ``launch_engines`` per engine); a list of the wrong length is a
    usage error."""
    from production_stack_tpu_torch import launch

    seen = {}

    class Proc:
        pid = 1

        def poll(self):
            return 0

    class Handle:
        urls, ready_seconds, log_paths = ["u0", "u1"], [0.0, 0.0], []
        procs = [Proc(), Proc()]

        def stop(self):
            seen["stopped"] = True

    def fake(model, n, extra, device, log_dir, timeout, per_engine):
        seen.update(model=model, n=n, extra=extra, per_engine=per_engine)
        return Handle()

    monkeypatch.setattr(launch, "launch_engines", fake)
    saved = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM,
                                                     signal.SIGINT)}
    try:
        launch.main(["--model", "tiny-llama-8kv", "--device", "cpu",
                     "--num-engines", "2", "--roles", "prefill,decode",
                     "--tensor-parallel-sizes", "2,1", "--",
                     "--max-model-len", "512"])
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    assert seen["per_engine"] == [
        ["--role", "prefill", "--tensor-parallel-size", "2"],
        ["--role", "decode", "--tensor-parallel-size", "1"]]
    assert seen["extra"] == ["--max-model-len", "512"] and seen["stopped"]
    with pytest.raises(SystemExit):
        launch.main(["--num-engines", "2", "--tensor-parallel-sizes", "2"])
