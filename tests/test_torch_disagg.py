"""The port's prefill/decode disaggregation against the JAX package's.

PDX1 handoff manifests are held byte for byte (float32, bfloat16 and int8
blocks with scales, and finished bundles). Then engines on the CPU
(``tiny-llama-128dh``, the JAX params through numpy, float32, window path)
in three pairings — port prefill to port decode, JAX prefill to port
decode, port prefill to JAX decode — over the port's cache server, with
the reference's cases (``tests/test_disagg.py:321-424``): greedy and
seeded streams, a stop string, a request finished at token 1 and an abort
mid-stream on the decode hop. Tokens and text must equal the unified
port engine's exactly (the two packages' float32 engines give the same
tokens, ``tests/test_torch_engine.py``). Last, the stack's real router with
``--routing-logic disagg`` in front of a prefill-role and a decode-role
port engine drives both hops, streamed and not, and degrades to unified
serving when the decode engine is gone.
"""

import asyncio
import json
import time

import ml_dtypes
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.disagg import transfer as jtransfer
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu_torch.disagg import transfer
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.kv_offload import serde
from production_stack_tpu_torch.kv_offload import server as pserver
from production_stack_tpu_torch.kv_offload.remote import RemoteKVClient
from production_stack_tpu_torch.server.api_server import OpenAIServer
from tests.test_disagg import _router_args
from tests.test_torch_kv_offload import _thread_server
from tests.test_torch_surface import MODEL, _events, _http, _jax_engine, \
    _port_engine

PROMPT = "the quick brown fox jumps over the lazy dog " * 3


# --------------------------------------------------------------- manifests
def _manifest(mod, kind, bf16):
    """The same manifest for transfer module ``mod``: 3 blocks of
    ``kind`` (bfloat16 arrays in ``bf16``'s dtype), or a finished one."""
    if kind == "finished":
        return mod.HandoffManifest(
            request_id="req-2", prompt_token_ids=[9, 8, 7],
            output_token_ids=[3], num_computed_tokens=3, block_size=16,
            model=MODEL, finish_reason="stop", final_text="hi there")
    rng = np.random.default_rng(7)
    shape = (3, 2, 2, 4, 8)
    ks = vs = None
    if kind == "int8":
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ks = rng.standard_normal(shape[:-1]).astype(ml_dtypes.bfloat16) \
            .view(np.uint16).view(bf16)
        vs = rng.standard_normal(shape[:-1]).astype(ml_dtypes.bfloat16) \
            .view(np.uint16).view(bf16)
    elif kind == "bfloat16":
        k = rng.standard_normal(shape).astype(ml_dtypes.bfloat16) \
            .view(np.uint16).view(bf16)
        v = rng.standard_normal(shape).astype(ml_dtypes.bfloat16) \
            .view(np.uint16).view(bf16)
    else:
        k = rng.standard_normal(shape).astype(np.float32)
        v = rng.standard_normal(shape).astype(np.float32)
    return mod.HandoffManifest(
        request_id="req-1", prompt_token_ids=[1, 2, 3, 4, 5],
        output_token_ids=[42],
        output_logprobs=[[-0.5, [[42, -0.5], [7, -1.25]]]],
        num_computed_tokens=40, block_size=16, model=MODEL,
        kv_cache_dtype="int8" if kind == "int8" else "bfloat16",
        k=k, v=v, k_scale=ks, v_scale=vs)


def _fields(m):
    return (m.request_id, m.prompt_token_ids, m.output_token_ids,
            m.output_logprobs, m.num_computed_tokens, m.block_size, m.model,
            m.finish_reason, m.final_text, m.kv_cache_dtype, m.num_blocks,
            *[None if a is None else (a.shape, a.tobytes())
              for a in (m.k, m.v, m.k_scale, m.v_scale)])


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "finished"])
def test_manifest_bytes_match_jax(kind):
    """The port packs a manifest to the JAX package's PDX1 bytes, and each
    side unpacks the other's to the same fields and block bytes."""
    port = _manifest(transfer, kind, serde.BF16)
    jx = _manifest(jtransfer, kind, ml_dtypes.bfloat16)
    blob = transfer.pack_manifest(port)
    assert blob[:4] == b"PDX1"
    assert blob == jtransfer.pack_manifest(jx)
    assert _fields(transfer.unpack_manifest(blob)) == \
        _fields(jtransfer.unpack_manifest(blob)) == _fields(port)
    with pytest.raises(ValueError):
        transfer.unpack_manifest(b"NOPE" + blob[4:])


def test_transfer_lease_is_delete_after_consume():
    """Publish, peek (lease kept), consume (deleted) through the port's
    server; a missing key is None."""
    url, stop = _thread_server(pserver.serve_python)
    try:
        tm = transfer.TransferManager(RemoteKVClient(url))
        blob = transfer.pack_manifest(_manifest(transfer, "int8", serde.BF16))
        assert tm.publish("t:1", blob)
        assert tm.peek("t:1") == blob and tm.peek("t:1") == blob
        assert tm.consume("t:1") == blob
        assert tm.peek("t:1") is None and tm.consume("t:1") is None
        assert tm.client.stats()["deletes"] == 1
        tm.close()
    finally:
        stop()


# ----------------------------------------------------------------- engines
async def _collect(engine, sampling, prompt=None, **kw):
    return [out async for out in engine.generate(prompt=prompt,
                                                 sampling=sampling, **kw)]


def _text(outs):
    return "".join(o.text_delta for o in outs)


@pytest.mark.parametrize("pairing", ["port-to-port", "jax-to-port",
                                     "port-to-jax"])
async def test_disagg_parity_greedy_seeded_stop_and_abort(pairing):
    """The reference's disagg parity cases through a prefill engine and a
    decode engine of the given packages: each stream's tokens, text and
    finish reason equal the unified port engine's; consumed transfers
    leave the store; a request finished at token 1 replays its manifest;
    an abort on the decode hop frees the row. The prefill engine forms no
    decode batch."""
    src, _, dst = pairing.split("-")
    make = {"jax": _jax_engine, "port": _port_engine}
    scls = {"jax": JaxSampling, "port": SamplingParams}
    url, stop = _thread_server(pserver.serve_python)
    uni = _port_engine()
    pre = make[src](role="prefill", kv_remote_url=url)
    dec = make[dst](role="decode", kv_remote_url=url)
    for e in (uni, pre, dec):
        await e.start()

    async def hop(sampling, key):
        sp = dict(sampling)
        p = await _collect(pre, scls[src](**sp), PROMPT, handoff_key=key)
        assert p[-1].finished and len(p) == 1
        mani = dec.disagg.fetch_handoff(key)
        assert mani is not None
        dec.disagg.consume_handoff(key)
        return p, mani, await _collect(dec, scls[dst](**sp),
                                       handoff_state=mani)

    try:
        cases = {
            "greedy": dict(temperature=0.0, max_tokens=24, ignore_eos=True),
            "seeded": dict(temperature=0.9, top_p=0.9, seed=1234,
                           max_tokens=24, ignore_eos=True),
        }
        full = None
        for name, sp in cases.items():
            u = await _collect(uni, SamplingParams(**sp), PROMPT)
            p, mani, d = await hop(sp, f"t:{name}")
            assert p[-1].finish_reason == "handoff"
            assert mani.num_blocks == -(-mani.num_computed_tokens // 16)
            assert d[-1].token_ids == u[-1].token_ids, name
            assert len(d[-1].token_ids) == 24
            assert _text(d) == _text(u) and d[-1].finish_reason == "length"
            assert dec.disagg.fetch_handoff(f"t:{name}") is None  # leased
            if name == "greedy":
                full = _text(u)
        # a stop string from the middle of the greedy text
        assert len(full) >= 6, full
        stopper = full[len(full) // 2:len(full) // 2 + 2]
        sp = dict(temperature=0.0, max_tokens=24, ignore_eos=True,
                  stop=[stopper])
        u = await _collect(uni, SamplingParams(**sp), PROMPT)
        _, _, d = await hop(sp, "t:stop")
        assert u[-1].finish_reason == "stop"
        assert d[-1].token_ids == u[-1].token_ids
        assert _text(d) == _text(u) and d[-1].finish_reason == "stop"
        # finished at token 1: the manifest carries the result, no KV
        one = dict(temperature=0.0, max_tokens=1, ignore_eos=True)
        u = await _collect(uni, SamplingParams(**one), PROMPT)
        p = await _collect(pre, scls[src](**one), PROMPT, handoff_key="t:one")
        assert p[-1].finish_reason == "length"
        mani = dec.disagg.fetch_handoff("t:one")
        assert mani.finish_reason == "length" and mani.num_blocks == 0
        d = await _collect(dec, scls[dst](**one), handoff_state=mani)
        assert d[-1].token_ids == u[-1].token_ids and _text(d) == _text(u)
        # an abort on the decode hop frees the engine's state
        long = dict(temperature=0.0, max_tokens=50, ignore_eos=True)
        await _collect(pre, scls[src](**long), PROMPT, handoff_key="t:abort")
        mani = dec.disagg.fetch_handoff("t:abort")
        gen = dec.generate(handoff_state=mani, sampling=scls[dst](**long))
        n = 0
        async for out in gen:
            if n == 0:
                assert dec.scheduler.seqs[out.request_id].disagg_fallback
            n += 1
            if n >= 2:
                break
        await gen.aclose()
        deadline = time.monotonic() + 10
        while dec.scheduler.num_running and time.monotonic() < deadline:
            await asyncio.sleep(0.05)
        assert dec.scheduler.num_running == 0 and not dec._pending_restores
        assert pre.disagg.handoff_bytes_total > 0
        assert dec.disagg.handoff_bytes_total > 0
        assert pre.disagg.handoff_failures_total == 0
        assert dec.disagg.handoff_failures_total == 0
        assert pre.stats()["disagg_role"] == "prefill"
        assert pre.stats()["decode_dispatches_total"] == 0
        assert dec.stats()["prefill_dispatches_total"] == 0
    finally:
        for e in (uni, pre, dec):
            await e.stop()
            if hasattr(e, "shutdown"):
                e.shutdown()
        stop()


async def test_role_gates_and_refusals_answer_as_the_jax_server():
    """A plain request to a role-split engine is a 503 ``wrong_role``
    (retryable) unless it carries the fallback header; ``/disagg/prefill``
    on a unified engine is a 501 and on a decode engine a 503; a decode hop
    for a missing transfer is a 503 ``handoff_unavailable``; a handoff to
    an engine of another KV dtype is refused. Statuses and error types are
    the JAX server's."""
    url, stop = _thread_server(pserver.serve_python)
    body = {"model": MODEL, "prompt": "hi there", "max_tokens": 2,
            "temperature": 0.0, "ignore_eos": True}
    probes = [
        ("prefill", "/v1/completions", {}, body),
        ("prefill", "/v1/completions", {"x-pstpu-disagg-fallback": "1"},
         body),
        ("decode", "/v1/completions", {}, body),
        ("decode", "/v1/completions", {"x-pstpu-disagg": "decode",
                                       "x-pstpu-transfer-key": "t:none"},
         body),
        ("decode", "/disagg/prefill", {"x-pstpu-transfer-key": "t:x"}, body),
        ("unified", "/disagg/prefill", {"x-pstpu-transfer-key": "t:x"}, body),
        ("prefill", "/disagg/prefill", {}, body),
    ]
    try:
        answers = {}
        for side in ("port", "jax"):
            servers = {}
            for role in ("unified", "prefill", "decode"):
                kw = {} if role == "unified" else dict(role=role,
                                                       kv_remote_url=url)
                if side == "port":
                    srv = OpenAIServer(_port_engine(**kw), port=0)
                    await srv.start()
                else:
                    srv = TestClient(TestServer(JaxServer(
                        _jax_engine(**kw)).build_app()))
                    await srv.start_server()
                servers[role] = srv
            got = []
            for role, path, hdr, b in probes:
                srv = servers[role]
                if side == "port":
                    st, _, text = await _http(srv.port, "POST", path, b, hdr)
                else:
                    resp = await srv.post(path, json=b, headers=hdr)
                    st, text = resp.status, await resp.text()
                etype = (json.loads(text).get("error", {}).get("type")
                         if st != 200 else None)
                got.append((st, etype))
            answers[side] = got
            for srv in servers.values():
                if side == "port":
                    await srv.stop()
                    srv.engine.shutdown()
                else:
                    await srv.close()
        assert answers["port"] == answers["jax"]
        assert answers["port"][0] == (503, "wrong_role")
        assert answers["port"][1] == (200, None)
        assert answers["port"][3] == (503, "handoff_unavailable")
        # the engine refuses a bundle of another KV dtype or block size
        dec = _port_engine(role="decode", kv_remote_url=url,
                           kv_cache_dtype="int8")
        mani = _manifest(transfer, "float32", serde.BF16)
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            await _collect(dec, SamplingParams(), handoff_state=mani)
        mani.kv_cache_dtype, mani.block_size = "int8", 4
        with pytest.raises(ValueError, match="block_size"):
            await _collect(dec, SamplingParams(), handoff_state=mani)
        dec.shutdown()
    finally:
        stop()


async def test_router_disagg_two_hops_over_port_engines():
    """The stack's router (``--routing-logic disagg``) in front of a
    prefill-role and a decode-role port engine and the port's cache
    server: a streamed chat and a completion through both hops carry the
    unified engine's tokens; both engines move handoff bytes and report
    their role on /metrics; the prefill engine forms no decode batch and
    the decode engine no prefill batch; with the decode engine gone the
    request degrades to unified serving (200)."""
    from production_stack_tpu.router.app import build_app

    url, stop = _thread_server(pserver.serve_python)
    uni = _port_engine()
    await uni.start()
    pre = OpenAIServer(_port_engine(role="prefill", kv_remote_url=url), port=0)
    dec = OpenAIServer(_port_engine(role="decode", kv_remote_url=url), port=0)
    await pre.start()
    await dec.start()
    urls = [f"http://127.0.0.1:{s.port}" for s in (pre, dec)]
    router = TestClient(TestServer(build_app(_router_args(
        urls, [MODEL, MODEL], ["prefill", "decode"]))))
    await router.start_server()
    hdr = {"x-user-id": "u1", "x-pstpu-resume": "1"}
    try:
        for sp in (dict(temperature=0.0), dict(temperature=0.9, seed=11)):
            u = await _collect(uni, SamplingParams(
                max_tokens=12, ignore_eos=True, **sp),
                prompt=uni.tokenizer.apply_chat_template(
                    [{"role": "user", "content": "tell me a story"}],
                    add_generation_prompt=True))
            resp = await router.post("/v1/chat/completions", json={
                "model": MODEL, "stream": True, "max_tokens": 12,
                "ignore_eos": True, **sp,
                "messages": [{"role": "user", "content": "tell me a story"}],
            }, headers=hdr)
            assert resp.status == 200
            evs, done = _events(await resp.text())
            assert done
            toks = [t for e in evs for t in e["pstpu"]["toks"]]
            assert toks == u[-1].token_ids
            assert "".join(e["choices"][0]["delta"].get("content", "")
                           for e in evs) == _text(u)
        resp = await router.post("/v1/completions", json={
            "model": MODEL, "prompt": PROMPT, "max_tokens": 8,
            "temperature": 0.0, "ignore_eos": True}, headers=hdr)
        assert resp.status == 200
        body = await resp.json()
        u = await _collect(uni, SamplingParams(max_tokens=8, temperature=0.0,
                                               ignore_eos=True), PROMPT)
        assert body["choices"][0]["text"] == _text(u)
        assert body["usage"]["completion_tokens"] == 8
        for srv in (pre, dec):
            st, _, text = await _http(srv.port, "GET", "/metrics")
            lines = text.splitlines()
            hb = next(ln for ln in lines
                      if ln.startswith("pstpu:kv_handoff_bytes_total"))
            assert float(hb.rsplit(" ", 1)[1]) > 0
            assert any(ln.startswith("pstpu:disagg_role") and
                       f'role="{srv.engine.config.role}"' in ln
                       for ln in lines)
        assert pre.engine.stats()["decode_dispatches_total"] == 0
        assert dec.engine.stats()["prefill_dispatches_total"] == 0
        assert RemoteKVClient(url).stats()["deletes"] == 3
        await dec.stop()
        dec.engine.shutdown()
        resp = await router.post("/v1/completions", json={
            "model": MODEL, "prompt": "fallback please", "max_tokens": 4,
            "temperature": 0.0, "ignore_eos": True},
            headers={"x-user-id": "u2"})
        assert resp.status == 200, await resp.text()
        assert (await resp.json())["usage"]["completion_tokens"] == 4
    finally:
        await router.close()
        await pre.stop()
        pre.engine.shutdown()
        if dec._server is not None:
            await dec.stop()
            dec.engine.shutdown()
        await uni.stop()
        uni.shutdown()
        stop()
