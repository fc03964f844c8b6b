"""The port's sampling surface against the JAX package's: logprobs (the
function, the engine, both HTTP formats, streamed and not), ``n`` fan-out,
multi-prompt completions, the 400s of ``_check_unsupported``, and
mid-stream resume (a JAX engine's stream resumed on the port, port to
port, and the refusal of a finished stream).

Both sides serve the same float32 weights (the JAX params through numpy)
of ``tiny-llama-128dh`` on the CPU, on the window path. Logprobs are
compared within 1e-4 (the two frameworks' f32 logits differ by rounding);
top-k ids where neighbouring values differ by more than 1e-5
(``torch.topk`` promises no order among ties; ``jax.lax.top_k`` puts the
lower id first).
"""

import asyncio
import functools
import json
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine import runner as jax_runner
from production_stack_tpu.engine import sampling as jsampling
from production_stack_tpu.engine.config import EngineConfig as JaxConfig
from production_stack_tpu.engine.engine import ServingEngine as JaxEngine
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu.server import api_server as jax_api
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import ServingEngine
from production_stack_tpu_torch.engine.sampling import (
    SamplingParams,
    compute_logprobs,
    gumbel_noise,
    logprobs_bucket,
    sampling_scores,
)
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.server.api_server import OpenAIServer

MODEL = "tiny-llama-128dh"
LP_TOL = 1e-4
# prefill + 2 decode dispatches of 4 steps for one row.
COMMON = dict(model=MODEL, max_model_len=256, block_size=16, num_kv_blocks=96,
              attn_impl="window", num_decode_steps=4, dtype="float32",
              max_num_batched_tokens=64, max_num_seqs=8)


@functools.lru_cache(maxsize=None)
def _jax_params():
    return jax_init(jax_resolve(MODEL), jax.random.PRNGKey(0), jnp.float32)


def _port_engine(**over):
    return ServingEngine(
        EngineConfig(**{**COMMON, **over}, device="cpu"),
        params=params_from_jax(jax.tree.map(np.asarray, _jax_params()),
                               resolve_model_config(MODEL), torch.float32))


def _jax_engine(**over):
    return JaxEngine(JaxConfig(**{**COMMON, **over}), params=_jax_params())


# ------------------------------------------------------------------ http
async def _http(port, method, path, body=None, headers=None):
    """(status, headers, body text) of one request to a port server."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = json.dumps(body).encode() if body is not None else b""
    head = {"Host": "127.0.0.1", "Content-Length": str(len(data)),
            "Content-Type": "application/json", **(headers or {})}
    writer.write((f"{method} {path} HTTP/1.1\r\n"
                  + "".join(f"{k}: {v}\r\n" for k, v in head.items())
                  + "\r\n").encode() + data)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head_raw, _, text = raw.partition(b"\r\n\r\n")
    lines = head_raw.decode().split("\r\n")
    hdrs = {k.strip().lower(): v.strip() for k, _, v in
            (ln.partition(":") for ln in lines[1:])}
    return int(lines[0].split()[1]), hdrs, text.decode()


def _events(text):
    """The JSON payloads of an SSE body (without [DONE]), and whether it
    ended in [DONE]."""
    data = [ln[6:] for ln in text.splitlines() if ln.startswith("data: ")]
    return [json.loads(d) for d in data if d != "[DONE]"], \
        bool(data) and data[-1] == "[DONE]"


class _Servers:
    """The JAX server (aiohttp test client) and the port's (a socket),
    over the same weights."""

    async def __aenter__(self):
        self.jax = TestClient(TestServer(JaxServer(_jax_engine()).build_app()))
        await self.jax.start_server()
        self.port_server = OpenAIServer(_port_engine(), port=0)
        await self.port_server.start()
        self.port = self.port_server.port
        return self

    async def __aexit__(self, *exc):
        await self.jax.close()
        await self.port_server.stop()
        self.port_server.engine.shutdown()

    async def both(self, path, body, headers=None):
        """(JAX status, JSON or text), (port status, JSON or text)."""
        resp = await self.jax.post(path, json=body, headers=headers or {})
        jtext = await resp.text()
        st, _, ptext = await _http(self.port, "POST", path, body, headers)
        if body.get("stream"):
            return (resp.status, jtext), (st, ptext)
        return (resp.status, json.loads(jtext)), (st, json.loads(ptext))


# -------------------------------------------------------------- function
def test_compute_logprobs_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 512)).astype(np.float32) * 3
    chosen = rng.integers(0, 512, 6).astype(np.int32)
    for k in (0, 3, 8, 20):
        jc, jt, ji = (np.asarray(x) for x in jsampling.compute_logprobs(
            jnp.asarray(logits), jnp.asarray(chosen), k))
        tc, tt, ti = (x.numpy() for x in compute_logprobs(
            torch.from_numpy(logits), torch.from_numpy(chosen), k))
        assert np.abs(tc - jc).max() <= 1e-5
        assert tt.shape == jt.shape == (6, k) and ti.dtype == np.int32
        if k:
            assert np.abs(tt - jt).max() <= 1e-5
            np.testing.assert_array_equal(ti, ji)
    assert [logprobs_bucket(k) for k in (0, 5, 8, 9, 20)] == [8, 8, 8, 20, 20]


@pytest.mark.parametrize("k", [1, 3, 8, 20])
def test_compute_logprobs_on_tied_logits_matches_jax(k):
    """Logits tied within and across the top k (a row of one value, rows of
    a few repeated values): the top-k ids and logprobs are jax.lax.top_k's,
    lower id first among equals and the lowest ids kept at the k-th place,
    bit for bit."""
    rng = np.random.default_rng(k)
    logits = rng.integers(-2, 3, (6, 512)).astype(np.float32)
    logits[0] = 0.5
    logits[1, 100:140] = 9.0
    chosen = rng.integers(0, 512, 6).astype(np.int32)
    jc, jt, ji = (np.asarray(x) for x in jsampling.compute_logprobs(
        jnp.asarray(logits), jnp.asarray(chosen), k))
    tc, tt, ti = (x.numpy() for x in compute_logprobs(
        torch.from_numpy(logits), torch.from_numpy(chosen), k))
    np.testing.assert_array_equal(ti, ji)
    assert np.abs(tt - jt).max() <= 1e-6 and np.abs(tc - jc).max() <= 1e-6
    assert (np.diff(ti[0]) > 0).all()


def test_sampling_scores_match_jax():
    """The score field the unfiltered sampler takes its argmax of: raw
    logits for greedy rows, logits / T + Gumbel for sampled rows, the
    JAX package's bits (the Gumbel field is the port's bit-exact copy)."""
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 512)).astype(np.float32)
    temps = np.array([0.0, 0.7, 1.0, 1.3], np.float32)
    seeds = np.array([3, 99, 2**32 - 1, 12345], np.uint32)
    want = np.asarray(jsampling.sampling_scores(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(seeds)))
    got = sampling_scores(torch.from_numpy(logits), torch.from_numpy(temps),
                          gumbel_noise(seeds.tolist(), 512, torch.device("cpu")))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------- engine
async def _gen(engine, prompt, sp, **kw):
    final = None
    async for out in engine.generate(prompt=prompt, sampling=sp, **kw):
        final = out
    return final


@pytest.mark.parametrize("seeded", [False, True])
async def test_engine_logprobs_match_jax(seeded):
    """Prefill and two 4-step decode dispatches, one greedy or seeded row
    beside a row without logprobs: the same tokens, chosen and top
    logprobs within 1e-4, and the same tokens with logprobs off."""
    extra = dict(temperature=0.8, seed=11) if seeded else dict(temperature=0.0)
    fields = dict(max_tokens=9, ignore_eos=True, **extra)
    jeng, eng = _jax_engine(), _port_engine()
    outs = {}
    for name, e, cls in (("jax", jeng, JaxSampling), ("port", eng, SamplingParams)):
        await e.start()
        try:
            outs[name] = await asyncio.gather(
                _gen(e, "logprobs on", cls(**fields, logprobs=5)),
                _gen(e, "a plain row", cls(**fields)))
            outs[name + "-off"] = await _gen(e, "logprobs on", cls(**fields))
        finally:
            await e.stop()
    eng.shutdown()
    (j, jplain), (p, pplain) = outs["jax"], outs["port"]
    assert p.token_ids == j.token_ids and len(p.token_ids) == 9
    assert pplain.token_ids == jplain.token_ids and pplain.logprobs is None
    assert outs["port-off"].token_ids == p.token_ids
    assert len(p.logprobs) == len(j.logprobs) == 9
    for tok, (pc, ptop), (jc, jtop) in zip(p.token_ids, p.logprobs, j.logprobs):
        assert abs(pc - jc) <= LP_TOL and pc <= 0.0
        assert len(ptop) == len(jtop) == 5
        assert max(abs(a[1] - b[1]) for a, b in zip(ptop, jtop)) <= LP_TOL
        assert [i for i, _ in ptop] == [i for i, _ in jtop]
        if not seeded:
            assert ptop[0][0] == tok and abs(ptop[0][1] - pc) <= 1e-6


async def test_logprob_decode_rows_use_the_logprob_variant_family():
    """A logprob row makes its decode dispatches the (b, mb, K, False, 8)
    family, which warmup reserved; the bucket of 20 is another family."""
    eng = _port_engine(enable_warmup=True)
    keys = []
    run = eng.runner.decode_train.run
    eng.runner.decode_train.run = lambda key, bf, n: (keys.append(key),
                                                      run(key, bf, n))[1]
    await eng.start()
    try:
        await _gen(eng, "x", SamplingParams(max_tokens=5, temperature=0.0,
                                            ignore_eos=True, logprobs=2))
        await _gen(eng, "y", SamplingParams(max_tokens=5, temperature=0.0,
                                            ignore_eos=True, logprobs=15))
    finally:
        await eng.stop()
        eng.shutdown()
    assert {k[4] for k in keys} == {8, 20}
    assert all(k[:4] + (8, False) in eng.runner.decode_graph_keys()
               for k in keys if k[4] == 8)


# ------------------------------------------------------------------ HTTP
_CHAT = {"messages": [{"role": "user", "content": "hi there"}]}


@pytest.mark.parametrize("stream", [False, True])
async def test_http_logprobs_match_jax(stream):
    """Completions (logprobs 3) and chat (top_logprobs 2) bodies of both
    servers: the same shapes, tokens and text offsets, logprobs within
    1e-4; streamed, the chunks' blocks cover every token and text_offset
    runs on across chunks."""
    base = {"max_tokens": 9, "temperature": 0, "ignore_eos": True,
            "stream": stream}
    async with _Servers() as s:
        (js, jc), (ps, pc) = await s.both("/v1/completions", {
            **base, "prompt": "hello world", "logprobs": 3})
        (jcs, jch), (pcs, pch) = await s.both("/v1/chat/completions", {
            **base, **_CHAT, "logprobs": True, "top_logprobs": 2})
    assert js == ps == jcs == pcs == 200
    if stream:
        blocks = []
        for text in (jc, pc):
            evs, done = _events(text)
            assert done
            blocks.append([c["logprobs"] for e in evs for c in e["choices"]
                           if c.get("logprobs")])
        merged = [{k: sum((b[k] for b in bl), []) for k in bl[0]}
                  for bl in blocks]
        jlp, plp = merged
        chats = [[i for e in _events(t)[0] for c in e["choices"]
                  if c.get("logprobs") for i in c["logprobs"]["content"]]
                 for t in (jch, pch)]
    else:
        jlp, plp = jc["choices"][0]["logprobs"], pc["choices"][0]["logprobs"]
        assert pc["choices"][0]["text"] == jc["choices"][0]["text"]
        chats = [b["choices"][0]["logprobs"]["content"] for b in (jch, pch)]
    assert plp["tokens"] == jlp["tokens"] and len(plp["tokens"]) == 9
    assert plp["text_offset"] == jlp["text_offset"]
    assert plp["text_offset"][0] == 0
    assert max(abs(a - b) for a, b in zip(plp["token_logprobs"],
                                          jlp["token_logprobs"])) <= LP_TOL
    for pt, jt in zip(plp["top_logprobs"], jlp["top_logprobs"]):
        assert set(pt) == set(jt)
        assert max(abs(pt[k] - jt[k]) for k in pt) <= LP_TOL
    jchat, pchat = chats
    assert len(pchat) == len(jchat) == 9
    for a, b in zip(pchat, jchat):
        assert a["token"] == b["token"] and a["bytes"] == b["bytes"]
        assert abs(a["logprob"] - b["logprob"]) <= LP_TOL
        assert len(a["top_logprobs"]) == 2
        assert max(abs(x["logprob"] - y["logprob"]) for x, y in
                   zip(a["top_logprobs"], b["top_logprobs"])) <= LP_TOL


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", {**_CHAT, "max_tokens": 4, "temperature": 0.9,
                              "seed": 7, "n": 3, "ignore_eos": True}),
    ("/v1/completions", {"prompt": ["one two", "three four five"],
                         "max_tokens": 3, "temperature": 0,
                         "ignore_eos": True}),
    ("/v1/completions", {"prompt": ["one two", "three four five"], "n": 2,
                         "max_tokens": 2, "temperature": 0.7, "seed": 3,
                         "ignore_eos": True}),
])
async def test_fanout_and_multi_prompt_match_jax(path, body):
    """n fan-out (choice i seeded seed + i) and multi-prompt completions:
    choice by choice the JAX server's answer, usage summed, and a second
    seeded call gives the same choices."""
    async with _Servers() as s:
        (js, jb), (ps, pb) = await s.both(path, body)
        _, (_, again) = await s.both(path, body)
    assert js == ps == 200
    n_choices = body.get("n", 1) * (len(body["prompt"])
                                    if "prompt" in body else 1)
    key = "message" if "messages" in body else "text"

    def texts(b):
        return [c[key]["content"] if key == "message" else c[key]
                for c in b["choices"]]

    assert [c["index"] for c in pb["choices"]] == list(range(n_choices))
    assert texts(pb) == texts(jb) == texts(again)
    assert pb["usage"] == jb["usage"]
    assert pb["usage"]["completion_tokens"] == n_choices * body["max_tokens"]
    if body.get("n", 1) > 1 and body.get("temperature"):
        assert len(set(texts(pb))) > 1


_BAD_COMPLETIONS = [{"logit_bias": {"5": 1.0}}, {"suffix": "tail"},
                    {"echo": True}, {"best_of": 3}, {"n": 0}, {"n": 99},
                    {"logprobs": 9}, {"logprobs": True}]
_BAD_CHAT = [{"logit_bias": {"5": 1.0}}, {"logprobs": 3}, {"logprobs": 0},
             {"logprobs": 1}, {"logprobs": True, "top_logprobs": 30},
             {"logprobs": True, "top_logprobs": True},
             {"resume_tokens": []}, {"resume_tokens": [1], "n": 2}]


async def test_unsupported_parameters_400_as_jax():
    """Every body the reference refuses with 400 (``_check_unsupported``,
    bool/int validation, bad resume fields), the port refuses too."""
    async with _Servers() as s:
        for path, base, bad in (
                ("/v1/completions", {"prompt": "x", "max_tokens": 1},
                 _BAD_COMPLETIONS),
                ("/v1/chat/completions", {**_CHAT, "max_tokens": 1}, _BAD_CHAT)):
            for extra in bad:
                (js, _), (ps, pb) = await s.both(path, {**base, **extra})
                assert (js, ps) == (400, 400), (path, extra)
                assert pb["error"]["code"] == 400


# ---------------------------------------------------------------- resume
_RESUME = {"prompt": "resume this stream", "max_tokens": 20,
           "temperature": 0.8, "ignore_eos": True, "stream": True}
_HDR = {"x-pstpu-resume": "1"}


def _payloads(text):
    evs, done = _events(text)
    assert done
    toks = []
    for e in evs:
        assert e["pstpu"]["off"] == len(toks)
        toks += e["pstpu"]["toks"]
    return evs, toks


async def test_jax_stream_resumed_on_the_port(monkeypatch):
    """The router's cross-engine failover: an unseeded stream the JAX
    engine began, cut after a chunk, resumed on the port from that chunk's
    pstpu payload, ends in the JAX stream's tokens and text.

    An unseeded stream's seed derives from ``hash(request_id)``: a random
    id, hashed under the process's own PYTHONHASHSEED. At this model's
    512-token vocab most tokens decode to no text (ids >= 256 are not
    bytes, 128-255 are incomplete UTF-8), and the server writes a chunk
    only once its text grows, so about one random stream in seven shows
    its first text in the final chunk, which then carries all 20 tokens
    and leaves nothing to resume. The JAX server's request id is fixed and
    its seed derived from it by CRC-32 (the stream stays unseeded: the
    server resolves the seed and relays it), so the stream always arrives
    in chunks of 5, 8, 4 and 3 tokens."""
    monkeypatch.setattr(jax_api, "random_uuid",
                        lambda prefix="": prefix + "resume-3")
    monkeypatch.setattr(
        jax_runner, "resolved_seed_base",
        lambda rid, sp: (sp.seed if sp.seed is not None
                         else zlib.crc32(rid.encode()) & 0x7FFFFFFF)
        & 0xFFFFFFFF)
    async with _Servers() as s:
        resp = await s.jax.post("/v1/completions", json=_RESUME, headers=_HDR)
        evs, toks = _payloads(await resp.text())
        assert len(toks) == 20
        cut = next(i for i, e in enumerate(evs)
                   if e["pstpu"]["off"] + len(e["pstpu"]["toks"]) >= 2)
        delivered = [t for e in evs[:cut + 1] for t in e["pstpu"]["toks"]]
        assert 0 < len(delivered) < 20
        st, _, text = await _http(s.port, "POST", "/v1/completions", {
            **_RESUME, "resume_tokens": delivered,
            "resume_seed": evs[cut]["pstpu"]["seed"]}, _HDR)
        assert st == 200
        revs, _ = _events(text)
        rtoks = [t for e in revs for t in e["pstpu"]["toks"]]
        assert revs[0]["pstpu"]["off"] == len(delivered)
        assert delivered + rtoks == toks
        jtext = "".join(e["choices"][0]["text"] for e in evs)
        ptext = "".join(e["choices"][0]["text"] for e in evs[:cut + 1] + revs)
        assert ptext == jtext


async def test_port_to_port_resume_and_finished_stream_refused():
    """A port stream resumed on the port from token 5 (seed from the
    payload) continues it token for token; resuming a finished stream is
    a 400, and at the engine a ValueError."""
    eng = _port_engine()
    server = OpenAIServer(eng, port=0)
    await server.start()
    try:
        st, _, text = await _http(server.port, "POST", "/v1/completions",
                                  _RESUME, _HDR)
        evs, toks = _payloads(text)
        assert st == 200 and len(toks) == 20
        st, _, text = await _http(server.port, "POST", "/v1/completions", {
            **_RESUME, "resume_tokens": toks[:5],
            "resume_seed": evs[0]["pstpu"]["seed"]}, _HDR)
        rtoks = [t for e in _events(text)[0] for t in e["pstpu"]["toks"]]
        assert st == 200 and toks[:5] + rtoks == toks
        st, _, body = await _http(server.port, "POST", "/v1/completions", {
            **_RESUME, "resume_tokens": toks, "resume_seed": 1}, _HDR)
        assert st == 400 and "shorter than max_tokens" in body
        with pytest.raises(ValueError, match="shorter than max_tokens"):
            await _gen(eng, "x", SamplingParams(max_tokens=3),
                       resume_tokens=[1, 2, 3])
        assert eng.stats()["resume_restored_tokens_total"] >= 0
    finally:
        await server.stop()
        eng.shutdown()


# ------------------------------------------------------------ speculation
_SPEC_SERIES = ("pstpu:spec_enabled", "pstpu:spec_draft_tokens_total",
                "pstpu:spec_accepted_tokens_total",
                "pstpu:spec_acceptance_rate",
                "pstpu:spec_acceptance_rate_window", "pstpu:spec_draft_depth",
                "pstpu:spec_tree_nodes_total", "pstpu:spec_acceptance_ema",
                "pstpu:spec_gamma0_dispatches_total")


def _close(a, b, path="body"):
    """``a`` equals ``b``, floats within LP_TOL (speculation computes a
    token's logprobs from the verify forward's logits, spec-off from the
    step's: the same tokens, f32 values that differ in rounding); ids and
    timestamps aside."""
    if isinstance(a, dict):
        keys = set(a) - {"id", "created"}
        assert keys == set(b) - {"id", "created"}, path
        for k in keys:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float):
        assert a == pytest.approx(b, abs=LP_TOL), path
    else:
        assert a == b, path


def _merged(evs):
    """A completion stream's one choice as one body: its text, logprob
    lists and finish reason over all chunks."""
    text, lp, finish = "", {}, None
    for e in evs:
        c = e["choices"][0]
        text += c["text"]
        finish = c["finish_reason"] or finish
        for k, v in (c.get("logprobs") or {}).items():
            lp[k] = lp.get(k, []) + v
    return {"text": text, "logprobs": lp, "finish_reason": finish}


async def test_spec_server_serves_like_spec_off_and_exports_its_counters():
    """A speculative port server (self-draft, N = 3) against a spec-off one
    on the same weights: a streamed completion with logprobs, n = 2 over
    two prompts (seeded), a chat with a stop string taken from the middle
    of the spec-off text, and a stream resumed from its pstpu payload give
    the same bodies; its /metrics then carries the spec series at the
    engine's counters, non-zero."""
    servers = [OpenAIServer(_port_engine(), port=0),
               OpenAIServer(_port_engine(speculative_num_tokens=3,
                                         speculative_model=MODEL), port=0)]
    for s in servers:
        await s.start()
    off, on = (s.port for s in servers)
    try:
        plain = {"prompt": "a speculative stream", "max_tokens": 24,
                 "temperature": 0.0, "ignore_eos": True}
        st, _, text = await _http(off, "POST", "/v1/completions", plain)
        base = json.loads(text)["choices"][0]["text"]
        assert st == 200 and len(base) >= 4
        mid = len(base) // 2
        bodies = [
            ("/v1/completions", {**plain, "stream": True, "logprobs": 2}),
            ("/v1/completions", {"prompt": ["one two", "three four five"],
                                 "n": 2, "max_tokens": 6, "temperature": 0.7,
                                 "seed": 3, "ignore_eos": True}),
            ("/v1/completions", {**plain, "stop": [base[mid:mid + 2]]}),
            ("/v1/chat/completions", {**_CHAT, "max_tokens": 10,
                                      "temperature": 0.0, "ignore_eos": True,
                                      "logprobs": True, "top_logprobs": 2}),
        ]
        for path, body in bodies:
            (so, _, to), (sn, _, tn) = [await _http(p, "POST", path, body)
                                        for p in (off, on)]
            assert so == sn == 200, (path, body)
            if body.get("stream"):
                _close(_merged(_events(tn)[0]), _merged(_events(to)[0]))
            else:
                _close(json.loads(tn), json.loads(to))
            if "stop" in body:
                assert json.loads(tn)["choices"][0]["finish_reason"] == "stop"
        # Resume a spec-on stream from its payload on the spec-on server.
        st, _, text = await _http(on, "POST", "/v1/completions", _RESUME, _HDR)
        evs, toks = _payloads(text)
        st, _, text = await _http(on, "POST", "/v1/completions", {
            **_RESUME, "resume_tokens": toks[:5],
            "resume_seed": evs[0]["pstpu"]["seed"]}, _HDR)
        rtoks = [t for e in _events(text)[0] for t in e["pstpu"]["toks"]]
        assert st == 200 and toks[:5] + rtoks == toks
        st, _, metrics = await _http(on, "GET", "/metrics")
        stats = servers[1].engine.stats()
        got = {line.split("{")[0]: float(line.rsplit(" ", 1)[1])
               for line in metrics.splitlines()
               if line.split("{")[0] in _SPEC_SERIES}
        assert set(got) == set(_SPEC_SERIES)
        for name, value in got.items():
            assert value == pytest.approx(float(stats[name.split(":")[1]]))
        assert got["pstpu:spec_enabled"] == 1
        assert got["pstpu:spec_draft_tokens_total"] > 0
        assert 0 < got["pstpu:spec_accepted_tokens_total"] <= \
            got["pstpu:spec_draft_tokens_total"]
    finally:
        for s in servers:
            await s.stop()
            s.engine.shutdown()
