"""Tool calling, /v1/embeddings and /rerank on the port against the JAX
package.

Tool calling: ``server/tool_calling.py``'s functions on the JAX tests'
inputs (``tests/test_tool_calling.py``), and its HTTP cases (auto, forced,
streamed, a plain answer with tools attached, the validation 400s,
malformed history) through both servers with a canned engine stream: the
bodies are equal apart from ids and ``created``, and so are the prompts
the engines saw. Model compliance depends on real weights, so the canned
stream stands in for the model.

Embeddings and rerank: both servers on the same float32
``tiny-llama-128dh`` weights on the CPU: vectors and scores within 1e-5,
the same usage, order and 400s; more inputs than ``max_num_seqs``; tp = 2
over gloo against tp = 1.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from production_stack_tpu.engine.engine import RequestOutput as JaxOutput
from production_stack_tpu.models.config import resolve_model_config as jax_resolve
from production_stack_tpu.models.llama import init_params as jax_init
from production_stack_tpu.server import tool_calling as jtc
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.engine import RequestOutput, ServingEngine
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.weights import params_from_jax
from production_stack_tpu_torch.server import tool_calling as ptc
from tests.test_torch_surface import COMMON, _events, _Servers

EMBED_TOL = 1e-5

TOOLS = [{
    "type": "function",
    "function": {
        "name": "get_weather",
        "description": "Get the current weather in a given location",
        "parameters": {
            "type": "object",
            "properties": {
                "location": {"type": "string"},
                "unit": {"type": "string", "enum": ["celsius", "fahrenheit"]},
            },
            "required": ["location", "unit"],
        },
    },
}]
CALL_JSON = ('{"name": "get_weather", "parameters": '
             '{"location": "San Francisco, CA", "unit": "celsius"}}')
FORCED = {"type": "function", "function": {"name": "get_weather"}}


def _no_ids(obj):
    """``obj`` without generated ids and creation times (any depth)."""
    if isinstance(obj, dict):
        return {k: _no_ids(v) for k, v in obj.items()
                if k not in ("id", "created")}
    if isinstance(obj, (list, tuple)):
        return [_no_ids(v) for v in obj]
    return obj


# ---------------------------------------------------------------- units
@pytest.mark.parametrize("text,valid", [
    (CALL_JSON, None),
    ('Sure! {"name": "f", "arguments": {"x": 1}} done', None),
    ('[{"name": "a", "parameters": {}}, {"name": "b", "parameters": {}}]',
     None),
    ("plain text answer", None),
    ('{"not_a_call": 1}', None),
    ('{"name": "x", "parameters": 3}', None),
    ('{"name": "evil", "parameters": {}}', {"get_weather"}),
    ('{"name": "f", "parameters": {"code": "if x { y }"}}', None),
    ('{"name": "f", "parameters": {"s": "a \\" } b"}} tail', None),
    ('{"name": "f", "parameters": {"x": 1}', None),
])
def test_parse_tool_calls_matches_jax(text, valid):
    assert _no_ids(ptc.parse_tool_calls(text, valid)) == \
        _no_ids(jtc.parse_tool_calls(text, valid))


@pytest.mark.parametrize("body", [
    {"tools": TOOLS}, {"tools": TOOLS, "tool_choice": "auto"}, {"tools": []},
    {"tools": [{"type": "function"}]}, {"tool_choice": "auto"},
    {"tool_choice": "none"}, {"tools": TOOLS, "tool_choice": "banana"},
    {"tools": TOOLS, "tool_choice": {"type": "function",
                                     "function": {"name": "nope"}}},
    {"tools": TOOLS, "tool_choice": FORCED}, {"tools": TOOLS,
                                              "tool_choice": 3},
])
def test_validate_tools_matches_jax(body):
    assert ptc.validate_tools(body) == jtc.validate_tools(body)


HISTORY = [
    {"role": "system", "content": "Be helpful."},
    {"role": "user", "content": "weather?"},
    {"role": "assistant", "tool_calls": [{
        "id": "call-1", "type": "function",
        "function": {"name": "get_weather",
                     "arguments": '{"location": "SF"}'}}]},
    {"role": "tool", "tool_call_id": "call-1", "name": "get_weather",
     "content": "sunny"},
]


@pytest.mark.parametrize("body,messages", [
    ({"tools": TOOLS}, HISTORY),
    ({"tools": TOOLS, "tool_choice": FORCED},
     [{"role": "user", "content": "hi"}]),
    ({"tools": TOOLS, "tool_choice": "required"}, HISTORY[1:]),
])
def test_inject_tool_messages_matches_jax(body, messages):
    pctx, jctx = ptc.build_tool_context(body), jtc.build_tool_context(body)
    assert pctx.forced_prefix == jctx.forced_prefix
    assert ptc.inject_tool_messages(messages, pctx) == \
        jtc.inject_tool_messages(messages, jctx)


@pytest.mark.parametrize("chunks", [
    ["Hel", "lo"], [CALL_JSON[:10], CALL_JSON[10:40], CALL_JSON[40:]],
    ["{broken json"], ["  ", "[", '{"name": "get_weather", "parameters": {}}]'],
])
def test_streaming_buffer_matches_jax(chunks):
    bufs = (ptc.StreamingToolBuffer(ptc.ToolContext(tools=TOOLS)),
            jtc.StreamingToolBuffer(jtc.ToolContext(tools=TOOLS)))
    for c in chunks:
        assert bufs[0].feed(c) == bufs[1].feed(c)
    assert _no_ids(bufs[0].finish()) == _no_ids(bufs[1].finish())


# ------------------------------------------------- HTTP, canned engines
def _can(engine, cls, text, chunks):
    """Replace ``engine.generate`` by a stream of ``text`` in ``chunks``
    pieces; the prompts it is given land in ``engine.seen_prompts``."""
    engine.seen_prompts = []

    async def fake_generate(prompt=None, prompt_token_ids=None, sampling=None,
                            request_id=None, **kw):
        engine.seen_prompts.append(prompt)
        n = max(1, len(text) // chunks)
        pieces = [text[i:i + n] for i in range(0, len(text), n)] or [""]
        for i, piece in enumerate(pieces):
            last = i == len(pieces) - 1
            yield cls(request_id=request_id or "r", text_delta=piece,
                      token_ids=list(range(i + 1)), finished=last,
                      finish_reason="stop" if last else None,
                      num_prompt_tokens=7, num_output_tokens=i + 1)

    engine.generate = fake_generate


TOOL_CFG = dict(max_model_len=2048, num_kv_blocks=160)


async def _tools_both(text, body, chunks=3):
    """The same chat body to both servers over canned streams of ``text``:
    (JAX status, body or SSE events), (port ...), the prompts each saw."""
    async with _Servers(**TOOL_CFG) as s:
        _can(s.jax_engine, JaxOutput, text, chunks)
        _can(s.port_server.engine, RequestOutput, text, chunks)
        (js, jt), (ps, pt) = await s.raw("POST", "/v1/chat/completions",
                                          body)
        seen = (s.jax_engine.seen_prompts, s.port_server.engine.seen_prompts)
    parse = ((lambda t: _events(t)[0]) if body.get("stream")
             else json.loads)
    return (js, parse(jt) if js == 200 else jt), \
        (ps, parse(pt) if ps == 200 else pt), seen


_USER = [{"role": "user", "content": "What's the weather in San Francisco?"}]


@pytest.mark.parametrize("name,text,extra,chunks", [
    ("auto", CALL_JSON, {"tool_choice": "auto"}, 3),
    ("forced", '{"location": "Paris", "unit": "celsius"}}',
     {"tool_choice": FORCED}, 3),
    ("streamed", CALL_JSON, {"stream": True}, 5),
    ("forced streamed", '{"location": "Paris", "unit": "celsius"}}',
     {"tool_choice": FORCED, "stream": True}, 4),
    ("plain answer streamed", "The weather is sunny today.",
     {"stream": True}, 4),
    ("plain answer", "The weather is sunny today.", {}, 4),
    ("choice none", CALL_JSON, {"tool_choice": "none"}, 3),
    ("required", CALL_JSON, {"tool_choice": "required"}, 2),
])
async def test_tool_calls_match_jax(name, text, extra, chunks):
    """The JAX tool tests' round trips through both servers: equal bodies
    (streamed: equal chunks) apart from ids and ``created``, equal
    prompts; a call comes back as ``tool_calls`` with finish_reason
    "tool_calls" (streamed: one delta, no content), a plain answer as
    content (streamed: more than one content chunk)."""
    body = {"messages": _USER, "tools": TOOLS, "max_tokens": 32, **extra}
    (js, jb), (ps, pb), (jseen, pseen) = await _tools_both(text, body, chunks)
    assert js == ps == 200
    assert pseen == jseen and len(pseen) == 1
    assert _no_ids(pb) == _no_ids(jb)
    if body.get("stream"):
        deltas = [c["delta"] for e in pb for c in e["choices"]]
        finish = [c["finish_reason"] for e in pb for c in e["choices"]
                  if c["finish_reason"]]
        calls = [d for d in deltas if d.get("tool_calls")]
        if name.startswith("plain"):
            assert finish == ["stop"] and not calls
            assert sum(bool(d.get("content")) for d in deltas) > 1
        else:
            assert finish == ["tool_calls"] and len(calls) == 1
            assert not any(d.get("content") for d in deltas)
        return
    choice = pb["choices"][0]
    if name in ("plain answer", "choice none"):
        assert choice["finish_reason"] == "stop"
        assert choice["message"]["content"] == text
        return
    assert choice["finish_reason"] == "tool_calls"
    assert choice["message"]["tool_calls"][0]["function"]["name"] == \
        "get_weather"
    if name == "forced":
        assert pseen[0].endswith('{"name": "get_weather", "parameters": ')


@pytest.mark.parametrize("extra", [
    {"tools": []}, {"tools": [{"type": "banana"}]}, {"tool_choice": "auto"},
    {"tools": TOOLS, "tool_choice": "sometimes"},
    {"tools": TOOLS, "tool_choice": {"type": "function",
                                     "function": {"name": "missing"}}},
    {"tools": TOOLS, "messages": _USER + [
        {"role": "assistant", "tool_calls": [{}]}]},
    {"tools": TOOLS, "messages": _USER + [{"role": "assistant", "tool_calls": [
        {"function": {"name": "f", "arguments": "{not json"}}]}]},
    {"tools": TOOLS, "stream": True, "resume_tokens": [1, 2]},
])
async def test_tool_400s_match_jax(extra):
    """Malformed tools or tool_choice, untrusted tool history and a resume
    with tools are 400s on both servers, and nothing reaches the engine."""
    body = {"messages": _USER, "max_tokens": 4, **extra}
    (js, _), (ps, _), (jseen, pseen) = await _tools_both("x", body)
    assert js == ps == 400
    assert jseen == pseen == []


async def test_dict_arguments_history_is_served():
    """Tool history with unserialized (dict) arguments is served, and both
    engines see the same prompt."""
    body = {"tools": TOOLS, "max_tokens": 4, "messages": _USER + [
        {"role": "assistant", "tool_calls": [{
            "id": "c1", "type": "function",
            "function": {"name": "get_weather", "arguments": {"location": "SF"}}}]},
        {"role": "tool", "tool_call_id": "c1", "content": "sunny"}]}
    (js, jb), (ps, pb), (jseen, pseen) = await _tools_both("It is sunny.", body)
    assert js == ps == 200 and pseen == jseen
    assert _no_ids(pb) == _no_ids(jb)


async def test_tools_logprobs_ride_the_finishing_chunk():
    """With tools a streamed choice's logprob entries are deferred to the
    finishing chunk on both servers (the text may turn out to be a call):
    served by the real engines, the same chunks apart from ids."""
    body = {"messages": [{"role": "user", "content": "hi"}], "tools": TOOLS,
            "max_tokens": 6, "temperature": 0, "ignore_eos": True,
            "stream": True, "logprobs": True, "top_logprobs": 2}
    async with _Servers(**TOOL_CFG) as s:
        (js, jt), (ps, pt) = await s.raw("POST", "/v1/chat/completions", body)
    assert js == ps == 200
    jev, pev = _events(jt)[0], _events(pt)[0]
    with_lp = [i for i, e in enumerate(pev) if e["choices"]
               and e["choices"][0].get("logprobs")]
    assert with_lp == [len(pev) - 1]
    entries = [pev[-1]["choices"][0]["logprobs"]["content"],
               jev[-1]["choices"][0]["logprobs"]["content"]]
    assert [e["token"] for e in entries[0]] == [e["token"] for e in entries[1]]
    assert len(entries[0]) == 6


# ------------------------------------------------------------ embeddings
LONG = "the quick brown fox jumps over the lazy dog " * 3


@pytest.mark.parametrize("inputs", [
    "hello world", ["hello world"], ["a", LONG, "b c"],
    [f"input number {i}" * (i % 3 + 1) for i in range(11)],  # > max_num_seqs
    ["", "x"],
])
async def test_embeddings_match_jax(inputs):
    """/v1/embeddings on both servers: vectors within 1e-5, unit norm, the
    same usage and shapes; 11 inputs go in chunks of max_num_seqs (8)."""
    async with _Servers() as s:
        (js, jt), (ps, pt) = await s.raw("POST", "/v1/embeddings",
                                          {"input": inputs})
        calls = s.port_server.engine.stats()["embed_calls_total"]
    assert js == ps == 200 and calls == 1
    jb, pb = json.loads(jt), json.loads(pt)
    assert pb["usage"] == jb["usage"] and pb["model"] == jb["model"]
    assert [d["index"] for d in pb["data"]] == [d["index"] for d in jb["data"]]
    jv = np.array([d["embedding"] for d in jb["data"]])
    pv = np.array([d["embedding"] for d in pb["data"]])
    n = 1 if isinstance(inputs, str) else len(inputs)
    assert pv.shape == jv.shape == (n, resolve_model_config(COMMON["model"])
                                    .hidden_size)
    assert np.abs(pv - jv).max() <= EMBED_TOL
    assert np.abs(np.linalg.norm(pv, axis=1) - 1).max() <= 1e-5


@pytest.mark.parametrize("path", ["/v1/rerank", "/rerank"])
@pytest.mark.parametrize("top_n", [None, 2, 0])
async def test_rerank_matches_jax(path, top_n):
    """Rerank on both servers: the same order, scores within 1e-5, the
    documents echoed, ``top_n`` honoured, the same usage."""
    body = {"query": "quick fox", "documents": [
        "a slow turtle", LONG, "quick fox", "nothing at all here"]}
    if top_n is not None:
        body["top_n"] = top_n
    async with _Servers() as s:
        (js, jt), (ps, pt) = await s.raw("POST", path, body)
    assert js == ps == 200
    jb, pb = json.loads(jt), json.loads(pt)
    assert pb["usage"] == jb["usage"]
    assert [r["index"] for r in pb["results"]] == \
        [r["index"] for r in jb["results"]]
    assert len(pb["results"]) == (4 if top_n is None else top_n)
    for a, b in zip(pb["results"], jb["results"]):
        assert a["document"] == b["document"]
        assert abs(a["relevance_score"] - b["relevance_score"]) <= EMBED_TOL


@pytest.mark.parametrize("path,body,status", [
    ("/rerank", {"query": "q", "documents": []}, 200),
    ("/rerank", {"documents": ["a"]}, 400),
    ("/rerank", {"query": "q", "documents": "a"}, 400),
    ("/rerank", {"query": "q", "documents": ["a", 3]}, 400),
    ("/v1/rerank", {"query": "q", "documents": ["a"], "top_n": -1}, 400),
    ("/v1/rerank", {"query": "q", "documents": ["a"], "model": "other"}, 404),
    ("/v1/embeddings", {}, 400),
    ("/v1/embeddings", {"input": []}, 400),
    ("/v1/embeddings", {"input": ["a", 1]}, 400),
    ("/v1/embeddings", {"input": "a", "model": "other"}, 404),
])
async def test_embed_and_rerank_errors_match_jax(path, body, status):
    """An empty document list, and every refusal: the same status on both
    servers, and the same body apart from ids."""
    async with _Servers() as s:
        (js, jt), (ps, pt) = await s.raw("POST", path, body)
    assert js == ps == status
    if status == 200:
        assert _no_ids(json.loads(pt)) == _no_ids(json.loads(jt))
    else:
        assert json.loads(pt)["error"]["code"] == status


async def test_rerank_scores_are_embedding_dot_products():
    """A rerank score is the dot product of the query's and the
    document's /v1/embeddings vectors; an input embeds the same alone as
    in a batch of others (float32 on the CPU)."""
    docs = ["alpha beta", LONG, "gamma"]
    async with _Servers() as s:
        _, (_, pt) = await s.raw("POST", "/rerank", {"query": "beta",
                                                      "documents": docs})
        _, (_, et) = await s.raw("POST", "/v1/embeddings",
                                  {"input": ["beta"] + docs})
        _, (_, alone) = await s.raw("POST", "/v1/embeddings",
                                     {"input": [LONG]})
    vec = np.array([d["embedding"] for d in json.loads(et)["data"]])
    for r in json.loads(pt)["results"]:
        assert abs(r["relevance_score"] - vec[r["index"] + 1] @ vec[0]) <= 1e-5
    assert np.abs(np.array(json.loads(alone)["data"][0]["embedding"])
                  - vec[2]).max() <= EMBED_TOL


async def test_embed_tp2_matches_tp1():
    """The embedding forward at tp = 2 (a worker rank over gloo, an EMBED
    descriptor) equals tp = 1 within 1e-5, more inputs than max_num_seqs
    included; a dispatch afterwards still runs on both ranks."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    model = "tiny-llama-8kv"
    params = params_from_jax(jax.tree.map(np.asarray, jax_init(
        jax_resolve(model), jax.random.PRNGKey(0), jnp.float32)),
        resolve_model_config(model), torch.float32)
    cfg = dict(model=model, device="cpu", dtype="float32", max_model_len=256,
               num_kv_blocks=64, max_num_seqs=4, tp_timeout_s=120)
    texts = [f"embed me {i} " * (i + 1) for i in range(6)]
    out = {}
    try:
        for tp in (1, 2):
            eng = ServingEngine(EngineConfig(**cfg, tensor_parallel_size=tp),
                                params=params)
            try:
                await eng.start()
                out[tp] = await eng.embed(texts)
                async for o in eng.generate(prompt="after", sampling=(
                        SamplingParams(max_tokens=3, temperature=0.0,
                                       ignore_eos=True))):
                    final = o
                out[f"tok{tp}"] = final.token_ids
                await eng.stop()
            finally:
                eng.shutdown()
    finally:
        torch.set_num_threads(n)
    assert out[1][1] == out[2][1]
    assert np.abs(out[1][0] - out[2][0]).max() <= EMBED_TOL
    assert out["tok1"] == out["tok2"] and len(out["tok2"]) == 3
