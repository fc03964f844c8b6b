"""The port's router (``production_stack_tpu_torch/router/``) held against
the JAX router piece by piece, on the same inputs: the parsed flags and
their refusals (the gated features' flags and the chart's rendered router
args too), every pick of the five routing logics over seeded traces,
the engine-stats parser on real expositions, breaker / backoff / SLO traces,
the SSE resume parser on randomly split bytes, the metric exposition, the
breaker gossip's temporary files, and the rule that nothing blocks the
event loop."""

import asyncio
import importlib
import os
import random
import threading
import types

import pytest

from production_stack_tpu.router import metrics as jax_metrics_mod
from production_stack_tpu.router import parser as jax_parser
from production_stack_tpu.router import resilience as jax_res
from production_stack_tpu.router import routing_logic as jax_rl
from production_stack_tpu.router import sse as jax_sse
from production_stack_tpu.router.service_discovery import EndpointInfo as JaxEP
from production_stack_tpu.router.stats import engine_stats as jax_es
from production_stack_tpu.router.stats import request_stats as jax_rs
from production_stack_tpu.utils import SingletonMeta as JaxSingletons
from production_stack_tpu_torch.router import metrics as port_metrics_mod
from production_stack_tpu_torch.router import parser as port_parser
from production_stack_tpu_torch.router import resilience as port_res
from production_stack_tpu_torch.router import routing_logic as port_rl
from production_stack_tpu_torch.router import sse as port_sse
from production_stack_tpu_torch.router.service_discovery import (
    EndpointInfo as PortEP,
)
from production_stack_tpu_torch.router.stats import engine_stats as port_es
from production_stack_tpu_torch.router.stats import request_stats as port_rs
from production_stack_tpu_torch.utils import SingletonMeta as PortSingletons

MODEL = "tiny-llama-128dh"


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    PortSingletons._instances.clear()
    yield
    PortSingletons._instances.clear()


# ------------------------------------------------------------------ parser
STATIC = ["--service-discovery", "static", "--static-backends",
          "http://127.0.0.1:9001,http://127.0.0.1:9002", "--static-models", "m"]

PARSED = [
    STATIC,
    STATIC + ["--routing-logic", "session", "--session-key", "x-user-id"],
    STATIC + ["--routing-logic", "cache_aware_load_balancing", "--session-key",
              "x-user-id", "--block-reuse-timeout", "12.5", "--ramp-in-seconds",
              "3"],
    STATIC + ["--routing-logic", "prefix-aware", "--prefix-tokenizer", MODEL,
              "--prefix-weight", "2", "--prefix-load-weight", "0.25",
              "--no-prefix-index-scrape"],
    STATIC + ["--static-backend-roles", "prefill,decode", "--port", "8123",
              "--host", "127.0.0.1", "--router-id", "r1", "--router-peer-dir",
              "/tmp/peers", "--prewarm-top-k", "4"],
    STATIC + ["--retry-max-attempts", "5", "--retry-backoff-base", "0.1",
              "--retry-backoff-cap", "2", "--breaker-window", "5",
              "--breaker-min-requests", "2", "--breaker-error-rate", "0.25",
              "--breaker-open-duration", "1", "--breaker-half-open-dwell", "0.5",
              "--max-midstream-resumes", "0", "--request-timeout", "30",
              "--ttft-deadline", "2"],
    STATIC + ["--engine-stats-interval", "1", "--request-stats-window", "5",
              "--log-stats", "--log-stats-interval", "2", "--dynamic-config-json",
              "/tmp/dyn.json", "--dynamic-config-watch-interval", "1",
              "--request-rewriter", "noop", "--callbacks", "a.b",
              "--feature-gates", "SemanticCache=false"],
]

REFUSED = [
    ["--service-discovery", "static"],
    ["--service-discovery", "static", "--static-backends", "http://a:1"],
    STATIC + ["--retry-max-attempts", "0"],
    STATIC + ["--ramp-in-seconds", "-1"],
    STATIC + ["--prewarm-top-k", "-2"],
    STATIC + ["--max-midstream-resumes", "-1"],
    STATIC + ["--breaker-error-rate", "0"],
    STATIC + ["--breaker-error-rate", "1.5"],
    STATIC + ["--routing-logic", "session"],
    STATIC + ["--routing-logic", "cache_aware_load_balancing"],
    STATIC + ["--routing-logic", "disagg"],
    STATIC + ["--routing-logic", "disagg", "--kv-offload-url", "kv://host:notaport"],
    STATIC + ["--routing-logic", "disagg", "--kv-offload-url", "kv://127.0.0.1:1"],
    STATIC + ["--routing-logic", "prefix-aware", "--kv-offload-url",
              "kv://127.0.0.1:1"],
    STATIC + ["--static-backend-roles", "prefill,oops"],
    STATIC + ["--static-backend-roles", "prefill"],
]


@pytest.mark.parametrize("argv", PARSED, ids=range(len(PARSED)))
def test_parsed_flags_equal_the_jax_parser(argv):
    assert vars(port_parser.parse_args(argv)) == vars(jax_parser.parse_args(argv))


def _refusal(parse, argv):
    try:
        parse(argv)
    except ValueError as e:
        return str(e).replace("production_stack_tpu_torch", "production_stack_tpu")
    except SystemExit as e:
        return f"exit {e.code}"
    return None


@pytest.mark.parametrize("argv", REFUSED, ids=range(len(REFUSED)))
def test_refusals_equal_the_jax_parser(argv):
    want = _refusal(jax_parser.parse_args, argv)
    assert want is not None
    assert _refusal(port_parser.parse_args, argv) == want


K8S = ["--service-discovery", "k8s"]
GATED = [
    K8S,
    STATIC + ["--k8s-namespace", "serving"],
    STATIC + ["--enable-batch-api"],
    STATIC + ["--file-storage-path", "/tmp/f"],
    STATIC + ["--feature-gates", "SemanticCache=true"],
    STATIC + ["--feature-gates", "PIIDetection=true"],
    STATIC + ["--pii-action", "redact"],
    STATIC + ["--semantic-cache-embedder", "sentence-transformers"],
    K8S + ["--k8s-namespace", "serving"],
    K8S + ["--k8s-port", "9000"],
    K8S + ["--k8s-label-selector", "environment=test,release=test"],
    K8S + ["--k8s-namespace", "prod", "--k8s-port", "8080", "--k8s-label-selector",
           "app=engine", "--routing-logic", "session", "--session-key", "x-user-id"],
    STATIC + ["--pii-analyzer", "presidio"],
    STATIC + ["--batch-processor", "local"],
    STATIC + ["--enable-batch-api", "--file-storage-class", "local_file",
              "--file-storage-path", "/tmp/f", "--batch-processor", "local"],
    STATIC + ["--feature-gates", "SemanticCache=true,PIIDetection=true",
              "--pii-action", "block", "--pii-analyzer", "regex",
              "--semantic-cache-embedder", "sentence-transformers:all-MiniLM-L6-v2"],
]
GATED_REFUSED = [
    STATIC + ["--batch-processor", "ray"],
    STATIC + ["--pii-action", "warn"],
    ["--service-discovery", "consul"],
    K8S + ["--k8s-port", "http"],
]


@pytest.mark.parametrize("argv", GATED, ids=lambda a: " ".join(a[-2:]))
def test_gated_feature_flags_equal_the_jax_parser(argv):
    """Kubernetes discovery, the files and batch APIs, the semantic cache
    and PII detection: the port's parser returns the JAX parser's
    Namespace for each of their flags."""
    assert vars(port_parser.parse_args(argv)) == vars(jax_parser.parse_args(argv))


@pytest.mark.parametrize("argv", GATED_REFUSED, ids=lambda a: " ".join(a[-2:]))
def test_gated_feature_refusals_equal_the_jax_parser(argv):
    want = _refusal(jax_parser.parse_args, argv)
    assert want is not None
    assert _refusal(port_parser.parse_args, argv) == want


def _chart_router_args():
    """Each example values file's rendered router container args (the JAX
    package's ``helm_lite``, here only)."""
    import glob

    from production_stack_tpu.helm_lite import render_chart

    chart = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "helm")
    out = []
    for values in sorted(glob.glob(os.path.join(chart, "examples", "values-*.yaml"))):
        for m in render_chart(chart, values_file=values, release_name="stack",
                              release_namespace="prod"):
            if m.get("kind") == "Deployment" and \
                    m["metadata"]["name"].endswith("deployment-router"):
                c = next(c for c in m["spec"]["template"]["spec"]["containers"]
                         if c["name"] == "router")
                out.append((os.path.basename(values), [str(a) for a in c["args"]]))
    return out


@pytest.mark.parametrize("values,args", _chart_router_args(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_chart_router_args_parse_as_the_jax_parser(values, args):
    """The chart's router args (``--service-discovery k8s`` with its
    namespace, label selector and port by default) parse with the port's
    parser to the JAX parser's Namespace."""
    want = vars(jax_parser.parse_args(args))
    assert vars(port_parser.parse_args(args)) == want
    assert want["service_discovery"] == "k8s" and want["k8s_namespace"] == "prod"


# ----------------------------------------------------------------- routing
class Clock:
    def __init__(self, t0=1_000_000.0):
        self.t = t0

    def time(self):
        return self.t

    def monotonic(self):
        return self.t


class Req:
    def __init__(self, headers, body, hop=None):
        self.headers = headers
        self.json_body = body
        self.disagg_hop = hop


class FakeTier:
    """A shared KV tier holding a set of keys (``index_query`` only)."""

    def __init__(self, keys):
        self.keys = set(keys)
        self._batched_ops_ok = True

    def index_query(self, keys):
        return [k in self.keys for k in keys]


def _prompt_pool(rng):
    """Prompts that share prefixes: a few heads, each grown by tails."""
    heads = [[rng.randrange(1, 250) for _ in range(rng.choice((40, 70, 100)))]
             for _ in range(4)]
    pool = []
    for h in heads:
        for _ in range(3):
            pool.append(h + [rng.randrange(1, 250)
                             for _ in range(rng.randrange(0, 40))])
    texts = ["shared system prompt " * rng.randrange(3, 8) + f"q{i}"
             for i in range(4)]
    return pool, texts


def _trace(logic, seed, steps=60):
    """A seeded trace: per step the live endpoints (with discovery times
    inside and outside the ramp-in window, and roles for disagg), the
    scraped engine stats, the router's request stats, the session header,
    the prompt, the prefix-index snapshots and the clock."""
    from production_stack_tpu_torch.engine.kv_cache import _block_hash

    rng = random.Random(seed)
    urls = [f"http://10.0.0.{i}:8000" for i in range(1, 6)]
    pool, texts = _prompt_pool(rng)
    born = {u: 1_000_000.0 - rng.choice((0.0, 2.0, 5.0, 100.0)) for u in urls}
    roles = {u: rng.choice(("prefill", "decode", "unified", None)) for u in urls}
    sessions = [f"user{i}" for i in range(6)]
    tier_keys = set()
    steps_out = []
    t = 1_000_000.0
    for step in range(steps):
        t += rng.choice((0.05, 0.5, 2.0, 30.0))
        live = sorted(rng.sample(urls, rng.randrange(1, len(urls) + 1)))
        if logic == "disagg" and step % 5 == 0:
            live = sorted(set(live) | {urls[0], urls[1]})
        engine = {}
        for u in live:
            if rng.random() < 0.8:
                engine[u] = dict(
                    num_running_requests=rng.randrange(0, 20),
                    num_queuing_requests=rng.randrange(0, 10),
                    gpu_cache_usage_perc=rng.choice((0.0, 0.3, 0.95)),
                    gpu_prefix_cache_hit_rate=rng.random(),
                    role=rng.choice(("", "prefill", "decode")))
        # Light load most of the time, so affinity and rebalancing both show.
        if rng.random() < 0.5:
            for v in engine.values():
                v["num_running_requests"] = v["num_queuing_requests"] = 0
        request = {u: dict(qps=rng.choice((0.0, 0.0, 1.0, 40.0)))
                   for u in live if rng.random() < 0.7}
        session = rng.choice(sessions + [None])
        kind = rng.random()
        if kind < 0.6:
            ids = rng.choice(pool)
            body = {"model": "m", "prompt": ids}
            if rng.random() < 0.15:
                body["resume_tokens"] = [rng.randrange(1, 250) for _ in range(20)]
        elif kind < 0.8:
            body = {"model": "m", "prompt": rng.choice(texts)}
        else:
            body = {"model": "m", "messages": [
                {"role": "user", "content": rng.choice(texts)}]}
        # Prefix-index snapshots: a backend holds a leading run of some
        # prompt's block hashes (truncated hex, as engines publish them).
        index = {}
        for u in live:
            if rng.random() < 0.6:
                ids = rng.choice(pool)
                bs = rng.choice((16, 16, 32))
                prev, hashes = b"", []
                for i in range((len(ids) - 1) // bs):
                    prev = _block_hash(prev, ids[i * bs:(i + 1) * bs])
                    hashes.append(prev.hex()[:16])
                keep = hashes[:rng.randrange(0, len(hashes) + 1)]
                index[u] = dict(block_size=bs, entries=frozenset(keep),
                                scraped_at=t - rng.choice((1.0, 5.0, 120.0)))
        if rng.random() < 0.3:
            ids = rng.choice(pool)
            prev = b""
            for i in range(min(3, (len(ids) - 1) // 16)):
                prev = _block_hash(prev, ids[i * 16:(i + 1) * 16])
                tier_keys.add(prev if rng.random() < 0.5 else b"q8|" + prev)
        hop = rng.choice(("prefill", "decode", None)) if logic == "disagg" else None
        steps_out.append(dict(t=t, live=live, engine=engine, request=request,
                              session=session, body=body, index=index, hop=hop,
                              tier=set(tier_keys)))
    return born, roles, steps_out


def _pkg(which):
    if which == "jax":
        return types.SimpleNamespace(
            rl=jax_rl, EP=JaxEP, ES=jax_es.EngineStats, RS=jax_rs.RequestStats,
            Snap=jax_es.PrefixIndexSnapshot, singletons=JaxSingletons)
    return types.SimpleNamespace(
        rl=port_rl, EP=PortEP, ES=port_es.EngineStats, RS=port_rs.RequestStats,
        Snap=port_es.PrefixIndexSnapshot, singletons=PortSingletons)


LOGICS = ["roundrobin", "session", "cache_aware_load_balancing",
          "prefix-aware", "disagg"]


def _picks(which, logic, seed, monkeypatch):
    pkg = _pkg(which)
    born, roles, steps = _trace(logic, seed)
    clock = Clock()
    monkeypatch.setattr(pkg.rl, "time", clock)
    state = {}
    kwargs = dict(session_key="x-user-id", block_reuse_timeout=40.0,
                  ramp_in_seconds=10.0)
    if logic == "prefix-aware":
        kwargs.update(prefix_tokenizer=MODEL, index_provider=lambda: state["index"],
                      kv_client=FakeTier(()), prefix_weight=1.0, load_weight=0.5)
    pkg.singletons._instances.clear()
    router = pkg.rl.initialize_routing_logic(logic, **kwargs)
    out = []
    for st in steps:
        clock.t = st["t"]
        eps = [pkg.EP(url=u, model_names=["m"], added_timestamp=born[u],
                      role=roles[u] if logic == "disagg" else None)
               for u in st["live"]]
        engine = {u: pkg.ES(**v) for u, v in st["engine"].items()}
        request = {u: pkg.RS(**v) for u, v in st["request"].items()}
        state["index"] = {u: pkg.Snap(**v) for u, v in st["index"].items()}
        if logic == "prefix-aware":
            router._kv_client.keys = st["tier"]
        headers = {"x-user-id": st["session"]} if st["session"] else {}
        req = Req(headers, st["body"], st["hop"])
        if logic == "disagg":
            pools = router.split_pools(eps, engine)
            pool = pools.get(st["hop"] or "unified") or eps
            out.append((router.route_request(pool, engine, request, req),
                        {k: [e.url for e in v] for k, v in pools.items()}))
        else:
            out.append(router.route_request(eps, engine, request, req))
    if logic == "prefix-aware":
        out.append((router.routed_by_index, router.routed_by_tier,
                    router.routed_by_fallback))
    pkg.singletons._instances.clear()
    return out


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("logic", LOGICS)
def test_every_pick_equals_the_jax_logic(logic, seed, monkeypatch):
    """The same seeded trace (60 decisions: endpoint churn, backends
    joining inside the ramp-in window, load from idle to saturated, session
    headers, token-id / text / chat prompts with resume tokens, prefix
    digests, a shared tier) gives the same pick at every step."""
    want = _picks("jax", logic, seed, monkeypatch)
    got = _picks("port", logic, seed, monkeypatch)
    assert got == want
    if logic == "prefix-aware":
        # The trace reaches every rung of the ladder.
        assert min(want[-1]) > 0, want[-1]


def test_cache_aware_rebalances_under_load_like_jax(monkeypatch):
    """A session pinned to a backend moves once that backend saturates
    and comes back when it drains, in both packages."""
    picks = []
    for pkg in (_pkg("jax"), _pkg("port")):
        clock = Clock()
        monkeypatch.setattr(pkg.rl, "time", clock)
        pkg.singletons._instances.clear()
        r = pkg.rl.initialize_routing_logic(
            "cache_aware_load_balancing", session_key="x-user-id")
        eps = [pkg.EP(url=u, model_names=["m"], added_timestamp=0.0)
               for u in ("http://a:1", "http://b:1")]
        seq = []
        for load in (0, 0, 16, 16, 0):
            clock.t += 1.0
            first = seq[0] if seq else "http://a:1"
            engine = {first: pkg.ES(num_running_requests=load,
                                    num_queuing_requests=load // 2,
                                    gpu_cache_usage_perc=0.95 if load else 0.1)}
            seq.append(r.route_request(eps, engine, {},
                                       Req({"x-user-id": "u"}, {})))
        picks.append(seq)
        pkg.singletons._instances.clear()
    assert picks[0] == picks[1]
    assert picks[0][1] == picks[0][0] and picks[0][2] != picks[0][0]


# ------------------------------------------------- stats and resilience
def _served_port_engine_texts():
    """The /metrics text of a port engine that served a request, from the
    port's renderer and from the JAX renderer on the same stats()."""
    import torch  # noqa: F401

    from production_stack_tpu.engine import metrics as jax_engine_metrics
    from production_stack_tpu.server.metrics import (
        render_engine_metrics as jax_render,
    )
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.engine.sampling import SamplingParams
    from production_stack_tpu_torch.server.metrics import render_engine_metrics

    eng = ServingEngine(EngineConfig(
        model=MODEL, device="cpu", dtype="float32", max_model_len=256,
        num_kv_blocks=64, attn_impl="window", num_decode_steps=4,
        max_num_batched_tokens=64, max_num_seqs=4))

    async def serve():
        await eng.start()
        try:
            for _ in range(2):
                async for _ in eng.generate(
                        prompt="scrape me " * 4, sampling=SamplingParams(
                            max_tokens=5, temperature=0.0, ignore_eos=True)):
                    pass
        finally:
            await eng.stop()

    asyncio.run(serve())
    shim = types.SimpleNamespace(
        stats=eng.stats,
        histograms=jax_engine_metrics.RequestLatencyHistograms(),
        lifecycle=jax_engine_metrics.LifecycleHistograms(),
        dispatch_hists=jax_engine_metrics.DispatchDurationHistograms())
    texts = [render_engine_metrics(eng, MODEL), jax_render(shim, MODEL)]
    eng.shutdown()
    return texts


def test_engine_stats_parse_equal_on_both_renderers():
    """The same exposition (the port engine's, and the JAX renderer's on
    the same stats) parses to equal EngineStats and counter baselines in
    both packages, first scrape and delta scrape alike; the role series of
    a role-split engine is read too."""
    texts = _served_port_engine_texts()
    texts.append(texts[0] + 'pstpu:disagg_role{role="decode"} 1\n')
    for text in texts:
        for prev in (None, (0.0, 1.0), (3.0, 2.0)):
            j, jc = jax_es.EngineStats.from_prometheus_text(text, prev)
            p, pc = port_es.EngineStats.from_prometheus_text(text, prev)
            assert vars(p) == vars(j) and pc == jc
    j, _ = jax_es.EngineStats.from_prometheus_text(texts[-1])
    assert j.role == "decode" and j.live_tok_per_s >= 0


def _resilience_trace(res, seed):
    """A scripted run of successes, failures and half-open probes against
    three backends under a fake clock: the breaker state after every event,
    the backoff delays, and the SLO attainment."""
    rng = random.Random(seed)
    clock = Clock(0.0)
    res.time = clock
    res.random = random.Random(seed + 1)
    cfg = res.ResilienceConfig(breaker_window=5.0, breaker_min_requests=3,
                               breaker_error_rate=0.5, breaker_open_duration=2.0,
                               breaker_half_open_dwell=rng.choice((0.0, 1.0)),
                               retry_backoff_base=0.05, retry_backoff_cap=0.4)
    mgr = res.ResilienceManager(cfg)
    slo = res.SLOTracker(window=10.0, max_classes=3)
    urls = ["http://a:1", "http://b:1", "http://c:1"]
    out = []
    for _ in range(300):
        clock.t += rng.choice((0.01, 0.1, 0.5, 1.5))
        u = rng.choice(urls)
        ev = rng.random()
        if ev < 0.35:
            ok = mgr.allow(u)
            if ok:
                mgr.on_dispatch(u)
            out.append(("allow", u, ok))
        elif ev < 0.55:
            mgr.record_success(u)
        elif ev < 0.85:
            mgr.record_failure(u)
        else:
            mgr.apply_peer_state("peer", {u: rng.choice((0.5, 3.0, -1.0))})
        headers = {"x-slo-class": rng.choice(("gold", "silver", "bronze", "x")),
                   "x-slo-ttft": rng.choice(("0.2", "1.0", "bad"))}
        slo.observe_from_headers(headers, cfg, rng.choice((None, 0.1, 0.5, 2.0)))
        out.append((mgr.snapshot(), mgr.peer_snapshot(), slo.snapshot(),
                    res.backoff_delay(rng.randrange(1, 6), cfg)))
        d = res.Deadline.from_request(
            {"x-request-timeout": rng.choice(("1", "0", "x", "500")),
             "x-ttft-deadline": rng.choice(("0.5", "-1"))},
            res.ResilienceConfig(default_timeout=rng.choice((0.0, 300.0)),
                                 default_ttft_deadline=rng.choice((0.0, 0.3))))
        out.append((d.total, d.ttft, d.binding_kind()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_breaker_backoff_and_slo_traces_equal_jax(seed, monkeypatch):
    for mod in (jax_res, port_res):
        monkeypatch.setattr(mod, "time", mod.time)
        monkeypatch.setattr(mod, "random", mod.random)
    want = _resilience_trace(jax_res, seed)
    got = _resilience_trace(port_res, seed)
    assert got == want
    assert any(s[0] and "open" in s[0].values() for s in want
               if isinstance(s, tuple) and isinstance(s[0], dict))


def _sse_stream(rng):
    """SSE bytes with pstpu payloads, comments, foreign events, CRLF
    framing, a finish chunk and [DONE]."""
    import json

    evs = [b": keepalive\n\n"]
    off = 0
    for i in range(rng.randrange(3, 12)):
        toks = [rng.randrange(0, 500) for _ in range(rng.randrange(0, 3))]
        obj = {"choices": [{"index": 0, "delta": {"content": "x" * len(toks)},
                            "finish_reason": None}],
               "pstpu": {"toks": toks, "off": off, "seed": 77}}
        off += len(toks)
        sep = b"\r\n\r\n" if rng.random() < 0.2 else b"\n\n"
        evs.append(b"data: " + json.dumps(obj).encode() + sep)
        if rng.random() < 0.1:
            evs.append(b"data: not json\n\n")
    evs.append(b'data: {"choices": [{"index": 0, "delta": {}, '
               b'"finish_reason": "length"}]}\n\n')
    evs.append(b"data: [DONE]\n\n")
    return b"".join(evs)


@pytest.mark.parametrize("seed", range(8))
def test_sse_resume_parser_equal_on_random_splits(seed):
    """The same bytes, split at random points, give the same forwarded
    events and resume state in both packages; a resumed stream with an
    overlap, a gap and a protocol break is judged alike."""
    rng = random.Random(seed)
    data = _sse_stream(rng)
    delivered = [rng.randrange(0, 500) for _ in range(rng.randrange(0, 4))]
    runs = []
    for mod in (jax_sse, port_sse):
        cuts = sorted(random.Random(seed + 99).sample(
            range(1, len(data)), min(12, len(data) - 1)))
        p = mod.SseResumeParser(delivered=delivered)
        if seed % 2:
            p.begin_strict()
        out = []
        for a, b in zip([0] + cuts, cuts + [len(data)]):
            out.append(p.feed(data[a:b]))
        runs.append((out, p.flush_residue(), p.delivered, p.seed, p.finished,
                     p.done, p.degraded, p.violation, p.events_relayed,
                     p.resumable))
    assert runs[0] == runs[1]


# ----------------------------------------------------------------- metrics
def _normalized_exposition(text):
    """Exposition lines of the router's own series (prometheus_client's
    process_* / python_* collectors and *_created samples dropped)."""
    keep = []
    for line in text.splitlines():
        name = line.split()[2] if line.startswith("#") else line.split("{")[0].split()[0]
        if name.startswith(("python_", "process_")) or name.endswith("_created"):
            continue
        keep.append(line)
    return keep


def _clear_jax_metrics():
    for obj in vars(jax_metrics_mod).values():
        if hasattr(obj, "_labelnames") and hasattr(obj, "clear"):
            if obj._labelnames:
                obj.clear()
            elif hasattr(obj, "_value"):
                obj._value.set(0)


def _metric_events(m):
    m.router_retries_total.labels(server="http://a:1").inc()
    m.router_failovers_total.labels(server="http://a:1").inc(2)
    m.router_deadline_exceeded_total.labels(server="http://b:1", kind="ttft").inc()
    m.router_midstream_resumes_total.labels(outcome="resumed").inc()
    m.router_truncations_total.inc()
    m.router_disagg_handoffs_total.inc(3)
    m.router_disagg_fallbacks_total.labels(reason="pool_empty").inc()
    m.router_trace_spans_dropped_total.inc()
    for v in (0.003, 0.2, 7.0, 50.0):
        m.router_ttft_seconds.labels(server="http://a:1").observe(v)
        m.router_e2e_latency_seconds.labels(server="http://a:1").observe(v * 3)
    for g in ("num_requests_running", "num_requests_waiting", "current_qps",
              "avg_decoding_length", "num_prefill_requests",
              "num_decoding_requests", "healthy_pods_total", "avg_latency",
              "avg_itl", "num_requests_swapped", "gpu_cache_usage_perc",
              "gpu_prefix_cache_hit_rate", "router_queueing_delay_seconds",
              "avg_prefill_length", "router_queue_depth", "router_kv_pressure",
              "router_backend_kv_hit_rate", "router_prefix_index_entries",
              "router_fleet_live_tok_per_s", "router_fleet_live_hbm_bw_pct",
              "router_fleet_live_effective_tokens_per_target_step",
              "router_fleet_breaker_open", "router_fleet_ramp_in_penalty"):
        getattr(m, g).labels(server="http://a:1").set(1234567.25)
    m.router_circuit_state.labels(server="http://a:1", router="r").set(1)
    m.router_pool_utilization.labels(role="decode").set(0.5)
    m.router_slo_attainment.labels(slo_class='gold "x"\\y').set(0.75)
    m.router_fleet_backends.set(2)
    m.router_queue_depth.labels(server="http://gone:1").set(1)
    m.router_queue_depth.remove("http://gone:1")


def test_metric_exposition_equals_prometheus_client_and_the_registry():
    """After the same events the two routers' expositions are equal line
    for line (families, types, help, label sets, values), once
    prometheus_client's *_created samples and process collectors are
    dropped; every family is registered on the router surface."""
    from prometheus_client import CollectorRegistry, generate_latest
    from prometheus_client.metrics import MetricWrapperBase

    from tools.pstpu_lint.metrics_registry import REGISTRY, ROUTER

    _clear_jax_metrics()
    port_metrics_mod.reset()
    _metric_events(jax_metrics_mod)
    _metric_events(port_metrics_mod)
    # The JAX router module's series alone: other modules a test process
    # imported (PII, the semantic cache) register theirs in the default
    # registry too.
    jax_router = CollectorRegistry()
    for obj in vars(jax_metrics_mod).values():
        if isinstance(obj, MetricWrapperBase):
            jax_router.register(obj)
    want = _normalized_exposition(generate_latest(jax_router).decode())
    # The port router module's series alone, likewise (the gated modules
    # register theirs on the same registry).
    got = port_metrics_mod.generate_latest(
        [obj for obj in vars(port_metrics_mod).values()
         if isinstance(obj, port_metrics_mod._Family)]).decode().splitlines()
    assert got == want
    families = {ln.split()[2] for ln in got if ln.startswith("# TYPE")}
    registered = {s.name for s in REGISTRY if ROUTER in s.surfaces}
    assert families <= registered, families - registered
    _clear_jax_metrics()
    port_metrics_mod.reset()


# ------------------------------------------------------------ gossip, loop
def test_gossip_writers_of_one_router_id_never_share_a_temporary_file(tmp_path):
    """Many watchers of one router id (more threads than cores, a short
    switch interval) publish at once: every write succeeds, the peer file
    is always whole JSON, and no temporary file is left behind."""
    import json
    import sys

    from production_stack_tpu_torch.router import dynamic_config as dc

    port_res.initialize_resilience(port_res.ResilienceConfig())
    watchers = []
    for _ in range(8):
        w = dc.DynamicConfigWatcher.__new__(dc.DynamicConfigWatcher)
        w.config_path, w.watch_interval = None, 10.0
        w.peer_dir, w.router_id = str(tmp_path), "same"
        watchers.append(w)
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def run(w):
            try:
                for _ in range(40):
                    w.sync_peer_state()
                    with open(tmp_path / "breakers-same.json") as f:
                        json.load(f)
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(repr(e))

        threads = [threading.Thread(target=run, args=(w,)) for w in watchers]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert sorted(os.listdir(tmp_path)) == ["breakers-same.json"]


def test_no_router_module_blocks_the_event_loop():
    """tools/pstpu_lint rule PL001 (sync I/O reachable in an async def),
    applied to the port's router: no finding; and the rule does flag a
    blocking call in a handler (the check is not vacuous)."""
    from tools.pstpu_lint import core, rules
    from tools.pstpu_lint.rules import blocked_event_loop

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    scope = ("production_stack_tpu_torch/router",)
    saved = rules.FILE_RULES
    try:
        rules.FILE_RULES = [(c, scope, f) for c, _, f in saved if c == "PL001"]
        found = core.run_lint([os.path.join(here, scope[0])],
                              project_root=here, project_rules=False)
    finally:
        rules.FILE_RULES = saved
    assert found == []
    import ast

    src = "import time\nasync def handler(request):\n    time.sleep(1)\n"
    bad = blocked_event_loop.check("production_stack_tpu_torch/router/x.py",
                                   ast.parse(src), src)
    assert [f.rule for f in bad] == ["PL001"]


def test_hash_ring_and_placement_equal_jax():
    from production_stack_tpu.router.ring import PlacementRing as JaxRing
    from production_stack_tpu_torch.router.ring import PlacementRing as PortRing

    rng = random.Random(3)
    a, b = JaxRing(), PortRing()
    for _ in range(50):
        nodes = rng.sample([f"http://n{i}:1" for i in range(8)], rng.randrange(1, 8))
        a.sync(nodes)
        b.sync(nodes)
        key = f"k{rng.randrange(1000)}"
        cands = rng.sample(nodes, rng.randrange(1, len(nodes) + 1))
        assert a.pick_session(key) == b.pick_session(key)
        assert a.pick_prefix(key, cands) == b.pick_prefix(key, cands)


def test_router_modules_mirror_the_jax_names():
    """Every module of the JAX router has its counterpart under the same
    name."""
    for name in ("app", "batch_service", "callbacks", "dynamic_config",
                 "feature_gates", "files_service", "log_stats", "metrics",
                 "parser", "pii", "request_service", "resilience", "rewriter",
                 "ring", "routing_logic", "semantic_cache", "service_discovery",
                 "sse", "stats.engine_stats", "stats.request_stats"):
        importlib.import_module(f"production_stack_tpu.router.{name}")
        importlib.import_module(f"production_stack_tpu_torch.router.{name}")


def test_the_router_process_loads_neither_torch_nor_numpy():
    """The router's modules, the launcher that starts it and the cache
    server's client (the disagg store probe, the prefix-aware tier rung)
    import on the standard library alone; prefix-aware hashing alone
    imports the engine's tokenizer and block hash, which load torch."""
    import subprocess
    import sys

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import production_stack_tpu_torch.router.app, "
            "production_stack_tpu_torch.launch, "
            "production_stack_tpu_torch.kv_offload.remote\n"
            "from production_stack_tpu_torch.router.parser import parse_args\n"
            "parse_args(['--service-discovery', 'static', '--static-backends', "
            "'http://127.0.0.1:1', '--static-models', 'm', '--routing-logic', "
            "'session', '--session-key', 'x'])\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'aiohttp', 'prometheus_client', 'requests')))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=here, capture_output=True,
                          text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=here))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
