"""Router app: HTTP surface + singleton wiring + entry point.

The HTTP surface matches reference src/vllm_router/app.py +
routers/main_router.py:
  * POST /v1/chat/completions, /v1/completions, /v1/embeddings,
    /v1/rerank — proxied via routing logic (main_router.py:42-86)
  * GET /v1/models — union of backend models (main_router.py:95-124)
  * GET /health — aggregates discovery + scraper thread liveness and shows
    the live dynamic config (main_router.py:127-162)
  * GET /metrics — router-derived Prometheus series (metrics_router.py:38-78)
  * GET /fleet — the fleet-perf pane: per-backend live roofline gauges,
    breaker position, KV signals, ramp-in progress (docs/OBSERVABILITY.md)
  * /v1/files, /v1/batches — files/batch services (files_router.py,
    batches_router.py)

``initialize_all`` mirrors app.py:98-211's wiring order.

Counterpart of ``production_stack_tpu/router/app.py`` on the standard
library (``router/http.py`` in place of aiohttp): the same routes, the same
wiring order, the same ``/health``, ``/fleet`` and ``/metrics``, and the
same gated features: the files and batches APIs (``--enable-batch-api``),
PII detection before the semantic cache (``--feature-gates
PIIDetection=true,SemanticCache=true``) and Kubernetes discovery
(``--service-discovery k8s``).

  python -m production_stack_tpu_torch.router.app --service-discovery static \\
      --static-backends http://127.0.0.1:8100,http://127.0.0.1:8101 \\
      --static-models llama-3b --routing-logic session --session-key x-user-id
"""

import json
import time
import urllib.request

from production_stack_tpu_torch.protocols import ModelCard, ModelList
from production_stack_tpu_torch.router import http as web
from production_stack_tpu_torch.router import metrics
from production_stack_tpu_torch.router.callbacks import initialize_custom_callbacks
from production_stack_tpu_torch.router.dynamic_config import (
    get_dynamic_config_watcher,
    initialize_dynamic_config_watcher,
)
from production_stack_tpu_torch.router.batch_service import LocalBatchProcessor
from production_stack_tpu_torch.router.feature_gates import (
    PII_DETECTION,
    SEMANTIC_CACHE,
    initialize_feature_gates,
)
from production_stack_tpu_torch.router.files_service import initialize_storage
from production_stack_tpu_torch.router.request_service import (
    _error,
    resilient_json_request,
    route_disagg_request,
    route_general_request,
)
from production_stack_tpu_torch.router.resilience import (
    ResilienceConfig,
    get_resilience,
    get_slo_tracker,
    initialize_resilience,
    set_router_id,
)
from production_stack_tpu_torch.router.rewriter import get_request_rewriter
from production_stack_tpu_torch.router.routing_logic import (
    DisaggRouter,
    get_routing_logic,
    initialize_routing_logic,
    ramp_in_penalty,
)
from production_stack_tpu_torch.router.service_discovery import (
    get_service_discovery,
    initialize_service_discovery,
)
from production_stack_tpu_torch.router.stats import (
    get_engine_stats_scraper,
    get_request_stats_monitor,
    initialize_engine_stats_scraper,
    initialize_request_stats_monitor,
)
from production_stack_tpu_torch.utils import (
    init_logger,
    parse_static_model_names,
    parse_static_urls,
    set_ulimit,
)

logger = init_logger(__name__)


# --------------------------------------------------------------- API handlers
async def handle_chat_completions(request: web.Request) -> web.StreamResponse:
    # PII runs BEFORE the semantic cache so PII-bearing prompts are never
    # embedded/persisted by the cache; the cache then sees the redacted
    # body.
    pii = request.app.get("pii_checker")
    if pii is not None:
        blocked = await pii.check(request)
        if blocked is not None:
            return blocked
    cache = request.app.get("semantic_cache")
    if cache is not None:
        hit = await cache.check(request)
        if hit is not None:
            return hit
    if isinstance(get_routing_logic(), DisaggRouter):
        return await route_disagg_request(request, "/v1/chat/completions")
    return await route_general_request(request, "/v1/chat/completions")


async def handle_completions(request: web.Request) -> web.StreamResponse:
    pii = request.app.get("pii_checker")
    if pii is not None:
        blocked = await pii.check(request)
        if blocked is not None:
            return blocked
    if isinstance(get_routing_logic(), DisaggRouter):
        return await route_disagg_request(request, "/v1/completions")
    return await route_general_request(request, "/v1/completions")


async def handle_embeddings(request: web.Request) -> web.StreamResponse:
    return await route_general_request(request, "/v1/embeddings")


async def handle_rerank(request: web.Request) -> web.StreamResponse:
    return await route_general_request(request, "/v1/rerank")


async def handle_models(request: web.Request) -> web.Response:
    cards = {}
    for ep in get_service_discovery().get_endpoint_info():
        for name in ep.model_names:
            if name not in cards:
                cards[name] = ModelCard(id=name)
    return web.json_response(ModelList(data=list(cards.values())).to_dict())


async def handle_health(request: web.Request) -> web.Response:
    problems = []
    if not get_service_discovery().get_health():
        problems.append("service discovery is down")
    if not get_engine_stats_scraper().get_health():
        problems.append("engine stats scraper is down")
    if problems:
        return web.json_response({"status": "unhealthy",
                                  "problems": problems}, status=503,
                                 headers={"Retry-After": "1"})
    payload = {"status": "healthy"}
    resilience = get_resilience()
    if resilience is not None:
        payload["circuit_breakers"] = resilience.snapshot()
    watcher = get_dynamic_config_watcher()
    if watcher is not None:
        payload["dynamic_config"] = watcher.get_current_config()
    return web.json_response(payload)


# Autoscaler gauge label sets published on the last /metrics render, so
# departed backends/roles can be removed from the registry (a prometheus
# Gauge keeps serving a label set's last value until it is removed).
_autoscale_published: dict = {"server": set(), "role": set()}


def _fleet_view(ramp_in_seconds: float) -> dict:
    """One JSON-ready document aggregating the router's per-backend view:
    live roofline gauges from the engine scrape plane, breaker position,
    KV-tier signals, ramp-in progress, and disagg role — the fleet-perf
    pane (docs/OBSERVABILITY.md). Served by GET /fleet and mirrored into
    the router_fleet_* gauges on every /metrics render."""
    engine_stats = get_engine_stats_scraper().get_engine_stats()
    request_stats = get_request_stats_monitor().get_request_stats(time.time())
    resilience = get_resilience()
    tracker = get_slo_tracker()
    backends = []
    for ep in sorted(get_service_discovery().get_endpoint_info(),
                     key=lambda e: e.url):
        es = engine_stats.get(ep.url)
        rs = request_stats.get(ep.url)
        backends.append({
            "url": ep.url,
            "role": (getattr(ep, "role", "")
                     or (es.role if es is not None else "") or "unified"),
            "live_tok_per_s": es.live_tok_per_s if es is not None else 0.0,
            "live_hbm_bw_pct": (es.live_hbm_bw_pct
                                if es is not None else 0.0),
            "live_effective_tokens_per_target_step": (
                es.live_effective_tokens_per_target_step
                if es is not None else 0.0),
            "queue_depth": ((es.num_running_requests
                             + es.num_queuing_requests)
                            if es is not None else 0),
            "kv_usage": es.gpu_cache_usage_perc if es is not None else 0.0,
            "kv_hit_rate": (es.gpu_prefix_cache_hit_rate
                            if es is not None else 0.0),
            "breaker_state": (resilience.state(ep.url)
                              if resilience is not None else 0),
            "ramp_in_penalty": ramp_in_penalty(ep, ramp_in_seconds),
            "qps": rs.qps if rs is not None else 0.0,
            "scraped": es is not None,
        })
    return {
        "backends": backends,
        "backends_total": len(backends),
        "breakers": resilience.snapshot() if resilience is not None else {},
        "slo_attainment": tracker.snapshot() if tracker is not None else {},
    }


async def handle_fleet(request: web.Request) -> web.Response:
    return web.json_response(
        _fleet_view(request.app.get("ramp_in_seconds", 0.0))
    )


async def handle_metrics(request: web.Request) -> web.Response:
    # Refresh gauges from both stats planes (reference metrics_router.py:38-78).
    engine_stats = get_engine_stats_scraper().get_engine_stats()
    request_stats = get_request_stats_monitor().get_request_stats(time.time())
    for url, es in engine_stats.items():
        metrics.num_requests_running.labels(server=url).set(
            es.num_running_requests)
        metrics.num_requests_waiting.labels(server=url).set(
            es.num_queuing_requests)
        metrics.gpu_cache_usage_perc.labels(server=url).set(
            es.gpu_cache_usage_perc)
        metrics.gpu_prefix_cache_hit_rate.labels(server=url).set(
            es.gpu_prefix_cache_hit_rate)
    for url, rs in request_stats.items():
        metrics.current_qps.labels(server=url).set(rs.qps)
        metrics.avg_decoding_length.labels(server=url).set(
            rs.avg_decoding_length)
        metrics.num_prefill_requests.labels(server=url).set(
            rs.in_prefill_requests)
        metrics.num_decoding_requests.labels(server=url).set(
            rs.in_decoding_requests)
        metrics.avg_latency.labels(server=url).set(rs.avg_latency)
        metrics.avg_itl.labels(server=url).set(rs.avg_itl)
        metrics.num_requests_swapped.labels(server=url).set(
            rs.num_swapped_requests)
    endpoints = get_service_discovery().get_endpoint_info()
    metrics.healthy_pods_total.labels(server="router").set(len(endpoints))
    # Autoscaling signals (docs/SOAK.md): queue depth / KV pressure per
    # backend from the scrape plane, plus mean in-flight depth per disagg
    # role pool so prefill and decode pools can be sized independently.
    pool_depth: dict = {}
    pool_size: dict = {}
    prefix_index = get_engine_stats_scraper().get_prefix_index()
    for ep in endpoints:
        es = engine_stats.get(ep.url)
        rs = request_stats.get(ep.url)
        if es is not None:
            depth = es.num_running_requests + es.num_queuing_requests
        elif rs is not None:
            # Engine not scraped yet: the router's own in-flight view.
            depth = rs.in_prefill_requests + rs.in_decoding_requests
        else:
            depth = 0
        metrics.router_queue_depth.labels(server=ep.url).set(depth)
        metrics.router_kv_pressure.labels(server=ep.url).set(
            es.gpu_cache_usage_perc if es is not None else 0.0
        )
        # KV economy (docs/KV_ECONOMY.md): the scraped per-backend
        # prefix-cache hit rate as a first-class router series, and the
        # backend's prefix-digest size (0 unless prefix-aware routing has
        # the /prefix_index poll on).
        metrics.router_backend_kv_hit_rate.labels(server=ep.url).set(
            es.gpu_prefix_cache_hit_rate if es is not None else 0.0
        )
        snap = prefix_index.get(ep.url)
        metrics.router_prefix_index_entries.labels(server=ep.url).set(
            len(snap.entries) if snap is not None else 0
        )
        role = (getattr(ep, "role", "") or
                (es.role if es is not None else "") or "unified")
        pool_depth[role] = pool_depth.get(role, 0) + depth
        pool_size[role] = pool_size.get(role, 0) + 1
    for role, size in pool_size.items():
        metrics.router_pool_utilization.labels(role=role).set(
            pool_depth[role] / size
        )
    # Fleet-perf pane (docs/OBSERVABILITY.md): mirror the /fleet aggregate
    # into the router_fleet_* gauges so the Grafana fleet row charts the
    # same numbers the JSON endpoint serves.
    fleet = _fleet_view(request.app.get("ramp_in_seconds", 0.0))
    metrics.router_fleet_backends.set(fleet["backends_total"])
    for b in fleet["backends"]:
        metrics.router_fleet_live_tok_per_s.labels(server=b["url"]).set(
            b["live_tok_per_s"])
        metrics.router_fleet_live_hbm_bw_pct.labels(server=b["url"]).set(
            b["live_hbm_bw_pct"])
        metrics.router_fleet_live_effective_tokens_per_target_step.labels(
            server=b["url"]).set(b["live_effective_tokens_per_target_step"])
        metrics.router_fleet_breaker_open.labels(server=b["url"]).set(
            b["breaker_state"])
        metrics.router_fleet_ramp_in_penalty.labels(server=b["url"]).set(
            b["ramp_in_penalty"])
    # Departed backends/roles must DROP their autoscaler series, not
    # freeze at their last value: the HPA sums these (prom-adapter rule),
    # so a dead pod's stale depth would inflate the scale signal forever.
    live_servers = {ep.url for ep in endpoints}
    for gone in _autoscale_published["server"] - live_servers:
        for gauge in (metrics.router_queue_depth, metrics.router_kv_pressure,
                      metrics.router_backend_kv_hit_rate,
                      metrics.router_prefix_index_entries,
                      metrics.router_fleet_live_tok_per_s,
                      metrics.router_fleet_live_hbm_bw_pct,
                      metrics.router_fleet_live_effective_tokens_per_target_step,
                      metrics.router_fleet_breaker_open,
                      metrics.router_fleet_ramp_in_penalty):
            try:
                gauge.remove(gone)
            except KeyError:
                pass
    _autoscale_published["server"] = live_servers
    for gone in _autoscale_published["role"] - set(pool_size):
        try:
            metrics.router_pool_utilization.remove(gone)
        except KeyError:
            pass
    _autoscale_published["role"] = set(pool_size)
    tracker = get_slo_tracker()
    if tracker is not None:
        # Re-expire attainment windows so the gauge never freezes at the
        # last observed value after a class's traffic stops.
        tracker.publish()
    return web.Response(body=metrics.generate_latest(),
                        content_type=metrics.CONTENT_TYPE_LATEST.split(";")[0])


# ----------------------------------------------------------- files / batches
async def handle_file_upload(request: web.Request) -> web.Response:
    storage = request.app.get("storage")
    if storage is None:
        return _error(501, "Files API disabled (--enable-batch-api)")
    reader = await request.multipart()
    filename, content, purpose = "upload", b"", "batch"
    async for part in reader:
        if part.name == "file":
            filename = part.filename or filename
            content = await part.read()
        elif part.name == "purpose":
            purpose = (await part.read()).decode()
    info = await storage.save_file(filename, content, purpose=purpose)
    return web.json_response(info.to_dict())


async def handle_file_get(request: web.Request) -> web.Response:
    storage = request.app.get("storage")
    if storage is None:
        return _error(501, "Files API disabled (--enable-batch-api)")
    try:
        info = await storage.get_file(request.match_info["file_id"])
    except FileNotFoundError:
        return _error(404, "File not found")
    return web.json_response(info.to_dict())


async def handle_file_content(request: web.Request) -> web.Response:
    storage = request.app.get("storage")
    if storage is None:
        return _error(501, "Files API disabled (--enable-batch-api)")
    try:
        content = await storage.get_file_content(request.match_info["file_id"])
    except FileNotFoundError:
        return _error(404, "File not found")
    return web.Response(body=content,
                        content_type="application/octet-stream")


async def handle_batch_create(request: web.Request) -> web.Response:
    processor = request.app.get("batch_processor")
    if processor is None:
        return _error(501, "Batch API disabled (--enable-batch-api)")
    body = await request.json()
    if "input_file_id" not in body:
        return _error(400, "Missing 'input_file_id'")
    info = await processor.create_batch(
        input_file_id=body["input_file_id"],
        endpoint=body.get("endpoint", "/v1/chat/completions"),
        completion_window=body.get("completion_window", "24h"),
        metadata=body.get("metadata"),
    )
    return web.json_response(info.to_dict())


async def handle_batch_get(request: web.Request) -> web.Response:
    processor = request.app.get("batch_processor")
    if processor is None:
        return _error(501, "Batch API disabled (--enable-batch-api)")
    info = await processor.retrieve_batch(request.match_info["batch_id"])
    if info is None:
        return _error(404, "Batch not found")
    return web.json_response(info.to_dict())


async def handle_batch_list(request: web.Request) -> web.Response:
    processor = request.app.get("batch_processor")
    if processor is None:
        return _error(501, "Batch API disabled (--enable-batch-api)")
    batches = await processor.list_batches()
    return web.json_response(
        {"object": "list", "data": [b.to_dict() for b in batches]}
    )


async def handle_batch_cancel(request: web.Request) -> web.Response:
    processor = request.app.get("batch_processor")
    if processor is None:
        return _error(501, "Batch API disabled (--enable-batch-api)")
    info = await processor.cancel_batch(request.match_info["batch_id"])
    if info is None:
        return _error(404, "Batch not found")
    return web.json_response(info.to_dict())


# ------------------------------------------------------------------- wiring
def initialize_all(app: web.Application, args) -> None:
    """Wire all router singletons (reference app.py:98-211 order)."""
    if args.service_discovery == "static":
        urls = parse_static_urls(args.static_backends)
        models = [[m] for m in parse_static_model_names(args.static_models)]
        if len(models) == 1 and len(urls) > 1:
            models = models * len(urls)
        roles = None
        if getattr(args, "static_backend_roles", None):
            roles = [
                r.strip() for r in args.static_backend_roles.split(",")
            ]
        initialize_service_discovery(
            "static", urls=urls, models=models, roles=roles
        )
    else:
        initialize_service_discovery(
            "k8s", namespace=args.k8s_namespace, port=args.k8s_port,
            label_selector=args.k8s_label_selector,
        )
    # Prefix prewarm push (docs/ELASTIC.md): when a NEW backend appears
    # mid-run, POST /prewarm to it from the scraper thread so it pulls the
    # shared tier's hottest chains before ramp-in sends it real traffic.
    prewarm_top_k = getattr(args, "prewarm_top_k", 0)

    def _prewarm_new_backend(url: str) -> None:
        try:
            req = urllib.request.Request(
                f"{url}/prewarm",
                data=json.dumps({"top_k": prewarm_top_k}).encode(),
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=30) as resp:
                text = resp.read().decode("utf-8", "replace")
            logger.info("Prewarmed new backend %s: %s", url,
                        text.strip()[:200])
        except Exception as e:  # noqa: BLE001 — prewarm is best-effort
            logger.warning("Prewarm push to %s failed: %s", url, e)

    initialize_engine_stats_scraper(
        args.engine_stats_interval,
        # The per-backend /prefix_index poll only pays for itself when the
        # prefix-aware logic consumes it (docs/KV_ECONOMY.md) — and with a
        # shared KV tier configured, the ONE batched residency query per
        # routing decision supersedes it entirely: with N router replicas
        # the scrape would cost O(routers x engines) while the tier query
        # stays O(1) per decision (docs/ROUTER_SCALE.md). Opt out
        # explicitly with --no-prefix-index-scrape.
        scrape_prefix_index=(
            args.routing_logic == "prefix-aware"
            and not getattr(args, "no_prefix_index_scrape", False)
            and not getattr(args, "kv_offload_url", None)
        ),
        on_new_backend=(_prewarm_new_backend if prewarm_top_k > 0 else None),
    )
    initialize_request_stats_monitor(args.request_stats_window)
    routing_kwargs = {}
    if args.routing_logic == "prefix-aware":
        # Scoped to prefix-aware: load_weight would otherwise override the
        # cache-aware router's own tuned default.
        routing_kwargs = dict(
            kv_offload_url=getattr(args, "kv_offload_url", None),
            prefix_tokenizer=getattr(args, "prefix_tokenizer", None),
            prefix_weight=getattr(args, "prefix_weight", 1.0),
            load_weight=getattr(args, "prefix_load_weight", 0.5),
        )
    initialize_routing_logic(
        args.routing_logic, session_key=args.session_key,
        block_reuse_timeout=args.block_reuse_timeout,
        # Slow-start for joining backends (docs/ELASTIC.md); routers that
        # don't score load accept-and-ignore it.
        ramp_in_seconds=getattr(args, "ramp_in_seconds", 0.0),
        **routing_kwargs,
    )
    # The fleet pane (GET /fleet, router_fleet_ramp_in_penalty) reports
    # ramp-in progress against the same window the routing logic uses.
    app["ramp_in_seconds"] = getattr(args, "ramp_in_seconds", 0.0)
    # Replica identity BEFORE the breaker registry exists, so every
    # breaker's first publish already carries the router label.
    import socket as _socket

    set_router_id(
        getattr(args, "router_id", None)
        or f"{_socket.gethostname()}:{getattr(args, 'port', 0)}"
    )
    # getattr defaults keep pre-resilience arg namespaces (operator-rendered
    # configs, test fixtures) working.
    initialize_resilience(ResilienceConfig(
        retry_max_attempts=getattr(args, "retry_max_attempts", 3),
        retry_backoff_base=getattr(args, "retry_backoff_base", 0.05),
        retry_backoff_cap=getattr(args, "retry_backoff_cap", 1.0),
        breaker_window=getattr(args, "breaker_window", 30.0),
        breaker_min_requests=getattr(args, "breaker_min_requests", 5),
        breaker_error_rate=getattr(args, "breaker_error_rate", 0.5),
        breaker_open_duration=getattr(args, "breaker_open_duration", 10.0),
        breaker_half_open_dwell=getattr(args, "breaker_half_open_dwell", 0.0),
        max_midstream_resumes=getattr(args, "max_midstream_resumes", 1),
        default_timeout=getattr(args, "request_timeout", 300.0),
        default_ttft_deadline=getattr(args, "ttft_deadline", 0.0),
        slo_window=getattr(args, "request_stats_window", 60.0),
    ))
    gates = initialize_feature_gates(args.feature_gates)

    if gates.enabled(SEMANTIC_CACHE):
        from production_stack_tpu_torch.router.semantic_cache import (
            SemanticCache,
            create_embed_fn,
        )

        app["semantic_cache"] = SemanticCache(
            embed_fn=create_embed_fn(
                getattr(args, "semantic_cache_embedder", "hashed-ngram")
            ),
        )
    if gates.enabled(PII_DETECTION):
        from production_stack_tpu_torch.router.pii import (
            PIIAction,
            PIIChecker,
            create_analyzer,
        )

        app["pii_checker"] = PIIChecker(
            action=PIIAction(getattr(args, "pii_action", "block")),
            analyzer=create_analyzer(getattr(args, "pii_analyzer", "regex")),
        )

    if args.enable_batch_api:
        import os

        from production_stack_tpu_torch.router.files_service import (
            DEFAULT_STORAGE_PATH,
        )

        # argparse choices gate the CLI; this guards operator-rendered arg
        # namespaces (dynamic config, tests) that bypass parse_args.
        processor_kind = getattr(args, "batch_processor", "local")
        if processor_kind != "local":
            raise ValueError(
                f"Unknown --batch-processor {processor_kind!r}; only "
                f"'local' is implemented"
            )
        storage_path = args.file_storage_path or DEFAULT_STORAGE_PATH
        storage = initialize_storage(args.file_storage_class, storage_path)
        app["storage"] = storage

        async def send_fn(endpoint: str, body: dict) -> dict:
            return await _inprocess_request(app, endpoint, body)

        app["batch_processor"] = LocalBatchProcessor(
            storage, db_path=os.path.join(storage_path, "batch.db"),
            send_fn=send_fn,
        )

    app["rewriter"] = get_request_rewriter(args.request_rewriter)
    if args.callbacks:
        app["callbacks"] = initialize_custom_callbacks(args.callbacks)
    # Peer breaker gossip rides the same watcher thread, so the watcher
    # also starts when only --router-peer-dir is set (config_path None).
    if args.dynamic_config_json or getattr(args, "router_peer_dir", None):
        from production_stack_tpu_torch.router.resilience import get_router_id

        initialize_dynamic_config_watcher(
            args.dynamic_config_json,
            watch_interval=getattr(
                args, "dynamic_config_watch_interval", 10.0
            ),
            peer_dir=getattr(args, "router_peer_dir", None),
            router_id=get_router_id(),
        )


async def _inprocess_request(app: web.Application, endpoint: str,
                             body: dict) -> dict:
    """Run one request through routing + backend for the batch processor.

    Routed through the resilience wrapper so batch jobs survive a backend
    restart (retry + failover + circuit breaking) instead of failing the
    whole line on the first transport error.
    """
    return await resilient_json_request(app, endpoint, body)


def build_app(args) -> web.Application:
    app = web.Application(client_max_size=64 * 1024 * 1024)
    initialize_all(app, args)

    async def on_startup(app):
        # No total timeout, a 30 s connect timeout (the JAX router's
        # aiohttp.ClientTimeout(total=None, sock_connect=30)).
        app["client_session"] = web.ClientSession(connect_timeout=30.0)
        # Exporter hygiene (docs/OBSERVABILITY.md): queue-full span drops
        # feed router_trace_spans_dropped_total instead of vanishing.
        from production_stack_tpu_torch.tracing import get_tracer

        tracer = get_tracer("pstpu-router")
        if tracer is not None:
            tracer.on_drop = metrics.router_trace_spans_dropped_total.inc
        proc = app.get("batch_processor")
        if proc is not None:
            proc.start()

    async def on_cleanup(app):
        proc = app.get("batch_processor")
        if proc is not None:
            await proc.stop()
        await app["client_session"].close()
        get_engine_stats_scraper().close()
        get_service_discovery().close()
        watcher = get_dynamic_config_watcher()
        if watcher is not None:
            watcher.close()
        from production_stack_tpu_torch.tracing import reset_tracer

        reset_tracer()  # drains + posts any queued spans

    app.on_startup.append(on_startup)
    app.on_cleanup.append(on_cleanup)

    app.router.add_post("/v1/chat/completions", handle_chat_completions)
    app.router.add_post("/v1/completions", handle_completions)
    app.router.add_post("/v1/embeddings", handle_embeddings)
    app.router.add_post("/v1/rerank", handle_rerank)
    app.router.add_get("/v1/models", handle_models)
    app.router.add_get("/health", handle_health)
    app.router.add_get("/fleet", handle_fleet)
    app.router.add_get("/metrics", handle_metrics)
    app.router.add_post("/v1/files", handle_file_upload)
    app.router.add_get("/v1/files/{file_id}", handle_file_get)
    app.router.add_get("/v1/files/{file_id}/content", handle_file_content)
    app.router.add_post("/v1/batches", handle_batch_create)
    app.router.add_get("/v1/batches", handle_batch_list)
    app.router.add_get("/v1/batches/{batch_id}", handle_batch_get)
    app.router.add_post("/v1/batches/{batch_id}/cancel", handle_batch_cancel)
    return app


def main(argv=None) -> None:
    from production_stack_tpu_torch.router.parser import parse_args

    args = parse_args(argv)
    set_ulimit()
    app = build_app(args)

    if args.log_stats:
        from production_stack_tpu_torch.router.log_stats import start_log_stats

        start_log_stats(args.log_stats_interval)

    logger.info("Router listening on %s:%d", args.host, args.port)
    web.run_app(app, host=args.host, port=args.port)


if __name__ == "__main__":
    main()
