"""Router CLI flags + cross-field validation.

Counterpart of ``production_stack_tpu/router/parser.py``: every flag, with
the same defaults, meaning and ``validate_args`` refusals.
"""

import argparse


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="TPU production-stack router")
    p.add_argument("--host", default="0.0.0.0",
                   help="bind address for the router's HTTP surface")
    p.add_argument("--port", type=int, default=8000,
                   help="router listen port")

    p.add_argument("--service-discovery", choices=["static", "k8s"],
                   required=True,
                   help="how backends are found: fixed list or live "
                        "Kubernetes pod watch")
    p.add_argument("--static-backends", default=None,
                   help="comma-separated backend URLs (static discovery)")
    p.add_argument("--static-models", default=None,
                   help="comma-separated model names, one entry per backend")
    p.add_argument("--k8s-namespace", default="default",
                   help="namespace the pod watch scans")
    p.add_argument("--k8s-port", type=int, default=8000,
                   help="serving port assumed on each discovered pod")
    p.add_argument("--k8s-label-selector", default=None,
                   help="labelSelector limiting which pods are engines")

    p.add_argument("--routing-logic", default="roundrobin",
                   choices=["roundrobin", "session",
                            "cache_aware_load_balancing", "disagg",
                            "prefix-aware"],
                   help="backend selection policy (disagg enables the "
                        "two-hop prefill/decode flow, docs/DISAGG.md; "
                        "prefix-aware routes on measured global prefix "
                        "residency, docs/KV_ECONOMY.md)")
    p.add_argument("--session-key", default=None,
                   help="request header whose value pins a session to a "
                        "backend (session/cache-aware routing)")
    p.add_argument("--block-reuse-timeout", type=float, default=300.0,
                   help="cache-aware/disagg routers: seconds a session's KV "
                        "blocks are assumed to stay resident")
    p.add_argument("--static-backend-roles", default=None,
                   help="comma-separated disagg roles "
                        "(unified|prefill|decode), one per --static-backends "
                        "entry (docs/DISAGG.md)")
    p.add_argument("--kv-offload-url", default=None,
                   help="shared KV offload store URL (kv://host:port) the "
                        "disagg prefill->decode handoff rides; required and "
                        "probed for reachability with --routing-logic "
                        "disagg, optional (shared-tier restorability "
                        "fallback) with prefix-aware")
    p.add_argument("--prefix-tokenizer", default=None,
                   help="model name/path whose tokenizer the prefix-aware "
                        "router hashes prompts with (must match the "
                        "engines' tokenizer; without it only token-id "
                        "prompts are prefix-hashed, docs/KV_ECONOMY.md)")
    p.add_argument("--prefix-weight", type=float, default=1.0,
                   help="prefix-aware routing: weight of the matched "
                        "global-index prefix fraction in the backend score")
    p.add_argument("--prefix-load-weight", type=float, default=0.5,
                   help="prefix-aware routing: weight of the backend load "
                        "score subtracted from the prefix match")

    p.add_argument("--ramp-in-seconds", type=float, default=0.0,
                   help="slow-start window for newly discovered backends "
                        "(docs/ELASTIC.md): a joining engine's load score "
                        "carries a penalty decaying linearly from 1.0 to 0 "
                        "over this many seconds, so the "
                        "least-loaded/cache-aware/prefix-aware policies "
                        "ramp traffic onto it instead of an instant 1/N "
                        "avalanche onto a cold KV pool (0 disables)")
    p.add_argument("--prewarm-top-k", type=int, default=0,
                   help="on discovering a NEW backend, POST /prewarm to it "
                        "with this top-K so it pulls the shared tier's "
                        "hottest prefix chains before taking load "
                        "(docs/ELASTIC.md; 0 disables; engines without a "
                        "shared tier no-op the request)")
    p.add_argument("--router-id", default=None,
                   help="identity of this router replica in logs, the "
                        "router label on router_circuit_state, and peer "
                        "breaker-state files (docs/ROUTER_SCALE.md); "
                        "defaults to hostname:port. Helm wires the pod "
                        "name when routerSpec.replicas > 1")
    p.add_argument("--router-peer-dir", default=None,
                   help="shared directory where router replicas publish "
                        "and reconcile breaker state through the "
                        "dynamic-config watch plane (one JSON file per "
                        "replica; a peer's OPEN circuit is adopted within "
                        "one --dynamic-config-watch-interval). Unset "
                        "disables peer reconciliation")
    p.add_argument("--no-prefix-index-scrape", action="store_true",
                   help="skip the per-engine /prefix_index scrape pass "
                        "(prefix-aware routing then relies on the shared "
                        "KV tier's batched index query + session rungs); "
                        "implied when --kv-offload-url is set with "
                        "prefix-aware routing, where the shared-tier path "
                        "supersedes O(routers x engines) scrape traffic")
    p.add_argument("--engine-stats-interval", type=float, default=10.0,
                   help="seconds between engine /metrics scrape passes "
                        "(newly discovered backends are additionally "
                        "scraped immediately, docs/ELASTIC.md)")
    p.add_argument("--request-stats-window", type=float, default=60.0,
                   help="sliding window for router-side request stats, "
                        "seconds")
    p.add_argument("--log-stats", action="store_true",
                   help="periodically log a human-readable stats dump")
    p.add_argument("--log-stats-interval", type=float, default=10.0,
                   help="seconds between --log-stats dumps")

    p.add_argument("--dynamic-config-json", default=None,
                   help="path to a hot-reloaded dynamic config JSON file")
    p.add_argument("--dynamic-config-watch-interval", type=float,
                   default=10.0,
                   help="seconds between dynamic-config file polls (the "
                        "scale-out discovery latency with static "
                        "discovery behind a config file — the soak "
                        "harness's local HPA emulation runs this at 1s)")
    p.add_argument("--feature-gates", default="",
                   help="comma-separated Name=true|false gates")
    p.add_argument("--pii-action", choices=["block", "redact"],
                   default="block",
                   help="what to do on PII detection (PIIDetection gate)")
    p.add_argument("--pii-analyzer", default="regex",
                   help="'regex' (dependency-free) or 'presidio' (needs "
                        "presidio-analyzer + spacy model)")
    p.add_argument("--semantic-cache-embedder", default="hashed-ngram",
                   help="'hashed-ngram' (dependency-free) or "
                        "'sentence-transformers[:model-name]' "
                        "(SemanticCache gate)")

    p.add_argument("--enable-batch-api", action="store_true",
                   help="serve the OpenAI files + batches APIs")
    p.add_argument("--file-storage-class", default="local_file",
                   help="files-API storage backend ('local_file')")
    p.add_argument("--file-storage-path", default=None,
                   help="directory for files-API content and the batch DB")
    p.add_argument("--batch-processor", default="local",
                   choices=["local"],
                   help="batch execution backend ('local': in-process, "
                        "proxied through the routing logic)")

    p.add_argument("--request-rewriter", default="noop",
                   help="request rewriter implementation ('noop')")
    p.add_argument("--callbacks", default="",
                   help="dotted path to a callbacks instance")

    # Data-plane resilience knobs (docs/RESILIENCE.md has the full table).
    p.add_argument("--retry-max-attempts", type=int, default=3,
                   help="total backend attempts per request (1 = no retry)")
    p.add_argument("--retry-backoff-base", type=float, default=0.05,
                   help="first retry delay in seconds (doubles per retry, "
                        "full jitter)")
    p.add_argument("--retry-backoff-cap", type=float, default=1.0,
                   help="per-retry delay ceiling in seconds")
    p.add_argument("--breaker-window", type=float, default=30.0,
                   help="rolling outcome window for the circuit breaker")
    p.add_argument("--breaker-min-requests", type=int, default=5,
                   help="outcomes required in the window before tripping")
    p.add_argument("--breaker-error-rate", type=float, default=0.5,
                   help="windowed error rate that opens a backend's circuit")
    p.add_argument("--breaker-open-duration", type=float, default=10.0,
                   help="seconds an open circuit waits before the half-open "
                        "probe")
    p.add_argument("--breaker-half-open-dwell", type=float, default=0.0,
                   help="minimum seconds of successful half-open probing "
                        "before a breaker may close (hysteresis against "
                        "open/closed flap on slow stragglers; 0 closes on "
                        "the first probe success)")
    p.add_argument("--max-midstream-resumes", type=int, default=1,
                   help="times one client stream may be resumed on another "
                        "backend after a mid-stream backend failure: the "
                        "router re-issues the request with the delivered "
                        "token ids + sampler seed and splices the "
                        "KV-restored continuation into the same stream "
                        "(0 restores truncation-only semantics)")
    p.add_argument("--request-timeout", type=float, default=300.0,
                   help="default total per-request deadline in seconds "
                        "(0 disables; x-request-timeout header overrides)")
    p.add_argument("--ttft-deadline", type=float, default=0.0,
                   help="default deadline to the first backend byte in "
                        "seconds (0 disables; x-ttft-deadline header "
                        "overrides)")
    args = p.parse_args(argv)
    validate_args(args)
    return args


def validate_args(args: argparse.Namespace) -> None:
    if args.service_discovery == "static":
        if not args.static_backends:
            raise ValueError(
                "--static-backends required with --service-discovery static"
            )
        if not args.static_models:
            raise ValueError(
                "--static-models required with --service-discovery static"
            )
    if getattr(args, "retry_max_attempts", 1) < 1:
        raise ValueError("--retry-max-attempts must be >= 1")
    if getattr(args, "ramp_in_seconds", 0.0) < 0:
        raise ValueError("--ramp-in-seconds must be >= 0")
    if getattr(args, "prewarm_top_k", 0) < 0:
        raise ValueError("--prewarm-top-k must be >= 0")
    if getattr(args, "max_midstream_resumes", 0) < 0:
        raise ValueError("--max-midstream-resumes must be >= 0")
    if not 0 < getattr(args, "breaker_error_rate", 0.5) <= 1:
        raise ValueError("--breaker-error-rate must be in (0, 1]")
    if args.routing_logic in ("session", "cache_aware_load_balancing") \
            and not args.session_key:
        # cache_aware without a session key would silently degrade to pure
        # load scoring (its KV-affinity core disabled) — fail fast instead.
        raise ValueError(
            f"--session-key required with --routing-logic {args.routing_logic}"
        )
    if args.routing_logic == "disagg":
        # Disagg without a reachable offload store means EVERY request pays
        # a doomed prefill hop before degrading to unified — fail fast at
        # parse time instead (mirrors the session-key validation above).
        if not getattr(args, "kv_offload_url", None):
            raise ValueError(
                "--kv-offload-url required with --routing-logic disagg "
                "(the prefill->decode KV handoff rides the offload store)"
            )
        _probe_kv_offload_url(args.kv_offload_url)
    if args.routing_logic == "prefix-aware" and \
            getattr(args, "kv_offload_url", None):
        # Optional for prefix-aware (the index + affinity rungs work
        # without a shared tier), but if configured it must be reachable —
        # a typo'd URL silently disabling the restorability rung is the
        # failure mode this probe exists for.
        _probe_kv_offload_url(args.kv_offload_url)
    if getattr(args, "static_backend_roles", None):
        roles = [r.strip() for r in args.static_backend_roles.split(",")]
        bad = [r for r in roles if r not in ("unified", "prefill", "decode")]
        if bad:
            raise ValueError(
                f"--static-backend-roles entries must be unified|prefill|"
                f"decode (got {bad})"
            )
        if args.service_discovery == "static" and args.static_backends and \
                len(roles) != len(args.static_backends.split(",")):
            raise ValueError(
                "--static-backend-roles must list one role per "
                "--static-backends entry"
            )


def _probe_kv_offload_url(url: str, timeout: float = 3.0) -> None:
    """TCP-connect probe of the offload store. Uses RemoteKVClient's own
    URL parser so the probe always resolves exactly the endpoint the
    handoff plane will connect to. Unreachable -> error at parse time,
    before the router starts taking traffic."""
    import socket

    from production_stack_tpu_torch.kv_offload.remote import parse_kv_url

    try:
        host, port = parse_kv_url(url)
    except ValueError as e:  # e.g. kv://host:notaport
        raise ValueError(
            f"--kv-offload-url {url!r} is malformed: {e}"
        ) from e
    try:
        socket.create_connection((host, port), timeout=timeout).close()
    except OSError as e:
        raise ValueError(
            f"--kv-offload-url {url!r} is not reachable ({e}); start the "
            f"cache server (python -m production_stack_tpu_torch.kv_offload.server) "
            f"or fix the URL before enabling disagg routing"
        ) from e
