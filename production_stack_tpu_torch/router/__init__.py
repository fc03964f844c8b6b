"""OpenAI-compatible L7 request router, the port of
``production_stack_tpu/router/`` (same module names) on the standard
library (numpy too, for the semantic cache when its gate is on): static
and Kubernetes service discovery, the five routing logics, engine and
request stats, the resilient streaming proxy with mid-stream resume, the
disagg two-hop flow, dynamic config and breaker gossip, feature gates (PII
detection, the semantic cache), the files and batch APIs, and the
Prometheus series. ``router/http.py`` stands in for aiohttp and
``router/metrics.py`` for prometheus_client; nothing here imports jax, the
JAX package, aiohttp, prometheus_client or requests, and the router process
never initialises CUDA.

Run: ``python -m production_stack_tpu_torch.router.app --service-discovery
static --static-backends URL[,URL...] --static-models MODEL`` (the JAX
router's flags, ``router/parser.py``).
"""
