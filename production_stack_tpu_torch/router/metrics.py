"""Router-exported Prometheus series, on a registry of this module's own.

Counterpart of ``production_stack_tpu/router/metrics.py``: every series of
that file, with the same names, types, help text and labels, on a small
registry (``Counter``, ``Gauge``, ``Histogram`` with labels) in place of
``prometheus_client``; ``router/pii.py`` and ``router/semantic_cache.py``
register their series here when they load. ``generate_latest()`` renders the Prometheus text
format as ``prometheus_client`` does (counters as ``<name>_total``, values
in Go's float notation, histogram buckets, ``_count`` and ``_sum``), but
writes no ``*_created`` samples and no ``process_*`` / ``python_*``
collector families (``ROADMAP.md`` Queue 3).
"""

import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

CONTENT_TYPE_LATEST = "text/plain; version=0.0.4; charset=utf-8"

_FAMILIES: List["_Family"] = []


def _float_str(d: float) -> str:
    """prometheus_client's ``floatToGoString``."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _labels(pairs: Sequence[Tuple[str, str]]) -> str:
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(pairs)) + "}"


class _Family:
    kind = ""

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = threading.Lock()
        if not self.labelnames:
            self._children[()] = self._new_child()
        _FAMILIES.append(self)

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kw):
        if kw:
            values = tuple(str(kw[n]) for n in self.labelnames)
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: wrong label values {values!r}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self._new_child()
            return child

    def remove(self, *values) -> None:
        with self._lock:
            del self._children[tuple(str(v) for v in values)]

    def clear(self) -> None:
        with self._lock:
            self._children.clear()
            if not self.labelnames:
                self._children[()] = self._new_child()

    def _only(self):
        return self._children[()]

    def render(self, out: List[str]) -> None:
        expo = self.name + "_total" if self.kind == "counter" else self.name
        doc = self.documentation.replace("\\", r"\\").replace("\n", r"\n")
        out.append(f"# HELP {expo} {doc}")
        out.append(f"# TYPE {expo} {self.kind}")
        with self._lock:
            children = list(self._children.items())
        for values, child in children:
            child.render(expo, list(zip(self.labelnames, values)), out)


class _Value:
    def __init__(self):
        self.value = 0.0
        self._lock = threading.Lock()

    def render(self, name, pairs, out) -> None:
        out.append(f"{name}{_labels(pairs)} {_float_str(self.value)}")


class _CounterChild(_Value):
    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only be incremented")
        with self._lock:
            self.value += amount


class _GaugeChild(_Value):
    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class Counter(_Family):
    kind = "counter"

    def __init__(self, name, documentation, labelnames=()):
        if name.endswith("_total"):
            name = name[:-len("_total")]
        super().__init__(name, documentation, labelnames)

    def _new_child(self):
        return _CounterChild()

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)


class Gauge(_Family):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild()

    def set(self, value: float) -> None:
        self._only().set(value)


class _HistogramChild:
    def __init__(self, bounds: Tuple[float, ...]):
        self.bounds = bounds
        self.counts = [0.0] * len(bounds)
        self.sum = 0.0
        self._lock = threading.Lock()

    def observe(self, amount: float) -> None:
        with self._lock:
            self.sum += amount
            for i, b in enumerate(self.bounds):
                if amount <= b:
                    self.counts[i] += 1
                    break

    def render(self, name, pairs, out) -> None:
        acc = 0.0
        for b, c in zip(self.bounds, self.counts):
            acc += c
            out.append(f"{name}_bucket{_labels(pairs + [('le', _float_str(b))])} "
                       f"{_float_str(acc)}")
        out.append(f"{name}_count{_labels(pairs)} {_float_str(acc)}")
        out.append(f"{name}_sum{_labels(pairs)} {_float_str(self.sum)}")


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, documentation, labelnames=(),
                 buckets: Sequence[float] = ()):
        bounds = [float(b) for b in buckets]
        if not bounds or bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.bounds = tuple(bounds)
        super().__init__(name, documentation, labelnames)

    def _new_child(self):
        return _HistogramChild(self.bounds)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)


def generate_latest(families: Optional[Sequence["_Family"]] = None) -> bytes:
    """The text exposition of ``families``, by default of every series
    registered in this process: this module's, then those of the gated
    modules imported since (PII detection, the semantic cache), as
    prometheus_client's default registry renders the JAX router's."""
    out: List[str] = []
    for fam in _FAMILIES if families is None else families:
        fam.render(out)
    return ("\n".join(out) + "\n").encode()


def reset() -> None:
    """Drop every label set and zero every unlabelled series (a test
    seam: one process may build many routers)."""
    for fam in _FAMILIES:
        fam.clear()


num_requests_running = Gauge(
    "vllm:num_requests_running",
    "Number of running requests per engine", ["server"],
)
num_requests_waiting = Gauge(
    "vllm:num_requests_waiting",
    "Number of waiting requests per engine", ["server"],
)
current_qps = Gauge(
    "vllm:current_qps", "Router-observed QPS per engine", ["server"],
)
avg_decoding_length = Gauge(
    "vllm:avg_decoding_length", "Average decoding length per engine", ["server"],
)
num_prefill_requests = Gauge(
    "vllm:num_prefill_requests", "In-prefill requests per engine", ["server"],
)
num_decoding_requests = Gauge(
    "vllm:num_decoding_requests", "In-decode requests per engine", ["server"],
)
healthy_pods_total = Gauge(
    "vllm:healthy_pods_total", "Healthy engine pods per server label", ["server"],
)
avg_latency = Gauge(
    "vllm:avg_latency", "Average end-to-end latency per engine", ["server"],
)
avg_itl = Gauge(
    "vllm:avg_itl", "Average inter-token latency per engine", ["server"],
)
num_requests_swapped = Gauge(
    "vllm:num_requests_swapped", "Swapped-out requests per engine", ["server"],
)
gpu_cache_usage_perc = Gauge(
    "vllm:gpu_cache_usage_perc",
    "KV-pool usage fraction per engine (TPU HBM)", ["server"],
)
gpu_prefix_cache_hit_rate = Gauge(
    "vllm:gpu_prefix_cache_hit_rate",
    "Per-interval prefix-cache hit rate per engine", ["server"],
)
router_queueing_delay_seconds = Gauge(
    "vllm:router_queueing_delay_seconds",
    "Router-side queueing delay (route decision to backend connect)", ["server"],
)
# Router-observed TTFT / end-to-end latency DISTRIBUTIONS (VERDICT r4 #5:
# the gauges above export window averages only; percentile panels need
# buckets). Engine pods additionally export the vLLM-named histograms
# (vllm:time_to_first_token_seconds / vllm:e2e_request_latency_seconds)
# that the reference dashboard's distribution panels query; these
# router-side series measure the same requests INCLUDING router overhead.
router_ttft_seconds = Histogram(
    "vllm:router_ttft_seconds",
    "Router-observed time to first streamed token", ["server"],
    buckets=(0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5, 5.0,
             7.5, 10.0, 20.0),
)
router_e2e_latency_seconds = Histogram(
    "vllm:router_e2e_latency_seconds",
    "Router-observed end-to-end request latency", ["server"],
    buckets=(0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0, 30.0, 60.0,
             120.0),
)
avg_prefill_length = Gauge(
    "vllm:avg_prefill_length", "Average prompt length per engine", ["server"],
)
# Data-plane resilience series (router/resilience.py). ``server`` is the
# backend the event was observed against.
router_retries_total = Counter(
    "router_retries",
    "Pre-stream backend failures that triggered a retry", ["server"],
)
router_failovers_total = Counter(
    "router_failovers",
    "Retries that moved the request away from this backend", ["server"],
)
router_circuit_state = Gauge(
    "router_circuit_state",
    "Circuit breaker state per backend (0=closed, 1=open, 2=half-open); "
    "router identifies the observing replica (docs/ROUTER_SCALE.md)",
    ["server", "router"],
)
router_deadline_exceeded_total = Counter(
    "router_deadline_exceeded",
    "Requests aborted on a deadline (kind: ttft or total)",
    ["server", "kind"],
)
# Mid-stream resume (docs/RESILIENCE.md): a backend died after bytes were
# on the wire and the router spliced a KV-backed continuation from another
# backend into the same client stream — or failed to and truncated.
router_midstream_resumes_total = Counter(
    "router_midstream_resumes",
    "Mid-stream backend failures the router tried to resume on another "
    "backend (outcome: resumed = continuation spliced, failed = no backend "
    "could attach, peer = client reconnected to this replica with "
    "x-pstpu-resume-* state after losing another router mid-stream)",
    ["outcome"],
)
router_truncations_total = Counter(
    "router_truncations",
    "Client streams that ended without data: [DONE] (mid-stream failure "
    "not resumed, resume budget exhausted, or mid-stream deadline)", [],
)
# Observability plane (docs/OBSERVABILITY.md): OTLP spans the router's
# exporter queue had to drop — tracing never blocks serving, but an
# undersized exporter must be visible. Bumped by the Tracer's on_drop hook
# (wired in app.build_app).
router_trace_spans_dropped_total = Counter(
    "router_trace_spans_dropped",
    "OTLP spans dropped because the exporter queue was full", [],
)
# Autoscaling signals (docs/SOAK.md): the first-class gauges an HPA /
# prometheus-adapter pipeline targets, so helm autoscaling wiring is a
# values-only change. Refreshed by the router's /metrics handler from the
# scrape + request stats planes (router_slo_attainment is pushed by the
# SLOTracker as outcomes arrive).
router_queue_depth = Gauge(
    "router_queue_depth",
    "Engine-reported running+waiting requests per backend "
    "(the queue-depth scale-up signal)", ["server"],
)
router_kv_pressure = Gauge(
    "router_kv_pressure",
    "KV-pool usage fraction per backend (HBM pressure; scale up before "
    "eviction/preemption sets in)", ["server"],
)
router_pool_utilization = Gauge(
    "router_pool_utilization",
    "Mean in-flight depth per engine in each disagg role pool "
    "(unified/prefill/decode) — sizes role pools independently", ["role"],
)
router_slo_attainment = Gauge(
    "router_slo_attainment",
    "Rolling-window fraction of x-slo-class requests meeting their soft "
    "TTFT target (sheds and failures count as misses)", ["slo_class"],
)
# KV economy (docs/KV_ECONOMY.md): the scraped per-backend prefix-cache
# hit rate made a first-class router series (the fork's engine_stats
# scraper already computes it per interval — this exports it), and the
# size of each backend's scraped prefix digest (how much of the fleet's
# device residency the prefix-aware router can actually see).
router_backend_kv_hit_rate = Gauge(
    "router_backend_kv_hit_rate",
    "Per-interval prefix-cache hit rate per backend, from the engine "
    "/metrics scrape plane", ["server"],
)
router_prefix_index_entries = Gauge(
    "router_prefix_index_entries",
    "Entries in the backend's last scraped /prefix_index digest "
    "(prefix-aware routing's view of device residency)", ["server"],
)
# Fleet performance pane (docs/OBSERVABILITY.md): the router's aggregate
# view of the engines' live roofline gauges plus the router-side per-backend
# state GET /fleet serves as JSON. Refreshed by the /metrics handler from
# the scrape plane; departed backends drop their label series (same GC as
# the autoscaler gauges).
router_fleet_backends = Gauge(
    "router_fleet_backends",
    "Backends in the router's current fleet view (healthy serving "
    "endpoints)", [],
)
router_fleet_live_tok_per_s = Gauge(
    "router_fleet_live_tok_per_s",
    "Engine-reported live generation throughput per backend", ["server"],
)
router_fleet_live_hbm_bw_pct = Gauge(
    "router_fleet_live_hbm_bw_pct",
    "Engine-reported live roofline position per backend (percent of the "
    "decode HBM ceiling)", ["server"],
)
router_fleet_live_effective_tokens_per_target_step = Gauge(
    "router_fleet_live_effective_tokens_per_target_step",
    "Engine-reported tokens emitted per target-model step per backend "
    "(speculation amortization)", ["server"],
)
router_fleet_breaker_open = Gauge(
    "router_fleet_breaker_open",
    "Circuit-breaker position per backend (0 closed / 1 open / 2 half-open) "
    "in the fleet view", ["server"],
)
router_fleet_ramp_in_penalty = Gauge(
    "router_fleet_ramp_in_penalty",
    "Remaining ramp-in load penalty per backend (1 just joined -> 0 fully "
    "ramped)", ["server"],
)
# Prefill/decode disaggregation (docs/DISAGG.md): two-hop flow outcomes.
router_disagg_handoffs_total = Counter(
    "router_disagg_handoffs",
    "Prefill->decode handoffs completed through the two-hop flow", [],
)
router_disagg_fallbacks_total = Counter(
    "router_disagg_fallbacks",
    "Disagg-routed requests degraded to unified serving",
    ["reason"],
)
