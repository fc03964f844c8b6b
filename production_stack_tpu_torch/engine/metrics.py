"""Engine metrics: the latency histograms the engine keeps, and the series
of its ``/metrics`` exposition.

Counterpart of ``production_stack_tpu/engine/metrics.py``, on the standard
library. ``engine_families`` lists every series the JAX package's engine
renders, under the same names and label sets (``vllm:*`` for the router's
``EngineStatsScraper`` and the reference dashboard, ``pstpu:*`` for this
stack), read from ``engine.stats()``: the offload, restore, shared-tier,
chain-eviction and handoff series read the KV tier's counters, the
``pstpu:spec_*`` series the speculative runner's,
``pstpu:trace_spans_dropped_total`` the tracer's queue-full drops
(``tracing.py``; 0 with tracing off). A series whose key ``stats()`` lacks
renders at 0, as the reference renders it for an engine without the
feature. Two renderers read that one list: the text renderer the server
serves (``server/metrics.py``) and ``EngineMetricsCollector`` for a
``prometheus_client`` registry, which imports ``prometheus_client`` only
when it collects (the port does not need the package).

``pstpu:hbm_kv_bytes`` has one series per tp rank, keyed
``rank<r>:<device>`` (ranks may share one card, so the device alone does
not name a rank).
"""

import bisect
from typing import Dict, Iterable, List, Tuple

import torch  # noqa: F401 — every module of the port is a torch module

# vLLM's bucket bounds for the two request-latency histograms the
# reference dashboard charts.
TTFT_BUCKETS = (
    0.001, 0.005, 0.01, 0.02, 0.04, 0.06, 0.08, 0.1, 0.25, 0.5, 0.75,
    1.0, 2.5, 5.0, 7.5, 10.0,
)
E2E_BUCKETS = (
    0.3, 0.5, 0.8, 1.0, 1.5, 2.0, 2.5, 5.0, 10.0, 15.0, 20.0, 30.0,
    40.0, 50.0, 60.0,
)
# Sub-second buckets for per-dispatch phases.
PHASE_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """A cumulative Prometheus histogram of one label set: an observe is a
    bisect and three adds."""

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        i = bisect.bisect_left(self.buckets, value)
        if i < len(self.counts):
            self.counts[i] += 1
        self.sum += value
        self.count += 1

    def cumulative(self) -> List[Tuple[str, int]]:
        """(upper bound, cumulative count) pairs, ending in +Inf."""
        out, cum = [], 0
        for bound, c in zip(self.buckets, self.counts):
            cum += c
            out.append((str(bound), cum))
        out.append(("+Inf", self.count))
        return out


class RequestLatencyHistograms:
    """TTFT and end-to-end request latency."""

    def __init__(self):
        self.ttft = Histogram(TTFT_BUCKETS)
        self.e2e = Histogram(E2E_BUCKETS)

    def families(self):
        return [("vllm:time_to_first_token_seconds",
                 "Time to first generated token", self.ttft),
                ("vllm:e2e_request_latency_seconds",
                 "End-to-end request latency", self.e2e)]


class DispatchDurationHistograms:
    """Issue-to-fetch duration of every dispatch by train kind: prefill
    chunk, plain fused decode, speculative decode (``decode_spec``; as in
    the reference, it also counts an adaptive engine's all-gamma-0
    dispatches)."""

    TRAINS = ("prefill", "decode", "decode_spec")

    def __init__(self):
        self.hists = {t: Histogram(PHASE_BUCKETS) for t in self.TRAINS}

    def observe(self, train: str, value: float) -> None:
        h = self.hists.get(train)
        if h is not None:
            h.observe(value)


class LifecycleHistograms:
    """Per-phase request latency: queue wait (arrival to first issue),
    prefill (first issue to the final chunk's fetch), each fused decode
    dispatch (issue to fetch), and the offload tier's restores at admission
    (the host and remote round trips with the scatter)."""

    def __init__(self):
        self.queue_wait = Histogram(TTFT_BUCKETS)
        self.prefill = Histogram(TTFT_BUCKETS)
        self.decode_train = Histogram(PHASE_BUCKETS)
        self.restore_round_trip = Histogram(PHASE_BUCKETS)

    def families(self):
        return [
            ("pstpu:queue_wait_seconds",
             "Arrival to first dispatch issue per request", self.queue_wait),
            ("pstpu:prefill_seconds",
             "First prefill issue to final prefill chunk fetch per request",
             self.prefill),
            ("pstpu:decode_train_seconds",
             "Issue-to-fetch duration of each fused decode dispatch (train)",
             self.decode_train),
            ("pstpu:restore_round_trip_seconds",
             "Duration of each shared-tier I/M restore round trip that "
             "restored KV blocks", self.restore_round_trip),
        ]


# Scalar series labelled by model_name only: (name, type, help, stats key),
# in the reference renderer's order. Keys absent from stats() read 0.
_G, _C = "gauge", "counter"
_HEAD = (
    ("vllm:num_requests_running", _G, "Running requests",
     "num_requests_running"),
    ("vllm:num_requests_waiting", _G, "Waiting requests",
     "num_requests_waiting"),
    ("pstpu:queue_depth", _G, "Engine backlog (running + waiting requests)",
     "queue_depth"),
    ("vllm:gpu_cache_usage_perc", _G, "KV-pool usage (device memory)",
     "kv_cache_usage"),
    ("vllm:gpu_prefix_cache_hits_total", _C, "Prefix cache hit tokens",
     "prefix_cache_hits"),
    ("vllm:gpu_prefix_cache_queries_total", _C, "Prefix cache query tokens",
     "prefix_cache_queries"),
    ("vllm:num_preemptions_total", _C, "Preempted sequences",
     "num_preemptions"),
    ("vllm:prompt_tokens_total", _C, "Prefilled tokens",
     "prompt_tokens_total"),
    ("vllm:generation_tokens_total", _C, "Generated tokens",
     "generation_tokens_total"),
    ("pstpu:engine_uptime_seconds", _G, "Engine uptime",
     "engine_uptime_seconds"),
    ("pstpu:kv_offload_blocks", _G,
     "KV blocks resident in the host offload pool", "kv_offload_blocks"),
    ("pstpu:prefix_index_size", _G,
     "Content-addressed blocks resident in the device prefix cache",
     "prefix_index_size"),
    ("pstpu:kv_restore_saved_tokens_total", _C,
     "Prompt tokens restored from the shared KV tier instead of recomputed",
     "kv_restore_saved_tokens_total"),
    ("pstpu:kv_shared_tier_hits_total", _C,
     "KV blocks served by the shared host/remote tiers during prefill "
     "restores", "kv_shared_tier_hits_total"),
    ("pstpu:kv_shared_tier_misses_total", _C,
     "Restore-candidate KV blocks the shared tiers did not hold",
     "kv_shared_tier_misses_total"),
    ("pstpu:kv_chain_evictions_total", _C,
     "Leaf-first chain evictions in the local host KV tier",
     "kv_chain_evictions_total"),
    ("pstpu:resume_restored_tokens_total", _C,
     "Prompt+resume tokens served from the prefix cache on mid-stream "
     "resume requests instead of recomputed",
     "resume_restored_tokens_total"),
    ("pstpu:spec_enabled", _G, "Speculative decoding active",
     "spec_enabled"),
    ("pstpu:spec_draft_tokens_total", _C,
     "Draft-model token proposals made inside fused decode dispatches",
     "spec_draft_tokens_total"),
    ("pstpu:spec_accepted_tokens_total", _C,
     "Draft proposals that survived target verification",
     "spec_accepted_tokens_total"),
    ("pstpu:spec_acceptance_rate_window", _G,
     "Draft acceptance over the last <=64 dispatch fetches",
     "spec_acceptance_rate_window"),
    ("pstpu:spec_draft_depth", _G,
     "Mean served draft depth per live verify cycle", "spec_draft_depth"),
    ("pstpu:spec_tree_nodes_total", _C,
     "Token-tree nodes verified (tree speculation)", "spec_tree_nodes_total"),
    ("pstpu:spec_acceptance_ema", _G,
     "Mean per-sequence acceptance EMA over live sequences",
     "spec_acceptance_ema"),
    ("pstpu:spec_gamma0_dispatches_total", _C,
     "Decode dispatches degraded to the plain (non-speculative) scan",
     "spec_gamma0_dispatches_total"),
    ("pstpu:spec_acceptance_rate", _G,
     "Lifetime fraction of draft proposals accepted by the target",
     "spec_acceptance_rate"),
    ("pstpu:startup_weight_load_seconds", _G,
     "Seconds loading model weights at startup",
     "startup_weight_load_seconds"),
    ("pstpu:startup_compile_seconds", _G,
     "Seconds in an ahead-of-time compile prepass",
     "startup_compile_seconds"),
    ("pstpu:startup_warmup_seconds", _G,
     "Seconds warming up (capturing decode graphs) before serving",
     "startup_warmup_seconds"),
    ("pstpu:startup_prewarm_seconds", _G,
     "Seconds serving POST /prewarm hot-chain pulls",
     "startup_prewarm_seconds"),
    ("pstpu:startup_total_seconds", _G,
     "Engine construction to ready-to-serve, seconds",
     "startup_total_seconds"),
    ("pstpu:startup_cache_hit_families", _G,
     "Warmup variants loaded from a persistent compile cache",
     "startup_cache_hit_families"),
    ("pstpu:startup_cache_miss_families", _G,
     "Warmup variants built from scratch", "startup_cache_miss_families"),
    ("pstpu:decode_dispatches_total", _C, "Fused decode dispatches issued",
     "decode_dispatches_total"),
    ("pstpu:prefill_dispatches_total", _C, "Prefill chunk dispatches issued",
     "prefill_dispatches_total"),
    ("pstpu:dispatch_overlap_ratio", _G,
     "Fraction of dispatch fetches with another dispatch still outstanding",
     "dispatch_overlap_ratio"),
    ("pstpu:dispatch_gap_seconds_total", _C,
     "Host-observed seconds with no dispatch outstanding between "
     "dispatches", "dispatch_gap_seconds_total"),
    ("pstpu:live_tok_per_s", _G,
     "Generation throughput over the rolling dispatch window",
     "live_tok_per_s"),
    ("pstpu:live_hbm_bw_pct", _G,
     "Achieved fraction (percent) of the decode HBM roofline for the "
     "current batch shape", "live_hbm_bw_pct"),
    ("pstpu:live_effective_tokens_per_target_step", _G,
     "Tokens emitted per target-model step over the rolling window",
     "live_effective_tokens_per_target_step"),
    ("pstpu:host_stall_seconds_total", _C,
     "Fetch-done to next issue-start gap with nothing outstanding on the "
     "device", "host_stall_seconds_total"),
    ("pstpu:trace_spans_dropped_total", _C,
     "OTLP spans dropped because the exporter queue was full",
     "trace_spans_dropped_total"),
)
_HANDOFF = (
    ("pstpu:kv_handoffs_total", _C,
     "Completed KV handoff transfers (published or consumed)",
     "kv_handoffs_total"),
    ("pstpu:kv_handoff_bytes_total", _C,
     "Bytes moved through the KV handoff plane", "kv_handoff_bytes_total"),
    ("pstpu:kv_handoff_seconds_total", _C,
     "Seconds spent serializing/publishing/consuming KV handoffs",
     "kv_handoff_seconds_total"),
    ("pstpu:kv_handoff_failures_total", _C, "Failed KV handoff transfers",
     "kv_handoff_failures_total"),
)
_MESH = (
    ("pstpu:mesh_tp_size", _G, "Tensor-parallel degree of the serving mesh",
     "mesh_tp_size"),
    ("pstpu:mesh_sp_size", _G, "Sequence-parallel degree of the serving mesh",
     "mesh_sp_size"),
    ("pstpu:mesh_devices", _G, "Devices the serving mesh occupies",
     "mesh_devices"),
)
_DEFAULTS = {"disagg_role": "unified", "kv_cache_dtype": "bfloat16",
             "mesh_tp_size": 1, "mesh_sp_size": 1, "mesh_devices": 1,
             "hbm_kv_bytes_per_device": {}}

# A family: (name, type, help, [(labels, value), ...]) for gauges and
# counters; (name, "histogram", help, [(labels, Histogram), ...]).
Family = Tuple[str, str, str, List[Tuple[Dict[str, str], object]]]


def engine_families(engine, model_name: str) -> List[Family]:
    """Every series of the engine's exposition, from ``engine.stats()`` and
    its histograms, in the reference renderer's order."""
    s = {**_DEFAULTS, **engine.stats()}
    lab = {"model_name": model_name}

    def scalars(table):
        return [(name, kind, doc, [(lab, s.get(key, 0))])
                for name, kind, doc, key in table]

    fams = scalars(_HEAD)
    fams.append(("pstpu:disagg_role", _G,
                 "Engine disaggregation role (1 = active)",
                 [({**lab, "role": s["disagg_role"]}, 1)]))
    fams += scalars(_HANDOFF)
    fams.append(("pstpu:kv_cache_dtype", _G,
                 "KV-cache storage dtype of the block pool (1 = active)",
                 [({**lab, "kv_cache_dtype": s["kv_cache_dtype"]}, 1)]))
    fams.append(("pstpu:kv_quant_bytes_saved_total", _C,
                 "KV-pool bytes the quantized cache avoided writing vs the "
                 "compute dtype", [(lab, s.get("kv_quant_bytes_saved_total", 0))]))
    fams += scalars(_MESH)
    fams.append(("pstpu:hbm_kv_bytes", _G,
                 "KV-pool bytes resident per device (payload + scales; one "
                 "series per tp rank, keyed rank<r>:<device>)",
                 [({**lab, "device": dev}, b) for dev, b in
                  sorted(s["hbm_kv_bytes_per_device"].items())]))
    for name, doc, h in engine.histograms.families() + \
            engine.lifecycle.families():
        fams.append((name, "histogram", doc, [(lab, h)]))
    fams.append(("pstpu:dispatch_duration_seconds", "histogram",
                 "Issue-to-fetch duration of each dispatch by train kind",
                 [({**lab, "train": t}, engine.dispatch_hists.hists[t])
                  for t in DispatchDurationHistograms.TRAINS]))
    return fams


class EngineMetricsCollector:
    """A ``prometheus_client`` collector of ``engine_families`` (register
    it on a registry). The package is imported when a scrape collects,
    never when this module is imported."""

    def __init__(self, engine):
        self.engine = engine

    def collect(self) -> Iterable:
        from prometheus_client.core import (
            CounterMetricFamily,
            GaugeMetricFamily,
            HistogramMetricFamily,
        )

        classes = {"gauge": GaugeMetricFamily, "counter": CounterMetricFamily,
                   "histogram": HistogramMetricFamily}
        for name, kind, doc, samples in engine_families(
                self.engine, self.engine.config.model_name):
            labels = list(samples[0][0]) if samples else ["model_name"]
            # prometheus_client appends _total to a counter family's name.
            base = name[:-len("_total")] if kind == "counter" else name
            fam = classes[kind](base, doc, labels=labels)
            for lv, value in samples:
                if kind == "histogram":
                    fam.add_metric(list(lv.values()), value.cumulative(),
                                   value.sum)
                else:
                    fam.add_metric(list(lv.values()), float(value))
            yield fam
