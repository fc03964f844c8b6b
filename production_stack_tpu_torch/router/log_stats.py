"""Periodic human-readable stats dump (reference src/vllm_router/stats/log_stats.py:21-82).

The port's copy of ``production_stack_tpu/router/log_stats.py``."""

import threading
import time

from production_stack_tpu_torch.router.service_discovery import get_service_discovery
from production_stack_tpu_torch.router.stats import (
    get_engine_stats_scraper,
    get_request_stats_monitor,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger("production_stack_tpu_torch.router.log_stats")


def log_stats_once() -> str:
    lines = ["", "==================================================="]
    endpoints = get_service_discovery().get_endpoint_info()
    engine_stats = get_engine_stats_scraper().get_engine_stats()
    request_stats = get_request_stats_monitor().get_request_stats(time.time())
    for ep in endpoints:
        lines.append(f"Server: {ep.url} models={ep.model_names}")
        es = engine_stats.get(ep.url)
        if es is not None:
            lines.append(
                f"  running={es.num_running_requests} "
                f"waiting={es.num_queuing_requests} "
                f"kv_usage={es.gpu_cache_usage_perc:.1%} "
                f"hit_rate={es.gpu_prefix_cache_hit_rate:.1%}"
            )
        rs = request_stats.get(ep.url)
        if rs is not None:
            lines.append(
                f"  qps={rs.qps:.2f} ttft={rs.ttft:.3f}s "
                f"prefill={rs.in_prefill_requests} "
                f"decode={rs.in_decoding_requests} "
                f"finished={rs.finished_requests}"
            )
    lines.append("===================================================")
    text = "\n".join(lines)
    logger.info("%s", text)
    return text


def start_log_stats(interval: float = 10.0) -> threading.Thread:
    def worker():
        while True:
            try:
                log_stats_once()
            except Exception:  # noqa: BLE001 — logging must not kill anything
                logger.exception("log_stats pass failed")
            time.sleep(interval)

    t = threading.Thread(target=worker, daemon=True, name="log-stats")
    t.start()
    return t
