"""Engine /metrics scraper (pull plane).

Counterpart of ``production_stack_tpu/router/stats/engine_stats.py``, over
``urllib.request`` on the scraper's own thread (the JAX file uses
``requests``): the event loop never waits on a scrape.

A daemon thread polls every discovered engine's Prometheus ``/metrics`` and
parses the vllm-compatible series our TPU engines emit. Contract parity with
reference src/vllm_router/stats/engine_stats.py:
  * series parsed: ``vllm:num_requests_running``, ``vllm:num_requests_waiting``,
    ``vllm:gpu_prefix_cache_hits_total`` / ``vllm:gpu_prefix_cache_queries_total``,
    ``vllm:gpu_cache_usage_perc`` (:27-72, :128-139) — on TPU the "gpu" cache
    series are reinterpreted as HBM KV-pool usage, same names so dashboards
    and the cache-aware router work unchanged.
  * per-interval hit-rate from counter DELTAS between consecutive scrapes
    (:141-155, this fork's rewrite), not lifetime ratios.
  * health = scrape thread recently completed a pass (:229-237).
"""

import json
import threading
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Optional, Tuple

from production_stack_tpu_torch.router.service_discovery import get_service_discovery
from production_stack_tpu_torch.utils import SingletonMeta, init_logger

logger = init_logger(__name__)


def http_get_text(url: str, timeout: float) -> str:
    """GET ``url``; the body as text. Raises on a non-2xx status or a
    transport failure (``urllib`` raises ``HTTPError`` for >= 400)."""
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode("utf-8", "replace")


@dataclass
class EngineStats:
    num_running_requests: int = 0
    num_queuing_requests: int = 0
    gpu_prefix_cache_hit_rate: float = 0.0   # per-interval (delta-based)
    gpu_cache_usage_perc: float = 0.0        # TPU: HBM KV-pool usage
    num_preemptions: int = 0
    # Disagg role scraped from pstpu:disagg_role{role="..."} — the
    # DisaggRouter's pool-split fallback when discovery carries no role.
    role: str = ""
    # Fleet-perf plane (docs/OBSERVABILITY.md): the engine's live roofline
    # gauges, re-exported per backend as router_fleet_* and served by
    # GET /fleet. 0.0 when the engine predates them (or is idle).
    live_tok_per_s: float = 0.0
    live_hbm_bw_pct: float = 0.0
    live_effective_tokens_per_target_step: float = 0.0

    @staticmethod
    def from_prometheus_text(text: str, prev: Optional[Tuple[float, float]] = None):
        """Parse exposition text; returns (EngineStats, (hits, queries))."""
        import re

        values: Dict[str, float] = {}
        role = ""
        for line in text.splitlines():
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if len(parts) < 2:
                continue
            name = parts[0].split("{")[0]
            if name == "pstpu:disagg_role":
                m = re.search(r'role="([^"]*)"', parts[0])
                if m and parts[-1] not in ("0", "0.0"):
                    role = m.group(1)
                continue
            try:
                values[name] = float(parts[-1])
            except ValueError:
                continue

        hits = values.get("vllm:gpu_prefix_cache_hits_total", 0.0)
        queries = values.get("vllm:gpu_prefix_cache_queries_total", 0.0)
        if prev is not None:
            dq = queries - prev[1]
            dh = hits - prev[0]
            hit_rate = dh / dq if dq > 0 else 0.0
        else:
            hit_rate = hits / queries if queries > 0 else 0.0
        stats = EngineStats(
            num_running_requests=int(values.get("vllm:num_requests_running", 0)),
            num_queuing_requests=int(values.get("vllm:num_requests_waiting", 0)),
            gpu_prefix_cache_hit_rate=hit_rate,
            gpu_cache_usage_perc=values.get("vllm:gpu_cache_usage_perc", 0.0),
            num_preemptions=int(values.get("vllm:num_preemptions_total", 0)),
            role=role,
            live_tok_per_s=values.get("pstpu:live_tok_per_s", 0.0),
            live_hbm_bw_pct=values.get("pstpu:live_hbm_bw_pct", 0.0),
            live_effective_tokens_per_target_step=values.get(
                "pstpu:live_effective_tokens_per_target_step", 0.0),
        )
        return stats, (hits, queries)


@dataclass(frozen=True)
class PrefixIndexSnapshot:
    """One backend's device-resident prefix digest (docs/KV_ECONOMY.md):
    the truncated block hashes its /prefix_index reported, the block size
    they were chained at, and when the scrape landed (staleness gate)."""

    block_size: int = 0
    entries: FrozenSet[str] = field(default_factory=frozenset)
    truncated: bool = False
    scraped_at: float = 0.0


class EngineStatsScraper(metaclass=SingletonMeta):
    def __init__(self, scrape_interval: float = 10.0,
                 scrape_prefix_index: bool = False,
                 discovery_poll_interval: float = 0.5,
                 on_new_backend=None):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        self.scrape_interval = scrape_interval
        # Cross-engine prefix index (docs/KV_ECONOMY.md): polled from each
        # backend's /prefix_index on the same cadence as /metrics, only
        # when the prefix-aware routing logic is active (the extra
        # request per backend per pass is pointless otherwise).
        self.scrape_prefix_index = scrape_prefix_index
        # Elastic fast-start (docs/ELASTIC.md): between full passes the
        # worker polls discovery at this cadence and scrapes any NEWLY
        # appeared backend immediately (metrics + prefix index), instead
        # of leaving it invisible to routing scores for up to a full
        # scrape interval. ``on_new_backend(url)`` fires once per backend
        # that appears AFTER the first full pass — the router wires the
        # prefix-prewarm push through it. <= 0 disables the fast poll.
        self.discovery_poll_interval = discovery_poll_interval
        self.on_new_backend = on_new_backend
        self.engine_stats: Dict[str, EngineStats] = {}
        self.prefix_index: Dict[str, PrefixIndexSnapshot] = {}
        self._prev_counters: Dict[str, Tuple[float, float]] = {}
        # URLs already seen by any pass: newness detection for the
        # immediate scrape + the one-shot on_new_backend callback.
        self._seen_urls: set = set()
        self._first_pass_done = False
        self._lock = threading.Lock()
        self._last_scrape = time.time()  # construction counts as a pass
                                         # (health grace until first scrape)
        self._running = True
        self._thread = threading.Thread(
            target=self._scrape_worker, daemon=True, name="engine-stats-scraper"
        )
        self._thread.start()

    # ------------------------------------------------------------ scrape loop
    def _scrape_worker(self) -> None:
        while self._running:
            try:
                self._scrape_metrics()
            except Exception:  # noqa: BLE001 — scraper must survive
                logger.exception("Engine stats scrape pass failed")
            self._last_scrape = time.time()
            deadline = time.monotonic() + self.scrape_interval
            if self.discovery_poll_interval <= 0:
                time.sleep(self.scrape_interval)
                continue
            while self._running and time.monotonic() < deadline:
                time.sleep(min(self.discovery_poll_interval,
                               max(0.0, deadline - time.monotonic())))
                try:
                    self._scrape_new_backends()
                except Exception:  # noqa: BLE001 — scraper must survive
                    logger.exception("Immediate scrape of new backend failed")

    def _endpoints(self):
        try:
            return get_service_discovery().get_endpoint_info()
        except AssertionError:
            return None

    def _scrape_metrics(self) -> None:
        endpoints = self._endpoints()
        if endpoints is None:
            return
        fresh: Dict[str, EngineStats] = {}
        fresh_index: Dict[str, PrefixIndexSnapshot] = {}
        for ep in endpoints:
            stats = self._scrape_one_endpoint(ep.url)
            if stats is not None:
                fresh[ep.url] = stats
            if self.scrape_prefix_index:
                snap = self._scrape_prefix_index(ep.url)
                if snap is not None:
                    fresh_index[ep.url] = snap
        live = {ep.url for ep in endpoints}
        # Departed backends also drop their delta baselines (worker-thread
        # state, never touched from the loop): without this the map grows
        # per pod ever seen, and a pod that comes BACK after a restart
        # would compute its first hit-rate delta against pre-restart
        # counters (negative deltas -> a bogus 0.0 interval).
        self._prev_counters = {
            u: c for u, c in self._prev_counters.items() if u in live
        }
        with self._lock:
            self.engine_stats = fresh
            # Departed/unscrapable backends drop out of the index entirely
            # (stale residency must not attract traffic).
            self.prefix_index = fresh_index
            # Departed URLs forget their seen-ness so a pod that comes BACK
            # counts as new again (it boots with a cold KV pool either way).
            self._seen_urls = set(live)
            self._first_pass_done = True

    def _scrape_new_backends(self) -> None:
        """Between full passes: scrape backends discovery has seen but no
        scrape pass has (docs/ELASTIC.md fast-start). A new engine becomes
        visible to routing scores (and the prefix-aware index) within
        ``discovery_poll_interval`` instead of a full scrape interval, and
        the one-shot ``on_new_backend`` hook fires for it — the router's
        prewarm push."""
        endpoints = self._endpoints()
        if endpoints is None:
            return
        with self._lock:
            first_pass_done = self._first_pass_done
            new = [ep for ep in endpoints if ep.url not in self._seen_urls]
            for ep in new:
                self._seen_urls.add(ep.url)
        for ep in new:
            logger.info("Discovery surfaced new backend %s; scraping "
                        "immediately", ep.url)
            # Prewarm BEFORE the first scrape lands it in routing scores:
            # the hot-chain pull is then (mostly) done by the time traffic
            # starts scoring this backend.
            if first_pass_done and self.on_new_backend is not None:
                try:
                    self.on_new_backend(ep.url)
                except Exception:  # noqa: BLE001 — hook must not kill scraper
                    logger.exception("on_new_backend hook failed for %s",
                                     ep.url)
            stats = self._scrape_one_endpoint(ep.url)
            snap = (
                self._scrape_prefix_index(ep.url)
                if self.scrape_prefix_index else None
            )
            with self._lock:
                if stats is not None:
                    self.engine_stats = {**self.engine_stats, ep.url: stats}
                if snap is not None:
                    self.prefix_index = {**self.prefix_index, ep.url: snap}

    def _scrape_one_endpoint(self, url: str) -> Optional[EngineStats]:
        try:
            text = http_get_text(f"{url}/metrics", timeout=5)
        except Exception as e:  # noqa: BLE001 — engine may be down
            logger.warning("Failed to scrape %s/metrics: %s", url, e)
            return None
        stats, counters = EngineStats.from_prometheus_text(
            text, self._prev_counters.get(url)
        )
        self._prev_counters[url] = counters
        return stats

    def _scrape_prefix_index(self, url: str) -> Optional[PrefixIndexSnapshot]:
        try:
            payload = json.loads(http_get_text(f"{url}/prefix_index",
                                               timeout=5))
            return PrefixIndexSnapshot(
                block_size=int(payload.get("block_size", 0)),
                entries=frozenset(payload.get("entries", ())),
                truncated=bool(payload.get("truncated", False)),
                scraped_at=time.time(),
            )
        except Exception as e:  # noqa: BLE001 — engine may be down/old
            logger.warning("Failed to scrape %s/prefix_index: %s", url, e)
            return None

    # -------------------------------------------------------------- interface
    def get_engine_stats(self) -> Dict[str, EngineStats]:
        with self._lock:
            return dict(self.engine_stats)

    def get_prefix_index(self) -> Dict[str, PrefixIndexSnapshot]:
        """Per-backend prefix digests from the last scrape pass (empty
        unless constructed with scrape_prefix_index=True)."""
        with self._lock:
            return dict(self.prefix_index)

    def get_health(self) -> bool:
        return (
            self._thread.is_alive()
            and time.time() - self._last_scrape < 4 * self.scrape_interval + 10
        )

    def close(self) -> None:
        self._running = False


def initialize_engine_stats_scraper(
    scrape_interval: float = 10.0,
    scrape_prefix_index: bool = False,
    discovery_poll_interval: float = 0.5,
    on_new_backend=None,
) -> EngineStatsScraper:
    return EngineStatsScraper(scrape_interval, scrape_prefix_index,
                              discovery_poll_interval, on_new_backend)


def get_engine_stats_scraper() -> EngineStatsScraper:
    return EngineStatsScraper()
