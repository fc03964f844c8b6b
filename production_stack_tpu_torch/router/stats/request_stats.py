"""Router-side per-backend request statistics (push plane).

The proxy hooks feed this monitor on request lifecycle events; routing logic
and /metrics consume the derived sliding-window stats. Contract parity with
reference src/vllm_router/stats/request_stats.py:
  * ``MovingAverageMonitor`` — time-windowed value series (:45-90).
  * ``RequestStatsMonitor`` — on_new_request / on_request_response /
    on_request_complete / on_request_swapped hooks (:132-209) producing
    RequestStats{qps, ttft, in_prefill, in_decode, finished, latency} per
    engine URL (:21-42, :225-293).

Single-event-loop discipline: all hooks run on the asyncio loop, so no locks
(same assumption as the reference, SURVEY.md §5 "race detection").

The port's copy of ``production_stack_tpu/router/stats/request_stats.py``.
"""

from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple

from production_stack_tpu_torch.utils import SingletonMeta


@dataclass
class RequestStats:
    qps: float = 0.0
    ttft: float = 0.0                  # avg time-to-first-token in window
    in_prefill_requests: int = 0
    in_decoding_requests: int = 0
    finished_requests: int = 0
    uptime: float = 0.0
    avg_decoding_length: float = 0.0
    avg_latency: float = 0.0
    avg_itl: float = 0.0               # inter-token latency
    num_swapped_requests: int = 0


class MovingAverageMonitor:
    """Values in a sliding time window."""

    def __init__(self, window_size: float):
        self.window_size = window_size
        self.timestamps: Deque[float] = deque()
        self.values: Deque[float] = deque()

    def update(self, timestamp: float, value: float) -> None:
        self.timestamps.append(timestamp)
        self.values.append(value)
        self._expire(timestamp)

    def update_no_value(self, timestamp: float) -> None:
        self.update(timestamp, 0.0)

    def _expire(self, now: float) -> None:
        cutoff = now - self.window_size
        while self.timestamps and self.timestamps[0] < cutoff:
            self.timestamps.popleft()
            self.values.popleft()

    def get_average(self) -> float:
        return sum(self.values) / len(self.values) if self.values else -1.0

    def get_sum(self) -> float:
        return sum(self.values)

    def get_count(self) -> int:
        return len(self.values)


class RequestStatsMonitor(metaclass=SingletonMeta):
    def __init__(self, sliding_window_size: float = 60.0):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        self.sliding_window_size = sliding_window_size
        # per-engine sliding windows
        self.qps_monitors: Dict[str, MovingAverageMonitor] = {}
        self.ttft_monitors: Dict[str, MovingAverageMonitor] = {}
        self.latency_monitors: Dict[str, MovingAverageMonitor] = {}
        self.decoding_length_monitors: Dict[str, MovingAverageMonitor] = {}
        self.itl_monitors: Dict[str, MovingAverageMonitor] = {}
        # in-flight bookkeeping keyed by (engine_url, request_id)
        self.in_prefill: Dict[Tuple[str, str], float] = {}
        self.in_decoding: Dict[Tuple[str, str], float] = {}
        self.last_token_time: Dict[Tuple[str, str], Tuple[float, int]] = {}
        self.finished_requests: Dict[str, int] = {}
        self.swapped_requests: Dict[str, int] = {}
        self.first_query_time: Optional[float] = None

    def _monitor(self, table: Dict, engine_url: str) -> MovingAverageMonitor:
        if engine_url not in table:
            table[engine_url] = MovingAverageMonitor(self.sliding_window_size)
        return table[engine_url]

    # ---------------------------------------------------------------- hooks
    def on_new_request(self, engine_url: str, request_id: str, timestamp: float) -> None:
        self.in_prefill[(engine_url, request_id)] = timestamp
        self._monitor(self.qps_monitors, engine_url).update_no_value(timestamp)
        if self.first_query_time is None:
            self.first_query_time = timestamp

    def on_request_response(self, engine_url: str, request_id: str, timestamp: float) -> None:
        """First streamed token arrived: prefill -> decode."""
        key = (engine_url, request_id)
        start = self.in_prefill.pop(key, None)
        if start is None:
            return
        self.in_decoding[key] = start
        self.last_token_time[key] = (timestamp, 0)
        self._monitor(self.ttft_monitors, engine_url).update(
            timestamp, timestamp - start
        )
        from production_stack_tpu_torch.router import metrics

        metrics.router_ttft_seconds.labels(server=engine_url).observe(
            timestamp - start
        )

    def on_request_token(self, engine_url: str, request_id: str, timestamp: float) -> None:
        """A subsequent streamed chunk arrived (inter-token latency)."""
        key = (engine_url, request_id)
        prev = self.last_token_time.get(key)
        if prev is None:
            return
        prev_t, n = prev
        self._monitor(self.itl_monitors, engine_url).update(
            timestamp, timestamp - prev_t
        )
        self.last_token_time[key] = (timestamp, n + 1)

    def on_request_complete(self, engine_url: str, request_id: str, timestamp: float) -> None:
        key = (engine_url, request_id)
        start = self.in_decoding.pop(key, None) or self.in_prefill.pop(key, None)
        tok = self.last_token_time.pop(key, None)
        self.finished_requests[engine_url] = (
            self.finished_requests.get(engine_url, 0) + 1
        )
        if start is not None:
            self._monitor(self.latency_monitors, engine_url).update(
                timestamp, timestamp - start
            )
            from production_stack_tpu_torch.router import metrics

            metrics.router_e2e_latency_seconds.labels(
                server=engine_url
            ).observe(timestamp - start)
        if tok is not None:
            self._monitor(self.decoding_length_monitors, engine_url).update(
                timestamp, tok[1] + 1
            )

    def on_request_swapped(self, engine_url: str, request_id: str, timestamp: float) -> None:
        self.swapped_requests[engine_url] = (
            self.swapped_requests.get(engine_url, 0) + 1
        )

    # ----------------------------------------------------------------- query
    def get_request_stats(self, current_time: float) -> Dict[str, RequestStats]:
        out: Dict[str, RequestStats] = {}
        urls = (
            set(self.qps_monitors) | set(self.finished_requests)
            | set(self.swapped_requests)
            | {u for u, _ in self.in_prefill} | {u for u, _ in self.in_decoding}
        )
        uptime = (
            current_time - self.first_query_time if self.first_query_time else 0.0
        )
        for url in urls:
            qps_mon = self.qps_monitors.get(url)
            if qps_mon is not None:
                qps_mon._expire(current_time)
                qps = qps_mon.get_count() / self.sliding_window_size
            else:
                qps = 0.0
            ttft = (
                self.ttft_monitors[url].get_average()
                if url in self.ttft_monitors else -1.0
            )
            out[url] = RequestStats(
                qps=qps,
                ttft=ttft,
                in_prefill_requests=sum(
                    1 for (u, _) in self.in_prefill if u == url
                ),
                in_decoding_requests=sum(
                    1 for (u, _) in self.in_decoding if u == url
                ),
                finished_requests=self.finished_requests.get(url, 0),
                uptime=uptime,
                avg_decoding_length=(
                    self.decoding_length_monitors[url].get_average()
                    if url in self.decoding_length_monitors else -1.0
                ),
                avg_latency=(
                    self.latency_monitors[url].get_average()
                    if url in self.latency_monitors else -1.0
                ),
                avg_itl=(
                    self.itl_monitors[url].get_average()
                    if url in self.itl_monitors else -1.0
                ),
                num_swapped_requests=self.swapped_requests.get(url, 0),
            )
        return out


def initialize_request_stats_monitor(sliding_window_size: float = 60.0) -> RequestStatsMonitor:
    return RequestStatsMonitor(sliding_window_size)


def get_request_stats_monitor() -> RequestStatsMonitor:
    return RequestStatsMonitor()
