"""Data-plane resilience: per-backend circuit breakers, retry/failover
budgets, and per-request deadlines.

The router's elasticity story (PAPER.md §1, §5) is readiness-gated
discovery — but the K8s watch notices a dead pod seconds after the first
connect refused. This module covers that gap at request time:

  * ``CircuitBreaker`` — rolling error-rate state machine per backend:
    CLOSED (serving) → OPEN (ejected after the windowed error rate crosses
    the threshold) → HALF_OPEN (after a cooldown, exactly one probe request
    is let through; success closes the circuit, failure re-opens it).
  * ``ResilienceManager`` — the per-backend breaker registry the proxy path
    consults before routing and reports outcomes to; exports
    ``router_circuit_state`` and is surfaced in the router's /health.
  * ``Deadline`` — per-request TTFT + total budgets, defaulted from router
    flags and overridable per request via the ``x-ttft-deadline`` /
    ``x-request-timeout`` headers (seconds).
  * ``backoff_delay`` — capped exponential backoff with full jitter for the
    retry loop in request_service.

Only PRE-STREAM failures (connect refused/timed out, 502/503 before any
byte reaches the client) are retried; once bytes are on the wire a failure
is truncation-only — the backend is marked, never the bytes resent.

The port's copy of ``production_stack_tpu/router/resilience.py``.
"""

import random
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

from production_stack_tpu_torch.router import metrics
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}

# Identity of THIS router replica (docs/ROUTER_SCALE.md): shows up in
# breaker transition logs, the ``router`` label on router_circuit_state,
# and the peer breaker-state files — so a 2-replica Grafana view can tell
# WHICH replica tripped. Set once at startup from --router-id.
_router_id = "router"


def set_router_id(router_id: str) -> None:
    global _router_id
    if router_id:
        _router_id = router_id


def get_router_id() -> str:
    return _router_id

#: Backend HTTP statuses treated as a pre-stream backend failure (the pod
#: is restarting / shedding); anything else is relayed to the client as-is.
RETRYABLE_STATUSES = (502, 503)


@dataclass
class ResilienceConfig:
    # Retry budget: total connection attempts per request (1 = no retry).
    retry_max_attempts: int = 3
    retry_backoff_base: float = 0.05   # first retry delay (seconds)
    retry_backoff_cap: float = 1.0     # per-retry delay ceiling
    # Circuit breaker: windowed error rate.
    breaker_window: float = 30.0       # rolling outcome window (seconds)
    breaker_min_requests: int = 5      # outcomes required before tripping
    breaker_error_rate: float = 0.5    # windowed error rate that opens
    breaker_open_duration: float = 10.0  # cooldown before the half-open probe
    # Half-open hysteresis: minimum seconds a breaker must keep probing
    # successfully before it may close. 0 closes on the first probe success
    # (the pre-soak behavior), which lets a slow/jittery straggler flap
    # open<->closed every probe under sustained load — a dwell makes the
    # breaker demand a sustained healthy period instead.
    breaker_half_open_dwell: float = 0.0
    # Mid-stream resume (docs/RESILIENCE.md): how many times one client
    # stream may be resumed on another backend after a MID-STREAM backend
    # failure (0 restores truncation-only semantics). Each resume re-issues
    # the request with the delivered token ids + sampler seed; the target
    # engine restores the KV and continues token-identically.
    max_midstream_resumes: int = 1
    # Deadlines (0 disables). Header overrides are per request.
    default_timeout: float = 300.0     # total request budget (seconds)
    default_ttft_deadline: float = 0.0  # budget to the first backend byte
    timeout_header: str = "x-request-timeout"
    ttft_header: str = "x-ttft-deadline"
    # Soft SLO attainment tracking (router_slo_attainment): window over
    # which the per-class attainment fraction is computed.
    slo_window: float = 60.0
    slo_class_header: str = "x-slo-class"
    slo_ttft_header: str = "x-slo-ttft"


class DeadlineExceeded(Exception):
    """The request's TTFT or total budget ran out before/while talking to
    ``backend_url``; ``kind`` is "ttft" or "total"."""

    def __init__(self, kind: str, backend_url: str):
        super().__init__(f"{kind} deadline exceeded talking to {backend_url}")
        self.kind = kind
        self.backend_url = backend_url


class PreStreamFailure(Exception):
    """Backend failed before any response byte reached the client —
    safe to retry/fail over."""

    def __init__(self, backend_url: str, reason: str,
                 status: Optional[int] = None):
        super().__init__(f"{backend_url}: {reason}")
        self.backend_url = backend_url
        self.reason = reason
        self.status = status


class Deadline:
    """Per-request budgets measured from router ingress."""

    def __init__(self, total: Optional[float] = None,
                 ttft: Optional[float] = None,
                 start: Optional[float] = None):
        self.start = time.monotonic() if start is None else start
        self.total = total or None     # 0/None -> disabled
        self.ttft = ttft or None

    @classmethod
    def from_request(cls, headers, cfg: ResilienceConfig) -> "Deadline":
        def _header_float(name: str, default: float) -> Optional[float]:
            raw = headers.get(name) if headers is not None else None
            if raw is None:
                return default
            try:
                val = float(raw)
            except (TypeError, ValueError):
                return default
            if val <= 0:        # invalid/non-positive: keep the default
                return default
            # Clients may only TIGHTEN the operator-configured bound, never
            # extend or disable it (an unbounded override would let any
            # client hold backend connections open indefinitely).
            return min(val, default) if default else val

        return cls(
            total=_header_float(cfg.timeout_header, cfg.default_timeout),
            ttft=_header_float(cfg.ttft_header, cfg.default_ttft_deadline),
        )

    def binding_kind(self) -> str:
        """Which budget expires first while waiting for the first byte
        (labels 504s and the deadline metric correctly when both are set)."""
        if self.ttft is None:
            return "total"
        if self.total is None or self.ttft <= self.total:
            return "ttft"
        return "total"

    def remaining_total(self) -> Optional[float]:
        if self.total is None:
            return None
        return self.total - (time.monotonic() - self.start)

    def remaining_ttft(self) -> Optional[float]:
        """Budget to the first backend byte: min of the ttft and total
        budgets (whichever runs out first aborts the wait)."""
        rem_total = self.remaining_total()
        if self.ttft is None:
            return rem_total
        rem_ttft = self.ttft - (time.monotonic() - self.start)
        return rem_ttft if rem_total is None else min(rem_ttft, rem_total)

    def expired(self) -> bool:
        rem = self.remaining_total()
        return rem is not None and rem <= 0


def backoff_delay(attempt: int, cfg: ResilienceConfig) -> float:
    """Capped exponential backoff with full jitter (attempt counts from 1)."""
    ceiling = min(cfg.retry_backoff_cap,
                  cfg.retry_backoff_base * (2 ** (attempt - 1)))
    return ceiling * (0.5 + random.random() * 0.5)


class CircuitBreaker:
    """Rolling error-rate breaker for one backend."""

    def __init__(self, url: str, cfg: ResilienceConfig):
        self.url = url
        self.cfg = cfg
        self.state = CLOSED
        self._outcomes: List = []      # (timestamp, ok) within the window
        self._opened_at = 0.0
        self._probe_at = 0.0           # when the half-open probe dispatched
        self._half_open_since = 0.0    # when probing started (dwell clock)
        self._publish()

    def _publish(self) -> None:
        metrics.router_circuit_state.labels(
            server=self.url, router=get_router_id()
        ).set(self.state)

    def _trim(self, now: float) -> None:
        cutoff = now - self.cfg.breaker_window
        self._outcomes = [o for o in self._outcomes if o[0] >= cutoff]

    # ------------------------------------------------------------- decisions
    def allow(self) -> bool:
        """May a request be sent to this backend right now? Side-effect-free
        apart from the OPEN -> HALF_OPEN cooldown transition — the probe
        slot is only consumed by ``on_dispatch`` (routing may check several
        candidates but dispatch to one)."""
        if self.state == CLOSED:
            return True
        now = time.monotonic()
        if self.state == OPEN:
            if now - self._opened_at < self.cfg.breaker_open_duration:
                return False
            self.state = HALF_OPEN
            self._probe_at = 0.0
            self._half_open_since = now
            self._publish()
            logger.info("[%s] Circuit %s: open -> half-open (probing)",
                        get_router_id(), self.url)
        # HALF_OPEN: one probe at a time. The probe slot is a LEASE, not a
        # flag — if the probe's outcome is never reported (e.g. the request
        # hit its deadline), the slot frees itself after open_duration.
        return now - self._probe_at >= self.cfg.breaker_open_duration

    def on_dispatch(self) -> None:
        """A request was actually sent to this backend."""
        if self.state == HALF_OPEN:
            self._probe_at = time.monotonic()

    # -------------------------------------------------------------- outcomes
    def record_success(self) -> None:
        now = time.monotonic()
        if self.state == HALF_OPEN:
            if now - self._half_open_since < self.cfg.breaker_half_open_dwell:
                # Hysteresis: a single fast probe success must not flap a
                # straggler's breaker straight back to closed. Stay
                # half-open, but free the probe slot immediately so the
                # next probe dispatches without waiting out open_duration.
                self._probe_at = 0.0
                logger.info(
                    "[%s] Circuit %s: half-open probe ok, dwelling "
                    "(%.2fs of %.2fs)", get_router_id(), self.url,
                    now - self._half_open_since,
                    self.cfg.breaker_half_open_dwell,
                )
                return
            self.state = CLOSED
            self._outcomes = []
            self._probe_at = 0.0
            self._publish()
            logger.info("[%s] Circuit %s: half-open -> closed (probe ok)",
                        get_router_id(), self.url)
            return
        self._outcomes.append((now, True))
        self._trim(now)

    def apply_remote_open(self, remaining_s: float, peer: str) -> None:
        """Adopt a PEER replica's OPEN verdict on this backend
        (docs/ROUTER_SCALE.md). One-way and advisory: only a locally-CLOSED
        breaker opens — a breaker that is already OPEN (local evidence) or
        HALF_OPEN (actively probing; the probe result is strictly fresher
        than the peer's snapshot) is never touched, and a peer can never
        CLOSE a circuit here. The open is backdated so the half-open probe
        fires when the peer's cooldown would, not a full window later."""
        if self.state != CLOSED or remaining_s <= 0:
            return
        remaining_s = min(remaining_s, self.cfg.breaker_open_duration)
        self.state = OPEN
        self._opened_at = time.monotonic() - (
            self.cfg.breaker_open_duration - remaining_s
        )
        self._publish()
        logger.warning(
            "[%s] Circuit %s: closed -> open (adopted from peer %s, "
            "%.1fs remaining)", get_router_id(), self.url, peer, remaining_s,
        )

    def record_failure(self) -> None:
        now = time.monotonic()
        if self.state == HALF_OPEN:
            self.state = OPEN
            self._opened_at = now
            self._probe_at = 0.0
            self._publish()
            logger.warning("[%s] Circuit %s: half-open -> open (probe failed)",
                           get_router_id(), self.url)
            return
        self._outcomes.append((now, False))
        self._trim(now)
        if self.state != CLOSED:
            return
        total = len(self._outcomes)
        if total < self.cfg.breaker_min_requests:
            return
        failures = sum(1 for _, ok in self._outcomes if not ok)
        if failures / total >= self.cfg.breaker_error_rate:
            self.state = OPEN
            self._opened_at = now
            self._publish()
            logger.warning(
                "[%s] Circuit %s: closed -> open (%d/%d failures in %.0fs "
                "window)", get_router_id(), self.url, failures, total,
                self.cfg.breaker_window,
            )


class ResilienceManager:
    """Per-backend breaker registry consulted by the proxy path."""

    def __init__(self, config: Optional[ResilienceConfig] = None):
        self.config = config or ResilienceConfig()
        self._breakers: Dict[str, CircuitBreaker] = {}
        # The event loop drives allow/on_dispatch/record_*; the
        # dynamic-config watcher THREAD drives peer_snapshot /
        # apply_peer_state (docs/ROUTER_SCALE.md gossip). One lock
        # serializes registry mutation and breaker state transitions
        # across the two — iterating an unlocked dict the loop is
        # concurrently inserting into raises RuntimeError and would drop
        # a whole gossip tick.
        self._lock = threading.Lock()

    def _breaker(self, url: str) -> CircuitBreaker:
        br = self._breakers.get(url)
        if br is None:
            br = self._breakers[url] = CircuitBreaker(url, self.config)
        return br

    def allow(self, url: str) -> bool:
        with self._lock:
            return self._breaker(url).allow()

    def on_dispatch(self, url: str) -> None:
        with self._lock:
            self._breaker(url).on_dispatch()

    def record_success(self, url: str) -> None:
        with self._lock:
            self._breaker(url).record_success()

    def record_failure(self, url: str) -> None:
        with self._lock:
            self._breaker(url).record_failure()

    def state(self, url: str) -> int:
        with self._lock:
            return self._breaker(url).state

    def snapshot(self) -> Dict[str, str]:
        """url -> state name, for the router's /health payload."""
        with self._lock:
            return {
                url: _STATE_NAMES[br.state]
                for url, br in sorted(self._breakers.items())
            }

    # ------------------------------------------------ peer reconciliation
    def peer_snapshot(self) -> Dict[str, float]:
        """url -> remaining open seconds, for every currently-OPEN circuit.
        The only breaker state worth telling peer replicas about
        (docs/ROUTER_SCALE.md): remaining-time deltas transfer across
        processes where monotonic timestamps cannot."""
        now = time.monotonic()
        out = {}
        with self._lock:
            for url, br in self._breakers.items():
                if br.state != OPEN:
                    continue
                rem = self.config.breaker_open_duration - (now - br._opened_at)
                if rem > 0:
                    out[url] = round(rem, 3)
        return out

    def apply_peer_state(self, peer_id: str,
                         open_circuits: Dict[str, float]) -> None:
        """Adopt a peer replica's OPEN circuits (published through the
        dynamic-config watch plane). Malformed entries are skipped — peer
        files are best-effort, never load-bearing for correctness."""
        for url, rem in (open_circuits or {}).items():
            try:
                rem = float(rem)
                url = str(url)
            except (TypeError, ValueError):
                continue
            with self._lock:
                self._breaker(url).apply_remote_open(rem, peer_id)


class SLOTracker:
    """Rolling-window per-class SLO attainment, exported as the
    ``router_slo_attainment{slo_class}`` gauge — the per-class scale-up
    signal an autoscaler pairs with ``router_queue_depth`` (docs/SOAK.md).

    Requests opt in by carrying the ``x-slo-class`` header (class name)
    and, optionally, ``x-slo-ttft`` (a SOFT router-observed TTFT target in
    seconds — measured only, never enforced; hard deadlines stay on
    ``x-ttft-deadline``). Sheds, deadline aborts, and backend failures all
    count as misses: an autoscaler must see attainment sag while the
    router is turning work away.

    The class name is CLIENT-CONTROLLED, so live classes are capped at
    ``max_classes``: a new name arriving at the cap evicts the
    least-recently-observed class (its gauge series removed) instead of
    minting unbounded Prometheus label series / tracker memory — and
    instead of silently ignoring new names, which would let a flood of
    junk classes permanently starve the real ones out of tracking (a
    legitimate class always re-registers on its next request). observe()
    runs on the streaming hot path (first byte of every opted-in
    request), so the window is a deque with a running met-counter: O(1)
    amortized per observation, never a rescan of the window."""

    def __init__(self, window: float = 60.0, max_classes: int = 32):
        self.window = window
        self.max_classes = max_classes
        # class -> [deque of (ts, met), met_count]
        self._outcomes: Dict[str, list] = {}

    def _expire(self, state, cutoff: float) -> None:
        outcomes, _ = state
        while outcomes and outcomes[0][0] < cutoff:
            _, was_met = outcomes.popleft()
            if was_met:
                state[1] -= 1

    def observe(self, slo_class: str, met: bool) -> None:
        now = time.monotonic()
        state = self._outcomes.get(slo_class)
        if state is None:
            if len(self._outcomes) >= self.max_classes:
                # Cardinality bound on an untrusted header: evict the
                # least-recently-observed class to make room.
                # (A class drained empty by snapshot() sorts first.)
                stale = min(
                    self._outcomes,
                    key=lambda c: (self._outcomes[c][0][-1][0]
                                   if self._outcomes[c][0] else 0.0),
                )
                del self._outcomes[stale]
                try:
                    metrics.router_slo_attainment.remove(stale)
                except KeyError:
                    pass
            state = self._outcomes[slo_class] = [deque(), 0]
        state[0].append((now, bool(met)))
        if met:
            state[1] += 1
        self._expire(state, now - self.window)
        metrics.router_slo_attainment.labels(slo_class=slo_class).set(
            state[1] / len(state[0])
        )

    def publish(self) -> None:
        """Re-expire every class's window and republish its gauge; classes
        whose outcomes have fully aged out are dropped (label series
        removed). Without this the gauge would freeze at its last value
        once a class's traffic stops — e.g. pinned at 0.0 after a shed
        burst ended the load — and an HPA wired to it would scale on stale
        data forever. Called from the router's /metrics handler."""
        cutoff = time.monotonic() - self.window
        for cls in list(self._outcomes):
            state = self._outcomes[cls]
            self._expire(state, cutoff)
            if not state[0]:
                del self._outcomes[cls]
                try:
                    metrics.router_slo_attainment.remove(cls)
                except KeyError:
                    pass
            else:
                metrics.router_slo_attainment.labels(slo_class=cls).set(
                    state[1] / len(state[0])
                )

    def observe_from_headers(self, headers, cfg: "ResilienceConfig",
                             ttft_s: Optional[float]) -> None:
        """Record one request outcome from its headers. ``ttft_s`` is the
        router-observed TTFT, or None when no first byte was ever relayed
        (shed / deadline / backend failure -> miss)."""
        if headers is None:
            return
        slo_class = headers.get(cfg.slo_class_header)
        if not slo_class:
            return
        target_raw = headers.get(cfg.slo_ttft_header)
        if ttft_s is None:
            met = False
        elif target_raw is None:
            met = True                 # class tracked, no TTFT target set
        else:
            try:
                met = ttft_s <= float(target_raw)
            except (TypeError, ValueError):
                met = True
        self.observe(slo_class, met)

    def snapshot(self) -> Dict[str, float]:
        cutoff = time.monotonic() - self.window
        out = {}
        for cls, state in self._outcomes.items():
            self._expire(state, cutoff)
            if state[0]:
                out[cls] = state[1] / len(state[0])
        return out


_resilience: Optional[ResilienceManager] = None
_slo_tracker: Optional[SLOTracker] = None


def initialize_resilience(
    config: Optional[ResilienceConfig] = None,
) -> ResilienceManager:
    global _resilience, _slo_tracker
    _resilience = ResilienceManager(config)
    _slo_tracker = SLOTracker(window=_resilience.config.slo_window)
    return _resilience


def get_resilience() -> Optional[ResilienceManager]:
    return _resilience


def get_slo_tracker() -> Optional[SLOTracker]:
    return _slo_tracker
