"""Pluggable request -> backend selection.

Contract parity with reference src/vllm_router/routers/routing_logic.py:
  * ``RoutingInterface.route_request(endpoints, engine_stats, request_stats,
    request) -> url`` (:39-59).
  * ``RoundRobinRouter`` (:62-93).
  * ``SessionRouter`` — session-key consistent hashing with lowest-QPS
    fallback for keyless requests; ring follows endpoint churn (:96-189).
  * ``CacheAwareLoadBalancingRouter`` — the fork's addition (:211-421):
    session -> engine KV-affinity map with TTL, predicted cache hit rate
    blended with an engine load score; falls back to least-loaded.
  * singleton initialize/reconfigure/get with in-place swap (:425-460).

The `request` argument duck-types: anything with ``.headers`` (mapping) and
``.json_body`` (dict) works — aiohttp requests and test fakes alike.

The port's copy of ``production_stack_tpu/router/routing_logic.py`` (prefix-aware routing hashes with the port's tokenizer, ``engine/kv_cache.py:_block_hash`` and ``RemoteKVClient``).
"""

import abc
import time
from collections import OrderedDict
from typing import Dict, List, Optional

from production_stack_tpu_torch.router.ring import PlacementRing, near_least_loaded
from production_stack_tpu_torch.router.service_discovery import EndpointInfo
from production_stack_tpu_torch.router.stats.engine_stats import EngineStats
from production_stack_tpu_torch.router.stats.request_stats import RequestStats
from production_stack_tpu_torch.utils import SingletonABCMeta, init_logger
from production_stack_tpu_torch.utils import HashRing

logger = init_logger(__name__)

# Predicted hit rate for the ring's session->engine pick when THIS replica
# has no local affinity entry. With N router replicas, "no local entry"
# usually means a peer replica served the session — and since every replica
# computes the same ring, the ring pick IS where the peer sent it. 0.7
# (not 1.0): the ring can't see evictions or timeouts the local map would.
RING_AFFINITY_PRIOR = 0.7


def _near_least_loaded_urls(endpoints, engine_stats, request_stats,
                            ramp_in_seconds: float) -> List[str]:
    """URLs within ring.LOAD_MARGIN of the least-loaded endpoint — the
    candidate set the placement ring deterministically picks among. When
    one engine is clearly least loaded this collapses to exactly it
    (pre-ring behavior); comparably-loaded engines defer to the ring so
    every replica agrees."""
    by_url = {ep.url: ep for ep in endpoints}
    return near_least_loaded(
        by_url,
        lambda u: CacheAwareLoadBalancingRouter._engine_load_score(
            u, engine_stats, request_stats
        ) + ramp_in_penalty(by_url[u], ramp_in_seconds),
    )


class RoutingLogic:
    ROUND_ROBIN = "roundrobin"
    SESSION = "session"
    CACHE_AWARE_LB = "cache_aware_load_balancing"
    DISAGG = "disagg"
    PREFIX_AWARE = "prefix-aware"


def ramp_in_penalty(ep: EndpointInfo, ramp_in_seconds: float,
                    now: Optional[float] = None) -> float:
    """Slow-start load penalty for a freshly discovered backend
    (docs/ELASTIC.md): decays linearly from 1.0 at discovery to 0.0 at
    ``ramp_in_seconds``, added to the backend's load score so a joining
    engine receives a growing share of traffic while its KV pool and
    dispatch pipeline warm — instead of an instant 1/N avalanche onto a
    stone-cold pool. It is a WEIGHT, not a gate: an engine with a strong
    prefix match (or a saturated fleet) can still win mid-ramp. 0
    disables. Discovery preserves ``added_timestamp`` across
    re-discovery/reconfigure, so only genuinely new backends ramp."""
    if ramp_in_seconds <= 0:
        return 0.0
    age = (now if now is not None else time.time()) - ep.added_timestamp
    if age >= ramp_in_seconds or age < 0:
        return 0.0
    return 1.0 - age / ramp_in_seconds


class RoutingInterface(metaclass=SingletonABCMeta):
    @abc.abstractmethod
    def route_request(
        self,
        endpoints: List[EndpointInfo],
        engine_stats: Dict[str, EngineStats],
        request_stats: Dict[str, RequestStats],
        request,
    ) -> str:
        raise NotImplementedError


class RoundRobinRouter(RoutingInterface):
    def __init__(self, **_):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        self.req_id = 0

    def route_request(self, endpoints, engine_stats, request_stats, request) -> str:
        if not endpoints:
            raise ValueError("No available endpoints for routing")
        chosen = sorted(endpoints, key=lambda e: e.url)[
            self.req_id % len(endpoints)
        ]
        self.req_id += 1
        return chosen.url


class SessionRouter(RoutingInterface):
    """Stable session->backend affinity via consistent hashing.

    Keyless requests fall back to the lowest-QPS backend (reference
    routing_logic.py:111-132) — this matters on TPU where pod startup takes
    minutes, so spreading cold traffic by load beats hashing it.
    """

    def __init__(self, session_key: Optional[str] = None, **_):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        if not session_key:
            raise ValueError("SessionRouter requires --session-key")
        self.session_key = session_key
        self.hash_ring = HashRing()

    def _sync_ring(self, endpoints: List[EndpointInfo]) -> None:
        self.hash_ring.set_nodes([ep.url for ep in endpoints])

    @staticmethod
    def _qps_routing(endpoints, request_stats) -> str:
        best_url, best_qps = None, float("inf")
        for ep in endpoints:
            qps = request_stats[ep.url].qps if ep.url in request_stats else -1
            if qps < best_qps:
                best_url, best_qps = ep.url, qps
        return best_url

    def route_request(self, endpoints, engine_stats, request_stats, request) -> str:
        if not endpoints:
            raise ValueError("No available endpoints for routing")
        self._sync_ring(endpoints)
        session_id = None
        headers = getattr(request, "headers", None)
        if headers is not None:
            session_id = headers.get(self.session_key)
        if not session_id:
            return self._qps_routing(endpoints, request_stats)
        return self.hash_ring.get_node(str(session_id))


class LRUCache:
    """Bounded mapping with recency eviction (reference routing_logic.py:192-208)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self._data: OrderedDict = OrderedDict()

    def get(self, key):
        if key not in self._data:
            return None
        self._data.move_to_end(key)
        return self._data[key]

    def put(self, key, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def __contains__(self, key) -> bool:
        return key in self._data

    def __len__(self) -> int:
        return len(self._data)


class CacheAwareLoadBalancingRouter(RoutingInterface):
    """Blend predicted KV-cache reuse with engine load (fork addition,
    reference routing_logic.py:211-421).

    A session's KV blocks live on the engine that served it last, for roughly
    ``block_reuse_timeout`` seconds (until evicted). Routing a returning
    session back there predicts a prefix-cache hit; but an overloaded engine
    can cost more than the recompute, so the decision blends:
        score = w_cache * predicted_hit_rate - w_load * load_score
    and the best-scoring engine wins. Sessions without affinity (or whose
    blocks likely expired) go to the least-loaded engine.
    """

    def __init__(
        self,
        session_key: Optional[str] = None,
        block_reuse_timeout: float = 300.0,
        cache_weight: float = 0.6,
        load_weight: float = 0.4,
        ramp_in_seconds: float = 0.0,
        **_,
    ):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        self.session_key = session_key
        self.block_reuse_timeout = block_reuse_timeout
        self.cache_weight = cache_weight
        self.load_weight = load_weight
        self.ramp_in_seconds = ramp_in_seconds
        # session -> (engine_url, last_seen_ts). Replica-local HINT only:
        # the cross-replica source of truth for first-contact placement is
        # the deterministic ring below (docs/ROUTER_SCALE.md).
        self._affinity = LRUCache(capacity=8192)
        self._ring = PlacementRing()
        self._rr = 0

    # ------------------------------------------------------------- components
    def _predict_cache_hit_rate(self, session_id, url: str,
                                engine_stats: Dict[str, EngineStats]) -> float:
        """P(prefix KV still resident on `url` for this session)."""
        if session_id is None:
            return 0.0
        entry = self._affinity.get(session_id)
        if entry is None or entry[0] != url:
            return 0.0
        age = time.time() - entry[1]
        if age >= self.block_reuse_timeout:
            return 0.0
        # Fresh sessions predict near-certain reuse, decaying with age and
        # discounted by cache pressure (a full KV pool evicts sooner).
        p = 1.0 - age / self.block_reuse_timeout
        stats = engine_stats.get(url)
        if stats is not None and stats.gpu_cache_usage_perc > 0.9:
            p *= 0.5
        return p

    @staticmethod
    def _engine_load_score(url: str,
                           engine_stats: Dict[str, EngineStats],
                           request_stats: Dict[str, RequestStats]) -> float:
        """0 (idle) .. ~1 (saturated)."""
        score = 0.0
        es = engine_stats.get(url)
        if es is not None:
            score += min(es.num_running_requests / 16.0, 1.0) * 0.4
            score += min(es.num_queuing_requests / 8.0, 1.0) * 0.4
            score += es.gpu_cache_usage_perc * 0.2
        rs = request_stats.get(url)
        if rs is not None and rs.qps > 0:
            score += min(rs.qps / 32.0, 1.0) * 0.2
        return score

    # --------------------------------------------------------------- routing
    def route_request(self, endpoints, engine_stats, request_stats, request) -> str:
        if not endpoints:
            raise ValueError("No available endpoints for routing")
        session_id = None
        headers = getattr(request, "headers", None)
        if headers is not None and self.session_key:
            session_id = headers.get(self.session_key)

        # No fresh LOCAL affinity for this session: a peer replica may
        # still hold its KV-warm engine. The ring computes that engine
        # deterministically from membership alone, so credit the ring pick
        # with a reuse prior instead of treating the session as cold.
        self._ring.sync(ep.url for ep in endpoints)
        ring_url = None
        if session_id is not None:
            entry = self._affinity.get(session_id)
            fresh = entry is not None and \
                time.time() - entry[1] < self.block_reuse_timeout
            if not fresh:
                ring_url = self._ring.pick_session(str(session_id))

        best_url, best_score = None, float("-inf")
        for ep in sorted(endpoints, key=lambda e: e.url):
            hit = self._predict_cache_hit_rate(session_id, ep.url, engine_stats)
            if hit == 0.0 and ep.url == ring_url:
                hit = RING_AFFINITY_PRIOR
            load = self._engine_load_score(ep.url, engine_stats, request_stats)
            load += ramp_in_penalty(ep, self.ramp_in_seconds)
            score = self.cache_weight * hit - self.load_weight * load
            if score > best_score:
                best_url, best_score = ep.url, score

        if best_url is None:  # all scores -inf (cannot happen, but be safe)
            best_url = endpoints[self._rr % len(endpoints)].url
            self._rr += 1
        if session_id is not None:
            self._affinity.put(session_id, (best_url, time.time()))
        return best_url


class PrefixAwareRouter(RoutingInterface):
    """Route on MEASURED global prefix residency, not affinity guesses
    (docs/KV_ECONOMY.md; the RadixAttention / prefix-cache-aware-routing
    shape).

    The router block-hashes the incoming prompt with the engine's exact
    chain scheme (engine/kv_cache.py:_block_hash, seed b"") and scores each
    backend against the cross-engine prefix index the stats scraper builds
    from the engines' /prefix_index digests:

        score = prefix_weight * matched_prefix_fraction - load_weight * load

    where matched_prefix_fraction is the longest contiguous run of the
    prompt's block hashes present in that backend's digest, over the
    prompt's full blocks. Fallback ladder when no backend holds the prefix:

      1. shared-tier restorability — if the offload store holds the chain
         head (one 'I' index query, both dtype namespaces), ANY engine can
         restore it, so pick the least-loaded backend;
      2. session affinity (the cache-aware router's map) — fresh affinity
         wins, else least-loaded.

    Degrades gracefully: a stale/absent index contributes score 0, a down
    kv server trips a cooldown (no per-request reconnect storms), and a
    missing tokenizer limits hashing to token-id prompts — every failure
    lands in the fallback ladder, never an exception on the data plane.
    """

    def __init__(
        self,
        session_key: Optional[str] = None,
        block_reuse_timeout: float = 300.0,
        prefix_weight: float = 1.0,
        load_weight: float = 0.5,
        kv_offload_url: Optional[str] = None,
        prefix_tokenizer=None,
        index_provider=None,
        kv_client=None,
        max_prefix_blocks: int = 512,
        index_ttl: float = 60.0,
        kv_down_cooldown: float = 30.0,
        ramp_in_seconds: float = 0.0,
        **_,
    ):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        self.session_key = session_key
        self.block_reuse_timeout = block_reuse_timeout
        self.prefix_weight = prefix_weight
        self.load_weight = load_weight
        self.ramp_in_seconds = ramp_in_seconds
        self.max_prefix_blocks = max_prefix_blocks
        self.index_ttl = index_ttl
        self.kv_down_cooldown = kv_down_cooldown
        self._index_provider = index_provider
        self._tokenizer = prefix_tokenizer   # object with .encode, or a
        self._tokenizer_spec = (             # model name/path to lazy-load
            prefix_tokenizer if isinstance(prefix_tokenizer, str) else None
        )
        self._tokenizer_failed = False
        self._kv_client = kv_client
        self._kv_url = kv_offload_url
        self._kv_down_until = 0.0
        # session -> (engine_url, last_seen_ts) — the final fallback rung.
        # Replica-local hint; cross-replica agreement comes from the ring.
        self._affinity = LRUCache(capacity=8192)
        self._ring = PlacementRing()
        self._rr = 0
        # decision telemetry (surfaced through /health-style debugging and
        # unit tests; Prometheus export stays on the scrape plane)
        self.routed_by_index = 0
        self.routed_by_tier = 0
        self.routed_by_fallback = 0
        # Load the tokenizer EAGERLY: the HF path can cost seconds of
        # import + disk I/O, which belongs in router startup, never in the
        # first data-plane route_request.
        if self._tokenizer_spec is not None:
            self._get_tokenizer()

    # ------------------------------------------------------------- tokenizer
    def _get_tokenizer(self):
        if self._tokenizer is not None and \
                not isinstance(self._tokenizer, str):
            return self._tokenizer
        if self._tokenizer_spec is None or self._tokenizer_failed:
            return None
        try:
            from production_stack_tpu_torch.engine.tokenizer import get_tokenizer
            from production_stack_tpu_torch.models.config import (
                resolve_model_config,
            )

            self._tokenizer = get_tokenizer(
                self._tokenizer_spec,
                resolve_model_config(self._tokenizer_spec),
            )
            return self._tokenizer
        except Exception:  # noqa: BLE001 — degrade to token-id-only hashing
            logger.exception(
                "prefix-aware router could not load tokenizer %r; only "
                "token-id prompts will be prefix-hashed",
                self._tokenizer_spec,
            )
            self._tokenizer_failed = True
            return None

    def _prompt_token_ids(self, request) -> Optional[List[int]]:
        ids = self._base_prompt_token_ids(request)
        body = getattr(request, "json_body", None)
        if ids is not None and isinstance(body, dict):
            resume = body.get("resume_tokens")
            if isinstance(resume, list) and resume and \
                    all(type(t) is int for t in resume):
                # Mid-stream resume (docs/RESILIENCE.md): the delivered
                # output extends the chain the dead engine computed, so
                # score backends on the FULL prompt+output chain — exactly
                # the blocks most likely resident in the shared tier or on
                # a sibling engine.
                ids = list(ids) + [int(t) for t in resume]
        return ids

    def _base_prompt_token_ids(self, request) -> Optional[List[int]]:
        body = getattr(request, "json_body", None)
        if not isinstance(body, dict):
            return None
        prompt = body.get("prompt")
        if isinstance(prompt, list) and prompt and \
                all(type(t) is int for t in prompt):
            return prompt
        tok = self._get_tokenizer()
        if isinstance(prompt, list) and prompt and \
                all(isinstance(p, str) for p in prompt):
            prompt = prompt[0]   # multi-prompt: route on the first
        if isinstance(prompt, str) and tok is not None:
            return tok.encode(prompt)
        messages = body.get("messages")
        if messages and tok is not None:
            try:
                # The engine's exact prompt construction
                # (api_server.chat_completions) — template divergence would
                # silently zero every match.
                text = tok.apply_chat_template(
                    messages, add_generation_prompt=True
                )
                return tok.encode(text)
            except Exception:  # noqa: BLE001 — malformed messages
                logger.warning(
                    "prefix-aware router failed to render chat template; "
                    "falling back past the index", exc_info=True,
                )
        return None

    # ----------------------------------------------------------------- hashes
    def _prefix_hashes(self, token_ids, block_size: int) -> List[bytes]:
        """Chain hashes of the prompt's full blocks (seed b"", the
        non-LoRA namespace the engines publish), capped at
        max_prefix_blocks."""
        from production_stack_tpu_torch.engine.kv_cache import _block_hash

        if block_size <= 0:
            return []
        max_full = min(
            (len(token_ids) - 1) // block_size, self.max_prefix_blocks
        )
        hashes = []
        prev = b""
        for i in range(max_full):
            prev = _block_hash(
                prev, token_ids[i * block_size:(i + 1) * block_size]
            )
            hashes.append(prev)
        return hashes

    def _index(self) -> dict:
        if self._index_provider is not None:
            try:
                return self._index_provider() or {}
            except Exception:  # noqa: BLE001 — index is advisory
                logger.warning("prefix index provider failed", exc_info=True)
                return {}
        try:
            from production_stack_tpu_torch.router.stats.engine_stats import (
                get_engine_stats_scraper,
            )

            return get_engine_stats_scraper().get_prefix_index()
        except Exception:  # noqa: BLE001 — scraper not initialized (tests)
            logger.warning("prefix index unavailable", exc_info=True)
            return {}

    def matched_prefix_blocks(self, token_ids, snapshot,
                              _hash_cache: Optional[dict] = None) -> int:
        """Longest contiguous run of the prompt's block hashes present in
        one backend's digest (truncated-hex comparison). ``_hash_cache``
        (block_size -> hashes) amortizes the chain hashing across the
        backends of one routing decision."""
        if snapshot is None or not snapshot.entries:
            return 0
        if self.index_ttl > 0 and snapshot.scraped_at and \
                time.time() - snapshot.scraped_at > self.index_ttl:
            return 0   # stale digest: treat as no residency
        if _hash_cache is not None and snapshot.block_size in _hash_cache:
            hashes = _hash_cache[snapshot.block_size]
        else:
            hashes = self._prefix_hashes(token_ids, snapshot.block_size)
            if _hash_cache is not None:
                _hash_cache[snapshot.block_size] = hashes
        run = 0
        for h in hashes:
            if h.hex()[:16] not in snapshot.entries:
                break
            run += 1
        return run

    # ------------------------------------------------------------ shared tier
    def _tier_client(self):
        if self._kv_client is not None:
            return self._kv_client
        if not self._kv_url:
            return None
        from production_stack_tpu_torch.kv_offload.remote import RemoteKVClient

        # Short timeouts: this client runs on the serving path; a slow
        # store must cost milliseconds, not the io default.
        self._kv_client = RemoteKVClient(
            self._kv_url, connect_timeout=0.5, io_timeout=0.5
        )
        return self._kv_client

    def _degraded_mode(self) -> str:
        """What prefix-aware routing falls back to while the shared tier
        is cooling down — with ``--kv-offload-url`` set, the local
        /prefix_index scrape is disabled by default (docs/ROUTER_SCALE.md),
        so a tier outage silently empties BOTH residency rungs unless the
        operator re-enabled scraping. Name the actual degradation so the
        log line tells the operator which ladder they are running on."""
        if self._index_provider is not None:
            return "local prefix-index snapshots"
        from production_stack_tpu_torch.router.stats.engine_stats import (
            EngineStatsScraper,
        )
        from production_stack_tpu_torch.utils import SingletonMeta

        # Peek the singleton registry rather than calling the accessor:
        # get_engine_stats_scraper() CONSTRUCTS a default scraper (and its
        # thread) when none exists — a log helper must not.
        scraper = SingletonMeta._instances.get(EngineStatsScraper)
        if scraper is not None and scraper.scrape_prefix_index:
            return "local /prefix_index snapshots"
        return ("session affinity/least-loaded ONLY — local /prefix_index "
                "scraping is disabled, so no prefix placement until the "
                "tier returns")

    def tier_restorable_blocks(self, hashes: List[bytes]) -> int:
        """Leading blocks of the prompt chain the shared offload tier
        holds, probing both dtype namespaces (bf16 bare keys and int8
        ``q8|`` keys) in ONE index-query round trip. 0 on any store
        error, with a cooldown so a down store is not re-dialed per
        request (the PR-1 degrade-don't-fail posture)."""
        if not hashes or time.time() < self._kv_down_until:
            return 0
        client = self._tier_client()
        if client is None:
            return 0
        if not getattr(client, "_batched_ops_ok", True):
            # Pre-batched-protocol store (native C++ server): the per-key
            # exists() fallback would cost up to 32 sequential round trips
            # on the event loop per routing decision — not worth the rung.
            return 0
        probe = hashes[:16]
        keys = [h for h in probe] + [b"q8|" + h for h in probe]
        t0 = time.monotonic()
        try:
            bits = client.index_query(keys)
        except (ConnectionError, OSError) as e:
            logger.warning(
                "shared KV tier unreachable (%s); prefix-aware routing "
                "degrades to %s for %.0fs",
                e, self._degraded_mode(), self.kv_down_cooldown,
            )
            self._kv_down_until = time.time() + self.kv_down_cooldown
            return 0
        if time.monotonic() - t0 > 0.25:
            # Alive but slow: a per-request stall on the router's event
            # loop serializes ALL traffic. Back off the same way a hard
            # failure does.
            logger.warning(
                "shared KV tier index query took %.2fs; cooling the "
                "restorability rung for %.0fs (degrading to %s)",
                time.monotonic() - t0, self.kv_down_cooldown,
                self._degraded_mode(),
            )
            self._kv_down_until = time.time() + self.kv_down_cooldown
        n = len(probe)
        run = 0
        for i in range(n):
            if bits[i] or bits[n + i]:
                run += 1
            else:
                break
        return run

    # --------------------------------------------------------------- routing
    def route_request(self, endpoints, engine_stats, request_stats,
                      request) -> str:
        if not endpoints:
            raise ValueError("No available endpoints for routing")
        session_id = None
        headers = getattr(request, "headers", None)
        if headers is not None and self.session_key:
            session_id = headers.get(self.session_key)

        self._ring.sync(ep.url for ep in endpoints)
        token_ids = self._prompt_token_ids(request)
        index = self._index() if token_ids else {}
        hash_cache: dict = {}
        best_url, best_score, best_match = None, float("-inf"), 0
        for ep in sorted(endpoints, key=lambda e: e.url):
            snap = index.get(ep.url)
            matched = (
                self.matched_prefix_blocks(token_ids, snap, hash_cache)
                if token_ids else 0
            )
            if token_ids and snap is not None and snap.block_size > 0:
                total = max(
                    1, min((len(token_ids) - 1) // snap.block_size,
                           self.max_prefix_blocks)
                )
            else:
                total = 1
            load = CacheAwareLoadBalancingRouter._engine_load_score(
                ep.url, engine_stats, request_stats
            ) + ramp_in_penalty(ep, self.ramp_in_seconds)
            score = (self.prefix_weight * (matched / total)
                     - self.load_weight * load)
            if score > best_score:
                best_url, best_score, best_match = ep.url, score, matched

        if best_match > 0:
            self.routed_by_index += 1
            if session_id is not None:
                self._affinity.put(session_id, (best_url, time.time()))
            return best_url

        # Nothing device-resident anywhere: if the shared tier can restore
        # the prefix, every engine is equally warm — take the least-loaded.
        if token_ids:
            # Probe at the most common block size among live digests (the
            # fleet normally agrees); default to the engine default.
            sizes = [s.block_size for s in index.values() if s.block_size]
            if sizes:
                bs = max(set(sizes), key=sizes.count)
            else:
                # No live digests to learn the fleet's block size from:
                # fall back to the engine default rather than a literal
                # (a block_size-32 fleet would otherwise hash to keys the
                # store never holds and silently lose this rung).
                from production_stack_tpu_torch.engine.config import EngineConfig

                bs = EngineConfig.block_size
            hashes = hash_cache.get(bs) or self._prefix_hashes(token_ids, bs)
            if self.tier_restorable_blocks(hashes) > 0:
                self.routed_by_tier += 1
                # Any engine can restore; deterministic ring pick (keyed by
                # the prefix chain head) among near-least-loaded engines, so
                # N replicas funnel the SAME tier-restorable prefix to the
                # SAME engine and its device cache warms once, not N times.
                cands = _near_least_loaded_urls(
                    endpoints, engine_stats, request_stats,
                    self.ramp_in_seconds,
                )
                url = self._ring.pick_prefix(
                    hashes[0].hex()[:16], cands
                ) or self._least_loaded(endpoints, engine_stats,
                                        request_stats)
                if session_id is not None:
                    self._affinity.put(session_id, (url, time.time()))
                return url

        # Final rung: session placement. Fresh LOCAL affinity wins (it saw
        # the actual pick); otherwise the deterministic ring decides among
        # near-least-loaded engines — the replica-agnostic replacement for
        # "least loaded with replica-local tie-breaking".
        self.routed_by_fallback += 1
        if session_id is not None:
            entry = self._affinity.get(session_id)
            if entry is not None and \
                    time.time() - entry[1] < self.block_reuse_timeout:
                for ep in endpoints:
                    if ep.url == entry[0]:
                        self._affinity.put(session_id, (ep.url, time.time()))
                        return ep.url
        url = None
        if session_id is not None:
            cands = _near_least_loaded_urls(
                endpoints, engine_stats, request_stats, self.ramp_in_seconds
            )
            url = self._ring.pick_session(str(session_id), cands)
        if url is None:
            url = self._least_loaded(endpoints, engine_stats, request_stats)
        if session_id is not None:
            self._affinity.put(session_id, (url, time.time()))
        return url

    def _least_loaded(self, endpoints, engine_stats, request_stats) -> str:
        best_url, best = None, float("inf")
        for ep in sorted(endpoints, key=lambda e: e.url):
            load = CacheAwareLoadBalancingRouter._engine_load_score(
                ep.url, engine_stats, request_stats
            ) + ramp_in_penalty(ep, getattr(self, "ramp_in_seconds", 0.0))
            if load < best:
                best_url, best = ep.url, load
        if best_url is None:  # defensive; endpoints is never empty here
            best_url = endpoints[self._rr % len(endpoints)].url
            self._rr += 1
        return best_url


class DisaggRouter(RoutingInterface):
    """Two-hop prefill/decode disaggregation routing (docs/DISAGG.md;
    DistServe OSDI'24 / Splitwise ISCA'24 shape).

    Endpoints are split into role pools (prefill/decode/unified) from
    EndpointInfo.role (static flag / k8s pod label) with the scraped
    ``pstpu:disagg_role`` metric as fallback. Hop 1 (prefill) goes to the
    least-loaded prefill engine — prefill is compute-bound, so load is the
    only signal. Hop 2 (decode) prefers the engine already holding the
    session's KV (affinity map with TTL, like the cache-aware router) and
    otherwise takes the least-loaded decode engine. The two-hop
    orchestration itself lives in request_service.route_disagg_request;
    this class only makes the per-hop picks (the ``request`` object's
    ``disagg_hop`` attribute selects which)."""

    def __init__(
        self,
        session_key: Optional[str] = None,
        block_reuse_timeout: float = 300.0,
        ramp_in_seconds: float = 0.0,
        **_,
    ):
        if hasattr(self, "_initialized"):
            return
        self._initialized = True
        self.session_key = session_key
        self.block_reuse_timeout = block_reuse_timeout
        self.ramp_in_seconds = ramp_in_seconds
        # session -> (decode_engine_url, last_seen_ts); replica-local hint,
        # ring below is the cross-replica tie-breaker.
        self._affinity = LRUCache(capacity=8192)
        self._ring = PlacementRing()
        self._rr = 0

    # ----------------------------------------------------------------- pools
    @staticmethod
    def endpoint_role(ep, engine_stats: Dict[str, EngineStats]) -> str:
        role = getattr(ep, "role", None)
        if not role:
            es = engine_stats.get(ep.url)
            role = getattr(es, "role", "") if es is not None else ""
        # Unknown/typo'd roles count as unified rather than orphaning the
        # endpoint into a pool nothing reads.
        return role if role in ("prefill", "decode") else "unified"

    def split_pools(self, endpoints, engine_stats) -> Dict[str, list]:
        pools: Dict[str, list] = {"prefill": [], "decode": [], "unified": []}
        for ep in endpoints:
            pools[self.endpoint_role(ep, engine_stats)].append(ep)
        return pools

    # ----------------------------------------------------------------- picks
    def _least_loaded(self, endpoints, engine_stats, request_stats) -> str:
        best_url, best = None, float("inf")
        for ep in sorted(endpoints, key=lambda e: e.url):
            load = CacheAwareLoadBalancingRouter._engine_load_score(
                ep.url, engine_stats, request_stats
            ) + ramp_in_penalty(ep, getattr(self, "ramp_in_seconds", 0.0))
            if load < best:
                best_url, best = ep.url, load
        if best_url is None:  # defensive; endpoints is never empty here
            best_url = endpoints[self._rr % len(endpoints)].url
            self._rr += 1
        return best_url

    def _session_id(self, request):
        headers = getattr(request, "headers", None)
        if headers is None or not self.session_key:
            return None
        return headers.get(self.session_key)

    def pick_prefill(self, endpoints, engine_stats, request_stats,
                     request) -> str:
        return self._least_loaded(endpoints, engine_stats, request_stats)

    def pick_decode(self, endpoints, engine_stats, request_stats,
                    request) -> str:
        session_id = self._session_id(request)
        if session_id is not None:
            entry = self._affinity.get(session_id)
            if entry is not None and \
                    time.time() - entry[1] < self.block_reuse_timeout:
                for ep in endpoints:
                    if ep.url == entry[0]:
                        self._affinity.put(session_id, (ep.url, time.time()))
                        return ep.url
        url = None
        if session_id is not None:
            # Deterministic decode placement among near-least-loaded decode
            # engines: any replica handling this session's next hop lands
            # on the same KV-warm engine without a state exchange.
            self._ring.sync(ep.url for ep in endpoints)
            url = self._ring.pick_session(
                str(session_id),
                _near_least_loaded_urls(endpoints, engine_stats,
                                        request_stats, self.ramp_in_seconds),
            )
        if url is None:
            url = self._least_loaded(endpoints, engine_stats, request_stats)
        if session_id is not None:
            self._affinity.put(session_id, (url, time.time()))
        return url

    # --------------------------------------------------------------- routing
    def route_request(self, endpoints, engine_stats, request_stats,
                      request) -> str:
        if not endpoints:
            raise ValueError("No available endpoints for routing")
        hop = getattr(request, "disagg_hop", None)
        if hop == "prefill":
            return self.pick_prefill(endpoints, engine_stats, request_stats,
                                     request)
        if hop == "decode":
            return self.pick_decode(endpoints, engine_stats, request_stats,
                                    request)
        # Generic traffic (embeddings, unified fallback): least-loaded.
        return self._least_loaded(endpoints, engine_stats, request_stats)


_ROUTERS = {
    RoutingLogic.ROUND_ROBIN: RoundRobinRouter,
    RoutingLogic.SESSION: SessionRouter,
    RoutingLogic.CACHE_AWARE_LB: CacheAwareLoadBalancingRouter,
    RoutingLogic.DISAGG: DisaggRouter,
    RoutingLogic.PREFIX_AWARE: PrefixAwareRouter,
}


def initialize_routing_logic(routing_logic: str, **kwargs) -> RoutingInterface:
    cls = _ROUTERS.get(routing_logic)
    if cls is None:
        raise ValueError(f"Invalid routing logic: {routing_logic!r}")
    logger.info("Initializing routing logic: %s", routing_logic)
    return cls(**kwargs)


def reconfigure_routing_logic(routing_logic: str, **kwargs) -> RoutingInterface:
    """Swap the active routing logic in place (reference routing_logic.py:445-452).

    Construct-then-swap: the replacement is fully built BEFORE the registry
    is touched, so a bad config (e.g. session without session_key) raises
    without leaving routing uninitialized, and in-flight requests never
    observe an empty registry for more than the GIL-atomic swap below.
    """
    from production_stack_tpu_torch.utils import SingletonMeta

    cls = _ROUTERS.get(routing_logic)
    if cls is None:
        raise ValueError(f"Invalid routing logic: {routing_logic!r}")
    new = cls.__new__(cls)      # bypass the singleton cache
    new.__init__(**kwargs)      # may raise; registry still intact
    for c in _ROUTERS.values():
        SingletonMeta._instances.pop(c, None)
    SingletonMeta._instances[cls] = new
    logger.info("Reconfigured routing logic: %s", routing_logic)
    return new


def get_routing_logic() -> RoutingInterface:
    from production_stack_tpu_torch.utils import SingletonMeta

    for cls in _ROUTERS.values():
        if cls in SingletonMeta._instances:
            return SingletonMeta._instances[cls]
    raise RuntimeError("Routing logic not initialized")
