"""Semantic cache: embedding-similarity response cache (feature-gated).

Contract parity with reference src/vllm_router/experimental/semantic_cache*:
check before routing (hit -> immediate JSONResponse), store after completion,
persisted index, Prometheus gauges (semantic_cache_integration.py:26-306).

TPU-shaped differences: this image has no sentence-transformers or FAISS, so
the embedder is a dependency-free hashed-ngram bag (stable across processes)
and the index is a numpy inner-product scan — same cosine-similarity
semantics at the scales a router cache sees (<=100k entries). Both are
pluggable: pass ``embed_fn`` to use a real model.

The port's copy of ``production_stack_tpu/router/semantic_cache.py``: the
same vectors bit for bit and the same pickled file, so a cache persisted by
either package loads in the other; the four series live on the port's
registry (``router/metrics.py``). The router imports this module (and so
numpy) only when the ``SemanticCache`` gate is on.
"""

import json
import os
import pickle
import re
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from production_stack_tpu_torch.router import http as web
from production_stack_tpu_torch.router.metrics import Counter, Gauge
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

hits_total = Counter("vllm:semantic_cache_hits", "Semantic cache hits")
misses_total = Counter("vllm:semantic_cache_misses", "Semantic cache misses")
cache_size = Gauge("vllm:semantic_cache_size", "Semantic cache entries")
latency_saved = Counter(
    "vllm:semantic_cache_latency_saved_seconds",
    "Estimated latency saved by cache hits",
)

_TOKEN_RE = re.compile(r"\w+")


def _stable_hash(s: str) -> int:
    # NOT the builtin hash(): that is randomized per process (PYTHONHASHSEED)
    # and would invalidate every persisted vector on restart.
    import hashlib

    return int.from_bytes(hashlib.blake2b(s.encode(), digest_size=8).digest(),
                          "big")


def hashed_ngram_embed(text: str, dim: int = 512) -> np.ndarray:
    """Deterministic bag-of-hashed-ngrams embedding, L2-normalized."""
    vec = np.zeros(dim, dtype=np.float32)
    words = _TOKEN_RE.findall(text.lower())
    for i, w in enumerate(words):
        vec[_stable_hash(w) % dim] += 1.0
        if i + 1 < len(words):
            vec[_stable_hash(w + "_" + words[i + 1]) % dim] += 1.0
    n = np.linalg.norm(vec)
    return vec / n if n > 0 else vec


def sentence_transformer_embed_fn(
    model_name: str = "all-MiniLM-L6-v2", model=None,
) -> Callable[[str], np.ndarray]:
    """Real-model ``embed_fn`` over sentence-transformers (optional dep).

    Matches the reference semantic cache's embedder (reference
    experimental/semantic_cache/semantic_cache.py:16-313 uses
    SentenceTransformer + FAISS; the numpy inner-product index here serves
    the same L2-normalized vectors). Pass a preloaded ``model`` (anything
    with ``encode(text) -> vector``) to skip the checkpoint load — tests
    and embedded deployments inject one; otherwise the named checkpoint is
    loaded at construction so a missing dependency fails fast, not on the
    first cached request.

    Select via ``--semantic-cache-embedder sentence-transformers:<name>``.
    """
    if model is None:
        try:
            from sentence_transformers import SentenceTransformer
        except ImportError as e:
            raise RuntimeError(
                "semantic-cache embedder 'sentence-transformers' needs the "
                "sentence-transformers package; omit the flag for the "
                "dependency-free hashed-ngram embedder"
            ) from e
        model = SentenceTransformer(model_name)

    def embed(text: str) -> np.ndarray:
        vec = np.asarray(model.encode(text), dtype=np.float32).reshape(-1)
        n = np.linalg.norm(vec)
        return vec / n if n > 0 else vec

    return embed


def create_embed_fn(spec: str) -> Callable[[str], np.ndarray]:
    """Embedder factory from a CLI spec: 'hashed-ngram' (default) or
    'sentence-transformers[:model-name]'."""
    if spec in ("", "hashed-ngram", None):
        return hashed_ngram_embed
    if spec == "sentence-transformers":
        return sentence_transformer_embed_fn()
    if spec.startswith("sentence-transformers:"):
        return sentence_transformer_embed_fn(
            spec.split(":", 1)[1]
        )
    raise ValueError(
        f"Unknown semantic-cache embedder {spec!r} (available: "
        f"hashed-ngram, sentence-transformers[:model-name])"
    )


class SemanticCache:
    def __init__(
        self,
        similarity_threshold: float = 0.95,
        max_entries: int = 10000,
        persist_path: Optional[str] = None,
        embed_fn: Callable[[str], np.ndarray] = hashed_ngram_embed,
    ):
        self.similarity_threshold = similarity_threshold
        self.max_entries = max_entries
        self.persist_path = persist_path
        self.embed_fn = embed_fn
        self._vectors: Optional[np.ndarray] = None   # [N, dim]
        self._entries: List[Dict] = []
        self._lock = threading.Lock()
        self._dirty = False
        self._persist_thread: Optional[threading.Thread] = None
        self.persist_interval = 5.0
        if persist_path and os.path.exists(persist_path):
            self._load()

    # ------------------------------------------------------------- internals
    @staticmethod
    def _request_text(body: dict) -> Optional[str]:
        messages = body.get("messages")
        if not messages:
            return None
        return "\n".join(
            f"{m.get('role', '')}: {m.get('content', '')}" for m in messages
        )

    def _search(self, vec: np.ndarray, model: str) -> Optional[Dict]:
        with self._lock:
            if self._vectors is None or not len(self._entries):
                return None
            sims = self._vectors @ vec
            idx = int(np.argmax(sims))
            if sims[idx] < self.similarity_threshold:
                return None
            entry = self._entries[idx]
            if entry["model"] != model:
                return None
            return entry

    def _add(self, vec: np.ndarray, entry: Dict) -> None:
        with self._lock:
            self._entries.append(entry)
            if self._vectors is None:
                self._vectors = vec[None, :]
            else:
                self._vectors = np.vstack([self._vectors, vec])
            if len(self._entries) > self.max_entries:
                self._entries.pop(0)
                self._vectors = self._vectors[1:]
            cache_size.set(len(self._entries))
        if self.persist_path:
            self._schedule_persist()

    def _schedule_persist(self) -> None:
        """Debounced background persistence: pickling the whole cache per
        store on the event loop would stall request handling."""
        with self._lock:
            self._dirty = True
            if self._persist_thread is not None and \
                    self._persist_thread.is_alive():
                return
            self._persist_thread = threading.Thread(
                target=self._persist_worker, daemon=True,
                name="semantic-cache-persist",
            )
            self._persist_thread.start()

    def _persist_worker(self) -> None:
        while True:
            with self._lock:
                if not self._dirty:
                    return
                self._dirty = False
            try:
                self._persist()
            except Exception:  # noqa: BLE001 — persistence is best-effort
                logger.exception("Semantic cache persist failed")
            time.sleep(self.persist_interval)

    def _persist(self) -> None:
        with self._lock:
            blob = pickle.dumps(
                {"vectors": self._vectors, "entries": self._entries}
            )
        tmp = f"{self.persist_path}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self.persist_path)

    def _load(self) -> None:
        try:
            with open(self.persist_path, "rb") as f:
                data = pickle.load(f)
            self._vectors = data["vectors"]
            self._entries = data["entries"]
            cache_size.set(len(self._entries))
            logger.info("Semantic cache: loaded %d entries", len(self._entries))
        except Exception:  # noqa: BLE001 — corrupted cache is droppable
            logger.exception("Semantic cache load failed; starting empty")

    # -------------------------------------------------------------- interface
    async def check(self, request: web.Request) -> Optional[web.Response]:
        """Pre-routing hook: return a cached response on similarity hit."""
        try:
            raw = request.get("pii_redacted_body") or await request.read()
            body = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return None
        if body.get("stream"):
            return None  # only non-streaming responses are cacheable
        text = self._request_text(body)
        if text is None:
            return None
        entry = self._search(self.embed_fn(text), body.get("model", ""))
        if entry is None:
            misses_total.inc()
            return None
        hits_total.inc()
        latency_saved.inc(entry.get("gen_time", 0.0))
        resp = dict(entry["response"])
        resp["cached"] = True
        return web.json_response(resp)

    def store_response(self, body: dict, response_bytes: bytes) -> None:
        """Post-completion hook fed by the proxy."""
        if body.get("stream"):
            return
        text = self._request_text(body)
        if text is None:
            return
        try:
            response = json.loads(response_bytes)
        except (json.JSONDecodeError, UnicodeDecodeError):
            return
        self._add(self.embed_fn(text), {
            "model": body.get("model", ""),
            "response": response,
            "stored_at": time.time(),
            "gen_time": 0.0,
        })
