"""Prefix-chain-aware LRU store: the shared KV tier's eviction core, a copy
of ``production_stack_tpu/kv_offload/chain_lru.py``.

A flat blob-LRU can evict a chain PARENT while its children stay resident,
and the children are then unrestorable (the engine restores consecutive
blocks from the chain root). So:

  * every entry may carry a ``parent`` link (the store key of the previous
    block in its hash chain; chain roots have none);
  * eviction is LRU over chains, leaf-first: an entry is evictable only
    while no live child references it, so a parent outlives its
    descendants;
  * touching an entry (get / multi-get hit) refreshes its whole ancestor
    chain, so a leaf read keeps the shared prefix above it warm.

Thread-safe (one lock); used by the engine-local HostKVPool and the cache
server (kv_offload/server.py).
"""

import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Set

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class ChainStore:
    def __init__(self, max_bytes: int):
        self.max_bytes = max_bytes
        self._data: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._bytes = 0
        self._parent: Dict[bytes, bytes] = {}
        # parent key -> keys that DECLARED it as parent (children may be
        # linked before the parent itself arrives; evictability only looks
        # at children currently resident).
        self._kids: Dict[bytes, Set[bytes]] = {}
        # The eviction frontier, maintained incrementally: resident entries
        # with NO resident children, in ~LRU order. Eviction pops its head
        # in O(1) instead of scanning _data past every child-protected
        # ancestor (under chain traffic the oldest entries are exactly the
        # protected roots, so a scan would re-walk them on every pass).
        self._leaves: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.stores = 0
        self.evictions = 0
        # Leaf evictions that shortened a live chain (the evicted entry had
        # a resident parent) — the "tails aging out" signal.
        self.chain_evictions = 0
        # Defensive fallback count: evictions forced past the leaf frontier
        # (possible only via corrupt/cyclic chain links).
        self.parent_protected_skips = 0
        self.deletes = 0

    # ------------------------------------------------------------ internals
    def _has_live_child(self, key: bytes) -> bool:
        kids = self._kids.get(key)
        if not kids:
            return False
        return any(c in self._data for c in kids)

    def _unlink(self, key: bytes) -> None:
        parent = self._parent.pop(key, None)
        if parent is not None:
            kids = self._kids.get(parent)
            if kids is not None:
                kids.discard(key)
                if not kids:
                    self._kids.pop(parent, None)
            # The departed child may have been the parent's last resident
            # one: the parent joins the leaf frontier at the OLD end (it is
            # older than the child that just left — parents precede their
            # children in recency).
            if parent in self._data and not self._has_live_child(parent) \
                    and parent not in self._leaves:
                self._leaves[parent] = None
                self._leaves.move_to_end(parent, last=False)

    def _touch_chain(self, key: bytes) -> None:
        """Refresh ``key`` and every resident ancestor, root-first, so the
        leaf ends up most-recently-used and the whole chain outranks
        entries untouched since."""
        chain: List[bytes] = []
        k: Optional[bytes] = key
        seen: Set[bytes] = set()
        while k is not None and k in self._data and k not in seen:
            chain.append(k)
            seen.add(k)
            k = self._parent.get(k)
        for k in reversed(chain):
            self._data.move_to_end(k)
            if k in self._leaves:
                self._leaves.move_to_end(k)

    def _evict_to_fit(self) -> None:
        while self._bytes > self.max_bytes and self._data:
            if self._leaves:
                victim = next(iter(self._leaves))  # oldest leaf, O(1)
            else:
                # Defensive: a parent-link cycle (corrupt chain metadata)
                # would leave no leaf; evict the raw-LRU head so the store
                # never deadlocks over bad links.
                victim = next(iter(self._data))
                self.parent_protected_skips += 1
                logger.warning(
                    "ChainStore found no childless entry; evicting LRU head"
                )
            blob = self._data.pop(victim)
            self._bytes -= len(blob)
            self._leaves.pop(victim, None)
            if self._parent.get(victim) in self._data:
                self.chain_evictions += 1
            self._unlink(victim)
            self.evictions += 1

    # ------------------------------------------------------------------ API
    def put(self, key: bytes, blob: bytes,
            parent: Optional[bytes] = None) -> None:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._bytes -= len(old)
                self._unlink(key)
            self._data[key] = blob
            self._bytes += len(blob)
            if parent and parent != key:
                self._parent[key] = parent
                self._kids.setdefault(parent, set()).add(key)
                # The parent (if resident) now has a live child: off the
                # eviction frontier.
                self._leaves.pop(parent, None)
            # The new entry joins the frontier unless it already has
            # resident children (an interior block re-admitted after an
            # explicit delete, or a parent arriving after its orphans).
            if self._has_live_child(key):
                self._leaves.pop(key, None)
            else:
                self._leaves[key] = None
                self._leaves.move_to_end(key)
            self.stores += 1
            self._evict_to_fit()

    def get(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            blob = self._data.get(key)
            if blob is None:
                self.misses += 1
                return None
            self._touch_chain(key)
            self.hits += 1
            return blob

    def multi_get(self, keys: Iterable[bytes]) -> List[Optional[bytes]]:
        """Batched get (the 'M' wire op's storage half): one lock
        acquisition, chain-touch per hit."""
        out: List[Optional[bytes]] = []
        with self._lock:
            for key in keys:
                blob = self._data.get(key)
                if blob is None:
                    self.misses += 1
                else:
                    self._touch_chain(key)
                    self.hits += 1
                out.append(blob)
        return out

    def contains(self, key: bytes) -> bool:
        with self._lock:
            return key in self._data

    def residency(self, keys: Iterable[bytes]) -> List[bool]:
        """Residency bitmap (the 'I' wire op's storage half). Read-only:
        probing residency must not refresh recency, or routing probes
        would keep everything artificially warm."""
        with self._lock:
            return [k in self._data for k in keys]

    def delete(self, key: bytes) -> bool:
        with self._lock:
            blob = self._data.pop(key, None)
            if blob is None:
                return False
            self._bytes -= len(blob)
            self._leaves.pop(key, None)
            self._unlink(key)
            self.deletes += 1
            return True

    def parent_of(self, key: bytes) -> Optional[bytes]:
        with self._lock:
            return self._parent.get(key)

    def hot_chains(self, top_k: int,
                   max_blocks: int = 4096) -> List[List[bytes]]:
        """The ``top_k`` hottest prefix chains, each as store keys ordered
        root -> leaf (the 'H' wire op's storage half; docs/ELASTIC.md
        prewarm protocol).

        "Hot" is recency: the LRU order is walked newest-first and each
        unvisited entry's resident ancestor chain is emitted whole — a leaf
        touch refreshes its ancestors root-first (_touch_chain), so the MRU
        end of ``_data`` is exactly the leaf frontier of the most recently
        served chains. Entries already covered by an earlier (hotter)
        chain are skipped, so overlapping sessions that share a system
        prompt yield one chain per distinct leaf, not duplicates.
        Read-only: enumerating hot chains must not refresh recency (same
        rule as residency())."""
        out: List[List[bytes]] = []
        seen: Set[bytes] = set()
        budget = max_blocks
        with self._lock:
            for key in reversed(self._data):
                if len(out) >= top_k or budget <= 0:
                    break
                if key in seen:
                    continue
                chain: List[bytes] = []
                k: Optional[bytes] = key
                walk: Set[bytes] = set()
                while k is not None and k in self._data and k not in walk:
                    chain.append(k)
                    walk.add(k)
                    k = self._parent.get(k)
                chain.reverse()          # root first
                seen.update(chain)
                chain = chain[:budget]
                budget -= len(chain)
                if chain:
                    out.append(chain)
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._data),
                "bytes": self._bytes,
                "max_bytes": self.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "stores": self.stores,
                "evictions": self.evictions,
                "chain_evictions": self.chain_evictions,
                "parent_protected_skips": self.parent_protected_skips,
                "deletes": self.deletes,
            }
