"""Paged KV cache block manager with hash-based prefix caching.

Mirror of ``production_stack_tpu/engine/kv_cache.py`` (host-side
bookkeeping for the runner's device pools ``[L, Hkv, num_slots, Dh]``),
with the offload tier's hooks: spill pins, chain parents, the
``/prefix_index`` digest and blocks adopted under a known hash (prewarm).

  * Block 0 is the reserved null block (padding writes land there).
  * Full blocks are content-addressed: hash chain H(prev, tokens) -> block.
  * Freed blocks that carry a hash go into an evictable LRU; they are
    resurrected on a prefix hit or reclaimed (LRU) when the free list runs
    dry.
  * Shared blocks are always FULL; writes only target a sequence's private
    tail block, so no copy-on-write is needed.

``_block_hash`` is the JAX package's, so store keys and ``/prefix_index``
entries agree across the two packages.
"""

import hashlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch  # noqa: F401 — every module of the port is a torch module


def _block_hash(prev: bytes, tokens: Sequence[int]) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(prev)
    h.update(b"|")
    h.update(",".join(map(str, tokens)).encode())
    return h.digest()


class BlockPoolManager:
    def __init__(self, num_blocks: int, block_size: int,
                 enable_prefix_caching: bool = True):
        assert num_blocks >= 2, "need at least null block + one usable block"
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.enable_prefix_caching = enable_prefix_caching
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._hash_to_block: Dict[bytes, int] = {}
        self._block_to_hash: Dict[int, bytes] = {}
        # content hash -> the prev_hash it was registered under (the seed
        # for chain roots): the spill thread carries chain links into the
        # shared tier.
        self._hash_parent: Dict[bytes, bytes] = {}
        # evictable: blocks with ref 0 still holding cached content (LRU order)
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        # blocks queued for offload spill: not reclaimed until the
        # device-to-host read is done (kv_offload/manager.py)
        self._spill_pinned: set = set()
        self.prefix_queries_total = 0
        self.prefix_hits_total = 0

    @property
    def num_free_blocks(self) -> int:
        # Spill-pinned evictable blocks cannot be reclaimed, so they do not
        # count as free.
        pinned_evictable = sum(
            1 for b in self._spill_pinned if b in self._evictable)
        return len(self._free) + len(self._evictable) - pinned_evictable

    @property
    def num_used_blocks(self) -> int:
        return (self.num_blocks - 1) - self.num_free_blocks

    def usage(self) -> float:
        usable = self.num_blocks - 1
        return self.num_used_blocks / usable if usable else 0.0

    def _pop_free_block(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        for blk in self._evictable:
            if blk in self._spill_pinned:
                continue
            del self._evictable[blk]
            h = self._block_to_hash.pop(blk, None)
            if h is not None:
                self._hash_to_block.pop(h, None)
                self._hash_parent.pop(h, None)
            return blk
        return None

    # ---------------------------------------------------------- offload hooks
    def pin_for_spill(self, blk: int) -> None:
        self._spill_pinned.add(blk)

    def unpin_for_spill(self, blk: int) -> None:
        self._spill_pinned.discard(blk)

    def hash_of_block(self, blk: int) -> Optional[bytes]:
        return self._block_to_hash.get(blk)

    def contains_hash(self, h: bytes) -> bool:
        """Is this content hash resident in the device prefix index?"""
        return h in self._hash_to_block

    def parent_hash(self, h: bytes) -> Optional[bytes]:
        """Parent hash in ``h``'s chain (the seed for chain roots); None if
        ``h`` is no longer registered."""
        return self._hash_parent.get(h)

    @property
    def prefix_index_size(self) -> int:
        """Content-addressed blocks resident on the device (the
        pstpu:prefix_index_size gauge)."""
        return len(self._hash_to_block)

    def prefix_digest(self, max_entries: int = 8192) -> Tuple[List[str], bool]:
        """(entries, truncated): the first 16 hex chars of every
        content-addressed block hash, the ``/prefix_index`` answer the
        router's prefix-aware routing scores prompts against."""
        entries = []
        for h in self._hash_to_block:
            entries.append(h.hex()[:16])
            if len(entries) >= max_entries:
                return entries, True
        return entries, False

    def can_allocate(self, n: int) -> bool:
        return self.num_free_blocks >= n

    def allocate_blocks(self, n: int) -> Optional[List[int]]:
        if not self.can_allocate(n):
            return None
        out = []
        for _ in range(n):
            blk = self._pop_free_block()
            if blk is None:
                # Accounting and reclaimability disagree (a spill pin
                # landed mid-allocation): roll back, never crash the loop.
                self.free_blocks(out)
                return None
            self._ref[blk] = 1
            out.append(blk)
        return out

    def lookup_prefix(self, token_ids: Sequence[int],
                      seed: bytes = b"") -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``token_ids`` as
        (cached_block_ids, num_cached_tokens); at least one prompt token is
        always left uncached so prefill has a position to sample from.
        ``seed`` namespaces the hash chain (the reference's LoRA
        adapters; b"" for the base model)."""
        if not self.enable_prefix_caching:
            return [], 0
        usable_full_blocks = (len(token_ids) - 1) // self.block_size
        blocks: List[int] = []
        prev = seed
        for i in range(usable_full_blocks):
            chunk = token_ids[i * self.block_size:(i + 1) * self.block_size]
            h = _block_hash(prev, chunk)
            blk = self._hash_to_block.get(h)
            if blk is None:
                break
            blocks.append(blk)
            prev = h
        return blocks, len(blocks) * self.block_size

    def allocate_prompt(
        self, token_ids: Sequence[int], seed: bytes = b""
    ) -> Optional[Tuple[List[int], int]]:
        """Block table for a new prompt, reusing cached prefixes:
        (block_ids, num_cached_tokens), or None if out of blocks."""
        if self.num_free_blocks == 0:
            return None
        cached, n_cached = self.lookup_prefix(token_ids, seed)
        total_blocks = -(-len(token_ids) // self.block_size)
        n_new = total_blocks - len(cached)
        # Pin the cached blocks FIRST: reviving an evictable block shrinks
        # the free count, and allocate_blocks could otherwise evict it.
        for blk in cached:
            self._take_ref(blk)
        fresh = self.allocate_blocks(n_new)
        if fresh is None:
            self.free_blocks(cached)
            return None
        self.prefix_queries_total += len(token_ids)
        self.prefix_hits_total += n_cached
        return cached + fresh, n_cached

    def append_block(self) -> Optional[int]:
        blocks = self.allocate_blocks(1)
        return blocks[0] if blocks else None

    def _take_ref(self, blk: int) -> None:
        if blk in self._evictable:
            del self._evictable[blk]
            self._ref[blk] = 1
        else:
            self._ref[blk] = self._ref.get(blk, 0) + 1

    def register_full_block(
        self, blk: int, prev_hash: bytes, tokens: Sequence[int]
    ) -> bytes:
        """Content-address a block that just became full."""
        if not self.enable_prefix_caching:
            return b""
        h = _block_hash(prev_hash, tokens)
        existing = self._hash_to_block.get(h)
        if existing is not None and existing != blk:
            return h  # duplicate content raced in; keep the earlier block
        self._hash_to_block[h] = blk
        self._block_to_hash[blk] = h
        self._hash_parent[h] = prev_hash
        return h

    def adopt_full_block(self, blk: int, h: bytes,
                         parent_hash: bytes) -> bool:
        """Content-address a block whose hash is already known (a prewarm
        restore arrives keyed by store hash, with no tokens to re-derive it
        from). The caller owns ``blk`` and has written its KV; freeing it
        afterwards parks it evictable, where prompts hit it like a locally
        computed prefix block. False (nothing registered) when the hash is
        already resident."""
        if not self.enable_prefix_caching or not h:
            return False
        if h in self._hash_to_block:
            return False
        self._hash_to_block[h] = blk
        self._block_to_hash[blk] = h
        self._hash_parent[h] = parent_hash
        return True

    def free_blocks(self, blocks: Sequence[int]) -> None:
        for blk in blocks:
            ref = self._ref.get(blk, 0) - 1
            if ref > 0:
                self._ref[blk] = ref
                continue
            self._ref.pop(blk, None)
            if blk in self._block_to_hash:
                self._evictable[blk] = None
                self._evictable.move_to_end(blk)
            else:
                self._free.append(blk)

    def reset_prefix_cache(self) -> None:
        """Drop every evictable cached block from the prefix index (blocks
        in use keep theirs)."""
        for blk in list(self._evictable):
            self._free.append(blk)
            h = self._block_to_hash.pop(blk, None)
            if h is not None:
                self._hash_to_block.pop(h, None)
                self._hash_parent.pop(h, None)
        self._evictable.clear()
