"""Paged KV cache block manager with hash-based prefix caching.

Mirror of ``production_stack_tpu/engine/kv_cache.py`` (host-side
bookkeeping for the runner's device pools ``[L, Hkv, num_slots, Dh]``),
without the offload hooks (spill pins, digests, adopted blocks), which come
with the offload port (ROADMAP).

  * Block 0 is the reserved null block (padding writes land there).
  * Full blocks are content-addressed: hash chain H(prev, tokens) -> block.
  * Freed blocks that carry a hash go into an evictable LRU; they are
    resurrected on a prefix hit or reclaimed (LRU) when the free list runs
    dry.
  * Shared blocks are always FULL; writes only target a sequence's private
    tail block, so no copy-on-write is needed.
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
        # evictable: blocks with ref 0 still holding cached content (LRU order)
        self._evictable: "OrderedDict[int, None]" = OrderedDict()
        self.prefix_queries_total = 0
        self.prefix_hits_total = 0

    @property
    def num_free_blocks(self) -> int:
        return len(self._free) + len(self._evictable)

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
            del self._evictable[blk]
            h = self._block_to_hash.pop(blk, None)
            if h is not None:
                self._hash_to_block.pop(h, None)
            return blk
        return None

    def can_allocate(self, n: int) -> bool:
        return self.num_free_blocks >= n

    def allocate_blocks(self, n: int) -> Optional[List[int]]:
        if not self.can_allocate(n):
            return None
        out = []
        for _ in range(n):
            blk = self._pop_free_block()
            self._ref[blk] = 1
            out.append(blk)
        return out

    def lookup_prefix(self, token_ids: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``token_ids`` as
        (cached_block_ids, num_cached_tokens); at least one prompt token is
        always left uncached so prefill has a position to sample from."""
        if not self.enable_prefix_caching:
            return [], 0
        usable_full_blocks = (len(token_ids) - 1) // self.block_size
        blocks: List[int] = []
        prev = b""
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
        self, token_ids: Sequence[int]
    ) -> Optional[Tuple[List[int], int]]:
        """Block table for a new prompt, reusing cached prefixes:
        (block_ids, num_cached_tokens), or None if out of blocks."""
        if self.num_free_blocks == 0:
            return None
        cached, n_cached = self.lookup_prefix(token_ids)
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
        return h

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
