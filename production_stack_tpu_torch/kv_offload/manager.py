"""Engine side of the KV offload tiers, the port of
``production_stack_tpu/kv_offload/manager.py``.

Write path (spill): a device block that becomes full and content-addressed
is queued and pinned in the block manager (eviction cannot recycle it);
the spill thread reads queued blocks in batches (``runner.read_blocks``,
on the dispatch stream, so after the dispatch that wrote them), re-checks
each block's hash, packs it (PKC1 around PKV1/PKV2) and writes it through
to the host pool and the remote server.

Read path (restore): at prompt admission, after the device prefix cache,
the scheduler asks for the next consecutive full blocks by hash: host
residency in-process, remote residency in one 'I', the cost model admits
the run, the remote blobs come in one 'M', and the blocks are scattered
into the freshly allocated device blocks (``runner.write_blocks``) before
the prefill that reads them is issued.

Prewarm pulls the shared tier's hottest chains ('H', 'I', 'M') into the
device prefix cache (``POST /prewarm``).

Best effort, as in the reference: a store that is down makes a restore
return 0 and a spill drop its blocks; the port counts both
(``restore_failures_total``, ``spill_failures_total``). A block write that
fails (at tp > 1, a lost rank) counts a restore failure and raises: the
engine fails, it does not recompute quietly.

Threads and locks. Three threads move blocks through the runner: the spill
thread (``_spill_batch``: ``read_blocks_retry``), the engine's threads
(``try_restore`` from the scheduler on the event loop, ``prewarm_hot_chains``
on the runner thread: ``write_blocks``) and the default executor (the
handoff publish: ``read_blocks_retry``). At tp > 1 each call is one block
I/O descriptor under the tp group's lock. Every thread takes the locks in
one order: the tp group's ``lock`` (tp > 1), then the runner's
``kv_io_lock``; this module's ``_lock`` guards only the spill queue and is
never held across block I/O, so no thread holds ``kv_io_lock`` (or
``_lock``) while it waits for the tp lock.
"""

import struct
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.engine.kv_cache import (
    BlockPoolManager,
    _block_hash,
)
from production_stack_tpu_torch.kv_offload.host_pool import HostKVPool
from production_stack_tpu_torch.kv_offload.serde import (
    get_serde,
    pack_chain,
    unpack_chain,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


def restore_beats_recompute(
    num_tokens: int,
    bytes_per_token: int,
    link_gbps: float,
    prefill_tok_s: float,
    transfer_tokens: Optional[int] = None,
) -> bool:
    """Restore-over-recompute admission (docs/KV_ECONOMY.md): restore a
    tier-resident prefix iff its estimated byte-transfer time beats the
    estimated prefill time. ``transfer_tokens`` is the subset that must
    actually cross the network link (remote-resident blocks); host-pool
    blocks are in-process RAM copies and cost ~nothing, so a fully local
    run always restores. Coarse by design — the decision only has to be
    right in the regimes that matter (a 1000-token shared system prompt is
    ~always worth restoring; recompute wins only when the link is slow
    relative to prefill throughput times per-token KV bytes). Non-positive
    knobs disable the model (always restore), preserving the pre-model
    behavior."""
    if num_tokens <= 0:
        return False
    t = num_tokens if transfer_tokens is None else transfer_tokens
    if t <= 0:
        return True
    if link_gbps <= 0 or prefill_tok_s <= 0 or bytes_per_token <= 0:
        return True
    transfer_s = t * bytes_per_token / (link_gbps * 1e9)
    recompute_s = num_tokens / prefill_tok_s
    return transfer_s < recompute_s


class KVOffloadManager:
    def __init__(
        self,
        runner,
        block_manager: BlockPoolManager,
        host_pool_bytes: int = 0,
        remote_url: Optional[str] = None,
        serde: str = "naive",
        flush_interval: float = 0.1,
        spill_batch: int = 8,
        bytes_per_token: int = 0,
        link_gbps: float = 2.0,
        prefill_tok_s: float = 4000.0,
    ):
        self.runner = runner
        self.block_manager = block_manager
        self.host_pool = HostKVPool(host_pool_bytes) if host_pool_bytes else None
        self.remote = None
        if remote_url:
            from production_stack_tpu_torch.kv_offload.remote import (
                RemoteKVClient,
            )

            self.remote = RemoteKVClient(remote_url)
        self.pack, self.unpack = get_serde(serde)
        # Store keys are namespaced by the KV-cache storage dtype: int8 and
        # bf16 engines sharing one offload tier must never splice each
        # other's blocks (the dequantized values differ from what the
        # other engine computed — a silent greedy-determinism break).
        # bfloat16 keeps the bare hash so pre-quantization stores stay
        # readable.
        self._kv_quantized = bool(getattr(runner, "kv_quantized", False))
        self._key_prefix = b"q8|" if self._kv_quantized else b""
        self.flush_interval = flush_interval
        self.spill_batch = spill_batch
        # Restore-over-recompute cost model inputs (EngineConfig knobs).
        self.bytes_per_token = bytes_per_token
        self.link_gbps = link_gbps
        self.prefill_tok_s = prefill_tok_s

        self._queue: List[Tuple[bytes, int]] = []
        self._queued_hashes = set()
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(
            target=self._spill_worker, daemon=True, name="kv-spiller"
        )
        self._thread.start()
        # telemetry
        self.restored_tokens_total = 0
        self.spilled_blocks_total = 0
        # KV-economy counters (docs/KV_ECONOMY.md): blocks served from /
        # missing in the shared tiers during restores, tokens restored
        # under cost-model admission, and tokens the model declined.
        self.shared_tier_hits_total = 0
        self.shared_tier_misses_total = 0
        self.restore_saved_tokens_total = 0
        self.restore_declined_tokens_total = 0
        # Best-effort failures: blocks a spill dropped (read, pack or
        # remote put failed) and store round trips a restore lost.
        self.spill_failures_total = 0
        self.restore_failures_total = 0

    @property
    def enabled(self) -> bool:
        return self.host_pool is not None or self.remote is not None

    # -------------------------------------------------------------- write path
    def _store_key(self, h: bytes) -> bytes:
        return self._key_prefix + h

    def on_block_registered(self, h: bytes, blk: int) -> None:
        """Engine-loop hook: a block just became full + content-addressed."""
        if not self.enabled or not h:
            return
        if self.host_pool is not None and \
                self.host_pool.contains(self._store_key(h)):
            return
        with self._lock:
            if h in self._queued_hashes:
                return
            # Pin BEFORE the entry becomes poppable: the spill worker drains
            # the queue under this same lock, so pinning outside it would let
            # the worker spill + unpin before the pin lands, leaving the block
            # pinned forever and excluded from eviction.
            self.block_manager.pin_for_spill(blk)
            self._queued_hashes.add(h)
            self._queue.append((h, blk))

    def _spill_worker(self) -> None:
        while self._running:
            time.sleep(self.flush_interval)
            with self._lock:
                batch = self._queue[: self.spill_batch]
                self._queue = self._queue[self.spill_batch:]
            if not batch:
                continue
            try:
                self._spill_batch(batch)
            except Exception:  # noqa: BLE001 — offload is best-effort
                logger.exception("KV spill batch failed")
                self.spill_failures_total += len(batch)
            finally:
                for h, blk in batch:
                    self.block_manager.unpin_for_spill(blk)
                    with self._lock:
                        self._queued_hashes.discard(h)

    def _spill_batch(self, batch: List[Tuple[bytes, int]]) -> None:
        # Drop entries whose block was recycled since registration.
        live = [
            (h, blk) for h, blk in batch
            if self.block_manager.hash_of_block(blk) == h
        ]
        if not live:
            return
        blks = [blk for _, blk in live]
        k_np, v_np, ks_np, vs_np = self.runner.read_blocks_retry(blks)
        for i, (h, blk) in enumerate(live):
            if self.block_manager.hash_of_block(blk) != h:
                continue  # recycled during the read; data is unreliable
            # Chain link (docs/KV_ECONOMY.md): the stored blob carries its
            # parent block's STORE KEY so the shared tier evicts leaf-first
            # over chains. Chain roots (parent = the hash seed, not a
            # registered block hash) carry an empty parent.
            parent = self.block_manager.parent_hash(h)
            # Real parent hashes are exactly the blake2b digest size; hash
            # seeds (chain roots, LoRA namespaces) are anything else.
            parent_key = (
                self._store_key(parent)
                if parent is not None and len(parent) == 16 else b""
            )
            blob = pack_chain(parent_key, self.pack(
                k_np[i], v_np[i],
                None if ks_np is None else ks_np[i],
                None if vs_np is None else vs_np[i],
            ))
            key = self._store_key(h)
            if self.host_pool is not None:
                self.host_pool.put(key, blob, parent=parent_key or None)
            if self.remote is not None:
                try:
                    self.remote.put(key, blob)
                except ConnectionError as e:
                    logger.warning("Remote KV put failed: %s", e)
                    self.spill_failures_total += 1
            self.spilled_blocks_total += 1

    # --------------------------------------------------------------- read path
    def try_restore(
        self,
        token_ids: Sequence[int],
        block_ids: Sequence[int],
        num_computed_tokens: int,
        seed: bytes = b"",
    ) -> int:
        """Restore consecutive full blocks after the device-cached prefix.

        Returns the number of tokens restored (multiple of block_size).
        Called on the engine loop between device steps, so the scatter into
        the pools is ordered with model steps. ``seed`` namespaces the hash
        chain exactly like the device prefix cache (Sequence.hash_seed): KV
        computed under different LoRA adapters must never be spliced across
        adapters from the host/remote tiers either.

        Pipelined (docs/KV_ECONOMY.md): all candidate hashes are computed
        up front, remote residency is resolved with ONE 'I' index query,
        the restore-over-recompute cost model admits (or declines) the
        contiguous resident run, and the remote blocks arrive in ONE 'M'
        multi-get — at most 2 remote round trips per restore instead of
        one per block.
        """
        if not self.enabled:
            return 0
        bs = self.block_manager.block_size
        if num_computed_tokens % bs != 0:
            return 0  # device cache ended mid-block: nothing contiguous to add
        # Hash chain up to the restore boundary (adapter-namespaced).
        prev = seed
        for i in range(num_computed_tokens // bs):
            prev = _block_hash(
                prev, token_ids[i * bs:(i + 1) * bs]
            )
        # At least one token must remain for prefill to compute logits from.
        max_full = (len(token_ids) - 1) // bs
        start_blk = num_computed_tokens // bs
        if start_blk >= max_full:
            return 0
        hashes: List[bytes] = []
        for i in range(start_blk, max_full):
            prev = _block_hash(prev, token_ids[i * bs:(i + 1) * bs])
            hashes.append(prev)
        keys = [self._store_key(h) for h in hashes]
        # Residency: the local tier answers in-process; the remote tier in
        # one index-query round trip (covering only what the host missed).
        host_res = [
            self.host_pool is not None and self.host_pool.contains(k)
            for k in keys
        ]
        remote_res = [False] * len(keys)
        if self.remote is not None and not all(host_res):
            try:
                remote_res = self.remote.index_query(keys)
            except ConnectionError as e:
                logger.warning("Remote KV index query failed: %s", e)
                self.restore_failures_total += 1
        run = 0
        while run < len(keys) and (host_res[run] or remote_res[run]):
            run += 1
        self.shared_tier_misses_total += len(keys) - run
        if run == 0:
            return 0
        # Restore-over-recompute admission: only the remote blocks cross
        # the link; host-pool blocks are free RAM copies.
        remote_blocks = sum(1 for i in range(run) if not host_res[i])
        if not restore_beats_recompute(
            run * bs, self.bytes_per_token,
            self.link_gbps, self.prefill_tok_s,
            transfer_tokens=remote_blocks * bs,
        ):
            self.restore_declined_tokens_total += run * bs
            return 0
        # Fetch: local hits from the host pool, everything else in ONE
        # pipelined multi-get.
        blobs: List[Optional[bytes]] = [None] * run
        for i in range(run):
            if host_res[i]:
                blobs[i] = self.host_pool.get(keys[i])
        remote_idx = [i for i in range(run) if blobs[i] is None]
        if remote_idx and self.remote is not None:
            try:
                fetched = self.remote.multi_get(
                    [keys[i] for i in remote_idx]
                )
            except ConnectionError as e:
                logger.warning("Remote KV multi-get failed: %s", e)
                self.restore_failures_total += 1
                fetched = [None] * len(remote_idx)
            for i, blob in zip(remote_idx, fetched):
                blobs[i] = blob
        hits: List[Tuple[int, tuple]] = []
        for i in range(run):
            blob = blobs[i]
            if blob is None:
                break  # residency raced an eviction; keep the prefix we got
            try:
                parent_key, inner = unpack_chain(blob)
                k, v, ks, vs = self.unpack(inner)
            except (ValueError, struct.error):
                # An undecodable blob ends the run like a miss (the
                # reference lets the error reach the scheduler).
                logger.warning("KV blob %s undecodable; restore stops there",
                               keys[i].hex()[:16])
                self.restore_failures_total += 1
                break
            if (ks is not None) != self._kv_quantized:
                # Wire/pool dtype mismatch (store written under another
                # kv_cache_dtype, possible despite key namespacing via a
                # hand-migrated store): treat as a miss, never splice.
                break
            hits.append((block_ids[start_blk + i], (k, v, ks, vs)))
            if self.host_pool is not None and not host_res[i]:
                # Promote remote blocks to the local tier, chain intact.
                self.host_pool.put(
                    keys[i], blob,
                    parent=parent_key or (keys[i - 1] if i > 0 else None),
                )
        if not hits:
            return 0
        blks = [b for b, _ in hits]
        k_np = np.stack([d[0] for _, d in hits])
        v_np = np.stack([d[1] for _, d in hits])
        try:
            if self._kv_quantized:
                self.runner.write_blocks(
                    blks, k_np, v_np,
                    np.stack([d[2] for _, d in hits]),
                    np.stack([d[3] for _, d in hits]),
                )
            else:
                self.runner.write_blocks(blks, k_np, v_np)
        except Exception:
            self.restore_failures_total += 1
            raise
        restored = len(hits) * bs
        self.restored_tokens_total += restored
        self.restore_saved_tokens_total += restored
        self.shared_tier_hits_total += len(hits)
        # Offload hits count toward the prefix-cache telemetry the router's
        # cache-aware logic consumes (LMCache hits do the same upstream).
        self.block_manager.prefix_hits_total += restored
        logger.debug("Restored %d tokens from KV offload", restored)
        return restored

    # -------------------------------------------------------------- prewarm
    def prewarm_hot_chains(self, top_k: int = 8,
                           max_blocks: int = 256) -> dict:
        """Pull the shared tier's hottest prefix chains into the DEVICE
        prefix cache before this engine takes load (docs/ELASTIC.md;
        POST /prewarm). Discovery is one 'H' round trip (the chain-aware
        LRU already knows its leaf frontier), residency one 'I', payloads
        one 'M' — the existing batched restore pipeline. Restored blocks
        are adopted into the prefix index and parked evictable, so the
        first real prompts sharing those prefixes hit device KV instead
        of recomputing — the same bytes, never different tokens.

        Runs on the engine loop's executor BETWEEN device steps (the
        caller orders it like _apply_restores). Returns telemetry; every
        failure degrades to fewer prewarmed blocks, never an exception."""
        out = {"chains": 0, "blocks": 0, "skipped_blocks": 0,
               "already_resident": 0}
        if self.remote is None:
            out["reason"] = "no shared tier configured"
            return out
        try:
            chains = self.remote.hot_chains(top_k, max_blocks=max_blocks)
        except ConnectionError as e:
            logger.warning("Prewarm hot-chains query failed: %s", e)
            out["reason"] = f"hot-chains query failed: {e}"
            return out
        pfx = self._key_prefix
        usable = []
        for chain in chains:
            # Only OUR dtype namespace: a bf16 pool must never splice q8|
            # blocks (and vice versa) — same rule as the restore path.
            if pfx:
                keys = [k for k in chain if k.startswith(pfx)]
                keys = keys if len(keys) == len(chain) else []
            else:
                keys = [] if any(
                    k.startswith(b"q8|") for k in chain
                ) else list(chain)
            if keys:
                usable.append(keys)
        budget = min(
            max_blocks,
            # Never let a prewarm crowd out serving: cap at half the pool.
            max(0, (self.block_manager.num_blocks - 1) // 2),
        )
        # Distinct keys only: overlapping chains share their ancestor
        # prefixes (e.g. every session's chain starts at the system
        # prompt), and the shared blocks must be fetched/written once.
        flat: List[bytes] = []
        seen_keys = set()
        for keys in usable:
            for k in keys:
                if k not in seen_keys and len(flat) < budget:
                    seen_keys.add(k)
                    flat.append(k)
        if not flat:
            out["reason"] = "no usable chains"
            return out
        try:
            resident = self.remote.index_query(flat)
            blobs = self.remote.multi_get(
                [k for k, r in zip(flat, resident) if r]
            )
        except ConnectionError as e:
            logger.warning("Prewarm fetch failed: %s", e)
            out["reason"] = f"fetch failed: {e}"
            return out
        blob_by_key: Dict[bytes, Optional[bytes]] = dict(
            zip([k for k, r in zip(flat, resident) if r], blobs)
        )
        writes: List[Tuple[int, tuple]] = []
        adopted: List[Tuple[int, bytes, bytes]] = []
        # Hashes collected THIS call: adoption into the block manager only
        # happens after the device write below, so without this set every
        # chain sharing an ancestor prefix would re-allocate and re-write
        # the same blocks once per chain.
        pending: set = set()
        for keys in usable:
            for i, key in enumerate(keys):
                h = key[len(pfx):]
                if h in pending or self.block_manager.contains_hash(h):
                    out["already_resident"] += 1
                    continue
                blob = blob_by_key.get(key)
                if blob is None:
                    # Evicted since 'H' (or residency miss): the rest of
                    # this chain is unrestorable contiguously — stop it.
                    out["skipped_blocks"] += len(keys) - i
                    break
                try:
                    parent_key, inner = unpack_chain(blob)
                    k, v, ks, vs = self.unpack(inner)
                except Exception:  # noqa: BLE001 — corrupt blob: skip chain
                    logger.warning("Prewarm blob %s undecodable; skipping "
                                   "chain tail", key.hex()[:16])
                    out["skipped_blocks"] += len(keys) - i
                    break
                if (ks is not None) != self._kv_quantized:
                    out["skipped_blocks"] += len(keys) - i
                    break
                blks = self.block_manager.allocate_blocks(1)
                if blks is None:
                    out["skipped_blocks"] += len(keys) - i
                    out["reason"] = "pool full"
                    break
                parent_hash = (
                    parent_key[len(pfx):]
                    if parent_key and parent_key.startswith(pfx) else
                    (keys[i - 1][len(pfx):] if i > 0 else b"")
                )
                writes.append((blks[0], (k, v, ks, vs)))
                adopted.append((blks[0], h, parent_hash))
                pending.add(h)
        if writes:
            blks = [b for b, _ in writes]
            k_np = np.stack([d[0] for _, d in writes])
            v_np = np.stack([d[1] for _, d in writes])
            if self._kv_quantized:
                self.runner.write_blocks(
                    blks, k_np, v_np,
                    np.stack([d[2] for _, d in writes]),
                    np.stack([d[3] for _, d in writes]),
                )
            else:
                self.runner.write_blocks(blks, k_np, v_np)
        for blk, h, parent_hash in adopted:
            if self.block_manager.adopt_full_block(blk, h, parent_hash):
                out["blocks"] += 1
            else:
                out["already_resident"] += 1
            # Park it evictable (cached-free): serving allocations may
            # reclaim it LRU like any other cached prefix block.
            self.block_manager.free_blocks([blk])
        out["chains"] = len(usable)
        return out

    @property
    def chain_evictions_total(self) -> int:
        """Leaf-first chain evictions in the local host tier (the
        pstpu:kv_chain_evictions_total counter)."""
        return self.host_pool.chain_evictions if self.host_pool else 0

    def stats(self) -> dict:
        out = {
            "restored_tokens_total": self.restored_tokens_total,
            "spilled_blocks_total": self.spilled_blocks_total,
            "shared_tier_hits_total": self.shared_tier_hits_total,
            "shared_tier_misses_total": self.shared_tier_misses_total,
            "restore_saved_tokens_total": self.restore_saved_tokens_total,
            "restore_declined_tokens_total":
                self.restore_declined_tokens_total,
            "chain_evictions_total": self.chain_evictions_total,
            "spill_failures_total": self.spill_failures_total,
            "restore_failures_total": self.restore_failures_total,
        }
        if self.host_pool is not None:
            out["host_pool"] = self.host_pool.stats()
        return out

    def close(self) -> None:
        """Stop the spill thread (blocks still queued are dropped, their
        pins released) and close the remote connection."""
        self._running = False
        if self._thread.is_alive() and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=10 * self.flush_interval + 5)
        with self._lock:
            for _, blk in self._queue:
                self.block_manager.unpin_for_spill(blk)
            self._queue.clear()
            self._queued_hashes.clear()
        if self.remote is not None:
            self.remote.close()
