"""Host-RAM KV tier: store key -> packed KV bytes, chain-aware LRU (the
``LMCACHE_LOCAL_CPU`` / ``LMCACHE_MAX_LOCAL_CPU_SIZE`` tier; a copy of
``production_stack_tpu/kv_offload/host_pool.py``).

Thread-safe: the spill thread writes while the scheduler path reads.
Eviction is leaf-first over prefix chains (kv_offload/chain_lru.py), so
every resident block stays restorable from its chain root.
"""

from typing import Optional

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.kv_offload.chain_lru import ChainStore


class HostKVPool:
    def __init__(self, max_bytes: int):
        self._store = ChainStore(max_bytes)

    def put(self, key: bytes, blob: bytes,
            parent: Optional[bytes] = None) -> None:
        self._store.put(key, blob, parent=parent)

    def get(self, key: bytes) -> Optional[bytes]:
        return self._store.get(key)

    def contains(self, key: bytes) -> bool:
        return self._store.contains(key)

    @property
    def chain_evictions(self) -> int:
        return self._store.chain_evictions

    def stats(self) -> dict:
        return self._store.stats()
