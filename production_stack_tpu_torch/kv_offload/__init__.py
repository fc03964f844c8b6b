"""KV offload tiers, the LMCache counterpart (``production_stack_tpu/kv_offload``):

  * ``serde``     — the PKV1 / PKV2 block and PKC1 chain wire formats;
  * ``chain_lru`` — the prefix-chain-aware LRU both tiers evict with;
  * ``host_pool`` — the in-process host-RAM tier;
  * ``remote``    — the TCP client of the shared cache server;
  * ``server``    — the cache server process (pure Python);
  * ``manager``   — the engine side: spill of newly full device blocks,
                    restore at prompt admission, prewarm of hot chains.
"""
