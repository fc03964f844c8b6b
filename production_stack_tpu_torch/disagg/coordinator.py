"""Engine-side disaggregation coordinator, the port of
``production_stack_tpu/disagg/coordinator.py``.

Owns a role-split engine's transfer plane: its own remote-store connection
(apart from the spill thread's, so handoffs never queue behind spills),
publish on the prefill side, fetch and lease on the decode side, and the
``pstpu:kv_handoff_*`` counters. Publish reads the sequence's blocks
(``runner.read_blocks``, on the dispatch stream) and puts the manifest;
both run on an executor thread, never the event loop.
"""

import time
from typing import Optional

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.disagg.transfer import (
    HandoffManifest,
    TransferManager,
    pack_manifest,
    unpack_manifest,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class DisaggCoordinator:
    def __init__(self, config, runner, block_manager, client=None):
        """``client``: injectable store client (tests); defaults to a fresh
        RemoteKVClient on config.kv_remote_url."""
        if client is None:
            from production_stack_tpu_torch.kv_offload.remote import (
                RemoteKVClient,
            )

            if not config.kv_remote_url:
                raise ValueError(
                    f"engine role {config.role!r} requires kv_remote_url "
                    f"(LMCACHE_REMOTE_URL / --kv-remote-url): the prefill->"
                    f"decode KV handoff rides the shared offload store"
                )
            client = RemoteKVClient(config.kv_remote_url)
        self.config = config
        self.runner = runner
        self.block_manager = block_manager
        self.transfer = TransferManager(client)
        self.serde = config.kv_remote_serde
        # telemetry (monotonic counters; server/metrics.py renders them)
        self.handoffs_total = 0
        self.handoff_bytes_total = 0
        self.handoff_seconds_total = 0.0
        self.handoff_failures_total = 0

    # ------------------------------------------------------------ prefill side
    def publish_handoff(self, seq, final_text: Optional[str] = None) -> bool:
        """Serialize ``seq``'s KV blocks + chain state and publish them under
        its transfer key. For sequences the prefill engine already finished
        (EOS/max_tokens/stop at token 1) no KV rides along — the manifest
        carries the final text + finish reason for verbatim replay."""
        t0 = time.monotonic()
        try:
            k = v = k_sc = v_sc = None
            if not seq.status.is_finished and seq.block_ids:
                k, v, k_sc, v_sc = self.runner.read_blocks_retry(
                    seq.block_ids
                )
            mani = HandoffManifest(
                request_id=seq.request_id,
                prompt_token_ids=list(seq.prompt_token_ids),
                output_token_ids=list(seq.output_token_ids),
                output_logprobs=(
                    list(seq.output_logprobs)
                    if seq.sampling.logprobs is not None else None
                ),
                num_computed_tokens=seq.num_computed_tokens,
                block_size=self.config.block_size,
                model=self.config.model_name,
                finish_reason=(
                    seq.finish_reason() if seq.status.is_finished else None
                ),
                final_text=final_text if seq.status.is_finished else None,
                kv_cache_dtype=self.config.kv_cache_dtype,
                k=k, v=v, k_scale=k_sc, v_scale=v_sc,
            )
            blob = pack_manifest(mani, self.serde)
            if not self.transfer.publish(seq.handoff_key, blob):
                raise ConnectionError("store refused the transfer put")
        except Exception as e:  # noqa: BLE001 — handoff must fail cleanly
            self.handoff_failures_total += 1
            logger.warning("KV handoff publish failed for %s: %s",
                           seq.request_id, e)
            return False
        self.handoffs_total += 1
        self.handoff_bytes_total += len(blob)
        self.handoff_seconds_total += time.monotonic() - t0
        return True

    # ------------------------------------------------------------- decode side
    def fetch_handoff(self, key: str) -> Optional[HandoffManifest]:
        """Read a transfer bundle WITHOUT consuming its lease — the caller
        validates compatibility (block size, pool capacity) first and then
        calls consume_handoff, so an engine that cannot use the bundle does
        not destroy it for the rest of the pool. Returns None when the key
        is missing/expired or the store is unreachable — the caller
        surfaces a retryable 503 so the router can fail over or degrade to
        unified serving."""
        t0 = time.monotonic()
        try:
            blob = self.transfer.peek(key)
            if blob is None:
                return None
            mani = unpack_manifest(blob)
        except Exception as e:  # noqa: BLE001 — store/codec failure
            self.handoff_failures_total += 1
            logger.warning("KV handoff fetch failed for %s: %s", key, e)
            return None
        self.handoffs_total += 1
        self.handoff_bytes_total += len(blob)
        self.handoff_seconds_total += time.monotonic() - t0
        return mani

    def consume_handoff(self, key: str) -> None:
        """Delete-after-consume: called once the bundle is accepted for
        restore, so completed transfers never linger in the store's host
        memory."""
        self.transfer.release(key)

    def stats(self) -> dict:
        return {
            "kv_handoffs_total": self.handoffs_total,
            "kv_handoff_bytes_total": self.handoff_bytes_total,
            "kv_handoff_seconds_total": self.handoff_seconds_total,
            "kv_handoff_failures_total": self.handoff_failures_total,
        }

    def close(self) -> None:
        self.transfer.close()
