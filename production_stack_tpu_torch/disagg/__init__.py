"""Prefill/decode disaggregation, the port of ``production_stack_tpu/disagg``.

An engine runs with ``role`` unified, prefill or decode: a prefill engine
computes a prompt's KV and first token and publishes them (PDX1) to the
shared KV store under a transfer key; a decode engine consumes the bundle
(delete-after-consume), writes the blocks into its own pool and continues
the stream from token 1. The stack's router drives the two hops.
"""

from production_stack_tpu_torch.disagg.coordinator import DisaggCoordinator
from production_stack_tpu_torch.disagg.transfer import (
    DISAGG_ENDPOINT_HEADER,
    DISAGG_FALLBACK_HEADER,
    DISAGG_KEY_HEADER,
    DISAGG_ROLE_HEADER,
    ENGINE_ROLES,
    HandoffManifest,
    TransferManager,
    pack_manifest,
    unpack_manifest,
)

__all__ = [
    "DISAGG_ENDPOINT_HEADER",
    "DISAGG_FALLBACK_HEADER",
    "DISAGG_KEY_HEADER",
    "DISAGG_ROLE_HEADER",
    "ENGINE_ROLES",
    "DisaggCoordinator",
    "HandoffManifest",
    "TransferManager",
    "pack_manifest",
    "unpack_manifest",
]
