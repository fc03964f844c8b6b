"""Prefill/decode disaggregation, the port of ``production_stack_tpu/disagg``.

An engine runs with ``role`` unified, prefill or decode: a prefill engine
computes a prompt's KV and first token and publishes them (PDX1) to the
shared KV store under a transfer key; a decode engine consumes the bundle
(delete-after-consume), writes the blocks into its own pool and continues
the stream from token 1. The stack's router drives the two hops.
"""

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


def __getattr__(name):
    """The package's names, imported at first use: importing
    ``disagg.headers`` (the router does) loads neither torch nor numpy."""
    if name == "DisaggCoordinator":
        from production_stack_tpu_torch.disagg.coordinator import DisaggCoordinator

        return DisaggCoordinator
    if name in __all__:
        from production_stack_tpu_torch.disagg import transfer

        return getattr(transfer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
