"""Handoff transfer manifest: serde and store lease for prefill->decode
moves, the port of ``production_stack_tpu/disagg/transfer.py`` (the same
PDX1 bytes, so a JAX prefill engine hands off to a port decode engine and
the reverse).

One manifest carries what a decode engine needs to continue a stream the
prefill engine started, with no recompute: the prompt token ids (the
decode hop does not re-encode text), the tokens already sampled (normally
one) with their logprob entries when asked for, the KV blocks of the
computed prompt positions (packed block by block with the offload tier's
serde), and for a request the prefill engine already finished, the finish
reason and final text to replay.

  PDX1 | u32 header_len | header JSON | (u64 blob_len | serde block blob)*

The store lease is delete-after-consume.
"""

import json
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.kv_offload.serde import get_serde
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_MAGIC = b"PDX1"

ENGINE_ROLES = ("unified", "prefill", "decode")

# Router<->engine disagg headers (request_service.py sets them; the API
# server reads them). Kept here so both planes import one definition.
DISAGG_ROLE_HEADER = "x-pstpu-disagg"            # hop marker: "decode"
DISAGG_KEY_HEADER = "x-pstpu-transfer-key"       # store key for the bundle
DISAGG_ENDPOINT_HEADER = "x-pstpu-endpoint"      # "chat" | "completions"
DISAGG_FALLBACK_HEADER = "x-pstpu-disagg-fallback"  # unlock unified serving
# Mid-stream resume (docs/RESILIENCE.md): the router asks the engine to
# attach the per-chunk resume payload (output token ids, offset, resolved
# sampler seed) to single-choice streams. Gated on a header so DIRECT API
# clients get pristine OpenAI chunks and the internal seed base is only
# exposed on router-requested streams (where it enables the splice and
# router-of-routers composition).
RESUME_HEADER = "x-pstpu-resume"


@dataclass
class HandoffManifest:
    request_id: str
    prompt_token_ids: List[int]
    output_token_ids: List[int]          # already sampled (normally 1 token)
    num_computed_tokens: int             # prompt positions whose KV rides along
    block_size: int
    model: str
    # Aligned per-token (chosen_logprob, [[token_id, logprob], ...]) entries
    # when the request asked for logprobs; None otherwise.
    output_logprobs: Optional[list] = None
    # Set when the prefill engine already finished the request: the decode
    # hop replays these verbatim (no KV rides along in that case).
    finish_reason: Optional[str] = None
    final_text: Optional[str] = None
    # KV-cache storage dtype of the published blocks (engine/config.py
    # kv_cache_dtype): the decode hop validates it against its own pool —
    # int8 blocks rehydrate bit-identically into an int8 pool with zero
    # recompute, and a mismatched bundle is rejected (the router degrades
    # to unified serving) rather than silently re-encoded.
    kv_cache_dtype: str = "bfloat16"
    # KV payload: [n_blocks, L, Hkv, bs, Dh] arrays (None when finished);
    # int8 bundles carry the per-(slot, head) scales [n_blocks, L, Hkv, bs].
    k: Optional[np.ndarray] = field(default=None, repr=False)
    v: Optional[np.ndarray] = field(default=None, repr=False)
    k_scale: Optional[np.ndarray] = field(default=None, repr=False)
    v_scale: Optional[np.ndarray] = field(default=None, repr=False)

    @property
    def num_blocks(self) -> int:
        return 0 if self.k is None else int(self.k.shape[0])


def pack_manifest(mani: HandoffManifest, serde: str = "naive") -> bytes:
    pack, _ = get_serde(serde)
    header = {
        "request_id": mani.request_id,
        "prompt_token_ids": list(mani.prompt_token_ids),
        "output_token_ids": list(mani.output_token_ids),
        "output_logprobs": mani.output_logprobs,
        "num_computed_tokens": mani.num_computed_tokens,
        "block_size": mani.block_size,
        "model": mani.model,
        "finish_reason": mani.finish_reason,
        "final_text": mani.final_text,
        "kv_cache_dtype": mani.kv_cache_dtype,
        "serde": serde,
    }
    hdr = json.dumps(header).encode()
    parts = [_MAGIC, struct.pack("<I", len(hdr)), hdr]
    n = mani.num_blocks
    for i in range(n):
        blob = pack(
            np.asarray(mani.k[i]), np.asarray(mani.v[i]),
            None if mani.k_scale is None else np.asarray(mani.k_scale[i]),
            None if mani.v_scale is None else np.asarray(mani.v_scale[i]),
        )
        parts.append(struct.pack("<Q", len(blob)))
        parts.append(blob)
    return b"".join(parts)


def unpack_manifest(blob: bytes) -> HandoffManifest:
    if blob[:4] != _MAGIC:
        raise ValueError("bad handoff manifest magic")
    (hlen,) = struct.unpack_from("<I", blob, 4)
    off = 8
    header = json.loads(blob[off:off + hlen].decode())
    off += hlen
    _, unpack = get_serde(header.get("serde", "naive"))
    ks, vs, kss, vss = [], [], [], []
    while off < len(blob):
        (blen,) = struct.unpack_from("<Q", blob, off)
        off += 8
        k, v, k_sc, v_sc = unpack(blob[off:off + blen])
        ks.append(k)
        vs.append(v)
        if k_sc is not None:
            kss.append(k_sc)
            vss.append(v_sc)
        off += blen
    return HandoffManifest(
        request_id=header["request_id"],
        prompt_token_ids=header["prompt_token_ids"],
        output_token_ids=header["output_token_ids"],
        output_logprobs=header.get("output_logprobs"),
        num_computed_tokens=header["num_computed_tokens"],
        block_size=header["block_size"],
        model=header["model"],
        finish_reason=header.get("finish_reason"),
        final_text=header.get("final_text"),
        kv_cache_dtype=header.get("kv_cache_dtype", "bfloat16"),
        k=np.stack(ks) if ks else None,
        v=np.stack(vs) if vs else None,
        k_scale=np.stack(kss) if kss else None,
        v_scale=np.stack(vss) if vss else None,
    )


class TransferManager:
    """Publish/consume handoff bundles over a kv_offload remote client.

    ``client`` duck-types RemoteKVClient: put/get/delete over bytes keys.
    The lease is delete-after-consume — a successful consume removes the
    bundle from the store so the cache server's host memory is not leaked
    by completed transfers.
    """

    def __init__(self, client):
        self.client = client

    def publish(self, key: str, blob: bytes) -> bool:
        return bool(self.client.put(key.encode(), blob))

    def peek(self, key: str) -> Optional[bytes]:
        """Read a bundle WITHOUT consuming the lease — callers validate
        compatibility first, so an incompatible bundle survives for other
        consumers (or LRU) instead of being destroyed by the engine that
        cannot use it."""
        return self.client.get(key.encode())

    def release(self, key: str) -> None:
        """Consume the lease: delete the bundle from the store."""
        try:
            self.client.delete(key.encode())
        except Exception:  # noqa: BLE001 — lease cleanup is best-effort
            logger.warning("Transfer lease delete failed for %s", key)

    def consume(self, key: str) -> Optional[bytes]:
        blob = self.peek(key)
        if blob is None:
            return None
        self.release(key)
        return blob

    def close(self) -> None:
        close = getattr(self.client, "close", None)
        if close is not None:
            close()
