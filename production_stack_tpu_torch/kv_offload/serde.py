"""KV block (de)serialization: the JAX package's wire formats, byte for
byte (``production_stack_tpu/kv_offload/serde.py``).

"naive" serde = raw little-endian dtype bytes behind a fixed header. One
value packs a block's K and V, two arrays ``[L, Hkv, block_size, Dh]``:

  * ``PKV1`` — payload only (bf16/f16/f32 pools): header + K + V bytes.
  * ``PKV2`` — quantized pools (int8): the header also names the scale
    dtype, and the int8 payload is followed by the per-(slot, head) scale
    planes ``[L, Hkv, block_size]`` in the pool's scale dtype, so a block
    restores bit-identically with no requantization.
  * ``PKC1`` — the chain envelope: a PKV1/PKV2 payload behind the store key
    of its chain-parent block (empty for chain roots), so the shared tier
    can evict leaf-first over chains from the blobs alone. Bare PKV1/PKV2
    blobs pass ``unpack_chain`` through with an empty parent.

numpy has no bfloat16, and the port depends on no package that adds one:
bfloat16 arrays here have the dtype ``BF16`` (one little-endian uint16
field named ``bfloat16``), which carries the same bytes. ``pack_block``
also takes arrays whose dtype prints as ``bfloat16`` (``ml_dtypes``), so a
JAX engine's arrays pack to the same bytes.
"""

import struct
from typing import Optional, Tuple

import numpy as np
import torch  # noqa: F401 — every module of the port is a torch module

_MAGIC = b"PKV1"
_MAGIC_Q = b"PKV2"
_MAGIC_CHAIN = b"PKC1"
_HDR_CHAIN = "<4sH"
_DTYPES = {0: "bfloat16", 1: "float32", 2: "float16", 3: "int8"}
_DTYPE_IDS = {v: k for k, v in _DTYPES.items()}
_HDR = "<4sB4I"
_HDR_Q = "<4sBB4I"

# bfloat16 as numpy holds it here: the 16 bits, under a field name that
# keeps the dtype's identity through reshape, stack and frombuffer.
BF16 = np.dtype([("bfloat16", "<u2")])


def dtype_name(dt: np.dtype) -> str:
    """The wire name of a numpy dtype (``BF16`` and ml_dtypes' bfloat16
    are both "bfloat16")."""
    if dt == BF16 or str(dt) == "bfloat16":
        return "bfloat16"
    return str(dt)


def np_dtype(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


def pack_block(
    k: np.ndarray, v: np.ndarray,
    k_scale: Optional[np.ndarray] = None,
    v_scale: Optional[np.ndarray] = None,
) -> bytes:
    """k/v: [L, Hkv, bs, Dh] arrays; k_scale/v_scale: [L, Hkv, bs] per-slot
    dequant scales (int8 pools) — their presence selects PKV2."""
    name = dtype_name(k.dtype)
    if k_scale is None:
        header = struct.pack(
            _HDR, _MAGIC, _DTYPE_IDS[name],
            k.shape[0], k.shape[1], k.shape[2], k.shape[3],
        )
        return header + k.tobytes() + v.tobytes()
    header = struct.pack(
        _HDR_Q, _MAGIC_Q, _DTYPE_IDS[name],
        _DTYPE_IDS[dtype_name(k_scale.dtype)],
        k.shape[0], k.shape[1], k.shape[2], k.shape[3],
    )
    return (header + k.tobytes() + v.tobytes()
            + k_scale.tobytes() + v_scale.tobytes())


def unpack_block(
    blob: bytes,
) -> Tuple[np.ndarray, np.ndarray,
           Optional[np.ndarray], Optional[np.ndarray]]:
    """-> (k, v, k_scale, v_scale); the scales are None for PKV1 blobs."""
    magic = blob[:4]
    if magic == _MAGIC:
        _, dt, nl, hkv, bs, dh = struct.unpack_from(_HDR, blob)
        off = struct.calcsize(_HDR)
        sdt = None
    elif magic == _MAGIC_Q:
        _, dt, sdt, nl, hkv, bs, dh = struct.unpack_from(_HDR_Q, blob)
        off = struct.calcsize(_HDR_Q)
    else:
        raise ValueError("bad KV block magic")
    dtype = np_dtype(_DTYPES[dt])
    n = nl * hkv * bs * dh
    nbytes = n * dtype.itemsize
    k = np.frombuffer(blob, dtype, count=n, offset=off).reshape(nl, hkv, bs, dh)
    v = np.frombuffer(blob, dtype, count=n, offset=off + nbytes).reshape(
        nl, hkv, bs, dh)
    if sdt is None:
        return k, v, None, None
    sdtype = np_dtype(_DTYPES[sdt])
    ns = nl * hkv * bs
    soff = off + 2 * nbytes
    k_scale = np.frombuffer(blob, sdtype, count=ns, offset=soff).reshape(
        nl, hkv, bs)
    v_scale = np.frombuffer(
        blob, sdtype, count=ns, offset=soff + ns * sdtype.itemsize
    ).reshape(nl, hkv, bs)
    return k, v, k_scale, v_scale


def pack_chain(parent_key: bytes, inner: bytes) -> bytes:
    """Wrap a packed KV blob with its chain-parent's store key (empty for
    chain roots)."""
    return (struct.pack(_HDR_CHAIN, _MAGIC_CHAIN, len(parent_key))
            + parent_key + inner)


def unpack_chain(blob: bytes) -> Tuple[bytes, bytes]:
    """-> (parent_key, inner); bare PKV1/PKV2 blobs pass through with an
    empty parent."""
    if blob[:4] != _MAGIC_CHAIN:
        return b"", blob
    _, plen = struct.unpack_from(_HDR_CHAIN, blob)
    off = struct.calcsize(_HDR_CHAIN)
    return blob[off:off + plen], blob[off + plen:]


def get_serde(name: str):
    if name == "naive":
        return pack_block, unpack_block
    raise ValueError(f"Unknown KV serde: {name!r} (supported: naive)")
