"""The shared KV cache server: ``python -m
production_stack_tpu_torch.kv_offload.server --port 8200``.

The port's own copy of the pure-Python server of
``production_stack_tpu/kv_offload/server.py`` (the JAX package's module
cannot be imported where JAX is not installed). The same wire protocol
(see kv_offload/remote.py) and the same chain-aware store
(kv_offload/chain_lru.py), so the stack's router, the JAX package's
engines and the port's engines all talk to it unchanged. The native core
(``native/kv_server.cpp``) is not run from here.

'P' payloads wrapped in the PKC1 chain envelope declare their parent's
store key; the blob is stored as received. 'M' is a pipelined multi-get,
'I' a read-only residency query, 'H' the hottest chains (read-only), 'D'
a delete (the disagg lease), 'T' stats. ``--port 0`` picks a free port;
the server prints ``kv_server listening on HOST:PORT`` on stdout once it
accepts connections.
"""

import argparse
import asyncio
import json
import struct
import sys

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.kv_offload.chain_lru import ChainStore
from production_stack_tpu_torch.kv_offload.serde import unpack_chain
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

STATUS_OK, STATUS_MISSING, STATUS_ERROR = 0, 1, 2


def unpack_key_list(val: bytes):
    """Parse the 'M'/'I' request payload: u32 count | (u32 klen | key)*.
    Raises ValueError on a malformed payload."""
    if len(val) < 4:
        raise ValueError("key-list payload too short")
    (count,) = struct.unpack_from("<I", val, 0)
    off = 4
    keys = []
    for _ in range(count):
        if off + 4 > len(val):
            raise ValueError("truncated key-list payload")
        (klen,) = struct.unpack_from("<I", val, off)
        off += 4
        if off + klen > len(val):
            raise ValueError("truncated key in key-list payload")
        keys.append(val[off:off + klen])
        off += klen
    return keys


def pack_key_list(keys) -> bytes:
    out = [struct.pack("<I", len(keys))]
    for k in keys:
        out.append(struct.pack("<I", len(k)) + k)
    return b"".join(out)


class PyKVServer:
    def __init__(self, max_bytes: int):
        self.store = ChainStore(max_bytes)

    async def handle(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                op = await reader.readexactly(1)
                (klen,) = struct.unpack("<I", await reader.readexactly(4))
                key = await reader.readexactly(klen) if klen else b""
                (vlen,) = struct.unpack("<Q", await reader.readexactly(8))
                val = await reader.readexactly(vlen) if vlen else b""
                status, payload = self._dispatch(op, key, val)
                writer.write(
                    bytes([status]) + struct.pack("<Q", len(payload)) + payload)
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError):
            pass
        finally:
            writer.close()

    def _dispatch(self, op: bytes, key: bytes, val: bytes):
        if op == b"P":
            parent, _ = unpack_chain(val)
            self.store.put(key, val, parent=parent or None)
            return STATUS_OK, b""
        if op == b"G":
            blob = self.store.get(key)
            if blob is None:
                return STATUS_MISSING, b""
            return STATUS_OK, blob
        if op == b"M":
            try:
                keys = unpack_key_list(val)
            except ValueError:
                return STATUS_ERROR, b""
            parts = []
            for blob in self.store.multi_get(keys):
                if blob is None:
                    parts.append(bytes([STATUS_MISSING]) + struct.pack("<Q", 0))
                else:
                    parts.append(bytes([STATUS_OK])
                                 + struct.pack("<Q", len(blob)) + blob)
            return STATUS_OK, b"".join(parts)
        if op == b"I":
            try:
                keys = unpack_key_list(val)
            except ValueError:
                return STATUS_ERROR, b""
            return STATUS_OK, bytes(
                1 if r else 0 for r in self.store.residency(keys))
        if op == b"E":
            return (STATUS_OK if self.store.contains(key)
                    else STATUS_MISSING), b""
        if op == b"D":
            if not self.store.delete(key):
                return STATUS_MISSING, b""
            return STATUS_OK, b""
        if op == b"H":
            # val = u32 top_k | u32 max_blocks; JSON {"chains": [[hex store
            # key, ... root -> leaf], ...]}, hottest first.
            try:
                (top_k,) = struct.unpack_from("<I", val, 0)
                (max_blocks,) = (struct.unpack_from("<I", val, 4)
                                 if len(val) >= 8 else (4096,))
            except struct.error:
                return STATUS_ERROR, b""
            chains = self.store.hot_chains(
                min(top_k, 256), max_blocks=min(max_blocks, 65536))
            return STATUS_OK, json.dumps({
                "chains": [[k.hex() for k in chain] for chain in chains],
            }).encode()
        if op == b"T":
            return STATUS_OK, json.dumps({
                **self.store.stats(), "impl": "python",
            }).encode()
        return STATUS_ERROR, b""


async def serve_python(host: str, port: int, max_bytes: int,
                       announce: bool = False) -> None:
    server = PyKVServer(max_bytes)
    srv = await asyncio.start_server(server.handle, host, port)
    port = srv.sockets[0].getsockname()[1]
    logger.info("Python kv_server listening on %s:%d (max %d bytes)",
                host, port, max_bytes)
    if announce:
        print(f"kv_server listening on {host}:{port}", flush=True)
    async with srv:
        await srv.serve_forever()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Shared KV cache server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--max-bytes", type=int, default=32 << 30)
    args = ap.parse_args(argv)
    try:
        asyncio.run(serve_python(args.host, args.port, args.max_bytes,
                                 announce=True))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
