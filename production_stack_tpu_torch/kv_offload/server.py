"""The shared KV cache server: ``python -m
production_stack_tpu_torch.kv_offload.server --port 8200``.

The port's own copy of ``production_stack_tpu/kv_offload/server.py`` (the
JAX package's module cannot be imported where JAX is not installed). It
runs the native core (``native/kv_server.cpp``'s binary, built by ``make
-C native``) when ``find_native_binary`` finds one and ``--force-python``
is absent, and otherwise serves the same wire protocol (see
kv_offload/remote.py) in pure Python over the same chain-aware store
(kv_offload/chain_lru.py), so the stack's router, the JAX package's
engines and the port's engines all talk to it unchanged.

'P' payloads wrapped in the PKC1 chain envelope declare their parent's
store key; the blob is stored as received. 'M' is a pipelined multi-get,
'I' a read-only residency query, 'H' the hottest chains (read-only), 'D'
a delete (the disagg lease), 'T' stats. The native core predates 'M', 'I',
'H' and 'D' and answers them ``STATUS_ERROR``: ``RemoteKVClient`` then
degrades to per-key gets and existence checks, and prewarm and the disagg
lease's delete do nothing, as against the JAX package's server. Its store
is a flat LRU, not chain-aware.

``--port 0`` picks a free port; the server prints ``kv_server listening on
HOST:PORT`` on stdout once it accepts connections, whichever core serves.
The native core binds every interface (it takes no host), so a ``--host``
that names one address fails the server unless ``--force-python`` is
given; it exits with its own code, which is the server's; SIGTERM and
SIGINT are passed on to it.
"""

import argparse
import asyncio
import ctypes
import json
import os
import shutil
import signal
import socket
import struct
import subprocess
import sys
import time

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.kv_offload.chain_lru import ChainStore
from production_stack_tpu_torch.kv_offload.remote import pack_key_list  # noqa: F401
from production_stack_tpu_torch.kv_offload.serde import unpack_chain
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

STATUS_OK, STATUS_MISSING, STATUS_ERROR = 0, 1, 2
# Seconds the native core has to accept connections before the server
# fails.
NATIVE_STARTUP_TIMEOUT_S = 30.0
# Hosts that mean every interface: the only ones the native core serves.
WILDCARD_HOSTS = ("0.0.0.0", "", "::")


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


def find_native_binary() -> str:
    """The native core's binary (the reference's candidates):
    ``native/build/kv_server`` beside this checkout, then ``kv_server`` on
    ``PATH``; "" when neither is an executable file."""
    candidates = [
        os.path.join(os.path.dirname(__file__), "..", "..", "native",
                     "build", "kv_server"),
        shutil.which("kv_server") or "",
    ]
    for c in candidates:
        c = os.path.abspath(c) if c else ""
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return ""


def _die_with_parent() -> None:
    """In the child, before exec: SIGTERM it when this process dies, so a
    killed server leaves no native core behind (Linux ``prctl``)."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)  # PR_SET_PDEATHSIG
    except (AttributeError, OSError):
        pass


def _exit_code(rc: int) -> int:
    """A child's return code as a shell's exit code: 128 + the signal that
    ended it."""
    return 128 - rc if rc < 0 else rc


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def serve_native(binary: str, host: str, port: int, max_bytes: int) -> int:
    """Run the native core on ``port`` (a free one when 0) and announce it
    once it accepts connections; returns its exit code (128 + the signal
    that ended it). A core that exits or does not accept connections within
    ``NATIVE_STARTUP_TIMEOUT_S`` fails the server: nothing falls back to
    Python. The core binds every interface: a ``host`` that names one
    address fails the server too, rather than expose the store beyond it
    (``--force-python`` serves on that address)."""
    if host not in WILDCARD_HOSTS:
        logger.error("the native kv_server binds every interface and cannot "
                     "bind --host %s; pass --force-python to serve there",
                     host)
        return 2
    if port == 0:
        port = _free_port()
    proc = subprocess.Popen(
        [binary, "--port", str(port), "--max-bytes", str(max_bytes)],
        preexec_fn=_die_with_parent)
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda s, _f: proc.send_signal(s))
    deadline = time.monotonic() + NATIVE_STARTUP_TIMEOUT_S
    while True:
        rc = proc.poll()
        if rc is not None:
            logger.error("native kv_server %s exited with %d before it "
                         "accepted connections on port %d", binary, rc, port)
            return _exit_code(rc) or 1
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            break
        except OSError:
            if time.monotonic() > deadline:
                logger.error("native kv_server %s did not accept connections "
                             "on port %d within %.0f s", binary, port,
                             NATIVE_STARTUP_TIMEOUT_S)
                proc.kill()
                proc.wait()
                return 1
            time.sleep(0.05)
    logger.info("native kv_server %s listening on port %d (max %d bytes)",
                binary, port, max_bytes)
    print(f"kv_server listening on {host}:{port}", flush=True)
    return _exit_code(proc.wait())


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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="Shared KV cache server")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8200)
    ap.add_argument("--max-bytes", type=int, default=32 << 30)
    ap.add_argument("--force-python", action="store_true",
                    help="skip the native binary even if present")
    ap.add_argument("--serde", default="naive", choices=["naive"],
                    help="the blobs' wire format; the Helm chart renders it "
                         "(cacheserverSpec.serde), and naive is the one "
                         "this server speaks")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.force_python:
        binary = find_native_binary()
        if binary:
            return serve_native(binary, args.host, args.port, args.max_bytes)
        logger.warning("Native kv_server binary not found "
                       "(build with `make -C native`); using Python server")
    try:
        asyncio.run(serve_python(args.host, args.port, args.max_bytes,
                                 announce=True))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
