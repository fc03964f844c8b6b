"""TCP client of the shared KV cache server (``kv://host:port``), a copy
of ``production_stack_tpu/kv_offload/remote.py``: the same wire, so the
port's engines share one server with the JAX package's engines and its
router.

  request:  op(1) | key_len(u32 LE) | key | val_len(u64 LE) | val
  response: status(1: 0=ok, 1=missing, 2=error) | val_len(u64 LE) | val

ops: 'P' put, 'G' get, 'E' exists, 'D' delete, 'T' stats (JSON), 'M'
pipelined multi-get (val = packed key list, response = per-key
status|len|blob), 'I' index query (val = packed key list, response = one
residency byte per key), 'H' hot chains (JSON). One request in flight per
connection; a lock serializes callers (the spill thread, the handoff
executor). A server that answers 'M' or 'I' with an error (the native
server predates them) is remembered, and the batched calls degrade to
per-key ops; a dead socket is reconnected once per request.
"""

import json
import socket
import struct
import threading
from typing import List, Optional, Sequence
from urllib.parse import urlparse

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

STATUS_OK = 0
STATUS_MISSING = 1
STATUS_ERROR = 2


def pack_key_list(keys) -> bytes:
    """The ``M`` / ``I`` ops' key list: a count, then each key's length and
    bytes (the server's ``unpack_key_list`` reads it)."""
    out = [struct.pack("<I", len(keys))]
    for k in keys:
        out.append(struct.pack("<I", len(k)) + k)
    return b"".join(out)


def parse_kv_url(url: str):
    """(host, port) from a store URL: ``kv://host:port`` (also ``tcp://``,
    ``lm://``, or a bare host:port — the LMCACHE_REMOTE_URL shapes). The
    single parser shared by this client and the router's parse-time
    reachability probe, so both always resolve the same endpoint."""
    parsed = urlparse(url if "//" in url else f"kv://{url}")
    return parsed.hostname or "localhost", parsed.port or 8200


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("KV server closed connection")
        buf.extend(chunk)
    return bytes(buf)


class RemoteKVClient:
    def __init__(self, url: str, connect_timeout: float = 5.0,
                 io_timeout: float = 30.0):
        """url: ``kv://host:port`` (also accepts ``tcp://`` / bare host:port,
        mirroring the reference's LMCACHE_REMOTE_URL shape)."""
        self.host, self.port = parse_kv_url(url)
        self.connect_timeout = connect_timeout
        self.io_timeout = io_timeout
        self._sock: Optional[socket.socket] = None
        self._lock = threading.Lock()
        # Wire round trips issued (one per _request attempt that reached
        # the send). The restore path's efficiency bar — N blocks in <= 2
        # round trips via 'I' + 'M' instead of N gets — is asserted
        # against this counter (tests/test_kv_economy.py).
        self.round_trips = 0
        # The native C++ server predates the batched ops and answers them
        # STATUS_ERROR; remember that and degrade to per-key ops.
        self._batched_ops_ok = True

    def _ensure_sock(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection(
                (self.host, self.port), timeout=self.connect_timeout
            )
            s.settimeout(self.io_timeout)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def _request(self, op: bytes, key: bytes, val: bytes = b""):
        with self._lock:
            # One-shot reconnect retry: a server restart leaves this client
            # holding a dead socket, and the FIRST request after it fails
            # with EPIPE/ECONNRESET on send (or EOF on recv) even though the
            # server is back. Requests are whole-message and idempotent at
            # this layer, so retrying once on a fresh connection is safe; a
            # second failure means the server is really down.
            for attempt in (0, 1):
                try:
                    sock = self._ensure_sock()
                    self.round_trips += 1
                    sock.sendall(
                        op + struct.pack("<I", len(key)) + key
                        + struct.pack("<Q", len(val)) + val
                    )
                    status = _recv_exact(sock, 1)[0]
                    (vlen,) = struct.unpack("<Q", _recv_exact(sock, 8))
                    payload = _recv_exact(sock, vlen) if vlen else b""
                    return status, payload
                except (OSError, ConnectionError) as e:
                    # Drop the connection; the retry (or next call) reconnects.
                    if self._sock is not None:
                        try:
                            self._sock.close()
                        except OSError:
                            pass
                        self._sock = None
                    if attempt == 1:
                        raise ConnectionError(
                            f"KV server request failed: {e}"
                        ) from e

    # ------------------------------------------------------------------- API
    def put(self, key: bytes, blob: bytes) -> bool:
        status, _ = self._request(b"P", key, blob)
        return status == STATUS_OK

    def get(self, key: bytes) -> Optional[bytes]:
        status, payload = self._request(b"G", key)
        return payload if status == STATUS_OK else None

    def exists(self, key: bytes) -> bool:
        status, _ = self._request(b"E", key)
        return status == STATUS_OK

    def delete(self, key: bytes) -> bool:
        """Remove a key (disagg delete-after-consume lease; frees the
        server's host memory for consumed transfer bundles). True iff the
        key existed and was deleted."""
        status, _ = self._request(b"D", key)
        return status == STATUS_OK

    def multi_get(self, keys: Sequence[bytes]) -> List[Optional[bytes]]:
        """Pipelined batch get ('M'): ONE round trip for the whole restore
        run instead of one per block. Falls back to sequential get() against
        servers that predate the op (native C++ server answers
        STATUS_ERROR)."""
        if not keys:
            return []
        if self._batched_ops_ok:
            status, payload = self._request(b"M", b"", pack_key_list(keys))
            if status == STATUS_OK:
                out: List[Optional[bytes]] = []
                off = 0
                try:
                    for _ in keys:
                        st = payload[off]
                        (vlen,) = struct.unpack_from("<Q", payload, off + 1)
                        off += 9
                        out.append(
                            payload[off:off + vlen] if st == STATUS_OK
                            else None
                        )
                        off += vlen
                    return out
                except (IndexError, struct.error) as e:
                    raise ConnectionError(
                        f"malformed multi-get response: {e}"
                    ) from e
            self._batched_ops_ok = False
        return [self.get(k) for k in keys]

    def index_query(self, keys: Sequence[bytes]) -> List[bool]:
        """Residency bitmap ('I'): which of ``keys`` the tier currently
        holds, in one round trip and without refreshing their recency.
        Falls back to per-key exists() on pre-batched-protocol servers."""
        if not keys:
            return []
        if self._batched_ops_ok:
            status, payload = self._request(b"I", b"", pack_key_list(keys))
            if status == STATUS_OK and len(payload) == len(keys):
                return [b == 1 for b in payload]
            if status == STATUS_OK:
                raise ConnectionError("malformed index-query response")
            self._batched_ops_ok = False
        return [self.exists(k) for k in keys]

    def hot_chains(self, top_k: int,
                   max_blocks: int = 4096) -> List[List[bytes]]:
        """The shared tier's hottest prefix chains ('H'), each a
        root->leaf list of store keys — the prewarm protocol's discovery
        half (docs/ELASTIC.md). Empty on servers that predate the op (the
        native C++ server answers STATUS_ERROR) — prewarm then no-ops
        rather than failing engine startup."""
        status, payload = self._request(
            b"H", b"", struct.pack("<II", top_k, max_blocks)
        )
        if status != STATUS_OK:
            return []
        try:
            doc = json.loads(payload)
            return [
                [bytes.fromhex(k) for k in chain]
                for chain in doc.get("chains", [])
            ]
        except (ValueError, TypeError) as e:
            raise ConnectionError(
                f"malformed hot-chains response: {e}"
            ) from e

    def stats(self) -> dict:
        status, payload = self._request(b"T", b"")
        return json.loads(payload) if status == STATUS_OK else {}

    def close(self) -> None:
        with self._lock:
            if self._sock is not None:
                try:
                    self._sock.close()
                except OSError:
                    pass
                self._sock = None
