"""The port's KV tier (``production_stack_tpu_torch/kv_offload``, the block
pool's offload hooks, ``runner.read_blocks`` / ``write_blocks``) against
the JAX package's.

Wire formats are held byte for byte: PKV1 and PKV2 blocks, the PKC1 chain
envelope, ``q8|`` key namespaces and the ``kv://`` ops, the JAX client on
the port's server and the port's client on the JAX server (both real
server processes), with the degrade when a server lacks a batched op. The
chain-aware store, the host pool, the block-pool hooks and the manager's
restore path are driven through the reference tests' shapes
(``tests/test_kv_offload.py``, ``tests/test_kv_economy.py:31-111``,
``tests/test_elastic.py:30-115``) on both packages, and their observations
compared. Then whole engines on the CPU (``tiny-llama-128dh``, the JAX
params through numpy, float32 compute, float32 or int8 pools): a prefix a
JAX engine spilled restores into a port engine, and the reverse; the
restored pool bytes equal the blobs exactly and the greedy tokens equal
those of the engine that computed the prefix (exact: both engines compute
in float32 over the same bytes). ``/prefix_index`` answers as the JAX
server's does, and ``/prewarm`` runs end to end on both.
"""

import asyncio
import json
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from production_stack_tpu.engine.kv_cache import BlockPoolManager as JaxPool
from production_stack_tpu.engine.kv_cache import _block_hash as jax_block_hash
from production_stack_tpu.engine.sampling import SamplingParams as JaxSampling
from production_stack_tpu.kv_offload import chain_lru as jchain
from production_stack_tpu.kv_offload import manager as jmanager
from production_stack_tpu.kv_offload import remote as jremote
from production_stack_tpu.kv_offload import serde as jserde
from production_stack_tpu.kv_offload import server as jserver
from production_stack_tpu.kv_offload.host_pool import HostKVPool as JaxHostPool
from production_stack_tpu.server.api_server import APIServer as JaxServer
from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kv_cache import (
    BlockPoolManager,
    _block_hash,
)
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.kv_offload import chain_lru, manager, remote
from production_stack_tpu_torch.kv_offload import serde
from production_stack_tpu_torch.kv_offload import server as pserver
from production_stack_tpu_torch.kv_offload.host_pool import HostKVPool
from production_stack_tpu_torch.launch import free_port, launch_kv_server
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.server.api_server import OpenAIServer
from tests.test_torch_surface import COMMON, MODEL, _http, _jax_engine, \
    _port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_SHAPE = (2, 2, 4, 8)  # [L, Hkv, bs, Dh]


def _wait_tcp(port, proc=None, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"server on {port} exited {proc.returncode}")
        try:
            socket.create_connection(("127.0.0.1", port), 0.2).close()
            return
        except OSError:
            time.sleep(0.05)
    raise TimeoutError(f"nothing listens on {port}")


def _thread_server(serve_python, max_bytes=1 << 26):
    """A cache server's ``serve_python`` on a background loop: (url, stop);
    stop cancels it, closes its connections and joins the thread."""
    port = free_port()
    loop = asyncio.new_event_loop()
    main = loop.create_task(serve_python("127.0.0.1", port, max_bytes))

    def run():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(main)
        except asyncio.CancelledError:
            pass
        rest = asyncio.all_tasks(loop)
        for t in rest:
            t.cancel()
        loop.run_until_complete(asyncio.gather(*rest, return_exceptions=True))
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    _wait_tcp(port)

    def stop():
        if not loop.is_closed():
            loop.call_soon_threadsafe(main.cancel)
        thread.join(10)

    return f"kv://127.0.0.1:{port}", stop


@pytest.fixture(scope="module")
def server_processes():
    """The JAX package's cache server and the port's, each its own process:
    {"jax": url, "port": url}."""
    port = free_port()
    jproc = subprocess.Popen(
        [sys.executable, "-m", "production_stack_tpu.kv_offload.server",
         "--force-python", "--host", "127.0.0.1", "--port", str(port),
         "--max-bytes", str(1 << 24)],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    # The Python server: the wire ops and ``impl`` below are its own.
    phandle = launch_kv_server(max_bytes=1 << 24, force_python=True)
    try:
        _wait_tcp(port, jproc)
        yield {"jax": f"kv://127.0.0.1:{port}", "port": phandle.url}
    finally:
        jproc.terminate()
        jproc.wait(10)
        phandle.stop()


# ------------------------------------------------------------------- serde
def _arrays(kind, shape=BLOCK_SHAPE, seed=0):
    """(port arrays, JAX arrays) of one block: k, v and, for int8, the
    bf16 scales. The two hold the same bytes (bf16: serde.BF16 and
    ml_dtypes.bfloat16)."""
    rng = np.random.default_rng(seed)
    if kind == "int8":
        k = rng.integers(-127, 128, shape, dtype=np.int8)
        v = rng.integers(-127, 128, shape, dtype=np.int8)
        ks = rng.standard_normal(shape[:-1]).astype(ml_dtypes.bfloat16)
        vs = rng.standard_normal(shape[:-1]).astype(ml_dtypes.bfloat16)
        port = (k, v, ks.view(np.uint16).view(serde.BF16),
                vs.view(np.uint16).view(serde.BF16))
        return port, (k, v, ks, vs)
    dt = np.float32 if kind == "float32" else ml_dtypes.bfloat16
    k = rng.standard_normal(shape).astype(dt)
    v = rng.standard_normal(shape).astype(dt)
    if kind == "float32":
        return (k, v, None, None), (k, v, None, None)
    return ((k.view(np.uint16).view(serde.BF16),
             v.view(np.uint16).view(serde.BF16), None, None),
            (k, v, None, None))


def _same_bytes(a, b):
    return (a is None and b is None) or (
        a.shape == b.shape and a.tobytes() == b.tobytes())


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_serde_blocks_and_chains_byte_for_byte(kind):
    """The port packs a block to the JAX package's bytes (PKV1, or PKV2
    with bf16 scales); each side unpacks the other's blob to the same
    bytes; the PKC1 envelope likewise, and a bare blob passes through."""
    port, jx = _arrays(kind)
    blob = serde.pack_block(*port)
    assert blob == jserde.pack_block(*jx)
    assert blob[:4] == (b"PKV2" if kind == "int8" else b"PKV1")
    for got, want in zip(serde.unpack_block(blob), jserde.unpack_block(blob)):
        assert _same_bytes(got, want)
    if kind == "bfloat16":
        assert serde.unpack_block(blob)[0].dtype == serde.BF16
    # JAX arrays (ml_dtypes) into the port's packer: the same bytes.
    assert serde.pack_block(*jx) == blob
    for parent in (b"", b"q8|" + b"\x07" * 16):
        env = serde.pack_chain(parent, blob)
        assert env == jserde.pack_chain(parent, blob)
        assert serde.unpack_chain(env) == jserde.unpack_chain(env) == \
            (parent, blob)
    assert serde.unpack_chain(blob) == (b"", blob)
    with pytest.raises(ValueError):
        serde.unpack_block(b"NOPE" + blob[4:])
    with pytest.raises(ValueError):
        serde.get_serde("cbor")


def test_serde_roundtrip():
    """The reference's round trip (tests/test_kv_offload.py)."""
    for dtype in (np.float32, serde.BF16):
        k = np.arange(2 * 2 * 4 * 8, dtype=np.float32).reshape(2, 2, 4, 8)
        if dtype == serde.BF16:
            k = k.astype(ml_dtypes.bfloat16).view(np.uint16).view(serde.BF16)
        v = k.copy()
        k2, v2, ks2, vs2 = serde.unpack_block(serde.pack_block(k, v))
        assert ks2 is None and vs2 is None
        assert k2.dtype == dtype and k2.tobytes() == k.tobytes()
        assert v2.tobytes() == v.tobytes()


# --------------------------------------------------- chain store, host pool
def _leaf_first(Store):
    s = Store(max_bytes=100)
    s.put(b"root", b"x" * 30)
    s.put(b"mid", b"x" * 30, parent=b"root")
    s.put(b"leaf", b"x" * 30, parent=b"mid")
    s.put(b"other", b"x" * 30)
    st = s.stats()
    assert s.contains(b"root") and s.contains(b"mid")
    assert not s.contains(b"leaf")
    assert st["evictions"] == 1 and st["chain_evictions"] == 1
    assert st["parent_protected_skips"] == 0
    return st


def _touch_refreshes_chain(Store):
    s = Store(max_bytes=90)
    s.put(b"a1", b"x" * 30)
    s.put(b"a2", b"x" * 30, parent=b"a1")
    s.put(b"b1", b"x" * 30)
    assert s.get(b"a2") is not None
    s.put(b"c1", b"x" * 30)
    assert not s.contains(b"b1")
    assert s.contains(b"a1") and s.contains(b"a2")
    return s.stats()


def _random_chains(Store):
    """Randomized root-first chains under eviction pressure: after every
    operation each resident entry's parent is resident, and the leaf
    frontier equals resident entries with no resident child."""
    rng = random.Random(1234)
    s = Store(max_bytes=40 * 25)
    chains, trace = [], []

    def check():
        with s._lock:
            for k in s._data:
                p = s._parent.get(k)
                assert p is None or p in s._data
            assert set(s._leaves) == {
                k for k in s._data if not s._has_live_child(k)}
        trace.append(tuple(s._data))

    for _ in range(400):
        if rng.random() < 0.5 or not chains:
            cid = rng.randrange(1000)
            keys = [f"c{cid}-{d}".encode() for d in range(rng.randint(1, 6))]
            for d, key in enumerate(keys):
                s.put(key, b"x" * 40, parent=keys[d - 1] if d else None)
                check()
            chains.append(keys)
        else:
            s.get(rng.choice(rng.choice(chains)))
            check()
    assert s.stats()["evictions"] > 50
    return s.stats(), trace


def _deep_chain(Store):
    s = Store(max_bytes=100)
    keys = [f"k{d}".encode() for d in range(8)]
    for d, key in enumerate(keys):
        s.put(key, b"x" * 30, parent=keys[d - 1] if d else None)
        assert s.stats()["bytes"] <= 100
    resident = [d for d, k in enumerate(keys) if s.contains(k)]
    assert resident == list(range(resident[0], resident[-1] + 1))
    assert len(resident) == 3
    return resident


def _hot_chains(Store):
    st = Store(1 << 20)
    st.put(b"a", b"A" * 8)
    st.put(b"b", b"B" * 8, parent=b"a")
    st.put(b"c", b"C" * 8, parent=b"b")
    st.put(b"d", b"D" * 8)
    st.get(b"c")
    chains = st.hot_chains(4)
    assert chains[0] == [b"a", b"b", b"c"] and chains[1] == [b"d"]
    budget = Store(1 << 20)
    for i in range(6):
        budget.put(f"k{i}".encode(), b"X" * 8)
    assert len(budget.hot_chains(2)) == 2
    assert sum(len(c) for c in budget.hot_chains(10, max_blocks=3)) == 3
    ro = Store(30)
    ro.put(b"a", b"A" * 8)
    ro.put(b"b", b"B" * 8)
    ro.hot_chains(10)
    ro.put(b"c", b"C" * 8)
    ro.put(b"d", b"D" * 8)
    assert not ro.contains(b"a") and ro.contains(b"d")
    return chains, budget.hot_chains(10, max_blocks=3)


@pytest.mark.parametrize("case", [_leaf_first, _touch_refreshes_chain,
                                  _random_chains, _deep_chain, _hot_chains],
                         ids=lambda f: f.__name__.strip("_"))
def test_chain_store_matches_jax(case):
    """Each reference scenario on the port's ChainStore passes the
    reference's assertions and observes what the JAX store observes."""
    assert case(chain_lru.ChainStore) == case(jchain.ChainStore)


def test_host_pool_lru_eviction_matches_jax():
    """The reference's host-pool LRU shape (tests/test_kv_offload.py)."""
    out = []
    for Pool in (HostKVPool, JaxHostPool):
        pool = Pool(max_bytes=100)
        pool.put(b"a", b"x" * 40)
        pool.put(b"b", b"y" * 40)
        assert pool.get(b"a") == b"x" * 40
        pool.put(b"c", b"z" * 40)
        assert pool.get(b"b") is None
        assert pool.get(b"a") is not None and pool.get(b"c") is not None
        assert pool.stats()["evictions"] == 1 and pool.chain_evictions == 0
        out.append(pool.stats())
    assert out[0] == out[1]


def test_server_dispatch_matches_jax():
    """The cache server's op handler answers every op as the JAX server's
    does, malformed payloads included."""
    ops = [
        (b"P", b"root", serde.pack_chain(b"", b"p1")),
        (b"P", b"leaf", serde.pack_chain(b"root", b"p2")),
        (b"G", b"leaf", b""), (b"G", b"nope", b""),
        (b"E", b"root", b""), (b"E", b"nope", b""),
        (b"M", b"", pserver.pack_key_list([b"root", b"nope", b"leaf"])),
        (b"I", b"", pserver.pack_key_list([b"leaf", b"zz"])),
        (b"M", b"", b"\x01"), (b"I", b"", b"\x05\x00\x00\x00"),
        (b"H", b"", struct.pack("<II", 4, 64)), (b"H", b"", b"\x01"),
        (b"D", b"nope", b""), (b"X", b"", b""), (b"T", b"", b""),
        (b"D", b"leaf", b""), (b"T", b"", b""),
    ]
    p, j = pserver.PyKVServer(1 << 20), jserver.PyKVServer(1 << 20)
    for op in ops:
        assert p._dispatch(*op) == j._dispatch(*op), op
    doc = json.loads(p._dispatch(b"H", b"", struct.pack("<II", 4, 64))[1])
    assert doc["chains"] == [[b"root".hex()]]
    assert pserver.pack_key_list([b"a", b"bc"]) == \
        jserver.pack_key_list([b"a", b"bc"])
    assert pserver.unpack_key_list(jserver.pack_key_list([b"a", b""])) == \
        [b"a", b""]


# -------------------------------------------------------------------- wire
def _drive_wire(Client, url, tag):
    """Every op through one client: P (chain envelope), G, E, M, I, H, D,
    T; the batched pair costs one round trip each."""
    c = Client(url)
    try:
        root, leaf = f"{tag}-root".encode(), f"{tag}-leaf".encode()
        blob_r = serde.pack_chain(b"", serde.pack_block(*_arrays("int8")[0]))
        blob_l = serde.pack_chain(root, b"leafpayload" * 50)
        assert not c.exists(root)
        assert c.put(root, blob_r) and c.put(leaf, blob_l)
        assert c.exists(root) and c.get(leaf) == blob_l
        assert c.get(b"missing") is None
        rt0 = c.round_trips
        assert c.multi_get([root, b"missing", leaf]) == [blob_r, None, blob_l]
        assert c.index_query([leaf, b"zz", root]) == [True, False, True]
        assert c.round_trips - rt0 == 2
        chains = c.hot_chains(8)
        assert [root, leaf] in chains
        assert c.delete(leaf) and not c.delete(leaf)
        assert not c.exists(leaf)
        assert c.stats()["impl"] == "python"
        assert jserde.unpack_block(serde.unpack_chain(c.get(root))[1])[0] \
            .tobytes() == _arrays("int8")[0][0].tobytes()
    finally:
        c.close()


@pytest.mark.parametrize("pairing", ["jax-client-port-server",
                                     "port-client-jax-server",
                                     "port-client-port-server"])
def test_wire_interop_with_server_processes(server_processes, pairing):
    """Each package's client on the other package's server process (and
    the port's on its own), every op, bit-exact blobs."""
    client, _, srv, _ = pairing.split("-")
    Client = (jremote.RemoteKVClient if client == "jax"
              else remote.RemoteKVClient)
    _drive_wire(Client, server_processes[srv], pairing)
    assert remote.parse_kv_url("kv://h:1") == jremote.parse_kv_url("kv://h:1")
    assert remote.parse_kv_url("h") == jremote.parse_kv_url("h") == \
        ("h", 8200)


class _NoBatchedOps(pserver.PyKVServer):
    """A server that predates 'M', 'I' and 'H' (as the native one does)."""

    def _dispatch(self, op, key, val):
        if op in (b"M", b"I", b"H"):
            return pserver.STATUS_ERROR, b""
        return super()._dispatch(op, key, val)


def test_batched_ops_degrade_to_per_key_ops():
    """Against a server that answers 'M'/'I' with an error, both packages'
    clients fall back to per-key gets and exists, and 'H' yields no
    chains."""
    async def serve(host, port, max_bytes):
        srv = await asyncio.start_server(_NoBatchedOps(max_bytes).handle,
                                         host, port)
        async with srv:
            await srv.serve_forever()

    url, stop = _thread_server(serve)
    try:
        out = []
        for Client in (remote.RemoteKVClient, jremote.RemoteKVClient):
            c = Client(url)
            c.put(b"k1", b"v1")
            rt0 = c.round_trips
            got = (c.multi_get([b"k1", b"nope"]),
                   c.index_query([b"k1", b"nope"]), c.hot_chains(4))
            # one failed 'M', then one get per key; then exists per key
            assert c.round_trips - rt0 == 1 + 2 + 2 + 1
            assert not c._batched_ops_ok
            out.append(got)
            c.close()
        assert out[0] == out[1] == ([b"v1", None], [True, False], [])
    finally:
        stop()


def test_client_reconnects_after_a_dropped_connection():
    """A dead socket is reconnected once per request (a server restart)."""
    url, stop = _thread_server(pserver.serve_python)
    try:
        c = remote.RemoteKVClient(url)
        assert c.put(b"a", b"1")
        c._sock.close()          # as a restarted server leaves it
        assert c.get(b"a") == b"1"
        c.close()
    finally:
        stop()


# ------------------------------------------------------------- block pool
def _pool_ops(Pool):
    """The same bookkeeping on a block pool: prompts, registration, spill
    pins, adoption under known hashes, the digest, a reset."""
    bm = Pool(12, 4)
    tokens = list(range(9))
    blocks, n = bm.allocate_prompt(tokens)
    prev = b""
    hashes = []
    for i in range(2):
        prev = bm.register_full_block(blocks[i], prev,
                                      tokens[i * 4:(i + 1) * 4])
        hashes.append(prev)
    bm.pin_for_spill(blocks[0])
    bm.free_blocks(blocks)
    free_pinned = bm.num_free_blocks
    bm.unpin_for_spill(blocks[0])
    free_unpinned = bm.num_free_blocks
    h1 = _block_hash(b"", list(range(100, 104)))
    h2 = _block_hash(h1, list(range(104, 108)))
    extra = bm.allocate_blocks(2)
    adopted = (bm.adopt_full_block(extra[0], h1, b""),
               bm.adopt_full_block(extra[1], h2, h1),
               bm.adopt_full_block(extra[1], h1, b""))
    bm.free_blocks(extra)
    hit = bm.lookup_prefix(list(range(100, 109)))
    digest = bm.prefix_digest()
    short = bm.prefix_digest(2)
    obs = (n, free_pinned, free_unpinned, adopted, hit, digest, short,
           bm.prefix_index_size, bm.parent_hash(hashes[1]) == hashes[0],
           bm.parent_hash(h2) == h1, bm.contains_hash(h2),
           bm.hash_of_block(extra[1]) == h2,
           bm.lookup_prefix(tokens, seed=b"lora:x"))
    bm.reset_prefix_cache()
    return obs + (bm.prefix_index_size, bm.num_free_blocks,
                  bm.lookup_prefix(tokens))


def test_block_pool_hooks_match_jax():
    """Spill pins keep a block out of the free count, adopted blocks feed
    prefix lookups, the digest and chain parents agree, and ``_block_hash``
    is the reference's (tests/test_elastic.py's adoption shape)."""
    obs = _pool_ops(BlockPoolManager)
    assert obs == _pool_ops(JaxPool)
    n, free_pinned, free_unpinned = obs[:3]
    assert free_pinned == free_unpinned - 1
    assert obs[4][1] == 8 and obs[6][1] is True
    assert _block_hash(b"x", [1, 2, 3]) == jax_block_hash(b"x", [1, 2, 3])


# ------------------------------------------------------------ the manager
class _FakeRunner:
    """Records block writes (the reference test's fake runner)."""

    def __init__(self, quantized=False):
        self.kv_quantized = quantized
        self.writes = []

    def write_blocks(self, blks, k, v, ks=None, vs=None):
        self.writes.append((list(blks), k.tobytes(), v.tobytes(),
                            None if ks is None else ks.tobytes()))

    def read_blocks_retry(self, blks):
        shape = (len(blks),) + BLOCK_SHAPE
        return np.zeros(shape, np.float32), np.zeros(shape, np.float32), \
            None, None


def _chain_blobs(token_ids, bs, key_prefix=b"", quant=False):
    """Store keys and chain-enveloped blobs of every full block, as the
    spill thread writes them."""
    prev, keys, blobs = b"", [], []
    for i in range((len(token_ids) - 1) // bs):
        h = _block_hash(prev, token_ids[i * bs:(i + 1) * bs])
        k = np.full(BLOCK_SHAPE, i + 1, np.int8 if quant else np.float32)
        sc = (np.full(BLOCK_SHAPE[:-1], 0x3F80, np.uint16).view(serde.BF16)
              if quant else None)
        keys.append(key_prefix + h)
        blobs.append(serde.pack_chain(key_prefix + prev if prev else b"",
                                      serde.pack_block(k, -k, sc, sc)))
        prev = h
    return keys, blobs


def _restore_case(case, mgr_mod, pool_cls, url):
    bs = 4
    quant = case == "q8"
    token_ids = list(range(100 + 50 * len(case), 133 + 50 * len(case)))
    runner = _FakeRunner(quantized=quant)
    bm = pool_cls(num_blocks=64, block_size=bs)
    kw = {}
    if case == "declined":
        kw = dict(bytes_per_token=2_000_000, link_gbps=0.1,
                  prefill_tok_s=100_000)
    mgr = mgr_mod.KVOffloadManager(runner, bm, host_pool_bytes=1 << 20,
                                   remote_url=url, **kw)
    try:
        keys, blobs = _chain_blobs(token_ids, bs,
                                   b"q8|" if quant else b"", quant)
        c = remote.RemoteKVClient(url)
        stored = blobs[:3] if case == "partial" else blobs
        for key, blob in zip(keys, stored):
            c.put(key, blob)
        if case == "partial":
            c.put(keys[0], serde.unpack_chain(blobs[0])[1])   # bare PKV1
        if case == "bf16-into-q8":
            # a hand-migrated store: a PKV1 block under a q8| key
            c.put(b"q8|" + keys[0], blobs[0])
            runner.kv_quantized = True
            mgr._kv_quantized, mgr._key_prefix = True, b"q8|"
        c.close()
        rt0 = mgr.remote.round_trips
        restored = mgr.try_restore(token_ids, list(range(1, 10)), 0)
        rts = mgr.remote.round_trips - rt0
        # the same prompt again: the promoted host copies serve it
        rt1 = mgr.remote.round_trips
        again = mgr.try_restore(token_ids, list(range(1, 10)), 0)
        stats = mgr.stats()
        # the port's own failure counters (none here)
        assert stats.pop("spill_failures_total", 0) == 0
        assert stats.pop("restore_failures_total", 0) == 0
        return (restored, rts, again, mgr.remote.round_trips - rt1,
                stats, runner.writes, bm.prefix_hits_total)
    finally:
        mgr.close()


@pytest.mark.parametrize("case", ["full", "partial", "declined", "q8",
                                  "bf16-into-q8"])
def test_manager_restore_matches_jax(case):
    """The reference's restore cases (tests/test_kv_economy.py): 8 remote
    blocks in at most 2 round trips ('I' + 'M'), a chain resident to depth
    3 with a bare PKV1 root, the cost model's refusal, int8 blocks under
    ``q8|`` keys, and a PKV1 blob under a ``q8|`` key, which an int8 pool
    never splices. Both managers on one store give the same restored
    tokens, round trips, counters, block writes and prefix hits."""
    url, stop = _thread_server(pserver.serve_python)
    try:
        got = _restore_case(case, manager, BlockPoolManager, url)
        want = _restore_case(case, jmanager, JaxPool, url)
    finally:
        stop()
    assert got == want
    restored, rts, again, rts_again = got[:4]
    expect = {"full": 32, "partial": 12, "declined": 0, "q8": 32,
              "bf16-into-q8": 0}[case]
    assert restored == expect and rts <= 2
    if expect:
        assert again == expect and rts_again <= 1   # host hits: no 'M'
        assert got[4]["shared_tier_hits_total"] == 2 * expect // 4
    if case == "declined":
        assert got[4]["restore_declined_tokens_total"] == 2 * 32


def test_restore_cost_model_matches_jax():
    grid = [(n, b, g, p, t) for n in (0, 64, 1000) for b in (0, 2048, 2_000_000)
            for g in (0, 0.1, 2.0) for p in (0, 1000, 100_000)
            for t in (None, 0, 16, 1000)]
    for args in grid:
        assert manager.restore_beats_recompute(*args) == \
            jmanager.restore_beats_recompute(*args), args
    assert manager.restore_beats_recompute(1000, 2048, 2.0, 4000)
    assert not manager.restore_beats_recompute(1000, 2_000_000, 0.1, 100_000)


def test_spill_thread_writes_chain_links_and_counts_failures():
    """The spill thread packs registered blocks with their chain parent's
    store key and writes through to the host pool and the remote store;
    with the store down, a spill counts the block it could not put (the
    host copy stays) and a restore returns 0 and counts the failure."""
    url, stop = _thread_server(pserver.serve_python)
    bm = BlockPoolManager(16, 4)
    mgr = manager.KVOffloadManager(_FakeRunner(), bm, host_pool_bytes=1 << 20,
                                   remote_url=url, flush_interval=0.01)
    dead = None
    try:
        tokens = list(range(40, 52))
        blocks, _ = bm.allocate_prompt(tokens)
        prev = b""
        hashes = []
        for i in range(3):
            prev = bm.register_full_block(blocks[i], prev,
                                          tokens[4 * i:4 * i + 4])
            hashes.append(prev)
            mgr.on_block_registered(prev, blocks[i])
        deadline = time.time() + 10
        while mgr.spilled_blocks_total < 3 and time.time() < deadline:
            time.sleep(0.01)
        assert mgr.spilled_blocks_total == 3 and not bm._spill_pinned
        c = remote.RemoteKVClient(url)
        parents = [serde.unpack_chain(c.get(h))[0] for h in hashes]
        assert parents == [b"", hashes[0], hashes[1]]
        assert c.stats()["entries"] == 3
        c.close()
        assert mgr.spill_failures_total == 0
        bm2 = BlockPoolManager(16, 4)
        dead = manager.KVOffloadManager(
            _FakeRunner(), bm2, host_pool_bytes=1 << 20,
            remote_url=f"kv://127.0.0.1:{free_port()}", flush_interval=0.01)
        blocks2, _ = bm2.allocate_prompt(tokens)
        h = bm2.register_full_block(blocks2[0], b"", tokens[:4])
        dead.on_block_registered(h, blocks2[0])
        deadline = time.time() + 10
        while dead.spill_failures_total < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert dead.spill_failures_total == 1
        assert dead.stats()["host_pool"]["entries"] == 1
        assert dead.try_restore(list(range(60, 73)), blocks2, 0) == 0
        assert dead.restore_failures_total == 1
    finally:
        mgr.close()
        if dead is not None:
            dead.close()
        stop()


# --------------------------------------------------------- runner blocks
@pytest.mark.parametrize("kv", ["float32", "bfloat16", "int8"])
def test_runner_block_reads_and_writes_in_place(kv):
    """``write_blocks`` then ``read_blocks`` gives back the written bytes
    (int8 scales too) and leaves every other block alone; the pool tensors
    are written in place (same storage: captured graphs keep reading
    them). An int8 pool refuses a payload without scales."""
    dtype = "bfloat16" if kv == "bfloat16" else "float32"
    cfg = EngineConfig(**{**COMMON, "dtype": dtype}, device="cpu",
                       kv_cache_dtype="int8" if kv == "int8" else "bfloat16")
    r = ModelRunner(cfg, resolve_model_config(MODEL))
    ptrs = [t.data_ptr() for t in r._pools()]
    gen = torch.Generator().manual_seed(3)
    for t in r._pools():
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                  dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=gen).to(t.dtype))
    before = [t.clone() for t in r._pools()]
    src = r.read_blocks([5, 9, 2])
    assert src[0].shape == (3, 2, 2, 16, 128)
    if kv == "int8":
        assert src[2].shape == (3, 2, 2, 16) and src[2].dtype == serde.BF16
    else:
        assert src[2] is None
        assert serde.dtype_name(src[0].dtype) == dtype
    r.write_blocks([7, 11, 40], *src)
    back = r.read_blocks([7, 11, 40])
    for a, b in zip(src, back):
        assert _same_bytes(a, b)
    assert [t.data_ptr() for t in r._pools()] == ptrs
    bs = cfg.block_size
    for t, old in zip(r._pools(), before):
        keep = torch.ones(t.shape[2], dtype=torch.bool)
        for b in (7, 11, 40):
            keep[b * bs:(b + 1) * bs] = False
        assert torch.equal(t[:, :, keep], old[:, :, keep])
    # a blob packs and unpacks to the same bytes on the way
    blob = serde.pack_block(*(a[0] if a is not None else None for a in src))
    for a, b in zip(serde.unpack_block(blob), (a[0] if a is not None else None
                                              for a in src)):
        assert _same_bytes(a, b)
    if kv == "int8":
        with pytest.raises(ValueError, match="per-slot scales"):
            r.write_blocks([3], src[0][:1], src[1][:1])


def test_offload_refused_at_tp_above_one():
    """What the KV tier still refuses, at tp = 1 and at tp = 2 alike: a
    role without the store's URL, and an unknown role (the tier itself is
    served at tp > 1: ``test_kv_tier_accepted_at_tp_above_one``)."""
    for tp in (1, 2):
        model = "tiny-llama-8kv" if tp > 1 else MODEL
        with pytest.raises(ValueError, match="requires kv_remote_url"):
            EngineConfig(model=model, device="cpu", role="prefill",
                         kv_remote_url=None, tensor_parallel_size=tp)
        with pytest.raises(ValueError, match="Unknown engine role"):
            EngineConfig(model=model, device="cpu", role="both",
                         tensor_parallel_size=tp)


def test_kv_tier_accepted_at_tp_above_one():
    """A tp = 2 config with the host tier, the remote tier or a
    prefill/decode role is accepted, and its restore cost model counts
    every kv head (the whole block a blob carries)."""
    url = "kv://127.0.0.1:1"
    for over in (dict(kv_offload_cpu=True), dict(kv_remote_url=url),
                 dict(role="prefill", kv_remote_url=url),
                 dict(role="decode", kv_remote_url=url)):
        cfg = EngineConfig(model="tiny-llama-8kv", device="cpu",
                           tensor_parallel_size=2, **over)
        mc = resolve_model_config(cfg.model)
        assert cfg.kv_wire_bytes_per_token(mc) == \
            2 * cfg.kv_cache_bytes_per_token(mc)


# ------------------------------------------------- engines, both packages
async def _greedy(engine, prompt, n=6, sampling_cls=SamplingParams):
    last = None
    async for out in engine.generate(prompt=prompt, sampling=sampling_cls(
            temperature=0.0, max_tokens=n, ignore_eos=True)):
        last = out
    return last


async def _spilled(engine, n_blocks, timeout=30.0):
    deadline = time.monotonic() + timeout
    while engine.offload.spilled_blocks_total < n_blocks:
        assert time.monotonic() < deadline, "spill did not finish"
        await asyncio.sleep(0.02)


def _prompt_hashes(tokens, bs):
    prev, out = b"", []
    for i in range((len(tokens) - 1) // bs):
        prev = _block_hash(prev, tokens[i * bs:(i + 1) * bs])
        out.append(prev)
    return out


def _pool_block(runner, blk):
    """(k, v, k_scale, v_scale) bytes of one block of an engine's pool
    (either package's runner)."""
    return [None if a is None else a[0].tobytes()
            for a in runner.read_blocks([blk])]


async def _cross_package(src, dst, kv, url, prompt):
    """``src`` package's engine computes the prompt and spills it to the
    store at ``url``, drops its device prefix cache and restores it
    itself; then a fresh ``dst`` engine restores it. Returns the tokens
    and what the store and the destination pool hold."""
    make = {"jax": _jax_engine, "port": _port_engine}
    scls = {"jax": JaxSampling, "port": SamplingParams}
    over = dict(kv_remote_url=url, kv_cache_dtype=kv)
    a = make[src](**over)
    a.offload.flush_interval = 0.02
    await a.start()
    try:
        cold = await _greedy(a, prompt, sampling_cls=scls[src])
        bs = COMMON["block_size"]
        toks = a.tokenizer.encode(prompt)
        hashes = _prompt_hashes(toks, bs)
        await _spilled(a, len(hashes))
        a.block_manager.reset_prefix_cache()
        own = await _greedy(a, prompt, sampling_cls=scls[src])
        assert a.offload.restored_tokens_total == len(hashes) * bs
    finally:
        await a.stop()
    b = make[dst](**over)
    b.offload.flush_interval = 0.02
    await b.start()
    try:
        out = await _greedy(b, prompt, sampling_cls=scls[dst])
        assert b.offload.restored_tokens_total == len(hashes) * bs
        assert out.num_cached_tokens == len(hashes) * bs
        prefix = b"q8|" if kv == "int8" else b""
        c = remote.RemoteKVClient(url)
        blobs = c.multi_get([prefix + h for h in hashes])
        other = c.index_query([(b"" if prefix else b"q8|") + h
                               for h in hashes])
        c.close()
        pools = [_pool_block(b.runner, b.block_manager._hash_to_block[h])
                 for h in hashes]
    finally:
        await b.stop()
        if dst == "port":
            b.shutdown()
    return cold, own, out, blobs, other, pools


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
async def test_prefix_spilled_by_one_package_restores_into_the_other(
        direction, kv):
    """A prefix one package's engine spilled (to the port's cache server)
    restores into the other's engine: every restored block's pool bytes
    equal its blob (PKV1 float32 payload, or PKV2 int8 payload and bf16
    scales under ``q8|`` keys, none under the other namespace), and the
    greedy tokens equal the spilling engine's own restore and its cold
    computation, exactly."""
    src, _, dst = direction.split("-")
    url, stop = _thread_server(pserver.serve_python)
    try:
        prompt = f"a shared prefix of four blocks, spilled by {src} " * 2
        cold, own, out, blobs, other, pools = await _cross_package(
            src, dst, kv, url, prompt)
    finally:
        stop()
    assert out.token_ids == own.token_ids == cold.token_ids
    assert len(out.token_ids) == 6
    assert not any(other)
    for blob, pool in zip(blobs, pools):
        k, v, ks, vs = serde.unpack_block(serde.unpack_chain(blob)[1])
        assert [k.tobytes(), v.tobytes(),
                None if ks is None else ks.tobytes(),
                None if vs is None else vs.tobytes()] == pool
        assert (ks is not None) == (kv == "int8")


def _series_value(text, name):
    return next(float(ln.rsplit(" ", 1)[1]) for ln in text.splitlines()
                if ln.startswith(name + "{"))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
async def test_host_pool_spill_and_restore_matches_jax(kv):
    """The reference's host-tier shape (tests/test_kv_offload.py): a
    prompt served, its blocks spilled to the host pool, the device prefix
    cache dropped, the prompt served again from the restored blocks. Both
    packages restore the same tokens and serve the same greedy tokens, and
    their ``/metrics`` read the same offload, restore and prefix-index
    values."""
    from production_stack_tpu.server.metrics import (
        render_engine_metrics as jax_render,
    )
    from production_stack_tpu_torch.server.metrics import render_engine_metrics

    prompt = "offload shared prefix " * 5
    got = {}
    for side, make, scls in (("port", _port_engine, SamplingParams),
                             ("jax", _jax_engine, JaxSampling)):
        e = make(kv_offload_cpu=True, kv_offload_max_cpu_gb=0.5,
                 kv_cache_dtype=kv)
        e.offload.flush_interval = 0.02
        await e.start()
        try:
            cold = await _greedy(e, prompt, sampling_cls=scls)
            await _spilled(e, e.block_manager.prefix_index_size)
            e.block_manager.reset_prefix_cache()
            again = await _greedy(e, prompt, sampling_cls=scls)
            render = render_engine_metrics if side == "port" else jax_render
            text = render(e, MODEL)
            got[side] = (cold.token_ids, again.token_ids,
                         again.num_cached_tokens,
                         e.offload.restored_tokens_total,
                         *[_series_value(text, f"pstpu:{n}") for n in (
                             "kv_offload_blocks", "kv_restore_saved_tokens_total",
                             "kv_shared_tier_hits_total", "prefix_index_size")])
        finally:
            await e.stop()
            if side == "port":
                e.shutdown()
    assert got["port"] == got["jax"]
    cold, again, cached, restored = got["port"][:4]
    assert again == cold and cached == restored >= 64


async def test_int8_engine_never_splices_a_bf16_store():
    """An int8 port engine on a store that a float32-pool engine filled:
    its ``q8|`` keys miss, and a PKV1 blob copied under a ``q8|`` key (a
    hand-migrated store) is refused; the tokens are those of an int8
    engine without offload."""
    url, stop = _thread_server(pserver.serve_python)
    try:
        prompt = "bf16 blocks must not reach an int8 pool " * 2
        a = _port_engine(kv_remote_url=url)
        a.offload.flush_interval = 0.02
        await a.start()
        await _greedy(a, prompt)
        hashes = _prompt_hashes(a.tokenizer.encode(prompt), 16)
        await _spilled(a, len(hashes))
        await a.stop()
        a.shutdown()
        c = remote.RemoteKVClient(url)
        c.put(b"q8|" + hashes[0], c.get(hashes[0]))
        c.close()
        outs = []
        for over in (dict(kv_remote_url=url), {}):
            e = _port_engine(kv_cache_dtype="int8", **over)
            await e.start()
            outs.append(await _greedy(e, prompt))
            st = e.stats()
            await e.stop()
            e.shutdown()
            assert st["kv_restore_saved_tokens_total"] == 0
            assert st["kv_shared_tier_hits_total"] == 0
        assert outs[0].token_ids == outs[1].token_ids
        assert outs[0].num_cached_tokens == 0
    finally:
        stop()


async def test_prefix_index_answers_as_the_jax_server():
    """After the same requests, ``/prefix_index`` of the port's server and
    the JAX server list the same digests (the port's equal to its block
    manager's ``prefix_digest``); ``max_entries`` truncates alike, and a
    bad value is a 400 on both."""
    jclient = TestClient(TestServer(JaxServer(_jax_engine()).build_app()))
    await jclient.start_server()
    server = OpenAIServer(_port_engine(), port=0)
    await server.start()
    try:
        for prompt in ("the prefix index lists every full block " * 2,
                       "a second prompt with its own blocks " * 2):
            body = {"model": MODEL, "prompt": prompt, "max_tokens": 4,
                    "temperature": 0.0, "ignore_eos": True}
            assert (await jclient.post("/v1/completions", json=body)).status \
                == 200
            st, _, _ = await _http(server.port, "POST", "/v1/completions",
                                   body)
            assert st == 200
        for q in ("", "?max_entries=3"):
            jdoc = await (await jclient.get("/prefix_index" + q)).json()
            st, _, text = await _http(server.port, "GET", "/prefix_index" + q)
            doc = json.loads(text)
            assert st == 200
            assert sorted(doc.pop("entries")) == sorted(jdoc.pop("entries"))
            assert doc == jdoc
        entries, truncated = server.engine.block_manager.prefix_digest()
        st, _, text = await _http(server.port, "GET", "/prefix_index")
        assert json.loads(text)["entries"] == entries and not truncated
        assert len(entries) >= 8
        jst = (await jclient.get("/prefix_index?max_entries=x")).status
        st, _, _ = await _http(server.port, "GET",
                               "/prefix_index?max_entries=x")
        assert st == jst == 400
    finally:
        await jclient.close()
        await server.stop()
        server.engine.shutdown()


async def test_prewarm_end_to_end_answers_as_the_jax_server():
    """A store a port engine filled: a fresh port engine's ``POST
    /prewarm`` adopts the hot chains, and its next request counts them as
    prefix hits (no restore) and gives the cold run's tokens; a fresh JAX
    engine's ``/prewarm`` on the same store reports the same chains and
    blocks. Without a shared tier both answer the same no-op; a bad
    ``top_k`` is a 400 on both."""
    url, stop = _thread_server(pserver.serve_python)
    prompt = "prewarm pulls this chain into the device cache " * 2
    try:
        a = _port_engine(kv_remote_url=url)
        a.offload.flush_interval = 0.02
        await a.start()
        cold = await _greedy(a, prompt)
        # blocks the prompt's hits can use; every registered block spills
        n_full = len(_prompt_hashes(a.tokenizer.encode(prompt), 16))
        n_stored = a.block_manager.prefix_index_size
        await _spilled(a, n_stored)
        await a.stop()
        a.shutdown()
        results = {}
        # the JAX engine first: it only prewarms, and leaves the store as
        # it found it for the port's (which then serves, and spills)
        for side in ("jax", "port"):
            if side == "port":
                srv = OpenAIServer(_port_engine(kv_remote_url=url), port=0)
                await srv.start()
                st, _, text = await _http(srv.port, "POST", "/prewarm",
                                          {"top_k": 4})
                res = json.loads(text)
                eng = srv.engine
                hits0 = eng.block_manager.prefix_hits_total
                out = await _greedy(eng, prompt)
                assert out.token_ids == cold.token_ids
                assert eng.block_manager.prefix_hits_total - hits0 == \
                    n_full * 16
                assert eng.offload.restored_tokens_total == 0
                assert eng.stats()["prewarmed_blocks_total"] == n_stored
                bad, _, _ = await _http(srv.port, "POST", "/prewarm",
                                        {"top_k": 0})
                await srv.stop()
                srv.engine.shutdown()
            else:
                jc = TestClient(TestServer(JaxServer(
                    _jax_engine(kv_remote_url=url)).build_app()))
                await jc.start_server()
                resp = await jc.post("/prewarm", json={"top_k": 4})
                st, res = resp.status, await resp.json()
                bad = (await jc.post("/prewarm", json={"top_k": 0})).status
                await jc.close()
            assert st == 200 and bad == 400
            res.pop("seconds")
            results[side] = res
        assert results["port"] == results["jax"]
        assert results["port"]["blocks"] == n_stored >= n_full
        # no shared tier: the same no-op answer
        srv = OpenAIServer(_port_engine(), port=0)
        await srv.start()
        st, _, text = await _http(srv.port, "POST", "/prewarm", None)
        await srv.stop()
        srv.engine.shutdown()
        jc = TestClient(TestServer(JaxServer(_jax_engine()).build_app()))
        await jc.start_server()
        jres = await (await jc.post("/prewarm")).json()
        await jc.close()
        assert st == 200 and json.loads(text) == jres
    finally:
        stop()
