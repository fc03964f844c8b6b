"""The native cache-server core (``native/kv_server.cpp``) behind the port's
server (``production_stack_tpu_torch/kv_offload/server.py``).

The binary is built with the Makefile's recipe into a temporary directory
(never into the checkout). The server's entry point runs with
``find_native_binary`` patched, so a ``native/build`` in the checkout
cannot sway which core serves. The native core answers the batched
multi-get ('M') with STATUS_ERROR, which tells it apart from the Python
server. A port engine on the CPU spills a prompt's blocks through the
native core and a fresh engine restores them: the tokens equal a cold
recompute's, and the stored blobs equal what the Python server stores for
the same prompt, byte for byte.
"""

import os
import select
import signal
import socket
import subprocess
import sys
import time

import pytest

import chip_smoke
from production_stack_tpu_torch.kv_offload import server as pserver
from production_stack_tpu_torch.kv_offload.remote import RemoteKVClient
from production_stack_tpu_torch.kv_offload.server import (
    STATUS_ERROR,
    STATUS_OK,
    pack_key_list,
)
from tests.test_torch_kv_offload import _greedy, _prompt_hashes, _spilled
from tests.test_torch_surface import COMMON, _port_engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def native_binary(tmp_path_factory):
    build = tmp_path_factory.mktemp("native-build")
    path, _, _ = chip_smoke.build_native_kv_server(str(build))
    assert path.startswith(str(build))
    return path


def _start(binary, *flags, tmp_path, host=None):
    """The port's server entry point with ``find_native_binary`` answering
    ``binary`` ("" = none found): (process, its announce line, the stderr
    file). The Python server binds loopback; the native core takes no host
    unless ``host`` names one."""
    code = ("import sys\n"
            "from production_stack_tpu_torch.kv_offload import server as s\n"
            f"s.find_native_binary = lambda: {binary!r}\n"
            "sys.exit(s.main(sys.argv[1:]))\n")
    if host is None and (not binary or "--force-python" in flags):
        host = "127.0.0.1"
    err = open(tmp_path / f"server-{time.monotonic_ns()}.err", "w+")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, *(["--host", host] if host else []),
         "--max-bytes", str(1 << 24), *flags],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stdout=subprocess.PIPE, stderr=err, text=True)
    line = ""
    if select.select([proc.stdout], [], [], 60)[0]:
        line = proc.stdout.readline()
    return proc, line, err


def _stop(proc) -> int:
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        return proc.wait(30)
    finally:
        if proc.poll() is None:
            proc.kill()


def _url(line: str) -> str:
    assert line.startswith("kv_server listening on "), line
    port = int(line.rsplit(":", 1)[1])
    assert port > 0
    return f"kv://127.0.0.1:{port}"


def _multi_get_status(url) -> int:
    c = RemoteKVClient(url)
    try:
        status, _ = c._request(b"M", b"", pack_key_list([b"k"]))
        return status
    finally:
        c.close()


def test_the_server_runs_the_native_core_when_found(native_binary, tmp_path):
    """Found and not forced: the binary serves, ``--port 0`` announces a
    real port it accepts on, 'M' answers STATUS_ERROR, a put and get go
    through, and the server's exit code is the binary's (ended by the
    SIGINT the server passes on)."""
    proc, line, _ = _start(native_binary, "--port", "0", tmp_path=tmp_path)
    try:
        url = _url(line)
        assert _multi_get_status(url) == STATUS_ERROR
        c = RemoteKVClient(url)
        assert c.put(b"key", b"blob") and c.get(b"key") == b"blob"
        assert "impl" not in c.stats()
        c.close()
    finally:
        rc = _stop(proc)
    assert rc == 128 + signal.SIGINT


@pytest.mark.parametrize("how", ["forced", "absent"])
def test_force_python_or_no_binary_gives_the_python_server(
        native_binary, tmp_path, how):
    binary = native_binary if how == "forced" else ""
    flags = ["--port", "0"] + (["--force-python"] if how == "forced" else [])
    proc, line, err = _start(binary, *flags, tmp_path=tmp_path)
    try:
        url = _url(line)
        assert _multi_get_status(url) == STATUS_OK
        c = RemoteKVClient(url)
        assert c.stats()["impl"] == "python"
        c.close()
    finally:
        assert _stop(proc) == 0
    err.seek(0)
    warned = "Native kv_server binary not found" in err.read()
    assert warned == (how == "absent")


def test_a_native_core_that_fails_fails_the_server(tmp_path):
    """A binary that exits before it accepts connections: the server exits
    with its code and announces nothing; nothing falls back to Python."""
    fake = tmp_path / "kv_server"
    fake.write_text("#!/bin/sh\nexit 7\n")
    fake.chmod(0o755)
    proc, line, _ = _start(str(fake), "--port", "0", tmp_path=tmp_path)
    assert line == ""
    assert proc.wait(30) == 7


def test_find_native_binary_takes_kv_server_on_path(native_binary,
                                                    monkeypatch):
    """The checkout's ``native/build/kv_server`` first (when built), then
    ``kv_server`` on PATH."""
    checkout = os.path.join(REPO, "native", "build", "kv_server")
    monkeypatch.setenv("PATH", os.path.dirname(native_binary))
    want = checkout if os.access(checkout, os.X_OK) else native_binary
    assert pserver.find_native_binary() == want
    monkeypatch.setenv("PATH", "")
    want = checkout if os.access(checkout, os.X_OK) else ""
    assert pserver.find_native_binary() == want


async def _spill_and_restore(url, prompt):
    """A port engine computes the prompt and spills its full blocks to the
    store at ``url``; a fresh engine restores them. Returns the cold
    tokens, the restored tokens, the restored token count and the stored
    blobs."""
    bs = COMMON["block_size"]
    a = _port_engine(kv_remote_url=url)
    a.offload.flush_interval = 0.02
    await a.start()
    try:
        cold = await _greedy(a, prompt)
        hashes = _prompt_hashes(a.tokenizer.encode(prompt), bs)
        await _spilled(a, len(hashes))
    finally:
        await a.stop()
        a.shutdown()
    b = _port_engine(kv_remote_url=url)
    await b.start()
    try:
        out = await _greedy(b, prompt)
        restored = b.offload.restored_tokens_total
    finally:
        await b.stop()
        b.shutdown()
    c = RemoteKVClient(url)
    blobs = [c.get(h) for h in hashes]
    c.close()
    return cold.token_ids, out.token_ids, restored, len(hashes) * bs, blobs


async def test_a_port_engine_restores_through_the_native_core(native_binary,
                                                              tmp_path):
    """Spill and restore through the native core: the restored tokens
    equal the cold recompute's (float32 over the same bytes), every block
    restored, and the stored blobs equal the Python server's for the same
    prompt byte for byte."""
    prompt = "a prefix spilled through the native cache-server core " * 2
    got = {}
    for name, binary in (("native", native_binary), ("python", "")):
        proc, line, _ = _start(binary, "--port", "0", tmp_path=tmp_path)
        try:
            url = _url(line)
            assert (_multi_get_status(url) == STATUS_ERROR) == \
                (name == "native")
            got[name] = await _spill_and_restore(url, prompt)
        finally:
            _stop(proc)
    cold, restored, n_restored, n_blocks, blobs = got["native"]
    assert restored == cold and len(cold) == 6
    assert n_restored == n_blocks >= 4 * COMMON["block_size"]
    assert all(b is not None for b in blobs)
    assert got["python"][:4] == got["native"][:4]
    assert got["python"][4] == blobs


def test_a_named_host_fails_the_native_core(native_binary, tmp_path):
    """The native core binds every interface, so a ``--host`` naming one
    address fails the server (exit 2, no announce line, nothing started)
    instead of exposing the store beyond it; with ``--force-python`` the
    Python server serves on that address."""
    proc, line, err = _start(native_binary, "--port", "0",
                             tmp_path=tmp_path, host="127.0.0.1")
    try:
        assert proc.wait(30) == 2
    finally:
        _stop(proc)
    assert line == ""
    err.seek(0)
    assert "--force-python" in err.read()
    proc, line, _ = _start(native_binary, "--port", "0", "--force-python",
                           tmp_path=tmp_path, host="127.0.0.1")
    try:
        assert line.startswith("kv_server listening on 127.0.0.1:")
        assert _multi_get_status(_url(line)) == STATUS_OK
    finally:
        _stop(proc)


def test_launch_kv_server_forces_python_on_request(native_binary, monkeypatch):
    """``launch_kv_server(force_python=True)`` passes ``--force-python``: with
    a binary on PATH, the default start runs it and the forced one does
    not."""
    from production_stack_tpu_torch.launch import launch_kv_server

    monkeypatch.setenv("PATH", os.path.dirname(native_binary) + os.pathsep
                       + os.environ.get("PATH", ""))
    for force in (True, False):
        h = launch_kv_server(max_bytes=1 << 24, force_python=force)
        try:
            socket.create_connection(("127.0.0.1", h.port), 5).close()
            assert (_multi_get_status(h.url) == STATUS_ERROR) == (not force)
        finally:
            h.stop()


def test_native_core_is_told_apart_by_the_smoke(native_binary, tmp_path):
    """``chip_smoke.is_native_core``, the smoke's check of which core
    serves, on both servers."""
    for binary, native in ((native_binary, True), ("", False)):
        proc, line, _ = _start(binary, "--port", "0", tmp_path=tmp_path)
        try:
            assert chip_smoke.is_native_core(_url(line)) is native
        finally:
            _stop(proc)

