"""Launch port engines: one ``python -m
production_stack_tpu_torch.server.api_server`` process per engine, each on a
free port, ready once its ``/health`` answers 200.

Counterpart of ``benchmarks/stack.py:launch_stack`` and of
``__graft_entry__.py:entry``. ``--router-args "FLAGS"`` also starts the
port's router (``python -m production_stack_tpu_torch.router.app``, a CPU
process that never touches the card) in front of the engines, with
``--service-discovery static``, the engines' URLs and served model, their
``--roles`` and the cache server's URL filled in, and ``FLAGS`` (the
router's own, e.g. ``--routing-logic session --session-key x-user-id``)
after them:

  python -m production_stack_tpu_torch.launch --model llama-3b \\
      --num-engines 2 --router-args "--routing-logic roundrobin" -- \\
      --max-num-seqs 16

prints ``{"urls": [...], "ready_s": [...], "pids": [...]}`` on one line
(with ``router_url`` and ``router_pid`` when a router runs), then serves
until SIGTERM or SIGINT, which stops the router and drains and stops every
engine. Without a router it also ends when an engine exits; with one, it
serves on while any engine does (the router fails over).
``--kv-server`` first starts the port's Python cache server on loopback
(``kv_offload/server.py``) and points every engine at it
(``--kv-remote-url``; its URL is printed as ``kv_url``); ``--roles
prefill,decode`` gives engine i the i-th role, the disaggregated pair the
router's ``--routing-logic disagg`` drives, and ``--tensor-parallel-sizes
2,1`` engine i the i-th ``--tensor-parallel-size`` (a tp = 2 prefill engine
handing off to a tp = 1 decode engine: blocks move whole, every kv head,
whatever either side's tp). Arguments after ``--`` go to
every engine's server as they are, e.g. ``--speculative-num-tokens 4
--speculative-model llama-3b`` for speculative decoding, or
``--lora-modules NAME=PATH ...`` for PEFT adapters, or
``--compilation-cache-dir DIR`` (engines of one configuration share its
warm-up manifest) and ``--no-overlap-weight-load``. ``--model`` may be a
local HuggingFace checkpoint directory; engines run in the launcher's
working directory, so relative paths resolve as they do here:

  python -m production_stack_tpu_torch.launch --model ./ckpt -- \\
      --lora-modules a=./adapters/a b=./adapters/b
"""

import argparse
import json
import os
import shlex
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import List, Optional

# The directory holding the package: engine processes import it from there
# whether or not the package is installed.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _healthy(url: str) -> bool:
    try:
        with urllib.request.urlopen(url + "/health", timeout=2) as r:
            return r.status == 200
    except (urllib.error.URLError, ConnectionError, OSError):
        return False


@dataclass
class EngineHandle:
    """Running engines: their URLs, spawn-to-healthy seconds, the exact
    argv of each (a relaunch reuses it), processes and log files."""
    urls: List[str]
    ready_seconds: List[float]
    argvs: List[List[str]]
    procs: List[subprocess.Popen] = field(repr=False)
    log_paths: List[str] = field(default_factory=list)

    def stop(self, timeout_s: float = 60.0) -> List[int]:
        """SIGTERM every engine (each drains), then wait; an engine still
        up at ``timeout_s`` is killed. Returns the exit codes."""
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        codes = []
        deadline = time.monotonic() + timeout_s
        for p in self.procs:
            try:
                codes.append(p.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
        return codes


def _child_env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [_PKG_PARENT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                         if p])
    return env


@dataclass
class KVServerHandle:
    """A running cache server: its ``kv://`` URL, process and log."""
    url: str
    port: int
    proc: subprocess.Popen = field(repr=False)
    log_path: str = ""

    def stop(self, timeout_s: float = 10.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def launch_kv_server(max_bytes: int = 8 << 30, log_dir: Optional[str] = None,
                     startup_timeout_s: float = 60.0,
                     force_python: bool = False) -> KVServerHandle:
    """Start the port's cache server (``python -m
    production_stack_tpu_torch.kv_offload.server``) on a free port and wait
    until it accepts connections: the native core where one is built, the
    Python server when there is none or ``force_python`` (its batched ops,
    prewarm and the disagg lease need it). The Python server binds the
    loopback address alone; the native core takes no host and binds every
    interface, so ask for ``force_python`` where the store must not be
    reachable from other hosts."""
    from production_stack_tpu_torch.kv_offload.server import find_native_binary

    log_dir = log_dir or tempfile.mkdtemp(prefix="pstpu-torch-kv-")
    os.makedirs(log_dir, exist_ok=True)
    port = free_port()
    path = os.path.join(log_dir, f"kv-server-{port}.log")
    native = not force_python and bool(find_native_binary())
    with open(path, "wb") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "production_stack_tpu_torch.kv_offload.server",
             "--port", str(port), "--max-bytes", str(max_bytes)]
            + ([] if native else ["--force-python", "--host", "127.0.0.1"]),
            stdout=log, stderr=subprocess.STDOUT, env=_child_env())
    handle = KVServerHandle(f"kv://127.0.0.1:{port}", port, proc, path)
    deadline = time.monotonic() + startup_timeout_s
    while True:
        try:
            socket.create_connection(("127.0.0.1", port), 0.5).close()
            return handle
        except OSError:
            if proc.poll() is not None or time.monotonic() > deadline:
                handle.stop()
                raise RuntimeError(f"kv server on port {port} did not "
                                   f"start; log: {path}")
            time.sleep(0.1)


def launch_engines(model: str, num_engines: int = 1,
                   engine_args: Optional[List[str]] = None,
                   device: str = "cuda", log_dir: Optional[str] = None,
                   startup_timeout_s: float = 1800.0,
                   per_engine_args: Optional[List[List[str]]] = None,
                   ) -> EngineHandle:
    """Start ``num_engines`` port engines serving ``model`` on ``device``
    (extra server flags in ``engine_args``, and engine i's own in
    ``per_engine_args[i]``, e.g. ``["--role", "prefill"]``), each on a
    free port, and wait until every ``/health`` answers 200. Logs go to
    ``log_dir`` (a fresh temporary directory by default). An engine that
    exits or is not healthy within ``startup_timeout_s`` stops them all
    and raises."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="pstpu-torch-engines-")
    os.makedirs(log_dir, exist_ok=True)
    env = _child_env()
    procs, argvs, urls, logs, ready = [], [], [], [], []
    t0 = time.monotonic()
    handle = EngineHandle(urls, ready, argvs, procs, logs)
    try:
        for i in range(num_engines):
            port = free_port()
            argv = [sys.executable, "-m",
                    "production_stack_tpu_torch.server.api_server",
                    "--model", model, "--device", device,
                    "--host", "127.0.0.1", "--port", str(port),
                    *(engine_args or []),
                    *(per_engine_args[i] if per_engine_args else [])]
            path = os.path.join(log_dir, f"engine-{i}-{port}.log")
            with open(path, "wb") as log:
                procs.append(subprocess.Popen(argv, stdout=log,
                                              stderr=subprocess.STDOUT,
                                              env=env))
            argvs.append(argv)
            urls.append(f"http://127.0.0.1:{port}")
            logs.append(path)
        for proc, url, path in zip(procs, urls, logs):
            while not _healthy(url):
                if proc.poll() is not None:
                    raise RuntimeError(f"engine {url} exited with "
                                       f"{proc.returncode}; log: {path}")
                if time.monotonic() - t0 > startup_timeout_s:
                    raise RuntimeError(f"engine {url} not healthy after "
                                       f"{startup_timeout_s:.0f} s; log: {path}")
                time.sleep(0.2)
            ready.append(time.monotonic() - t0)
    except BaseException:
        handle.stop(timeout_s=10.0)
        raise
    return handle


@dataclass
class RouterHandle:
    """A running router: its URL, process and log."""
    url: str
    proc: subprocess.Popen = field(repr=False)
    log_path: str = ""

    def stop(self, timeout_s: float = 10.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()


def launch_router(backends: List[str], models: List[str],
                  router_args: Optional[List[str]] = None,
                  log_dir: Optional[str] = None,
                  startup_timeout_s: float = 120.0) -> RouterHandle:
    """Start the port's router (``python -m
    production_stack_tpu_torch.router.app``) on a free loopback port with
    static discovery of ``backends`` serving ``models`` (one name for all,
    or one per backend) and the router flags ``router_args``; wait until
    its ``/health`` answers 200."""
    log_dir = log_dir or tempfile.mkdtemp(prefix="pstpu-torch-router-")
    os.makedirs(log_dir, exist_ok=True)
    port = free_port()
    path = os.path.join(log_dir, f"router-{port}.log")
    argv = [sys.executable, "-m", "production_stack_tpu_torch.router.app",
            "--host", "127.0.0.1", "--port", str(port),
            "--service-discovery", "static",
            "--static-backends", ",".join(backends),
            "--static-models", ",".join(models), *(router_args or [])]
    with open(path, "wb") as log:
        proc = subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                env=_child_env())
    handle = RouterHandle(f"http://127.0.0.1:{port}", proc, path)
    deadline = time.monotonic() + startup_timeout_s
    while not _healthy(handle.url):
        if proc.poll() is not None or time.monotonic() > deadline:
            handle.stop()
            raise RuntimeError(f"router on port {port} did not start "
                               f"(exit {proc.poll()}); log: {path}")
        time.sleep(0.1)
    return handle


def _served_name(model: str, extra: List[str]) -> str:
    """The model name the engines serve (``--served-model-name``, else
    ``--model``)."""
    for i, a in enumerate(extra):
        if a == "--served-model-name" and i + 1 < len(extra):
            return extra[i + 1]
        if a.startswith("--served-model-name="):
            return a.split("=", 1)[1]
    return model


def entry(device: str = "cuda"):
    """(fn, example_args) of the decode train at ``tiny-llama``: fn runs one
    fused 4-step decode dispatch of 4 rows (head, 4 steps, tail) over the
    packed int32 buffer the engine stages (every row starts at position 0
    with token 1, writes block 1, greedy)."""
    import functools

    import numpy as np
    import torch

    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.decode_graphs import NUM_SCALARS
    from production_stack_tpu_torch.engine.runner import ModelRunner
    from production_stack_tpu_torch.models.config import resolve_model_config

    cfg = EngineConfig(model="tiny-llama", device=device, max_model_len=256,
                       num_kv_blocks=64, max_num_seqs=8,
                       max_num_batched_tokens=64)
    runner = ModelRunner(cfg, resolve_model_config(cfg.model))
    b, k = 4, 4
    mb = runner._decode_mb(1)
    key = (b, mb, k, False, 0, False)
    bf = runner.decode_train.buffers(*key)
    packed = np.zeros((NUM_SCALARS * b + b * mb,), np.int32)
    sc = packed[:NUM_SCALARS * b].reshape(NUM_SCALARS, b)
    sc[0, :] = 1                        # tokens0
    sc[2, :] = k                        # step budget
    sc[6, :] = -1                       # top_k off
    sc.view(np.float32)[7, :] = 1.0     # top_p
    sc[11, :] = -1                      # start tokens from the host
    packed[NUM_SCALARS * b:].reshape(b, mb)[:, 0] = 1
    bf.packed.copy_(torch.from_numpy(packed))
    return functools.partial(runner.decode_train.run, key), (bf, k)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    extra: List[str] = []
    if "--" in argv:
        i = argv.index("--")
        argv, extra = argv[:i], argv[i + 1:]
    p = argparse.ArgumentParser(description="Launch port engines")
    p.add_argument("--model", default="llama-3b")
    p.add_argument("--num-engines", type=int, default=1)
    p.add_argument("--device", default="cuda")
    p.add_argument("--log-dir", default=None)
    p.add_argument("--startup-timeout", type=float, default=1800.0)
    p.add_argument("--kv-server", action="store_true",
                   help="start the port's Python cache server on loopback "
                        "and pass its URL to every engine as --kv-remote-url")
    p.add_argument("--roles", default=None,
                   help="comma list, one disagg role per engine "
                        "(unified, prefill, decode)")
    p.add_argument("--tensor-parallel-sizes", default=None,
                   help="comma list, one --tensor-parallel-size per engine "
                        "(e.g. 2,1 with --roles prefill,decode)")
    p.add_argument("--router-args", default=None,
                   help="start the port's router in front of the engines, "
                        "with these router flags (one string; \"\" for "
                        "the defaults)")
    args = p.parse_args(argv)
    per_engine = None
    for name, flag, value in (
            ("--roles", "--role", args.roles),
            ("--tensor-parallel-sizes", "--tensor-parallel-size",
             args.tensor_parallel_sizes)):
        if not value:
            continue
        values = value.split(",")
        if len(values) != args.num_engines:
            p.error(f"{name} names {len(values)} values for "
                    f"{args.num_engines} engines")
        per_engine = [(per_engine[i] if per_engine else []) + [flag, v]
                      for i, v in enumerate(values)]
    kv = None
    if args.kv_server:
        # The disaggregated pair's lease needs the Python server, which
        # binds loopback alone (the reference's stack launcher pins it).
        kv = launch_kv_server(log_dir=args.log_dir, force_python=True)
        extra = ["--kv-remote-url", kv.url, *extra]
    router, handle = None, None
    try:
        handle = launch_engines(args.model, args.num_engines, extra,
                                args.device, args.log_dir,
                                args.startup_timeout, per_engine)
        if args.router_args is not None:
            rargs = shlex.split(args.router_args)
            if args.roles and "--static-backend-roles" not in rargs:
                rargs = ["--static-backend-roles", args.roles, *rargs]
            if kv is not None and "--kv-offload-url" not in rargs and \
                    "disagg" in rargs:
                rargs = ["--kv-offload-url", kv.url, *rargs]
            router = launch_router(handle.urls,
                                   [_served_name(args.model, extra)], rargs,
                                   args.log_dir)
    except BaseException:
        if handle is not None:
            handle.stop(timeout_s=10.0)
        if kv is not None:
            kv.stop()
        raise
    print(json.dumps({"urls": handle.urls, "ready_s": handle.ready_seconds,
                      "pids": [pr.pid for pr in handle.procs],
                      "logs": handle.log_paths,
                      **({"kv_url": kv.url} if kv else {}),
                      **({"router_url": router.url, "router_pid": router.proc.pid,
                          "router_log": router.log_path} if router else {})}),
          flush=True)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())

    def serving() -> bool:
        alive = [pr.poll() is None for pr in handle.procs]
        if router is None:
            return all(alive)
        return router.proc.poll() is None and any(alive)

    while not stop.is_set() and serving():
        stop.wait(1.0)
    if router is not None:
        router.stop()
    handle.stop()
    if kv is not None:
        kv.stop()


if __name__ == "__main__":
    main()
