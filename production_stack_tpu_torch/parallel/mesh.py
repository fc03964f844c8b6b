"""The tensor-parallel group: one process per tp rank.

Counterpart of ``production_stack_tpu/parallel/mesh.py``. The JAX package
lays one ``Mesh`` with axes ("dp", "sp", "tp") over the devices of one
process and lets XLA insert the collectives. The port runs one process per
tp rank (the "dp" and "sp" axes are not ported): rank 0 is the engine
process (scheduler, engine loop, HTTP server) and starts ranks 1..tp-1 as
worker processes (``parallel/worker.py``), which execute exactly the
dispatches rank 0 describes, in the same order.

Backend, a rule (logged, and reported by ``ServingEngine.stats()`` as
``tp_backend``), never a recovery from a failed init:
  * ``nccl`` when every rank has a card of its own
    (``torch.cuda.device_count() >= tp``; rank r on ``cuda:r``);
  * ``gloo`` when ranks share a card (NCCL refuses two ranks on one
    device), with CUDA tensors staged through pinned host memory, and in
    every CPU run.

Two groups: the compute group (the default group, on that backend) carries
the model's collectives and the KV tier's block exchange; a separate gloo
group carries the dispatch descriptors rank 0 broadcasts (CPU int tensors)
and the few control messages (pool agreement, rank reports).

Block I/O (the offload tier, ``/prewarm``, the prefill/decode handoff) reads
and writes whole logical blocks, every kv head: a ``KV_READ`` descriptor
makes every rank select its heads of the named blocks and gather them to
rank 0 (``gather_to_root``), which joins them in rank order; a ``KV_WRITE``
makes rank 0 scatter each rank its heads (``scatter_from_root``) and every
rank write them into its pool (the head ranges are ``sharding.py``'s). Both move raw bits (bf16 as 16 bits, int8 as
is) in chunks of at most ``BLOCK_IO_CHUNK_BYTES`` per rank, through their
own staging buffers (tags ``kvio-*``), so a large read leaves no large
pinned buffer behind the decode path's small ones. Every collective carries the
group's timeout, so a lost rank is an error within it, never a hang. Rank
0 sends an empty descriptor after ``timeout / 4`` without one, so an idle
worker's wait for the next descriptor stays inside the timeout.

``all_reduce`` is an all-gather of the partial sums, then their float32
sum in rank order, rounded once to the input dtype, on every rank: the
result is bit-identical on every rank by construction (replicated
activations and replicated sampling rest on that) and does not depend on
a library's reduction order.
"""

import ctypes
import datetime
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

AXIS_TP = "tp"

# Descriptor kinds (entry 0 of a descriptor header) and the header length.
# EMBED is the embedding forward (/v1/embeddings, /rerank): no KV pool, no
# dispatch number. KV_READ and KV_WRITE are block I/O: (kind, blocks,
# whether int8 scales follow, blocks per collective), then the block ids;
# no dispatch number.
NOOP, DECODE, PREFILL, QUERY, STOP, EMBED, KV_READ, KV_WRITE = range(8)
HEADER_LEN = 12

# Bytes of one rank's slice that one block-exchange collective moves at
# most: the size of block I/O's staging buffers, whatever the batch.
BLOCK_IO_CHUNK_BYTES = 32 << 20

# The directory that holds the package: a worker process imports it from
# there whether or not the package is installed.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def tp_backend(device: torch.device, tp: int) -> str:
    """``nccl`` when each of the ``tp`` ranks has a card of its own, else
    ``gloo`` (ranks sharing one card, or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= tp:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, tp: int) -> torch.device:
    """Rank r's device: ``cuda:r`` when each rank has a card of its own,
    else the one card (or the CPU) every rank shares."""
    if device.type != "cuda":
        return device
    if torch.cuda.device_count() >= tp:
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def ranks_per_device(device: torch.device, tp: int) -> int:
    """How many ranks share ``device``'s memory."""
    if device.type == "cuda" and torch.cuda.device_count() < tp:
        return tp
    return 1


def die_with_parent(parent_pid: int) -> None:
    """Ask Linux to kill this process when its parent exits (prctl
    PR_SET_PDEATHSIG), and exit now if it already has."""
    if sys.platform.startswith("linux"):
        try:
            ctypes.CDLL("libc.so.6", use_errno=True).prctl(1, signal.SIGKILL)
        except (OSError, AttributeError):
            pass
    if os.getppid() != parent_pid:
        os._exit(1)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives move it: bf16 as its raw 16 bits."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def rank_order_sum(parts, dtype: torch.dtype) -> torch.Tensor:
    """The float32 sum of ``parts`` (one per rank) in rank order, rounded
    once to ``dtype``: the all-reduce's arithmetic."""
    acc = parts[0].float()
    for p in parts[1:]:
        acc = acc + p.float()
    return acc.to(dtype)


class TPGroup:
    """This process's rank of a tensor-parallel group (see the module
    docstring). Rank 0 owns the worker processes (``procs``)."""

    def __init__(self, rank: int, size: int, device: torch.device,
                 timeout_s: float, store, procs=()):
        if dist.is_initialized():
            raise RuntimeError(
                "a tensor-parallel group is already running in this process "
                "(one engine with tensor_parallel_size > 1 per process)")
        self.rank, self.size, self.device = rank, size, device
        self.backend = tp_backend(device, size)
        self.timeout_s = timeout_s
        self.procs: List[subprocess.Popen] = list(procs)
        self._store = store
        timeout = datetime.timedelta(seconds=timeout_s)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(self.backend, store=store, rank=rank,
                                world_size=size, timeout=timeout)
        self._cpu = dist.new_group(backend="gloo", timeout=timeout)
        # Held by rank 0 around each descriptor and the device work it
        # describes, so the heartbeat's empty descriptor never lands inside
        # a dispatch.
        self.lock = threading.RLock()
        self._staging: Dict = {}
        self._last_send = time.monotonic()
        self._closed = False
        # Set once a collective or a heartbeat failed: the group is lost.
        self.error: Optional[str] = None
        # Host seconds inside compute collectives (staging included), and
        # inside block I/O's gathers and scatters.
        self.collective_seconds = 0.0
        self.block_io_seconds = 0.0
        self._stop_beat = threading.Event()
        self._beat = None
        if rank == 0 and size > 1:
            self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                          name="tp-heartbeat")
            self._beat.start()
        logger.info(
            "tp rank %d of %d on %s: backend %s (%s)", rank, size, device,
            self.backend,
            "each rank has a card of its own" if self.backend == "nccl"
            else "ranks share one card: CUDA tensors staged through pinned "
                 "host memory" if device.type == "cuda" else "CPU ranks")

    # ------------------------------------------------------------ start
    @classmethod
    def launch(cls, tp: int, device: torch.device, timeout_s: float,
               worker_argv: Callable[[int, int], List[str]]) -> "TPGroup":
        """Rank 0: open a rendezvous store on a free port, start ranks
        1..tp-1 as ``worker_argv(rank, port)`` and join them."""
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", 0, tp, True, timeout=timeout,
                              wait_for_workers=False)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
        procs: List[subprocess.Popen] = []
        try:
            for r in range(1, tp):
                procs.append(subprocess.Popen(worker_argv(r, store.port),
                                              env=env))
            deadline = time.monotonic() + timeout_s
            for r, p in enumerate(procs, 1):
                while not store.check([f"ready/{r}"]):
                    if p.poll() is not None:
                        raise RuntimeError(
                            f"tp rank {r} exited with code {p.returncode} "
                            "before joining the group")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"tp rank {r} did not join within {timeout_s} s")
                    time.sleep(0.02)
            return cls(0, tp, rank_device(device, 0, tp), timeout_s, store,
                       procs)
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise

    @classmethod
    def join(cls, rank: int, tp: int, port: int, device: torch.device,
             timeout_s: float) -> "TPGroup":
        """Ranks 1..tp-1: join rank 0's rendezvous on ``port``."""
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, tp, False, timeout=timeout)
        store.set(f"ready/{rank}", "1")
        return cls(rank, tp, rank_device(device, rank, tp), timeout_s, store)

    # ------------------------------------------------- compute collectives
    def _buffer(self, tag: str, numel: int, dtype) -> torch.Tensor:
        """A host staging buffer of at least ``numel`` elements (pinned
        when this rank runs on a card)."""
        buf = self._staging.get((tag, dtype))
        if buf is None or buf.numel() < numel:
            buf = torch.empty((max(numel, 1 << 16),), dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._staging[(tag, dtype)] = buf
        return buf[:numel]

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's ``x`` in rank order, on x's
        device. bf16 travels as its raw 16 bits (a gather only copies)."""
        t0 = time.perf_counter()
        x = x.contiguous()
        wire = _wire(x)
        shape = (self.size,) + tuple(wire.shape)
        stage = self.backend == "gloo" and x.is_cuda
        if stage:
            # Waits for this rank's queued device work.
            with record_function("tp.stage_d2h"):
                src = self._buffer("in", wire.numel(), wire.dtype).view(wire.shape)
                src.copy_(wire)
            out = self._buffer("out", self.size * wire.numel(),
                               wire.dtype).view(shape)
        else:
            src = wire
            out = torch.empty(shape, dtype=wire.dtype, device=x.device)
        try:
            # Waits for the other ranks to arrive.
            with record_function("tp.exchange"):
                dist.all_gather(list(out.unbind(0)), src)
        except Exception as e:
            self.error = f"tp collective failed on rank {self.rank}: {e}"
            raise
        if stage:
            with record_function("tp.stage_h2d"):
                out = out.to(x.device)   # synchronous: the buffer is reused
        self.collective_seconds += time.perf_counter() - t0
        return out.view(x.dtype) if wire is not x else out

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        with record_function("tp.all_gather"):
            return torch.cat(self._gather(x).unbind(0), dim=dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``: float32 in rank order, rounded
        once to x's dtype; bit-identical on every rank."""
        with record_function("tp.all_reduce"):
            return rank_order_sum(self._gather(x).unbind(0), x.dtype)

    # ------------------------------------------------------- block I/O
    @staticmethod
    def block_chunk(row_bytes: int) -> int:
        """Blocks per block-exchange collective when one block of one
        rank's slice is ``row_bytes``."""
        return max(1, BLOCK_IO_CHUNK_BYTES // max(1, row_bytes))

    def mark_lost(self, what: str, e: Exception) -> None:
        """Record that ``what`` failed on this rank: the group is lost."""
        self.error = self.error or f"tp {what} failed on rank {self.rank}: {e}"

    def gather_to_root(self, x: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank: send ``x`` (a chunk of its blocks, on its device) to
        rank 0, which gets every rank's tensor in rank order as host
        tensors (views of a staging buffer: valid until the next block
        exchange); None on the other ranks."""
        t0 = time.perf_counter()
        x = x.contiguous()
        wire = _wire(x)
        nccl = self.backend == "nccl"
        if x.is_cuda and not nccl:
            # Waits for this rank's queued device work (the selection).
            src = self._buffer("kvio-in", wire.numel(),
                               wire.dtype).view(wire.shape)
            src.copy_(wire)
        else:
            src = wire
        parts = None
        if self.rank == 0:
            if nccl:
                parts = [torch.empty_like(wire) for _ in range(self.size)]
            else:
                parts = list(self._buffer(
                    "kvio-out", self.size * wire.numel(), wire.dtype
                ).view((self.size,) + tuple(wire.shape)).unbind(0))
        try:
            with record_function("tp.block_gather"):
                dist.gather(src, parts, dst=0)
        except Exception as e:
            self.mark_lost("block gather", e)
            raise
        if parts is not None:
            parts = [p.view(x.dtype).cpu() if nccl else p.view(x.dtype)
                     for p in parts]
        self.block_io_seconds += time.perf_counter() - t0
        return parts

    def scatter_from_root(self, parts: Optional[List[torch.Tensor]], shape,
                          dtype: torch.dtype) -> torch.Tensor:
        """Every rank: receive its tensor of rank 0's host tensors
        ``parts`` (one per rank in rank order, each ``shape`` and
        ``dtype``; None on the other ranks), on this rank's device."""
        t0 = time.perf_counter()
        wire_dtype = torch.float16 if dtype == torch.bfloat16 else dtype
        nccl = self.backend == "nccl"
        staged = self.device.type == "cuda" and not nccl
        if nccl:
            recv = torch.empty(shape, dtype=wire_dtype, device=self.device)
        elif staged:
            n = 1
            for d in shape:
                n *= d
            recv = self._buffer("kvio-in", n, wire_dtype).view(shape)
        else:
            recv = torch.empty(shape, dtype=wire_dtype)
        if parts is not None:
            parts = [_wire(p) for p in parts]
            if nccl:
                parts = [p.to(self.device) for p in parts]
        try:
            with record_function("tp.block_scatter"):
                dist.scatter(recv, parts, src=0)
        except Exception as e:
            self.mark_lost("block scatter", e)
            raise
        got = recv.view(dtype)
        if staged:
            got = got.to(self.device)   # synchronous: the buffer is reused
        self.block_io_seconds += time.perf_counter() - t0
        return got

    # ------------------------------------------------ descriptors, control
    def bcast(self, t: torch.Tensor) -> None:
        """Broadcast the CPU tensor ``t`` from rank 0 in place (rank 0
        sends, the others receive into ``t``) on the descriptor group."""
        wire = _wire(t)
        try:
            dist.broadcast(wire, 0, group=self._cpu)
        except Exception as e:
            self.error = f"tp descriptor broadcast failed on rank {self.rank}: {e}"
            raise

    def send_header(self, kind: int, *args: int) -> None:
        """Rank 0: the header of the next descriptor. A lost group gets
        none: it raises the loss instead."""
        if self.error:
            raise RuntimeError(self.error)
        h = torch.zeros((HEADER_LEN,), dtype=torch.int64)
        h[0] = kind
        if args:
            h[1:1 + len(args)] = torch.tensor(args, dtype=torch.int64)
        self.bcast(h)
        self._last_send = time.monotonic()

    def recv_header(self) -> List[int]:
        """Ranks 1..tp-1: wait for the next descriptor's header."""
        h = torch.empty((HEADER_LEN,), dtype=torch.int64)
        self.bcast(h)
        return h.tolist()

    def gather_object(self, obj) -> list:
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self._cpu)
        return out

    def min_int(self, v: int) -> int:
        t = torch.tensor([v], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self._cpu)
        return int(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self._cpu)

    def broadcast_params(self, params: Optional[Dict]) -> Dict:
        """Rank 0's full param dict (``{name: tensor, "layers": {name:
        tensor}}``) on every rank, as CPU tensors, leaf by leaf."""
        spec = [None]
        if self.rank == 0:
            spec[0] = [(k, n, tuple(t.shape), t.dtype)
                       for k, v in sorted(params.items())
                       for n, t in (sorted(v.items()) if k == "layers"
                                    else [(None, v)])]
        dist.broadcast_object_list(spec, 0, group=self._cpu)
        out: Dict = {"layers": {}}
        for k, n, shape, dtype in spec[0]:
            if self.rank == 0:
                t = (params[k][n] if n else params[k]).detach().cpu().contiguous()
            else:
                t = torch.empty(shape, dtype=dtype)
            self.bcast(t)
            if n:
                out["layers"][n] = t
            else:
                out[k] = t
        return out

    # ------------------------------------------------------------ health
    def _heartbeat(self) -> None:
        interval = self.timeout_s / 4
        while not self._stop_beat.wait(min(interval, 1.0)):
            if time.monotonic() - self._last_send < interval:
                continue
            if not self.lock.acquire(blocking=False):
                continue
            try:
                if self._closed or self.error:
                    return
                self.send_header(NOOP)
            except Exception as e:  # noqa: BLE001 — recorded as the loss
                logger.error("tp heartbeat failed: %s", e)
                return
            finally:
                self.lock.release()

    def lost(self) -> Optional[str]:
        """Why the group is lost (a failed collective, or a worker process
        that exited), or None while every rank is up."""
        if self.error:
            return self.error
        if not self._closed:
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    return f"tp rank {r} (pid {p.pid}) exited with code {p.returncode}"
        return None

    def close(self, wait_s: float = 60.0) -> None:
        """Stop the heartbeat, wait for the worker processes to exit (kill
        them after ``wait_s``, or at once when the group is lost) and leave
        the process groups."""
        if self._closed:
            return
        lost = self.lost()
        self._closed = True
        self._stop_beat.set()
        if self._beat is not None:
            self._beat.join(timeout=10)
        for p in self.procs:
            try:
                p.wait(timeout=0 if lost else wait_s)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        dist.destroy_process_group()
