"""The rank mesh: one process per rank of a dp x sp x tp grid.

Counterpart of ``production_stack_tpu/parallel/mesh.py``. The JAX package
lays one ``Mesh`` with axes ("dp", "sp", "tp") over the devices of one
process (``make_mesh``: the devices reshaped to ``(dp, sp, tp)``) and lets
XLA insert the collectives. The port runs one process per rank of the same
grid: global rank ``(d * sp + s) * tp + t`` (``grid_rank``) is the
reference's device ``[d, s, t]``. Rank 0 is the engine process (scheduler,
engine loop, HTTP server) and starts ranks 1..world-1 as worker processes
(``parallel/worker.py``), which execute exactly the dispatches rank 0
describes, in the same order.

Groups, made on every rank in the same order (``dist.new_group`` is
collective over the world, whether or not the rank is a member):
  * the world (the default group, on the backend below) carries the block
    writes' scatter;
  * the tp group of each (d, s) (``TPGroup``) carries the model's
    collectives (``models/llama.py``'s ``tp`` argument), and the tp group
    of (0, 0), ranks 0..tp-1, the block reads' gather;
  * the sp ring of each (d, t) (``SPRing``) carries ring attention's
    point-to-point K/V exchange (``ops/ring_attention.py``) and the
    gathers that follow a ring-attended prefill;
  * a gloo group over the world carries the dispatch descriptors rank 0
    broadcasts (CPU int tensors) and the few control messages (pool
    agreement, rank reports).
dp replicas share nothing: every (d, s, t) rank holds what its (0, s, t)
twin holds and runs the same work, as the reference's dp axis replicates.

Backend, a rule (logged, and reported by ``ServingEngine.stats()`` as
``tp_backend``), never a recovery from a failed init:
  * ``nccl`` when every rank has a card of its own
    (``torch.cuda.device_count() >= world``; rank r on ``cuda:r``);
  * ``gloo`` when ranks share a card (NCCL refuses two ranks on one
    device), with CUDA tensors staged through pinned host memory, and in
    every CPU run.

Block I/O (the offload tier, ``/prewarm``, the prefill/decode handoff) reads
and writes whole logical blocks, every kv head: a ``KV_READ`` descriptor
makes every rank of the (0, 0) tp group select its heads of the named
blocks and gather them to rank 0 (``gather_to_root``), which joins them in
rank order; a ``KV_WRITE`` makes rank 0 scatter each rank of the world its
heads (``scatter_from_root``), so every replica's pool takes the blob (the
head ranges are ``sharding.py``'s). Both move raw bits (bf16 as 16 bits,
int8 as is) in chunks of at most ``BLOCK_IO_CHUNK_BYTES`` per rank, through
their own staging buffers (tags ``kvio-*``), so a large read leaves no large
pinned buffer behind the decode path's small ones. Every collective carries
the group's timeout, so a lost rank is an error within it, never a hang.
Rank 0 sends an empty descriptor after ``timeout / 4`` without one, so an
idle worker's wait for the next descriptor stays inside the timeout.

``TPGroup.all_reduce`` is an all-gather of the partial sums, then their
float32 sum in rank order, rounded once to the input dtype, on every rank:
the result is bit-identical on every rank by construction (replicated
activations and replicated sampling rest on that) and does not depend on a
library's reduction order.
"""

import ctypes
import datetime
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.profiler import record_function

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

AXIS_DP, AXIS_SP, AXIS_TP = "dp", "sp", "tp"

# Descriptor kinds (entry 0 of a descriptor header) and the header length.
# EMBED is the embedding forward (/v1/embeddings, /rerank): no KV pool, no
# dispatch number. KV_READ and KV_WRITE are block I/O: (kind, blocks,
# whether int8 scales follow, blocks per collective), then the block ids;
# no dispatch number. The speculative kinds (dp replicas; speculation is
# served at tp = sp = 1): SPEC_DECODE is a speculative decode dispatch
# (kind, dispatch, b, mb, K, cycle bound, penalties, logprob bucket, mode),
# then the packed buffer (each row's draft-ring slot and draft depth
# among its scalars) and the penalty counts; during its cycles rank 0
# broadcasts its "any budget left" flag once per group of cycles, so every
# replica runs rank 0's cycle count. SPEC_INGEST is a draft catch-up (kind,
# slot, first position, tokens, padded length), then the padded tokens.
# SPEC_RESET forgets a fresh draft-ring slot's positions (kind, slot).
(NOOP, DECODE, PREFILL, QUERY, STOP, EMBED, KV_READ, KV_WRITE,
 SPEC_DECODE, SPEC_INGEST, SPEC_RESET) = range(11)
HEADER_LEN = 12

# Bytes of one rank's slice that one block-exchange collective moves at
# most: the size of block I/O's staging buffers, whatever the batch.
BLOCK_IO_CHUNK_BYTES = 32 << 20

# The directory that holds the package: a worker process imports it from
# there whether or not the package is installed.
_PKG_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def grid_rank(d: int, s: int, t: int, sp: int, tp: int) -> int:
    """The global rank of grid point (d, s, t): the reference's
    ``devices.reshape(dp, sp, tp)`` order."""
    return (d * sp + s) * tp + t


def grid_coords(rank: int, sp: int, tp: int) -> Tuple[int, int, int]:
    """(d, s, t) of a global rank (the inverse of ``grid_rank``)."""
    return rank // (sp * tp), (rank // tp) % sp, rank % tp


def tp_backend(device: torch.device, world: int) -> str:
    """``nccl`` when each of the ``world`` ranks has a card of its own,
    else ``gloo`` (ranks sharing one card, or the CPU)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def rank_device(device: torch.device, rank: int, world: int) -> torch.device:
    """Rank r's device: ``cuda:r`` when each rank has a card of its own,
    else the one card (or the CPU) every rank shares."""
    if device.type != "cuda":
        return device
    if torch.cuda.device_count() >= world:
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def ranks_per_device(device: torch.device, world: int) -> int:
    """How many of the ``world`` ranks share ``device``'s memory."""
    if device.type == "cuda" and torch.cuda.device_count() < world:
        return world
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


class _SubGroup:
    """A sub-group of the mesh: its member ranks (global, in group order),
    this rank's place among them, and a gather in group order."""

    def __init__(self, mesh: "RankMesh", group, ranks: Sequence[int]):
        self.mesh = mesh
        self.group = group
        self.ranks = list(ranks)
        self.rank = self.ranks.index(mesh.rank)
        self.size = len(self.ranks)
        self.device = mesh.device
        self.backend = mesh.backend

    def _stage(self, tag: str, x: torch.Tensor) -> torch.Tensor:
        """``x``'s wire form where the collective reads it: a pinned host
        copy when a gloo group moves a CUDA tensor (waits for this rank's
        queued device work), else the wire view itself."""
        wire = _wire(x.contiguous())
        if self.backend == "gloo" and x.is_cuda:
            src = self.mesh._buffer(tag, wire.numel(), wire.dtype).view(wire.shape)
            src.copy_(wire)
            return src
        return wire

    def gather(self, x: torch.Tensor, tag: str) -> torch.Tensor:
        """[size, *x.shape]: every member's ``x`` in group order, on x's
        device. bf16 travels as its raw 16 bits (a gather only copies)."""
        stage = self.backend == "gloo" and x.is_cuda
        with record_function("tp.stage_d2h"):
            src = self._stage(f"{tag}-in", x)
        shape = (self.size,) + tuple(src.shape)
        if stage:
            out = self.mesh._buffer(f"{tag}-out", self.size * src.numel(),
                                    src.dtype).view(shape)
        else:
            out = torch.empty(shape, dtype=src.dtype, device=x.device)
        try:
            # Waits for the other members to arrive.
            with record_function("tp.exchange"):
                dist.all_gather(list(out.unbind(0)), src, group=self.group)
        except Exception as e:
            self.mesh.mark_lost(f"{tag} collective", e)
            raise
        if stage:
            with record_function("tp.stage_h2d"):
                out = out.to(x.device)   # synchronous: the buffer is reused
        return out.view(x.dtype) if x.dtype == torch.bfloat16 else out


class TPGroup(_SubGroup):
    """This rank's tensor-parallel group: the tp ranks of one (d, s)
    replica. ``rank`` is the tp rank t, ``size`` the tp degree; the
    model's collectives run here (``models/llama.py``'s ``tp``)."""

    def __init__(self, mesh: "RankMesh", group, ranks: Sequence[int]):
        super().__init__(mesh, group, ranks)
        # Host seconds inside compute collectives (staging included).
        self.collective_seconds = 0.0

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order."""
        t0 = time.perf_counter()
        with record_function("tp.all_gather"):
            out = torch.cat(self.gather(x, "tp").unbind(0), dim=dim)
        self.collective_seconds += time.perf_counter() - t0
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``: float32 in rank order, rounded
        once to x's dtype; bit-identical on every rank."""
        t0 = time.perf_counter()
        with record_function("tp.all_reduce"):
            out = rank_order_sum(self.gather(x, "tp").unbind(0), x.dtype)
        self.collective_seconds += time.perf_counter() - t0
        return out


class SPRing(_SubGroup):
    """This rank's sequence-parallel ring: the sp ranks of one (d, t).
    ``rank`` is s; a ring step passes tensors to s + 1 and takes them
    from s - 1 (``exchange``)."""

    def __init__(self, mesh: "RankMesh", group, ranks: Sequence[int]):
        super().__init__(mesh, group, ranks)
        self.next = self.ranks[(self.rank + 1) % self.size]
        self.prev = self.ranks[(self.rank - 1) % self.size]
        # Host seconds inside ring exchanges and sp gathers (staging
        # included), the exchanges made, and the ring-attended layer calls
        # by kind (ops/ring_attention.py).
        self.ring_seconds = 0.0
        self.exchanges = 0
        self.rings = {"first": 0, "continuation": 0}

    def exchange(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """One ring step: send each of ``tensors`` to rank s + 1 and receive
        its counterpart of the same shape and dtype from rank s - 1, one
        ``isend`` / ``irecv`` pair per tensor (tag: its index). Every rank
        posts the same pairs in the same order, so the ring cannot
        deadlock. Returns the received tensors on this rank's device."""
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and self.device.type == "cuda"
        sends, recvs, works = [], [], []
        with record_function("sp.stage_d2h"):
            for i, x in enumerate(tensors):
                src = self._stage(f"ring-send{i}", x)
                if staged:
                    dst = self.mesh._buffer(f"ring-recv{i}", src.numel(),
                                            src.dtype).view(src.shape)
                else:
                    dst = torch.empty_like(src)
                sends.append(src)
                recvs.append(dst)
        try:
            with record_function("sp.exchange"):
                for i, (src, dst) in enumerate(zip(sends, recvs)):
                    works.append(dist.isend(src, self.next, group=self.group,
                                            tag=i))
                    works.append(dist.irecv(dst, self.prev, group=self.group,
                                            tag=i))
                for w in works:
                    w.wait(self.mesh.timeout)
        except Exception as e:
            self.mesh.mark_lost("ring exchange", e)
            raise
        out = []
        with record_function("sp.stage_h2d"):
            for x, got in zip(tensors, recvs):
                if staged:
                    got = got.to(self.device)   # synchronous: buffers reused
                out.append(got.view(x.dtype) if x.dtype == torch.bfloat16
                           else got)
        self.exchanges += 1
        self.ring_seconds += time.perf_counter() - t0
        return out

    def gather(self, x: torch.Tensor, tag: str = "sp") -> torch.Tensor:
        """[sp, *x.shape]: every sp rank's ``x`` in ring order."""
        t0 = time.perf_counter()
        with record_function("sp.gather"):
            out = super().gather(x, tag)
        self.ring_seconds += time.perf_counter() - t0
        return out

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every sp rank's ``x`` concatenated along ``dim`` in ring order."""
        return torch.cat(self.gather(x).unbind(0), dim=dim)


class RankMesh:
    """This process's rank of the dp x sp x tp grid (see the module
    docstring): the descriptor and control plane over every rank, block
    I/O, and this rank's ``tp`` group and ``sp`` ring (None where that
    degree is 1). Rank 0 owns the worker processes (``procs``)."""

    def __init__(self, rank: int, dp: int, sp: int, tp: int,
                 device: torch.device, timeout_s: float, store, procs=()):
        if dist.is_initialized():
            raise RuntimeError(
                "a rank mesh is already running in this process (one engine "
                "with more than one rank per process)")
        self.dp_size, self.sp_size, self.tp_size = dp, sp, tp
        self.rank, self.size = rank, dp * sp * tp
        self.coords = grid_coords(rank, sp, tp)
        self.device = device
        self.backend = tp_backend(device, self.size)
        self.timeout_s = timeout_s
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self.procs: List[subprocess.Popen] = list(procs)
        self._store = store
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(self.backend, store=store, rank=rank,
                                world_size=self.size, timeout=self.timeout)
        self._cpu = dist.new_group(backend="gloo", timeout=self.timeout)
        self._staging: Dict = {}
        self.tp: Optional[TPGroup] = None
        self.sp: Optional[SPRing] = None
        # Every rank makes every group, in this order: the tp group of each
        # (d, s), then the sp ring of each (d, t).
        groups = []
        if tp > 1:
            groups += [("tp", [grid_rank(d, s, t, sp, tp) for t in range(tp)])
                       for d in range(dp) for s in range(sp)]
        if sp > 1:
            groups += [("sp", [grid_rank(d, s, t, sp, tp) for s in range(sp)])
                       for d in range(dp) for t in range(tp)]
        for kind, ranks in groups:
            group = (None if len(ranks) == self.size else dist.new_group(
                ranks, timeout=self.timeout, backend=self.backend))
            if rank in ranks:
                if kind == "tp":
                    self.tp = TPGroup(self, group, ranks)
                else:
                    self.sp = SPRing(self, group, ranks)
        # Held by rank 0 around each descriptor and the device work it
        # describes, so the heartbeat's empty descriptor never lands inside
        # a dispatch.
        self.lock = threading.RLock()
        self._last_send = time.monotonic()
        self._closed = False
        # Set once a collective or a heartbeat failed: the mesh is lost.
        self.error: Optional[str] = None
        # Host seconds inside block I/O's gathers and scatters.
        self.block_io_seconds = 0.0
        self._stop_beat = threading.Event()
        self._beat = None
        if rank == 0 and self.size > 1:
            self._beat = threading.Thread(target=self._heartbeat, daemon=True,
                                          name="mesh-heartbeat")
            self._beat.start()
        logger.info(
            "rank %d (dp %d, sp %d, tp %d) of dp=%d x sp=%d x tp=%d on %s: "
            "backend %s (%s)", rank, *self.coords, dp, sp, tp, device,
            self.backend,
            "each rank has a card of its own" if self.backend == "nccl"
            else "ranks share one card: CUDA tensors staged through pinned "
                 "host memory" if device.type == "cuda" else "CPU ranks")

    # ------------------------------------------------------------ start
    @classmethod
    def launch(cls, dp: int, sp: int, tp: int, device: torch.device,
               timeout_s: float,
               worker_argv: Callable[[int, int], List[str]]) -> "RankMesh":
        """Rank 0: open a rendezvous store on a free port, start ranks
        1..world-1 as ``worker_argv(rank, port)`` and join them."""
        world = dp * sp * tp
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", 0, world, True, timeout=timeout,
                              wait_for_workers=False)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PKG_PARENT, env.get("PYTHONPATH")) if p)
        procs: List[subprocess.Popen] = []
        try:
            for r in range(1, world):
                procs.append(subprocess.Popen(worker_argv(r, store.port),
                                              env=env))
            deadline = time.monotonic() + timeout_s
            for r, p in enumerate(procs, 1):
                while not store.check([f"ready/{r}"]):
                    if p.poll() is not None:
                        raise RuntimeError(
                            f"rank {r} exited with code {p.returncode} "
                            "before joining the mesh")
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"rank {r} did not join within {timeout_s} s")
                    time.sleep(0.02)
            return cls(0, dp, sp, tp, rank_device(device, 0, world), timeout_s,
                       store, procs)
        except BaseException:
            for p in procs:
                p.kill()
                p.wait()
            raise

    @classmethod
    def join(cls, rank: int, dp: int, sp: int, tp: int, port: int,
             device: torch.device, timeout_s: float) -> "RankMesh":
        """Ranks 1..world-1: join rank 0's rendezvous on ``port``."""
        world = dp * sp * tp
        timeout = datetime.timedelta(seconds=timeout_s)
        store = dist.TCPStore("127.0.0.1", port, world, False, timeout=timeout)
        store.set(f"ready/{rank}", "1")
        return cls(rank, dp, sp, tp, rank_device(device, rank, world),
                   timeout_s, store)

    def _buffer(self, tag: str, numel: int, dtype) -> torch.Tensor:
        """A host staging buffer of at least ``numel`` elements (pinned
        when this rank runs on a card)."""
        buf = self._staging.get((tag, dtype))
        if buf is None or buf.numel() < numel:
            buf = torch.empty((max(numel, 1 << 16),), dtype=dtype,
                              pin_memory=self.device.type == "cuda")
            self._staging[(tag, dtype)] = buf
        return buf[:numel]

    # ------------------------------------------------------- block I/O
    @staticmethod
    def block_chunk(row_bytes: int) -> int:
        """Blocks per block-exchange collective when one block of one
        rank's slice is ``row_bytes``."""
        return max(1, BLOCK_IO_CHUNK_BYTES // max(1, row_bytes))

    def mark_lost(self, what: str, e: Exception) -> None:
        """Record that ``what`` failed on this rank: the mesh is lost."""
        self.error = self.error or f"{what} failed on rank {self.rank}: {e}"

    def gather_to_root(self, x: torch.Tensor) -> Optional[List[torch.Tensor]]:
        """Every rank of the (0, 0) tp group: send ``x`` (a chunk of its
        blocks, on its device) to rank 0, which gets every tp rank's
        tensor in rank order as host tensors (views of a staging buffer:
        valid until the next block exchange); None on the other ranks."""
        t0 = time.perf_counter()
        g = self.tp
        nccl = self.backend == "nccl"
        src = g._stage("kvio-in", x)
        parts = None
        if self.rank == 0:
            if nccl:
                parts = [torch.empty_like(src) for _ in range(g.size)]
            else:
                parts = list(self._buffer(
                    "kvio-out", g.size * src.numel(), src.dtype
                ).view((g.size,) + tuple(src.shape)).unbind(0))
        try:
            with record_function("tp.block_gather"):
                dist.gather(src, parts, dst=0, group=g.group)
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
        ``parts`` (one per global rank in rank order, each ``shape`` and
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
            self.mark_lost("descriptor broadcast", e)
            raise

    def send_header(self, kind: int, *args: int) -> None:
        """Rank 0: the header of the next descriptor. A lost mesh gets
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
        """Ranks 1..world-1: wait for the next descriptor's header."""
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
                logger.error("mesh heartbeat failed: %s", e)
                return
            finally:
                self.lock.release()

    def lost(self) -> Optional[str]:
        """Why the mesh is lost (a failed collective, or a worker process
        that exited), or None while every rank is up."""
        if self.error:
            return self.error
        if not self._closed:
            for r, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    return f"rank {r} (pid {p.pid}) exited with code {p.returncode}"
        return None

    def close(self, wait_s: float = 60.0) -> None:
        """Stop the heartbeat, wait for the worker processes to exit (kill
        them after ``wait_s``, or at once when the mesh is lost) and leave
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
