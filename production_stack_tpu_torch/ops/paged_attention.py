"""Paged flash-decode over the layer-stacked KV pool: the hand-written CUDA
kernels (``csrc/``: a tensor-core kernel for bf16 and f16 q over pools of
q's dtype or int8 at Dh 32 / 64 / 128 / 256, any number of query heads per
kv head and every block size the gate admits, and a generic CUDA-core
kernel for the rest of the Pallas kernel's domain: float32, and bf16 / f16
at Dh 1-16 and above 256) and their plain PyTorch twin.

Counterpart of ``production_stack_tpu/ops/pallas/paged_attention.py``
(``paged_flash_decode_stats`` and its ``_decode_kernel``, both branches, the
tensor-parallel ``paged_flash_decode_stats_tp``, and the
``paged_attention_decode_pallas`` / ``paged_attention_pallas`` wrappers).
The wrapper takes the plain version only for tensors that lie on the CPU;
for a CUDA tensor it launches the kernel or raises. The kernels are compiled
by ``nvcc`` from the package's own ``csrc/`` at first use (one ``nvcc``
process per translation unit, all at once, then one link) into
``BUILD_DIR`` (``build/torch_kernels/`` of a checkout; a per-user cache
directory when the package is installed) and bound through ``ctypes`` (a
plain C interface: seconds to build, no PyTorch headers). The kernel
counts its own launches per variant on the device (``launch_counts``), so
a run can show which variant served it, graph replays included. A call is
one kernel launch: the kernel splits each row's tiles into chunks on the
device (the host only sizes the grid, ``launch_plan``) and merges the
chunks itself, through a scratch kept per device and shape bucket.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.ops.attention import paged_attention_xla
from production_stack_tpu_torch.ops.quantization import SCALE_DTYPE

# The gate is the Pallas kernel's (``supports_pallas_decode``): a head dim
# that divides LANES or is a multiple of it, a block size dividing the
# 512-token superpage and divisible by the pack factor LANES // Dh.
SUPER_TOKENS = 512
LANES = 128
# The tensor-core kernel's shapes (q dtypes and head dims, at any G and
# block size); every other admitted shape runs the generic kernel.
MMA_DTYPES = (torch.bfloat16, torch.float16)
MMA_HEAD_DIMS = (32, 64, 128, 256)
MMA_GROUP = 16            # query heads per block; more run as head groups (kMaxGroup)
MMA_COLUMNS = 128         # output columns per block; Dh 256 runs two (kMaxColumns)
MMA_PAGE_LIST = 257       # page-list entries of a block (kMaxPages)
GENERIC_HEADS = 8         # query heads per block of the generic kernel (kGenHeads)
GENERIC_SMEM_BUDGET = 200 * 1024   # its dynamic shared bytes (kGenSmemBudget)
TILE_TOKENS = 64          # tokens per tile (kTile)
MAX_CHUNK_TILES = 8       # tiles per block, at most (kMaxChunkTiles)

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
# The C interface and the generic kernel; the tensor-core instances, one
# translation unit per q dtype and pool kind; their shared header.
SOURCE = os.path.join(_CSRC, "paged_decode.cu")
SOURCES = (SOURCE, *(os.path.join(_CSRC, f"paged_decode_{name}.cu")
                     for name in ("bf16", "bf16_int8", "f16", "f16_int8")))
HEADER = os.path.join(_CSRC, "paged_decode.cuh")


def kernel_build_dir() -> str:
    """Where ``build_kernels`` writes: ``build/torch_kernels`` of the
    checkout when the package's parent is this repository (its
    ``pyproject.toml``) and writable; otherwise, as in an install, the
    user's cache directory (``$XDG_CACHE_HOME``, else ``~/.cache``) under
    ``production_stack_tpu_torch/kernels``."""
    parent = os.path.dirname(_PKG_DIR)
    project = os.path.join(parent, "pyproject.toml")
    if os.path.isfile(project) and os.access(parent, os.W_OK):
        with open(project) as f:
            if 'name = "production-stack-tpu"' in f.read():
                return os.path.join(parent, "build", "torch_kernels")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "production_stack_tpu_torch", "kernels")


BUILD_DIR = kernel_build_dir()
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# The variants (the names of chip_smoke.py's kernels line). Each launch
# adds one to its variant's slot of a per-device int64 counter, in the
# kernel (thread 0 of block (0, 0, 0)): a launch replayed from a CUDA graph
# counts like a direct one, and a call that launches nothing counts
# nothing. Counters live as long as the process (graphs hold their
# addresses).
BF16 = "paged_flash_decode_stats"
INT8 = "paged_flash_decode_stats[int8]"
F16 = "paged_flash_decode_stats[f16]"
F16_INT8 = "paged_flash_decode_stats[f16/int8]"
# The tensor-core kernel's variants and the generic kernel's, by (q dtype,
# int8 pools).
MMA = {(torch.bfloat16, False): BF16, (torch.bfloat16, True): INT8,
       (torch.float16, False): F16, (torch.float16, True): F16_INT8}
DTYPE_CODES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
_SHORT = {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32"}
GENERIC = {(dt, quant): f"paged_flash_decode_stats[generic {name}"
                        f"{'/int8' if quant else ''}]"
           for dt, name in _SHORT.items() for quant in (False, True)}
VARIANTS = (*MMA.values(), *GENERIC.values())
_counters: Dict[torch.device, torch.Tensor] = {}

_lib = None
_lib_lock = threading.Lock()
_sm_count = {}
# Split scratch per (device, batch bucket, Hkv, G, Dh, chunks, blocks per kv
# head): partial (acc, m, l) of every chunk and one merge ticket per (row,
# kv head, head group, column block). Kept for the life of the process, so
# a captured CUDA graph's pointers stay valid; the kernel leaves every
# ticket at 0.
_scratch = {}


def supports_paged_decode(head_dim: int, block_size: int) -> bool:
    """Shapes the kernels take: the Pallas kernel's gate
    (``supports_pallas_decode``), for every compute dtype and both pool
    kinds, at any number of query heads per kv head."""
    pack = max(1, LANES // head_dim)
    return ((head_dim % LANES == 0 or LANES % head_dim == 0)
            and SUPER_TOKENS % block_size == 0
            and block_size % pack == 0)


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def uses_mma(dtype, head_dim: int) -> bool:
    """Whether a call runs the tensor-core kernel (else the generic one):
    bf16 or f16 q at Dh 32, 64, 128 or 256. The pool kind, the query heads
    per kv head and the block size do not enter."""
    return _dtype(dtype) in MMA_DTYPES and head_dim in MMA_HEAD_DIMS


def variant_of(dtype, quant: bool, head_dim: int, q_per_kv: int,
               block_size: int) -> str:
    """The variant (launch counter) a call of these shapes launches:
    ``dtype`` is q's (a torch dtype or its name), ``quant`` True for int8
    pools."""
    table = MMA if uses_mma(dtype, head_dim) else GENERIC
    return table[(_dtype(dtype), bool(quant))]


def heads_per_block(dtype, head_dim: int, q_per_kv: int,
                    block_size: int) -> int:
    """Query heads one block takes: up to MMA_GROUP (its M rows) on the
    tensor-core kernel; on the generic kernel up to GENERIC_HEADS, fewer
    where q and acc ([heads, Dh] fp32 each) would pass its shared-memory
    budget. A (row, kv head, chunk) gets ceil(G / this) head groups."""
    if uses_mma(dtype, head_dim):
        return min(q_per_kv, MMA_GROUP)
    hb = min(GENERIC_HEADS, q_per_kv)
    while hb > 1 and 8 * hb * head_dim > GENERIC_SMEM_BUDGET:
        hb -= 1
    return hb


def column_blocks(dtype, head_dim: int) -> int:
    """Output column blocks of a (row, kv head, head group, chunk): Dh 256
    runs as two blocks of MMA_COLUMNS on the tensor-core kernel, each
    scoring all of K and multiplying half of V."""
    return head_dim // MMA_COLUMNS if uses_mma(dtype, head_dim) \
        and head_dim > MMA_COLUMNS else 1


def chunk_tiles_cap(dtype, head_dim: int, block_size: int) -> int:
    """Tiles a chunk may hold: MAX_CHUNK_TILES, or 4 on the tensor-core
    kernel at one-token pages (its page list holds MMA_PAGE_LIST
    entries)."""
    if uses_mma(dtype, head_dim) and block_size == 1:
        return (MMA_PAGE_LIST - 1) // TILE_TOKENS
    return MAX_CHUNK_TILES


def launch_plan(batch: int, num_kv_heads: int, max_tokens: int,
                sm_count: int, groups: int = 1,
                max_chunk_tiles: int = MAX_CHUNK_TILES) -> Tuple[int, int]:
    """(chunk_tiles, max_chunks) of a call, from host-known sizes only:
    chunks of 4 tiles, or of ``max_chunk_tiles`` (``chunk_tiles_cap``)
    where 4-tile chunks of rows as long as the block table allows would
    exceed 8 blocks per SM (``groups`` blocks per kv head: head groups x
    column blocks). The kernel gives row b ceil(tiles_b / chunk_tiles) of
    the max_chunks blocks per kv head and head group."""
    tiles = max(1, -(-max_tokens // TILE_TOKENS))
    chunk = 4
    if batch * num_kv_heads * groups * -(-tiles // chunk) > 8 * sm_count:
        chunk = max(chunk, max_chunk_tiles)
    return chunk, -(-tiles // chunk)


def _find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda/bin or PATH): the "
            "paged-decode kernel is built from source at first use"
        )
    return found


def build_kernels() -> Tuple[str, str]:
    """Compile ``csrc/`` into a shared library (once per source content):
    one ``nvcc -c`` per translation unit, all running at once, then one
    link. Returns (library path, ptxas report of every unit)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (HEADER, *SOURCES):
        with open(path, "rb") as f:
            digest.update(f.read())
    tag = digest.hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libpaged_decode-{tag}.so")
    log_path = lib_path + ".log"
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        # Engines of one pod may build at once: each writes its own files
        # and renames them into place, the report before the library.
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        nvcc = _find_nvcc()
        objs = [f"{tmp}.{i}.o" for i in range(len(SOURCES))]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                for obj, src in zip(objs, SOURCES)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        reports = [proc.communicate()[0] for proc in procs]
        link = [nvcc, "-shared", "-o", tmp, *objs]
        try:
            for cmd, proc, report in zip(cmds, procs, reports):
                if proc.returncode != 0:
                    raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                       f"{' '.join(cmd)}\n{report}")
            proc = subprocess.run(link, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(link)}\n{proc.stdout}\n{proc.stderr}")
        finally:
            for obj in objs:
                if os.path.exists(obj):
                    os.remove(obj)
        with open(tmp + ".log", "w") as f:
            f.write("".join(reports))
        os.replace(tmp + ".log", log_path)
        os.replace(tmp, lib_path)
    with open(log_path) as f:
        return lib_path, f.read()


def _load_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_kernels()
            lib = ctypes.CDLL(path)
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            tail = [i32, i32, i32, i32, ctypes.c_longlong, i32, i32, i32, i32,
                    i32, ctypes.c_float, vp]
            lib.pstpu_paged_decode_mma.argtypes = [i32, i32] + [vp] * 14 + tail
            lib.pstpu_paged_decode_mma.restype = i32
            lib.pstpu_paged_decode_generic.argtypes = (
                [i32, i32] + [vp] * 14 + [i32] * 5 + tail[4:])
            lib.pstpu_paged_decode_generic.restype = i32
            lib.pstpu_paged_decode_mma_occupancy.argtypes = [
                i32, i32, i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
            lib.pstpu_paged_decode_mma_occupancy.restype = i32
            lib.pstpu_paged_decode_generic_occupancy.argtypes = [
                i32, i32, i32, i32, i32, ctypes.POINTER(i32), ctypes.POINTER(i32)]
            lib.pstpu_paged_decode_generic_occupancy.restype = i32
            lib.pstpu_graph_node_counts.argtypes = [
                vp, ctypes.POINTER(i32), ctypes.POINTER(i32)]
            lib.pstpu_graph_node_counts.restype = i32
            lib.pstpu_cuda_error_string.argtypes = [i32]
            lib.pstpu_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"paged decode kernel ({what}): CUDA error {err} "
                           f"({lib.pstpu_cuda_error_string(err).decode()})")


def occupancy(dtype, pool: int, head_dim: int, m_rows: int) -> Tuple[int, int]:
    """(resident blocks per SM, dynamic shared bytes per block) of the
    tensor-core kernel's instance of q ``dtype``, ``pool`` (0 pools of q's
    dtype, 1 int8 pools, 2 int8 pools of one-token pages), head dim and M
    rows (8 or 16), as the CUDA runtime reports them for the launch's block
    size and shared memory."""
    lib = _load_lib()
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.pstpu_paged_decode_mma_occupancy(
        DTYPE_CODES[_dtype(dtype)], pool, head_dim, m_rows,
        ctypes.byref(blocks), ctypes.byref(smem)), "occupancy")
    return blocks.value, smem.value


def generic_occupancy(dtype, quant: bool, head_dim: int, heads: int,
                      max_chunks: int = 1) -> Tuple[int, int]:
    """The same for the generic kernel's instance of q ``dtype`` and pool
    kind, at ``heads`` query heads per block and ``max_chunks`` chunks
    (its shared memory follows both and the head dim)."""
    lib = _load_lib()
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.pstpu_paged_decode_generic_occupancy(
        DTYPE_CODES[_dtype(dtype)], int(quant), head_dim, heads, max_chunks,
        ctypes.byref(blocks), ctypes.byref(smem)), "occupancy")
    return blocks.value, smem.value


def graph_node_counts(graph: "torch.cuda.CUDAGraph") -> Tuple[int, int]:
    """(kernel nodes, all nodes) of a graph captured with keep_graph=True:
    how many launches one replay makes."""
    lib = _load_lib()
    kernels, total = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib, lib.pstpu_graph_node_counts(
        graph.raw_cuda_graph(), ctypes.byref(kernels), ctypes.byref(total)),
        "graph nodes")
    return kernels.value, total.value


def _counter(device: torch.device) -> torch.Tensor:
    """The launch counter of ``device`` ([len(VARIANTS)] int64), made at
    the first call on it, which must not be under CUDA-graph capture."""
    if device not in _counters:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "paged decode kernel: the first call on a device must run "
                "outside CUDA-graph capture (it allocates the launch counter)")
        _counters[device] = torch.zeros((len(VARIANTS),), dtype=torch.int64,
                                        device=device)
    return _counters[device]


def launch_counts() -> Dict[str, int]:
    """Kernel launches per variant since the last ``reset_launch_counts``,
    summed over devices (after waiting for each device's queued work). On a
    machine where the kernel never ran, every count is 0."""
    total = dict.fromkeys(VARIANTS, 0)
    for device, counter in _counters.items():
        torch.cuda.synchronize(device)
        for name, n in zip(VARIANTS, counter.tolist()):
            total[name] += n
    return total


def reset_launch_counts() -> None:
    """Set every device's launch counts to 0 (queued on each device's
    current stream, after the work already queued there)."""
    for counter in _counters.values():
        counter.zero_()


def sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def _split_scratch(device: torch.device, b: int, hkv: int, g: int, dh: int,
                   max_chunks: int, per_kv: int, columns: int):
    """(partial acc, partial (m, l), tickets) for a call, allocated once per
    device and shape bucket (the batch rounded up to a power of two):
    ``per_kv`` blocks per (row, kv head, chunk), of which ``columns``
    column blocks each keep their own (m, l)."""
    bucket = 1
    while bucket < b:
        bucket *= 2
    key = (device, bucket, hkv, g, dh, max_chunks, per_kv, columns)
    if key not in _scratch:
        rows = bucket * hkv * max_chunks * g
        _scratch[key] = (
            torch.empty((rows * dh,), dtype=torch.float32, device=device),
            torch.empty((rows * 2 * columns,), dtype=torch.float32, device=device),
            torch.zeros((bucket * hkv * per_kv,), dtype=torch.int32, device=device),
        )
    return _scratch[key]


def paged_flash_decode_stats(
    q: torch.Tensor,             # [B, H, Dh] decode queries (post-rope)
    k_pool: torch.Tensor,        # [L, Hkv, num_slots, Dh]
    v_pool: torch.Tensor,        # [L, Hkv, num_slots, Dh]
    block_tables: torch.Tensor,  # [B, Mb] int32
    kv_lens: torch.Tensor,       # [B] int32 — tokens resident in the pool
    layer: int,                  # layer of the stacked pool
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv, num_slots] (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pool-segment flash decode for one layer of the stacked pool.

    Returns (out [B, H, Dh] normalized in q's dtype, m [B, H] f32,
    l [B, H] f32); rows with kv_len == 0 give (0, -inf, 0), a no-op under
    ops/attention.py:merge_attention_segments. CPU tensors take the plain
    version; CUDA tensors launch a kernel or raise: q in bf16, f16 or f32
    over pools of q's dtype, or (scales given) over int8 pools with bf16
    per-slot scales, on the shapes ``supports_paged_decode`` admits; the
    tensor-core kernel where ``uses_mma``, else the generic one. Each
    kv_lens[i] must be at most Mb * block_size (the caller's
    block tables cover every resident token; the lengths stay on the
    device, so this is not checked here: the kernel clamps to it). One
    launch per call, and no host decision reads device data, so a call can
    be captured in a CUDA graph and replayed with new lengths and tables.
    Calls on one device must not overlap in time: they share the split
    scratch."""
    quant = k_scale is not None
    if q.device.type == "cpu":
        return paged_flash_decode_stats_ref(
            q, k_pool, v_pool, block_tables, kv_lens, layer,
            block_size=block_size, scale=scale, k_scale=k_scale,
            v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_flash_decode_stats: unsupported device {q.device}")
    b, h, dh = q.shape
    n_layers, hkv, num_slots, pdh = k_pool.shape
    tensors = [("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
               ("block_tables", block_tables), ("kv_lens", kv_lens)]
    if quant or v_scale is not None:
        if k_scale is None or v_scale is None:
            raise ValueError("int8 pools need both k_scale and v_scale")
        tensors += [("k_scale", k_scale), ("v_scale", v_scale)]
    for name, t in tensors:
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    pool_dtype = torch.int8 if quant else q.dtype
    if q.dtype not in DTYPE_CODES or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise ValueError(
            f"paged decode kernel takes q in {sorted(_SHORT.values())} over "
            f"pools of q's dtype, or int8 pools with scales; got q={q.dtype} "
            f"k={k_pool.dtype} v={v_pool.dtype} "
            f"({'with' if quant else 'without'} scales)"
        )
    if quant and (k_scale.dtype != SCALE_DTYPE or v_scale.dtype != SCALE_DTYPE
                  or tuple(k_scale.shape) != (n_layers, hkv, num_slots)
                  or v_scale.shape != k_scale.shape):
        raise ValueError(
            f"int8 pools need {SCALE_DTYPE} scales of shape "
            f"{(n_layers, hkv, num_slots)}, got k_scale "
            f"{k_scale.dtype} {tuple(k_scale.shape)}, v_scale "
            f"{v_scale.dtype} {tuple(v_scale.shape)}"
        )
    if v_pool.shape != k_pool.shape or pdh != dh or h % hkv:
        raise ValueError(
            f"shape mismatch: q {tuple(q.shape)} k {tuple(k_pool.shape)} "
            f"v {tuple(v_pool.shape)}"
        )
    if not supports_paged_decode(dh, block_size):
        raise ValueError(
            f"paged decode kernel: head_dim {dh} must divide or be a multiple "
            f"of {LANES}, and block_size {block_size} divide the "
            f"{SUPER_TOKENS}-token superpage and be divisible by the pack "
            f"factor {max(1, LANES // dh)}"
        )
    if block_tables.dtype != torch.int32 or kv_lens.dtype != torch.int32:
        raise ValueError("block_tables and kv_lens must be int32")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or tuple(kv_lens.shape) != (b,):
        raise ValueError("block_tables must be [B, Mb] and kv_lens [B]")
    if num_slots % block_size or not 0 <= layer < n_layers:
        raise ValueError(
            f"num_slots {num_slots} not a multiple of block_size "
            f"{block_size}, or layer {layer} outside [0, {n_layers})"
        )
    g = h // hkv
    mma = uses_mma(q.dtype, dh)
    # The tensor-core kernel: 16-byte copies of pool rows; 4-byte loads of
    # q pairs and copies of scale pairs. The generic kernel reads elements.
    for name, t in tensors:
        align = (16 if name.endswith("pool") else 4) if mma else t.element_size()
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    if scale is None:
        scale = dh ** -0.5
    mb = block_tables.shape[1]
    hb = heads_per_block(q.dtype, dh, g, block_size)
    columns = column_blocks(q.dtype, dh)
    per_kv = -(-g // hb) * columns
    chunk_tiles, max_chunks = launch_plan(
        b, hkv, mb * block_size, sm_count(q.device), per_kv,
        chunk_tiles_cap(q.dtype, dh, block_size))
    if not mma and 8 * hb * max(dh, max_chunks) > GENERIC_SMEM_BUDGET:
        raise ValueError(
            f"paged decode kernel: head_dim {dh} with {mb * block_size}-token "
            f"block tables needs more than {GENERIC_SMEM_BUDGET} bytes of "
            "shared memory per block")
    part_acc, part_ml, tickets = _split_scratch(q.device, b, hkv, g, dh,
                                                max_chunks, per_kv, columns)
    out = torch.empty_like(q)
    m = torch.empty((b, h), dtype=torch.float32, device=q.device)
    l = torch.empty((b, h), dtype=torch.float32, device=q.device)
    lib = _load_lib()
    variant = variant_of(q.dtype, quant, dh, g, block_size)
    counter = _counter(q.device)[VARIANTS.index(variant):]
    pools = [k_pool.data_ptr(), v_pool.data_ptr()]
    scales = [k_scale.data_ptr(), v_scale.data_ptr()] if quant else [None, None]
    rest = [block_tables.data_ptr(), kv_lens.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(),
            tickets.data_ptr(), counter.data_ptr(), b, h, hkv, dh]
    tail = [num_slots, int(layer), mb, block_size.bit_length() - 1,
            chunk_tiles, max_chunks, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream]
    if mma:
        err = lib.pstpu_paged_decode_mma(
            DTYPE_CODES[q.dtype], int(quant), q.data_ptr(), *pools, *scales,
            *rest, *tail)
    else:
        err = lib.pstpu_paged_decode_generic(
            DTYPE_CODES[q.dtype], int(quant), q.data_ptr(), *pools, *scales,
            *rest, hb, *tail)
    _check(lib, err, f"{variant} launch")
    return out, m, l


def paged_flash_decode_stats_tp(
    q: torch.Tensor,             # [B, H/tp, Dh] this rank's query heads
    k_pool: torch.Tensor,        # [L, Hkv/tp, num_slots, Dh] this rank's kv heads
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,  # [B, Mb] int32 (replicated)
    kv_lens: torch.Tensor,       # [B] int32 (replicated)
    layer: int,
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv/tp, num_slots]
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One tensor-parallel rank's pool-segment flash decode: the
    counterpart of the reference's ``paged_flash_decode_stats_tp``, which
    ``shard_map``s the kernel over the tp axis. Each rank runs the kernel
    (its plain twin on the CPU) over its own contiguous block of kv heads
    and the query heads of their GQA groups; int8 scale pools are split
    like the payload. Heads are independent, so this needs no collective:
    it returns this rank's ``(out [B, H/tp, Dh], m, l [B, H/tp])``, and the
    row-parallel output projection downstream sums over the ranks. The
    launch counts like any other call of the kernel, on this rank's device
    counter."""
    if q.shape[1] % k_pool.shape[1]:
        raise ValueError(
            f"paged_flash_decode_stats_tp: this rank's {q.shape[1]} query "
            f"heads do not fill whole GQA groups of its {k_pool.shape[1]} "
            "kv heads")
    return paged_flash_decode_stats(
        q, k_pool, v_pool, block_tables, kv_lens, layer,
        block_size=block_size, scale=scale, k_scale=k_scale, v_scale=v_scale,
    )


def paged_flash_decode_stats_ref(
    q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
    block_tables: torch.Tensor, kv_lens: torch.Tensor, layer: int,
    *, block_size: int, scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, with the Pallas kernel's
    arithmetic: q in f32 pre-scaled, f32 scores and PV, masked keys at -inf.
    Int8 pools (scales given), as the Pallas kernel's quantized branch: the
    raw int8 score times the slot's K scale, ``l`` sums the unscaled
    weights, and each weight is multiplied by its slot's V scale on the way
    into PV. Keys, values and scales past kv_len are zeroed before the
    contractions so a stale slot never meets a zero weight as 0 * NaN. On
    the card its f32 products are full precision only with TF32 off
    (``torch.backends.cuda.matmul.allow_tf32``, PyTorch's default;
    chip_smoke.py sets it and ``cudnn.allow_tf32`` to False)."""
    b, h, dh = q.shape
    _, hkv, num_slots, _ = k_pool.shape
    g = h // hkv
    if scale is None:
        scale = dh ** -0.5
    mb = block_tables.shape[1]
    nb = num_slots // block_size
    s_tot = mb * block_size
    idx = block_tables.long()
    keys = k_pool[layer].view(hkv, nb, block_size, dh)[:, idx]
    vals = v_pool[layer].view(hkv, nb, block_size, dh)[:, idx]
    keys = keys.reshape(hkv, b, s_tot, dh).float()
    vals = vals.reshape(hkv, b, s_tot, dh).float()
    pos = torch.arange(s_tot, device=q.device)
    valid = pos[None, :] < kv_lens.to(q.device).long()[:, None]      # [B, S]
    vmask = valid[None, :, :, None]
    keys = torch.where(vmask, keys, 0.0)
    vals = torch.where(vmask, vals, 0.0)
    qf = q.float().reshape(b, hkv, g, dh) * scale

    def slot_scales(sc):                                              # [B,Hkv,1,S]
        w = sc[layer].view(hkv, nb, block_size)[:, idx].reshape(hkv, b, s_tot)
        w = torch.where(valid[None], w.float(), 0.0)
        return w.permute(1, 0, 2)[:, :, None, :]

    scores = torch.einsum("bkgd,kbsd->bkgs", qf, keys)
    if k_scale is not None:
        scores = scores * slot_scales(k_scale)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = scores.amax(dim=-1)                                           # [B,Hkv,G]
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m_safe[..., None])
    l = p.sum(dim=-1)
    if v_scale is not None:
        p = p * slot_scales(v_scale)
    acc = torch.einsum("bkgs,kbsd->bkgd", p, vals)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return (out.reshape(b, h, dh).to(q.dtype), m.reshape(b, h),
            l.reshape(b, h))


def paged_attention_decode(
    q: torch.Tensor,             # [B, 1, H, Dh]
    k_pool: torch.Tensor,        # [Hkv, num_slots, Dh]
    v_pool: torch.Tensor,        # [Hkv, num_slots, Dh]
    block_tables: torch.Tensor,  # [B, Mb] int32
    kv_lens: torch.Tensor,       # [B] int32
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [Hkv, num_slots] (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-layer wrapper (``paged_attention_decode_pallas``): the
    normalized output [B, 1, H, Dh] only."""
    b, t, h, dh = q.shape
    if t != 1:
        raise ValueError(f"paged_attention_decode is decode-only (T=1), got T={t}")
    out, _, _ = paged_flash_decode_stats(
        q.reshape(b, h, dh), k_pool[None], v_pool[None], block_tables,
        kv_lens, 0, block_size=block_size, scale=scale,
        k_scale=None if k_scale is None else k_scale[None],
        v_scale=None if v_scale is None else v_scale[None],
    )
    return out.reshape(b, 1, h, dh)


def paged_attention(
    q, k_pool, v_pool, block_tables, kv_lens, q_positions,
    *, block_size: int, scale: Optional[float] = None,
    k_scale=None, v_scale=None,
) -> torch.Tensor:
    """Dispatch by shape (``paged_attention_pallas``): a decode query
    (T == 1) on a shape the kernel takes runs the flash-decode kernel;
    everything else runs ``ops/attention.py:paged_attention_xla``."""
    b, t, h, dh = q.shape
    if t == 1 and supports_paged_decode(dh, block_size):
        return paged_attention_decode(
            q, k_pool, v_pool, block_tables, kv_lens, block_size=block_size,
            scale=scale, k_scale=k_scale, v_scale=v_scale,
        )
    return paged_attention_xla(
        q, k_pool, v_pool, block_tables, kv_lens, q_positions,
        block_size=block_size, scale=scale, k_scale=k_scale, v_scale=v_scale,
    )
