"""ModelRunner: owns the device state and issues the serving dispatches.

Counterpart of ``production_stack_tpu/engine/runner.py`` (main path only):
  * The KV pool is two tensors ``[L, Hkv, num_slots, Dh]`` (the JAX
    layout, so offloaded blocks are the JAX package's bytes), updated IN
    PLACE — the JAX package donated its pools to each dispatch and rebound
    the results. ``kv_cache_dtype="int8"`` stores int8 payload pools plus
    bf16 scale pools ``[L, Hkv, num_slots]``; fresh K/V is quantized once,
    before it is written, and every reader dequantizes
    (ops/quantization.py). ``read_blocks`` / ``write_blocks`` move whole
    blocks between the pools and the host for the offload tier and the
    disagg handoff, in place and on the dispatch stream.
  * A dispatch is issued (``execute_async``: staged, enqueued, no wait)
    and fetched later through its ``DispatchHandle``, so the pipelined
    engine loop can issue the next dispatch first. Every dispatch runs on
    the one current stream; its small host inputs ride ONE int32 buffer
    (the reference's 14-row layout, floats bitcast) copied from a pinned
    staging slot, and its tokens (and, for a batch that asked for
    logprobs, their logprob arrays, f32 as int32 bits) come back into the
    slot's one pinned output behind a CUDA event, which the fetch waits on.
  * Logprobs: a batch's ``logprobs_k`` is the largest bucket among its
    rows (``LOGPROB_BUCKETS``); the decode train's logprob variant and the
    prefill's final sample compute them from the raw logits on the device,
    and the fetch cuts each row's entries to its own width.
  * A prefill dispatch runs the chunk of ``engine/prefill_graphs.py``
    (slot mappings, the history window gathered once, the forward, the
    draft over the chunk, every row's sample from its last token's logits,
    the one scatter of the chunk's KV), replayed from the CUDA graph
    ``warmup`` captured for its (b, t, mb, has_window) family and sampling
    variant, or eagerly. Its rows, chunk length and block-table width pad
    to the reference's families: rows to 1 or the ``max_prefill_seqs``
    bucket (``prefill_rows``); padding rows have chunk length 0 and table
    0 and write only the null block (and the draft rings' trash slot). On
    a mesh of more than one rank nothing is captured and rows are not
    padded.
  * A decode dispatch runs the fused K-step train of
    ``engine/decode_graphs.py`` (head / step / tail), replayed from CUDA
    graphs captured by ``warmup`` for its (b, mb, K) family, or eagerly.
    Rows pad to the power-of-two ``b`` bucket; padding rows have budget 0
    and table 0 and write only the null block.
  * Token chaining: a dispatch's last-token vector stays on the device
    (``_chains``); a decode whose rows' previous tokens are not applied on
    the host yet reads them there (``chain_src``), all from ONE source
    dispatch (the scheduler keeps fresh prefill rows out of decode until
    their prefill applies).
  * Seeds are derived on the device from ``seed_base`` and ``gen0``.
  * Speculative decoding (``speculative_num_tokens`` N > 0; the reference's
    spec state and ``_decode_spec``): the draft model's params (shared with
    the target for a self-draft) and its per-sequence KV rings
    ``[Ld, Hd, S + 1, R, Dd]`` (S slots, the last one the trash of padding
    rows; R ring tokens) in the compute dtype, updated in place. Prefill
    runs the draft over each chunk into the row's ring; a row whose context
    the ring has not seen (a prefix-cache hit, a restore, a handoff) is
    caught up by a draft ingest before its prefill or decode
    (``engine/ingest_graphs.py``: one CUDA graph per token bucket, replayed
    at dp = 1 after warm-up). A
    decode dispatch runs the speculative train of ``decode_graphs.py``
    (draft N + 1, verify once, accept on the device); its fetch returns
    each row's accepted tokens, a variable count, and feeds the adaptive
    controller (``SpecGammaController``); a batch whose rows all sit at
    gamma 0 runs the plain train (``spec_gamma0_dispatches_total``).
  * Weights: a local HF checkpoint directory (``config.model``, and the
    speculative draft's) is loaded by ``models/weights.py:load_hf_params``
    straight into device stacks (this rank's shard); a named config, or
    ``load_format="dummy"``, draws random weights from ``seed``. With
    ``overlap_weight_load`` (the server's default; warm-up on, tp 1, no
    speculation, no params given) every leaf and the f32 head are
    allocated first, the pool is sized, and a ``weight-loader`` thread
    fills them in place while ``warmup`` builds the kernels and runs the
    eager warm runs; ``warmup`` joins it before the first capture.
  * Fast start: ``compilation_cache_dir`` holds the reference's warm-up
    manifest (``_warmup_manifest_path``); a start that finds its own
    captures the default sampling variants only and each other variant
    at its first dispatch (``_first_use``). No graph persists.
  * LoRA: the engine's registry (``models/lora.py``) is stacked once on the
    device; each row's adapter index rides packed scalar row 8 of prefill
    and decode dispatches, and the prefill forward, the decode step and the
    speculative verify add the per-row delta (the draft runs the base
    model, as the reference's).
  * The mesh (dp x sp x tp ranks, one process each, ``parallel/``): each
    rank's runner holds its tp shard of the params and the pools of its kv
    heads, and every dispatch splits in two. The host part, on rank 0
    only, packs the int32 buffer from the ``ScheduledBatch``; the device
    part runs on every rank from a descriptor (kind, shape key,
    ``n_steps``, ``finals``, penalty counts, chain source and the packed
    buffer) that rank 0 broadcasts on the mesh's CPU group right before its
    own device part. Chains are kept per dispatch number on every rank, so
    a worker needs no ``Sequence``. Every rank samples from the same full
    logits with the same seeds, so start tokens chain on every rank without
    a broadcast; only rank 0 copies tokens to the host. Each rank keeps a
    device digest of the tokens it sampled, reported with its launch
    counts and ring counts (``tp_query``) and at ``tp_stop``. A prefill
    chunk of an sp engine rings its attention over the sp ranks under the
    reference's condition (``PrefillTrain.ring``); decode runs whole on every
    rank. Block I/O is a descriptor too (``KV_READ`` / ``KV_WRITE``): the
    (0, 0) tp group's ranks select their kv heads and rank 0 gathers them
    (a replicated pool is read on rank 0 alone), and every rank of every
    replica writes its heads of a blob rank 0 scatters, so a blob holds the
    whole logical block at any mesh. A speculative engine (dp replicas)
    sends its device work the same way: ``SPEC_DECODE`` (the packed buffer
    carries each row's draft-ring slot and draft depth, rank 0's choices),
    ``SPEC_INGEST`` (a catch-up) and ``SPEC_RESET`` (a fresh slot), and a
    prefill's draft pass runs inside its chunk on every rank; each rank
    reports a digest of its draft rings beside its pool's. Locks, always
    in this order: the mesh's ``lock`` (rank 0, world > 1), then
    ``kv_io_lock``.
"""

import contextlib
import hashlib
import json
import os
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.decode_graphs import (
    NUM_SCALARS,
    POS_SENTINEL,
    DecodeTrain,
    FamilyKey,
)
from production_stack_tpu_torch.engine.ingest_graphs import (
    INGEST_SCALARS,
    IngestTrain,
)
from production_stack_tpu_torch.engine.prefill_graphs import (
    PrefillKey,
    PrefillTrain,
)
from production_stack_tpu_torch.engine.sampling import (
    LOGPROB_BUCKETS,
    adaptive_gamma,
    logprobs_bucket,
    seed_base,
)
from production_stack_tpu_torch.engine.scheduler import (
    INTERACTIVE_DECODE_STEPS,
    ScheduledBatch,
    decode_step_cap,
)
from production_stack_tpu_torch.kv_offload.serde import BF16, dtype_name
from production_stack_tpu_torch.models import empty_params, get_model_fns
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.lora import shard_stacks
from production_stack_tpu_torch.models.weights import dtype_of, load_hf_params
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.ops.attention import QBLOCK
from production_stack_tpu_torch.ops.quantization import SCALE_DTYPE
from production_stack_tpu_torch.ops.tree_mask import (
    main_chain_indices,
    tree_attention_bias,
    tree_structure,
)
from production_stack_tpu_torch.parallel import mesh as pmesh
from production_stack_tpu_torch.parallel.sharding import (
    join_kv_blocks,
    shard_kv_blocks,
    shard_params,
)
from production_stack_tpu_torch.utils import (
    init_logger,
    pow2_bucket as _bucket,
    prefill_t_floor,
    resolve_device,
    window_mb_bucket,
)

logger = init_logger(__name__)

# Staging slots: a slot is reused four dispatches later; with at most two
# dispatches outstanding, its copies have run and its fetch has read it.
_NUM_SLOTS = 4


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host tensor as numpy (bfloat16 as ``serde.BF16``, the same
    bytes)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16)
    return t.numpy()


_TORCH_OF = {np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
             np.dtype(np.float16): torch.float16,
             np.dtype(np.float32): torch.float32}


def _to_torch(arr: np.ndarray, pin: bool = False) -> torch.Tensor:
    """A numpy array (bfloat16 as ``serde.BF16`` or ml_dtypes') copied into
    a host tensor of its dtype, in pinned memory when ``pin``."""
    bf16 = dtype_name(arr.dtype) == "bfloat16"
    src = arr.view(np.int16) if bf16 else arr
    t = torch.empty(src.shape, dtype=_TORCH_OF[src.dtype], pin_memory=pin)
    np.copyto(t.numpy(), src, casting="no")
    return t.view(torch.bfloat16) if bf16 else t


def resolve_cache_dir(base: str, device: torch.device) -> Optional[str]:
    """``--compilation-cache-dir``'s directory for this card and toolchain
    (the reference's ``_setup_compilation_cache``): ``base`` joined with
    ``cuda-<device name>-torch<version>-cuda<version>``, sanitised as the
    reference sanitises its fingerprint, created when missing. None, with
    a warning, when it cannot be made: that start warms every variant and
    writes no manifest (a cache failure never fails a start)."""
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    fingerprint = re.sub(
        r"[^A-Za-z0-9_.-]+", "-",
        f"{device.type}-{kind}-torch{torch.__version__}"
        f"-cuda{torch.version.cuda}")
    path = os.path.join(base, fingerprint)
    try:
        os.makedirs(path, exist_ok=True)
    except OSError:
        logger.warning("--compilation-cache-dir %r is unusable: warm-up "
                       "captures every variant, and no manifest is written",
                       base, exc_info=True)
        return None
    return path


class DispatchHandle:
    """An issued dispatch: ``fetch()`` waits for its event and returns
    (each row's tokens, each row's logprob entries or None) from its pinned
    output (called once)."""

    __slots__ = ("fetch",)

    def __init__(self, fetch):
        self.fetch = fetch


class _Slot:
    """Host memory of one dispatch in flight: the packed input it stages
    and the tokens it fetches (pinned on the card), and the events around
    its device work (``end`` follows its last copy)."""

    __slots__ = ("inp", "out", "start", "end")

    def __init__(self):
        self.inp = self.out = self.start = self.end = None


# Token digest: digest = (digest * _DIGEST_MULT + sum(tokens * weights))
# mod _DIGEST_MOD, weights 1..65521 by position; int64 never overflows.
_DIGEST_MULT = 1000003
_DIGEST_MOD = 2147483647
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32}


class SpecGammaController:
    """Host-side per-sequence draft-depth controller (the reference's):
    an acceptance EMA per request from the per-row draft/accept counts
    every speculative fetch reads, and each row's next depth from
    ``adaptive_gamma``. A row at gamma 0 is re-probed with gamma 1 every
    ``probe_period`` dispatches. Deterministic given its observations."""

    def __init__(self, n_max: int, decay: float, threshold: float,
                 probe_period: int):
        self.n_max = n_max
        self.decay = decay
        self.threshold = threshold
        self.probe_period = probe_period
        self._ema: Dict[str, float] = {}
        self._since_probe: Dict[str, int] = {}

    def update(self, request_id: str, drafted: int, accepted: int) -> None:
        """Fold one dispatch's (drafted, accepted) counts into the
        request's EMA; a dispatch that drafted nothing is no observation."""
        if drafted <= 0:
            return
        obs = min(1.0, accepted / drafted)
        prev = self._ema.get(request_id, 1.0)
        self._ema[request_id] = (1.0 - self.decay) * prev + self.decay * obs

    def gamma(self, request_id: str) -> int:
        """Draft depth of the request's NEXT dispatch (full depth before
        the first observation)."""
        g = adaptive_gamma(self._ema.get(request_id, 1.0), self.n_max,
                           self.threshold)
        if g == 0 and self.probe_period > 0:
            waited = self._since_probe.get(request_id, 0) + 1
            if waited >= self.probe_period:
                self._since_probe[request_id] = 0
                return 1
            self._since_probe[request_id] = waited
        return g

    def ema(self, request_id: str) -> float:
        return self._ema.get(request_id, 1.0)

    def forget(self, request_id: str) -> None:
        self._ema.pop(request_id, None)
        self._since_probe.pop(request_id, None)

    def mean_ema(self) -> float:
        """Mean EMA over tracked sequences (pstpu:spec_acceptance_ema)."""
        if not self._ema:
            return 0.0
        return sum(self._ema.values()) / len(self._ema)


class ModelRunner:
    def __init__(self, config: EngineConfig, model_config: ModelConfig,
                 params: Optional[Dict] = None,
                 num_kv_blocks: Optional[int] = None,
                 mesh: Optional[pmesh.RankMesh] = None,
                 broadcast_params: bool = False,
                 draft_params: Optional[Dict] = None,
                 lora_registry=None,
                 broadcast_draft_params: bool = False):
        """``mesh``: this process's rank of the dp x sp x tp mesh (None on
        one rank). ``params`` are FULL params; on a mesh rank 0's are
        broadcast to the workers (which pass ``broadcast_params``) and each
        rank keeps its tp shard. Without ``params`` every rank loads
        its shard of the checkpoint directory ``config.model``, or draws it
        from config.seed (``_load_or_init_params``). ``draft_params``: the
        speculative draft's params when it is not the target itself (else
        loaded or drawn the same way); on a mesh rank 0's are broadcast
        to the workers (which pass ``broadcast_draft_params``), as the
        target's are. ``lora_registry``: the engine's
        ``models/lora.py:LoRARegistry`` (None: no adapters)."""
        self.config = config
        self.model_config = model_config
        if (mesh.size if mesh is not None else 1) != config.mesh_devices:
            raise ValueError(
                f"a mesh of {config.mesh_devices} ranks needs a rank mesh of "
                f"that size, got {mesh.size if mesh else None}")
        # The mesh (None on one rank), this rank's tp group and sp ring
        # (None where that degree is 1), its global and tp ranks.
        self.mesh = mesh if config.mesh_devices > 1 else None
        self.tp = self.mesh.tp if self.mesh is not None else None
        self.sp = self.mesh.sp if self.mesh is not None else None
        self.rank = self.mesh.rank if self.mesh is not None else 0
        self.tp_rank = self.tp.rank if self.tp is not None else 0
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(config.device))
        # (init_params, forward, compute_logits, lm_head_f32) of the arch:
        # llama, or OPT (window path, no chunk rings).
        init_fn, self.model_forward, self.model_logits, head_fn = \
            get_model_fns(model_config)
        # "paged": decode attends against the pool inside the CUDA
        # flash-decode kernel (its plain twin on the CPU). "window": decode
        # gathers the live KV into a contiguous per-dispatch window.
        self.attn_impl = config.resolved_attn_impl(model_config)
        self.dtype = dtype_of(config.dtype)
        self.kv_quantized = config.kv_cache_quantized
        # Tokens written to a quantized pool (prefill + decode), for
        # kv_quant_bytes_saved_total.
        self.kv_quant_tokens_written = 0
        tp_size = config.tensor_parallel_size
        self.local_kv_heads = config.local_kv_heads(model_config)
        if self.mesh is not None and (params is not None or broadcast_params):
            params = self.mesh.broadcast_params(params)
        # Start telemetry (the reference's): the loader's wall seconds, the
        # warm-up seconds that ran beside it, and the warm-up's variant
        # counts; the port adds the deferred variants' first-use captures.
        self.startup_weight_load_seconds = 0.0
        self.startup_compile_seconds = 0.0
        self.startup_cache_hit_families = 0
        self.startup_cache_miss_families = 0
        self.startup_deferred_families = 0
        self.startup_phase_seconds: Dict[str, float] = {}
        self.deferred_captures_total = 0
        self.deferred_capture_seconds_total = 0.0
        # --compilation-cache-dir: the warm-up manifest's directory (None:
        # every start warms every variant).
        self.compilation_cache_path = (
            resolve_cache_dir(config.compilation_cache_dir, self.device)
            if config.compilation_cache_dir else None)
        self._manifest: Optional[str] = None
        self._verified = False
        self._warmed_up = False
        # The overlapped load (the reference's conditions; on a mesh the
        # load stays serial): every leaf and the f32 head are allocated
        # here, so the KV pool below is sized net of them, and the
        # ``weight-loader`` thread, started at the end of __init__, fills
        # them in place while warm-up runs.
        self._param_thread: Optional[threading.Thread] = None
        self._param_error: Optional[BaseException] = None
        self._weights_done_at: Optional[float] = None
        overlap = (params is None and self.mesh is None
                   and config.enable_warmup and config.overlap_weight_load
                   and not config.speculative_enabled)
        t0 = time.monotonic()
        if overlap:
            params = empty_params(model_config, self.dtype, self.device)
        elif params is None:
            params, _ = self._load_or_init_params(model_config, config.model,
                                                  init_fn)
        else:
            params = shard_params(params, model_config, self.tp_rank, tp_size)
            params = {
                k: ({n: t.to(self.device, self.dtype) for n, t in v.items()}
                    if k == "layers" else v.to(self.device, self.dtype))
                for k, v in params.items()
            }
        self.params = params
        if overlap:
            shape = head_fn(empty_params(model_config, self.dtype,
                                         torch.device("meta")),
                            model_config).shape
            self.head_f32 = torch.zeros(shape, dtype=torch.float32,
                                        device=self.device)
        else:
            self.head_f32 = head_fn(params, model_config)
            self.startup_weight_load_seconds = time.monotonic() - t0
        # Every registered LoRA adapter stacked per target, on the device
        # (this rank's slice at tp > 1): rows select theirs by the index in
        # packed scalar row 8 (models/lora.py). None without adapters.
        self.lora_stacks = (
            shard_stacks(lora_registry.stacks(self.device), self.tp_rank,
                         tp_size)
            if lora_registry is not None else None)
        self._init_spec(draft_params, broadcast_draft_params)
        # Its peak is reserved when the pool is sized.
        self.ingest_train = IngestTrain(self)
        if self.mesh is not None:
            # Every rank's weights are resident before any rank reads the
            # free memory its pool may take.
            self.mesh.barrier()
        # Set by _derive_num_blocks when the pool is sized from free memory.
        self.prefill_reserve_bytes = 0
        self.kv_blocks_without_prefill_graphs: Optional[int] = None
        self.kv_blocks_free_memory: Optional[int] = None
        # The overlapped loader's temporaries come after the pool is sized
        # (on the card they are reserved; a serial load's are freed before).
        self.loader_reserve_bytes = (
            self._loader_peak_bytes(model_config)
            if overlap and self.device.type == "cuda" else 0)
        n = num_kv_blocks or config.num_kv_blocks or self._derive_num_blocks()
        if self.mesh is not None:
            # Block ids are global: every rank holds the same count.
            n = self.mesh.min_int(n)
        self.num_kv_blocks = n
        self._alloc_kv_pools()
        # Every dispatch runs on the stream current when the runner was
        # built (the device's default stream); the offload tier's block
        # reads and writes are enqueued on the same stream, from whichever
        # thread, so they run in enqueue order with the dispatches. The
        # lock keeps a spill read out of a graph capture window.
        self.dispatch_stream = (torch.cuda.current_stream(self.device)
                                if self.device.type == "cuda" else None)
        self.kv_io_lock = threading.Lock()
        self.b_max = _bucket(config.max_num_seqs, 1, max(1, config.max_num_seqs))
        # Device-resident last-token vectors of recent token-producing
        # dispatches, newest first, on every rank: (dispatch number, [b_max]
        # int32). Rank 0 keeps their rows beside them, {"dispatch": n,
        # "row": {rid: row}, "epoch": {rid: preemptions}}. With at most
        # pipeline_depth dispatches outstanding, the newest max(2, depth)
        # entries cover every chainable row.
        self._chain_last: List[Tuple[int, torch.Tensor]] = []
        self._chain_rows: List[Dict] = []
        self._max_chains = max(2, config.pipeline_depth)
        self._dispatches = 0
        # When a list: each dispatch appends its full f32 logits (prefill:
        # [b, V]; each decode step: [b bucket, V]), for a caller that reads
        # them (chip_smoke.py's teacher-forced check).
        self.logits_sink: Optional[List[torch.Tensor]] = None
        self._digest = (torch.zeros((1,), dtype=torch.int64, device=self.device)
                        if self.mesh is not None else None)
        self.decode_train = DecodeTrain(self)
        self.prefill_train = PrefillTrain(self)
        self._slots = [_Slot() for _ in range(_NUM_SLOTS)]
        self._slot_idx = 0
        # Host clock from issue to fetch per dispatch (pipelined dispatches
        # overlap, so these sums can exceed the wall time), and decode
        # device time between CUDA events around each dispatch (0 on the
        # CPU: not measured there).
        self.prefill_seconds_total = 0.0
        self.decode_seconds_total = 0.0
        self.decode_device_seconds_total = 0.0
        self.decode_steps_total = 0       # fused steps executed
        self.decode_tokens_total = 0      # tokens within row budgets
        # Decode dispatches that read start tokens on the device.
        self.chained_dispatches_total = 0
        # Embedding forwards (runner.embed): calls and their host seconds.
        self.embed_calls_total = 0
        self.embed_seconds_total = 0.0
        # Every rank's report at start (device, pool and weight bytes).
        self.rank_info: List[Dict] = [self._rank_report()]
        if self.mesh is not None:
            self.rank_info = self.mesh.gather_object(self.rank_info[0])
        if overlap:
            # Last: the pool above reserved the loader's temporaries
            # (``loader_reserve_bytes``).
            self._start_loader(init_fn, head_fn)

    def _load_or_init_params(self, model_config: ModelConfig, source: str,
                             init_fn, out: Optional[Dict] = None
                             ) -> Tuple[Dict, bool]:
        """A model's params (this rank's shard) on the device: loaded from
        the local HF checkpoint directory ``source``, or drawn from
        config.seed (named configs, ``load_format="dummy"``), into ``out``
        (``models.empty_params``) when given. ONE loader for the target and
        the speculative draft (the reference's). Returns (params,
        loaded_from_checkpoint). A checkpoint with a missing tensor raises:
        nothing falls back to random weights."""
        cfg = self.config
        tp_size = cfg.tensor_parallel_size
        if cfg.load_format != "dummy" and os.path.isdir(source):
            return load_hf_params(model_config, source, self.dtype,
                                  self.device, rank=self.tp_rank,
                                  tp=tp_size, out=out), True
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        return init_fn(model_config, gen, self.dtype, self.device,
                       rank=self.tp_rank, tp=tp_size, out=out), False

    # ------------------------------------------------------ overlapped load
    def _start_loader(self, init_fn, head_fn) -> None:
        """Fill ``params`` and ``head_f32`` in place on the ``weight-loader``
        thread (the reference's ``_load_params_background``), on a stream
        of its own that first waits for their zero fills."""
        stream = None
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(torch.cuda.current_stream(self.device))
        self._param_thread = threading.Thread(
            target=self._load_params_background,
            args=(init_fn, head_fn, stream), daemon=True,
            name="weight-loader")
        self._param_thread.start()

    def _load_params_background(self, init_fn, head_fn, stream) -> None:
        t0 = time.monotonic()
        try:
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                self._load_or_init_params(self.model_config, self.config.model,
                                          init_fn, out=self.params)
                head_fn(self.params, self.model_config, out=self.head_f32)
            if stream is not None:
                stream.synchronize()
        except BaseException as e:  # re-raised by wait_for_weights
            self._param_error = e
        finally:
            self._weights_done_at = time.monotonic()
            self.startup_weight_load_seconds = self._weights_done_at - t0

    def _loader_peak_bytes(self, model_config: ModelConfig) -> int:
        """The loader's largest transient on the device, reckoned from the
        shapes: its largest single draw or checkpoint tensor (a top-level
        leaf, or one layer of a stacked one) read in f32 and cast to the
        compute dtype, both alive at once (``init_params``,
        ``load_hf_params``)."""
        meta = empty_params(model_config, self.dtype, torch.device("meta"))
        numel = max([t.numel() for k, t in meta.items() if k != "layers"]
                    + [t[0].numel() for t in meta["layers"].values()])
        return numel * (4 + self.dtype.itemsize)

    @property
    def weights_ready(self) -> bool:
        """The weights are all in place: a serial load, or the loader
        thread ended without an error."""
        t = self._param_thread
        return (t is None or not t.is_alive()) and self._param_error is None

    def wait_for_weights(self) -> None:
        """Join the weight loader (no-op once joined, or after a serial
        load) and re-raise its error, every time: a broken checkpoint fails
        the start as the serial path does, and nothing serves after it."""
        t = self._param_thread
        if t is not None:
            t.join()
            self._param_thread = None
        if self._param_error is not None:
            raise self._param_error

    # ------------------------------------------------------------------ sizing
    def _alloc_kv_pools(self) -> None:
        """Payload pools in the storage dtype, plus (int8) the per-(slot,
        head) scale pools."""
        mc, cfg = self.model_config, self.config
        num_slots = self.num_kv_blocks * cfg.block_size
        shape = (mc.num_layers, self.local_kv_heads, num_slots, mc.head_dim_)
        store = torch.int8 if self.kv_quantized else self.dtype
        self.kv_k = torch.zeros(shape, dtype=store, device=self.device)
        self.kv_v = torch.zeros(shape, dtype=store, device=self.device)
        if self.kv_quantized:
            self.kv_k_scale = torch.zeros(shape[:-1], dtype=SCALE_DTYPE,
                                          device=self.device)
            self.kv_v_scale = torch.zeros_like(self.kv_k_scale)
        else:
            self.kv_k_scale = self.kv_v_scale = None

    # -------------------------------------------------- speculative state
    def _init_spec(self, draft_params: Optional[Dict],
                   broadcast_draft: bool = False) -> None:
        """The draft model, its ring pools (allocated before the KV pool is
        sized from free memory), slots, tree constants, controller and the
        acceptance counters (the reference's spec ``__init__`` block). On a
        mesh (dp replicas: speculation is served at tp = sp = 1) every rank
        holds the same draft and rings; rank 0 alone decides slots and
        draft depths, and sends them in its descriptors."""
        cfg = self.config
        self.spec_n = int(cfg.speculative_num_tokens)
        self.spec_tree_width = int(cfg.speculative_tree_width)
        self.spec_adaptive = bool(cfg.speculative_adaptive)
        self._spec_controller: Optional[SpecGammaController] = None
        # Counters (accumulated at fetch): proposals drafted and accepted,
        # tree nodes verified, the served depth's numerator, per-row live
        # cycles, all-gamma-0 dispatches; per dispatch: cycles run and the
        # most live cycles of a row (their difference is replay waste).
        self.spec_draft_tokens_total = 0
        self.spec_accepted_tokens_total = 0
        self.spec_tree_nodes_total = 0
        self.spec_draft_depth_sum = 0
        self.spec_live_cycles_total = 0
        self.spec_gamma0_dispatches_total = 0
        self.spec_cycles_run_total = 0
        self.spec_cycles_live_total = 0
        self.spec_dispatches_total = 0
        # Draft catch-ups this rank ran (every rank of a mesh counts its
        # own: its report shows them).
        self.spec_ingests_total = 0
        self._spec_window: "deque[Tuple[int, int]]" = deque(maxlen=64)
        if not self.spec_n:
            self.spec_ring_len = 1
            return
        self.spec_draft_config = dmc = cfg.resolved_draft_config()
        d_init, self.draft_forward, self.draft_logits, d_head = \
            get_model_fns(dmc)
        if cfg.speculative_model == cfg.model:
            # Self-draft: the target's params outright.
            self.spec_params, self.spec_head_f32 = self.params, self.head_f32
        else:
            if self.mesh is not None and (draft_params is not None
                                          or broadcast_draft):
                draft_params = self.mesh.broadcast_params(draft_params)
            if draft_params is None:
                draft_params, loaded = self._load_or_init_params(
                    dmc, cfg.speculative_model, d_init)
                if not loaded and cfg.load_format != "dummy":
                    logger.warning(
                        "speculative draft %r has RANDOM weights (config.seed "
                        "%d; not a local checkpoint dir): expect ~zero "
                        "acceptance — speculation will cost throughput, not "
                        "add it", cfg.speculative_model, cfg.seed)
            else:
                draft_params = {
                    k: ({n: t.to(self.device, self.dtype)
                         for n, t in v.items()}
                        if k == "layers" else v.to(self.device, self.dtype))
                    for k, v in draft_params.items()}
            self.spec_params = draft_params
            self.spec_head_f32 = d_head(draft_params, dmc)
        self.spec_ring_len = cfg.speculative_ring_len
        # Every running row plus a prefill batch of fresh prompts can hold
        # a slot at once; LRU eviction is the backstop.
        self.spec_num_slots = cfg.max_num_seqs + cfg.max_prefill_seqs
        self._alloc_spec_pools()
        self._spec_slots: "OrderedDict[str, int]" = OrderedDict()
        self._spec_free = list(range(self.spec_num_slots))
        # Per request: the position (exclusive) its draft ring is warm to.
        self._spec_warmed: Dict[str, int] = {}
        if self.spec_tree_width > 1:
            parents, depths = tree_structure(self.spec_n, self.spec_tree_width)
            self.spec_tree_parents, self.spec_tree_depths = parents, depths
            self.spec_tree_depths_dev = torch.from_numpy(
                depths.astype(np.int64)).to(self.device)
            self.spec_tree_bias = torch.from_numpy(
                tree_attention_bias(parents)).to(self.device)
            self.spec_main_chain = main_chain_indices(self.spec_n,
                                                      self.spec_tree_width)
            self.spec_main_chain_dev = torch.from_numpy(
                self.spec_main_chain.astype(np.int64)).to(self.device)
        if self.spec_adaptive:
            self._spec_controller = SpecGammaController(
                self.spec_n, cfg.speculative_ema_decay,
                cfg.speculative_gamma_threshold, cfg.speculative_probe_period)

    def _alloc_spec_pools(self) -> None:
        """Draft-KV ring pools [Ld, Hd, S + 1, R, Dd] in the compute dtype
        and the position plane [S + 1, R] (sentinel = unwritten); slot S is
        the trash of padding rows."""
        dmc = self.spec_draft_config
        s, r = self.spec_num_slots + 1, self.spec_ring_len
        shape = (dmc.num_layers, dmc.num_kv_heads, s, r, dmc.head_dim_)
        self.spec_k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.spec_v = torch.zeros_like(self.spec_k)
        self.spec_pos = torch.full((s, r), POS_SENTINEL, dtype=torch.int32,
                                   device=self.device)
        logger.info("Speculative draft-KV rings: %d slots x %d tokens "
                    "(%.1f MiB, draft=%s)", s - 1, r,
                    2 * self.spec_k.numel() * self.spec_k.element_size()
                    / 2**20, dmc.name)

    @property
    def spec_pool_bytes(self) -> int:
        if not self.spec_n:
            return 0
        return sum(t.numel() * t.element_size()
                   for t in (self.spec_k, self.spec_v, self.spec_pos))

    def spec_slot(self, request_id: str) -> int:
        """Get or allocate the sequence's draft-ring slot; a fresh one has
        its positions reset (LRU eviction when none is free)."""
        slot = self._spec_slots.get(request_id)
        if slot is not None:
            self._spec_slots.move_to_end(request_id)
            return slot
        if self._spec_free:
            slot = self._spec_free.pop()
        else:
            evicted, slot = self._spec_slots.popitem(last=False)
            # The evicted stream's ring is gone: so is its warm ledger.
            self._spec_warmed.pop(evicted, None)
            logger.warning(
                "Draft-ring slots exhausted; evicting %s (cold draft "
                "context lowers acceptance for that stream only)", evicted)
        with self._dispatch_lock():
            if self.mesh is not None:
                self.mesh.send_header(pmesh.SPEC_RESET, slot)
            self._spec_reset_device(slot)
        self._spec_slots[request_id] = slot
        self._spec_warmed[request_id] = 0
        return slot

    def _spec_reset_device(self, slot: int) -> None:
        """The device part of a fresh slot, on every rank: its ring
        positions back to the sentinel (unwritten)."""
        with self._io_stream():
            self.spec_pos[slot].fill_(POS_SENTINEL)

    def release_spec_slot(self, request_id: str) -> None:
        """Return a finished sequence's draft-ring slot (idempotent)."""
        if not self.spec_n:
            return
        self._spec_warmed.pop(request_id, None)
        if self._spec_controller is not None:
            self._spec_controller.forget(request_id)
        slot = self._spec_slots.pop(request_id, None)
        if slot is not None:
            self._spec_free.append(slot)

    @property
    def spec_draft_max_pos(self) -> int:
        """Position clamp of DRAFT forwards: any position for rotary
        (llama) drafts, the table size for OPT's learned positions."""
        dmc = self.spec_draft_config
        if dmc.arch == "opt":
            return min(self.config.max_model_len, dmc.max_position_embeddings)
        return self.config.max_model_len

    def _spec_ring_write(self, dk, dv, positions, keep, slot_idx,
                         reset) -> None:
        """Run-once draft ring update of rows ``slot_idx`` [b] from a draft
        forward's K/V [Ld, Hd, b, t, Dd] at ``positions`` [b, t], entries
        where ``keep``; rows where ``reset`` first forget their ring. The
        rings are gathered, written through a trash row and scattered back
        in place (the decode graphs hold the pools' addresses). Each row
        reads the ring it writes back, so a row naming the trash slot
        ``spec_num_slots`` touches no other."""
        b = slot_idx.shape[0]
        r_len = self.spec_ring_len
        slot_c = slot_idx.long()
        ld, hd, dd = dk.shape[0], dk.shape[1], dk.shape[-1]
        drk = torch.empty((ld, hd, b + 1, r_len, dd), dtype=self.dtype,
                          device=self.device)
        drv = torch.empty_like(drk)
        drp = torch.empty((b + 1, r_len), dtype=torch.int32, device=self.device)
        drk[:, :, :b] = self.spec_k[:, :, slot_c]
        drv[:, :, :b] = self.spec_v[:, :, slot_c]
        drp[:b] = torch.where(reset[:, None], POS_SENTINEL,
                              self.spec_pos[slot_c])
        rows = torch.arange(b, device=self.device)[:, None]
        widx = torch.where(keep, rows * r_len + positions % r_len,
                           b * r_len).reshape(-1)
        t = positions.shape[1]
        drk.view(ld, hd, -1, dd).index_copy_(2, widx, dk.reshape(ld, hd, b * t, dd))
        drv.view(ld, hd, -1, dd).index_copy_(2, widx, dv.reshape(ld, hd, b * t, dd))
        drp.view(-1).index_copy_(0, widx, positions.reshape(-1).int())
        self.spec_k.index_copy_(2, slot_c, drk[:, :, :b])
        self.spec_v.index_copy_(2, slot_c, drv[:, :, :b])
        self.spec_pos.index_copy_(0, slot_c, drp[:b])

    def _spec_catch_up(self, seq, upto: int) -> None:
        """Ensure the sequence's draft ring covers context up to ``upto``
        (exclusive): ingest the most recent min(R, upto) tokens it has not
        seen, through the draft (the reference's ``_spec_catch_up`` and
        ``_spec_ingest_jit``): the bucket's graph replayed at dp = 1 after
        warm-up, else ``IngestTrain.body`` eagerly (on a mesh a
        ``SPEC_INGEST`` descriptor runs it on every rank). Acceptance only,
        never output correctness. Its host seconds count by bucket."""
        rid = seq.request_id
        warmed = self._spec_warmed.get(rid, 0)
        if warmed >= upto:
            return
        t0 = time.perf_counter()
        lo = max(0, upto - self.spec_ring_len, min(warmed, upto))
        toks = seq.all_token_ids[lo:upto]
        if not toks:
            self._spec_warmed[rid] = upto
            return
        slot = self.spec_slot(rid)
        train = self.ingest_train
        t = train.bucket(len(toks))
        packed = train.host_packed(t, lo, len(toks), slot)
        packed.numpy()[INGEST_SCALARS:INGEST_SCALARS + len(toks)] = toks
        with self._dispatch_lock():
            if self.mesh is not None:
                self.mesh.send_header(pmesh.SPEC_INGEST, slot, lo, len(toks),
                                      t)
                self.mesh.bcast(packed[INGEST_SCALARS:])
            self._spec_ingest_device(packed)
        self._spec_warmed[rid] = upto
        host = train.host_by_bucket.setdefault(t, [0, 0.0])
        host[0] += 1
        host[1] += time.perf_counter() - t0

    def _spec_ingest_device(self, packed: torch.Tensor) -> None:
        """The device part of a catch-up, on every rank: ``packed``
        (``IngestTrain.host_packed``: lo, n, the slot, then the bucket's
        tokens) staged into the ingest arena on the dispatch stream, then
        the bucket's graph or ``IngestTrain.body`` eagerly."""
        train = self.ingest_train
        self.spec_ingests_total += 1
        with torch.no_grad(), self._io_stream():
            bf = train.stage(packed)
            train.run(bf.t, bf)

    @property
    def spec_acceptance_rate(self) -> float:
        """Lifetime share of draft proposals that survived verification."""
        if not self.spec_draft_tokens_total:
            return 0.0
        return self.spec_accepted_tokens_total / self.spec_draft_tokens_total

    @property
    def spec_acceptance_rate_window(self) -> float:
        """Acceptance over the last <= 64 fetches."""
        drafts = sum(d for d, _ in self._spec_window)
        if not drafts:
            return 0.0
        return sum(a for _, a in self._spec_window) / drafts

    @property
    def spec_draft_depth_mean(self) -> float:
        """Mean served draft depth per live verify cycle."""
        if not self.spec_live_cycles_total:
            return 0.0
        return self.spec_draft_depth_sum / self.spec_live_cycles_total

    @property
    def spec_acceptance_ema_mean(self) -> float:
        if self._spec_controller is None:
            return 0.0
        return self._spec_controller.mean_ema()

    def spec_stats(self) -> Dict:
        """The reference's ``stats()`` spec keys, and the port's cycle
        counts (cycles run against the most live cycles of a row)."""
        return {
            "spec_enabled": 1 if self.spec_n else 0,
            "spec_draft_tokens_total": self.spec_draft_tokens_total,
            "spec_accepted_tokens_total": self.spec_accepted_tokens_total,
            "spec_acceptance_rate": self.spec_acceptance_rate,
            "spec_acceptance_rate_window": self.spec_acceptance_rate_window,
            "spec_draft_depth": self.spec_draft_depth_mean,
            "spec_tree_nodes_total": self.spec_tree_nodes_total,
            "spec_acceptance_ema": self.spec_acceptance_ema_mean,
            "spec_gamma0_dispatches_total": self.spec_gamma0_dispatches_total,
            "spec_live_cycles_total": self.spec_live_cycles_total,
            "spec_dispatches_total": self.spec_dispatches_total,
            "spec_cycles_run_total": self.spec_cycles_run_total,
            "spec_cycles_live_total": self.spec_cycles_live_total,
            "spec_pool_bytes": self.spec_pool_bytes,
        }

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the whole KV pool, payload + scale pools, over
        all ranks of the mesh."""
        return (self.num_kv_blocks * self.config.mesh_devices
                * self.config.kv_cache_bytes_per_block(self.model_config))

    @property
    def hbm_kv_bytes(self) -> int:
        """Device bytes this rank's pool tensors occupy."""
        pools = [self.kv_k, self.kv_v, self.kv_k_scale, self.kv_v_scale]
        return sum(t.numel() * t.element_size() for t in pools if t is not None)

    def per_device_hbm_kv_bytes(self) -> Dict[str, int]:
        """Each rank's pool bytes (as the rank measured them at start),
        keyed "rank<r>:<device>" (the reference keys by device; ranks may
        share one here)."""
        return {f"rank{i['rank']}:{i['device']}": i["hbm_kv_bytes"]
                for i in self.rank_info}

    @property
    def kv_quant_bytes_saved_total(self) -> int:
        """Pool bytes a quantized cache avoided writing against storing the
        same tokens in the compute dtype, over all ranks (0 when not
        quantized)."""
        if not self.kv_quantized:
            return 0
        mc, cfg = self.model_config, self.config
        unquantized = (2 * mc.num_layers * self.local_kv_heads * mc.head_dim_
                       * self.dtype.itemsize)
        saved = max(0, unquantized - cfg.kv_cache_bytes_per_token(mc))
        return (self.kv_quant_tokens_written * saved
                * cfg.mesh_devices)

    def _derive_num_blocks(self) -> int:
        """Size the KV pool from free device memory (after the weights are
        resident); the CPU gets a conservative 2 GiB. The pool costs its
        storage bytes (int8 payload + scales when quantized); gathered
        windows hold dequantized compute-dtype K/V and cost those bytes.
        On the card at tp = 1 warm-up captures every prefill family as a
        CUDA graph, whose temporaries the graph pool holds for the engine's
        life: the largest family's peak (``prefill_peak_bytes``), or the
        largest draft-ingest bucket's when it is larger, is reserved.
        Without graphs (the CPU, a mesh) prefill takes its temporaries
        transiently, and only its history window is reserved.
        An overlapped load reserves its loader's largest transient
        (``loader_reserve_bytes``), which comes after the pool is sized.
        Bytes are this rank's (its kv heads); mesh ranks sharing one card
        each take their share of its free memory (the caller then takes the
        minimum over ranks)."""
        mc, cfg = self.model_config, self.config
        bytes_per_block = cfg.kv_cache_bytes_per_block(mc)
        window_bytes_per_block = cfg.window_bytes_per_block(mc)
        if self.device.type == "cuda":
            free_bytes, _ = torch.cuda.mem_get_info(self.device)
            free_bytes //= pmesh.ranks_per_device(self.device,
                                                  cfg.mesh_devices)
        else:
            free_bytes = 2 << 30
        budget = int(free_bytes * cfg.hbm_utilization) - self.loader_reserve_bytes
        graphs = self.device.type == "cuda" and self.mesh is None
        # The ingest graphs share the pool: the larger peak is reserved.
        ingest_peak = (self.ingest_train.peak_bytes(self.ingest_train.t_max)
                       if graphs and self.spec_n else 0)
        if self.attn_impl == "window":
            # Windows are counted per block; the graphs' other temporaries
            # are reserved.
            extra = max([ingest_peak] + [
                self.prefill_peak_bytes(*f, window=False)
                for f in self.reachable_prefill_families(1 << 30)]
                ) if graphs else 0
            reserve_bytes = min(extra, budget // 2)
            n_eager = budget // (bytes_per_block + window_bytes_per_block)
            n = (budget - reserve_bytes) // (bytes_per_block
                                             + window_bytes_per_block)
        else:
            # Paged decode never copies the pool, but chunked prefill still
            # gathers a [rows, max_blocks] history window: reserve it.
            window_reserve = min(
                _bucket(cfg.max_prefill_seqs, 1, max(1, cfg.max_num_seqs))
                * _bucket(cfg.max_blocks_per_seq, 1,
                          max(1, cfg.max_blocks_per_seq))
                * window_bytes_per_block,
                budget // 2,
            )
            self._prefill_window_blocks = max(
                1, window_reserve // window_bytes_per_block
            )
            reserve_bytes = window_reserve
            if graphs:
                reserve_bytes = min(budget // 2, max(
                    [window_reserve, ingest_peak] + [
                        self.prefill_peak_bytes(*f)
                        for f in self.reachable_prefill_families(
                            self._prefill_window_blocks)]))
            n_eager = (budget - window_reserve) // bytes_per_block
            n = (budget - reserve_bytes) // bytes_per_block
        cap = cfg.max_blocks_per_seq * cfg.max_num_seqs + 1
        self.kv_blocks_free_memory = n
        n = max(2, min(n, cap))
        # The prefill reserve and the blocks the pool would have without it.
        self.prefill_reserve_bytes = reserve_bytes
        self.kv_blocks_without_prefill_graphs = max(2, min(n_eager, cap))
        logger.info(
            "KV pool: %d blocks x %d tokens (%.1f MiB, kv_cache_dtype=%s, "
            "attn=%s, device=%s; prefill reserve %.1f MiB, %d blocks "
            "without prefill graphs; loader reserve %.1f MiB; %d blocks "
            "free memory allows)",
            n, cfg.block_size, n * bytes_per_block / (1 << 20),
            cfg.kv_cache_dtype, self.attn_impl, self.device,
            reserve_bytes / (1 << 20), self.kv_blocks_without_prefill_graphs,
            self.loader_reserve_bytes / (1 << 20), self.kv_blocks_free_memory,
        )
        return n

    def prefill_peak_bytes(self, b: int, t: int, mb: int, has_window: bool,
                           window: bool = True) -> int:
        """Device bytes a prefill dispatch of family (b, t, mb, has_window)
        holds at its peak, reckoned from its shapes (this rank's heads): the
        gathered window (K and V ``[L, Hkv, b, mb * bs, Dh]`` in the compute
        dtype; left out when not ``window``); the chunk's K/V ``[L, Hkv, b,
        t, Dh]`` twice (the forward's per-layer outputs and their stack);
        the residual stream; the larger of one layer's attention (per
        query block of ``QBLOCK``: three f32 score-sized blocks ``[Hkv, b,
        G * tq, mb * bs + t]``, f32 copies of the layer's keys and values,
        the f32 output ``[b, t, H, Dh]`` and its concatenation) and its MLP
        (five ``[b, t, F]`` activations); the sampler's f32 ``[b, V]``
        fields; and the draft's own forward on a speculative engine. A
        captured graph holds this for the engine's life (the pool is
        shared, so the largest family sets it)."""
        mc, cfg = self.model_config, self.config
        tp = cfg.tensor_parallel_size
        e = self.dtype.itemsize
        nl, hkv, dh = mc.num_layers, self.local_kv_heads, mc.head_dim_
        h = mc.num_heads // tp
        s_win = mb * cfg.block_size if has_window else 0
        win = 2 * nl * hkv * b * s_win * dh * e if window else 0
        kv = 4 * nl * hkv * b * t * dh * e
        tq = min(t, QBLOCK)
        attn = (3 * hkv * b * (h // max(1, hkv)) * tq * (s_win + t) * 4
                + 2 * hkv * b * (s_win + t) * dh * 4
                + 2 * b * t * h * dh * 4
                + b * t * (h + 2 * hkv) * dh * e)
        mlp = 5 * b * t * (mc.intermediate_size // tp) * e
        resid = 4 * b * t * mc.hidden_size * e
        head = 6 * b * mc.vocab_size * 4
        draft = 0
        if self.spec_n:
            d = self.spec_draft_config
            draft = (4 * d.num_layers * d.num_kv_heads * b * t * d.head_dim_ * e
                     + 2 * d.num_layers * d.num_kv_heads * (b + 1)
                     * self.spec_ring_len * d.head_dim_ * e
                     + max(3 * b * d.num_heads * tq
                           * (t + self.spec_ring_len) * 4,
                           5 * b * t * d.intermediate_size * e))
        return win + kv + max(attn, mlp) + resid + head + draft

    @property
    def decode_window_blocks(self) -> int:
        """Per-dispatch block budget of the decode window (paged decode
        reads the pool in place: no cap)."""
        if self.attn_impl != "window":
            return 1 << 30
        return self.num_kv_blocks

    @property
    def prefill_window_blocks(self) -> int:
        if self.attn_impl == "window":
            return self.num_kv_blocks
        return getattr(self, "_prefill_window_blocks", self.num_kv_blocks)

    def _decode_mb(self, live_blocks: int) -> int:
        """Block-table width of a decode dispatch: pinned at the max bucket
        on the paged path (the kernel's page loop stops at the live
        kv_len), cost-proportional buckets on the window path."""
        cfg = self.config
        if self.attn_impl == "paged":
            return _bucket(cfg.max_blocks_per_seq, 1,
                           max(1, cfg.max_blocks_per_seq))
        return window_mb_bucket(live_blocks, cfg.max_blocks_per_seq)

    def _prefill_mb(self, live_blocks: int, has_window: bool) -> int:
        cfg = self.config
        if not has_window:
            return _bucket(cfg.max_blocks_per_seq, 1,
                           max(1, cfg.max_blocks_per_seq))
        return window_mb_bucket(live_blocks, cfg.max_blocks_per_seq)

    # ------------------------------------------------------------ families
    def _row_buckets(self) -> List[int]:
        """The power-of-two row buckets up to b_max, and b_max itself (a
        max_num_seqs that is not a power of two clamps the top bucket to
        it, which the reference's enumeration misses)."""
        out, nb = [], 1
        while nb < self.b_max:
            out.append(nb)
            nb *= 2
        return out + [self.b_max]

    def reachable_decode_families(self) -> List[Tuple[int, int, int]]:
        """Every (b, mb, K) decode family the scheduler can dispatch under
        this config: the reference's ``reachable_decode_families`` without
        its cached-window flag (the port keeps no persistent window).
        ``warmup`` captures each as CUDA graphs."""
        cfg = self.config
        full_mb = _bucket(cfg.max_blocks_per_seq, 1,
                          max(1, cfg.max_blocks_per_seq))
        if self.attn_impl == "paged":
            mbs = [full_mb]
        else:
            mbs = sorted({
                window_mb_bucket(m, cfg.max_blocks_per_seq)
                for m in (1, full_mb // 4, full_mb // 2, full_mb)
            })
        fams = set()
        for nb in self._row_buckets():
            # Counts 1..nb share bucket nb, and tier bounds can land inside
            # a bucket: both endpoints' caps, and the interactive cap.
            ks = {
                decode_step_cap(nb, cfg.num_decode_steps),
                decode_step_cap(nb // 2 + 1, cfg.num_decode_steps),
                min(INTERACTIVE_DECODE_STEPS,
                    decode_step_cap(nb, cfg.num_decode_steps)),
            }
            for mb in mbs:
                if self.attn_impl != "paged" and \
                        nb * mb > self.decode_window_blocks:
                    continue  # the scheduler's window budget never emits it
                for dk in ks:
                    fams.add((nb, mb, dk))
        return sorted(fams)

    def reachable_prefill_families(self, window_blocks: Optional[int] = None
                                   ) -> List[Tuple[int, int, int, bool]]:
        """Every (b, t, mb, has_window) prefill family reachable under this
        config (the reference's set); ``warmup`` captures each as a CUDA
        graph. ``window_blocks``: the prefill window budget to enumerate
        under (default: the runner's)."""
        cfg = self.config
        if window_blocks is None:
            window_blocks = self.prefill_window_blocks
        full_mb = _bucket(cfg.max_blocks_per_seq, 1,
                          max(1, cfg.max_blocks_per_seq))
        t_max = _bucket(cfg.max_num_batched_tokens, 16,
                        max(16, cfg.max_num_batched_tokens))
        pb_max = _bucket(max(1, cfg.max_prefill_seqs), 1,
                         max(1, cfg.max_num_seqs))
        win_mbs = sorted({
            window_mb_bucket(m, cfg.max_blocks_per_seq)
            for m in (1, full_mb // 4, full_mb // 2, full_mb)
        })
        fams = set()
        for pb in {1, pb_max}:
            t = prefill_t_floor(cfg.max_num_batched_tokens)
            while t <= t_max:
                # Multi-row dispatches split the token budget fairly, so
                # their chunk bucket never exceeds bucket(budget // 2).
                if pb == 1 or t <= _bucket(
                    max(16, cfg.max_num_batched_tokens // 2), 16, t_max
                ):
                    fams.add((pb, t, full_mb, False))
                    for mb in win_mbs:
                        if pb * mb <= window_blocks:
                            fams.add((pb, t, mb, True))
                t *= 2
        return sorted(fams)

    def prefill_rows(self, n: int) -> int:
        """Rows of a prefill dispatch of ``n`` sequences: the reference's
        two row families, 1 and the ``max_prefill_seqs`` bucket (a straggler
        batch of 2 to 7 rows pads to 8 at the default), so the dispatch has
        a captured family's shape. On a mesh nothing is captured: the exact
        ``n``."""
        cfg = self.config
        if n == 1 or self.mesh is not None:
            return n
        return _bucket(max(n, cfg.max_prefill_seqs), 1, max(1, cfg.max_num_seqs))

    def prefill_shape(self, batch: ScheduledBatch) -> Tuple[int, int, bool]:
        """(t, mb, has_window) of a prefill dispatch: its chunk-length and
        block-table buckets, as the reference's. With its rows
        (``prefill_rows``) they make its (b, t, mb, has_window) family in
        ``reachable_prefill_families``."""
        cfg = self.config
        t = _bucket(max(batch.chunk_lens),
                    prefill_t_floor(cfg.max_num_batched_tokens),
                    max(16, cfg.max_num_batched_tokens))
        has_window = any(st > 0 for st in batch.chunk_starts)
        mb = self._prefill_mb(max(len(s.block_ids) for s in batch.seqs),
                              has_window)
        return t, mb, has_window

    def decode_graph_keys(self) -> List[FamilyKey]:
        """The variants ``warmup`` captures, as the reference warms them:
        the default sampling variant and the first logprob bucket's of
        every decode family, and the penalty variant at b = 1. Others (the
        top bucket, penalties at b > 1) run eagerly. A speculative engine
        captures the speculative train's variants, and the plain train's
        too when adaptive (its all-gamma-0 dispatches)."""
        fams = self.reachable_decode_families()
        lpk = LOGPROB_BUCKETS[0]

        def keys(spec):
            return ([(b, mb, k, False, 0, spec) for b, mb, k in fams]
                    + [(b, mb, k, False, lpk, spec) for b, mb, k in fams]
                    + [(b, mb, k, True, 0, spec) for b, mb, k in fams
                       if b == 1])

        if not self.spec_n:
            return keys(False)
        return keys(True) + (keys(False) if self.spec_adaptive else [])

    def prefill_graph_keys(self) -> List[PrefillKey]:
        """The prefill variants ``warmup`` captures, by the reference's
        rule (its ``warmup``): the default sampling variant of every
        family; the first logprob bucket's of every b = 1 family; the
        penalty variant at (1, t_floor, full_mb, False) only. Others (the
        top logprob bucket, logprobs or penalties at b > 1) run eagerly."""
        cfg = self.config
        t_floor = prefill_t_floor(cfg.max_num_batched_tokens)
        lpk = LOGPROB_BUCKETS[0]
        keys = []
        for b, t, mb, hw in self.reachable_prefill_families():
            keys.append((b, t, mb, hw, False, 0))
            if b == 1:
                keys.append((b, t, mb, hw, False, lpk))
                if t == t_floor and not hw:
                    keys.append((b, t, mb, hw, True, 0))
        return keys

    def _prefill_arena_keys(self) -> List[PrefillKey]:
        """The captured keys and the largest eager variant (penalties and
        the top logprob bucket at the widest row family): the prefill
        arena's size."""
        keys = self.prefill_graph_keys()
        b, t, mb, hw = max(self.reachable_prefill_families())
        return keys + [(b, t, mb, hw, True, LOGPROB_BUCKETS[-1])]

    def warmup(self) -> None:
        """Before serving: on the card, capture head, step and tail of
        every decode graph family (``DecodeTrain.capture``; the kernel
        library is built first), then one graph of every prefill family of
        ``prefill_graph_keys`` into the same pool (``PrefillTrain.capture``;
        each family runs once eagerly before anything is captured,
        ``PrefillTrain.warm``), and on a speculative engine one graph of
        every draft-ingest bucket (``IngestTrain``: warmed after the
        weights are joined, before the first capture; every start captures
        them all); on the CPU, run each family's and bucket's all-zero
        dummy dispatch eagerly.
        Dummy dispatches have budget 0, chunk length 0 and table 0 in every
        row, so they write only the null block: the pool's other blocks
        survive warmup.
        Fast start (the reference's ``docs/ELASTIC.md`` §1-2): an
        overlapped load fills the weights meanwhile; the kernel build and
        the eager warm runs run beside it, and the weights are joined
        (``wait_for_weights``, which re-raises the loader's error) before
        the first capture: graphs hold addresses, but a capture must not
        share the card with another thread's allocations. With
        ``compilation_cache_dir`` a start that finds its own manifest
        (``_warmup_manifest_path``: the previous identical start warmed
        fully) warms only the default sampling variant of every family;
        each deferred variant is captured at its first dispatch
        (``_first_use``). The arenas still reserve every variant
        and the pool is sized as a cold start sizes it, so that capture
        fits. A cold start writes the manifest after it warmed fully.
        A capture that fails, or a prefill family warm-up missed, fails
        warm-up with the family named. On a mesh no family is captured
        (gloo collectives cannot be captured, and NCCL capture is not
        ported): decode and prefill run eagerly, prefill at its exact row
        count, and nothing is deferred."""
        t0 = time.monotonic()
        cuda = self.device.type == "cuda"
        try:
            self._warmup(t0, cuda)
        except BaseException:
            # A failed start leaves no thread writing weights behind it.
            if self._param_thread is not None:
                self._param_thread.join()
            raise

    def _warmup(self, t0: float, cuda: bool) -> None:
        first = not self._warmed_up
        if cuda and self.attn_impl == "paged":
            pa.build_kernels()
        phases = {"kernel_build": time.monotonic() - t0}
        if self.mesh is not None:
            self.wait_for_weights()
            logger.info("warmup: a mesh of %d ranks: no decode or prefill "
                        "family captured (both run eagerly)", self.mesh.size)
            return
        keys = self.decode_graph_keys()
        pkeys = self.prefill_graph_keys()
        if first:
            self._manifest = self._warmup_manifest_path()
            self._verified = (self._manifest is not None
                              and os.path.exists(self._manifest))
        verified = self._verified
        dwarm, pwarm = keys, pkeys
        if verified:
            # The default variants only: penalties off, no logprobs.
            dwarm = [k for k in keys if not (k[3] or k[4])]
            pwarm = [k for k in pkeys if not (k[4] or k[5])]
        train, prefill = self.decode_train, self.prefill_train
        ingest = self.ingest_train
        # Every start warms every ingest bucket: it has no variants.
        ikeys = ingest.buckets() if self.spec_n else []
        # The arenas hold every family first (captured graphs hold their
        # addresses), the deferred ones included.
        train.reserve(keys)
        prefill.reserve(self._prefill_arena_keys())
        ingest.reserve(ikeys)
        if first:
            train.deferred = set(keys) - set(dwarm)
            prefill.deferred = set(pkeys) - set(pwarm)
        if cuda:
            with self.kv_io_lock:
                t = time.monotonic()
                prefill.warm(pwarm)
                phases["warm_runs"] = time.monotonic() - t
                self._join_weights(t0)
                if ikeys:
                    # The draft's weights are joined: its warm runs, before
                    # any graph holds pool memory.
                    t = time.monotonic()
                    ingest.warm(ikeys)
                    phases["warm_runs"] += time.monotonic() - t
                # The logprob variants are captured apart, so their share
                # of the graph pool is read.
                t = time.monotonic()
                train.capture([k for k in dwarm if not k[4]])
                train.capture([k for k in dwarm if k[4]])
                phases["decode_capture"] = time.monotonic() - t
                t = time.monotonic()
                prefill.capture(pwarm)
                phases["prefill_capture"] = time.monotonic() - t
                if ikeys:
                    t = time.monotonic()
                    ingest.capture(ikeys)
                    phases["ingest_capture"] = time.monotonic() - t
        else:
            t = time.monotonic()
            for key in dwarm:
                train.dummy_dispatch(key)
            for key in pwarm:
                prefill.dummy_dispatch(key)
                prefill.warmed.add(key)
            phases["warm_runs"] = time.monotonic() - t
            self._join_weights(t0)
            t = time.monotonic()
            for key in ikeys:
                ingest.dummy_dispatch(key)
                ingest.warmed.add(key)
            phases["warm_runs"] += time.monotonic() - t
        prefill.check(pwarm)
        if first:
            # CUDA graphs do not persist: every variant warmed here was
            # captured from scratch (a miss), none is a hit. Deferred: the
            # reference's rule, len(variants) - 1 per family, so an adaptive
            # speculative engine's plain-train twins are not counted. The
            # ingest buckets count as the reference's ``n_warmed`` does.
            spec = bool(self.spec_n)
            self.startup_cache_miss_families = (len(dwarm) + len(pwarm)
                                                + len(ikeys))
            self.startup_cache_hit_families = 0
            self.startup_deferred_families = (
                sum(1 for k in keys if (k[3] or k[4]) and k[5] == spec)
                + sum(1 for k in pkeys if k[4] or k[5])) if verified else 0
            phases["weight_load"] = self.startup_weight_load_seconds
            phases["overlap"] = self.startup_compile_seconds
            self.startup_phase_seconds = phases
            if self._manifest is not None and not verified:
                self._write_manifest(self._manifest)
        self._warmed_up = True
        if not first:
            logger.info("warmup: %d decode, %d prefill and %d ingest families "
                        "already warm (%.2f s)", len(dwarm), len(pwarm),
                        len(ikeys), time.monotonic() - t0)
            return
        logger.info(
            "warmup: %d decode, %d prefill and %d ingest families in %.2f s "
            "(%s); start phases (s): weight load %.2f, kernel build %.2f, "
            "warm runs %.2f, decode capture %.2f, prefill capture %.2f, "
            "ingest capture %.2f, overlapped with the load %.2f; %d variants "
            "deferred to first use (manifest %s)",
            len(dwarm), len(pwarm), len(ikeys), time.monotonic() - t0,
            "CUDA graphs" if cuda else "eager",
            self.startup_weight_load_seconds, phases["kernel_build"],
            phases.get("warm_runs", 0.0), phases.get("decode_capture", 0.0),
            phases.get("prefill_capture", 0.0),
            phases.get("ingest_capture", 0.0), self.startup_compile_seconds,
            len(train.deferred) + len(prefill.deferred),
            "verified" if verified else
            "written" if self._manifest is not None else "off")

    def _join_weights(self, t0: float) -> None:
        """Join the weight loader; with an overlapped load, record the
        warm-up seconds since ``t0`` that ran while it was still working
        (the reference's prepass seconds)."""
        loading = self._param_thread is not None
        t_join = time.monotonic()
        self.wait_for_weights()
        if loading:
            self.startup_compile_seconds = max(
                0.0, min(t_join, self._weights_done_at) - t0)

    def _warmup_manifest_path(self) -> Optional[str]:
        """The warm-up manifest of THIS configuration (the reference's
        ``_warmup_manifest_path``; None without a cache directory): keyed by
        the reference's fields and both family enumerations, plus the
        port's graph keys, so any change to what warm-up captures misses to
        another manifest and the start warms cold. It holds no artifact:
        CUDA graphs do not persist. Its existence says that a start of this
        configuration warmed every variant, and lets this one defer the
        non-default ones to their first use."""
        if not self.compilation_cache_path:
            return None
        cfg = self.config
        doc = {
            "model": cfg.model, "dtype": cfg.dtype,
            "kv_cache_dtype": cfg.kv_cache_dtype,
            "block_size": cfg.block_size,
            "num_kv_blocks": self.num_kv_blocks,
            "attn": self.attn_impl, "decode_loop": cfg.decode_loop,
            "mesh": [["dp", cfg.data_parallel_size],
                     ["sp", cfg.sequence_parallel_size],
                     ["tp", cfg.tensor_parallel_size]],
            "b_max": self.b_max,
            "max_model_len": cfg.max_model_len,
            "max_num_batched_tokens": cfg.max_num_batched_tokens,
            "max_prefill_seqs": cfg.max_prefill_seqs,
            "spec": self.spec_n,
            "spec_ring": self.spec_ring_len,
            "spec_adaptive": self.spec_adaptive,
            "spec_tree": self.spec_tree_width,
            "logprob_buckets": LOGPROB_BUCKETS,
            "decode_families": self.reachable_decode_families(),
            "prefill_families": self.reachable_prefill_families(),
            "decode_graph_keys": self.decode_graph_keys(),
            "prefill_graph_keys": self.prefill_graph_keys(),
        }
        key = hashlib.blake2b(
            json.dumps(doc, sort_keys=True, default=str).encode(),
            digest_size=12).hexdigest()
        return os.path.join(self.compilation_cache_path,
                            f"pstpu-warmup-{key}.ok")

    @staticmethod
    def _write_manifest(path: str) -> None:
        """Write the manifest atomically (a temporary file, then a rename);
        a directory that refuses it costs the next start a full warm-up."""
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write("complete\n")
            os.replace(tmp, path)
        except OSError:
            logger.warning("could not write the warm-up manifest %s: the "
                           "next start warms every variant", path,
                           exc_info=True)

    def _first_use(self, train, key) -> None:
        """Capture ``key`` at its first dispatch when a manifest-verified
        warm-up deferred it (``train.capture_deferred``: warm-up's own
        path, on the capture stream, into the shared pool), under
        ``kv_io_lock``, before the dispatch stages its inputs: the capture
        zeroes the arena that every family of the train views. Counted in
        ``deferred_captures_total`` and ``deferred_capture_seconds_total``,
        never as an eager dispatch. A failure deletes the warm-up manifest
        (the next start warms every variant) and raises out of the
        dispatch: nothing runs in its place."""
        if key not in train.deferred:
            return
        t0 = time.monotonic()
        try:
            with self.kv_io_lock:
                train.capture_deferred(key)
        except BaseException:
            self.drop_warmup_manifest()
            raise
        train.deferred.discard(key)
        dt = time.monotonic() - t0
        self.deferred_captures_total += 1
        self.deferred_capture_seconds_total += dt
        logger.info("deferred variant %s captured at its first use in %.3f s",
                    key, dt)

    def drop_warmup_manifest(self) -> None:
        """Delete this configuration's manifest (a deferred variant failed
        to capture): the next start warms every variant."""
        if self._manifest is None:
            return
        try:
            os.unlink(self._manifest)
        except FileNotFoundError:
            pass
        except OSError:
            logger.warning("could not delete the warm-up manifest %s",
                           self._manifest, exc_info=True)

    # --------------------------------------------------------------- helpers
    def _slot(self, n_in: int, n_out: int) -> _Slot:
        """The next staging slot, with room for ``n_in`` packed int32s and
        ``n_out`` fetched int32s; waits (normally not at all) until its
        previous dispatch's copies have run."""
        slot = self._slots[self._slot_idx % _NUM_SLOTS]
        self._slot_idx += 1
        cuda = self.device.type == "cuda"
        if slot.end is not None:
            slot.end.synchronize()
        if slot.inp is None or slot.inp.numel() < n_in:
            slot.inp = torch.empty((max(n_in, 1024),), dtype=torch.int32,
                                   pin_memory=cuda)
        if slot.out is None or slot.out.numel() < n_out:
            slot.out = torch.empty((max(n_out, 1024),), dtype=torch.int32,
                                   pin_memory=cuda)
        if cuda and slot.start is None:
            slot.start = torch.cuda.Event(enable_timing=True)
            slot.end = torch.cuda.Event(enable_timing=True)
        if cuda:
            slot.start.record()
        return slot

    @staticmethod
    def _logprobs_k(seqs) -> int:
        """A batch's logprob bucket: the largest among its rows (0 when no
        row asked for logprobs)."""
        return max((logprobs_bucket(s.sampling.logprobs) for s in seqs
                    if s.sampling.logprobs is not None), default=0)

    @staticmethod
    def _out_ints(k: int, b: int, lpk: int) -> int:
        """int32s a dispatch fetches: tokens [k, b], and with logprobs the
        chosen logprob [k, b], top logprobs and ids [k, b, lpk]."""
        return k * b * (2 + 2 * lpk if lpk else 1)

    @staticmethod
    def _gather_logprobs(seqs, steps, host, offs, k: int, b: int, lpk: int):
        """Per-row logprob entries from a dispatch's fetched arrays (the
        segments ``_copy_out`` wrote at ``offs``: tokens, chosen [k, b],
        top [k, b, lpk], ids [k, b, lpk]): a row that asked gets one
        (chosen logprob, [(token id, logprob), ...] cut to its own width)
        per token in its budget; the others get None (the reference's
        ``_gather_logprobs``)."""
        o_c, o_t, o_i = offs[1:]
        lp_c = host[o_c:o_c + k * b].view(np.float32).reshape(k, b)
        lp_t = host[o_t:o_t + k * b * lpk].view(np.float32).reshape(k, b, lpk)
        lp_i = host[o_i:o_i + k * b * lpk].reshape(k, b, lpk)
        out = []
        for i, s in enumerate(seqs):
            want = s.sampling.logprobs
            if want is None:
                out.append(None)
                continue
            entries = []
            for j in range(steps[i]):
                top = [(int(lp_i[j, i, r]), float(lp_t[j, i, r]))
                       for r in range(min(want, lp_i.shape[-1]))]
                entries.append((float(lp_c[j, i]), top))
            out.append(entries)
        return out

    @staticmethod
    def _copy_out(out_buf, parts) -> List[int]:
        """Copy device arrays into consecutive int32 segments of a pinned
        output (f32 as its bits); returns the segments' offsets."""
        offs, o = [], 0
        for t in parts:
            n = t.numel()
            src = t.view(torch.int32) if t.dtype == torch.float32 else t
            out_buf[o:o + n].copy_(src.reshape(-1), non_blocking=True)
            offs.append(o)
            o += n
        return offs

    def _counts(self, seqs, b: int) -> Optional[np.ndarray]:
        """[b, V] output-token occurrence counts when a row has a penalty
        (built from APPLIED tokens: the engine drains the pipeline before
        such a batch), else None."""
        if not any(s.sampling.presence_penalty or s.sampling.frequency_penalty
                   for s in seqs):
            return None
        vocab = self.model_config.vocab_size
        counts = np.zeros((b, vocab), np.int32)
        for i, s in enumerate(seqs):
            if s.output_token_ids:
                np.add.at(counts[i],
                          np.asarray(s.output_token_ids, np.int64) % vocab, 1)
        return counts

    def _dispatch_lock(self):
        """Rank 0 holds the mesh's lock from a descriptor's broadcast to the
        end of the device work it describes."""
        return self.mesh.lock if self.mesh is not None else contextlib.nullcontext()

    def _push_last(self, last: torch.Tensor) -> int:
        """Record a token-producing dispatch's device-resident last-token
        vector under its dispatch number (newest first, bounded): later
        decodes chain start tokens from it until its results reach the
        host. Returns the number."""
        d = self._dispatches
        self._chain_last.insert(0, (d, last))
        del self._chain_last[self._max_chains:]
        return d

    def _push_rows(self, d: int, seqs, rows) -> None:
        """Rank 0: the rows of dispatch ``d``'s last-token vector."""
        self._chain_rows.insert(0, {
            "dispatch": d,
            "row": {seqs[i].request_id: i for i in rows},
            "epoch": {seqs[i].request_id: seqs[i].num_preemptions
                      for i in rows},
        })
        del self._chain_rows[self._max_chains:]

    def _digest_add(self, toks: torch.Tensor) -> None:
        """Fold sampled tokens into this rank's device digest (on a
        mesh)."""
        if self._digest is None:
            return
        flat = toks.reshape(-1).long()
        w = torch.arange(flat.numel(), device=flat.device) % 65521 + 1
        self._digest.mul_(_DIGEST_MULT).add_((flat * w).sum()).remainder_(
            _DIGEST_MOD)

    # ------------------------------------------------------------------ decode
    def _issue_decode(self, batch: ScheduledBatch) -> DispatchHandle:
        """Issue one fused K-step decode dispatch (the reference's
        ``_issue_decode``); its handle's fetch returns each row's tokens
        (its step budget's worth). The host part: pack the inputs."""
        t_issue = time.monotonic()
        cfg = self.config
        seqs = batch.seqs
        k = batch.num_steps
        n = len(seqs)
        b = _bucket(n, 1, max(1, cfg.max_num_seqs))
        mb = self._decode_mb(max(len(s.block_ids) for s in seqs))
        lpk = self._logprobs_k(seqs)
        n_packed = NUM_SCALARS * b + b * mb
        slot = self._slot(n_packed, self._out_ints(k, b, lpk))
        packed = slot.inp[:n_packed].numpy()
        packed[:] = 0
        sc = packed[:NUM_SCALARS * b].reshape(NUM_SCALARS, b)
        bt = packed[NUM_SCALARS * b:].reshape(b, mb)
        f32 = sc.view(np.float32)
        u32 = sc.view(np.uint32)
        sc[11, :] = -1
        spec = bool(self.spec_n)
        gammas: Optional[List[int]] = None
        if spec:
            # Padding rows name the trash slot.
            sc[12, :] = self.spec_num_slots
            if self._spec_controller is not None:
                gammas = [self._spec_controller.gamma(s.request_id)
                          for s in seqs]
                if not any(gammas):
                    # Every row at gamma 0: the plain train, no draft work.
                    spec = False
                    self.spec_gamma0_dispatches_total += 1
            batch.spec_mode = (
                "off-degrade" if not spec
                else "adaptive" if self.spec_adaptive
                else "tree" if self.spec_tree_width > 1
                else "linear")
        chain_entry = None  # the ONE dispatch this dispatch chains from
        for i, s in enumerate(seqs):
            if spec:
                g = gammas[i] if gammas is not None else self.spec_n
                sc[13, i] = g
                if g > 0:
                    # Context the ring has not seen (restores, handoffs)
                    # first; gamma-0 rows draft nothing this dispatch.
                    self._spec_catch_up(s, s.num_computed_tokens)
                    sc[12, i] = self.spec_slot(s.request_id)
            pos = s.num_computed_tokens
            if pos < len(s.all_token_ids):
                sc[0, i] = s.all_token_ids[pos]
            else:
                # The row's last token is still in an unapplied dispatch's
                # device vector: read it there.
                src, src_entry = -1, None
                for entry in self._chain_rows:  # newest first
                    r = entry["row"].get(s.request_id, -1)
                    if r >= 0 and entry["epoch"][s.request_id] == \
                            s.num_preemptions:
                        src, src_entry = r, entry
                        break
                if src < 0:
                    raise RuntimeError(
                        f"row {s.request_id}: token at pos {pos} neither "
                        "applied on host nor chainable from a recent "
                        "dispatch (pipeline invariant breach)"
                    )
                if chain_entry is None:
                    chain_entry = src_entry
                elif chain_entry is not src_entry:
                    raise RuntimeError(
                        f"row {s.request_id}: decode batch chains start "
                        "tokens from two different in-flight dispatches "
                        "(overlap single-source invariant breach)"
                    )
                sc[11, i] = src
            sc[1, i] = pos
            sc[2, i] = batch.decode_steps[i]
            u32[3, i] = seed_base(s.request_id, s.sampling)
            u32[4, i] = len(s.output_token_ids) + s.inflight_steps
            sp = s.sampling
            f32[5, i] = sp.temperature
            sc[6, i] = sp.top_k
            f32[7, i] = sp.top_p
            sc[8, i] = s.adapter_idx
            f32[9, i] = sp.presence_penalty
            f32[10, i] = sp.frequency_penalty
            bt[i, :len(s.block_ids)] = s.block_ids
        counts = self._counts(seqs, b)
        if counts is not None:
            counts = torch.from_numpy(counts)
        steps = list(batch.decode_steps)
        if spec:
            return self._issue_decode_spec(batch, slot, b, mb, lpk, counts,
                                           gammas, t_issue)
        n_steps = k if cfg.decode_loop == "scan" else max(steps)
        chain_src = -1 if chain_entry is None else chain_entry["dispatch"]
        with self._dispatch_lock():
            if self.mesh is not None:
                self.mesh.send_header(pmesh.DECODE, self._dispatches, b, mb, k,
                                      n_steps, chain_src,
                                      int(counts is not None), lpk)
                self.mesh.bcast(slot.inp[:n_packed])
                if counts is not None:
                    self.mesh.bcast(counts)
            d, bf = self._decode_device(slot, b, mb, k, n_steps, chain_src,
                                        counts, lpk)
        self._push_rows(d, seqs, range(n))
        out_buf, start, end = slot.out, slot.start, slot.end
        parts = [bf.toks_all]
        if lpk:
            parts += [bf.lp_chosen, bf.lp_top, bf.lp_ids]
        offs = self._copy_out(out_buf, parts)
        if end is not None:
            end.record()

        def fetch():
            if end is not None:
                end.synchronize()
                self.decode_device_seconds_total += \
                    start.elapsed_time(end) / 1e3
            host = out_buf.numpy()
            out = host[:k * b].reshape(k, b)
            tokens = [[int(out[j, i]) for j in range(steps[i])]
                      for i in range(n)]
            lps = (self._gather_logprobs(seqs, steps, host, offs, k, b, lpk)
                   if lpk else None)
            self.decode_seconds_total += time.monotonic() - t_issue
            return tokens, lps

        return DispatchHandle(fetch)

    def _issue_decode_spec(self, batch: ScheduledBatch, slot: _Slot, b: int,
                           mb: int, lpk: int, counts: Optional[torch.Tensor],
                           gammas: Optional[List[int]],
                           t_issue: float) -> DispatchHandle:
        """Issue a speculative decode dispatch (the reference's spec branch
        of ``_issue_decode``; the engine loop is strict, so no row chains).
        Its fetch returns each row's accepted tokens, a variable count up
        to its budget, and updates the ring ledger, the controller and the
        acceptance counters."""
        seqs, k = batch.seqs, batch.num_steps
        n, n1 = len(seqs), self.spec_n + 1
        steps = list(batch.decode_steps)
        # Issue-time positions: advance_at_issue runs after this returns.
        poss = [s.num_computed_tokens for s in seqs]
        row_gammas = gammas if gammas is not None else [self.spec_n] * n
        n_packed = NUM_SCALARS * b + b * mb
        max_cycles = max(steps)
        with self._dispatch_lock():
            if self.mesh is not None:
                self.mesh.send_header(pmesh.SPEC_DECODE, self._dispatches, b,
                                      mb, k, max_cycles,
                                      int(counts is not None), lpk,
                                      self._spec_mode_code)
                self.mesh.bcast(slot.inp[:n_packed])
                if counts is not None:
                    self.mesh.bcast(counts)
            d, bf, cycles = self._spec_decode_device(slot, b, mb, k,
                                                     max_cycles, counts, lpk)
        self._push_rows(d, seqs, range(n))
        self.spec_dispatches_total += 1
        self.spec_cycles_run_total += cycles
        parts = [bf.toks_all, bf.emits, bf.stats]
        if lpk:
            parts += [bf.lp_chosen, bf.lp_top, bf.lp_ids]
        n_out = sum(t.numel() for t in parts)
        if slot.out.numel() < n_out:
            slot.out = torch.empty((n_out,), dtype=torch.int32,
                                   pin_memory=self.device.type == "cuda")
        out_buf, start, end = slot.out, slot.start, slot.end
        offs = self._copy_out(out_buf, parts)
        if end is not None:
            end.record()

        def fetch():
            if end is not None:
                end.synchronize()
                self.decode_device_seconds_total += \
                    start.elapsed_time(end) / 1e3
            host = out_buf.numpy()
            out = host[offs[0]:offs[0] + k * n1 * b].reshape(k, n1, b)
            em = host[offs[1]:offs[1] + k * b].reshape(k, b)
            st = host[offs[2]:offs[2] + 4 * b].reshape(4, b)
            tokens = []
            for i in range(n):
                row = [int(out[c, t, i]) for c in range(k)
                       for t in range(em[c, i])]
                tokens.append(row)
                rid = seqs[i].request_id
                if row_gammas[i] > 0:
                    # The dispatch wrote draft KV for the emitted tokens; a
                    # gamma-0 row wrote none, so its ledger stays.
                    self._spec_warmed[rid] = poss[i] + len(row)
                if self._spec_controller is not None:
                    self._spec_controller.update(rid, int(st[0, i]),
                                                 int(st[1, i]))
            d_tot, a_tot = int(st[0].sum()), int(st[1].sum())
            self.spec_draft_tokens_total += d_tot
            self.spec_accepted_tokens_total += a_tot
            self._spec_window.append((d_tot, a_tot))
            self.spec_draft_depth_sum += d_tot
            self.spec_tree_nodes_total += int(st[2].sum())
            self.spec_live_cycles_total += int(st[3].sum())
            self.spec_cycles_live_total += int(st[3].max(initial=0))
            self.decode_tokens_total += sum(len(t) for t in tokens)
            lps = None
            if lpk:
                lpc = host[offs[3]:offs[3] + k * n1 * b].view(
                    np.float32).reshape(k, n1, b)
                lpt = host[offs[4]:offs[4] + k * n1 * b * lpk].view(
                    np.float32).reshape(k, n1, b, lpk)
                lpi = host[offs[5]:offs[5] + k * n1 * b * lpk].reshape(
                    k, n1, b, lpk)
                lps = []
                for i, s in enumerate(seqs):
                    want = s.sampling.logprobs
                    if want is None:
                        lps.append(None)
                        continue
                    lps.append([
                        (float(lpc[c, t, i]),
                         [(int(lpi[c, t, i, r]), float(lpt[c, t, i, r]))
                          for r in range(min(want, lpk))])
                        for c in range(k) for t in range(em[c, i])])
            self.decode_seconds_total += time.monotonic() - t_issue
            return tokens, lps

        return DispatchHandle(fetch)

    @property
    def _spec_mode_code(self) -> int:
        """The speculative mode a ``SPEC_DECODE`` descriptor names (1
        linear, 2 tree, 3 adaptive): a worker checks it against its own."""
        return 3 if self.spec_adaptive else 2 if self.spec_tree_width > 1 \
            else 1

    def _spec_decode_device(self, slot: _Slot, b: int, mb: int, k: int,
                            max_cycles: int, counts: Optional[torch.Tensor],
                            lpk: int = 0):
        """The device part of a speculative decode dispatch, on every rank:
        the speculative train over the packed inputs in ``slot`` (row 12
        each row's draft-ring slot, row 13 its draft depth, both rank 0's
        choice), at most ``max_cycles`` cycles, as many as rank 0 runs
        (``DecodeTrain._spec_any_live``). Returns (dispatch number, the
        train's buffers, the cycles run)."""
        n_packed = NUM_SCALARS * b + b * mb
        key = (b, mb, k, counts is not None, lpk, True)
        train = self.decode_train
        self._first_use(train, key)
        bf = train.buffers(*key)
        bf.packed.copy_(slot.inp[:n_packed], non_blocking=True)
        if counts is not None:
            bf.counts.copy_(counts)
        cycles = train.run(key, bf, max_cycles)
        d = self._push_last(bf.last.clone())
        self._dispatches += 1
        self._digest_add(bf.toks_all)
        self._digest_add(bf.emits)
        return d, bf, cycles

    def _decode_device(self, slot: _Slot, b: int, mb: int, k: int,
                       n_steps: int, chain_src: int,
                       counts: Optional[torch.Tensor], lpk: int = 0):
        """The device part of a decode dispatch, on every rank: the fused
        train over the packed inputs in ``slot``. Returns (dispatch number,
        the train's buffers)."""
        n_packed = NUM_SCALARS * b + b * mb
        key = (b, mb, k, counts is not None, lpk, False)
        train = self.decode_train
        self._first_use(train, key)
        bf = train.buffers(*key)
        bf.packed.copy_(slot.inp[:n_packed], non_blocking=True)
        if chain_src >= 0:
            last = dict(self._chain_last).get(chain_src)
            if last is None:
                raise RuntimeError(
                    f"decode chains from dispatch {chain_src}, which is not "
                    "among the recent token-producing dispatches")
            bf.prev_last.copy_(last)
            self.chained_dispatches_total += 1
        if counts is not None:
            bf.counts.copy_(counts)
        train.run(key, bf, n_steps)
        d = self._push_last(bf.last.clone())
        self._dispatches += 1
        self._digest_add(bf.toks_all)
        # Row 2 holds each row's step budget (0 in padding rows).
        budgets = int(slot.inp[2 * b:3 * b].sum())
        if self.kv_quantized:
            self.kv_quant_tokens_written += budgets
        self.decode_steps_total += n_steps
        self.decode_tokens_total += budgets
        return d, bf

    # ----------------------------------------------------------------- prefill
    def _issue_prefill(self, batch: ScheduledBatch) -> DispatchHandle:
        """Issue one (multi-sequence) prefill chunk dispatch (the
        reference's ``_issue_prefill``); its fetch returns the sampled token
        of rows whose prompt completes in this chunk. Rows pad to
        ``prefill_rows``. Packed rows: 0 chunk_start, 1 chunk_len,
        2 seed_base, 3 gen0, 4 temperature, 5 top_k, 6 top_p, 8 adapter,
        9 presence, 10 frequency, 12 draft-ring slot; then the block tables,
        the chunk's tokens and (the descriptor's ``finals``) one flag per
        row."""
        t_issue = time.monotonic()
        seqs = batch.seqs
        n = len(seqs)
        b = self.prefill_rows(n)
        t, mb, has_window = self.prefill_shape(batch)
        finals = [
            batch.chunk_starts[i] + batch.chunk_lens[i] >= seqs[i].num_tokens
            for i in range(n)
        ]

        n_sc = NUM_SCALARS * b
        n_packed = n_sc + b * mb + b * t
        # Logprob and penalty variants matter only for a final chunk's
        # sampled token.
        lpk = self._logprobs_k(seqs) if any(finals) else 0
        slot = self._slot(n_packed + b, self._out_ints(1, b, lpk))
        packed = slot.inp[:n_packed + b].numpy()
        packed[:] = 0
        sc = packed[:n_sc].reshape(NUM_SCALARS, b)
        bt = packed[n_sc:n_sc + b * mb].reshape(b, mb)
        toks = packed[n_sc + b * mb:n_packed].reshape(b, t)
        packed[n_packed:n_packed + n] = finals
        f32 = sc.view(np.float32)
        u32 = sc.view(np.uint32)
        if self.spec_n:
            # Padding rows name the trash slot.
            sc[12, :] = self.spec_num_slots
        for i, s in enumerate(seqs):
            start, ln = batch.chunk_starts[i], batch.chunk_lens[i]
            sc[0, i] = start
            sc[1, i] = ln
            if self.spec_n:
                # A cached or restored prefix never prefilled here: replay
                # it through the draft first, then the chunk's draft KV
                # joins the row's ring (row 12: its slot).
                self._spec_catch_up(s, start)
                sc[12, i] = self.spec_slot(s.request_id)
                self._spec_warmed[s.request_id] = start + ln
            u32[2, i] = seed_base(s.request_id, s.sampling)
            u32[3, i] = len(s.output_token_ids)
            sp = s.sampling
            f32[4, i] = sp.temperature
            sc[5, i] = sp.top_k
            f32[6, i] = sp.top_p
            sc[8, i] = s.adapter_idx
            f32[9, i] = sp.presence_penalty
            f32[10, i] = sp.frequency_penalty
            bt[i, :len(s.block_ids)] = s.block_ids
            toks[i, :ln] = s.all_token_ids[start:start + ln]
        counts = self._counts(seqs, b) if any(finals) else None
        if counts is not None:
            counts = torch.from_numpy(counts)
        with self._dispatch_lock():
            if self.mesh is not None:
                self.mesh.send_header(pmesh.PREFILL, self._dispatches, b, t,
                                      mb, int(has_window),
                                      int(counts is not None), lpk)
                self.mesh.bcast(slot.inp[:n_packed + b])
                if counts is not None:
                    self.mesh.bcast(counts)
            d, bf = self._prefill_device(slot, b, t, mb, has_window, finals,
                                         counts, lpk)

        if not any(finals):
            if slot.end is not None:
                slot.end.record()
            self.prefill_seconds_total += time.monotonic() - t_issue
            return DispatchHandle(lambda: ([[] for _ in range(n)], None))
        # Final rows' sampled tokens are chainable by the next decode
        # without a host round trip.
        self._push_rows(d, seqs, [i for i in range(n) if finals[i]])
        out_buf, end = slot.out, slot.end
        offs = self._copy_out(out_buf, bf.outputs())
        if end is not None:
            end.record()

        def fetch():
            if end is not None:
                end.synchronize()
            host = out_buf.numpy()
            out = host[:b]
            self.prefill_seconds_total += time.monotonic() - t_issue
            tokens = [[int(out[i])] if finals[i] else [] for i in range(n)]
            lps = (self._gather_logprobs(seqs, [int(f) for f in finals],
                                         host, offs, 1, b, lpk)
                   if lpk else None)
            return tokens, lps

        return DispatchHandle(fetch)

    def _prefill_device(self, slot: _Slot, b: int, t: int, mb: int,
                        has_window: bool, finals: List[bool],
                        counts: Optional[torch.Tensor], lpk: int = 0):
        """The device part of a prefill dispatch, on every rank: stage the
        packed inputs (and penalty counts) into the prefill arena, run the
        family's chunk (``PrefillTrain.run``: its graph, or the functions
        eagerly) and, when a row's prompt completes, keep the last-token
        vector for chaining. Returns (dispatch number, the family's
        buffers)."""
        n_packed = NUM_SCALARS * b + b * mb + b * t
        key = (b, t, mb, has_window, counts is not None, lpk)
        train = self.prefill_train
        # A logits sink runs the functions eagerly: nothing is captured.
        if self.logits_sink is None:
            self._first_use(train, key)
        bf = train.buffers(*key)
        bf.packed.copy_(slot.inp[:n_packed], non_blocking=True)
        if counts is not None:
            bf.counts.copy_(counts)
        # A logits sink reads each dispatch's logits: the functions run
        # eagerly.
        logits = train.run(key, bf, eager=self.logits_sink is not None)
        d = self._dispatches
        if any(finals):
            if self.logits_sink is not None:
                self.logits_sink.append(logits.clone())
            # A copy: the next prefill overwrites the arena's vector while
            # a decode may still chain from this one.
            self._push_last(bf.last.clone())
            self._digest_add(bf.tokens)
        if self.kv_quantized:
            # Row 1 holds each row's chunk length (0 in padding rows).
            self.kv_quant_tokens_written += int(slot.inp[b:2 * b].sum())
        self._dispatches += 1
        return d, bf

    def _prefill_draft(self, token_ids, positions, chunk_start, chunk_lens,
                       in_chunk, slot_idx) -> None:
        """The draft over a prefill chunk, into each row's ring: rows whose
        chunk starts at 0 forget their ring first (a fresh or re-prefilled
        sequence), and only the last min(t, R) chunk tokens are kept (their
        ring indices are then distinct)."""
        slot_c = torch.clamp(slot_idx, 0, self.spec_num_slots - 1).long()
        reset = chunk_start == 0
        drp = torch.where(reset[:, None], POS_SENTINEL, self.spec_pos[slot_c])
        _, dk, dv = self.draft_forward(
            self.spec_params, self.spec_draft_config, token_ids,
            torch.clamp(positions, max=self.spec_draft_max_pos - 1),
            chunk_lens, None, None, None, self.spec_k[:, :, slot_c],
            self.spec_v[:, :, slot_c], drp)
        chunk_end = chunk_start + chunk_lens
        keep = in_chunk & (positions >= chunk_end[:, None] - self.spec_ring_len)
        self._spec_ring_write(dk, dv, positions, keep, slot_idx, reset)

    def lora_of(self, scalars: torch.Tensor):
        """The forward's ``lora`` argument of a dispatch: each row's adapter
        index (packed scalar row 8) and the stacks; None without adapters
        (the reference's ``(adapter_idx, lora_stacks)``)."""
        return (scalars[8], self.lora_stacks) if self.lora_stacks else None

    # ---------------------------------------------------------------- execute
    def execute_async(self, batch: ScheduledBatch) -> DispatchHandle:
        """Issue one dispatch: it is enqueued on the current stream and the
        call returns before any device-to-host wait; ``fetch()`` on the
        handle waits for its tokens. The pipelined engine loop issues the
        next dispatch before fetching this one."""
        self.wait_for_weights()
        if batch.kind == "decode":
            return self._issue_decode(batch)
        return self._issue_prefill(batch)

    # -------------------------------------------------------------- embedding
    def embed(self, token_lists: List[List[int]]) -> np.ndarray:
        """[n, D] float32 embeddings of tokenized inputs (the reference's
        ``embed``): the trunk forward with no KV pool and no window, mean
        pooling over each input's valid tokens in f32, L2 normalisation
        (norm floored at 1e-9). Rows pad to the power-of-two bucket of at
        most ``max_num_seqs`` (more inputs go in chunks of that many),
        tokens to the power-of-two bucket >= 16 of the longest input. Run
        between dispatches on the engine's worker thread; on a mesh every
        rank runs its shard's forward (an EMBED descriptor)."""
        self.wait_for_weights()
        t0 = time.monotonic()
        cap = max(1, self.config.max_num_seqs)
        hi = 16
        while hi < self.config.max_model_len:
            hi *= 2
        outs = []
        for ofs in range(0, len(token_lists), cap):
            chunk = token_lists[ofs:ofs + cap]
            n = len(chunk)
            b = _bucket(n, 1, cap)
            t = _bucket(max((len(x) for x in chunk), default=1), 16, hi)
            packed = torch.zeros((b * t + b,), dtype=torch.int32)
            ids = packed[:b * t].view(b, t).numpy()
            lens = packed[b * t:].numpy()
            for i, toks in enumerate(chunk):
                toks = toks[:t]
                ids[i, :len(toks)] = toks
                lens[i] = len(toks)
            with self._dispatch_lock():
                if self.mesh is not None:
                    self.mesh.send_header(pmesh.EMBED, b, t)
                    self.mesh.bcast(packed)
                out = self._embed_device(packed, b, t)
            outs.append(out[:n].cpu().numpy())
        self.embed_calls_total += 1
        self.embed_seconds_total += time.monotonic() - t0
        return np.concatenate(outs, axis=0)

    def _embed_device(self, packed: torch.Tensor, b: int, t: int
                      ) -> torch.Tensor:
        """The device part of ``embed``, on every rank: token ids [b, t]
        and lengths [b] from ``packed`` -> [b, D] float32 (full D on every
        rank). Holds ``kv_io_lock``: never inside a graph capture."""
        with self.kv_io_lock, self._io_stream():
            dev = packed.to(self.device)
            token_ids = dev[:b * t].view(b, t)
            lens = dev[b * t:]
            t_iota = torch.arange(t, dtype=torch.int32, device=self.device)
            positions = t_iota[None, :].expand(b, t)
            hidden, _, _ = self.model_forward(
                self.params, self.model_config, token_ids, positions, lens,
                tp=self.tp)
            mask = (t_iota[None, :] < lens[:, None]).float()[:, :, None]
            denom = torch.clamp(lens.float(), min=1.0)[:, None]
            pooled = (hidden.float() * mask).sum(1) / denom
            norm = torch.clamp(
                torch.linalg.vector_norm(pooled, dim=-1, keepdim=True),
                min=1e-9)
            return pooled / norm

    # ------------------------------------------------------------ KV offload
    def _pools(self) -> List[torch.Tensor]:
        """The pools a block spans: K and V payload, and (int8) their scale
        pools."""
        if self.kv_quantized:
            return [self.kv_k, self.kv_v, self.kv_k_scale, self.kv_v_scale]
        return [self.kv_k, self.kv_v]

    def _block_view(self, pool: torch.Tensor) -> torch.Tensor:
        """``[L, Hkv, nblk, bs(, Dh)]`` view of a pool (the same storage)."""
        bs = self.config.block_size
        return pool.view(pool.shape[0], pool.shape[1], self.num_kv_blocks,
                         bs, *pool.shape[3:])

    def _io_stream(self):
        return (torch.cuda.stream(self.dispatch_stream)
                if self.dispatch_stream is not None
                else contextlib.nullcontext())

    def _block_shape(self, pool: torch.Tensor, n: int, whole: bool):
        """``[n, L, Hkv, bs(, Dh)]`` of ``n`` blocks of ``pool``: every kv
        head when ``whole``, else this rank's."""
        heads = self.model_config.num_kv_heads if whole else pool.shape[1]
        return (n, pool.shape[0], heads, self.config.block_size,
                *pool.shape[3:])

    @property
    def _pool_split(self) -> bool:
        """Whether tp ranks split this pool's kv heads (else every rank
        holds every head)."""
        return self.local_kv_heads < self.model_config.num_kv_heads

    def _io_chunk(self) -> int:
        """Blocks per block-exchange collective on a mesh (one block of
        this rank's K pool per row)."""
        k = self.kv_k
        return pmesh.RankMesh.block_chunk(
            k.numel() // self.num_kv_blocks * k.element_size())

    def read_blocks(self, block_ids: List[int]):
        """Device-to-host read of whole KV blocks (the reference's
        ``read_blocks``): (k, v, k_scale, v_scale) numpy arrays, payload
        ``[n, L, Hkv, bs, Dh]`` in the pool's storage dtype (bfloat16 as
        ``kv_offload.serde.BF16``), plus the per-slot scales ``[n, L, Hkv,
        bs]`` of an int8 pool (None otherwise). Every kv head at any mesh:
        where tp splits the kv heads a ``KV_READ`` descriptor makes each
        rank of the (0, 0) tp group select its heads and rank 0 gathers
        them (``_read_device``); a pool every rank holds whole is read on
        rank 0 alone. A gather through the ``[L, Hkv, nblk, bs, Dh]`` view
        of each pool, then a copy to host memory, on the dispatch stream: it
        runs after every dispatch enqueued before it, whichever thread
        calls."""
        self.wait_for_weights()
        ids = torch.tensor(list(block_ids), dtype=torch.long)
        if not self._pool_split or not ids.numel():
            hosts = self._read_device(ids)
        else:
            with self._dispatch_lock():
                try:
                    step = self._io_chunk()
                    self.mesh.send_header(pmesh.KV_READ, ids.numel(),
                                          int(self.kv_quantized), step)
                    self.mesh.bcast(ids)
                    hosts = self._read_device(ids, step)
                except Exception as e:
                    # The ranks are out of step: the group is lost.
                    self.mesh.mark_lost("block read", e)
                    raise
        out = [_to_numpy(h) for h in hosts]
        if not self.kv_quantized:
            out += [None, None]
        return tuple(out)

    def _read_device(self, ids: torch.Tensor, step: int = 0
                     ) -> Optional[List[torch.Tensor]]:
        """The device part of ``read_blocks``: each pool's blocks ``ids`` as
        host tensors ``[n, L, Hkv, bs(, Dh)]`` (None on ranks 1..world-1).
        Where tp splits the kv heads each rank of the (0, 0) tp group
        selects its heads ``step`` blocks at a time (rank 0's choice, sent
        in the descriptor) and rank 0 gathers them in rank order; the
        other replicas' ranks hold copies and take no part."""
        cuda = self.device.type == "cuda"
        n = ids.numel()
        if self._pool_split and self.mesh.coords[:2] != (0, 0):
            return None
        with self.kv_io_lock, self._io_stream():
            idx = ids.to(self.device)
            if not self._pool_split:
                hosts = []
                for pool in self._pools():
                    g = self._block_view(pool).index_select(2, idx).movedim(2, 0)
                    h = torch.empty(g.shape, dtype=g.dtype, pin_memory=cuda)
                    h.copy_(g, non_blocking=cuda)
                    hosts.append(h)
                if cuda:
                    done = torch.cuda.Event()
                    done.record(self.dispatch_stream)
                    done.synchronize()
                return hosts
            root = self.rank == 0
            hosts = [torch.empty(self._block_shape(pool, n, True),
                                 dtype=pool.dtype) if root else None
                     for pool in self._pools()]
            for a in range(0, n, max(1, step)):
                for pool, h in zip(self._pools(), hosts):
                    g = self._block_view(pool).index_select(
                        2, idx[a:a + step]).movedim(2, 0)
                    parts = self.mesh.gather_to_root(g)
                    if root:
                        join_kv_blocks(parts, out=h[a:a + step])
            return hosts if root else None

    def read_blocks_retry(self, block_ids: List[int], attempts: int = 3):
        """``read_blocks`` with the reference's retry. Reads never race a
        donation here (the pools are updated in place), so a failure is
        retried only against a transient device error, and never once the
        tp group is lost: a retry would send a descriptor to a dead
        group."""
        for attempt in range(attempts):
            try:
                return self.read_blocks(block_ids)
            except RuntimeError:
                if attempt == attempts - 1 or (
                        self.mesh is not None and self.mesh.lost()):
                    raise
                time.sleep(0.01)

    def write_blocks(self, block_ids: List[int], k_np, v_np,
                     k_scale=None, v_scale=None) -> None:
        """Host-to-device restore of whole KV blocks (the reference's
        ``write_blocks``): ``[n, L, Hkv, bs, Dh]`` payloads, and an int8
        pool's ``[n, L, Hkv, bs]`` scales (it restores bit-identically, no
        requantization). Every kv head at any mesh: on a mesh a
        ``KV_WRITE`` descriptor makes rank 0 scatter every rank its heads
        (each replica takes the blob). Copied and
        scattered on the dispatch stream with ``index_copy_`` into the pool
        tensors themselves: the decode graphs captured their addresses, so
        the pools are never rebound. The next dispatch runs after the
        scatter (same stream)."""
        self.wait_for_weights()
        if self.kv_quantized and k_scale is None:
            raise ValueError(
                "restoring into an int8 KV pool requires per-slot scales "
                "(blob written by a kv_cache_dtype=bfloat16 engine?)")
        cuda = self.device.type == "cuda"
        arrays = [k_np, v_np] + ([k_scale, v_scale] if self.kv_quantized
                                 else [])
        ids = torch.tensor(list(block_ids), dtype=torch.long)
        if self.mesh is None:
            hosts = [_to_torch(a, pin=cuda) for a in arrays]
            self._write_device(ids, hosts)
        elif ids.numel():
            hosts = [_to_torch(a).to(pool.dtype)
                     for pool, a in zip(self._pools(), arrays)]
            with self._dispatch_lock():
                try:
                    step = self._io_chunk()
                    self.mesh.send_header(pmesh.KV_WRITE, ids.numel(),
                                          int(self.kv_quantized), step)
                    self.mesh.bcast(ids)
                    self._write_device(ids, hosts, step)
                except Exception as e:
                    self.mesh.mark_lost("block write", e)
                    raise
        if self.kv_quantized:
            self.kv_quant_tokens_written += (len(block_ids)
                                             * self.config.block_size)

    def _write_device(self, ids: torch.Tensor,
                      hosts: Optional[List[torch.Tensor]],
                      step: int = 0) -> None:
        """The device part of ``write_blocks``, on every rank: each pool's
        blocks ``ids`` from rank 0's host tensors ``hosts`` (every kv head;
        None on ranks 1..world-1). On a mesh rank 0 scatters every rank its
        heads ``step`` blocks at a time."""
        cuda = self.device.type == "cuda"
        n = ids.numel()
        with self.kv_io_lock, self._io_stream():
            idx = ids.to(self.device)
            if self.mesh is None:
                for pool, h in zip(self._pools(), hosts):
                    src = h.to(self.device, non_blocking=cuda).to(pool.dtype)
                    self._block_view(pool).index_copy_(2, idx, src.movedim(0, 2))
                return
            m = self.mesh
            # Global rank g takes the heads of its tp rank g mod tp.
            tps = [pmesh.grid_coords(g, m.sp_size, m.tp_size)[2]
                   for g in range(m.size)]
            for a in range(0, n, max(1, step)):
                rows = min(step, n - a)
                for i, pool in enumerate(self._pools()):
                    parts = (None if hosts is None else
                             [shard_kv_blocks(hosts[i][a:a + rows], t,
                                              m.tp_size) for t in tps])
                    src = self.mesh.scatter_from_root(
                        parts, self._block_shape(pool, rows, False), pool.dtype)
                    self._block_view(pool).index_copy_(
                        2, idx[a:a + rows], src.movedim(0, 2))

    # ------------------------------------------------------------------ mesh
    @staticmethod
    def _bits_digest(rows) -> int:
        """A digest of the raw bits of ``rows`` (tensors, in order), one row
        at a time on the device: equal rows give equal digests."""
        digest = 0
        for row in rows:
            c = row.reshape(-1).view(
                _INT_OF_SIZE[row.element_size()]).long() % 65521
            w = torch.arange(c.numel(), device=c.device) % 65521 + 1
            digest = (digest * _DIGEST_MULT + int((c * w).sum())) % _DIGEST_MOD
        return digest

    def pool_digest(self) -> int:
        """A digest of this rank's pools' raw bits (payload and scales),
        over every slot but the null block's (block 0, which padding rows
        write in no fixed order), one (layer, head) row at a time: equal
        pools give equal digests, so replicas of one tp rank can be
        compared."""
        bs = self.config.block_size
        return self._bits_digest(head[bs:] for pool in self._pools()
                                 for layer in pool for head in layer)

    def spec_digest(self) -> Optional[int]:
        """A digest of the draft rings' raw bits (K, V and positions) over
        every slot but the trash slot (padding rows write it), like
        ``pool_digest``: replicas hold equal rings. None without
        speculation."""
        if not self.spec_n:
            return None
        s = self.spec_num_slots
        return self._bits_digest(
            head[:s] for ring in (self.spec_k, self.spec_v,
                                  self.spec_pos[None, None])
            for layer in ring for head in layer)

    def _rank_report(self, pool_digest: bool = False) -> Dict:
        cuda = self.device.type == "cuda"
        return {
            "rank": self.rank, "pid": os.getpid(), "device": str(self.device),
            "coords": (list(self.mesh.coords) if self.mesh is not None
                       else [0, 0, 0]),
            "hbm_kv_bytes": self.hbm_kv_bytes,
            "weight_bytes": sum(
                t.numel() * t.element_size() for k, v in self.params.items()
                for t in (v.values() if k == "layers" else [v])),
            "head_f32_bytes": self.head_f32.numel() * 4,
            "num_kv_blocks": self.num_kv_blocks,
            "launch_counts": pa.launch_counts(),
            "token_digest": (int(self._digest.item())
                             if self._digest is not None else None),
            "dispatches": self._dispatches,
            "decode_steps_total": self.decode_steps_total,
            "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                           if cuda else 0),
            # The sp ring's ring-attended layer calls by kind, exchanges
            # and host seconds (None without an sp ring).
            "rings": dict(self.sp.rings) if self.sp is not None else None,
            "ring_exchanges": self.sp.exchanges if self.sp is not None else 0,
            "ring_seconds": self.sp.ring_seconds if self.sp is not None else 0.0,
            "pool_digest": self.pool_digest() if pool_digest else None,
            # The draft rings' digest beside the pool's, and the draft
            # catch-ups this rank ran (speculation only).
            "spec_digest": self.spec_digest() if pool_digest else None,
            "spec_ingests": self.spec_ingests_total,
        }

    def _answer_query(self, reset: bool, pool_digest: bool = False
                      ) -> List[Dict]:
        reports = self.mesh.gather_object(self._rank_report(pool_digest))
        if reset:
            pa.reset_launch_counts()
            self._digest.zero_()
            if self.sp is not None:
                self.sp.rings = dict.fromkeys(self.sp.rings, 0)
                self.sp.exchanges = 0
                self.sp.ring_seconds = 0.0
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        return reports

    def tp_query(self, reset: bool = False, pool_digest: bool = False
                 ) -> List[Dict]:
        """Rank 0, between dispatches: every rank's report (grid
        coordinates, launch counts, token digest, ring counts, pool and
        weight bytes, dispatches, decode steps, peak device bytes, and with
        ``pool_digest`` its pools' digest), in rank order. ``reset`` then
        sets each rank's launch counts, token digest, ring counts and
        peak-memory mark to 0."""
        with self.mesh.lock:
            self.mesh.send_header(pmesh.QUERY, int(reset), int(pool_digest))
            return self._answer_query(reset, pool_digest)

    def tp_stop(self) -> List[Dict]:
        """Rank 0: end the workers' descriptor loops; returns every rank's
        final report."""
        with self.mesh.lock:
            self.mesh.send_header(pmesh.STOP)
            return self._answer_query(False)

    def serve(self) -> List[Dict]:
        """Ranks 1..world-1: run rank 0's descriptors, in order, until the
        stop descriptor; returns the final reports."""
        m = self.mesh
        vocab = self.model_config.vocab_size
        while True:
            h = m.recv_header()
            kind = h[0]
            if kind == pmesh.NOOP:
                continue
            if kind == pmesh.QUERY:
                self._answer_query(bool(h[1]), bool(h[2]))
                continue
            if kind == pmesh.STOP:
                return self._answer_query(False)
            if kind == pmesh.EMBED:
                b, t = h[1:3]
                packed = torch.empty((b * t + b,), dtype=torch.int32)
                m.bcast(packed)
                self._embed_device(packed, b, t)
                continue
            if kind == pmesh.SPEC_RESET:
                self._spec_reset_device(h[1])
                continue
            if kind == pmesh.SPEC_INGEST:
                slot, lo, n, t = h[1:5]
                packed = self.ingest_train.host_packed(t, lo, n, slot)
                m.bcast(packed[INGEST_SCALARS:])
                self._spec_ingest_device(packed)
                continue
            if kind in (pmesh.KV_READ, pmesh.KV_WRITE):
                n, quantized, step = h[1:4]
                if bool(quantized) != self.kv_quantized:
                    raise RuntimeError(
                        f"block I/O descriptor for a {'int8' if quantized else 'unquantized'} "
                        f"pool reached rank {self.rank}")
                ids = torch.empty((n,), dtype=torch.int64)
                m.bcast(ids)
                if kind == pmesh.KV_READ:
                    self._read_device(ids, step)
                else:
                    self._write_device(ids, None, step)
                continue
            if kind == pmesh.DECODE:
                d, b, mb, k, n_steps, chain_src, pen, lpk = h[1:9]
                n_payload = NUM_SCALARS * b + b * mb
            elif kind == pmesh.SPEC_DECODE:
                d, b, mb, k, max_cycles, pen, lpk, mode = h[1:9]
                if mode != self._spec_mode_code:
                    raise RuntimeError(
                        f"speculative descriptor of mode {mode} reached rank "
                        f"{self.rank}, whose mode is {self._spec_mode_code}")
                n_payload = NUM_SCALARS * b + b * mb
            elif kind == pmesh.PREFILL:
                d, b, t, mb, has_window, pen, lpk = h[1:8]
                n_payload = NUM_SCALARS * b + b * mb + b * t + b
            else:
                raise RuntimeError(f"unknown dispatch descriptor kind {kind}")
            if d != self._dispatches:
                raise RuntimeError(f"descriptor of dispatch {d} reached rank "
                                   f"{self.rank} at dispatch {self._dispatches}")
            slot = self._slot(n_payload, 0)
            m.bcast(slot.inp[:n_payload])
            counts = None
            if pen:
                counts = torch.empty((b, vocab), dtype=torch.int32)
                m.bcast(counts)
            if kind == pmesh.DECODE:
                self._decode_device(slot, b, mb, k, n_steps, chain_src, counts,
                                    lpk)
            elif kind == pmesh.SPEC_DECODE:
                self._spec_decode_device(slot, b, mb, k, max_cycles, counts,
                                         lpk)
            else:
                finals = [bool(f) for f in slot.inp[n_payload - b:n_payload].tolist()]
                self._prefill_device(slot, b, t, mb, bool(has_window), finals,
                                     counts, lpk)
            if slot.end is not None:
                slot.end.record()
