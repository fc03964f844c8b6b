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
  * A prefill dispatch (eager) computes slot mappings, gathers the history
    window once, runs the forward, samples from the last token's logits and
    scatters the chunk's KV once. Its chunk length and block-table width
    pad to the reference's buckets; its rows are not padded (no graph
    replays prefill yet, and a padding row costs a full forward).
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
    caught up by an eager draft ingest before its prefill or decode. A
    decode dispatch runs the speculative train of ``decode_graphs.py``
    (draft N + 1, verify once, accept on the device); its fetch returns
    each row's accepted tokens, a variable count, and feeds the adaptive
    controller (``SpecGammaController``); a batch whose rows all sit at
    gamma 0 runs the plain train (``spec_gamma0_dispatches_total``).
  * Weights: a local HF checkpoint directory (``config.model``, and the
    speculative draft's) is loaded by ``models/weights.py:load_hf_params``
    straight into device stacks (this rank's shard); a named config, or
    ``load_format="dummy"``, draws random weights from ``seed``.
  * LoRA: the engine's registry (``models/lora.py``) is stacked once on the
    device; each row's adapter index rides packed scalar row 8 of prefill
    and decode dispatches, and the prefill forward, the decode step and the
    speculative verify add the per-row delta (the draft runs the base
    model, as the reference's).
  * Tensor parallelism (``tensor_parallel_size`` > 1, ``parallel/``): each
    rank's runner holds its param shard and the pools of its kv heads, and
    every dispatch splits in two. The host part, on rank 0 only, packs the
    int32 buffer from the ``ScheduledBatch``; the device part runs on every
    rank from a descriptor (kind, shape key, ``n_steps``, ``finals``,
    penalty counts, chain source and the packed buffer) that rank 0
    broadcasts on the tp group's CPU group right before its own device
    part. Chains are kept per dispatch number on every rank, so a worker
    needs no ``Sequence``. Every rank samples from the same full logits
    with the same seeds, so start tokens chain on every rank without a
    broadcast; only rank 0 copies tokens to the host. Each rank keeps a
    device digest of the tokens it sampled, reported with its launch
    counts (``tp_query``) and at ``tp_stop``.
"""

import contextlib
import os
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
from production_stack_tpu_torch.engine.sampling import (
    LOGPROB_BUCKETS,
    adaptive_gamma,
    apply_penalties,
    compute_logprobs,
    gumbel_noise,
    logprobs_bucket,
    sample_tokens,
    seed_base,
    token_seeds,
)
from production_stack_tpu_torch.engine.scheduler import (
    INTERACTIVE_DECODE_STEPS,
    ScheduledBatch,
    decode_step_cap,
)
from production_stack_tpu_torch.kv_offload.serde import BF16, dtype_name
from production_stack_tpu_torch.models import get_model_fns
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.lora import shard_stacks
from production_stack_tpu_torch.models.weights import dtype_of, load_hf_params
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.ops.attention import gather_window
from production_stack_tpu_torch.ops.quantization import (
    SCALE_DTYPE,
    quantize_kv,
)
from production_stack_tpu_torch.ops.tree_mask import (
    main_chain_indices,
    tree_attention_bias,
    tree_structure,
)
from production_stack_tpu_torch.parallel import mesh
from production_stack_tpu_torch.parallel.sharding import shard_params
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
                 tp: Optional[mesh.TPGroup] = None,
                 broadcast_params: bool = False,
                 draft_params: Optional[Dict] = None,
                 lora_registry=None):
        """``tp``: this process's rank of the tensor-parallel group (None at
        tensor_parallel_size 1). ``params`` are FULL params; at tp > 1 rank
        0's are broadcast to the workers (which pass ``broadcast_params``)
        and each rank keeps its shard. Without ``params`` every rank loads
        its shard of the checkpoint directory ``config.model``, or draws it
        from config.seed (``_load_or_init_params``). ``draft_params``: the
        speculative draft's params when it is not the target itself (else
        loaded or drawn the same way). ``lora_registry``: the engine's
        ``models/lora.py:LoRARegistry`` (None: no adapters)."""
        self.config = config
        self.model_config = model_config
        if (tp.size if tp is not None else 1) != config.tensor_parallel_size:
            raise ValueError(
                f"tensor_parallel_size {config.tensor_parallel_size} needs a "
                f"tp group of that size, got {tp.size if tp else None}")
        self.tp = tp if config.tensor_parallel_size > 1 else None
        self.rank = tp.rank if self.tp is not None else 0
        self.device = (self.tp.device if self.tp is not None
                       else resolve_device(config.device))
        # (init_params, forward, compute_logits, lm_head_f32) of the arch:
        # llama, or OPT (window path, tp 1; config.validate_parallelism).
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
        if self.tp is not None and (params is not None or broadcast_params):
            params = self.tp.broadcast_params(params)
        t0 = time.monotonic()
        if params is None:
            params, _ = self._load_or_init_params(model_config, config.model,
                                                  init_fn)
        else:
            params = shard_params(params, model_config, self.rank, tp_size)
            params = {
                k: ({n: t.to(self.device, self.dtype) for n, t in v.items()}
                    if k == "layers" else v.to(self.device, self.dtype))
                for k, v in params.items()
            }
        self.params = params
        self.head_f32 = head_fn(params, model_config)
        self.startup_weight_load_seconds = time.monotonic() - t0
        # Every registered LoRA adapter stacked per target, on the device
        # (this rank's slice at tp > 1): rows select theirs by the index in
        # packed scalar row 8 (models/lora.py). None without adapters.
        self.lora_stacks = (
            shard_stacks(lora_registry.stacks(self.device), self.rank, tp_size)
            if lora_registry is not None else None)
        self._init_spec(draft_params)
        if self.tp is not None:
            # Every rank's weights are resident before any rank reads the
            # free memory its pool may take.
            self.tp.barrier()
        n = num_kv_blocks or config.num_kv_blocks or self._derive_num_blocks()
        if self.tp is not None:
            # Block ids are global: every rank holds the same count.
            n = self.tp.min_int(n)
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
                        if self.tp is not None else None)
        self.decode_train = DecodeTrain(self)
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
        if self.tp is not None:
            self.rank_info = self.tp.gather_object(self.rank_info[0])

    def _load_or_init_params(self, model_config: ModelConfig, source: str,
                             init_fn) -> Tuple[Dict, bool]:
        """A model's params (this rank's shard) on the device: loaded from
        the local HF checkpoint directory ``source``, or drawn from
        config.seed (named configs, ``load_format="dummy"``). ONE loader for
        the target and the speculative draft (the reference's). Returns
        (params, loaded_from_checkpoint). A checkpoint with a missing
        tensor raises: nothing falls back to random weights."""
        cfg = self.config
        tp_size = cfg.tensor_parallel_size
        if cfg.load_format != "dummy" and os.path.isdir(source):
            return load_hf_params(model_config, source, self.dtype,
                                  self.device, rank=self.rank,
                                  tp=tp_size), True
        gen = torch.Generator(device=self.device)
        gen.manual_seed(cfg.seed)
        return init_fn(model_config, gen, self.dtype, self.device,
                       rank=self.rank, tp=tp_size), False

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
    def _init_spec(self, draft_params: Optional[Dict]) -> None:
        """The draft model, its ring pools (allocated before the KV pool is
        sized from free memory), slots, tree constants, controller and the
        acceptance counters (the reference's spec ``__init__`` block)."""
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
        with self._io_stream():
            self.spec_pos[slot].fill_(POS_SENTINEL)
        self._spec_slots[request_id] = slot
        self._spec_warmed[request_id] = 0
        return slot

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
        in place (the decode graphs hold the pools' addresses)."""
        b = slot_idx.shape[0]
        r_len = self.spec_ring_len
        slot_c = torch.clamp(slot_idx, 0, self.spec_num_slots - 1).long()
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
        self.spec_k.index_copy_(2, slot_idx.long(), drk[:, :, :b])
        self.spec_v.index_copy_(2, slot_idx.long(), drv[:, :, :b])
        self.spec_pos.index_copy_(0, slot_idx.long(), drp[:b])

    def _spec_catch_up(self, seq, upto: int) -> None:
        """Ensure the sequence's draft ring covers context up to ``upto``
        (exclusive): ingest the most recent min(R, upto) tokens it has not
        seen, through the draft, eagerly (the reference's
        ``_spec_catch_up`` and ``_spec_ingest_jit``). Acceptance only,
        never output correctness."""
        rid = seq.request_id
        warmed = self._spec_warmed.get(rid, 0)
        if warmed >= upto:
            return
        r_len = self.spec_ring_len
        lo = max(0, upto - r_len, min(warmed, upto))
        toks = seq.all_token_ids[lo:upto]
        if not toks:
            self._spec_warmed[rid] = upto
            return
        slot = self.spec_slot(rid)
        t = _bucket(len(toks), 16, max(16, 1 << (r_len - 1).bit_length()))
        dev = self.device
        with torch.no_grad(), self._io_stream():
            padded = torch.zeros((1, t), dtype=torch.int32)
            padded[0, :len(toks)] = torch.tensor(toks, dtype=torch.int32)
            padded = padded.to(dev)
            positions = lo + torch.arange(t, dtype=torch.int32,
                                          device=dev)[None, :]
            length = torch.full((1,), len(toks), dtype=torch.int32, device=dev)
            slot_idx = torch.full((1,), slot, dtype=torch.int32, device=dev)
            slot_c = slot_idx.long()
            _, dk, dv = self.draft_forward(
                self.spec_params, self.spec_draft_config, padded,
                torch.clamp(positions, max=self.spec_draft_max_pos - 1),
                length, None, None, None, self.spec_k[:, :, slot_c],
                self.spec_v[:, :, slot_c], self.spec_pos[slot_c])
            in_chunk = torch.arange(t, device=dev)[None, :] < len(toks)
            self._spec_ring_write(dk, dv, positions, in_chunk, slot_idx,
                                  torch.zeros((1,), dtype=torch.bool,
                                              device=dev))
        self._spec_warmed[rid] = upto

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
        all tp ranks."""
        return (self.num_kv_blocks * self.config.tensor_parallel_size
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
                * cfg.tensor_parallel_size)

    def _derive_num_blocks(self) -> int:
        """Size the KV pool from free device memory (after the weights are
        resident); the CPU gets a conservative 2 GiB. The pool costs its
        storage bytes (int8 payload + scales when quantized); gathered
        windows hold dequantized compute-dtype K/V and cost those bytes.
        Bytes are this rank's (its kv heads); tp ranks sharing one card
        each take their share of its free memory (the caller then takes the
        minimum over ranks)."""
        mc, cfg = self.model_config, self.config
        bytes_per_block = cfg.kv_cache_bytes_per_block(mc)
        window_bytes_per_block = cfg.window_bytes_per_block(mc)
        if self.device.type == "cuda":
            free_bytes, _ = torch.cuda.mem_get_info(self.device)
            free_bytes //= mesh.ranks_per_device(
                self.device, cfg.tensor_parallel_size)
        else:
            free_bytes = 2 << 30
        budget = int(free_bytes * cfg.hbm_utilization)
        if self.attn_impl == "window":
            n = budget // (bytes_per_block + window_bytes_per_block)
        else:
            # Paged decode never copies the pool, but chunked prefill still
            # gathers a [rows, max_blocks] history window: reserve it.
            reserve_bytes = min(
                _bucket(cfg.max_prefill_seqs, 1, max(1, cfg.max_num_seqs))
                * _bucket(cfg.max_blocks_per_seq, 1,
                          max(1, cfg.max_blocks_per_seq))
                * window_bytes_per_block,
                budget // 2,
            )
            self._prefill_window_blocks = max(
                1, reserve_bytes // window_bytes_per_block
            )
            n = (budget - reserve_bytes) // bytes_per_block
        n = max(2, min(n, cfg.max_blocks_per_seq * cfg.max_num_seqs + 1))
        logger.info(
            "KV pool: %d blocks x %d tokens (%.1f MiB, kv_cache_dtype=%s, "
            "attn=%s, device=%s)",
            n, cfg.block_size, n * bytes_per_block / (1 << 20),
            cfg.kv_cache_dtype, self.attn_impl, self.device,
        )
        return n

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

    def reachable_prefill_families(self) -> List[Tuple[int, int, int, bool]]:
        """Every (b, t, mb, has_window) prefill family reachable under this
        config (the reference's set; prefill runs eagerly in the port)."""
        cfg = self.config
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
                        if pb * mb <= self.prefill_window_blocks:
                            fams.add((pb, t, mb, True))
                t *= 2
        return sorted(fams)

    def prefill_shape(self, batch: ScheduledBatch) -> Tuple[int, int, bool]:
        """(t, mb, has_window) of a prefill dispatch: its chunk-length and
        block-table buckets, as the reference's. With the reference's row
        family (1, or the ``max_prefill_seqs`` bucket) they make its
        (b, t, mb, has_window) family in ``reachable_prefill_families``."""
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

    def warmup(self) -> None:
        """Before serving: on the card, capture head, step and tail of
        every decode graph family (``DecodeTrain.capture``; the kernel
        library is built first); on the CPU, run each family's all-zero
        dummy dispatch eagerly. Dummy dispatches have budget 0 and table 0
        in every row, so they write only the null block: the pool's other
        blocks survive warmup. Prefill stays eager and is not warmed. At
        tp > 1 no family is captured (gloo collectives cannot be captured,
        and NCCL capture is not ported): decode runs eagerly."""
        t0 = time.monotonic()
        cuda = self.device.type == "cuda"
        if cuda and self.attn_impl == "paged":
            pa.build_kernels()
        if self.tp is not None:
            logger.info("warmup: tp=%d: no decode family captured (decode "
                        "runs eagerly)", self.tp.size)
            return
        keys = self.decode_graph_keys()
        if cuda:
            # The arena holds every family first; the logprob variants are
            # captured apart, so their share of the graph pool is read.
            self.decode_train.reserve(keys)
            with self.kv_io_lock:
                self.decode_train.capture([k for k in keys if not k[4]])
                self.decode_train.capture([k for k in keys if k[4]])
        else:
            self.decode_train.reserve(keys)
            for key in keys:
                self.decode_train.dummy_dispatch(key)
        logger.info("warmup: %d decode families in %.2f s (%s)", len(keys),
                    time.monotonic() - t0, "CUDA graphs" if cuda else "eager")

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
        """Rank 0 holds the tp group's lock from a descriptor's broadcast to
        the end of the device work it describes."""
        return self.tp.lock if self.tp is not None else contextlib.nullcontext()

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
        """Fold sampled tokens into this rank's device digest (tp > 1)."""
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
            if self.tp is not None:
                self.tp.send_header(mesh.DECODE, self._dispatches, b, mb, k,
                                    n_steps, chain_src, int(counts is not None),
                                    lpk)
                self.tp.bcast(slot.inp[:n_packed])
                if counts is not None:
                    self.tp.bcast(counts)
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
        key = (b, mb, k, counts is not None, lpk, True)
        train = self.decode_train
        bf = train.buffers(*key)
        parts = [bf.toks_all, bf.emits, bf.stats]
        if lpk:
            parts += [bf.lp_chosen, bf.lp_top, bf.lp_ids]
        n_out = sum(t.numel() for t in parts)
        if slot.out.numel() < n_out:
            slot.out = torch.empty((n_out,), dtype=torch.int32,
                                   pin_memory=self.device.type == "cuda")
        bf.packed.copy_(slot.inp[:n_packed], non_blocking=True)
        if counts is not None:
            bf.counts.copy_(counts)
        cycles = train.run(key, bf, max(steps))
        self._push_rows(self._push_last(bf.last.clone()), seqs, range(n))
        self._dispatches += 1
        self.spec_dispatches_total += 1
        self.spec_cycles_run_total += cycles
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

    def _decode_device(self, slot: _Slot, b: int, mb: int, k: int,
                       n_steps: int, chain_src: int,
                       counts: Optional[torch.Tensor], lpk: int = 0):
        """The device part of a decode dispatch, on every rank: the fused
        train over the packed inputs in ``slot``. Returns (dispatch number,
        the train's buffers)."""
        n_packed = NUM_SCALARS * b + b * mb
        key = (b, mb, k, counts is not None, lpk, False)
        train = self.decode_train
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
        reference's ``_issue_prefill`` + ``_prefill_impl``); its fetch
        returns the sampled token of rows whose prompt completes in this
        chunk. Packed rows: 0 chunk_start, 1 chunk_len, 2 seed_base,
        3 gen0, 4 temperature, 5 top_k, 6 top_p, 8 adapter, 9 presence,
        10 frequency;
        then the block tables, the chunk's tokens and (the descriptor's
        ``finals``) one flag per row."""
        t_issue = time.monotonic()
        seqs = batch.seqs
        b = len(seqs)
        t, mb, has_window = self.prefill_shape(batch)
        finals = [
            batch.chunk_starts[i] + batch.chunk_lens[i] >= seqs[i].num_tokens
            for i in range(b)
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
        packed[n_packed:] = finals
        f32 = sc.view(np.float32)
        u32 = sc.view(np.uint32)
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
            if self.tp is not None:
                self.tp.send_header(mesh.PREFILL, self._dispatches, b, t, mb,
                                    int(has_window), int(counts is not None),
                                    lpk)
                self.tp.bcast(slot.inp[:n_packed + b])
                if counts is not None:
                    self.tp.bcast(counts)
            d, next_tokens, lp = self._prefill_device(
                slot, b, t, mb, has_window, finals, counts, lpk)

        if next_tokens is None:
            if slot.end is not None:
                slot.end.record()
            self.prefill_seconds_total += time.monotonic() - t_issue
            return DispatchHandle(lambda: ([[] for _ in range(b)], None))
        # Final rows' sampled tokens are chainable by the next decode
        # without a host round trip.
        self._push_rows(d, seqs, [i for i in range(b) if finals[i]])
        out_buf, end = slot.out, slot.end
        offs = self._copy_out(out_buf, [next_tokens, *lp])
        if end is not None:
            end.record()

        def fetch():
            if end is not None:
                end.synchronize()
            host = out_buf.numpy()
            out = host[:b]
            self.prefill_seconds_total += time.monotonic() - t_issue
            tokens = [[int(out[i])] if finals[i] else [] for i in range(b)]
            lps = (self._gather_logprobs(seqs, [int(f) for f in finals],
                                         host, offs, 1, b, lpk)
                   if lpk else None)
            return tokens, lps

        return DispatchHandle(fetch)

    def _prefill_device(self, slot: _Slot, b: int, t: int, mb: int,
                        has_window: bool, finals: List[bool],
                        counts: Optional[torch.Tensor], lpk: int = 0):
        """The device part of a prefill dispatch, on every rank: slot
        mappings, the history window, the forward, sampling (when a row's
        prompt completes) and the one scatter of the chunk's KV. Returns
        (dispatch number, the sampled tokens or None, the logprob arrays
        of ``compute_logprobs`` or ())."""
        cfg, mc = self.config, self.model_config
        bs = cfg.block_size
        n_sc = NUM_SCALARS * b
        n_packed = n_sc + b * mb + b * t
        dev = torch.empty((n_packed,), dtype=torch.int32, device=self.device)
        dev.copy_(slot.inp[:n_packed], non_blocking=True)
        scalars = dev[:n_sc].view(NUM_SCALARS, b)
        chunk_start, chunk_lens = scalars[0], scalars[1]
        temps = scalars[4].view(torch.float32)
        top_k = scalars[5]
        top_p = scalars[6].view(torch.float32)
        block_tables = dev[n_sc:n_sc + b * mb].view(b, mb)
        token_ids = dev[n_sc + b * mb:].view(b, t)

        t_iota = torch.arange(t, dtype=torch.int32, device=self.device)
        positions = torch.clamp(chunk_start[:, None] + t_iota[None, :],
                                max=cfg.max_model_len - 1)           # [b, t]
        in_chunk = t_iota[None, :] < chunk_lens[:, None]
        blk_idx = torch.clamp(positions // bs, 0, mb - 1)
        blk = torch.gather(block_tables, 1, blk_idx.long())
        slot_mapping = torch.where(in_chunk, blk * bs + positions % bs,
                                   torch.zeros_like(blk))
        if has_window:
            # The history window dequantizes; the chunk attends its own
            # fresh K/V unquantized.
            win_k, win_v = gather_window(
                self.kv_k, self.kv_v, block_tables, bs, self.kv_k_scale,
                self.kv_v_scale, out_dtype=self.dtype)
            win_len = chunk_start
        else:
            win_k = win_v = win_len = None
        hidden, k_new, v_new = self.model_forward(
            self.params, mc, token_ids, positions, chunk_lens,
            win_k, win_v, win_len, tp=self.tp, lora=self.lora_of(scalars),
        )
        del win_k, win_v
        if self.spec_n:
            self._prefill_draft(token_ids, positions, chunk_start, chunk_lens,
                                in_chunk, scalars[12])
        next_tokens, lp = None, ()
        if any(finals):
            logit_idx = torch.clamp(chunk_lens - 1, min=0).long()
            last_hidden = hidden[torch.arange(b, device=self.device), logit_idx]
            logits = self.model_logits(self.params, mc, last_hidden,
                                       self.head_f32, tp=self.tp)
            if self.logits_sink is not None:
                self.logits_sink.append(logits.clone())
            if counts is not None:
                logits_eff = apply_penalties(
                    logits, counts.to(self.device),
                    scalars[9].view(torch.float32),
                    scalars[10].view(torch.float32))
            else:
                logits_eff = logits
            gumbel = gumbel_noise(token_seeds(scalars[2], scalars[3]),
                                  logits.shape[1], self.device,
                                  rows=temps > 0.0)
            next_tokens = sample_tokens(logits_eff, temps, top_k, top_p,
                                        gumbel).int()
            if lpk:
                lp = compute_logprobs(logits, next_tokens, lpk)

        nl, hkv, dh = mc.num_layers, self.local_kv_heads, mc.head_dim_
        flat_slots = slot_mapping.reshape(-1).long()
        k_flat = k_new.reshape(nl, hkv, b * t, dh)
        v_flat = v_new.reshape(nl, hkv, b * t, dh)
        if self.kv_quantized:
            # Quantized before the one scatter: compute-dtype K/V never
            # lands in an int8 pool.
            k_flat, k_sc = quantize_kv(k_flat)
            v_flat, v_sc = quantize_kv(v_flat)
            self.kv_k_scale[:, :, flat_slots] = k_sc
            self.kv_v_scale[:, :, flat_slots] = v_sc
            self.kv_quant_tokens_written += int(slot.inp[b:2 * b].sum())
        self.kv_k[:, :, flat_slots] = k_flat
        self.kv_v[:, :, flat_slots] = v_flat
        d = self._dispatches
        if next_tokens is not None:
            last = torch.zeros((self.b_max,), dtype=torch.int32,
                               device=self.device)
            last[:b] = next_tokens
            self._push_last(last)
            self._digest_add(next_tokens)
        self._dispatches += 1
        return d, next_tokens, lp

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
        between dispatches on the engine's worker thread; at tp > 1 every
        rank runs its shard's forward (an EMBED descriptor)."""
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
                if self.tp is not None:
                    self.tp.send_header(mesh.EMBED, b, t)
                    self.tp.bcast(packed)
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

    def read_blocks(self, block_ids: List[int]):
        """Device-to-host read of whole KV blocks (the reference's
        ``read_blocks``): (k, v, k_scale, v_scale) numpy arrays, payload
        ``[n, L, Hkv, bs, Dh]`` in the pool's storage dtype (bfloat16 as
        ``kv_offload.serde.BF16``), plus the per-slot scales ``[n, L, Hkv,
        bs]`` of an int8 pool (None otherwise). A gather through the
        ``[L, Hkv, nblk, bs, Dh]`` view of each pool, then one copy into
        pinned host memory, on the dispatch stream: it runs after every
        dispatch enqueued before it, whichever thread calls. This rank's
        kv heads only: the config refuses the KV tier at tp > 1."""
        cuda = self.device.type == "cuda"
        with self.kv_io_lock, self._io_stream():
            idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                                  device=self.device)
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
        out = [_to_numpy(h) for h in hosts]
        if not self.kv_quantized:
            out += [None, None]
        return tuple(out)

    def read_blocks_retry(self, block_ids: List[int], attempts: int = 3):
        """``read_blocks`` with the reference's retry. Reads never race a
        donation here (the pools are updated in place), so a failure is
        retried only against a transient device error."""
        for attempt in range(attempts):
            try:
                return self.read_blocks(block_ids)
            except RuntimeError:
                if attempt == attempts - 1:
                    raise
                time.sleep(0.01)

    def write_blocks(self, block_ids: List[int], k_np, v_np,
                     k_scale=None, v_scale=None) -> None:
        """Host-to-device restore of whole KV blocks (the reference's
        ``write_blocks``): ``[n, L, Hkv, bs, Dh]`` payloads, and an int8
        pool's ``[n, L, Hkv, bs]`` scales (it restores bit-identically, no
        requantization). Staged in pinned memory, copied and scattered on
        the dispatch stream with ``index_copy_`` into the pool tensors
        themselves: the decode graphs captured their addresses, so the
        pools are never rebound. The next dispatch runs after the scatter
        (same stream)."""
        if self.kv_quantized and k_scale is None:
            raise ValueError(
                "restoring into an int8 KV pool requires per-slot scales "
                "(blob written by a kv_cache_dtype=bfloat16 engine?)")
        cuda = self.device.type == "cuda"
        arrays = [k_np, v_np] + ([k_scale, v_scale] if self.kv_quantized
                                 else [])
        with self._io_stream():
            idx = torch.as_tensor(list(block_ids), dtype=torch.long,
                                  device=self.device)
            for pool, arr in zip(self._pools(), arrays):
                src = _to_torch(arr, pin=cuda).to(
                    self.device, non_blocking=cuda).to(pool.dtype)
                self._block_view(pool).index_copy_(2, idx, src.movedim(0, 2))
        if self.kv_quantized:
            self.kv_quant_tokens_written += (len(block_ids)
                                             * self.config.block_size)

    # ------------------------------------------------------ tensor parallel
    def _rank_report(self) -> Dict:
        cuda = self.device.type == "cuda"
        return {
            "rank": self.rank, "pid": os.getpid(), "device": str(self.device),
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
        }

    def _answer_query(self, reset: bool) -> List[Dict]:
        reports = self.tp.gather_object(self._rank_report())
        if reset:
            pa.reset_launch_counts()
            self._digest.zero_()
            if self.device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(self.device)
        return reports

    def tp_query(self, reset: bool = False) -> List[Dict]:
        """Rank 0, between dispatches: every rank's report (launch counts,
        token digest, pool and weight bytes, dispatches, decode steps, peak
        device bytes), in rank order. ``reset`` then sets each rank's launch
        counts, digest and peak-memory mark to 0."""
        with self.tp.lock:
            self.tp.send_header(mesh.QUERY, int(reset))
            return self._answer_query(reset)

    def tp_stop(self) -> List[Dict]:
        """Rank 0: end the workers' descriptor loops; returns every rank's
        final report."""
        with self.tp.lock:
            self.tp.send_header(mesh.STOP)
            return self._answer_query(False)

    def serve(self) -> List[Dict]:
        """Ranks 1..tp-1: run rank 0's descriptors, in order, until the
        stop descriptor; returns the final reports."""
        tp = self.tp
        vocab = self.model_config.vocab_size
        while True:
            h = tp.recv_header()
            kind = h[0]
            if kind == mesh.NOOP:
                continue
            if kind == mesh.QUERY:
                self._answer_query(bool(h[1]))
                continue
            if kind == mesh.STOP:
                return self._answer_query(False)
            if kind == mesh.EMBED:
                b, t = h[1:3]
                packed = torch.empty((b * t + b,), dtype=torch.int32)
                tp.bcast(packed)
                self._embed_device(packed, b, t)
                continue
            if kind == mesh.DECODE:
                d, b, mb, k, n_steps, chain_src, pen, lpk = h[1:9]
                n_payload = NUM_SCALARS * b + b * mb
            elif kind == mesh.PREFILL:
                d, b, t, mb, has_window, pen, lpk = h[1:8]
                n_payload = NUM_SCALARS * b + b * mb + b * t + b
            else:
                raise RuntimeError(f"unknown dispatch descriptor kind {kind}")
            if d != self._dispatches:
                raise RuntimeError(f"descriptor of dispatch {d} reached rank "
                                   f"{self.rank} at dispatch {self._dispatches}")
            slot = self._slot(n_payload, 0)
            tp.bcast(slot.inp[:n_payload])
            counts = None
            if pen:
                counts = torch.empty((b, vocab), dtype=torch.int32)
                tp.bcast(counts)
            if kind == mesh.DECODE:
                self._decode_device(slot, b, mb, k, n_steps, chain_src, counts,
                                    lpk)
            else:
                finals = [bool(f) for f in slot.inp[n_payload - b:n_payload].tolist()]
                self._prefill_device(slot, b, t, mb, bool(has_window), finals,
                                     counts, lpk)
            if slot.end is not None:
                slot.end.record()
