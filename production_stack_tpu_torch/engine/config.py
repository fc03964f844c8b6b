"""Engine configuration: the fields of ``production_stack_tpu/engine/config.py``
that the port's serving path reads, under the same names, defaults and
environment variables, plus ``device``.

The parallel degrees (tensor, sequence, data) lay out the reference's
``dp x sp x tp`` mesh as one process per rank (``parallel/mesh.py``), and
``validate_parallelism`` makes the reference's checks of them, plus the
port's own refusals, each named (ROADMAP Queue 3).
``compilation_cache_dir`` is the directory of the port's warm-up manifest
(``engine/runner.py:ModelRunner.warmup``); unlike the reference's it
defaults to unset, so a default start warms every variant.
"""

import os
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from production_stack_tpu_torch.ops.paged_attention import supports_paged_decode
from production_stack_tpu_torch.ops.quantization import (
    KV_CACHE_DTYPES,
    SCALE_ITEMSIZE,
)

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}
_SPEC_MESH_ERROR = (
    "--speculative-num-tokens is incompatible with "
    "--tensor-parallel-size/--sequence-parallel-size > 1: speculative "
    "decoding currently requires a single-device mesh (tp=sp=1) — the "
    "draft-KV ring pools and the batched verify chunk are not mesh-sharded "
    "yet.")


@dataclass
class EngineConfig:
    model: str = "tiny-llama"
    dtype: str = "bfloat16"
    # Entry points run on the card; the CPU only when asked for ("cpu").
    device: str = "cuda"
    max_model_len: int = 2048
    # --- KV cache ---
    # Pool STORAGE dtype (compute stays ``dtype``): "int8" stores K/V as
    # symmetric int8 with a per-(slot, head) bf16 scale
    # (ops/quantization.py); readers dequantize inline (window gather, the
    # paged kernel's int8 variant).
    kv_cache_dtype: str = "bfloat16"
    block_size: int = 16
    num_kv_blocks: Optional[int] = None     # explicit block count; else derived
    hbm_utilization: float = 0.9            # fraction of free memory for KV
    enable_prefix_caching: bool = True
    # --- scheduler ---
    max_num_seqs: int = 64
    max_num_batched_tokens: int = 4096      # prefill dispatch token budget
    max_prefill_seqs: int = 8               # rows per batched prefill dispatch
    # MAX decode steps fused into ONE dispatch; the scheduler grades K down
    # with the number of streams (scheduler.decode_step_cap).
    num_decode_steps: int = 32
    # --- kernels ---
    # "auto" -> "paged" on CUDA when the kernel takes the model (llama
    # family, head_dim 64/128, bf16), else "window". "window": decode
    # gathers the live KV into a contiguous window. "paged": force the
    # flash-decode kernel path (raises when the model can't take it).
    attn_impl: str = "auto"
    # Fused-decode loop: "scan" runs all K steps of a dispatch; "while" runs
    # max(min(budget, K)) of them (the host knows every row's budget), so a
    # drain tail skips steps no row needs. Tokens are the same either way.
    decode_loop: str = "scan"
    # Capture the decode train of every reachable (b, mb, K) family as CUDA
    # graphs before serving (engine/decode_graphs.py); on the CPU it runs
    # each family's dummy dispatch eagerly. The server turns it on.
    enable_warmup: bool = False
    # Pipelined engine loop: issue dispatch N+1 before fetching N's tokens
    # (start tokens chained on the device, scheduler state advanced at
    # issue). False restores strict issue -> fetch -> apply.
    async_pipeline: bool = True
    # Dispatches outstanding at once; 1 when async_pipeline is False, and
    # clamped to 2 by the engine loop (a third outstanding decode could need
    # start tokens from two unapplied dispatches).
    pipeline_depth: int = 2
    # Two-slot prefill/decode overlap: one scheduling round may issue a
    # prefill while a decode is in flight, and the reverse.
    overlap_dispatch: bool = True
    # --- parallelism ---
    # The mesh is dp x sp x tp ranks, one process each (parallel/mesh.py):
    # rank 0 serves, ranks 1..world-1 are worker processes it starts.
    # Tensor parallelism splits heads and projections over tp ranks
    # (parallel/sharding.py; a leaf whose dim tp does not divide is
    # replicated, the reference's fallback).
    tensor_parallel_size: int = 1
    # Seconds any collective of the mesh may wait: a lost rank is an error
    # within it.
    tp_timeout_s: float = 600.0
    # Sequence parallelism: a prefill chunk's tokens split over sp ranks,
    # its attention a ring (ops/ring_attention.py); decode replicated.
    sequence_parallel_size: int = 1
    # Data parallelism: dp replicas of the (sp, tp) ranks, each repeating
    # its twin's work (the reference's dp axis shards nothing).
    data_parallel_size: int = 1
    # The reference's persistent compile-cache directory. CUDA graphs do not
    # persist, so the port keeps only the reference's warm-up manifest there
    # (in a subdirectory per card and toolchain): a start that finds the
    # manifest of its own configuration captures the default sampling
    # variant of every family and each other variant at its first use.
    # Unset or "": every start warms every variant (the reference defaults
    # to $PSTPU_COMPILATION_CACHE or ~/.cache/pstpu_xla).
    compilation_cache_dir: Optional[str] = None
    # Fill the weights on a background thread while warm-up builds the
    # kernel library and runs the eager warm runs; captures wait for them
    # (the reference's default: off; the server turns it on). Ignored with
    # speculative decoding, without warm-up, at tp > 1 and when params are
    # passed in.
    overlap_weight_load: bool = False
    # --- prefill/decode disaggregation ---
    # "unified" serves prompts end to end. "prefill" computes a prompt's KV
    # and first token, publishes them to the remote KV store under the
    # request's transfer key and finishes ("handoff"); it forms no decode
    # batch except for router-flagged fallback traffic. "decode" restores
    # published KV into its own pool and continues the stream from token 1;
    # it forms no prefill batch except for fallback traffic. A non-unified
    # role requires kv_remote_url (the handoff rides the offload store).
    role: str = "unified"
    # --- KV offload (the LMCache env names of the reference's chart) ---
    kv_offload_cpu: bool = field(
        default_factory=lambda: os.environ.get(
            "LMCACHE_LOCAL_CPU", "").lower() == "true")
    kv_offload_max_cpu_gb: float = field(
        default_factory=lambda: float(
            os.environ.get("LMCACHE_MAX_LOCAL_CPU_SIZE", "0") or 0))
    kv_remote_url: Optional[str] = field(
        default_factory=lambda: os.environ.get("LMCACHE_REMOTE_URL") or None)
    kv_remote_serde: str = field(
        default_factory=lambda: os.environ.get("LMCACHE_REMOTE_SERDE",
                                               "naive"))
    # Restore-over-recompute admission (kv_offload/manager.py): restore a
    # tier-resident prefix when its estimated transfer time (bytes / link
    # rate) beats its estimated prefill time (tokens / prefill rate).
    # Coarse knobs with the reference's defaults, not measurements.
    kv_restore_link_gbps: float = field(
        default_factory=lambda: float(
            os.environ.get("PSTPU_KV_RESTORE_LINK_GBPS", "2.0")))
    kv_restore_prefill_tok_s: float = field(
        default_factory=lambda: float(
            os.environ.get("PSTPU_KV_RESTORE_PREFILL_TOK_S", "4000")))
    # --- speculative decoding (the reference's fields and defaults) ---
    # Draft-ahead tokens N per verify: each cycle of the speculative decode
    # train runs the DRAFT model N+1 single-token steps, scores the chunk
    # with ONE target forward, and accepts the longest prefix of proposals
    # equal to the target's own (seeded) samples, so spec-on output is
    # token-identical to spec-off, greedy and seeded. 0 disables.
    speculative_num_tokens: int = 0
    # The draft (a named config; the target itself for a self-draft). It
    # must share the target's vocabulary. Its KV lives in per-sequence
    # rings in the compute dtype, outside the paged pool.
    speculative_model: Optional[str] = None
    # Draft KV ring length in tokens per sequence (0 = max_model_len).
    speculative_draft_window: int = 1024
    # Per-sequence draft depth gamma in [0, N] from an acceptance EMA
    # (runner.SpecGammaController); a dispatch whose rows all sit at
    # gamma 0 runs the plain decode train.
    speculative_adaptive: bool = False
    # Token-tree width W: W alternatives at the first speculated position,
    # verified in the same target forward under a tree attention bias
    # (ops/tree_mask.py). 1 = linear speculation.
    speculative_tree_width: int = 1
    # The adaptive controller's shape: the newest observation's weight,
    # the expected-value floor (gamma = largest g with ema^g >= it), and
    # the re-probe period of a gamma-0 row (0: never).
    speculative_ema_decay: float = 0.35
    speculative_gamma_threshold: float = 0.5
    speculative_probe_period: int = 16
    # --- LoRA (vLLM --lora-modules convention: name -> PEFT checkpoint dir)
    lora_modules: Dict[str, str] = field(default_factory=dict)
    # --- weights ---
    # "auto" / "safetensors": a local HF checkpoint directory (``model``, or
    # the speculative draft) is loaded (models/weights.py:load_hf_params);
    # "dummy", or a named config: random weights from ``seed``.
    load_format: str = "auto"               # "auto" | "safetensors" | "dummy"
    seed: int = 0
    served_model_name: Optional[str] = None
    # Peak HBM bandwidth (GB/s) of one card, the ceiling of the live
    # roofline gauge (pstpu:live_hbm_bw_pct); None: looked up from the
    # card's name (perf/roofline.py), 0 when the card is not in the table.
    hbm_peak_gbps: Optional[float] = None
    # --- observability (the reference's) ---
    # The per-request flight recorder and the /debug routes (timelines,
    # profiler captures, the port's kernel counts). Recorder appends are
    # O(1) host appends from the engine loop, so it is on by default; False
    # records nothing and every /debug route is a plain 404.
    debug_endpoints: bool = True
    # At most this many recent request timelines, each of at most
    # flight_recorder_max_events events (overflow is counted).
    flight_recorder_capacity: int = 256
    flight_recorder_max_events: int = 512

    def __post_init__(self):
        if self.decode_loop not in ("scan", "while"):
            raise ValueError(
                f"Unknown decode_loop {self.decode_loop!r} (scan or while)"
            )
        if self.pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got "
                             f"{self.pipeline_depth}")
        if self.dtype not in _ITEMSIZE:
            raise ValueError(f"Unknown dtype {self.dtype!r}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(
                f"Unknown kv_cache_dtype {self.kv_cache_dtype!r} "
                f"(supported: {', '.join(KV_CACHE_DTYPES)})"
            )
        self.validate_parallelism()
        if not self.speculative_num_tokens and (
            self.speculative_adaptive or self.speculative_tree_width > 1
        ):
            raise ValueError(
                "--speculative-adaptive/--speculative-tree-width modify the "
                "speculative decode train and require "
                "--speculative-num-tokens > 0 (plus --speculative-model)"
            )
        if self.speculative_num_tokens:
            self.resolved_draft_config()
        self.validate_kv_tier()

    @property
    def torch_device(self) -> torch.device:
        return torch.device(self.device)

    @property
    def mesh_devices(self) -> int:
        """Ranks the engine's mesh occupies (dp x sp x tp)."""
        return (self.data_parallel_size * self.sequence_parallel_size
                * self.tensor_parallel_size)

    def validate_parallelism(self) -> None:
        """The parallel degrees against the other knobs (the reference's
        ``validate_parallelism``: its checks and messages, and no other);
        raises a ValueError naming the flags at fault."""
        from production_stack_tpu_torch.models.config import (
            resolve_model_config,
        )

        tp = self.tensor_parallel_size
        sp = self.sequence_parallel_size
        dp = self.data_parallel_size
        if tp < 1 or sp < 1 or dp < 1:
            raise ValueError(
                "--tensor-parallel-size/--sequence-parallel-size/"
                "--data-parallel-size must all be >= 1, got "
                f"tp={tp} sp={sp} dp={dp}")
        if self.speculative_num_tokens and (tp > 1 or sp > 1):
            raise ValueError(_SPEC_MESH_ERROR + " Drop the speculative flags "
                             "to serve on the mesh, or serve speculatively "
                             "on one chip.")
        if tp == 1:
            return
        mc = resolve_model_config(self.model)
        if self.kv_cache_quantized and (mc.num_kv_heads % tp
                                        or mc.num_heads % tp):
            raise ValueError(
                f"--kv-cache-dtype int8 with --tensor-parallel-size "
                f"{tp} requires tp to divide the model's head counts "
                f"(the per-(slot, head) scale pools are kv-head-"
                f"sharded over the tp axis like the payload pools); "
                f"model {self.model!r} has "
                f"{mc.num_heads}/{mc.num_kv_heads} heads. Use a tp "
                f"that divides both, or --kv-cache-dtype bfloat16.")

    @property
    def kv_offload_enabled(self) -> bool:
        return bool(self.kv_offload_cpu or self.kv_remote_url)

    def validate_kv_tier(self) -> None:
        """The role and the offload tier against the other knobs."""
        from production_stack_tpu_torch.disagg.transfer import ENGINE_ROLES

        if self.role not in ENGINE_ROLES:
            raise ValueError(f"Unknown engine role {self.role!r} "
                             f"(supported: {', '.join(ENGINE_ROLES)})")
        if self.role != "unified" and not self.kv_remote_url:
            raise ValueError(
                f"engine role {self.role!r} requires kv_remote_url "
                f"(LMCACHE_REMOTE_URL / --kv-remote-url): the prefill->"
                f"decode KV handoff rides the shared offload store")

    @property
    def speculative_enabled(self) -> bool:
        return self.speculative_num_tokens > 0

    def resolved_draft_config(self):
        """The speculative draft's ModelConfig, validated against this
        engine's target (the reference's ``resolved_draft_config``, its
        refusals and messages); raises ValueError on every pairing the
        draft/verify train cannot serve."""
        from production_stack_tpu_torch.models.config import (
            resolve_model_config,
        )

        n = self.speculative_num_tokens
        if n < 0 or n > 16:
            raise ValueError(
                f"--speculative-num-tokens must be in [0, 16], got {n}"
            )
        if not self.speculative_model:
            raise ValueError(
                "--speculative-num-tokens > 0 requires --speculative-model "
                "(the draft; e.g. facebook/opt-125m, or the target model "
                "itself for a self-draft parity configuration)"
            )
        if self.kv_cache_quantized:
            raise ValueError(
                "speculative decoding requires --kv-cache-dtype bfloat16: "
                "the batched verify step attends the in-chunk draft KV "
                "unquantized, so int8 pools would break the spec-on == "
                "spec-off token-identity bar (draft KV is always kept in "
                "the compute dtype)"
            )
        if self.tensor_parallel_size > 1 or self.sequence_parallel_size > 1:
            raise ValueError(_SPEC_MESH_ERROR)
        w = self.speculative_tree_width
        if w < 1 or w > 8:
            raise ValueError(
                f"--speculative-tree-width must be in [1, 8], got {w} "
                f"(width 1 is linear speculation; wider trees multiply "
                f"verify-chunk FLOPs with sharply diminishing acceptance "
                f"returns past the first few alternatives)"
            )
        if not 0.0 < self.speculative_ema_decay <= 1.0:
            raise ValueError(
                f"speculative_ema_decay must be in (0, 1], got "
                f"{self.speculative_ema_decay}"
            )
        if self.speculative_gamma_threshold <= 0.0:
            raise ValueError(
                f"speculative_gamma_threshold must be > 0, got "
                f"{self.speculative_gamma_threshold} (values > 1 pin every "
                f"row to gamma=0 — the spec-off-degradation test "
                f"configuration)"
            )
        if self.speculative_probe_period < 0:
            raise ValueError(
                f"speculative_probe_period must be >= 0, got "
                f"{self.speculative_probe_period}"
            )
        target = resolve_model_config(self.model)
        draft = resolve_model_config(self.speculative_model)
        if draft.vocab_size != target.vocab_size:
            raise ValueError(
                f"speculative draft {self.speculative_model!r} is tokenizer-"
                f"incompatible with target {self.model!r}: draft vocab "
                f"{draft.vocab_size} != target vocab {target.vocab_size} "
                f"(draft proposals are accepted by token id, so the two "
                f"models must share one tokenizer/vocabulary)"
            )
        return draft

    @property
    def speculative_ring_len(self) -> int:
        """Draft KV ring length in tokens (0 = track the full context)."""
        w = self.speculative_draft_window
        if w <= 0:
            return self.max_model_len
        return min(w, self.max_model_len)

    def resolved_attn_impl(self, model_config) -> str:
        """Resolve the decode attention implementation for ``model_config``
        (see the attn_impl field comment). Speculation runs on the window
        path: ``auto`` resolves to it and ``paged`` is an error, as in the
        reference (which departs from its own default the same way)."""
        on_cuda = self.torch_device.type == "cuda"
        # tp > 1: each rank runs the kernel over its own kv heads
        # (paged_flash_decode_stats_tp), exact only when tp divides both
        # head counts.
        tp = self.tensor_parallel_size
        tp_ok = (model_config.num_heads % tp == 0
                 and model_config.num_kv_heads % tp == 0)
        # The kernels take every compute dtype and pool kind on the
        # shapes the reference's gate admits; the CPU runs their plain
        # version.
        supported = (
            model_config.arch == "llama"
            and supports_paged_decode(model_config.head_dim_, self.block_size)
            and tp_ok
        )
        # The reference's legacy names: "xla" is the window path, "pallas"
        # the paged kernel.
        v = {"xla": "window", "pallas": "paged"}.get(self.attn_impl,
                                                      self.attn_impl)
        if self.speculative_enabled and v == "paged":
            raise ValueError(
                "speculative decoding requires the window attention path "
                "(the paged flash-decode kernel serves single-token "
                "queries; the batched verify step is a multi-token chunk) "
                "— drop attn_impl=paged or --speculative-num-tokens"
            )
        if v == "window" or (self.speculative_enabled and v == "auto"):
            return "window"
        if v == "paged":
            if not supported:
                raise ValueError(
                    f"attn_impl={v!r} requires a llama-family model whose "
                    f"head_dim divides or is a multiple of 128 (lane "
                    f"packing), with block_size dividing the superpage and "
                    f"divisible by the pack factor, and (for tp>1) head "
                    f"counts divisible by tensor_parallel_size; got "
                    f"arch={model_config.arch} "
                    f"head_dim={model_config.head_dim_} "
                    f"block_size={self.block_size} "
                    f"heads={model_config.num_heads}/"
                    f"{model_config.num_kv_heads} tp={tp}"
                )
            return "paged"
        if v != "auto":
            raise ValueError(f"Unknown attn_impl {v!r}")
        return "paged" if supported and on_cuda else "window"

    def _kv_bytes_per_token(self, model_config, heads: int) -> int:
        """K + V payload bytes of one token over all layers and ``heads``
        kv heads, in the pool's storage dtype, plus the per-(slot, head)
        scale when quantized."""
        if self.kv_cache_quantized:
            per_slot = model_config.head_dim_ + SCALE_ITEMSIZE
        else:
            per_slot = model_config.head_dim_ * _ITEMSIZE[self.dtype]
        return 2 * model_config.num_layers * heads * per_slot

    def kv_cache_bytes_per_token(self, model_config) -> int:
        """Pool bytes one token occupies across all layers ON ONE RANK (its
        kv heads: Hkv / tp, or all Hkv where tp does not divide them)."""
        return self._kv_bytes_per_token(model_config,
                                        self.local_kv_heads(model_config))

    def kv_wire_bytes_per_token(self, model_config) -> int:
        """Bytes one token's KV takes in a blob of whole logical blocks
        (every kv head, whatever the mesh): what crosses the link when the
        offload tier restores it, and the reference's
        ``kv_cache_bytes_per_token``."""
        return self._kv_bytes_per_token(model_config, model_config.num_kv_heads)

    def window_bytes_per_block(self, model_config) -> int:
        """Bytes of one block of a gathered window on one rank: windows
        hold the DEQUANTIZED K/V, so they cost compute-dtype bytes at any
        storage dtype."""
        return (
            2 * model_config.num_layers * self.block_size
            * self.local_kv_heads(model_config) * model_config.head_dim_
            * _ITEMSIZE[self.dtype]
        )

    def local_kv_heads(self, model_config) -> int:
        """KV heads each tp rank's pool holds: Hkv / tp, or every kv head
        where tp does not divide Hkv (the replicated pool)."""
        from production_stack_tpu_torch.parallel.sharding import kv_heads_split

        tp = self.tensor_parallel_size
        hkv = model_config.num_kv_heads
        return hkv // tp if kv_heads_split(hkv, tp) else hkv

    def kv_cache_bytes_per_block(self, model_config) -> int:
        return self.block_size * self.kv_cache_bytes_per_token(model_config)

    @property
    def kv_cache_quantized(self) -> bool:
        return self.kv_cache_dtype == "int8"

    @property
    def model_name(self) -> str:
        return self.served_model_name or self.model

    @property
    def max_blocks_per_seq(self) -> int:
        return -(-self.max_model_len // self.block_size)
