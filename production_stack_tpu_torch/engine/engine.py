"""ServingEngine: the async continuous-batching inference engine.

Counterpart of ``production_stack_tpu/engine/engine.py``. Owns the
tokenizer, the ModelRunner (device state), the BlockPoolManager (paged KV
bookkeeping + prefix cache), the Scheduler, and per-request output streams.
Device work (issue and fetch) runs on one worker thread so the asyncio
loop (HTTP serving) never blocks on the card.

The loop is the reference's two-slot pipeline (``async_pipeline``,
``pipeline_depth`` clamped to 2, ``overlap_dispatch``): each round fills the
free dispatch slots, then fetches the oldest dispatch and applies its
tokens. Scheduler state advances at issue; a decode issued before its rows'
previous tokens reach the host chains them on the device. With overlap, a
round may hold a prefill and a decode at once. Aborts are applied by the
loop between rounds; a block freed under an in-flight dispatch is reused
only by a later dispatch, which runs after it on the one compute stream.
``async_pipeline=False`` is the strict issue -> fetch -> apply loop, and
so is a speculative engine's loop (``speculative_num_tokens`` > 0: a
dispatch emits a variable number of tokens, the scheduler reconciles each
row's position at apply, and a finished row's draft-ring slot is
released).
The loop keeps the reference's request-latency, lifecycle and per-train
dispatch-duration histograms and a rolling window of dispatches, from
which ``stats()`` derives the live throughput and roofline gauges
(``_live_perf``). A request may carry logprobs (computed on the device, see
runner.py) and resume an interrupted stream (``generate(resume_tokens=,
resume_seed=)``).

Observability (the reference's): with ``debug_endpoints`` a
``FlightRecorder`` (``engine/flight_recorder.py``) keeps each recent
request's timeline, appended at enqueue and resume, at each dispatch's
issue (``_record_issue``, anchored before the runner's issue call so the
phases tile the request) and fetch (``_record_fetch``, with the batch's
speculative acceptance), at preemption, restore, handoff and finish. Every
hook is an O(rows) host append on the loop thread and reads no device
value. ``stats()["trace_spans_dropped_total"]`` reads the tracer
(``tracing.py``). ``embed`` serves /v1/embeddings and /rerank: mean-pooled,
L2-normalised trunk states, computed on the worker thread between
dispatches without touching the KV pool (``runner.embed``).

LoRA (the reference's): the adapters of ``lora_modules`` are loaded into a
``LoRARegistry`` at start, and ``generate(lora_adapter=name)`` serves the
base model plus that adapter; a request's prefix-cache chain is seeded with
the adapter's name (``Sequence.hash_seed``), on the device and in the
offload tiers.

The KV tier (the reference's): with ``kv_offload_cpu`` or
``kv_remote_url`` a ``KVOffloadManager`` spills every block that fills
and restores tier-resident prefixes at admission; ``prewarm`` pulls the
shared tier's hot chains into the device prefix cache between steps. A
role-split engine has a ``DisaggCoordinator``: a prefill hop
(``generate(handoff_key=)``) publishes its KV and first token and finishes
with reason "handoff"; a decode hop (``generate(handoff_state=)``) writes
the manifest's blocks into this pool between steps and continues the
stream with no recompute. Block reads and writes run on the dispatch
stream (runner.py), so they are ordered with the dispatches.

On a mesh (``data_parallel_size`` x ``sequence_parallel_size`` x
``tensor_parallel_size`` > 1 ranks) this process is rank 0: the engine
starts ranks 1..world-1 as worker processes (``parallel/worker.py``)
before building its runner, and stops and joins them at ``stop``. Prefill
and decode run eagerly (no graph is captured). The KV tier works at any
mesh: block reads and writes move whole logical blocks (every kv head,
gathered to or scattered from rank 0), so a blob spilled or handed off on
one mesh restores on another and in the JAX package, and the restore cost
model counts the whole block's bytes. A lost rank (a worker that exited,
or a collective that failed or timed out, a block exchange's included)
makes the engine unhealthy; its requests, and every later one, raise.
"""

import asyncio
import contextlib
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field, replace
from typing import AsyncIterator, Dict, List, Optional, Set

import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.flight_recorder import FlightRecorder
from production_stack_tpu_torch.engine.kv_cache import BlockPoolManager
from production_stack_tpu_torch.engine.metrics import (
    DispatchDurationHistograms,
    LifecycleHistograms,
    RequestLatencyHistograms,
)
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.engine.scheduler import (
    Scheduler,
    Sequence,
    SequenceStatus,
)
from production_stack_tpu_torch.engine.tokenizer import (
    IncrementalDetokenizer,
    get_tokenizer,
)
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.lora import load_registry
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.parallel import worker
from production_stack_tpu_torch.parallel.mesh import RankMesh
from production_stack_tpu_torch.perf.roofline import (
    peak_gbps_for,
    roofline_components,
)
from production_stack_tpu_torch.tracing import spans_dropped_total
from production_stack_tpu_torch.utils import init_logger, random_uuid, resolve_device

logger = init_logger(__name__)


@dataclass
class RequestOutput:
    request_id: str
    text_delta: str = ""
    token_ids: List[int] = field(default_factory=list)
    finished: bool = False
    finish_reason: Optional[str] = None
    num_prompt_tokens: int = 0
    num_output_tokens: int = 0
    num_cached_tokens: int = 0
    # When sampling.logprobs is set: one (chosen logprob, [(token id,
    # logprob), ...]) per output token, aligned with token_ids (None for
    # tokens a resume pre-seeded); None otherwise.
    logprobs: Optional[List] = None


@dataclass
class _StreamState:
    queue: asyncio.Queue
    detok: IncrementalDetokenizer
    text: str = ""   # decoded output, already truncated at any stop match
    sent: int = 0    # chars delivered to the client so far


class ServingEngine:
    def __init__(self, config: EngineConfig, params: Optional[Dict] = None,
                 num_kv_blocks: Optional[int] = None,
                 draft_params: Optional[Dict] = None):
        self._startup_t0 = time.monotonic()
        self.startup_total_seconds = 0.0
        self.startup_warmup_seconds = 0.0
        self.config = config
        self.model_config = resolve_model_config(config.model)
        self.tokenizer = get_tokenizer(config.model, self.model_config)
        # The rank mesh (None on one rank) and every rank's final report.
        self.mesh: Optional[RankMesh] = None
        self.tp_reports: Optional[List[Dict]] = None  # every rank's, at stop
        self._tp_error: Optional[str] = None
        if config.mesh_devices > 1:
            device = resolve_device(config.device)
            if device.type == "cuda" and \
                    config.resolved_attn_impl(self.model_config) == "paged":
                pa.build_kernels()  # once, before the workers load it
            self.mesh = RankMesh.launch(
                config.data_parallel_size, config.sequence_parallel_size,
                config.tensor_parallel_size, device, config.tp_timeout_s,
                lambda rank, port: worker.argv(
                    config, rank, port, broadcast_params=params is not None,
                    broadcast_draft_params=draft_params is not None,
                    num_kv_blocks=num_kv_blocks))
        try:
            self.lora_registry = load_registry(config.lora_modules,
                                               self.model_config)
            self.runner = ModelRunner(
                config, self.model_config, params=params,
                num_kv_blocks=num_kv_blocks, mesh=self.mesh,
                draft_params=draft_params, lora_registry=self.lora_registry,
            )
        except BaseException:
            if self.mesh is not None:
                self.mesh.error = self.mesh.error or "runner failed to start"
                self.mesh.close()
            raise
        self.block_manager = BlockPoolManager(
            self.runner.num_kv_blocks, config.block_size,
            config.enable_prefix_caching,
        )
        self.offload = None
        if config.kv_offload_enabled:
            from production_stack_tpu_torch.kv_offload.manager import (
                KVOffloadManager,
            )

            gb = config.kv_offload_max_cpu_gb or 4.0
            self.offload = KVOffloadManager(
                self.runner, self.block_manager,
                host_pool_bytes=(int(gb * (1 << 30))
                                 if config.kv_offload_cpu else 0),
                remote_url=config.kv_remote_url,
                serde=config.kv_remote_serde,
                # A restored blob holds every kv head: the link moves the
                # whole block at any tp.
                bytes_per_token=config.kv_wire_bytes_per_token(
                    self.model_config),
                link_gbps=config.kv_restore_link_gbps,
                prefill_tok_s=config.kv_restore_prefill_tok_s,
            )
        self.disagg = None
        if config.role != "unified":
            from production_stack_tpu_torch.disagg import DisaggCoordinator

            self.disagg = DisaggCoordinator(config, self.runner,
                                            self.block_manager)
        self.scheduler = Scheduler(
            config, self.block_manager, offload=self.offload,
            decode_window_budget=self.runner.decode_window_blocks,
            prefill_window_budget=self.runner.prefill_window_blocks,
        )
        self.scheduler.on_restore = self._on_restore
        self.scheduler.on_preempt = self._on_preempt
        # The per-request flight recorder; None without the debug surface.
        self.recorder = (FlightRecorder(
            capacity=config.flight_recorder_capacity,
            max_events=config.flight_recorder_max_events)
            if config.debug_endpoints else None)
        self._step_counter = 0
        self._streams: Dict[str, _StreamState] = {}
        self._pending_aborts: Set[str] = set()
        self._new_work = asyncio.Event()
        self._loop_task: Optional[asyncio.Task] = None
        self._running = False
        # One worker thread: every device call of the runner comes from it.
        self._executor = ThreadPoolExecutor(max_workers=1,
                                            thread_name_prefix="runner")
        # Decode-hop restores (Sequence, HandoffManifest) and POST /prewarm
        # pulls (request, future) wait for the loop, which applies them
        # between dispatches; publishes in flight are awaited at loop exit.
        self._pending_restores: List = []
        self._pending_prewarms: List = []
        self._publish_tasks: Set = set()
        self.startup_prewarm_seconds = 0.0
        self.prewarmed_blocks_total = 0
        self.start_time = time.monotonic()
        self.prompt_tokens_total = 0
        self.generation_tokens_total = 0
        # Dispatch-pipeline telemetry (the reference's names): dispatches
        # per kind, fetches, fetches that ran with another dispatch still
        # outstanding (overlap), and the host-observed time during which
        # nothing was outstanding between two dispatches (bubbles).
        self.decode_dispatches_total = 0
        self.prefill_dispatches_total = 0
        self.fetches_total = 0
        self.overlapped_fetches_total = 0
        self.dispatch_gap_seconds_total = 0.0
        self.host_stall_seconds_total = 0.0
        self._last_fetch_done: Optional[float] = None
        # Rolling window of (fetch done, issue-to-fetch seconds, tokens
        # accepted, decode row-steps) per dispatch: the live gauges.
        self._dispatch_window: deque = deque(maxlen=256)
        self.histograms = RequestLatencyHistograms()
        self.lifecycle = LifecycleHistograms()
        self.dispatch_hists = DispatchDurationHistograms()
        self._ttft_recorded: Set[str] = set()
        # Prompt + resume tokens a resumed request found in the prefix
        # cache instead of recomputing.
        self.resume_restored_tokens_total = 0
        self.hbm_peak_gbps = config.hbm_peak_gbps
        if self.hbm_peak_gbps is None:
            dev = self.runner.device
            name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else None
            self.hbm_peak_gbps = peak_gbps_for(name)
            if self.hbm_peak_gbps is None:
                logger.warning("no HBM peak known for device %r and no "
                               "--hbm-peak-gbps: pstpu:live_hbm_bw_pct reads 0",
                               name or str(dev))

    # --------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        if self._running:
            return
        if self.mesh is not None and self.tp_reports is not None:
            raise RuntimeError("a stopped engine on a mesh cannot start "
                               "again: its worker ranks have exited")
        self._new_work = asyncio.Event()
        if self.config.enable_warmup:
            t0 = time.monotonic()
            await asyncio.get_running_loop().run_in_executor(
                self._executor, self.runner.warmup)
            self.startup_warmup_seconds += time.monotonic() - t0
        if not self.startup_total_seconds:
            self.startup_total_seconds = time.monotonic() - self._startup_t0
        self._running = True
        self._loop_task = asyncio.create_task(self._run_loop())
        logger.info(
            "Engine started: model=%s kv_blocks=%d block_size=%d attn=%s "
            "device=%s dp=%d sp=%d tp=%d", self.config.model_name,
            self.runner.num_kv_blocks, self.config.block_size,
            self.runner.attn_impl, self.runner.device,
            self.config.data_parallel_size,
            self.config.sequence_parallel_size,
            self.config.tensor_parallel_size,
        )
        if self.mesh is not None:
            logger.info("a mesh of %d ranks over %s: prefill and decode run "
                        "eagerly (no CUDA graph family is captured)",
                        self.mesh.size, self.mesh.backend)

    async def stop(self) -> None:
        """Stop the engine loop and the KV tier's thread and connections;
        on a mesh also end the worker ranks (their final reports land in
        ``tp_reports``) and join them."""
        self._running = False
        self._new_work.set()
        if self._loop_task:
            await self._loop_task
            self._loop_task = None
        if self.offload is not None:
            self.offload.close()
        if self.disagg is not None:
            self.disagg.close()
        if self.mesh is not None and self.tp_reports is None:
            await asyncio.get_running_loop().run_in_executor(
                self._executor, self._stop_ranks)

    def _stop_ranks(self) -> None:
        try:
            if self._lost() is None:
                self.tp_reports = self.runner.tp_stop()
        except Exception as e:  # noqa: BLE001 — the ranks are lost
            self._tp_error = f"stopping the worker ranks failed: {e}"
            logger.error("%s", self._tp_error)
        finally:
            if self.tp_reports is None:
                self.tp_reports = []
            self.mesh.close()

    def shutdown(self) -> None:
        """Release the worker threads and the KV tier's (after ``stop``, or
        for an engine never started); end the worker ranks if ``stop`` did
        not."""
        if self.mesh is not None and self.tp_reports is None:
            self._executor.submit(self._stop_ranks).result()
        self._executor.shutdown(wait=True)
        if self.offload is not None:
            self.offload.close()
        if self.disagg is not None:
            self.disagg.close()

    def _lost(self) -> Optional[str]:
        """Why the mesh is lost, or None (always None on one rank)."""
        if self.mesh is None:
            return None
        self._tp_error = self._tp_error or self.mesh.lost()
        return self._tp_error

    @property
    def is_healthy(self) -> bool:
        return self._running and (
            self._loop_task is not None and not self._loop_task.done()
        ) and self._lost() is None

    def active_request_ids(self) -> List[str]:
        """Request ids with a live output stream (drain aborts these)."""
        return list(self._streams)

    @property
    def offload_blocks_resident(self) -> int:
        """KV blocks resident in the host offload pool
        (pstpu:kv_offload_blocks)."""
        if self.offload is None or self.offload.host_pool is None:
            return 0
        return self.offload.host_pool.stats()["entries"]

    def _on_preempt(self, request_id: str) -> None:
        if self.recorder is not None:
            self.recorder.event(request_id, "preempt")

    def _on_restore(self, request_id: str, tokens: int,
                    seconds: float) -> None:
        self.lifecycle.restore_round_trip.observe(seconds)
        if self.recorder is not None:
            self.recorder.event(request_id, "restore", {
                "tokens": tokens, "seconds": round(seconds, 6)})

    async def rank_reports(self, reset: bool = False,
                           pool_digest: bool = False) -> List[Dict]:
        """Every rank's report (``ModelRunner.tp_query``), taken between
        dispatches on the runner thread; ``reset`` zeroes each rank's
        launch counts, token digest, ring counts and peak-memory mark
        afterwards; ``pool_digest`` adds each rank's pool digest."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self.runner.tp_query, reset, pool_digest)

    # ----------------------------------------------------------------- intake
    async def generate(
        self,
        prompt: Optional[str] = None,
        prompt_token_ids: Optional[List[int]] = None,
        sampling: Optional[SamplingParams] = None,
        request_id: Optional[str] = None,
        resume_tokens: Optional[List[int]] = None,
        resume_seed: Optional[int] = None,
        handoff_key: Optional[str] = None,
        handoff_state=None,
        disagg_fallback: bool = False,
        lora_adapter: Optional[str] = None,
    ) -> AsyncIterator[RequestOutput]:
        """Submit a request; yields streaming RequestOutput deltas.

        Mid-stream resume (the reference's rules): ``resume_tokens`` are
        output tokens an earlier engine produced and delivered before its
        stream broke. The request prefills prompt + resume_tokens (the
        prefix cache serves what it holds) and decodes on at generation
        index len(resume_tokens); ``resume_seed``, the earlier engine's
        resolved seed base, replaces the seed, so the continuation is the
        uninterrupted stream's. Its text starts where the delivered text
        stopped. Resuming a finished stream (resume_tokens as long as
        max_tokens) is refused.

        Disagg hops: ``handoff_key`` makes this the prefill hop (prefill,
        sample token 1, publish KV and chain state under the key, finish
        with reason "handoff"); ``handoff_state`` (a HandoffManifest) makes
        it the decode hop (write the published blocks into this pool and
        continue from token 1). ``disagg_fallback`` marks router-flagged
        degrade-to-unified traffic, which a role-split engine serves end
        to end. ``lora_adapter`` selects a registered adapter by name (None
        = base); an unknown name raises KeyError."""
        request_id = request_id or random_uuid("req-")
        sampling = sampling or SamplingParams()
        if self._lost() is not None:
            raise RuntimeError(f"engine unavailable: {self._tp_error}")
        if (handoff_key or handoff_state is not None) and self.disagg is None:
            raise ValueError("disagg handoff requested but this engine has "
                             "no coordinator (--role unified)")
        if (handoff_key or handoff_state is not None) and lora_adapter:
            raise ValueError("disagg handoff does not support LoRA adapters")
        if resume_tokens:
            if handoff_key or handoff_state is not None:
                raise ValueError("resume_tokens cannot be combined with a "
                                 "disagg handoff")
            if len(resume_tokens) >= sampling.max_tokens:
                raise ValueError(
                    f"resume_tokens ({len(resume_tokens)}) must be shorter "
                    f"than max_tokens ({sampling.max_tokens})")
            if resume_seed is not None:
                sampling = replace(sampling, seed=int(resume_seed))
        if handoff_state is not None:
            async for out in self._generate_from_handoff(
                    handoff_state, sampling, request_id):
                yield out
            return
        if prompt_token_ids is None:
            assert prompt is not None
            prompt_token_ids = self.tokenizer.encode(prompt)
        if not prompt_token_ids:
            prompt_token_ids = [self.tokenizer.eos_token_id or 0]
        adapter_idx = 0
        if lora_adapter is not None:
            if self.lora_registry is None:
                raise ValueError("no LoRA adapters are registered")
            adapter_idx = self.lora_registry.adapter_index(lora_adapter)
        seq = Sequence(
            request_id=request_id,
            prompt_token_ids=list(prompt_token_ids),
            sampling=sampling,
            eos_token_id=self.tokenizer.eos_token_id,
            adapter_idx=adapter_idx,
            adapter_name=lora_adapter if adapter_idx else None,
            handoff_key=handoff_key,
            # A resumed request is served end to end on any role.
            disagg_fallback=disagg_fallback or bool(resume_tokens),
        )
        state = _StreamState(
            queue=asyncio.Queue(), detok=IncrementalDetokenizer(self.tokenizer)
        )
        if resume_tokens:
            # The delivered tokens, pre-seeded as output (they were checked
            # for EOS and stops upstream), and the emission state the
            # earlier engine had: text and the emitted boundary are
            # functions of the token list, so the first delta starts
            # exactly where the delivered text stopped.
            seq.output_token_ids = list(resume_tokens)
            seq.resume_base = len(resume_tokens)
            if sampling.logprobs is not None:
                seq.output_logprobs = [None] * len(resume_tokens)
            pre = state.detok.step(list(resume_tokens))
            state.text = pre
            hold = max(len(s) for s in sampling.stop) - 1 \
                if sampling.stop else 0
            state.sent = max(len(pre) - hold, 0)
        self.scheduler.add_sequence(seq)
        self._streams[request_id] = state
        if self.recorder is not None:
            self.recorder.start(request_id,
                                prompt_tokens=len(prompt_token_ids))
            self.recorder.event(request_id, "enqueue", {
                "prompt_tokens": len(prompt_token_ids)})
            if resume_tokens:
                self.recorder.event(request_id, "resume", {
                    "resume_tokens": len(resume_tokens)})
        self.prompt_tokens_total += len(prompt_token_ids)
        self._new_work.set()
        async with contextlib.aclosing(self._outputs(seq, state)) as outs:
            async for out in outs:
                yield out

    async def _outputs(self, seq: Sequence, state: _StreamState
                       ) -> AsyncIterator[RequestOutput]:
        """A request's output stream until it finishes; a consumer that
        stops early aborts the request (callers close it at once, with
        ``contextlib.aclosing``)."""
        try:
            while True:
                out = await state.queue.get()
                if isinstance(out, Exception):
                    raise out
                yield out
                if out.finished:
                    break
        finally:
            self._streams.pop(seq.request_id, None)
            if not seq.status.is_finished:
                self.abort(seq.request_id)

    async def _generate_from_handoff(
        self, mani, sampling: SamplingParams, request_id: str
    ) -> AsyncIterator[RequestOutput]:
        """Decode hop: continue a stream from a consumed transfer bundle.
        A finished bundle (the prefill engine hit EOS, max_tokens or a stop
        at token 1) replays the recorded result; a live one queues a
        restore the loop applies between dispatches. Token counters are
        not bumped: the prefill engine counted this request."""
        if mani.finish_reason is not None:
            yield RequestOutput(
                request_id=request_id,
                text_delta=mani.final_text or "",
                token_ids=list(mani.output_token_ids),
                finished=True,
                finish_reason=mani.finish_reason,
                num_prompt_tokens=len(mani.prompt_token_ids),
                num_output_tokens=len(mani.output_token_ids),
                num_cached_tokens=mani.num_computed_tokens,
                logprobs=(list(mani.output_logprobs)
                          if sampling.logprobs is not None
                          and mani.output_logprobs is not None else None),
            )
            return
        cfg = self.config
        if mani.block_size != cfg.block_size:
            raise ValueError(
                f"handoff block_size {mani.block_size} != engine block_size "
                f"{cfg.block_size} (pools must share the KV layout)")
        if mani.kv_cache_dtype != cfg.kv_cache_dtype:
            raise ValueError(
                f"handoff kv_cache_dtype {mani.kv_cache_dtype!r} != engine "
                f"kv_cache_dtype {cfg.kv_cache_dtype!r} (role-split pools "
                f"must share --kv-cache-dtype)")
        need = mani.num_blocks
        if (need > self.block_manager.num_blocks - 1
                or len(mani.prompt_token_ids) >= cfg.max_model_len):
            raise ValueError(
                "handoff bundle exceeds this engine's KV pool / max_model_len")
        if need * cfg.block_size < mani.num_computed_tokens:
            raise ValueError("handoff bundle is missing KV blocks")
        seq = Sequence(
            request_id=request_id,
            prompt_token_ids=list(mani.prompt_token_ids),
            sampling=sampling,
            eos_token_id=self.tokenizer.eos_token_id,
            # The lease is consumed: if preempted, recompute here is the
            # row's only path, so the decode-role prefill gate admits it.
            disagg_fallback=True,
        )
        state = _StreamState(
            queue=asyncio.Queue(), detok=IncrementalDetokenizer(self.tokenizer)
        )
        self._streams[request_id] = state
        # Registered before the restore applies: an abort while queued
        # finds it.
        self.scheduler.seqs[request_id] = seq
        if self.recorder is not None:
            self.recorder.start(request_id,
                                prompt_tokens=len(mani.prompt_token_ids))
            self.recorder.event(request_id, "enqueue", {
                "prompt_tokens": len(mani.prompt_token_ids),
                "disagg_decode_hop": True})
        self._pending_restores.append((seq, mani))
        self._new_work.set()
        async with contextlib.aclosing(self._outputs(seq, state)) as outs:
            async for out in outs:
                yield out

    # ----------------------------------------------------------- prewarm
    async def prewarm(self, top_k: int = 8, max_blocks: int = 256) -> dict:
        """Pull the shared tier's hottest prefix chains into the device
        prefix cache (POST /prewarm). Queued for the loop, which applies it
        between dispatches; resolves with the pull's telemetry, a no-op
        result (never an exception) without a shared tier."""
        if self.offload is None or self.offload.remote is None:
            return {"chains": 0, "blocks": 0,
                    "reason": "no shared tier configured (LMCACHE_REMOTE_URL"
                              " / --kv-remote-url)"}
        if not self._running:
            return {"chains": 0, "blocks": 0, "reason": "engine not running"}
        fut = asyncio.get_running_loop().create_future()
        self._pending_prewarms.append(
            ({"top_k": int(top_k), "max_blocks": int(max_blocks)}, fut))
        self._new_work.set()
        return await fut

    async def _apply_prewarms(self) -> None:
        """Serve queued prewarm pulls between dispatches (the store fetch
        and the block writes run on the runner thread; no dispatch is
        issued meanwhile)."""
        loop = asyncio.get_running_loop()
        pending, self._pending_prewarms = self._pending_prewarms, []
        for req, fut in pending:
            t0 = time.monotonic()
            try:
                res = await loop.run_in_executor(
                    self._executor, self.offload.prewarm_hot_chains,
                    req["top_k"], req["max_blocks"])
            except Exception as e:  # noqa: BLE001 — the loop must survive
                logger.exception("Prewarm pull failed")
                res = {"chains": 0, "blocks": 0,
                       "reason": f"prewarm failed: {e}"}
            res["seconds"] = round(time.monotonic() - t0, 4)
            self.startup_prewarm_seconds += res["seconds"]
            self.prewarmed_blocks_total += res.get("blocks", 0)
            if not fut.done():
                fut.set_result(res)

    # --------------------------------------------------- disagg handoff plane
    async def _apply_restores(self) -> None:
        """Write queued decode-hop bundles into the pool, between
        dispatches: blocks are allocated, the manifest's KV written (on the
        runner thread; the loop awaits it, so the next dispatch is enqueued
        after it), the sampled tokens replayed through the normal append
        path, and the row joins RUNNING. A pool too full re-queues the
        restore; a failed restore aborts only its own request."""
        loop = asyncio.get_running_loop()
        pending, self._pending_restores = self._pending_restores, []
        leftover = []
        for seq, mani in pending:
            if seq.status.is_finished:
                continue  # aborted while queued
            try:
                blocks = (self.block_manager.allocate_blocks(mani.num_blocks)
                          if mani.num_blocks else [])
                if blocks is None:
                    leftover.append((seq, mani))
                    continue
                seq.block_ids = blocks
                if mani.num_blocks:
                    await loop.run_in_executor(
                        self._executor, self.runner.write_blocks, blocks,
                        mani.k, mani.v, mani.k_scale, mani.v_scale)
                seq.num_computed_tokens = mani.num_computed_tokens
                seq.num_cached_tokens = mani.num_computed_tokens
                seq.status = SequenceStatus.RUNNING
                if self.recorder is not None:
                    self.recorder.event(seq.request_id, "handoff_restore", {
                        "blocks": mani.num_blocks,
                        "tokens": mani.num_computed_tokens})
                self.scheduler.running.append(seq)
                for i, tok in enumerate(mani.output_token_ids):
                    if seq.status.is_finished:
                        break
                    lp = (mani.output_logprobs[i] if mani.output_logprobs
                          and i < len(mani.output_logprobs) else None)
                    self.scheduler._append_token(seq, tok, lp)
                # The restored full blocks join this engine's prefix cache
                # (and its offload tier).
                self.scheduler._register_full_blocks(seq)
                self._process_output(seq)
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("Handoff restore failed; aborting %s",
                                 seq.request_id)
                aborted = self.scheduler.abort(seq.request_id)
                if aborted is not None:
                    self._process_output(aborted)
        self._pending_restores.extend(leftover)

    async def _publish_handoffs(self, produced: List[Sequence]) -> None:
        """Prefill hop completion: a row that just produced its first token
        and carries a transfer key gets a background publish (block read,
        pack, store put) off the runner thread, so the dispatch pipeline
        does not wait for it. Meanwhile the row stays RUNNING but out of decode
        batches and preemption; then it finishes (FINISHED_HANDOFF, its
        blocks freed into the prefix cache) and the /disagg/prefill answer
        is emitted. A failed publish aborts the row: a prefill-role engine
        never starts decoding."""
        if self.disagg is None:
            return
        for seq in produced:
            if seq.handoff_key is None or seq.handoff_done \
                    or not seq.prefill_done:
                continue
            seq.handoff_done = True
            st = self._streams.get(seq.request_id)
            final_text = (st.text if (st is not None and seq.status.is_finished)
                          else None)
            task = asyncio.ensure_future(self._publish_one(seq, final_text))
            self._publish_tasks.add(task)
            task.add_done_callback(self._publish_tasks.discard)

    async def _publish_one(self, seq: Sequence,
                           final_text: Optional[str]) -> None:
        loop = asyncio.get_running_loop()
        try:
            ok = await loop.run_in_executor(
                None, self.disagg.publish_handoff, seq, final_text)
        except Exception:  # noqa: BLE001 — publish must fail cleanly
            logger.exception("KV handoff publish task failed")
            ok = False
        if self.recorder is not None:
            self.recorder.event(seq.request_id, "handoff_publish",
                                {"ok": ok})
        # finish and emit in one loop slice: the scheduler never sees a
        # half-finished handoff row.
        if not seq.status.is_finished:
            self.scheduler.finish(
                seq.request_id,
                SequenceStatus.FINISHED_HANDOFF if ok
                else SequenceStatus.FINISHED_ABORTED)
        self._emit_handoff_output(seq)

    def _emit_handoff_output(self, seq: Sequence) -> None:
        """The one (final) emission of a prefill-hop row: its incremental
        outputs are held back (``_process_output``), so the /disagg/prefill
        answer reflects the publish's outcome."""
        st = self._streams.get(seq.request_id)
        if st is None:
            return
        st.queue.put_nowait(RequestOutput(
            request_id=seq.request_id,
            text_delta=st.text,
            token_ids=list(seq.output_token_ids),
            finished=True,
            finish_reason=seq.finish_reason(),
            num_prompt_tokens=seq.num_prompt_tokens,
            num_output_tokens=len(seq.output_token_ids),
            num_cached_tokens=seq.num_cached_tokens,
            logprobs=(list(seq.output_logprobs)
                      if seq.sampling.logprobs is not None else None),
        ))

    async def embed(self, texts: List[str]):
        """Embed texts: (mean-pooled, L2-normalised trunk states [n, D]
        float32 numpy, prompt tokens). Each text is tokenized (an empty one
        as the EOS token) and cut to max_model_len. The forward runs on the
        worker thread, between dispatches, and touches no KV block."""
        if self._lost() is not None:
            raise RuntimeError(f"engine unavailable: {self._tp_error}")
        token_lists = [
            (self.tokenizer.encode(t) or [self.tokenizer.eos_token_id or 0])[
                :self.config.max_model_len]
            for t in texts]
        vecs = await asyncio.get_running_loop().run_in_executor(
            self._executor, self.runner.embed, token_lists)
        n_tokens = sum(len(t) for t in token_lists)
        self.prompt_tokens_total += n_tokens
        return vecs, n_tokens

    def abort(self, request_id: str) -> None:
        """Deferred abort: applied by the engine loop between dispatches."""
        self._pending_aborts.add(request_id)
        self._new_work.set()

    # ------------------------------------------------------------ engine loop
    async def _run_loop(self) -> None:
        """Two-slot pipelined dispatch loop (the reference's ``_run_loop``).

        Each iteration FILLS the free dispatch slots (issuing only enqueues
        device work) and then FETCHES the oldest dispatch, so the fetch's
        wait overlaps the newer dispatch's execution. Tokens are applied in
        issue order; rows finished or preempted since a dispatch's issue
        discard its tokens (epoch check)."""
        loop = asyncio.get_running_loop()
        cfg = self.config
        # Clamped to 2: a third outstanding decode could need start tokens
        # from two unapplied dispatches (the single-source invariant).
        depth = min(2, cfg.pipeline_depth) if cfg.async_pipeline else 1
        if cfg.speculative_num_tokens:
            # A speculative dispatch emits a variable number of tokens, so
            # the scheduler cannot advance past an unfetched one: strict
            # issue -> fetch -> apply (the reference's rule).
            depth = 1
        overlap = cfg.overlap_dispatch and depth >= 2
        in_flight: deque = deque()  # (batch, step, DispatchHandle, issue), FIFO
        r = self.runner

        def abort_batch(batch):
            for seq in batch.seqs:
                aborted = self.scheduler.abort(seq.request_id)
                if aborted is not None:
                    self._process_output(aborted)

        async def apply_oldest():
            batch, step, handle, issue_time = in_flight.popleft()
            self.fetches_total += 1
            if in_flight:
                # Another dispatch executes while this fetch waits.
                self.overlapped_fetches_total += 1
            # The speculative counters grow at fetch: their growth over
            # this fetch is this dispatch's.
            spec0 = (r.spec_accepted_tokens_total, r.spec_draft_tokens_total)
            try:
                tokens, lps = await loop.run_in_executor(self._executor,
                                                         handle.fetch)
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("Dispatch fetch failed; aborting its batch")
                abort_batch(batch)
                self._last_fetch_done = time.monotonic()
                return
            self._last_fetch_done = now = time.monotonic()
            self._record_fetch(batch, step, tokens, issue_time, now,
                               r.spec_accepted_tokens_total - spec0[0],
                               r.spec_draft_tokens_total - spec0[1])
            produced, accepted = self.scheduler.apply_results(batch, tokens,
                                                              lps)
            self.generation_tokens_total += accepted
            row_steps = (len(batch.seqs) * batch.num_steps
                         if batch.kind == "decode" else 0)
            self._dispatch_window.append(
                (now, now - issue_time, accepted, row_steps))
            for seq in produced:
                self._process_output(seq)
            await self._publish_handoffs(produced)

        def next_batch():
            if not overlap:
                return self.scheduler.schedule()
            kinds = {b.kind for b, *_ in in_flight}
            # With a prefill in flight, decode gets the free slot first
            # (its streams must not stall behind a chunk train).
            return self.scheduler.schedule(
                prefer_decode=("prefill" in kinds and "decode" not in kinds))

        while self._running:
            self._apply_pending_aborts()
            if self._pending_restores:
                await self._apply_restores()
            if self._pending_prewarms:
                await self._apply_prewarms()
            issue_failed = False
            while len(in_flight) < depth:
                try:
                    batch = next_batch()
                except Exception as e:  # noqa: BLE001 — see below
                    # Admission's restore writes blocks: at tp > 1 a lost
                    # rank fails the engine, as a failed dispatch does.
                    if self.mesh is None or self._lost() is None:
                        raise
                    self._tp_error = self._lost()
                    logger.error("tensor-parallel group lost at admission: "
                                 "%s (%s)", self._tp_error, e)
                    self._fail_all(RuntimeError(
                        f"engine unavailable: {self._tp_error}"))
                    self._running = False
                    break
                if batch is None:
                    break
                # Penalty counts are built from APPLIED tokens: drain first.
                if in_flight and any(
                        s.sampling.presence_penalty
                        or s.sampling.frequency_penalty for s in batch.seqs):
                    while in_flight:
                        await apply_oldest()
                step = self._step_counter
                self._step_counter += 1
                # Taken before the issue call: its time belongs to this
                # dispatch's phase (issue -> fetch), so the phases tile the
                # request (_record_issue).
                issue_wall, issue_mono = time.time(), time.monotonic()
                try:
                    handle = await loop.run_in_executor(
                        self._executor, self.runner.execute_async, batch)
                except Exception as e:  # noqa: BLE001 — the loop must survive
                    if self.mesh is not None:
                        # A rank is lost: every request fails, the loop
                        # ends and the engine reports unhealthy.
                        self._tp_error = self._lost() or \
                            f"mesh dispatch failed: {e}"
                        logger.error("rank mesh lost: %s", self._tp_error)
                        self._fail_all(RuntimeError(
                            f"engine unavailable: {self._tp_error}"))
                        self._running = False
                        break
                    logger.exception("Dispatch issue failed; aborting its batch")
                    abort_batch(batch)
                    issue_failed = True
                    break
                if not in_flight and self._last_fetch_done is not None:
                    self.dispatch_gap_seconds_total += (
                        time.monotonic() - self._last_fetch_done)
                    self.host_stall_seconds_total += max(
                        0.0, issue_mono - self._last_fetch_done)
                if batch.kind == "decode":
                    self.decode_dispatches_total += 1
                else:
                    self.prefill_dispatches_total += 1
                self._record_issue(batch, step, issue_wall, issue_mono)
                self.scheduler.advance_at_issue(batch)
                in_flight.append((batch, step, handle, issue_mono))
            if in_flight:
                # Applying may finish rows and free blocks, unblocking
                # admission: the next iteration schedules right after.
                await apply_oldest()
                await asyncio.sleep(0)
                continue
            if issue_failed:
                continue
            self._new_work.clear()
            if not self.scheduler.has_work() and not self._pending_restores:
                try:
                    await asyncio.wait_for(self._new_work.wait(), timeout=1.0)
                except asyncio.TimeoutError:
                    pass
            else:
                # Work exists but nothing schedulable: yield and retry.
                await asyncio.sleep(0.001)
        # Stopping: apply what is in flight, so no accepted token is lost,
        # and let publishes in flight reach the store.
        for _req, fut in self._pending_prewarms:
            if not fut.done():
                fut.set_result({"chains": 0, "blocks": 0,
                                "reason": "engine stopping"})
        self._pending_prewarms.clear()
        while in_flight:
            await apply_oldest()
        if self._publish_tasks:
            await asyncio.gather(*list(self._publish_tasks),
                                 return_exceptions=True)

    def _record_issue(self, batch, step: int, t_wall: float,
                      t_mono: float) -> None:
        """Dispatch-issue anchor (the reference's): closes each fresh row's
        queue wait (histogram and "schedule" event) and appends each row's
        issue event. ``t_wall`` / ``t_mono`` are taken before the runner's
        issue call, so the issue's own time belongs to the dispatch's phase
        and the phases tile the request. O(rows) host appends; no device
        value is read."""
        rec = self.recorder
        for idx, seq in enumerate(batch.seqs):
            if seq.first_issue_time is None:
                seq.first_issue_time = t_mono
                self.lifecycle.queue_wait.observe(t_mono - seq.arrival_time)
                if rec is not None:
                    rec.event(seq.request_id, "schedule", {
                        "wait_s": round(t_mono - seq.arrival_time, 6),
                    }, t=t_wall)
            if rec is None:
                continue
            if batch.kind == "prefill":
                rec.event(seq.request_id, "prefill_issue", {
                    "step": step, "chunk": batch.chunk_lens[idx],
                    "start": batch.chunk_starts[idx],
                }, t=t_wall)
            else:
                data = {"step": step, "rows": len(batch.seqs),
                        "k": batch.num_steps}
                if batch.spec_mode != "off":
                    data["spec_mode"] = batch.spec_mode
                rec.event(seq.request_id, "decode_issue", data, t=t_wall)

    def _record_fetch(self, batch, step: int, token_lists, issue_time: float,
                      now: float, spec_accepted_delta: int = 0,
                      spec_drafts_delta: int = 0) -> None:
        """Dispatch-fetch anchor: the dispatch's duration by train kind; a
        decode's in the lifecycle's decode-train histogram; a row's prefill
        phase when its final chunk comes back; and each row's fetch event
        (prefill: final flag and cached tokens; decode: tokens, ms and the
        batch's speculative acceptance)."""
        rec = self.recorder
        self.dispatch_hists.observe(
            "prefill" if batch.kind != "decode"
            else "decode_spec" if batch.spec_mode != "off" else "decode",
            now - issue_time)
        if batch.kind == "decode":
            self.lifecycle.decode_train.observe(now - issue_time)
        for idx, seq in enumerate(batch.seqs):
            if batch.kind != "decode":
                final = bool(batch.finals[idx]) if batch.finals else False
                if final and seq.first_issue_time is not None:
                    self.lifecycle.prefill.observe(now - seq.first_issue_time)
                if rec is not None:
                    rec.event(seq.request_id, "prefill_fetch", {
                        "step": step, "final": final,
                        "cached_tokens": seq.num_cached_tokens})
            elif rec is not None:
                data = {"step": step,
                        "tokens": (len(token_lists[idx])
                                   if idx < len(token_lists) else 0),
                        "ms": round((now - issue_time) * 1000, 2)}
                # Batch-level: a dispatch accepts for all its rows at once.
                if spec_accepted_delta:
                    data["spec_accepted_batch"] = spec_accepted_delta
                if spec_drafts_delta:
                    data["spec_drafts_batch"] = spec_drafts_delta
                rec.event(seq.request_id, "decode_fetch", data)

    def _fail_all(self, err: Exception) -> None:
        """End every open stream with ``err`` (raised by its generate())."""
        for st in self._streams.values():
            st.queue.put_nowait(err)

    def _apply_pending_aborts(self) -> None:
        while self._pending_aborts:
            rid = self._pending_aborts.pop()
            seq = self.scheduler.abort(rid)
            if seq is not None:
                self._process_output(seq)

    def _process_output(self, seq: Sequence) -> None:
        """Detokenize incrementally, apply stop-string semantics, emit the
        delta. The stop sequence itself is excluded from the output; while a
        request has stop strings, the last len(longest_stop)-1 chars are
        held back so a match split across tokens is never partially sent."""
        if seq.first_token_time is not None and \
                seq.request_id not in self._ttft_recorded:
            self._ttft_recorded.add(seq.request_id)
            self.histograms.ttft.observe(seq.first_token_time
                                         - seq.arrival_time)
        if seq.status.is_finished:
            self._ttft_recorded.discard(seq.request_id)
            if self.recorder is not None:
                # Idempotent: a stop-string finish below calls it again.
                self.recorder.finish(
                    seq.request_id, reason=seq.finish_reason(),
                    output_tokens=len(seq.output_token_ids))
            # Its draft-ring slot goes back (idempotent; no-op spec off).
            self.runner.release_spec_slot(seq.request_id)
            if seq.status is not SequenceStatus.FINISHED_ABORTED:
                self.histograms.e2e.observe(time.monotonic()
                                            - seq.arrival_time)
        st = self._streams.get(seq.request_id)
        if st is None:
            return
        if seq.resume_base and not seq._resume_counted and seq.prefill_done:
            seq._resume_counted = True
            self.resume_restored_tokens_total += seq.num_cached_tokens
        finished = seq.status.is_finished
        delta = st.detok.step(seq.output_token_ids, flush=finished)
        st.text += delta
        stops = seq.sampling.stop
        if stops and delta:
            max_stop = max(len(s) for s in stops)
            start = max(0, len(st.text) - len(delta) - max_stop)
            idx = -1
            for s in stops:
                i = st.text.find(s, start)
                if i != -1 and (idx == -1 or i < idx):
                    idx = i
            if idx != -1:
                st.text = st.text[:idx]
                # Drop sampled-past-the-stop tokens (the fused K-step decode
                # can overshoot a stop match by up to K-1 tokens): smallest
                # kept prefix by binary search, then a short linear fix-up
                # (decoded length is not strictly monotone in token count).
                toks = seq.output_token_ids
                lo, hi = 0, len(toks)
                while lo < hi:
                    mid = (lo + hi) // 2
                    if len(self.tokenizer.decode(toks[:mid])) < idx:
                        lo = mid + 1
                    else:
                        hi = mid
                while lo < len(toks) and \
                        len(self.tokenizer.decode(toks[:lo])) < idx:
                    lo += 1
                while lo > 0 and \
                        len(self.tokenizer.decode(toks[:lo - 1])) >= idx:
                    lo -= 1
                # Tokens below resume_base were counted by the engine that
                # generated them, not by this one.
                self.generation_tokens_total -= max(
                    0, len(toks) - max(lo, seq.resume_base))
                seq.output_token_ids = toks[:lo]
                if seq.output_logprobs:
                    del seq.output_logprobs[lo:]
                if finished:
                    seq.status = SequenceStatus.FINISHED_STOPPED
                else:
                    self.scheduler.finish(
                        seq.request_id, SequenceStatus.FINISHED_STOPPED
                    )
                finished = True
        if finished and self.recorder is not None:
            self.recorder.finish(seq.request_id, reason=seq.finish_reason(),
                                 output_tokens=len(seq.output_token_ids))
        if seq.handoff_key is not None:
            # A prefill-hop row emits once, after its publish
            # (_emit_handoff_output); an abort still ends its stream.
            if seq.status is SequenceStatus.FINISHED_ABORTED:
                self._emit_handoff_output(seq)
            return
        hold = 0 if finished or not stops else max(len(s) for s in stops) - 1
        emit_upto = max(len(st.text) - hold, st.sent)
        text_delta = st.text[st.sent:emit_upto]
        st.sent = emit_upto
        st.queue.put_nowait(RequestOutput(
            request_id=seq.request_id,
            text_delta=text_delta,
            token_ids=list(seq.output_token_ids),
            finished=finished,
            finish_reason=seq.finish_reason(),
            num_prompt_tokens=seq.num_prompt_tokens,
            num_output_tokens=len(seq.output_token_ids),
            num_cached_tokens=seq.num_cached_tokens,
            logprobs=(list(seq.output_logprobs)
                      if seq.sampling.logprobs is not None else None),
        ))

    def _live_perf(self) -> Dict[str, float]:
        """Live gauges from the rolling dispatch window (the reference's
        ``_live_perf``): tokens per second over the window's span (oldest
        issue to newest fetch), tokens per decode row-step, and the share
        of the decode HBM roofline at the running batch's shape. An idle
        engine, or one without a known peak, reads 0 for the share."""
        out = {"live_tok_per_s": 0.0, "live_hbm_bw_pct": 0.0,
               "live_effective_tokens_per_target_step": 0.0}
        win = list(self._dispatch_window)
        if not win:
            return out
        span = max(win[-1][0] - (win[0][0] - win[0][1]), 1e-9)
        tok_s = sum(e[2] for e in win) / span
        out["live_tok_per_s"] = tok_s
        row_steps = sum(e[3] for e in win)
        eff = 1.0
        if row_steps:
            eff = sum(e[2] for e in win if e[3]) / row_steps
            out["live_effective_tokens_per_target_step"] = eff
        if not self.hbm_peak_gbps:
            return out
        running = self.scheduler.running
        avg_ctx = (sum(s.num_tokens for s in running) / len(running)
                   if running else 1.0)
        dtype_bytes = {"bfloat16": 2.0, "float16": 2.0, "float32": 4.0}[
            self.config.dtype]
        comp = roofline_components(
            self.config.model, dtype_bytes, self.config.kv_cache_dtype,
            max(1, len(running)), avg_ctx, peak_gbs=self.hbm_peak_gbps,
            tokens_per_target_step=max(1.0, eff),
            num_chips=self.config.mesh_devices)
        out["live_hbm_bw_pct"] = 100.0 * tok_s / comp["roofline_tok_s"]
        return out

    # ------------------------------------------------------------------ stats
    def _offload_stat(self, attr: str):
        return getattr(self.offload, attr, 0) if self.offload else 0

    def stats(self) -> Dict:
        r = self.runner
        disagg = self.disagg.stats() if self.disagg is not None else {
            "kv_handoffs_total": 0,
            "kv_handoff_bytes_total": 0,
            "kv_handoff_seconds_total": 0.0,
            "kv_handoff_failures_total": 0,
        }
        return {
            "disagg_role": self.config.role,
            **disagg,
            "engine_uptime_seconds": time.monotonic() - self.start_time,
            "kv_offload_blocks": self.offload_blocks_resident,
            # The KV tier: the device prefix index, and the offload
            # manager's restore, spill and shared-tier counters (the last
            # four are the port's: the reference only logs failures).
            "prefix_index_size": self.block_manager.prefix_index_size,
            "kv_restore_saved_tokens_total": self._offload_stat(
                "restore_saved_tokens_total"),
            "kv_shared_tier_hits_total": self._offload_stat(
                "shared_tier_hits_total"),
            "kv_shared_tier_misses_total": self._offload_stat(
                "shared_tier_misses_total"),
            "kv_chain_evictions_total": self._offload_stat(
                "chain_evictions_total"),
            "kv_spilled_blocks_total": self._offload_stat(
                "spilled_blocks_total"),
            "kv_restore_declined_tokens_total": self._offload_stat(
                "restore_declined_tokens_total"),
            "kv_spill_failures_total": self._offload_stat(
                "spill_failures_total"),
            "kv_restore_failures_total": self._offload_stat(
                "restore_failures_total"),
            "startup_prewarm_seconds": self.startup_prewarm_seconds,
            "prewarmed_blocks_total": self.prewarmed_blocks_total,
            "device": str(r.device),
            "attn_impl": r.attn_impl,
            "kv_cache_dtype": self.config.kv_cache_dtype,
            "kv_pool_bytes": r.kv_pool_bytes,
            "kv_quant_bytes_saved_total": r.kv_quant_bytes_saved_total,
            "kv_num_blocks": r.num_kv_blocks,
            # A pool sized from free memory: the bytes reserved for the
            # prefill graphs' temporaries, and the blocks without them; the
            # bytes reserved for an overlapped loader's temporaries, and the
            # blocks free memory allowed before the configured cap.
            "prefill_reserve_bytes": r.prefill_reserve_bytes,
            "kv_blocks_without_prefill_graphs":
                r.kv_blocks_without_prefill_graphs,
            "loader_reserve_bytes": r.loader_reserve_bytes,
            "kv_blocks_free_memory": r.kv_blocks_free_memory,
            "num_requests_running": self.scheduler.num_running,
            "num_requests_waiting": self.scheduler.num_waiting,
            "queue_depth": self.scheduler.num_running + self.scheduler.num_waiting,
            "resume_restored_tokens_total": self.resume_restored_tokens_total,
            # Start (docs/ELASTIC.md §1-2): the loader's seconds, the
            # warm-up seconds beside it, the warm-up's variants (every one a
            # miss: CUDA graphs do not persist), those a manifest deferred,
            # their first-use captures, and the start's phases.
            "startup_weight_load_seconds": r.startup_weight_load_seconds,
            "startup_compile_seconds": r.startup_compile_seconds,
            "startup_warmup_seconds": self.startup_warmup_seconds,
            "startup_total_seconds": self.startup_total_seconds,
            "startup_cache_hit_families": r.startup_cache_hit_families,
            "startup_cache_miss_families": r.startup_cache_miss_families,
            "startup_deferred_families": r.startup_deferred_families,
            "startup_phase_seconds": r.startup_phase_seconds,
            "weights_ready": r.weights_ready,
            "deferred_captures_total": r.deferred_captures_total,
            "deferred_capture_seconds_total":
                r.deferred_capture_seconds_total,
            "kv_cache_usage": self.block_manager.usage(),
            "prefix_cache_hits": self.block_manager.prefix_hits_total,
            "prefix_cache_queries": self.block_manager.prefix_queries_total,
            "num_preemptions": self.scheduler.num_preemptions_total,
            "prompt_tokens_total": self.prompt_tokens_total,
            "generation_tokens_total": self.generation_tokens_total,
            "decode_dispatches_total": self.decode_dispatches_total,
            "prefill_dispatches_total": self.prefill_dispatches_total,
            "fetches_total": self.fetches_total,
            "overlapped_fetches_total": self.overlapped_fetches_total,
            "dispatch_overlap_ratio": (
                self.overlapped_fetches_total / self.fetches_total
                if self.fetches_total else 0.0),
            "dispatch_gap_seconds_total": self.dispatch_gap_seconds_total,
            "host_stall_seconds_total": self.host_stall_seconds_total,
            "decode_steps_total": r.decode_steps_total,
            "decode_tokens_total": r.decode_tokens_total,
            "chained_dispatches_total": r.chained_dispatches_total,
            "decode_seconds_total": r.decode_seconds_total,
            "decode_device_seconds_total": r.decode_device_seconds_total,
            "prefill_seconds_total": r.prefill_seconds_total,
            # The embedding path (the port's keys): calls and the host
            # seconds they took.
            "embed_calls_total": r.embed_calls_total,
            "embed_seconds_total": r.embed_seconds_total,
            # The mesh: its degrees and ranks, the backend its rule picked,
            # and each rank's pool bytes.
            "mesh_tp_size": self.config.tensor_parallel_size,
            "mesh_sp_size": self.config.sequence_parallel_size,
            "mesh_dp_size": self.config.data_parallel_size,
            "mesh_devices": self.config.mesh_devices,
            "hbm_kv_bytes_per_device": r.per_device_hbm_kv_bytes(),
            "tp_backend": self.mesh.backend if self.mesh is not None else None,
            # Speculative decoding: the reference's keys and the port's
            # cycle counts.
            # OTLP spans the exporter queue had to drop (0 with tracing
            # off).
            "trace_spans_dropped_total": spans_dropped_total(),
            **r.spec_stats(),
            **r.decode_train.stats(),
            **r.prefill_train.stats(),
            **r.ingest_train.stats(),
            **self._live_perf(),
        }
