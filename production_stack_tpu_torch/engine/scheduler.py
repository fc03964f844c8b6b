"""Continuous-batching scheduler.

Mirror of ``production_stack_tpu/engine/scheduler.py`` (same policy, same
batches): prefill has priority and runs in token-budgeted chunks, several
waiting prompts per batched prefill; otherwise all running sequences decode
together in one fused K-step dispatch; when the block pool is exhausted the
lowest-priority running sequence is preempted by recompute. A resumed
request (``Sequence.resume_base``) enters the same prefill path with its
delivered tokens pre-seeded as output. At admission the offload tier may
restore blocks past the device prefix cache (``offload.try_restore``), and
every block that fills is offered to its spill thread. A prefill-role
engine forms no decode batch and a decode-role engine no prefill batch,
except for traffic the router flagged as fallback; a prefill hop's row
(``handoff_key``) never decodes and is never preempted. A LoRA request's
prefix-cache chain lives in its adapter's namespace (``Sequence.hash_seed``),
and a speculative decode's fetch reconciles each row's KV position to the
tokens the device accepted (``apply_results``).
"""

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence as Seq

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.kv_cache import BlockPoolManager
from production_stack_tpu_torch.engine.sampling import SamplingParams
from production_stack_tpu_torch.utils import (
    init_logger,
    pow2_bucket as _bucket,
    prefill_t_floor,
    window_mb_bucket,
)

logger = init_logger(__name__)

# Fused-scan length grades with the number of active streams:
# (max_running_bound, K_cap) pairs, ascending.
DECODE_STEP_TIERS = ((2, 8), (8, 32))
INTERACTIVE_DECODE_STEPS = DECODE_STEP_TIERS[0][1]


def decode_step_cap(num_streams: int, num_decode_steps: int) -> int:
    """Fused-scan K cap for ``num_streams`` concurrent rows."""
    cap = max(1, num_decode_steps)
    for bound, tier_cap in DECODE_STEP_TIERS:
        if num_streams <= bound:
            return min(cap, tier_cap)
    return cap


class SequenceStatus(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    FINISHED_STOPPED = "stop"
    FINISHED_LENGTH = "length"
    FINISHED_ABORTED = "abort"
    # Prefill hop complete: KV and chain state published to the remote
    # store; a decode engine continues the stream.
    FINISHED_HANDOFF = "handoff"

    @property
    def is_finished(self) -> bool:
        return self in (
            SequenceStatus.FINISHED_STOPPED,
            SequenceStatus.FINISHED_LENGTH,
            SequenceStatus.FINISHED_ABORTED,
            SequenceStatus.FINISHED_HANDOFF,
        )


@dataclass
class Sequence:
    request_id: str
    prompt_token_ids: List[int]
    sampling: SamplingParams
    eos_token_id: Optional[int] = None
    arrival_time: float = field(default_factory=time.monotonic)

    status: SequenceStatus = SequenceStatus.WAITING
    output_token_ids: List[int] = field(default_factory=list)
    # When sampling.logprobs is set: one (chosen logprob, [(id, logprob),
    # ...]) per output token, None for tokens a resume pre-seeded.
    output_logprobs: List = field(default_factory=list)
    # Mid-stream resume: output tokens pre-seeded from the request's
    # resume_tokens (delivered by an earlier engine). This engine rebuilds
    # their KV through prefill and decodes on at generation index
    # resume_base; they are never counted as generated here.
    resume_base: int = 0
    _resume_counted: bool = False
    # Disagg prefill hop: once prefilled and token 1 sampled, the engine
    # publishes KV and chain state under this key and finishes the row
    # (FINISHED_HANDOFF); it never joins a decode batch.
    handoff_key: Optional[str] = None
    handoff_done: bool = False
    # Router-flagged fallback traffic: served end to end on this engine
    # whatever its role.
    disagg_fallback: bool = False
    # LoRA adapter index in the engine's registry (0 = base model) rides the
    # packed buffer so one batch can mix adapters; adapter_name keys the
    # prefix-cache namespace (models/lora.py).
    adapter_idx: int = 0
    adapter_name: Optional[str] = None
    # Monotonic time of the first dispatch issue (closes queue wait).
    first_issue_time: Optional[float] = None
    # Tokens sampled by an issued-but-unapplied dispatch (num_computed_tokens
    # already includes them).
    inflight_steps: int = 0
    # True while the final chunk of this row's prefill is issued but not
    # yet applied: the row must not join a decode batch until then.
    pending_prefill_apply: bool = False
    block_ids: List[int] = field(default_factory=list)
    num_computed_tokens: int = 0       # tokens whose KV is in the device pool
    num_cached_tokens: int = 0         # prefix-cache hits (telemetry)
    num_preemptions: int = 0
    first_token_time: Optional[float] = None
    # prefix-cache hash chain bookkeeping
    _prev_hash: bytes = b""
    _num_hashed_blocks: int = 0

    @property
    def all_token_ids(self) -> List[int]:
        return self.prompt_token_ids + self.output_token_ids

    @property
    def num_tokens(self) -> int:
        return len(self.prompt_token_ids) + len(self.output_token_ids)

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_token_ids)

    @property
    def prefill_done(self) -> bool:
        return self.num_computed_tokens >= len(self.prompt_token_ids)

    def finish_reason(self) -> Optional[str]:
        return self.status.value if self.status.is_finished else None

    @property
    def hash_seed(self) -> bytes:
        """Prefix-cache hash-chain seed: KV under different LoRA adapters is
        different KV, so each adapter gets its own chain namespace on the
        device and in the host/remote offload tiers. Keyed by adapter
        NAME, not registry index: indices are engine-local and would
        collide across engines sharing a remote KV tier."""
        return b"" if not self.adapter_name else f"lora:{self.adapter_name}".encode()


@dataclass
class ScheduledBatch:
    kind: str                        # "prefill" | "decode"
    seqs: List[Sequence]
    chunk_starts: List[int] = field(default_factory=list)  # prefill only
    chunk_lens: List[int] = field(default_factory=list)
    # decode only: steps of the fused dispatch and each row's budget (a row
    # with fewer steps has its excess writes masked to the null block and
    # its excess tokens discarded).
    num_steps: int = 1
    decode_steps: List[int] = field(default_factory=list)
    epochs: List[int] = field(default_factory=list)
    finals: List[bool] = field(default_factory=list)
    # Set by the runner at decode issue: which speculative variant ran —
    # "off" (speculation disabled), "linear", "tree", "adaptive", or
    # "off-degrade" (every row at gamma 0: the plain train).
    spec_mode: str = "off"


class Scheduler:
    def __init__(self, config: EngineConfig, block_manager: BlockPoolManager,
                 offload=None, decode_window_budget: Optional[int] = None,
                 prefill_window_budget: Optional[int] = None):
        self.config = config
        self.block_manager = block_manager
        self.offload = offload  # KVOffloadManager (host/remote KV tiers)
        # on_restore(request_id, tokens, seconds) after an admission restore
        self.on_restore = None
        # Window budgets (in blocks) cap bucket(rows) x bucket(max_blocks)
        # of a dispatch that gathers a window; None = unlimited.
        self.decode_window_budget = decode_window_budget or (1 << 30)
        self.prefill_window_budget = prefill_window_budget or (1 << 30)
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []
        self.seqs: Dict[str, Sequence] = {}
        self.num_preemptions_total = 0
        # A row the window budget skipped last dispatch decodes FIRST next.
        self._decode_first: Optional[Sequence] = None

    def _window_ok(self, rows: int, max_blocks: int, budget: int) -> bool:
        cfg = self.config
        return (
            _bucket(rows, 1, max(1, cfg.max_num_seqs))
            * window_mb_bucket(max_blocks, cfg.max_blocks_per_seq)
            <= budget
        )

    # ----------------------------------------------------------------- intake
    def add_sequence(self, seq: Sequence) -> None:
        if seq.num_tokens > self.config.max_model_len:
            raise ValueError(
                f"Prompt of {seq.num_tokens} tokens exceeds max_model_len "
                f"{self.config.max_model_len}"
            )
        bs = self.config.block_size
        usable = self.block_manager.num_blocks - 1
        if -(-seq.num_tokens // bs) > usable:
            raise ValueError(
                f"Prompt of {seq.num_tokens} tokens cannot fit the KV pool "
                f"({usable} blocks x {bs} tokens)"
            )
        self.seqs[seq.request_id] = seq
        self.waiting.append(seq)

    def abort(self, request_id: str) -> Optional[Sequence]:
        return self.finish(request_id, SequenceStatus.FINISHED_ABORTED)

    def finish(self, request_id: str, status: SequenceStatus) -> Optional[Sequence]:
        seq = self.seqs.get(request_id)
        if seq is None or seq.status.is_finished:
            return None
        self._finish(seq, status)
        return seq

    @property
    def num_waiting(self) -> int:
        return len(self.waiting)

    @property
    def num_running(self) -> int:
        return len(self.running)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # -------------------------------------------------------------- schedule
    def schedule(self, prefer_decode: bool = False) -> Optional[ScheduledBatch]:
        """One admissible batch, prefill first (TTFT priority);
        ``prefer_decode`` inverts the order: the overlap engine loop asks
        for it while a prefill is in flight, so decode keeps its cadence
        through a chunk train. Rows whose final prefill chunk is issued but
        not applied never join a decode batch (``pending_prefill_apply``),
        so every decode chains its start tokens from one dispatch."""
        if prefer_decode:
            batch = self._schedule_decode()
            if batch is not None:
                return batch
            return self._try_schedule_prefill()
        batch = self._try_schedule_prefill()
        if batch is not None:
            return batch
        return self._schedule_decode()

    def _try_schedule_prefill(self) -> Optional[ScheduledBatch]:
        """Admit up to max_prefill_seqs waiting prompts into ONE batched
        prefill. Starved prompts are skipped, never preempted-for."""
        cfg = self.config
        max_rows = min(
            cfg.max_prefill_seqs, cfg.max_num_seqs - len(self.running)
        )
        if not self.waiting or max_rows <= 0:
            return None
        budget = cfg.max_num_batched_tokens
        cands: List[Sequence] = []
        newly_allocated: set = set()
        for cand in list(self.waiting):
            if len(cands) >= max_rows:
                break
            if self.config.role == "decode" and not cand.disagg_fallback:
                # A decode-role engine prefills only fallback traffic
                # (decode-hop rows are restored straight to RUNNING).
                continue
            if not cand.block_ids:
                alloc = self.block_manager.allocate_prompt(
                    cand.all_token_ids, seed=cand.hash_seed)
                if alloc is None:
                    continue  # starved; a later cand may already hold blocks
                cand.block_ids, cand.num_cached_tokens = alloc
                cand.num_computed_tokens = cand.num_cached_tokens
                cand._prev_hash = cand.hash_seed
                newly_allocated.add(cand.request_id)
                if self.offload is not None:
                    # The host/remote tiers may extend the cached prefix
                    # past what the device still holds; the scatter is
                    # enqueued before this batch's prefill.
                    t_restore = time.monotonic()
                    restored = self.offload.try_restore(
                        cand.all_token_ids, cand.block_ids,
                        cand.num_computed_tokens, seed=cand.hash_seed)
                    cand.num_computed_tokens += restored
                    cand.num_cached_tokens += restored
                    if restored and self.on_restore is not None:
                        self.on_restore(cand.request_id, restored,
                                        time.monotonic() - t_restore)
            cands.append(cand)
        if not cands:
            return None
        # Shared padded chunk width: a fair share of the budget over the
        # admitted rows; the padded width counts against the budget.
        n = len(cands)
        while True:
            rems = [c.num_tokens - c.num_computed_tokens for c in cands[:n]]
            chunk_cap = min(max(rems), max(16, budget // n))
            t_bucket = prefill_t_floor(budget)
            while t_bucket < chunk_cap:
                t_bucket *= 2
            has_window = any(c.num_computed_tokens > 0 for c in cands[:n])
            mb_need = max(len(c.block_ids) for c in cands[:n])
            padded_rows = n if n == 1 else max(n, self.config.max_prefill_seqs)
            win_ok = not has_window or self._window_ok(
                padded_rows, mb_need, self.prefill_window_budget
            )
            if n == 1 or (n * t_bucket <= budget and win_ok):
                break
            n -= 1
        seqs = cands[:n]
        # Candidates allocated this pass but dropped by the shrink loop
        # release their blocks (the prefix cache makes re-allocation cheap).
        for cand in cands[n:]:
            if cand.request_id in newly_allocated:
                self.block_manager.free_blocks(cand.block_ids)
                cand.block_ids = []
                cand.num_computed_tokens = 0
                cand.num_cached_tokens = 0
                cand._prev_hash = cand.hash_seed
                cand._num_hashed_blocks = 0
        starts = [s.num_computed_tokens for s in seqs]
        lens = [
            min(s.num_tokens - s.num_computed_tokens, chunk_cap) for s in seqs
        ]
        for seq in seqs:
            self.waiting.remove(seq)
            seq.status = SequenceStatus.RUNNING
        return ScheduledBatch(
            kind="prefill", seqs=seqs, chunk_starts=starts, chunk_lens=lens
        )

    def _schedule_decode(self) -> Optional[ScheduledBatch]:
        if not self.running:
            return None
        bs = self.config.block_size
        max_k = decode_step_cap(
            len(self.running), self.config.num_decode_steps
        )
        scheduled: List[Sequence] = []
        steps: List[int] = []
        snapshot = list(self.running)
        ofs = 0
        if self._decode_first is not None:
            try:
                ofs = snapshot.index(self._decode_first)
            except ValueError:
                pass  # finished/preempted since; normal order
            self._decode_first = None
        first_skipped: Optional[Sequence] = None
        for seq in snapshot[ofs:] + snapshot[:ofs]:
            if seq not in self.running:
                continue  # preempted by an earlier iteration of this pass
            if seq.pending_prefill_apply:
                continue
            if seq.handoff_key is not None:
                continue  # a prefill hop finishes at token 1, by handoff
            if self.config.role == "prefill" and not seq.disagg_fallback:
                continue  # a prefill-role engine decodes only fallback rows
            pos = seq.num_computed_tokens
            produced = len(seq.output_token_ids) + seq.inflight_steps
            if (
                seq.sampling.max_tokens - produced <= 0
                or self.config.max_model_len - pos <= 0
            ):
                continue
            want = max(1, min(
                max_k,
                self.config.max_model_len - pos,
                seq.sampling.max_tokens - produced,
            ))
            need_blocks = (pos + want - 1) // bs + 1
            while len(seq.block_ids) < need_blocks:
                blk = self.block_manager.append_block()
                if blk is not None:
                    seq.block_ids.append(blk)
                    continue
                if len(seq.block_ids) * bs > pos:
                    break  # partial allocation still allows >= 1 step
                victim = self._pick_preemption_victim(exclude=scheduled)
                if victim is None or victim is seq:
                    self._preempt(seq)
                    break
                self._preempt(victim)
            if seq not in self.running:
                continue
            avail = len(seq.block_ids) * bs - pos
            if avail <= 0:
                continue
            mb_next = max(
                [len(seq.block_ids)] + [len(s.block_ids) for s in scheduled]
            )
            if scheduled and not self._window_ok(
                len(scheduled) + 1, mb_next, self.decode_window_budget
            ):
                if first_skipped is None:
                    first_skipped = seq
                continue  # window budget full; this row decodes next dispatch
            scheduled.append(seq)
            steps.append(min(want, avail))
        if first_skipped is not None and first_skipped in self.running:
            self._decode_first = first_skipped
        if not scheduled:
            return None
        max_k = min(
            max_k,
            decode_step_cap(len(scheduled), self.config.num_decode_steps),
        )
        # A row with no output yet gets its first decode token only when the
        # whole fused dispatch returns: cap the scan short.
        if any(not s.output_token_ids for s in scheduled):
            max_k = min(max_k, INTERACTIVE_DECODE_STEPS)
        num_steps = max_k
        # Return blocks over-reserved for the pre-regrade `want`.
        for i, seq in enumerate(scheduled):
            steps[i] = min(steps[i], num_steps)
            need = (seq.num_computed_tokens + steps[i] - 1) // bs + 1
            if len(seq.block_ids) > need:
                self.block_manager.free_blocks(seq.block_ids[need:])
                del seq.block_ids[need:]
        return ScheduledBatch(
            kind="decode", seqs=scheduled, num_steps=num_steps,
            decode_steps=steps,
        )

    def _pick_preemption_victim(self, exclude: Seq[Sequence]) -> Optional[Sequence]:
        for seq in reversed(self.running):
            if seq in exclude:
                continue
            if seq.handoff_key is not None:
                # Its blocks may be mid-read by the handoff publish; it
                # finishes right after it.
                continue
            return seq
        return None

    def _preempt(self, seq: Sequence) -> None:
        logger.warning("Preempting request %s (recompute)", seq.request_id)
        self.num_preemptions_total += 1
        seq.num_preemptions += 1
        if seq in self.running:
            self.running.remove(seq)
        self.block_manager.free_blocks(seq.block_ids)
        seq.block_ids = []
        seq.num_computed_tokens = 0
        seq.inflight_steps = 0
        seq.pending_prefill_apply = False
        seq._prev_hash = seq.hash_seed
        seq._num_hashed_blocks = 0
        seq.status = SequenceStatus.WAITING
        self.waiting.appendleft(seq)

    # ------------------------------------------------------- post-step update
    def advance_at_issue(self, batch: ScheduledBatch) -> None:
        """State advance at dispatch issue: KV positions, queue transitions,
        in-flight generation accounting — all that ``schedule`` needs to
        build the next dispatch before this one's tokens reach the host
        (``apply_results`` delivers them later, in issue order)."""
        batch.epochs = [s.num_preemptions for s in batch.seqs]
        if batch.kind == "prefill":
            requeue: List[Sequence] = []
            batch.finals = []
            for idx, seq in enumerate(batch.seqs):
                if seq.status.is_finished:
                    batch.finals.append(False)
                    continue
                seq.num_computed_tokens += batch.chunk_lens[idx]
                final = seq.num_computed_tokens >= seq.num_tokens
                batch.finals.append(final)
                if final:
                    seq.inflight_steps += 1
                    seq.pending_prefill_apply = True
                    self.running.append(seq)
                else:
                    seq.status = SequenceStatus.WAITING
                    requeue.append(seq)
            self.waiting.extendleft(reversed(requeue))
        else:
            for i, seq in enumerate(batch.seqs):
                if seq.status.is_finished:
                    continue
                seq.num_computed_tokens += batch.decode_steps[i]
                seq.inflight_steps += batch.decode_steps[i]

    def _apply_valid(self, seq: Sequence, epoch: int) -> bool:
        return not seq.status.is_finished and seq.num_preemptions == epoch

    def apply_results(
        self, batch: ScheduledBatch, token_lists: List[List[int]],
        logprob_lists=None,
    ) -> tuple:
        """Deliver a fetched dispatch's tokens (and, when a row asked, its
        per-token logprob entries, aligned). Returns (sequences that
        produced NEW tokens, number of tokens accepted)."""
        produced: List[Sequence] = []
        accepted = 0
        if batch.kind == "prefill":
            for idx, seq in enumerate(batch.seqs):
                if batch.finals[idx] and \
                        seq.num_preemptions == batch.epochs[idx]:
                    seq.pending_prefill_apply = False
                if not self._apply_valid(seq, batch.epochs[idx]):
                    continue
                self._register_full_blocks(seq)
                if batch.finals[idx] and token_lists[idx]:
                    seq.inflight_steps -= 1
                    self._append_token(
                        seq, token_lists[idx][0],
                        logprob_lists[idx][0]
                        if logprob_lists and logprob_lists[idx] else None)
                    accepted += 1
                    produced.append(seq)
        else:
            for i, (seq, toks) in enumerate(zip(batch.seqs, token_lists)):
                if not self._apply_valid(seq, batch.epochs[i]):
                    continue
                seq.inflight_steps -= batch.decode_steps[i]
                if self.config.speculative_num_tokens:
                    # A speculative dispatch emits a variable count (at most
                    # its budget), and advance_at_issue advanced by the
                    # budget: reconcile the KV position to what the device
                    # committed (the speculative loop is strict, so no
                    # dispatch was issued in between).
                    seq.num_computed_tokens -= max(
                        0, batch.decode_steps[i] - len(toks))
                took = False
                lps = logprob_lists[i] if logprob_lists else None
                for j, tok in enumerate(toks):
                    if seq.status.is_finished:
                        break  # EOS/max_tokens hit mid-scan; rest discarded
                    self._append_token(seq, tok, lps[j] if lps else None)
                    accepted += 1
                    took = True
                self._register_full_blocks(seq)
                if took:
                    produced.append(seq)
        for seq in produced:
            if seq.status.is_finished and seq in self.running:
                self.running.remove(seq)
        return produced, accepted

    def update_after_step(
        self, batch: ScheduledBatch, token_lists: List[List[int]],
        logprob_lists=None,
    ) -> tuple:
        """Synchronous advance + apply (the strict engine loop)."""
        self.advance_at_issue(batch)
        return self.apply_results(batch, token_lists, logprob_lists)

    def _append_token(self, seq: Sequence, token: int, logprob=None) -> None:
        if seq.first_token_time is None:
            seq.first_token_time = time.monotonic()
        seq.output_token_ids.append(token)
        if seq.sampling.logprobs is not None:
            seq.output_logprobs.append(logprob)
        sp = seq.sampling
        n_out = len(seq.output_token_ids)
        if (
            not sp.ignore_eos
            and n_out >= sp.min_tokens
            and (
                (seq.eos_token_id is not None and token == seq.eos_token_id)
                or token in sp.stop_token_ids
            )
        ):
            self._finish(seq, SequenceStatus.FINISHED_STOPPED)
        elif n_out >= sp.max_tokens or seq.num_tokens >= self.config.max_model_len:
            self._finish(seq, SequenceStatus.FINISHED_LENGTH)

    def _finish(self, seq: Sequence, status: SequenceStatus) -> None:
        seq.status = status
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        self.block_manager.free_blocks(seq.block_ids)
        seq.block_ids = []

    def _register_full_blocks(self, seq: Sequence) -> None:
        if not seq.block_ids:
            return  # freed (abort/preempt) before this bookkeeping ran
        bs = self.config.block_size
        full = min(seq.num_computed_tokens, len(seq.all_token_ids)) // bs
        tokens = seq.all_token_ids
        while seq._num_hashed_blocks < full:
            i = seq._num_hashed_blocks
            h = self.block_manager.register_full_block(
                seq.block_ids[i], seq._prev_hash, tokens[i * bs:(i + 1) * bs]
            )
            if self.offload is not None:
                self.offload.on_block_registered(h, seq.block_ids[i])
            seq._prev_hash = h
            seq._num_hashed_blocks += 1
