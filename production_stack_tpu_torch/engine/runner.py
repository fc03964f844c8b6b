"""ModelRunner: owns the device state and runs the serving steps.

Counterpart of ``production_stack_tpu/engine/runner.py`` (main path only):
  * The KV pool is two tensors ``[L, Hkv, num_slots, Dh]`` (the JAX layout,
    so offload bytes stay compatible later), updated IN PLACE — the JAX
    package donated its pools to each dispatch and rebound the results.
    ``kv_cache_dtype="int8"`` stores int8 payload pools plus bf16 scale
    pools ``[L, Hkv, num_slots]``; fresh K/V is quantized once, before it is
    written, and every reader dequantizes (ops/quantization.py).
  * A prefill dispatch computes slot mappings, gathers the history window
    once, runs the forward, samples from the last token's logits and
    scatters the chunk's KV once.
  * A decode dispatch runs K fused steps. Tokens produced mid-dispatch live
    in a small ring ``[L, Hkv, b, K, Dh]`` that attention reads beside the
    pool (``kv_lens = pos0``: the pool holds only tokens of earlier
    dispatches); the whole dispatch's KV is scattered once at the end.
  * All small host inputs of a dispatch ride ONE int32 buffer (floats
    bitcast), one host-to-device copy per dispatch.

The engine loop is strict issue -> fetch -> apply in this slice, so every
decode row's start token is already on the host (no device token chaining;
pipelining is ROADMAP Queue 1 item 6). Row counts are not padded to
power-of-two buckets: PyTorch runs eagerly, and the buckets existed for
XLA's compile families (CUDA graphs per bucket are ROADMAP work).
"""

import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.sampling import (
    apply_penalties,
    gumbel_noise,
    sample_tokens,
    seed_base,
    token_seed,
)
from production_stack_tpu_torch.engine.scheduler import ScheduledBatch
from production_stack_tpu_torch.models import llama
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.weights import dtype_of
from production_stack_tpu_torch.ops.attention import gather_window
from production_stack_tpu_torch.ops.quantization import (
    SCALE_DTYPE,
    dequantize_kv,
    quantize_kv,
)
from production_stack_tpu_torch.utils import (
    init_logger,
    pow2_bucket as _bucket,
    prefill_t_floor,
    resolve_device,
    window_mb_bucket,
)

logger = init_logger(__name__)

POS_SENTINEL = 2**30  # ring_pos value for not-yet-written entries
# Rows of per-row int32 scalars at the head of a decode dispatch's packed
# host buffer (floats bitcast): tokens0, pos0, budget, temperature, top_k,
# top_p, presence, frequency.
_DECODE_SCALARS = 8
# Prefill: chunk_start, chunk_len, temperature, top_k, top_p, presence,
# frequency.
_PREFILL_SCALARS = 7


class ModelRunner:
    def __init__(self, config: EngineConfig, model_config: ModelConfig,
                 params: Optional[Dict] = None,
                 num_kv_blocks: Optional[int] = None):
        self.config = config
        self.model_config = model_config
        self.device = resolve_device(config.device)
        if model_config.arch != "llama":
            raise ValueError(
                f"arch {model_config.arch!r} is not ported (llama family only)"
            )
        if os.path.isdir(config.model):
            raise ValueError(
                "loading a HuggingFace checkpoint directory is not ported yet; "
                "serve a named config (random weights from config.seed)"
            )
        # "paged": decode attends against the pool inside the CUDA
        # flash-decode kernel (its plain twin on the CPU). "window": decode
        # gathers the live KV into a contiguous per-dispatch window.
        self.attn_impl = config.resolved_attn_impl(model_config)
        self.dtype = dtype_of(config.dtype)
        self.kv_quantized = config.kv_cache_quantized
        # Tokens written to a quantized pool (prefill + decode), for
        # kv_quant_bytes_saved_total.
        self.kv_quant_tokens_written = 0
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = llama.init_params(model_config, gen, self.dtype, self.device)
        else:
            params = {
                k: ({n: t.to(self.device, self.dtype) for n, t in v.items()}
                    if k == "layers" else v.to(self.device, self.dtype))
                for k, v in params.items()
            }
        self.params = params
        self._head_f32 = llama.lm_head_f32(params, model_config)
        self.num_kv_blocks = num_kv_blocks or config.num_kv_blocks or \
            self._derive_num_blocks()
        self._alloc_kv_pools()
        # Host-clock dispatch accounting (each dispatch ends in a fetch that
        # synchronizes the device).
        self.prefill_seconds_total = 0.0
        self.decode_seconds_total = 0.0
        self.decode_steps_total = 0       # fused steps executed
        self.decode_tokens_total = 0      # tokens within row budgets

    # ------------------------------------------------------------------ sizing
    def _alloc_kv_pools(self) -> None:
        """Payload pools in the storage dtype, plus (int8) the per-(slot,
        head) scale pools."""
        mc, cfg = self.model_config, self.config
        num_slots = self.num_kv_blocks * cfg.block_size
        shape = (mc.num_layers, mc.num_kv_heads, num_slots, mc.head_dim_)
        store = torch.int8 if self.kv_quantized else self.dtype
        self.kv_k = torch.zeros(shape, dtype=store, device=self.device)
        self.kv_v = torch.zeros(shape, dtype=store, device=self.device)
        if self.kv_quantized:
            self.kv_k_scale = torch.zeros(shape[:-1], dtype=SCALE_DTYPE,
                                          device=self.device)
            self.kv_v_scale = torch.zeros_like(self.kv_k_scale)
        else:
            self.kv_k_scale = self.kv_v_scale = None

    @property
    def kv_pool_bytes(self) -> int:
        """Device bytes of the KV pool, payload + scale pools."""
        return self.num_kv_blocks * self.config.kv_cache_bytes_per_block(
            self.model_config)

    @property
    def kv_quant_bytes_saved_total(self) -> int:
        """Pool bytes a quantized cache avoided writing against storing the
        same tokens in the compute dtype (0 when not quantized)."""
        if not self.kv_quantized:
            return 0
        mc, cfg = self.model_config, self.config
        unquantized = (2 * mc.num_layers * mc.num_kv_heads * mc.head_dim_
                       * self.dtype.itemsize)
        saved = max(0, unquantized - cfg.kv_cache_bytes_per_token(mc))
        return self.kv_quant_tokens_written * saved

    def _derive_num_blocks(self) -> int:
        """Size the KV pool from free device memory (after the weights are
        resident); the CPU gets a conservative 2 GiB. The pool costs its
        storage bytes (int8 payload + scales when quantized); gathered
        windows hold dequantized compute-dtype K/V and cost those bytes."""
        mc, cfg = self.model_config, self.config
        bytes_per_block = cfg.kv_cache_bytes_per_block(mc)
        window_bytes_per_block = cfg.window_bytes_per_block(mc)
        if self.device.type == "cuda":
            free_bytes, _ = torch.cuda.mem_get_info(self.device)
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

    # --------------------------------------------------------------- helpers
    def _upload(self, packed: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(packed)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _sample(self, logits, temps, top_k, top_p, seeds: List[int],
                host_temps: List[float], counts=None, presence=None,
                frequency=None) -> torch.Tensor:
        eff = logits
        if counts is not None:
            eff = apply_penalties(logits, counts, presence, frequency)
        gumbel = gumbel_noise(seeds, logits.shape[1], self.device,
                              rows=[t > 0.0 for t in host_temps])
        return sample_tokens(eff, temps, top_k, top_p, gumbel)

    def _counts(self, seqs) -> Optional[torch.Tensor]:
        if not any(s.sampling.presence_penalty or s.sampling.frequency_penalty
                   for s in seqs):
            return None
        vocab = self.model_config.vocab_size
        counts = np.zeros((len(seqs), vocab), np.int32)
        for i, s in enumerate(seqs):
            if s.output_token_ids:
                np.add.at(counts[i],
                          np.asarray(s.output_token_ids, np.int64) % vocab, 1)
        return torch.from_numpy(counts).to(self.device)

    # ------------------------------------------------------------------ decode
    def _execute_decode(self, batch: ScheduledBatch) -> List[List[int]]:
        """One fused K-step decode dispatch (the JAX package's
        ``_issue_decode`` + ``_decode_impl`` + fetch); returns each row's
        tokens (its step budget's worth)."""
        t_start = time.monotonic()
        cfg, mc = self.config, self.model_config
        bs = cfg.block_size
        seqs = batch.seqs
        num_steps = batch.num_steps
        b = len(seqs)
        mb = self._decode_mb(max(len(s.block_ids) for s in seqs))

        packed = np.zeros((_DECODE_SCALARS * b + b * mb,), np.int32)
        sc = packed[:_DECODE_SCALARS * b].reshape(_DECODE_SCALARS, b)
        bt = packed[_DECODE_SCALARS * b:].reshape(b, mb)
        f32 = sc.view(np.float32)
        bases, gen0s, host_temps = [], [], []
        for i, s in enumerate(seqs):
            pos = s.num_computed_tokens
            if pos >= len(s.all_token_ids):
                raise RuntimeError(
                    f"row {s.request_id}: token at pos {pos} is not on the "
                    "host (the strict engine loop applies every dispatch "
                    "before the next is issued)"
                )
            sc[0, i] = s.all_token_ids[pos]
            sc[1, i] = pos
            sc[2, i] = batch.decode_steps[i]
            sp = s.sampling
            f32[3, i] = sp.temperature
            sc[4, i] = sp.top_k
            f32[5, i] = sp.top_p
            f32[6, i] = sp.presence_penalty
            f32[7, i] = sp.frequency_penalty
            bt[i, :len(s.block_ids)] = s.block_ids
            bases.append(seed_base(s.request_id, sp))
            gen0s.append(len(s.output_token_ids) + s.inflight_steps)
            host_temps.append(sp.temperature)
        dev = self._upload(packed)
        scalars = dev[:_DECODE_SCALARS * b].view(_DECODE_SCALARS, b)
        tokens0, pos0, budget = scalars[0], scalars[1], scalars[2]
        temps = scalars[3].view(torch.float32)
        top_k = scalars[4]
        top_p = scalars[5].view(torch.float32)
        presence = scalars[6].view(torch.float32)
        frequency = scalars[7].view(torch.float32)
        block_tables = dev[_DECODE_SCALARS * b:].view(b, mb)
        counts = self._counts(seqs)

        # Per-step write slots [K, b] (0 = the null block for rows whose
        # budget ran out).
        k_iota = torch.arange(num_steps, dtype=torch.int32, device=self.device)
        p = pos0[None, :] + k_iota[:, None]                          # [K, b]
        blk_idx = torch.clamp(p // bs, 0, mb - 1)
        blk = torch.gather(block_tables, 1, blk_idx.t().long()).t()  # [K, b]
        valid = k_iota[:, None] < budget[None, :]
        slot_steps = torch.where(valid, blk * bs + p % bs,
                                 torch.zeros_like(blk))

        quant = self.kv_quantized
        if self.attn_impl == "paged":
            win_k = win_v = win_len = None
            paged = (self.kv_k, self.kv_v, self.kv_k_scale, self.kv_v_scale,
                     block_tables, pos0, bs)
        else:
            win_k, win_v = gather_window(
                self.kv_k, self.kv_v, block_tables, bs, self.kv_k_scale,
                self.kv_v_scale, out_dtype=self.dtype)
            win_len = pos0
            paged = None

        nl, hkv, dh = mc.num_layers, mc.num_kv_heads, mc.head_dim_
        ring_k = torch.zeros((nl, hkv, b, num_steps, dh), dtype=self.dtype,
                             device=self.device)
        ring_v = torch.zeros_like(ring_k)
        if quant:
            # Side rings of the int8 payload + scales each step scatters at
            # the end of the dispatch: each token is quantized ONCE, so the
            # pool and the attention ring hold the same (q, scale) pair.
            ring_qk = torch.zeros(ring_k.shape, dtype=torch.int8,
                                  device=self.device)
            ring_qv = torch.zeros_like(ring_qk)
            ring_sk = torch.zeros(ring_k.shape[:-1], dtype=SCALE_DTYPE,
                                  device=self.device)
            ring_sv = torch.zeros_like(ring_sk)
        ring_pos = torch.full((b, num_steps), POS_SENTINEL, dtype=torch.int32,
                              device=self.device)
        ones = torch.ones((b,), dtype=torch.int32, device=self.device)
        max_len = cfg.max_model_len
        rows = torch.arange(b, device=self.device)

        # Every step of the dispatch runs (the JAX package's
        # decode_loop="scan"); steps past a row's budget are discarded.
        toks = tokens0
        toks_all = []
        for j in range(num_steps):
            positions = torch.clamp(pos0 + j, max=max_len - 1)[:, None]
            hidden, k_new, v_new = llama.forward(
                self.params, mc, toks[:, None], positions, ones,
                win_k, win_v, win_len, ring_k, ring_v, ring_pos, paged=paged,
            )
            logits = llama.compute_logits(self.params, mc, hidden[:, 0],
                                          self._head_f32)
            seeds = [token_seed(bases[i], gen0s[i] + j) for i in range(b)]
            nxt = self._sample(logits, temps, top_k, top_p, seeds, host_temps,
                               counts, presence, frequency)
            if counts is not None:
                counts[rows, nxt] += 1
            if quant:
                # Later steps attend to what later dispatches reconstruct
                # from the pool; this step's own token attended to itself
                # unquantized inside the forward.
                qk, sk = quantize_kv(k_new)
                qv, sv = quantize_kv(v_new)
                k_new = dequantize_kv(qk, sk, self.dtype)
                v_new = dequantize_kv(qv, sv, self.dtype)
                ring_qk[:, :, :, j] = qk[:, :, :, 0]
                ring_qv[:, :, :, j] = qv[:, :, :, 0]
                ring_sk[:, :, :, j] = sk[:, :, :, 0]
                ring_sv[:, :, :, j] = sv[:, :, :, 0]
            ring_k[:, :, :, j] = k_new[:, :, :, 0]
            ring_v[:, :, :, j] = v_new[:, :, :, 0]
            ring_pos[:, j] = positions[:, 0]
            # The carried token freezes at each row's step budget.
            toks = torch.where(j < budget, nxt.to(torch.int32), toks)
            toks_all.append(nxt)

        # ONE scatter writes the whole dispatch's KV to the pool, in place
        # (int8: the payload and scales the steps recorded).
        flat_slots = slot_steps.reshape(-1).long()

        def steps_major(ring):
            return ring.transpose(2, 3).reshape(nl, hkv, num_steps * b,
                                                *ring.shape[4:])

        if quant:
            self.kv_k[:, :, flat_slots] = steps_major(ring_qk)
            self.kv_v[:, :, flat_slots] = steps_major(ring_qv)
            self.kv_k_scale[:, :, flat_slots] = steps_major(ring_sk)
            self.kv_v_scale[:, :, flat_slots] = steps_major(ring_sv)
            self.kv_quant_tokens_written += sum(batch.decode_steps)
        else:
            self.kv_k[:, :, flat_slots] = steps_major(ring_k)
            self.kv_v[:, :, flat_slots] = steps_major(ring_v)

        out = torch.stack(toks_all).cpu().numpy()                    # [K, b]
        tokens = [
            [int(out[j, i]) for j in range(batch.decode_steps[i])]
            for i in range(b)
        ]
        self.decode_steps_total += num_steps
        self.decode_tokens_total += sum(batch.decode_steps)
        self.decode_seconds_total += time.monotonic() - t_start
        return tokens

    # ----------------------------------------------------------------- prefill
    def _execute_prefill(self, batch: ScheduledBatch) -> List[List[int]]:
        """One (multi-sequence) prefill chunk dispatch (``_issue_prefill`` +
        ``_prefill_impl`` + fetch); returns the sampled token for rows whose
        prompt completes in this chunk."""
        t_start = time.monotonic()
        cfg, mc = self.config, self.model_config
        bs = cfg.block_size
        seqs = batch.seqs
        b = len(seqs)
        t = _bucket(max(batch.chunk_lens),
                    prefill_t_floor(cfg.max_num_batched_tokens),
                    max(16, cfg.max_num_batched_tokens))
        has_window = any(st > 0 for st in batch.chunk_starts)
        mb = self._prefill_mb(max(len(s.block_ids) for s in seqs), has_window)
        finals = [
            batch.chunk_starts[i] + batch.chunk_lens[i] >= seqs[i].num_tokens
            for i in range(b)
        ]

        n_sc = _PREFILL_SCALARS * b
        packed = np.zeros((n_sc + b * mb + b * t,), np.int32)
        sc = packed[:n_sc].reshape(_PREFILL_SCALARS, b)
        bt = packed[n_sc:n_sc + b * mb].reshape(b, mb)
        toks = packed[n_sc + b * mb:].reshape(b, t)
        f32 = sc.view(np.float32)
        seeds, host_temps = [], []
        for i, s in enumerate(seqs):
            start, ln = batch.chunk_starts[i], batch.chunk_lens[i]
            sc[0, i] = start
            sc[1, i] = ln
            sp = s.sampling
            f32[2, i] = sp.temperature
            sc[3, i] = sp.top_k
            f32[4, i] = sp.top_p
            f32[5, i] = sp.presence_penalty
            f32[6, i] = sp.frequency_penalty
            bt[i, :len(s.block_ids)] = s.block_ids
            toks[i, :ln] = s.all_token_ids[start:start + ln]
            seeds.append(token_seed(seed_base(s.request_id, sp),
                                    len(s.output_token_ids)))
            host_temps.append(sp.temperature)
        dev = self._upload(packed)
        scalars = dev[:n_sc].view(_PREFILL_SCALARS, b)
        chunk_start, chunk_lens = scalars[0], scalars[1]
        temps = scalars[2].view(torch.float32)
        top_k = scalars[3]
        top_p = scalars[4].view(torch.float32)
        presence = scalars[5].view(torch.float32)
        frequency = scalars[6].view(torch.float32)
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
        hidden, k_new, v_new = llama.forward(
            self.params, mc, token_ids, positions, chunk_lens,
            win_k, win_v, win_len,
        )
        del win_k, win_v
        logit_idx = torch.clamp(chunk_lens - 1, min=0).long()
        last_hidden = hidden[torch.arange(b, device=self.device), logit_idx]
        next_tokens = None
        if any(finals):
            logits = llama.compute_logits(self.params, mc, last_hidden,
                                          self._head_f32)
            next_tokens = self._sample(
                logits, temps, top_k, top_p, seeds, host_temps,
                self._counts(seqs), presence, frequency,
            )

        nl, hkv, dh = mc.num_layers, mc.num_kv_heads, mc.head_dim_
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
            self.kv_quant_tokens_written += sum(batch.chunk_lens)
        self.kv_k[:, :, flat_slots] = k_flat
        self.kv_v[:, :, flat_slots] = v_flat

        if next_tokens is None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            tokens = [[] for _ in range(b)]
        else:
            out = next_tokens.cpu().numpy()
            tokens = [[int(out[i])] if finals[i] else [] for i in range(b)]
        self.prefill_seconds_total += time.monotonic() - t_start
        return tokens

    # ---------------------------------------------------------------- execute
    def execute(self, batch: ScheduledBatch) -> List[List[int]]:
        """Run one dispatch to completion: per-sequence NEW token lists
        (empty for a non-final prefill chunk)."""
        if batch.kind == "decode":
            return self._execute_decode(batch)
        return self._execute_prefill(batch)
