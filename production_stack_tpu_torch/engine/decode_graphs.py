"""The fused K-step decode train as head / step / tail over static buffers,
the speculative draft/verify train as head / cycles (N + 1 draft steps and
a verify) / tail, and their CUDA graphs per (b, mb, K, penalties,
logprobs, speculative) family.

Counterpart of the body of ``production_stack_tpu/engine/runner.py``
``_decode_impl`` (the reference compiles the whole train as one XLA program
per family; ``warmup`` compiles every reachable family). Here the train is
three functions:

  * head: start tokens (``tokens0 = prev_last[chain_src]`` where
    ``chain_src >= 0``: chained on the device from an unapplied dispatch),
    per-step write slots, ring and step-index init, the window gather
    (window path);
  * step: one forward at position ``pos0 + j``, sample with seeds derived
    on the device from ``(seed_base, gen0 + j)``, ring write at ``j``;
    ``j`` is a device scalar the step increments, so one captured step
    serves every step of the train; the logprob variants (``lpk`` > 0)
    also write the chosen token's logprob and the top-``lpk`` logprobs and
    ids of the step's raw logits at ``j``;
  * tail: the one pool scatter of the dispatch's KV and the last-token
    vector the next dispatch may chain from.

Every tensor they read or write lives at a fixed address: the static inputs
(the packed host buffer, ``prev_last``, penalty counts) and the train's
state (rings, carried tokens, ``j``, slots, ``toks_all``, ``last``) are
views into one arena per buffer, sized for the largest reachable family
and shared by all families. That is safe because every dispatch, prefill
and decode, runs on one compute stream: a dispatch's head re-initializes
all state, and its outputs are copied out right after its tail, before the
next dispatch touches the arena. The graphs' own temporaries come from one
shared graph memory pool, for the same reason; the prefill graphs
(``engine/prefill_graphs.py``) are captured into it too, and
``graph_pool_bytes`` is the whole pool.

On the CPU (and on the card without warmup) the same three functions run
eagerly; on the card ``capture`` records one graph of each per family, and
a dispatch replays head, step (K times under ``decode_loop="scan"``, or
``max(min(budget, K))`` times under "while", a count the host knows) and
tail: the same operations on the same buffers, so the same bits. A family
that a manifest-verified warm-up deferred (``GraphArena.deferred``: the
logprob and penalty variants) is captured at its first dispatch, through
the same ``capture`` (``capture_deferred``), before its inputs are staged.

On a mesh of more than one rank (tp, sp or dp > 1) nothing is captured:
the forward's collectives (gloo, host-staged, when ranks share a card)
cannot be captured, and NCCL capture is not ported yet. Every rank runs the
train eagerly, and each decode dispatch counts in
``decode_eager_dispatches_total``.

The speculative train (``speculative_num_tokens`` N > 0; the reference's
``_decode_spec``) replaces the step with a CYCLE: N + 1 draft-model steps
from each row's last accepted token (one draft-step graph replayed N + 1
times, the step index a device scalar; its KV in the row's draft ring,
gathered from the runner's ring pools by slot in the head and scattered
back in the tail), ONE target forward over the [b, N + 1] verify chunk
(N + W nodes under the tree bias at tree width W > 1), the target's own
samples under the generation-index seed schedule, the deterministic accept
rule (``sampling.speculative_accept`` / ``speculative_tree_accept``), and
the commit of the accepted path's KV into an intra-dispatch ring that the
tail scatters to the pool once. A cycle emits 1 to N + 1 tokens per row; the
reference loops ``while cycle < K and any(budget > 0)``, which a graph
cannot hold, so ``run`` replays the first ceil(max budget / (N + 1))
cycles unconditionally (no dispatch ends sooner) and then groups of
``SPEC_GROUP`` cycles while a pinned "any budget left" flag says so. A
cycle after every row's budget is spent writes nothing but its own
(ignored) record, so the replayed count never changes a token. At dp > 1
(the one mesh speculation serves on) every replica runs the train eagerly
and takes rank 0's flag (``_spec_any_live``), so all run the same cycles.
Scatters that the reference drops (padding rows, rows at gamma 0, rejected
tail entries) land in a TRASH row or slot one past the live ones, never in
another row's entries.
"""

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.sampling import (
    apply_penalties,
    compute_logprobs,
    gumbel_noise,
    sample_tokens,
    sampling_scores,
    speculative_accept,
    speculative_tree_accept,
    token_seeds,
    top_k_like_jax,
)
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.ops.attention import gather_window
from production_stack_tpu_torch.ops.quantization import (
    SCALE_DTYPE,
    dequantize_kv,
    quantize_kv,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

POS_SENTINEL = 2**30  # ring_pos value for not-yet-written entries
# Rows of per-row int32 scalars at the head of a dispatch's packed host
# buffer (the reference's layout, floats and uint32 bitcast). Decode:
# 0 tokens0, 1 pos0, 2 budget, 3 seed_base, 4 gen0, 5 temperature,
# 6 top_k, 7 top_p, 8 adapter, 9 presence, 10 frequency, 11 chain_src,
# 12 the row's draft-ring slot (the trash slot for padding rows), 13 its
# draft depth gamma in [0, N] (12 and 13 are read by the speculative train
# only). Row 8 is the row's LoRA adapter index (0 = the base model, and
# every padding row): the step and the verify read it on the device, and
# the registry's stacks are static tensors of the runner, so one captured
# graph serves any mix of adapters and the family key does not name them.
NUM_SCALARS = 14
# Cycles the speculative train replays between two reads of its "any
# budget left" flag, once no row can have finished.
SPEC_GROUP = 2

# (b, mb, K, has_penalties, logprobs bucket (0 = no logprobs), speculative)
FamilyKey = Tuple[int, int, int, bool, int, bool]


@dataclass
class DecodeBuffers:
    """One family's views into the arena (see the module docstring)."""
    b: int
    mb: int
    k: int
    packed: torch.Tensor        # int32 [NUM_SCALARS*b + b*mb] (input)
    prev_last: torch.Tensor     # int32 [b_max] (input: chain source)
    counts: Optional[torch.Tensor]  # int32 [b, V] (input, penalty variant)
    toks: torch.Tensor          # int32 [b] carried token
    j: torch.Tensor             # int64 [1] step index
    slots: torch.Tensor         # int64 [K*b] write slot per (step, row)
    ring_k: torch.Tensor        # [L, Hkv, b, K, Dh] compute dtype
    ring_v: torch.Tensor
    ring_pos: torch.Tensor      # int32 [b, K]
    ring_q: Optional[Tuple[torch.Tensor, ...]]  # int8 k, v; scales k, v
    win: Optional[Tuple[torch.Tensor, torch.Tensor]]  # window path
    toks_all: torch.Tensor      # int32 [K, b] (output)
    last: torch.Tensor          # int32 [b_max] (output)
    lpk: int = 0
    # Logprob variants (lpk > 0), outputs: the chosen token's logprob
    # f32 [K, b], the top-lpk logprobs f32 [K, b, lpk] and ids int32.
    lp_chosen: Optional[torch.Tensor] = None
    lp_top: Optional[torch.Tensor] = None
    lp_ids: Optional[torch.Tensor] = None


@dataclass
class SpecBuffers:
    """One speculative family's views into the arena. Rings carry one row
    past the batch (index b), the trash of masked scatters."""
    b: int
    mb: int
    k: int
    packed: torch.Tensor        # int32 [NUM_SCALARS*b + b*mb] (input)
    counts: Optional[torch.Tensor]  # int32 [b, V] (input; carried)
    toks: torch.Tensor          # int32 [b] last accepted token
    pos: torch.Tensor           # int32 [b] next position
    gen_off: torch.Tensor       # int64 [b] tokens emitted this dispatch
    rem: torch.Tensor           # int32 [b] budget left
    base: torch.Tensor          # int32 [b] next intra-dispatch ring entry
    j: torch.Tensor             # int64 [1] cycle index
    i: torch.Tensor             # int64 [1] draft step index in the cycle
    dtok: torch.Tensor          # int32 [b] the draft step's input token
    props: torch.Tensor         # int32 [b, N+1] the cycle's draft samples
    l1: Optional[torch.Tensor]  # f32 [b, V] step 0's sampling field (tree)
    flag: torch.Tensor          # int32 [1] any row with budget left
    ring_k: torch.Tensor        # [L, Hkv, b+1, K+N+1, Dh] target KV
    ring_v: torch.Tensor
    ring_pos: torch.Tensor      # int32 [b+1, K+N+1]
    dr_k: torch.Tensor          # [Ld, Hd, b+1, R, Dd] draft rings
    dr_v: torch.Tensor
    dr_pos: torch.Tensor        # int32 [b+1, R]
    win: Tuple[torch.Tensor, torch.Tensor]
    stats: torch.Tensor         # int32 [4, b] drafts, accepted, tree nodes,
    #                             live cycles (output)
    toks_all: torch.Tensor      # int32 [K, N+1, b] verify samples (output)
    emits: torch.Tensor         # int32 [K, b] tokens emitted per cycle
    last: torch.Tensor          # int32 [b_max] (output)
    lpk: int = 0
    lp_chosen: Optional[torch.Tensor] = None   # f32 [K, N+1, b]
    lp_top: Optional[torch.Tensor] = None      # f32 [K, N+1, b, lpk]
    lp_ids: Optional[torch.Tensor] = None      # int32 [K, N+1, b, lpk]


@dataclass
class FamilyGraphs:
    """The graphs of one family (head, step, tail; speculative: head,
    draft, verify, tail) and their node counts."""
    graphs: Dict[str, "torch.cuda.CUDAGraph"] = field(default_factory=dict)
    nodes: Dict[str, int] = field(default_factory=dict)


class GraphArena:
    """One arena tensor per named buffer, whose families' buffers are views
    at its start (see the module docstring), and the graphs captured over
    it: the base of the decode train and of the prefill train
    (``engine/prefill_graphs.py``). A subclass's ``buffers(*key)`` makes a
    family's views."""

    def __init__(self, runner):
        self.r = runner
        self._arena: Dict[str, torch.Tensor] = {}
        self.graphs: Dict = {}
        # Keys a manifest-verified warm-up left to their first dispatch
        # (``capture_deferred``, from the runner's ``_first_use``).
        self.deferred: set = set()

    def _view(self, name: str, shape, dtype) -> torch.Tensor:
        """A view of ``shape`` at the start of arena ``name``. The arena
        grows until graphs are captured; after that, a family larger than
        it gets a tensor of its own (its dispatch runs eagerly)."""
        n = 1
        for s in shape:
            n *= s
        buf = self._arena.get(name)
        if buf is None or buf.numel() < n:
            fresh = torch.empty((n,), dtype=dtype, device=self.r.device)
            if self.graphs:
                return fresh.view(shape)
            self._arena[name] = buf = fresh
        return buf[:n].view(shape)

    def reserve(self, keys) -> None:
        """Grow the arena to the largest of ``keys`` before any capture
        (a captured graph holds the arena's addresses)."""
        for key in keys:
            self.buffers(*key)


class DecodeTrain(GraphArena):
    """Runs a decode dispatch's train for one ModelRunner: eagerly, or by
    replaying the graphs ``capture`` recorded for its family."""

    def __init__(self, runner):
        super().__init__(runner)
        mc = runner.model_config
        self.b_max = runner.b_max
        self._shapes = (mc.num_layers, runner.local_kv_heads, mc.head_dim_)
        self.graphs: Dict[FamilyKey, FamilyGraphs] = {}
        self.pool = None
        self.capture_seconds = 0.0
        # The shared graph pool's bytes (prefill captures add theirs).
        self.pool_bytes = 0
        # The graph pool's growth while the logprob variants were captured.
        self.pool_bytes_logprobs = 0
        # Decode dispatches that ran the train eagerly on the card (no
        # warmup, or a family outside the captured set, e.g. a penalty
        # batch at b > 1), and those that replayed graphs.
        self.eager_dispatches_total = 0
        self.graph_dispatches_total = 0
        # Speculative cycles run (replayed or eager), over all dispatches.
        self.spec_cycles_total = 0
        self._flag_host = None      # pinned int32 [1]: the cycle flag read
        self._flag_event = None
        self._stream = None         # the capture stream
        self._warned: set = set()

    # ------------------------------------------------------------ buffers
    def buffers(self, b: int, mb: int, k: int, pen: bool,
                lpk: int = 0, spec: bool = False):
        """The family's buffers: ``DecodeBuffers``, or ``SpecBuffers`` for a
        speculative family."""
        if spec:
            return self._spec_buffers(b, mb, k, pen, lpk)
        r = self.r
        nl, hkv, dh = self._shapes
        ring = (nl, hkv, b, k, dh)
        quant = r.kv_quantized
        return DecodeBuffers(
            b=b, mb=mb, k=k,
            packed=self._view("packed", (NUM_SCALARS * b + b * mb,),
                              torch.int32),
            prev_last=self._view("prev_last", (self.b_max,), torch.int32),
            counts=(self._view("counts", (b, r.model_config.vocab_size),
                               torch.int32) if pen else None),
            toks=self._view("toks", (b,), torch.int32),
            j=self._view("j", (1,), torch.int64),
            slots=self._view("slots", (k * b,), torch.int64),
            ring_k=self._view("ring_k", ring, r.dtype),
            ring_v=self._view("ring_v", ring, r.dtype),
            ring_pos=self._view("ring_pos", (b, k), torch.int32),
            ring_q=((self._view("ring_qk", ring, torch.int8),
                     self._view("ring_qv", ring, torch.int8),
                     self._view("ring_sk", ring[:-1], SCALE_DTYPE),
                     self._view("ring_sv", ring[:-1], SCALE_DTYPE))
                    if quant else None),
            win=((self._view("win_k", (nl, hkv, b, mb * r.config.block_size,
                                       dh), r.dtype),
                  self._view("win_v", (nl, hkv, b, mb * r.config.block_size,
                                       dh), r.dtype))
                 if r.attn_impl == "window" else None),
            toks_all=self._view("toks_all", (k, b), torch.int32),
            last=self._view("last", (self.b_max,), torch.int32),
            lpk=lpk,
            lp_chosen=(self._view("lp_chosen", (k, b), torch.float32)
                       if lpk else None),
            lp_top=(self._view("lp_top", (k, b, lpk), torch.float32)
                    if lpk else None),
            lp_ids=(self._view("lp_ids", (k, b, lpk), torch.int32)
                    if lpk else None),
        )

    def _spec_buffers(self, b: int, mb: int, k: int, pen: bool,
                      lpk: int) -> SpecBuffers:
        r = self.r
        nl, hkv, dh = self._shapes
        dmc = r.spec_draft_config
        n1 = r.spec_n + 1
        s_ring = k + n1
        r_len = r.spec_ring_len
        dring = (dmc.num_layers, dmc.num_kv_heads, b + 1, r_len, dmc.head_dim_)
        win = (nl, hkv, b, mb * r.config.block_size, dh)

        def i32(name, *shape):
            return self._view(name, shape, torch.int32)

        return SpecBuffers(
            b=b, mb=mb, k=k,
            packed=i32("packed", NUM_SCALARS * b + b * mb),
            counts=(i32("counts", b, r.model_config.vocab_size)
                    if pen else None),
            toks=i32("toks", b), pos=i32("s_pos", b),
            gen_off=self._view("s_gen_off", (b,), torch.int64),
            rem=i32("s_rem", b), base=i32("s_base", b),
            j=self._view("j", (1,), torch.int64),
            i=self._view("s_i", (1,), torch.int64),
            dtok=i32("s_dtok", b), props=i32("s_props", b, n1),
            l1=(self._view("s_l1", (b, r.model_config.vocab_size),
                           torch.float32) if r.spec_tree_width > 1 else None),
            flag=i32("s_flag", 1),
            ring_k=self._view("s_ring_k", (nl, hkv, b + 1, s_ring, dh), r.dtype),
            ring_v=self._view("s_ring_v", (nl, hkv, b + 1, s_ring, dh), r.dtype),
            ring_pos=i32("s_ring_pos", b + 1, s_ring),
            dr_k=self._view("s_dr_k", dring, r.dtype),
            dr_v=self._view("s_dr_v", dring, r.dtype),
            dr_pos=i32("s_dr_pos", b + 1, r_len),
            win=(self._view("win_k", win, r.dtype),
                 self._view("win_v", win, r.dtype)),
            stats=i32("s_stats", 4, b),
            toks_all=i32("s_toks_all", k, n1, b),
            emits=i32("s_emits", k, b),
            last=i32("last", self.b_max),
            lpk=lpk,
            lp_chosen=(self._view("s_lp_chosen", (k, n1, b), torch.float32)
                       if lpk else None),
            lp_top=(self._view("s_lp_top", (k, n1, b, lpk), torch.float32)
                    if lpk else None),
            lp_ids=i32("s_lp_ids", k, n1, b, lpk) if lpk else None,
        )

    @staticmethod
    def _scalars(bf) -> torch.Tensor:
        return bf.packed[:NUM_SCALARS * bf.b].view(NUM_SCALARS, bf.b)

    # ---------------------------------------------------- head/step/tail
    def head(self, bf: DecodeBuffers) -> None:
        """Start tokens, write slots, state init, window gather."""
        r = self.r
        bs = r.config.block_size
        sc = self._scalars(bf)
        tokens0, pos0, budget, chain_src = sc[0], sc[1], sc[2], sc[11]
        tables = bf.packed[NUM_SCALARS * bf.b:].view(bf.b, bf.mb)
        src = torch.clamp(chain_src, 0, self.b_max - 1).long()
        bf.toks.copy_(torch.where(chain_src >= 0, bf.prev_last[src], tokens0))
        # Per-step write slots [K, b] (0 = the null block for steps past a
        # row's budget), flattened step-major for the tail's scatter.
        k_iota = torch.arange(bf.k, dtype=torch.int32, device=r.device)
        p = pos0[None, :] + k_iota[:, None]
        blk_idx = torch.clamp(p // bs, 0, bf.mb - 1)
        blk = torch.gather(tables, 1, blk_idx.t().long()).t()
        valid = k_iota[:, None] < budget[None, :]
        bf.slots.copy_(torch.where(valid, blk * bs + p % bs,
                                   torch.zeros_like(blk)).reshape(-1))
        bf.ring_k.zero_()
        bf.ring_v.zero_()
        bf.ring_pos.fill_(POS_SENTINEL)
        if bf.ring_q is not None:
            for t in bf.ring_q:
                t.zero_()
        bf.j.zero_()
        bf.toks_all.zero_()
        if bf.lpk:
            bf.lp_chosen.zero_()
            bf.lp_top.zero_()
            bf.lp_ids.zero_()
        if bf.win is not None:
            wk, wv = gather_window(r.kv_k, r.kv_v, tables, bs, r.kv_k_scale,
                                   r.kv_v_scale, out_dtype=r.dtype)
            bf.win[0].copy_(wk)
            bf.win[1].copy_(wv)

    def step(self, bf: DecodeBuffers) -> None:
        """One fused step: forward, sample, ring write, j += 1."""
        r, mc = self.r, self.r.model_config
        sc = self._scalars(bf)
        pos0, budget = sc[1], sc[2]
        temps = sc[5].view(torch.float32)
        top_k = sc[6]
        top_p = sc[7].view(torch.float32)
        tables = bf.packed[NUM_SCALARS * bf.b:].view(bf.b, bf.mb)
        j = bf.j
        positions = torch.clamp(pos0.long() + j,
                                max=r.config.max_model_len - 1).int()[:, None]
        if bf.win is None:
            win_k = win_v = win_len = None
            paged = (r.kv_k, r.kv_v, r.kv_k_scale, r.kv_v_scale, tables, pos0,
                     r.config.block_size)
        else:
            (win_k, win_v), win_len, paged = bf.win, pos0, None
        ones = torch.ones((bf.b,), dtype=torch.int32, device=r.device)
        hidden, k_new, v_new = r.model_forward(
            r.params, mc, bf.toks[:, None], positions, ones, win_k, win_v,
            win_len, bf.ring_k, bf.ring_v, bf.ring_pos, paged=paged, tp=r.tp,
            lora=r.lora_of(sc),
        )
        logits = r.model_logits(r.params, mc, hidden[:, 0], r.head_f32,
                                tp=r.tp)
        if r.logits_sink is not None:
            r.logits_sink.append(logits.clone())
        eff = logits
        if bf.counts is not None:
            eff = apply_penalties(logits, bf.counts, sc[9].view(torch.float32),
                                  sc[10].view(torch.float32))
        seeds = token_seeds(sc[3], sc[4].long() + j)
        gumbel = gumbel_noise(seeds, logits.shape[1], r.device, rows=temps > 0.0)
        nxt = sample_tokens(eff, temps, top_k, top_p, gumbel).int()
        if bf.counts is not None:
            rows = torch.arange(bf.b, device=r.device)
            bf.counts[rows, nxt.long()] += 1
        if bf.lpk:
            # From the raw logits: sampling above read the same tensor.
            chosen_lp, top_lp, top_ids = compute_logprobs(logits, nxt, bf.lpk)
            bf.lp_chosen.index_copy_(0, j, chosen_lp[None])
            bf.lp_top.index_copy_(0, j, top_lp[None])
            bf.lp_ids.index_copy_(0, j, top_ids[None])
        if bf.ring_q is not None:
            # Later steps attend to what later dispatches reconstruct from
            # the pool; this step's own token attended to itself
            # unquantized inside the forward.
            qk, sk = quantize_kv(k_new)
            qv, sv = quantize_kv(v_new)
            k_new = dequantize_kv(qk, sk, r.dtype)
            v_new = dequantize_kv(qv, sv, r.dtype)
            ring_qk, ring_qv, ring_sk, ring_sv = bf.ring_q
            ring_qk.index_copy_(3, j, qk)
            ring_qv.index_copy_(3, j, qv)
            ring_sk.index_copy_(3, j, sk)
            ring_sv.index_copy_(3, j, sv)
        bf.ring_k.index_copy_(3, j, k_new)
        bf.ring_v.index_copy_(3, j, v_new)
        bf.ring_pos.index_copy_(1, j, positions)
        # The carried token freezes at each row's step budget: after the
        # last step it is the row's last valid token, the chain source.
        bf.toks.copy_(torch.where(j < budget, nxt, bf.toks))
        bf.toks_all.index_copy_(0, j, nxt[None])
        j.add_(1)

    def tail(self, bf: DecodeBuffers) -> None:
        """ONE scatter of the dispatch's KV into the pool (int8: the
        payload and scales the steps recorded), and the last-token
        vector."""
        r = self.r
        nl, hkv, _ = self._shapes
        n = bf.k * bf.b

        def steps_major(ring):
            return ring.transpose(2, 3).reshape(nl, hkv, n, *ring.shape[4:])

        if bf.ring_q is not None:
            ring_qk, ring_qv, ring_sk, ring_sv = bf.ring_q
            r.kv_k[:, :, bf.slots] = steps_major(ring_qk)
            r.kv_v[:, :, bf.slots] = steps_major(ring_qv)
            r.kv_k_scale[:, :, bf.slots] = steps_major(ring_sk)
            r.kv_v_scale[:, :, bf.slots] = steps_major(ring_sv)
        else:
            r.kv_k[:, :, bf.slots] = steps_major(bf.ring_k)
            r.kv_v[:, :, bf.slots] = steps_major(bf.ring_v)
        bf.last.zero_()
        bf.last[:bf.b].copy_(bf.toks)

    # ------------------------------------ speculative head / cycle / tail
    def spec_head(self, bf: SpecBuffers) -> None:
        """Cycle state from the packed scalars, the rows' draft rings
        gathered from the runner's ring pools by slot (padding rows read a
        live slot harmlessly; their writes go to the trash), the window."""
        r = self.r
        bs = r.config.block_size
        sc = self._scalars(bf)
        tables = bf.packed[NUM_SCALARS * bf.b:].view(bf.b, bf.mb)
        bf.toks.copy_(sc[0])
        bf.pos.copy_(sc[1])
        bf.rem.copy_(sc[2])
        bf.gen_off.zero_()
        bf.base.zero_()
        bf.j.zero_()
        bf.i.zero_()
        bf.dtok.copy_(sc[0])
        bf.props.zero_()
        if bf.l1 is not None:
            bf.l1.zero_()
        bf.ring_k.zero_()
        bf.ring_v.zero_()
        bf.ring_pos.fill_(POS_SENTINEL)
        slot_c = torch.clamp(sc[12], 0, r.spec_num_slots - 1).long()
        bf.dr_k[:, :, :bf.b].copy_(r.spec_k[:, :, slot_c])
        bf.dr_v[:, :, :bf.b].copy_(r.spec_v[:, :, slot_c])
        bf.dr_pos[:bf.b].copy_(r.spec_pos[slot_c])
        bf.stats.zero_()
        bf.toks_all.zero_()
        bf.emits.zero_()
        if bf.lpk:
            bf.lp_chosen.zero_()
            bf.lp_top.zero_()
            bf.lp_ids.zero_()
        wk, wv = gather_window(r.kv_k, r.kv_v, tables, bs, None, None,
                               out_dtype=r.dtype)
        bf.win[0].copy_(wk)
        bf.win[1].copy_(wv)
        bf.flag.copy_((bf.rem > 0).any().int()[None])

    def spec_cycle(self, bf: SpecBuffers) -> None:
        """One draft / verify / accept cycle (the body of the reference's
        ``_decode_spec`` while loop): N + 1 draft steps, then the verify.
        Captured as two graphs, the draft step replayed N + 1 times."""
        for _ in range(self.r.spec_n + 1):
            self.spec_draft_step(bf)
        self.spec_verify(bf)

    def _spec_row_state(self, bf: SpecBuffers):
        """(scalars, seed bases, gen index of the cycle's first token,
        temperatures, top-k, top-p, gamma, gamma > 0, sampled rows, live
        rows) of the cycle."""
        sc = self._scalars(bf)
        gamma = torch.clamp(sc[13], 0, self.r.spec_n)
        temps = sc[5].view(torch.float32)
        return (sc, sc[3], (sc[4].long() & 0xFFFFFFFF) + bf.gen_off, temps,
                sc[6], sc[7].view(torch.float32), gamma, gamma > 0,
                temps > 0.0, bf.rem > 0)

    def spec_draft_step(self, bf: SpecBuffers) -> None:
        """Draft step i of the cycle (i a device scalar, so one captured
        graph serves every step): one draft-model token from ``dtok`` at
        position pos + i into the row's draft ring, sampled with the seed
        the target uses at that generation index (common random numbers);
        step 0 also keeps its sampling field (the tree's alternates)."""
        r, dmc = self.r, self.r.spec_draft_config
        dev = r.device
        b = bf.b
        _, seed_b, gen, temps, top_k, top_p, _, g_on, sampled, live = \
            self._spec_row_state(bf)
        r_len = r.spec_ring_len
        i = bf.i
        dpos = (bf.pos + i).int()
        dpos_c = torch.clamp(dpos, 0, r.spec_draft_max_pos - 1)
        ones = torch.ones((b,), dtype=torch.int32, device=dev)
        hid, dk, dv = r.draft_forward(
            r.spec_params, dmc, bf.dtok[:, None], dpos_c[:, None], ones,
            None, None, None, bf.dr_k[:, :, :b], bf.dr_v[:, :, :b],
            bf.dr_pos[:b])
        # gamma-0 rows and spent rows leave their draft ring untouched.
        iota_b = torch.arange(b, device=dev)
        widx = torch.where(live & g_on, iota_b * r_len + dpos % r_len,
                           b * r_len)
        bf.dr_k.view(*bf.dr_k.shape[:2], -1, bf.dr_k.shape[-1]).index_copy_(
            2, widx, dk[:, :, :, 0])
        bf.dr_v.view(*bf.dr_v.shape[:2], -1, bf.dr_v.shape[-1]).index_copy_(
            2, widx, dv[:, :, :, 0])
        bf.dr_pos.view(-1).index_copy_(0, widx, dpos)
        logits_d = r.draft_logits(r.spec_params, dmc, hid[:, 0],
                                  r.spec_head_f32)
        gumbel = gumbel_noise(token_seeds(seed_b, gen + i),
                              r.model_config.vocab_size, dev, rows=sampled)
        prop = sample_tokens(logits_d, temps, top_k, top_p, gumbel).int()
        bf.props.index_copy_(1, i, prop[:, None])
        if bf.l1 is not None:
            # The runner-ups of the field the sampler argmaxes: the tree's
            # depth-1 alternates.
            bf.l1.copy_(torch.where(i == 0, sampling_scores(
                logits_d, temps, gumbel), bf.l1))
        bf.dtok.copy_(prop)
        i.add_(1)

    def spec_verify(self, bf: SpecBuffers) -> None:
        """The cycle's one target forward over the verify chunk, the
        target's samples, the accept rule, the commit of the accepted path,
        the draft-ring rollback; then j += 1 and the next cycle's draft
        starts from the last accepted token."""
        r, mc = self.r, self.r.model_config
        dev = r.device
        b, n, tw = bf.b, r.spec_n, r.spec_tree_width
        n1 = n + 1
        vocab = mc.vocab_size
        sc, seed_b, gen, temps, top_k, top_p, gamma, g_on, sampled, live = \
            self._spec_row_state(bf)
        presence = sc[9].view(torch.float32)
        frequency = sc[10].view(torch.float32)
        iota_b = torch.arange(b, device=dev)
        iota_n1 = torch.arange(n1, device=dev)
        r_len = r.spec_ring_len
        s_ring = bf.ring_pos.shape[1]
        props_t = bf.props
        l1 = bf.l1

        # One target forward over the verify chunk.
        if tw > 1:
            l1 = l1.scatter(1, props_t[:, :1].long(),
                            torch.full((b, 1), float("-inf"), device=dev))
            alt_idx = top_k_like_jax(l1, tw - 1)[1].int()        # [b, W-1]
            v_toks = torch.cat([bf.toks[:, None], props_t[:, :1], alt_idx,
                                props_t[:, 1:n]], dim=1)         # [b, T_v]
            node_gen = r.spec_tree_depths_dev
            chunk_bias = r.spec_tree_bias
        else:
            v_toks = torch.cat([bf.toks[:, None], props_t[:, :n]], dim=1)
            node_gen = iota_n1
            chunk_bias = None
        t_v = v_toks.shape[1]
        v_pos = bf.pos[:, None] + node_gen[None, :].int()
        v_pos_c = torch.clamp(v_pos, max=r.config.max_model_len - 1)
        full = torch.full((b,), t_v, dtype=torch.int32, device=dev)
        hid, k_new, v_new = r.model_forward(
            r.params, mc, v_toks, v_pos_c, full, bf.win[0], bf.win[1],
            sc[1], bf.ring_k[:, :, :b], bf.ring_v[:, :, :b],
            bf.ring_pos[:b], chunk_bias=chunk_bias, lora=r.lora_of(sc))
        logits = r.model_logits(r.params, mc, hid, r.head_f32)  # [b, T_v, V]
        seeds = token_seeds(seed_b[:, None], (gen[:, None]
                                              + node_gen[None, :]))
        if bf.counts is not None:
            # Sequential over the main chain: position i's penalties count
            # this cycle's earlier samples, as the one-token scan would.
            chain = r.spec_main_chain.tolist() if tw > 1 else range(n1)
            cnt = bf.counts.clone()
            z_main = []
            for c in chain:
                eff = apply_penalties(logits[:, c], cnt, presence, frequency)
                g = gumbel_noise(seeds[:, c], vocab, dev, rows=sampled)
                zi = sample_tokens(eff, temps, top_k, top_p, g).int()
                cnt[iota_b, zi.long()] += 1
                z_main.append(zi)
            z_main = torch.stack(z_main, dim=1)
            if tw > 1:
                # An alternate's only penalty delta is its own depth-0
                # emission.
                z = torch.zeros((b, t_v), dtype=torch.int32, device=dev)
                z[:, r.spec_main_chain_dev] = z_main
                for a in range(2, tw + 1):
                    cnt_a = bf.counts.clone()
                    cnt_a[iota_b, v_toks[:, a].long()] += 1
                    eff_a = apply_penalties(logits[:, a], cnt_a, presence,
                                            frequency)
                    g = gumbel_noise(seeds[:, a], vocab, dev, rows=sampled)
                    z[:, a] = sample_tokens(eff_a, temps, top_k, top_p,
                                            g).int()
            else:
                z = z_main
        else:
            def rep(x):  # each row's value once per chunk node
                return x[:, None].expand(b, t_v).reshape(-1)

            g = gumbel_noise(seeds.reshape(-1), vocab, dev, rows=rep(sampled))
            z = sample_tokens(logits.reshape(b * t_v, vocab), rep(temps),
                              rep(top_k), rep(top_p), g).view(b, t_v).int()

        # Accept and emit.
        if tw > 1:
            emit, acc, path_idx, main_len = speculative_tree_accept(
                v_toks, z, r.spec_tree_parents, r.spec_tree_depths,
                bf.rem, gamma)
            z_path = torch.gather(z, 1, path_idx)
            kidx = path_idx[None, None, :, :, None].expand(
                k_new.shape[0], k_new.shape[1], b, n1, k_new.shape[-1])
            k_path = torch.gather(k_new, 3, kidx)
            v_path = torch.gather(v_new, 3, kidx)
        else:
            emit, acc = speculative_accept(props_t[:, :n], z, bf.rem,
                                           gamma=gamma)
            path_idx = iota_n1[None, :].expand(b, n1)
            main_len = emit
            z_path, k_path, v_path = z, k_new, v_new
        c_pos = bf.pos[:, None] + iota_n1[None, :].int()        # [b, N+1]
        valid_i = iota_n1[None, :] < emit[:, None]
        if bf.counts is not None:
            rows = iota_b[:, None].expand(b, n1)
            bf.counts.index_put_((rows, z_path.long()), valid_i.int(),
                                 accumulate=True)
        if bf.lpk:
            logits_path = (torch.gather(logits, 1, path_idx[:, :, None].expand(
                b, n1, vocab)) if tw > 1 else logits)
            lp_c, lp_t, lp_i = compute_logprobs(
                logits_path.reshape(b * n1, vocab), z_path.reshape(-1), bf.lpk)
            bf.lp_chosen.index_copy_(0, bf.j, lp_c.view(b, n1).t()[None])
            bf.lp_top.index_copy_(
                0, bf.j, lp_t.view(b, n1, bf.lpk).transpose(0, 1)[None])
            bf.lp_ids.index_copy_(
                0, bf.j, lp_i.view(b, n1, bf.lpk).transpose(0, 1)[None])

        # Commit the accepted path's target KV at [base, base + emit) of
        # the intra-dispatch ring; the rest goes to the trash row.
        nl, hkv, dh = self._shapes
        flat_r = torch.where(valid_i, iota_b[:, None] * s_ring
                             + bf.base[:, None] + iota_n1[None, :],
                             b * s_ring).reshape(-1)
        rk_flat = bf.ring_k.view(nl, hkv, -1, dh)
        rv_flat = bf.ring_v.view(nl, hkv, -1, dh)
        rk_flat.index_copy_(2, flat_r, k_path.reshape(nl, hkv, b * n1, dh))
        rv_flat.index_copy_(2, flat_r, v_path.reshape(nl, hkv, b * n1, dh))
        bf.ring_pos.view(-1).index_copy_(0, flat_r, c_pos.reshape(-1))

        # Draft-ring rollback: entries written from a token the target did
        # not emit are masked; gamma-0 rows wrote nothing.
        inval = ((iota_n1[None, :] >= main_len[:, None])
                 & live[:, None] & g_on[:, None])
        rb_idx = torch.where(inval, iota_b[:, None] * r_len + c_pos % r_len,
                             b * r_len).reshape(-1)
        bf.dr_pos.view(-1).index_fill_(0, rb_idx, POS_SENTINEL)

        new_tok = torch.gather(z_path, 1,
                               torch.clamp(emit - 1, 0, n)[:, None].long())[:, 0]
        bf.toks.copy_(torch.where(emit > 0, new_tok, bf.toks))
        bf.pos.add_(emit)
        bf.gen_off.add_(emit)
        bf.base.add_(emit)
        bf.rem.sub_(emit)
        zero = torch.zeros_like(gamma)
        bf.stats[0].add_(torch.where(live, gamma, zero))
        bf.stats[1].add_(torch.where(live, acc, zero))
        bf.stats[2].add_(torch.where(live & g_on, tw - 1 + gamma, zero))
        bf.stats[3].add_(live.int())
        bf.toks_all.index_copy_(0, bf.j, z_path.t()[None])
        bf.emits.index_copy_(0, bf.j, emit[None])
        bf.j.add_(1)
        bf.i.zero_()
        bf.dtok.copy_(bf.toks)
        bf.flag.copy_((bf.rem > 0).any().int()[None])

    def spec_tail(self, bf: SpecBuffers) -> None:
        """ONE pool scatter of the committed target KV (slots from the
        ring's positions; uncommitted entries to the null block), the draft
        rings back to their slots (padding rows to the trash slot), the
        last-token vector."""
        r = self.r
        bs = r.config.block_size
        nl, hkv, dh = self._shapes
        b = bf.b
        sc = self._scalars(bf)
        tables = bf.packed[NUM_SCALARS * b:].view(b, bf.mb)
        ring_pos = bf.ring_pos[:b]
        valid = ring_pos < POS_SENTINEL
        blk = torch.gather(tables, 1,
                           torch.clamp(ring_pos // bs, 0, bf.mb - 1).long())
        slots = torch.where(valid, blk * bs + ring_pos % bs,
                            torch.zeros_like(blk)).reshape(-1).long()
        r.kv_k[:, :, slots] = bf.ring_k[:, :, :b].reshape(nl, hkv, -1, dh)
        r.kv_v[:, :, slots] = bf.ring_v[:, :, :b].reshape(nl, hkv, -1, dh)
        slot_idx = sc[12].long()
        r.spec_k.index_copy_(2, slot_idx, bf.dr_k[:, :, :b])
        r.spec_v.index_copy_(2, slot_idx, bf.dr_v[:, :, :b])
        r.spec_pos.index_copy_(0, slot_idx, bf.dr_pos[:b])
        bf.last.zero_()
        bf.last[:b].copy_(bf.toks)

    def _spec_any_live(self, bf: SpecBuffers) -> bool:
        """Whether a budget is left: rank 0's read of the cycle flag
        (pinned, one event wait). On a mesh rank 0 broadcasts it on the
        descriptor group and the other ranks take it instead of their own,
        so every replica runs exactly rank 0's cycles."""
        m = self.r.mesh
        if m is not None and m.rank != 0:
            flag = torch.zeros((1,), dtype=torch.int64)
            m.bcast(flag)
            return bool(flag[0])
        live = self._read_flag(bf)
        if m is not None:
            m.bcast(torch.tensor([int(live)], dtype=torch.int64))
        return live

    def _read_flag(self, bf: SpecBuffers) -> bool:
        """This rank's own read of the flag."""
        if self.r.device.type != "cuda":
            return bool(bf.flag.item())
        if self._flag_host is None:
            self._flag_host = torch.empty((1,), dtype=torch.int32,
                                          pin_memory=True)
            self._flag_event = torch.cuda.Event()
        self._flag_host.copy_(bf.flag, non_blocking=True)
        self._flag_event.record()
        self._flag_event.synchronize()
        return bool(self._flag_host[0])

    def _run_spec(self, fns, bf: SpecBuffers, max_cycles: int) -> int:
        """head, the cycles, tail; returns the cycles run. No row finishes
        before ceil(max budget / (N + 1)) cycles; after those, groups of
        SPEC_GROUP while the flag says a budget is left, at most
        ``max_cycles`` (the largest budget: every live cycle emits)."""
        head, cycle, tail = fns
        head()
        first = min(max_cycles, math.ceil(max_cycles / (self.r.spec_n + 1)))
        done = 0
        for _ in range(first):
            cycle()
        done = first
        while done < max_cycles and self._spec_any_live(bf):
            for _ in range(min(SPEC_GROUP, max_cycles - done)):
                cycle()
                done += 1
        tail()
        self.spec_cycles_total += done
        return done

    # -------------------------------------------------------------- run
    def run(self, key: FamilyKey, bf, n_steps: int):
        """The train of one dispatch on the current stream: the family's
        graphs when captured, else eagerly. ``n_steps``: the plain train's
        steps, or the speculative train's cycle bound (the largest row
        budget). Returns whether it replayed (plain) or the cycles run
        (speculative)."""
        fam = self.graphs.get(key)
        spec = key[5]
        if fam is None:
            if self.r.device.type == "cuda":
                self.eager_dispatches_total += 1
                if self.graphs and key not in self._warned:
                    self._warned.add(key)
                    logger.warning(
                        "decode family (b, mb, K, penalties, logprobs, "
                        "speculative)=%s was not captured: its dispatches "
                        "run eagerly", key)
            if spec:
                return self._run_spec(
                    (lambda: self.spec_head(bf), lambda: self.spec_cycle(bf),
                     lambda: self.spec_tail(bf)), bf, n_steps)
            self.head(bf)
            for _ in range(n_steps):
                self.step(bf)
            self.tail(bf)
            return False
        g = fam.graphs
        self.graph_dispatches_total += 1
        if spec:
            def cycle():
                for _ in range(self.r.spec_n + 1):
                    g["draft"].replay()
                g["verify"].replay()

            return self._run_spec((g["head"].replay, cycle, g["tail"].replay),
                                  bf, n_steps)
        g["head"].replay()
        for _ in range(n_steps):
            g["step"].replay()
        g["tail"].replay()
        return True

    def dummy_dispatch(self, key: FamilyKey):
        """The warm-up dispatch of a family: all-zero inputs, so every row
        has budget 0 and table 0 and the train writes only the null block
        (pool contents survive; a speculative family's rows name the trash
        slot). One step or cycle, as a capture needs."""
        bf = self.buffers(*key)
        bf.packed.zero_()
        if bf.counts is not None:
            bf.counts.zero_()
        if key[5]:
            self._scalars(bf)[12].fill_(self.r.spec_num_slots)
            self.spec_head(bf)
            self.spec_cycle(bf)
            self.spec_tail(bf)
            return bf
        bf.prev_last.zero_()
        self.head(bf)
        self.step(bf)
        self.tail(bf)
        return bf

    def capture_deferred(self, key: FamilyKey) -> None:
        """Warm-up's path for one deferred family, at its first dispatch,
        before that dispatch stages anything: its capture on the card (a
        dummy dispatch on the capture stream, then the graphs, into the
        shared pool), its dummy dispatch on the CPU."""
        if self.r.device.type == "cuda":
            self.capture([key])
        else:
            self.dummy_dispatch(key)

    def capture(self, keys: List[FamilyKey]) -> None:
        """Record head, step and tail of every family in ``keys`` as CUDA
        graphs sharing one memory pool. Each function first runs once
        eagerly on the capture stream (lazy initialization stays out of
        the graph). A failed capture raises: there is no eager fallback
        for a family that was meant to be captured. The arena must hold
        every family captured in any call (``reserve`` them all first)."""
        if self.r.mesh is not None:
            raise RuntimeError("decode graphs are not captured on a mesh "
                               "of more than one rank")
        self.reserve(keys)
        device = self.r.device
        # The graph pool's bytes: reserved memory before and after, each
        # with the allocator's unused cache released (captures release it
        # too, and the pool's own segments stay while its graphs live).
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        t0 = time.monotonic()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        stream = self._stream
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
        for key in keys:
            if key in self.graphs:
                continue  # an engine restarted: its graphs stay valid
            stream.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(stream):
                bf = self.dummy_dispatch(key)
            torch.cuda.current_stream(device).wait_stream(stream)
            fam = FamilyGraphs()
            fns = ((("head", self.spec_head), ("draft", self.spec_draft_step),
                    ("verify", self.spec_verify), ("tail", self.spec_tail))
                   if key[5] else
                   (("head", self.head), ("step", self.step),
                    ("tail", self.tail)))
            for name, fn in fns:
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                with torch.cuda.graph(graph, pool=self.pool, stream=stream):
                    fn(bf)
                fam.nodes[name] = pa.graph_node_counts(graph)[1]
                graph.instantiate()
                fam.graphs[name] = graph
            self.graphs[key] = fam
        torch.cuda.synchronize(device)
        self.capture_seconds += time.monotonic() - t0
        torch.cuda.empty_cache()
        grown = max(0, torch.cuda.memory_reserved(device) - reserved0)
        self.pool_bytes += grown
        if keys and all(key[4] for key in keys):
            self.pool_bytes_logprobs += grown
        logger.info(
            "decode graphs: %d families, %d graphs, %d nodes per step, draft "
            "or verify graph (max), %.2f s to capture, graph pool %.1f MiB",
            len(self.graphs), self._graphs_captured(), self._body_nodes_max(),
            self.capture_seconds, self.pool_bytes / 2**20)

    def _graphs_captured(self) -> int:
        return sum(len(f.graphs) for f in self.graphs.values())

    def _body_nodes_max(self, spec: Optional[bool] = None) -> int:
        """The most nodes of one graph replayed per step (plain: the step;
        speculative: the draft step or the verify), over the families of
        the kind asked for."""
        return max((n for key, f in self.graphs.items()
                    if spec is None or key[5] == spec
                    for name, n in f.nodes.items()
                    if name in ("step", "draft", "verify")), default=0)

    def stats(self) -> Dict:
        fams = self.graphs.values()
        return {
            "graph_families": len(self.graphs),
            "graph_families_spec": sum(1 for key in self.graphs if key[5]),
            "graphs_captured": self._graphs_captured(),
            "graph_nodes_total": sum(sum(f.nodes.values()) for f in fams),
            "graph_step_nodes_max": self._body_nodes_max(False),
            "graph_spec_nodes_max": self._body_nodes_max(True),
            "spec_cycles_total": self.spec_cycles_total,
            "graph_capture_seconds": self.capture_seconds,
            "graph_pool_bytes": self.pool_bytes,
            "graph_families_logprobs": sum(1 for key in self.graphs
                                           if key[4]),
            "graph_pool_bytes_logprobs": self.pool_bytes_logprobs,
            "decode_graph_dispatches_total": self.graph_dispatches_total,
            "decode_eager_dispatches_total": self.eager_dispatches_total,
        }
