"""The fused K-step decode train as head / step / tail over static buffers,
and its CUDA graphs per (b, mb, K, penalties, logprobs) family.

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
shared graph memory pool, for the same reason.

On the CPU (and on the card without warmup) the same three functions run
eagerly; on the card ``capture`` records one graph of each per family, and
a dispatch replays head, step (K times under ``decode_loop="scan"``, or
``max(min(budget, K))`` times under "while", a count the host knows) and
tail: the same operations on the same buffers, so the same bits.

At tensor_parallel_size > 1 nothing is captured: the forward's collectives
(gloo, host-staged, when ranks share a card) cannot be captured, and NCCL
capture is not ported yet. Every rank runs the train eagerly, and each
decode dispatch counts in ``decode_eager_dispatches_total``.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.sampling import (
    apply_penalties,
    compute_logprobs,
    gumbel_noise,
    sample_tokens,
    token_seeds,
)
from production_stack_tpu_torch.models import llama
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
# 12 spec slot, 13 spec gamma (8, 12 and 13 stay 0: LoRA and speculation
# are not ported).
NUM_SCALARS = 14

# (b, mb, K, has_penalties, logprobs bucket; 0 = no logprobs)
FamilyKey = Tuple[int, int, int, bool, int]


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
class FamilyGraphs:
    """The three graphs of one family and their node counts."""
    graphs: Dict[str, "torch.cuda.CUDAGraph"] = field(default_factory=dict)
    nodes: Dict[str, int] = field(default_factory=dict)


class DecodeTrain:
    """Runs a decode dispatch's train for one ModelRunner: eagerly, or by
    replaying the graphs ``capture`` recorded for its family."""

    def __init__(self, runner):
        self.r = runner
        mc = runner.model_config
        self.b_max = runner.b_max
        self._shapes = (mc.num_layers, runner.local_kv_heads, mc.head_dim_)
        self._arena: Dict[str, torch.Tensor] = {}
        self.graphs: Dict[FamilyKey, FamilyGraphs] = {}
        self.pool = None
        self.capture_seconds = 0.0
        self.pool_bytes = 0
        # The graph pool's growth while the logprob variants were captured.
        self.pool_bytes_logprobs = 0
        # Decode dispatches that ran the train eagerly on the card (no
        # warmup, or a family outside the captured set, e.g. a penalty
        # batch at b > 1), and those that replayed graphs.
        self.eager_dispatches_total = 0
        self.graph_dispatches_total = 0
        self._warned: set = set()

    # ------------------------------------------------------------ buffers
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

    def buffers(self, b: int, mb: int, k: int, pen: bool,
                lpk: int = 0) -> DecodeBuffers:
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

    @staticmethod
    def _scalars(bf: DecodeBuffers) -> torch.Tensor:
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
        hidden, k_new, v_new = llama.forward(
            r.params, mc, bf.toks[:, None], positions, ones, win_k, win_v,
            win_len, bf.ring_k, bf.ring_v, bf.ring_pos, paged=paged, tp=r.tp,
        )
        logits = llama.compute_logits(r.params, mc, hidden[:, 0], r.head_f32,
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

    # -------------------------------------------------------------- run
    def run(self, key: FamilyKey, bf: DecodeBuffers, n_steps: int) -> bool:
        """The train of one dispatch on the current stream: the family's
        graphs when captured, else eagerly. Returns whether it replayed."""
        fam = self.graphs.get(key)
        if fam is None:
            if self.r.device.type == "cuda":
                self.eager_dispatches_total += 1
                if self.graphs and key not in self._warned:
                    self._warned.add(key)
                    logger.warning(
                        "decode family (b, mb, K, penalties, logprobs)=%s "
                        "was not captured: its dispatches run eagerly", key)
            self.head(bf)
            for _ in range(n_steps):
                self.step(bf)
            self.tail(bf)
            return False
        g = fam.graphs
        g["head"].replay()
        for _ in range(n_steps):
            g["step"].replay()
        g["tail"].replay()
        self.graph_dispatches_total += 1
        return True

    def dummy_dispatch(self, key: FamilyKey) -> DecodeBuffers:
        """The warm-up dispatch of a family: all-zero inputs, so every row
        has budget 0 and table 0 and the train writes only the null block
        (pool contents survive). One step, as a capture needs."""
        bf = self.buffers(*key)
        bf.packed.zero_()
        bf.prev_last.zero_()
        if bf.counts is not None:
            bf.counts.zero_()
        self.head(bf)
        self.step(bf)
        self.tail(bf)
        return bf

    def reserve(self, keys: List[FamilyKey]) -> None:
        """Grow the arena to the largest of ``keys`` before any capture
        (a captured graph holds the arena's addresses)."""
        for key in keys:
            self.buffers(*key)

    def capture(self, keys: List[FamilyKey]) -> None:
        """Record head, step and tail of every family in ``keys`` as CUDA
        graphs sharing one memory pool. Each function first runs once
        eagerly on the capture stream (lazy initialization stays out of
        the graph). A failed capture raises: there is no eager fallback
        for a family that was meant to be captured. The arena must hold
        every family captured in any call (``reserve`` them all first)."""
        if self.r.tp is not None:
            raise RuntimeError("decode graphs are not captured at "
                               "tensor_parallel_size > 1")
        self.reserve(keys)
        device = self.r.device
        # The graph pool's bytes: reserved memory before and after, each
        # with the allocator's unused cache released (captures release it
        # too, and the pool's own segments stay while its graphs live).
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        t0 = time.monotonic()
        stream = torch.cuda.Stream(device)
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
            for name, fn in (("head", self.head), ("step", self.step),
                             ("tail", self.tail)):
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
            "decode graphs: %d families, %d graphs, %d nodes per step "
            "graph (max), %.2f s to capture, graph pool %.1f MiB",
            len(self.graphs), 3 * len(self.graphs),
            max(f.nodes["step"] for f in self.graphs.values()),
            self.capture_seconds, self.pool_bytes / 2**20)

    def stats(self) -> Dict:
        fams = self.graphs.values()
        return {
            "graph_families": len(self.graphs),
            "graphs_captured": 3 * len(self.graphs),
            "graph_nodes_total": sum(sum(f.nodes.values()) for f in fams),
            "graph_step_nodes_max": max((f.nodes["step"] for f in fams),
                                        default=0),
            "graph_capture_seconds": self.capture_seconds,
            "graph_pool_bytes": self.pool_bytes,
            "graph_families_logprobs": sum(1 for key in self.graphs
                                           if key[4]),
            "graph_pool_bytes_logprobs": self.pool_bytes_logprobs,
            "decode_graph_dispatches_total": self.graph_dispatches_total,
            "decode_eager_dispatches_total": self.eager_dispatches_total,
        }
