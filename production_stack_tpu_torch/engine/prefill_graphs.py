"""The prefill chunk as functions over static buffers, and its CUDA graphs
per (b, t, mb, has_window, penalties, logprobs) family.

Counterpart of the body of ``production_stack_tpu/engine/runner.py``
``_prefill_impl`` (the reference compiles one XLA program per family, and
its ``warmup`` runs every reachable one). Here the chunk is four functions,
run in this order and captured together as ONE graph per family:

  * ``inputs``: each (row, token)'s position, in-chunk flag and KV write
    slot, from the packed scalars and block tables;
  * ``forward``: the history window gathered from the pools (an int8 pool
    dequantizes) when the family has one, the model forward over the chunk
    (LoRA rows by their adapter index, packed scalar row 8), each row's
    hidden state at its last chunk token, and on a speculative engine the
    draft over the chunk into each row's draft ring
    (``runner._prefill_draft``);
  * ``sample``: every row's logits at its last chunk token, the penalties
    (penalty variant), the Gumbel field from seeds derived on the device,
    the sampled tokens, their logprobs (logprob variants) and the
    last-token vector a decode may chain from;
  * ``scatter``: the chunk's K/V written to the pools in one scatter per
    pool (an int8 pool's quantized and written one layer at a time).

Every row is sampled, final chunk or not: a graph cannot branch on which
rows finish their prompt, and the head at b <= ``max_prefill_seqs`` rows is
cheap. The runner's fetch keeps the final rows' tokens only.

The arena. Every input and output lives at a fixed address: the packed
host buffer (scalars, tables, chunk tokens), the penalty counts, the
sampled tokens, the logprob arrays and ``last`` are views at the start of
one arena tensor per buffer, sized for the largest family ``reserve`` saw
(captured families and the eager variants' largest shape) and shared by
all families. Temporaries (the window, activations, scores, the chunk's
K/V) come from the graph memory pool, which the prefill graphs share with
the decode train's (``DecodeTrain.pool``). Both are safe for one reason:
every dispatch, prefill or decode, runs on one stream, stages its inputs
right before it and copies its outputs out right after it, so no two
graphs' buffers are ever live at once, and the shared pool costs the
largest graph's temporaries, not their sum. ``last`` is cloned before a
decode may chain from it: the next prefill overwrites the arena's.

Padding rows. Rows pad to the reference's two row families, 1 and the
``max_prefill_seqs`` bucket (the runner's ``prefill_rows``), so a dispatch
has the JAX package's shape. A padding row is all zeros in the packed
buffer but its draft-ring slot: chunk length 0 and table 0, so its K/V and
int8 scales land only in the null block; adapter 0; greedy; its draft-ring
slot is the trash slot ``spec_num_slots``; it is never chained and never
counted in ``kv_quant_tokens_written``.

On the CPU, and on the card without warm-up, the same functions run
eagerly over the same buffers; on the card ``warm`` runs each family of
``runner.prefill_graph_keys()`` once, ``capture`` records it, and a
dispatch of a captured family replays it: the same operations on the same
buffers, so the same bits. A dispatch of another family (the top logprob
bucket, penalties at b > 1) runs eagerly and counts in
``eager_dispatches_total``. A capture that fails raises: warm-up fails
with the family named, and nothing falls back to eager quietly. After a
manifest-verified warm-up (``runner.warmup``) the non-default variants are
in ``deferred``: the runner's first dispatch of one first runs warm-up's
path for it (``capture_deferred``: a warm run and the capture; on the CPU
its dummy dispatch), before it stages its inputs, then replays it.

On a mesh of more than one rank nothing is captured: the forward's
collectives (gloo, host-staged, when ranks share a card) cannot be
captured. Every rank runs these functions eagerly at the exact row count,
without padding. On an sp engine a chunk rings (``ring``: the reference's
condition) or runs whole on every sp rank. A ringing chunk's forward keeps
one token shard per sp rank; after it the shards' K/V are gathered over
the ring, so every sp rank's pool takes the whole chunk, and so is each
row's last-token hidden state (from the rank that holds it), so every
rank samples the same token.
"""

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from production_stack_tpu_torch.engine.decode_graphs import (
    NUM_SCALARS,
    GraphArena,
)
from production_stack_tpu_torch.engine.sampling import (
    apply_penalties,
    compute_logprobs,
    gumbel_noise,
    sample_tokens,
    token_seeds,
)
from production_stack_tpu_torch.ops import paged_attention as pa
from production_stack_tpu_torch.ops.attention import gather_window
from production_stack_tpu_torch.ops.quantization import quantize_kv
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# (b, t, mb, has_window, has_penalties, logprobs bucket (0 = none))
PrefillKey = Tuple[int, int, int, bool, bool, int]


@dataclass
class PrefillBuffers:
    """One family's views into the arena (see the module docstring)."""
    b: int
    t: int
    mb: int
    has_window: bool
    packed: torch.Tensor            # int32 [NUM_SCALARS*b + b*mb + b*t] (input)
    counts: Optional[torch.Tensor]  # int32 [b, V] (input, penalty variant)
    tokens: torch.Tensor            # int32 [b] sampled tokens (output)
    last: torch.Tensor              # int32 [b_max] (output)
    lpk: int = 0
    # Logprob variants (lpk > 0), outputs: the chosen token's logprob f32
    # [b], the top-lpk logprobs f32 [b, lpk] and their ids int32 [b, lpk].
    lp_chosen: Optional[torch.Tensor] = None
    lp_top: Optional[torch.Tensor] = None
    lp_ids: Optional[torch.Tensor] = None

    def outputs(self) -> List[torch.Tensor]:
        """The arrays a fetch copies out: tokens, then the logprob arrays."""
        if not self.lpk:
            return [self.tokens]
        return [self.tokens, self.lp_chosen, self.lp_top, self.lp_ids]

class GraphPerKey(GraphArena):
    """A train captured as ONE CUDA graph per key of ``body`` over its
    arena: the prefill chunk per family (``PrefillTrain``), the draft's
    catch-up per token bucket (``engine/ingest_graphs.py``). ``run``
    replays a key's graph, or runs ``body`` eagerly; ``warm`` and
    ``capture`` are warm-up's. A subclass gives ``body``, ``key_buffers``
    (a key's views), ``_zero_inputs`` (its warm-up dispatch's inputs),
    ``name`` and ``label`` (how messages name the train and a key)."""

    name = "graph"
    label = "key"

    def __init__(self, runner):
        super().__init__(runner)
        self.graphs: Dict = {}
        self.nodes: Dict = {}
        # Keys warm-up covered: captured on the card, dummy-run on the
        # CPU. A dispatch of any other key counts as eager.
        self.warmed: set = set()
        # Warm-up seconds: the eager warm runs, and capture + instantiate.
        self.warm_seconds = 0.0
        self.capture_seconds = 0.0
        # The shared graph pool's growth while this train's graphs were
        # captured.
        self.pool_bytes = 0
        self.eager_dispatches_total = 0
        self.graph_dispatches_total = 0
        self._stream = None
        self._warned: set = set()

    def body(self, bf):
        raise NotImplementedError

    def key_buffers(self, key):
        raise NotImplementedError

    def _zero_inputs(self, bf) -> None:
        raise NotImplementedError

    def reserve(self, keys) -> None:
        for key in keys:
            self.key_buffers(key)

    # -------------------------------------------------------------- run
    def run(self, key, bf, eager: bool = False):
        """The dispatch on the current stream, its inputs staged in ``bf``:
        the key's graph when captured (and ``eager`` is not asked for),
        else ``body`` eagerly. Returns what an eager ``body`` returns (None
        for a replay)."""
        graph = None if eager else self.graphs.get(key)
        if graph is not None:
            self.graph_dispatches_total += 1
            graph.replay()
            return None
        if self.r.device.type == "cuda" or key not in self.warmed:
            self.eager_dispatches_total += 1
            if self.graphs and key not in self._warned:
                self._warned.add(key)
                logger.warning("%s=%s was not captured: its dispatches run "
                               "eagerly", self.label, key)
        return self.body(bf)

    def dummy_dispatch(self, key):
        """The warm-up dispatch of a key: its ``_zero_inputs``, which write
        no live state."""
        bf = self.key_buffers(key)
        self._zero_inputs(bf)
        self.body(bf)
        return bf

    # ---------------------------------------------------------- capture
    def warm(self, keys) -> None:
        """Run every new key of ``keys`` once eagerly on the capture
        stream, on the thread that will capture them, then release the
        allocator's cache. Capture needs the thread's cuBLAS handle and
        workspace made outside it, and on the card a key whose shapes never
        ran in the process captures several times slower than one that ran
        (``PERF.md``, Findings), more than its warm run costs. Run before
        any graph holds pool memory, so the peak is one key's temporaries,
        not the pool's plus one key's."""
        device = self.r.device
        t0 = time.monotonic()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            for key in keys:
                if key not in self.graphs:
                    self.dummy_dispatch(key)
        torch.cuda.current_stream(device).wait_stream(self._stream)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        self.warm_seconds += time.monotonic() - t0

    def capture(self, keys) -> None:
        """Record one graph per key of ``keys`` (``warm`` ran them) into
        the decode train's graph pool, one after another on the capture
        stream. A failed capture raises, naming the key: there is no eager
        fallback for a key that was meant to be captured."""
        r = self.r
        if r.mesh is not None:
            raise RuntimeError(f"{self.name} graphs are not captured on a "
                               "mesh of more than one rank")
        device = r.device
        self.reserve(keys)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved0 = torch.cuda.memory_reserved(device)
        t0 = time.monotonic()
        train = r.decode_train
        if train.pool is None:
            train.pool = torch.cuda.graph_pool_handle()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        # No synchronization or cache release between two captures
        # (torch.cuda.graph does both per graph).
        self._stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(self._stream):
            for key in keys:
                if key in self.graphs:
                    continue  # an engine restarted: its graphs stay valid
                bf = self.key_buffers(key)
                self._zero_inputs(bf)
                graph = torch.cuda.CUDAGraph(keep_graph=True)
                try:
                    graph.capture_begin(pool=train.pool)
                    try:
                        self.body(bf)
                    finally:
                        graph.capture_end()
                    self.nodes[key] = pa.graph_node_counts(graph)[1]
                    graph.instantiate()
                except Exception as e:
                    raise RuntimeError(
                        f"{self.label}={key}: CUDA graph capture failed: "
                        f"{e}") from e
                self.graphs[key] = graph
                self.warmed.add(key)
        torch.cuda.current_stream(device).wait_stream(self._stream)
        torch.cuda.synchronize(device)
        self.capture_seconds += time.monotonic() - t0
        torch.cuda.empty_cache()
        grown = max(0, torch.cuda.memory_reserved(device) - reserved0)
        self.pool_bytes += grown
        # The pool is shared: the decode train reports its whole size.
        train.pool_bytes += grown
        logger.info(
            "%s graphs: %d captured, %d nodes max, %.2f s to capture, graph "
            "pool +%.1f MiB", self.name, len(self.graphs),
            max(self.nodes.values(), default=0), self.capture_seconds,
            grown / 2**20)


class PrefillTrain(GraphPerKey):
    """Runs a prefill dispatch for one ModelRunner: eagerly, or by
    replaying the graph ``capture`` recorded for its family."""

    name = "prefill"
    label = "prefill family (b, t, mb, has_window, penalties, logprobs)"

    # ------------------------------------------------------------ buffers
    def buffers(self, b: int, t: int, mb: int, has_window: bool, pen: bool,
                lpk: int = 0) -> PrefillBuffers:
        r = self.r
        vocab = r.model_config.vocab_size
        return PrefillBuffers(
            b=b, t=t, mb=mb, has_window=has_window,
            packed=self._view("packed", (NUM_SCALARS * b + b * mb + b * t,),
                              torch.int32),
            counts=(self._view("counts", (b, vocab), torch.int32)
                    if pen else None),
            tokens=self._view("tokens", (b,), torch.int32),
            last=self._view("last", (r.b_max,), torch.int32),
            lpk=lpk,
            lp_chosen=(self._view("lp_chosen", (b,), torch.float32)
                       if lpk else None),
            lp_top=(self._view("lp_top", (b, lpk), torch.float32)
                    if lpk else None),
            lp_ids=self._view("lp_ids", (b, lpk), torch.int32) if lpk else None,
        )

    @staticmethod
    def _scalars(bf: PrefillBuffers) -> torch.Tensor:
        return bf.packed[:NUM_SCALARS * bf.b].view(NUM_SCALARS, bf.b)

    @staticmethod
    def _tables(bf: PrefillBuffers) -> torch.Tensor:
        n_sc = NUM_SCALARS * bf.b
        return bf.packed[n_sc:n_sc + bf.b * bf.mb].view(bf.b, bf.mb)

    @staticmethod
    def _token_ids(bf: PrefillBuffers) -> torch.Tensor:
        return bf.packed[NUM_SCALARS * bf.b + bf.b * bf.mb:].view(bf.b, bf.t)

    # ---------------------------------------------- the chunk's functions
    def inputs(self, bf: PrefillBuffers):
        """(positions [b, t], in-chunk flags [b, t], KV write slots [b, t];
        0, the null block, outside the chunk)."""
        r = self.r
        cfg = r.config
        bs = cfg.block_size
        sc = self._scalars(bf)
        chunk_start, chunk_lens = sc[0], sc[1]
        t_iota = torch.arange(bf.t, dtype=torch.int32, device=r.device)
        positions = torch.clamp(chunk_start[:, None] + t_iota[None, :],
                                max=cfg.max_model_len - 1)
        in_chunk = t_iota[None, :] < chunk_lens[:, None]
        blk_idx = torch.clamp(positions // bs, 0, bf.mb - 1)
        blk = torch.gather(self._tables(bf), 1, blk_idx.long())
        slot_mapping = torch.where(in_chunk, blk * bs + positions % bs,
                                   torch.zeros_like(blk))
        return positions, in_chunk, slot_mapping

    def ring(self, bf: PrefillBuffers):
        """The sp ring when this chunk rings its attention (the reference's
        condition: t > 1, t divisible by sp, and with a window the window
        slots plus t too; the llama family), else None."""
        r = self.r
        sp = r.sp
        if (sp is None or bf.t <= 1 or bf.t % sp.size
                or r.model_config.arch != "llama"):
            return None
        if bf.has_window and (bf.mb * r.config.block_size + bf.t) % sp.size:
            return None
        return sp

    def forward(self, bf: PrefillBuffers, positions, in_chunk):
        """The window, the forward, each row's last-token hidden state and
        the draft: (last_hidden [b, D], k_new, v_new [L, Hkv, b, t, Dh])."""
        r = self.r
        sc = self._scalars(bf)
        chunk_start, chunk_lens = sc[0], sc[1]
        token_ids = self._token_ids(bf)
        if bf.has_window:
            # The history window dequantizes; the chunk attends its own
            # fresh K/V unquantized.
            win_k, win_v = gather_window(
                r.kv_k, r.kv_v, self._tables(bf), r.config.block_size,
                r.kv_k_scale, r.kv_v_scale, out_dtype=r.dtype)
            win_len = chunk_start
        else:
            win_k = win_v = win_len = None
        ring = self.ring(bf)
        hidden, k_new, v_new = r.model_forward(
            r.params, r.model_config, token_ids, positions, chunk_lens,
            win_k, win_v, win_len, tp=r.tp, lora=r.lora_of(sc), sp=ring)
        del win_k, win_v
        if r.spec_n:
            r._prefill_draft(token_ids, positions, chunk_start, chunk_lens,
                             in_chunk, sc[12])
        logit_idx = torch.clamp(chunk_lens - 1, min=0).long()
        rows = torch.arange(bf.b, device=r.device)
        if ring is None:
            return hidden[rows, logit_idx], k_new, v_new
        # hidden, k_new and v_new hold this rank's token shard.
        n = bf.t // ring.size
        mine = hidden[rows, torch.clamp(logit_idx - ring.rank * n, 0, n - 1)]
        last = ring.gather(mine)[logit_idx // n, rows]
        k_new, v_new = ring.all_gather(torch.stack([k_new, v_new]),
                                       dim=4).unbind(0)
        return last, k_new, v_new

    def sample(self, bf: PrefillBuffers, last_hidden) -> torch.Tensor:
        """Every row's token from the logits of its last chunk token's
        hidden state ``last_hidden`` [b, D] (and its logprobs); ``last``.
        Returns the raw f32 logits [b, V]."""
        r = self.r
        sc = self._scalars(bf)
        temps = sc[4].view(torch.float32)
        logits = r.model_logits(r.params, r.model_config, last_hidden,
                                r.head_f32, tp=r.tp)
        eff = logits
        if bf.counts is not None:
            eff = apply_penalties(logits, bf.counts, sc[9].view(torch.float32),
                                  sc[10].view(torch.float32))
        gumbel = gumbel_noise(token_seeds(sc[2], sc[3]), logits.shape[1],
                              r.device, rows=temps > 0.0)
        nxt = sample_tokens(eff, temps, sc[5], sc[6].view(torch.float32),
                            gumbel).int()
        bf.tokens.copy_(nxt)
        if bf.lpk:
            chosen, top, ids = compute_logprobs(logits, nxt, bf.lpk)
            bf.lp_chosen.copy_(chosen)
            bf.lp_top.copy_(top)
            bf.lp_ids.copy_(ids)
        bf.last.zero_()
        bf.last[:bf.b].copy_(nxt)
        return logits

    def scatter(self, bf: PrefillBuffers, slot_mapping, k_new, v_new) -> None:
        """The chunk's K/V into the pools at ``slot_mapping``; an int8 pool
        gets it quantized (with its scales), one layer at a time: the f32
        temporaries of ``quantize_kv`` then cost one layer, not L."""
        r = self.r
        nl, hkv, dh = (r.model_config.num_layers, r.local_kv_heads,
                       r.model_config.head_dim_)
        flat = slot_mapping.reshape(-1).long()
        k_flat = k_new.reshape(nl, hkv, bf.b * bf.t, dh)
        v_flat = v_new.reshape(nl, hkv, bf.b * bf.t, dh)
        if not r.kv_quantized:
            r.kv_k[:, :, flat] = k_flat
            r.kv_v[:, :, flat] = v_flat
            return
        for layer in range(nl):
            kq, ks = quantize_kv(k_flat[layer])
            vq, vs = quantize_kv(v_flat[layer])
            r.kv_k[layer][:, flat] = kq
            r.kv_v[layer][:, flat] = vq
            r.kv_k_scale[layer][:, flat] = ks
            r.kv_v_scale[layer][:, flat] = vs

    def prefill(self, bf: PrefillBuffers) -> torch.Tensor:
        """The whole chunk (what a graph captures); returns the logits."""
        positions, in_chunk, slot_mapping = self.inputs(bf)
        last_hidden, k_new, v_new = self.forward(bf, positions, in_chunk)
        logits = self.sample(bf, last_hidden)
        del last_hidden
        self.scatter(bf, slot_mapping, k_new, v_new)
        return logits


    def key_buffers(self, key: PrefillKey) -> PrefillBuffers:
        return self.buffers(*key)

    def body(self, bf: PrefillBuffers) -> torch.Tensor:
        return self.prefill(bf)

    # ---------------------------------------------------- first use
    def capture_deferred(self, key: PrefillKey) -> None:
        """Warm-up's path for one deferred family, at its first dispatch,
        before that dispatch stages anything: on the card a warm run of the
        smallest family of the same sampling variant, then the capture; on
        the CPU its dummy dispatch. The warm run makes this thread's cuBLAS
        handle and the variant's first launches outside the capture; the
        family's own forward shapes ran at warm-up in its default variant.
        It is not the family itself: the graph pool already holds the
        default variants, and a warm run of a large family beside it would
        need memory the pool's sizing (one family's peak) does not leave."""
        if self.r.device.type == "cuda":
            self.warm([min(k for k in self.r.prefill_graph_keys()
                           if k[4:] == key[4:])])
            self.capture([key])
        else:
            self.dummy_dispatch(key)
            self.warmed.add(key)
    def _zero_inputs(self, bf: PrefillBuffers) -> None:
        bf.packed.zero_()
        if bf.counts is not None:
            bf.counts.zero_()
        if self.r.spec_n:
            self._scalars(bf)[12].fill_(self.r.spec_num_slots)
    def check(self, keys: List[PrefillKey]) -> None:
        """Fail warm-up when a family of ``keys`` was not warmed."""
        missed = [k for k in keys if k not in self.warmed]
        if missed:
            raise RuntimeError(
                f"warm-up missed {len(missed)} prefill families (b, t, mb, "
                f"has_window, penalties, logprobs), first {missed[0]}: their "
                "dispatches would run eagerly")

    def stats(self) -> Dict:
        return {
            "prefill_graph_families": len(self.graphs),
            "prefill_graph_nodes_max": max(self.nodes.values(), default=0),
            "prefill_warm_seconds": self.warm_seconds,
            "prefill_capture_seconds": self.capture_seconds,
            "graph_pool_bytes_prefill": self.pool_bytes,
            "prefill_graph_dispatches_total": self.graph_dispatches_total,
            "prefill_eager_dispatches_total": self.eager_dispatches_total,
        }
