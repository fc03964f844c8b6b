"""The draft's catch-up ingest as functions over static buffers, and its
CUDA graphs, one per token bucket.

Counterpart of ``production_stack_tpu/engine/runner.py``
``_spec_ingest_jit`` (the reference compiles one ingest program per token
bucket and its ``warmup`` runs each). A catch-up replays context the
target never prefilled on this engine (a prefix-cache hit, a restore, a
disagg handoff) through the draft, so the row's draft ring holds it: one
row, its tokens padded to the bucket ``t`` = ``_bucket(n, 16, max(16,
next_pow2(R)))`` of ring length R. ``body`` is the whole catch-up:

  * positions ``lo + j`` and the in-chunk flags ``j < n``, on the device
    from the packed scalars;
  * the draft forward over the bucket's tokens (positions clamped on the
    device to the draft's table, ``runner.spec_draft_max_pos``) attending
    the slot's ring;
  * the chunk's draft K/V and positions written into the slot's ring by
    ``runner._spec_ring_write``, the one owner of the ring layout, which
    prefill's draft writes through too (padding entries land in a trash
    row, which is dropped, as the reference's ``mode="drop"`` scatter
    drops them; the ring is scattered back in place, since the decode and
    prefill graphs hold the rings' addresses).

The arena. The inputs are one int32 buffer per bucket, a view at the start
of the one ``packed`` arena: ``lo``, ``n``, the slot, then the ``t``
tokens. A catch-up fills the next of ``STAGING_SLOTS`` pinned host buffers
(allocated once, at the largest bucket's size; refilled only after the
event behind its last copy) and copies it in right before the replay, on
the dispatch stream, so it is staged and replayed before the dispatch that
asked for it stages its own arena. The graphs'
temporaries come from the decode train's graph pool, which the prefill
graphs share too: the rule of ``prefill_graphs.py`` holds (every graph
runs on the one dispatch stream, so no two graphs' buffers are live at
once).

On the CPU, and on the card without warm-up, the same function runs
eagerly over the same buffers; on the card ``warmup`` runs each bucket
once eagerly (``warm``), then ``capture`` records one graph per bucket,
and a catch-up replays its bucket's graph: the same operations on the same
buffers, so the same bits. A catch-up that runs eagerly after warm-up
counts in ``eager_dispatches_total``. A capture that fails raises and names the
bucket: nothing falls back to eager. Every start captures every bucket
(ingest has no sampling variants, so a manifest defers none). The warm
run of a bucket names the trash slot ``spec_num_slots`` with length 0: it
writes back that slot's own ring unchanged.

On a mesh of more than one rank (dp replicas) nothing is captured: every
rank runs ``body`` eagerly from the ``SPEC_INGEST`` descriptor.
"""

from dataclasses import dataclass
from typing import Dict, List

import torch

from production_stack_tpu_torch.engine.prefill_graphs import GraphPerKey
from production_stack_tpu_torch.ops.attention import QBLOCK
from production_stack_tpu_torch.utils import pow2_bucket

# Packed int32 scalars ahead of a catch-up's tokens: lo, n, slot.
INGEST_SCALARS = 3
INGEST_T_MIN = 16
# Pinned host buffers catch-ups stage their inputs in, in turn.
STAGING_SLOTS = 4


@dataclass
class IngestBuffers:
    """One bucket's view into the arena (see the module docstring)."""
    t: int
    packed: torch.Tensor    # int32 [INGEST_SCALARS + t] (input)


class IngestTrain(GraphPerKey):
    """Runs a catch-up for one ModelRunner's draft rings: eagerly, or by
    replaying the graph ``capture`` recorded for its bucket (its key)."""

    name = "draft ingest"
    label = "draft ingest bucket t"

    def __init__(self, runner):
        super().__init__(runner)
        # Host seconds of the catch-ups that ran, by bucket: [calls, s].
        self.host_by_bucket: Dict[int, List[float]] = {}
        # The card's pinned staging buffers and the events behind their
        # last copies; the buffer ``host_packed`` handed out last.
        self._staging: List[torch.Tensor] = []
        self._staged_events: List["torch.cuda.Event"] = []
        self._next = self._last = 0

    # ------------------------------------------------------------ buckets
    @property
    def t_max(self) -> int:
        r_len = self.r.spec_ring_len
        return max(INGEST_T_MIN, 1 << (r_len - 1).bit_length())

    def bucket(self, n: int) -> int:
        """The token bucket of a catch-up of ``n`` tokens."""
        return pow2_bucket(n, INGEST_T_MIN, self.t_max)

    def buckets(self) -> List[int]:
        """Every bucket, 16 up to the ring length's power of two: what the
        reference's warm-up compiles."""
        out, t = [], INGEST_T_MIN
        while t <= self.t_max:
            out.append(t)
            t *= 2
        return out

    def buffers(self, t: int) -> IngestBuffers:
        return IngestBuffers(t, self._view(
            "packed", (INGEST_SCALARS + t,), torch.int32))

    key_buffers = buffers

    def reserve(self, buckets: List[int]) -> None:
        """The arena for every bucket, and on the card the pinned staging
        buffers, before any capture."""
        super().reserve(buckets)
        if buckets and self.r.device.type == "cuda":
            self._alloc_staging()

    def _alloc_staging(self) -> None:
        if not self._staging:
            n = INGEST_SCALARS + self.t_max
            self._staging = [torch.empty((n,), dtype=torch.int32,
                                         pin_memory=True)
                             for _ in range(STAGING_SLOTS)]
            self._staged_events = [torch.cuda.Event()
                                   for _ in range(STAGING_SLOTS)]

    def host_packed(self, t: int, lo: int, n: int, slot: int) -> torch.Tensor:
        """A host buffer of a catch-up's packed inputs, its tokens zero (the
        caller fills ``[INGEST_SCALARS:][:n]``): on the card the next
        pinned staging buffer, once its last copy has run (``stage``
        records it); on the CPU a fresh tensor."""
        if self.r.device.type != "cuda":
            host = torch.zeros((INGEST_SCALARS + t,), dtype=torch.int32)
        else:
            self._alloc_staging()
            i = self._last = self._next
            self._next = (i + 1) % STAGING_SLOTS
            self._staged_events[i].synchronize()
            host = self._staging[i][:INGEST_SCALARS + t]
            host.zero_()
        host.numpy()[:INGEST_SCALARS] = (lo, n, slot)
        return host

    def stage(self, host: torch.Tensor) -> IngestBuffers:
        """Copy ``host`` (from ``host_packed``) into its bucket's arena view
        on the current stream; on the card record the event its staging
        buffer waits on before its next use."""
        bf = self.buffers(host.numel() - INGEST_SCALARS)
        bf.packed.copy_(host, non_blocking=True)
        if self.r.device.type == "cuda":
            self._staged_events[self._last].record()
        return bf

    # ------------------------------------------------------ the function
    def body(self, bf: IngestBuffers) -> None:
        """The catch-up (what a graph captures)."""
        r = self.r
        dev = r.device
        lo, n = bf.packed[0], bf.packed[1]
        slot = bf.packed[2:3]
        slot_l = slot.long()
        tokens = bf.packed[INGEST_SCALARS:][None, :]
        iota = torch.arange(bf.t, dtype=torch.int32, device=dev)
        positions = (lo + iota)[None, :]
        _, dk, dv = r.draft_forward(
            r.spec_params, r.spec_draft_config, tokens,
            torch.clamp(positions, max=r.spec_draft_max_pos - 1), n[None],
            None, None, None, r.spec_k[:, :, slot_l], r.spec_v[:, :, slot_l],
            r.spec_pos[slot_l])
        r._spec_ring_write(dk, dv, positions, (iota < n)[None, :], slot,
                           torch.zeros((1,), dtype=torch.bool, device=dev))

    def peak_bytes(self, t: int) -> int:
        """Device bytes a catch-up of bucket ``t`` holds at its peak,
        reckoned from its shapes as ``runner.prefill_peak_bytes`` reckons a
        chunk's: the slot's ring gathered for the forward (K and V ``[Ld,
        Hd, R, Dd]``) and for ``runner._spec_ring_write`` (K and V ``[Ld,
        Hd, 2, R, Dd]``, its row and the trash row), the chunk's draft K/V ``[Ld, Hd, t, Dd]`` twice (per-layer outputs and
        their stack), the residual stream, and the larger of one layer's
        attention (per query block of ``QBLOCK``: three f32 score blocks
        ``[H, tq, R + t]``, f32 copies of its keys and values, the f32
        output) and its MLP (five ``[t, F]`` activations)."""
        r = self.r
        d = r.spec_draft_config
        e = r.dtype.itemsize
        r_len = r.spec_ring_len
        ring = 6 * d.num_layers * d.num_kv_heads * r_len * d.head_dim_ * e
        kv = 4 * d.num_layers * d.num_kv_heads * t * d.head_dim_ * e
        tq = min(t, QBLOCK)
        attn = (3 * d.num_heads * tq * (r_len + t) * 4
                + 2 * d.num_kv_heads * (r_len + t) * d.head_dim_ * 4
                + 2 * t * d.num_heads * d.head_dim_ * 4)
        mlp = 5 * t * d.intermediate_size * e
        resid = 4 * t * d.hidden_size * e
        return ring + kv + max(attn, mlp) + resid

    def _zero_inputs(self, bf: IngestBuffers) -> None:
        bf.packed.zero_()
        bf.packed[2].fill_(self.r.spec_num_slots)

    def stats(self) -> Dict:
        return {
            "spec_ingest_graph_buckets": len(self.graphs),
            "spec_ingest_graph_nodes_max": max(self.nodes.values(), default=0),
            "spec_ingest_warm_seconds": self.warm_seconds,
            "spec_ingest_capture_seconds": self.capture_seconds,
            "graph_pool_bytes_spec_ingest": self.pool_bytes,
            # Catch-ups this rank ran, replayed or eager.
            "spec_ingests_total": self.r.spec_ingests_total,
            "spec_ingest_graph_replays_total": self.graph_dispatches_total,
            "spec_ingest_eager_total": self.eager_dispatches_total,
            # Host milliseconds per catch-up, by bucket.
            "spec_ingest_host_ms_by_bucket": {
                t: 1e3 * s / n for t, (n, s) in
                sorted(self.host_by_bucket.items())},
        }
