"""Ring attention: exact causal attention with the sequence axis sharded over
the sequence-parallel ranks.

Counterpart of ``production_stack_tpu/ops/ring_attention.py``
(``_ring_attention_shard``, ``ring_attention``, ``ring_attention_kv``),
which runs under ``shard_map`` over the mesh's "sp" axis and rotates the
KV shards with ``jax.lax.ppermute``. Here the sp ranks are processes
(``parallel/mesh.py:SPRing``) and the rotation is point-to-point sends.

Algorithm (ring step r of sp): rank i holds the queries of its token shard
and the KV shard that started on rank (i - r) mod sp; it folds that shard
into an online-softmax accumulator (m, l, acc) in float32, with causality
decided by absolute positions only (so any token-to-rank layout of the
keys is exact), then passes the shard on to rank i + 1. After sp steps
every query saw every key. ``ring_step`` is the reference's per-step body,
its float32 arithmetic in its order; the reference also rotates after the
last step, whose result it discards: the ring here makes sp - 1 exchanges.

Three forms over the same body:
  * ``ring_attention`` / ``ring_attention_kv``: the plain version, every
    shard in one process, the ring's steps a loop (the reference's
    signatures with the sp degree in place of the mesh). The tests hold it
    to the JAX function, and the distributed form to it bit for bit;
  * ``ring_attention_shard``: one rank's part of the distributed ring. It
    holds one KV shard at a time (its own, then each one it receives),
    never the K/V of a layer's other shards at once.

The ring is plain PyTorch ops plus ``torch.distributed`` sends: the
reference's is XLA, not a Pallas kernel.
"""

from typing import List, Optional, Tuple

import torch

_NEG_INF = float(torch.finfo(torch.float32).min)

# The sentinel position of a window slot a query must never see (at or
# past the row's history length): larger than every query position.
WINDOW_SENTINEL = 2 ** 30

Carry = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def ring_init(q: torch.Tensor, hkv: int, scale: Optional[float] = None
              ) -> Tuple[torch.Tensor, Carry]:
    """The scaled f32 queries grouped by kv head [B, Sq, Hkv, G, Dh] and the
    empty accumulator (m, l [B, Hkv, G, Sq, 1], acc [B, Sq, Hkv, G, Dh])."""
    b, sq, h, dh = q.shape
    g = h // hkv
    if scale is None:
        scale = dh ** -0.5
    qg = (q.float() * scale).reshape(b, sq, hkv, g, dh)
    m = torch.full((b, hkv, g, sq, 1), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, dh), dtype=torch.float32, device=q.device)
    return qg, (m, l, acc)


def ring_step(qg: torch.Tensor, q_pos: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, kv_pos: torch.Tensor, carry: Carry) -> Carry:
    """Fold one KV shard (k, v [B, Sk, Hkv, Dh], positions kv_pos [B, Sk])
    into the accumulator of the queries ``qg`` (``ring_init``) at positions
    q_pos [B, Sq]: a key is seen where its position is at most the
    query's."""
    m, l, acc = carry
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    causal = kv_pos[:, None, :] <= q_pos[:, :, None]             # [B, Sq, Sk]
    scores = torch.where(causal[:, None, None, :, :], scores,
                         torch.full((), _NEG_INF, device=scores.device))
    m_new = torch.maximum(m, scores.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_new)
    p = torch.exp(scores - m_new)
    l_new = l * alpha + p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    acc_new = acc * alpha.movedim(3, 1)[..., 0][..., None] + pv
    return m_new, l_new, acc_new


def ring_finish(q: torch.Tensor, carry: Carry) -> torch.Tensor:
    """The attention output [B, Sq, H, Dh] in q's dtype."""
    _, l, acc = carry
    b, sq, h, dh = q.shape
    l_q = l.movedim(3, 1)[..., 0][..., None]                      # [B, Sq, Hkv, G, 1]
    out = acc / torch.clamp(l_q, min=1e-30)
    return out.reshape(b, sq, h, dh).to(q.dtype)


def _plain(q_shards: List[torch.Tensor], qpos_shards: List[torch.Tensor],
           k_shards: List[torch.Tensor], v_shards: List[torch.Tensor],
           kvpos_shards: List[torch.Tensor], scale: Optional[float]
           ) -> List[torch.Tensor]:
    """Every rank's output of the ring, the ranks' steps run in turn: rank
    i's step r folds KV shard (i - r) mod sp."""
    sp = len(q_shards)
    outs = []
    for i in range(sp):
        qg, carry = ring_init(q_shards[i], k_shards[i].shape[2], scale)
        for r in range(sp):
            j = (i - r) % sp
            carry = ring_step(qg, qpos_shards[i], k_shards[j], v_shards[j],
                              kvpos_shards[j], carry)
        outs.append(ring_finish(q_shards[i], carry))
    return outs


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   positions: torch.Tensor, sp: int, *,
                   scale: Optional[float] = None) -> torch.Tensor:
    """The plain ring over ``sp`` contiguous shards of the sequence, in one
    process: q [B, S, H, Dh], k/v [B, S, Hkv, Dh], positions [B, S] -> [B,
    S, H, Dh]. S must divide by sp."""
    q_s, k_s, v_s, p_s = (list(x.chunk(sp, dim=1))
                          for x in (q, k, v, positions))
    return torch.cat(_plain(q_s, p_s, k_s, v_s, p_s, scale), dim=1)


def ring_attention_kv(q: torch.Tensor, q_pos: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, kv_pos: torch.Tensor, sp: int, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The plain ring with an independent KV sequence (the continuation
    chunk: history window followed by the chunk; window slots a query must
    not see carry ``WINDOW_SENTINEL``): q [B, Sq, H, Dh] at q_pos [B, Sq],
    k/v [B, Sk, Hkv, Dh] at kv_pos [B, Sk]. Sq and Sk must each divide by
    sp."""
    q_s, qp_s = list(q.chunk(sp, dim=1)), list(q_pos.chunk(sp, dim=1))
    k_s, v_s, kp_s = (list(x.chunk(sp, dim=1)) for x in (k, v, kv_pos))
    return torch.cat(_plain(q_s, qp_s, k_s, v_s, kp_s, scale), dim=1)


def ring_attention_shard(q: torch.Tensor, q_pos: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor,
                         kv_pos: torch.Tensor, ring, kind: str, *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """This rank's part of the distributed ring over ``ring``
    (``parallel/mesh.py:SPRing``): its queries q [B, Sq, H, Dh] at q_pos
    and its KV shard k/v [B, Sk, Hkv, Dh] at kv_pos; every rank's shards
    have the same shapes. Step r folds the shard held, then (but after the
    last step) passes it to rank s + 1 and takes the next from s - 1.
    ``kind`` ("first" or "continuation") names the call in the ring's
    counts. Returns this rank's output [B, Sq, H, Dh]."""
    ring.rings[kind] += 1
    qg, carry = ring_init(q, k.shape[2], scale)
    for r in range(ring.size):
        carry = ring_step(qg, q_pos, k, v, kv_pos, carry)
        if r < ring.size - 1:
            k, v, kv_pos = ring.exchange([k, v, kv_pos])
    return ring_finish(q, carry)
