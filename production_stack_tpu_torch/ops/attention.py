"""Attention over the paged KV cache, plain PyTorch.

Counterpart of ``production_stack_tpu/ops/attention.py``. None of these is a
Pallas kernel in the JAX package (XLA compiled them), so here they are
ordinary tensor code. The JAX rounding order is kept: bf16 operands of a
score or PV product are widened to f32 before the product (JAX's
``preferred_element_type=float32``), q is scaled in f32 and cast back to its
dtype before the scores, and softmax weights are cast to the values' dtype
before PV.
"""

from typing import Optional, Tuple

import torch

from production_stack_tpu_torch.ops.quantization import dequantize_kv

_NEG_INF = float(torch.finfo(torch.float32).min)

# Query-block size for the chunked prefill path: bounds the materialized
# score tensor at [Hkv, B, G*QBLOCK, S_total] f32 regardless of chunk length.
QBLOCK = 256


def _seg_scores(qf: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """q [Hkv, B, M, Dh] x keys [Hkv, B, S, Dh] -> [Hkv, B, M, S] f32."""
    return torch.matmul(qf.float(), keys.float().transpose(-1, -2))


def _seg_pv(p: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """p [Hkv, B, M, S] x values [Hkv, B, S, Dh] -> [Hkv, B, M, Dh] f32."""
    return torch.matmul(p.to(values.dtype).float(), values.float())


def window_attention(
    q: torch.Tensor,            # [B, T, H, Dh] chunk queries (post-rope)
    k_chunk: torch.Tensor,      # [B, T, Hkv, Dh] chunk keys (post-rope)
    v_chunk: torch.Tensor,      # [B, T, Hkv, Dh]
    positions: torch.Tensor,    # [B, T] absolute position per query token
    chunk_lens: torch.Tensor,   # [B] valid (non-pad) tokens per row
    win_k: Optional[torch.Tensor] = None,    # [Hkv, B, S, Dh] gathered history
    win_v: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,  # [B] valid history per row
    ring_k: Optional[torch.Tensor] = None,   # [Hkv, B, R, Dh] intra-dispatch KV
    ring_v: Optional[torch.Tensor] = None,
    ring_pos: Optional[torch.Tensor] = None,  # [B, R] position per entry
    *,
    scale: Optional[float] = None,
    chunk_bias: Optional[torch.Tensor] = None,  # [T, T] additive f32
) -> torch.Tensor:
    """Dense attention against up to three key segments: the gathered
    history window (valid where s < win_len), the intra-dispatch ring (valid
    where ring_pos < position) and the chunk itself (causal, valid where
    key_idx < chunk_len). ``chunk_bias``: the token tree's [T, T] additive
    bias (ops/tree_mask.py), added to the in-chunk causal mask, for one
    query block only (a verify chunk is N + W <= 24 tokens). Returns
    [B, T, H, Dh] in q.dtype."""
    b, t, h, dh = q.shape
    hkv = k_chunk.shape[2]
    g = h // hkv
    if scale is None:
        scale = dh ** -0.5
    dev = q.device

    qf = (q.float() * scale).to(q.dtype)
    qf = qf.reshape(b, t, hkv, g, dh).permute(2, 0, 3, 1, 4)   # [Hkv,B,G,T,Dh]
    kc = k_chunk.permute(2, 0, 1, 3)                             # [Hkv, B, T, Dh]
    vc = v_chunk.permute(2, 0, 1, 3)

    # 0-d fills, not torch.tensor(): a host-to-device copy would block.
    neg = torch.full((), _NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    t_idx = torch.arange(t, dtype=torch.int32, device=dev)
    chunk_valid = t_idx[None, :] < chunk_lens[:, None]           # [B, T]
    win_bias = None
    if win_k is not None:
        s = win_k.shape[2]
        s_idx = torch.arange(s, dtype=torch.int32, device=dev)
        win_bias = torch.where(s_idx[None, :] < win_len[:, None], zero, neg)

    def q_block(qb, pos_q):
        # qb: [Hkv, B, G, TQ, Dh]; pos_q: [B, TQ] query positions
        tq = qb.shape[3]
        m = g * tq
        qb = qb.reshape(hkv, b, m, dh)
        cb = torch.where(
            chunk_valid[:, None, :]
            & (positions[:, None, :] <= pos_q[:, :, None]),
            zero, neg,
        )                                                        # [B, TQ, T]
        if chunk_bias is not None:
            # Clamped add: both masks bottom out at the f32 floor, and
            # floor + floor would overflow it.
            cb = torch.maximum(cb + chunk_bias[None, :, :], neg)
        segs = []
        vals = []
        if win_k is not None:
            sw = _seg_scores(qb, win_k)
            segs.append(sw + win_bias[None, :, None, :])
            vals.append(win_v)
        if ring_k is not None:
            rb = torch.where(
                ring_pos[:, None, :] < pos_q[:, :, None], zero, neg
            )                                                    # [B, TQ, R]
            sr = _seg_scores(qb, ring_k)
            rb4 = rb[:, None, :, :].expand(b, g, tq, rb.shape[-1]).reshape(
                1, b, m, rb.shape[-1])
            segs.append(sr + rb4)
            vals.append(ring_v)
        sc = _seg_scores(qb, kc)
        cb4 = cb[:, None, :, :].expand(b, g, tq, t).reshape(1, b, m, t)
        segs.append(sc + cb4)
        vals.append(vc)

        mx = segs[0].amax(-1, keepdim=True)
        for ss in segs[1:]:
            mx = torch.maximum(mx, ss.amax(-1, keepdim=True))
        ps = [torch.exp(ss - mx) for ss in segs]
        denom = sum(p.sum(-1, keepdim=True) for p in ps)
        out = sum(_seg_pv(p, val) for p, val in zip(ps, vals))
        out = out / denom                                        # [Hkv, B, M, Dh]
        return out.reshape(hkv, b, g, tq, dh)

    if t <= QBLOCK:
        out = q_block(qf, positions)
    else:
        assert chunk_bias is None, \
            "chunk_bias (tree speculation) requires t <= QBLOCK"
        assert t % QBLOCK == 0, "token bucket must be a multiple of QBLOCK"
        outs = [
            q_block(qf[:, :, :, i:i + QBLOCK], positions[:, i:i + QBLOCK])
            for i in range(0, t, QBLOCK)
        ]
        out = torch.cat(outs, dim=3)                             # [Hkv,B,G,T,Dh]

    # [Hkv, B, G, T, Dh] -> [B, T, H, Dh]
    return out.permute(1, 3, 0, 2, 4).reshape(b, t, h, dh).to(q.dtype)


def dense_decode_stats(
    q: torch.Tensor,         # [B, H, Dh] decode queries (post-rope, UNscaled)
    keys: torch.Tensor,      # [Hkv, B, S, Dh]
    values: torch.Tensor,    # [Hkv, B, S, Dh]
    bias: torch.Tensor,      # [B, S] additive f32 {0, _NEG_INF} validity mask
    *,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-style stats for a small dense key segment (decode T == 1):
    (out [B, H, Dh] normalized, m [B, H] f32, l [B, H] f32). A row whose
    bias masks ALL keys returns (0, -inf, 0) — a no-op under merge."""
    b, h, dh = q.shape
    hkv = keys.shape[0]
    g = h // hkv
    if scale is None:
        scale = dh ** -0.5
    qf = (q.float() * scale).to(q.dtype)
    qf = qf.reshape(b, hkv, g, dh).permute(1, 0, 2, 3)          # [Hkv, B, G, Dh]
    scores = _seg_scores(qf, keys) + bias[None, :, None, :]      # [Hkv, B, G, S]
    m = scores.amax(dim=-1)                                      # [Hkv, B, G]
    # A fully-masked row has every score equal to the mask bias, so
    # exp(score - m) would be 1; mask p explicitly.
    p = torch.exp(scores - m[..., None])
    p = torch.where(scores > _NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1)                                            # [Hkv, B, G]
    out = _seg_pv(p, values)                                     # [Hkv, B, G, Dh]
    out = out / torch.clamp(l, min=1e-30)[..., None]
    out = out.permute(1, 0, 2, 3).reshape(b, h, dh).to(q.dtype)
    mt = torch.where(l > 0, m, torch.full_like(m, float("-inf")))
    return out, mt.permute(1, 0, 2).reshape(b, h), l.permute(1, 0, 2).reshape(b, h)


def merge_attention_segments(
    out_a: torch.Tensor, m_a: torch.Tensor, l_a: torch.Tensor,
    out_b: torch.Tensor, m_b: torch.Tensor, l_b: torch.Tensor,
) -> torch.Tensor:
    """Flash-merge two NORMALIZED attention segments with their softmax
    stats into the attention over the union of their keys. Safe when one
    segment is empty (m = -inf, l = 0)."""
    m = torch.maximum(m_a, m_b)
    m = torch.clamp(m, min=_NEG_INF)  # both-empty guard
    wa = l_a * torch.exp(m_a - m)
    wb = l_b * torch.exp(m_b - m)
    denom = torch.clamp(wa + wb, min=1e-30)
    out = (
        out_a.float() * (wa / denom)[..., None]
        + out_b.float() * (wb / denom)[..., None]
    )
    return out.to(out_a.dtype)


def gather_window(
    kv_k: torch.Tensor,          # [L, Hkv, num_slots, Dh]
    kv_v: torch.Tensor,
    block_tables: torch.Tensor,  # [B, Mb] int32
    block_size: int,
    k_scale: Optional[torch.Tensor] = None,  # [L, Hkv, num_slots] (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
    out_dtype: Optional[torch.dtype] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One gather per dispatch: paged pool -> contiguous per-sequence
    windows [L, Hkv, B, Mb*bs, Dh] (slot s holds absolute position s),
    indexed by BLOCK so each gathered element is a contiguous bs*Dh run.
    Int8 pools (scales given) gather payload and scales and dequantize the
    window to ``out_dtype`` (default bf16), one layer at a time: the f32
    temporaries of the dequantization then cost one layer's window, not
    L."""
    b, mb = block_tables.shape
    n_layers, hkv, num_slots, dh = kv_k.shape
    nb = num_slots // block_size
    s_tot = mb * block_size
    idx = block_tables.long()
    if k_scale is None:
        win_k = kv_k.view(n_layers, hkv, nb, block_size, dh)[:, :, idx]
        win_v = kv_v.view(n_layers, hkv, nb, block_size, dh)[:, :, idx]
        return (win_k.reshape(n_layers, hkv, b, s_tot, dh),
                win_v.reshape(n_layers, hkv, b, s_tot, dh))
    out_dtype = out_dtype or torch.bfloat16
    wins = []
    for pool, scale in ((kv_k, k_scale), (kv_v, v_scale)):
        win = torch.empty((n_layers, hkv, b, s_tot, dh), dtype=out_dtype,
                          device=pool.device)
        for layer in range(n_layers):
            q = pool[layer].view(hkv, nb, block_size, dh)[:, idx]
            s = scale[layer].view(hkv, nb, block_size)[:, idx]
            win[layer] = dequantize_kv(q.reshape(hkv, b, s_tot, dh),
                                       s.reshape(hkv, b, s_tot), out_dtype)
        wins.append(win)
    return wins[0], wins[1]


def gather_kv_pages(pool: torch.Tensor, block_tables: torch.Tensor,
                    block_size: int) -> torch.Tensor:
    """pool [Hkv, num_slots, Dh], block_tables [B, Mb] -> [Hkv, B, Mb*bs, Dh]."""
    b, mb = block_tables.shape
    hkv, num_slots, dh = pool.shape
    nb = num_slots // block_size
    pr = pool.view(hkv, nb, block_size, dh)
    return pr[:, block_tables.long()].reshape(hkv, b, mb * block_size, dh)


def paged_attention_xla(
    q: torch.Tensor,             # [B, T, H, Dh]
    k_pool: torch.Tensor,        # [Hkv, num_slots, Dh]
    v_pool: torch.Tensor,        # [Hkv, num_slots, Dh]
    block_tables: torch.Tensor,  # [B, Mb] int32
    kv_lens: torch.Tensor,       # [B] int32 — total KV length incl. current chunk
    q_positions: torch.Tensor,   # [B, T] int32 — absolute positions of queries
    *,
    block_size: int,
    scale: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,  # [Hkv, num_slots] (int8 pools)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reference paged attention (the JAX package's XLA path, kept under its
    name): gather pages, masked softmax. Query at position p attends to KV
    slots [0, p] of its own sequence; slots beyond kv_len are masked. Int8
    pools pass per-slot scales; the gathered pages dequantize to f32."""
    b, t, h, dh = q.shape
    hkv = k_pool.shape[0]
    g = h // hkv
    if scale is None:
        scale = dh ** -0.5
    k = gather_kv_pages(k_pool, block_tables, block_size)       # [Hkv, B, S, Dh]
    v = gather_kv_pages(v_pool, block_tables, block_size)
    if k_scale is not None:
        ks = gather_kv_pages(k_scale[..., None], block_tables, block_size)
        vs = gather_kv_pages(v_scale[..., None], block_tables, block_size)
        k = dequantize_kv(k, ks[..., 0], torch.float32)
        v = dequantize_kv(v, vs[..., 0], torch.float32)
    s = k.shape[2]
    qg = q.reshape(b, t, hkv, g, dh).float() * scale
    scores = torch.einsum("btkgd,kbsd->bkgts", qg, k.float())
    key_pos = torch.arange(s, dtype=torch.int32, device=q.device)[None, :]
    valid = key_pos < kv_lens[:, None]                           # [B, S]
    causal = key_pos[:, None, :] <= q_positions[:, :, None]      # [B, T, S]
    mask = (valid[:, None, :] & causal)[:, None, None, :, :]     # [B,1,1,T,S]
    scores = torch.where(mask, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,kbsd->btkgd", probs, v.float())
    return out.reshape(b, t, h, dh).to(q.dtype)


def write_kv_to_pool(
    k_pool: torch.Tensor,        # [Hkv, num_slots, Dh]
    v_pool: torch.Tensor,
    k_new: torch.Tensor,         # [B, T, Hkv, Dh]
    v_new: torch.Tensor,
    slot_mapping: torch.Tensor,  # [B, T] int32 — flat slot per token; 0 = discard
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter freshly-computed KV into the pools IN PLACE (the JAX package
    returned new pools and donated the old ones). Padding tokens carry slot
    0, the reserved null block, which attention never unmasks."""
    flat = slot_mapping.reshape(-1).long()
    kf = k_new.reshape(-1, *k_new.shape[2:]).transpose(0, 1).to(k_pool.dtype)
    vf = v_new.reshape(-1, *v_new.shape[2:]).transpose(0, 1).to(v_pool.dtype)
    k_pool[:, flat] = kf
    v_pool[:, flat] = vf
    return k_pool, v_pool
