"""A plain-torch model of the CUDA tensor-core paged flash-decode kernel's
numerics (``production_stack_tpu_torch/csrc/paged_decode.cuh``), for the
CPU tests.

It follows the kernel step by step where rounding happens: the work split
of ``chunk_plan`` (the device's, under the host's ``launch_plan``) and of
the blocks of one (row, kv head, chunk): head groups of up to 16 query
heads and, at Dh 256, two column blocks that each score all of K and
multiply their half of V; per chunk, four warps of 16 tokens per 64-token
tile, each with its own online softmax in the log2 domain (q unscaled in its
own dtype, bf16 or f16, the fp32 score times ``scale * log2(e)`` and the
slot's K scale); the weights P (int8: times the slot's V scale) split into
two parts hi + lo before the product with V, in q's dtype over
compute-dtype pools and in bf16 over int8 pools; the warps merged, then the
chunks merged by the max of their m; out rounded to q's dtype once. Sums
inside one product run in another order than the tensor cores', which
moves results by fp32 ulps only.
"""

import math

import torch

from production_stack_tpu_torch.ops import paged_attention as tpa

LOG2E = torch.tensor(1.4426950408889634, dtype=torch.float32)
LN2 = torch.tensor(0.6931471805599453, dtype=torch.float32)


def chunk_plan(kv_len: int, max_tokens: int, block_size: int,
               chunk_tiles: int):
    """The kernel's work split for one (row, kv head), as
    ``paged_decode_kernel`` computes it on the device from kv_len:
    [(chunk, first token, end token, first block-table entry, entries
    read)]. kv_len is clamped to the block table's max_tokens; an empty row
    has no chunk (its block 0 writes (0, -inf, 0))."""
    kv_len = min(kv_len, max_tokens)
    n_tiles = -(-kv_len // tpa.TILE_TOKENS)
    span = chunk_tiles * tpa.TILE_TOKENS
    plan = []
    for c in range(-(-n_tiles // chunk_tiles)):
        begin, end = c * span, min(kv_len, (c + 1) * span)
        page0 = begin // block_size
        plan.append((c, begin, end, page0, (end - 1) // block_size - page0 + 1))
    return plan


def _round(x, dtype):
    return x.to(dtype).float()


def _chunk_partial(qi, rows, valid, scale2, split_dtype, k_scale, v_scale, tiles):
    """One block's chunk: ``qi`` [Hkv, gn, Dh] f32 (q's values), ``rows``
    (pool, first column, columns) -> [4, Hkv, 16, ...] of tile ti; returns
    (m, l, acc) of the chunk, log2 domain, warps merged."""
    hkv, gn, _ = qi.shape
    k_rows, v_rows = rows
    dv = v_rows(0).shape[-1]
    m_w = torch.full((4, hkv, gn), -math.inf)
    l_w = torch.zeros((4, hkv, gn))
    acc = torch.zeros((4, hkv, gn, dv))
    for ti in range(tiles):
        keys, vals = k_rows(ti), v_rows(ti)
        s = torch.einsum("kgd,wktd->wkgt", qi, keys) * scale2
        if k_scale is not None:
            s = s * k_scale(ti)[:, :, None, :]
        s = s.masked_fill(~valid(ti)[:, None, None, :], -math.inf)
        m_new = torch.maximum(m_w, s.amax(dim=-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m_w - m_use)
        p = torch.exp2(s - m_use[..., None])
        l_w = l_w * alpha + p.sum(dim=-1)
        if v_scale is not None:
            p = p * v_scale(ti)[:, :, None, :]
        hi = _round(p, split_dtype)
        lo = _round(p - hi, split_dtype)
        pv = (torch.einsum("wkgt,wktd->wkgd", hi, vals)
              + torch.einsum("wkgt,wktd->wkgd", lo, vals))
        acc = acc * alpha[..., None] + pv
        m_w = m_new
    mc = m_w.amax(dim=0)
    f = torch.exp2(m_w - mc)
    return mc, (l_w * f).sum(dim=0), (acc * f[..., None]).sum(dim=0)


def kernel_model(q, k_pool, v_pool, block_tables, kv_lens, layer, *,
                 block_size, chunk_tiles, scale=None, k_scale=None,
                 v_scale=None):
    """(out [B, H, Dh] in q's dtype, m [B, H] f32, l [B, H] f32) as the
    tensor-core kernel computes them. q is bf16 or f16; pools hold q's
    dtype, or int8 with bf16 scales."""
    b, h, dh = q.shape
    hkv = k_pool.shape[1]
    g = h // hkv
    tile = tpa.TILE_TOKENS
    quant = k_scale is not None
    split_dtype = torch.bfloat16 if quant else q.dtype
    hb = tpa.heads_per_block(q.dtype, dh, g, block_size)
    dv = dh // tpa.column_blocks(q.dtype, dh)
    scale2 = torch.tensor(dh ** -0.5 if scale is None else scale,
                          dtype=torch.float32) * LOG2E
    max_tokens = block_tables.shape[1] * block_size
    out = torch.zeros((b, h, dh), dtype=q.dtype)
    m_out = torch.full((b, h), -math.inf)
    l_out = torch.zeros((b, h))
    for i in range(b):
        plan = chunk_plan(int(kv_lens[i]), max_tokens, block_size,
                          chunk_tiles)
        if not plan:
            continue
        qi = q[i].float().view(hkv, g, dh)
        o_i = torch.zeros((hkv, g, dh))
        m_i = torch.zeros((hkv, g))
        l_i = torch.zeros((hkv, g))
        # One block per (head group, column block) of each chunk.
        for g0 in range(0, g, hb):
            for d0 in range(0, dh, dv):
                parts = []
                for _, begin, end, page0, n_pages in plan:
                    pages = block_tables[i, page0:page0 + n_pages].long()

                    def where(ti, begin=begin, end=end, page0=page0, pages=pages):
                        tok = (begin + ti * tile + torch.arange(tile)).view(4, 16)
                        valid = tok < end
                        page = torch.where(valid, tok // block_size - page0, 0)
                        slot = torch.where(valid, pages[page] * block_size
                                           + tok % block_size, 0)
                        return slot, valid

                    def rows(pool, lo=0, n=None):   # [4, Hkv, 16, ...], 0 past end
                        def get(ti):
                            slot, valid = where(ti)
                            x = pool[layer][:, slot].float().transpose(0, 1)
                            if n is not None:
                                x = x[..., lo:lo + n]
                            mask = valid.view(4, 1, 16, *[1] * (x.dim() - 3))
                            return torch.where(mask, x, 0.0)
                        return get

                    parts.append(_chunk_partial(
                        qi[:, g0:g0 + hb], (rows(k_pool), rows(v_pool, d0, dv)),
                        lambda ti: where(ti)[1], scale2, split_dtype,
                        rows(k_scale) if quant else None,
                        rows(v_scale) if quant else None,
                        -(-(end - begin) // tile)))
                ms = torch.stack([p[0] for p in parts])
                mc = ms.amax(dim=0)
                f = torch.exp2(ms - mc) if len(parts) > 1 else torch.ones_like(ms)
                lc = (torch.stack([p[1] for p in parts]) * f).sum(dim=0)
                ac = (torch.stack([p[2] for p in parts]) * f[..., None]).sum(dim=0)
                o_i[:, g0:g0 + hb, d0:d0 + dv] = ac / lc[..., None]
                m_i[:, g0:g0 + hb] = mc
                l_i[:, g0:g0 + hb] = lc
        out[i] = o_i.reshape(h, dh).to(q.dtype)
        m_out[i] = (m_i * LN2).reshape(h)
        l_out[i] = l_i.reshape(h)
    return out, m_out, l_out
