"""A plain-torch model of the CUDA paged flash-decode kernel's numerics
(``production_stack_tpu_torch/csrc/paged_decode.cu``), for the CPU tests.

It follows the kernel step by step where rounding happens: the work split
of ``chunk_plan`` (the device's, under the host's ``launch_plan``); per
chunk, four warps of 16 tokens per 64-token tile, each with its own online softmax in the log2
domain (q in bf16 unscaled, the fp32 score times ``scale * log2(e)`` and the
slot's K scale); the weights P (int8: times the slot's V scale) split into
two bf16 parts hi + lo before the product with V; the warps merged, then
the chunks merged by the max of their m; out rounded to bf16 once. Sums
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


def _bf16(x):
    return x.to(torch.bfloat16).float()


def kernel_model(q, k_pool, v_pool, block_tables, kv_lens, layer, *,
                 block_size, chunk_tiles, scale=None, k_scale=None,
                 v_scale=None):
    """(out [B, H, Dh] bf16, m [B, H] f32, l [B, H] f32) as the kernel
    computes them. Pools are bf16 (or int8 with bf16 scales) values."""
    b, h, dh = q.shape
    hkv = k_pool.shape[1]
    g = h // hkv
    tile = tpa.TILE_TOKENS
    scale2 = torch.tensor(dh ** -0.5 if scale is None else scale,
                          dtype=torch.float32) * LOG2E
    max_tokens = block_tables.shape[1] * block_size
    out = torch.zeros((b, h, dh), dtype=torch.bfloat16)
    m_out = torch.full((b, h), -math.inf)
    l_out = torch.zeros((b, h))
    for i in range(b):
        plan = chunk_plan(int(kv_lens[i]), max_tokens, block_size,
                          chunk_tiles)
        if not plan:
            continue
        qi = _bf16(q[i].float()).view(hkv, g, dh)
        parts = []
        for _, begin, end, page0, n_pages in plan:
            pages = block_tables[i, page0:page0 + n_pages].long()
            tiles = -(-(end - begin) // tile)
            # [4 warps, Hkv, G] running state, log2 domain.
            m_w = torch.full((4, hkv, g), -math.inf)
            l_w = torch.zeros((4, hkv, g))
            acc = torch.zeros((4, hkv, g, dh))
            for ti in range(tiles):
                tok = (begin + ti * tile + torch.arange(tile)).view(4, 16)
                valid = tok < end
                page = torch.where(valid, tok // block_size - page0, 0)
                slot = torch.where(valid, pages[page] * block_size
                                   + tok % block_size, 0)

                def rows(pool):       # [4, Hkv, 16, ...], zero past end
                    x = pool[layer][:, slot].float().transpose(0, 1)
                    mask = valid.view(4, 1, 16, *[1] * (x.dim() - 3))
                    return torch.where(mask, x, 0.0)

                keys, vals = rows(k_pool), rows(v_pool)
                s = torch.einsum("kgd,wktd->wkgt", qi, keys) * scale2
                if k_scale is not None:
                    s = s * rows(k_scale)[:, :, None, :]
                s = s.masked_fill(~valid[:, None, None, :], -math.inf)
                m_new = torch.maximum(m_w, s.amax(dim=-1))
                m_use = torch.where(m_new == -math.inf, 0.0, m_new)
                alpha = torch.exp2(m_w - m_use)
                p = torch.exp2(s - m_use[..., None])
                l_w = l_w * alpha + p.sum(dim=-1)
                if v_scale is not None:
                    p = p * rows(v_scale)[:, :, None, :]
                hi = _bf16(p)
                lo = _bf16(p - hi)
                pv = (torch.einsum("wkgt,wktd->wkgd", hi, vals)
                      + torch.einsum("wkgt,wktd->wkgd", lo, vals))
                acc = acc * alpha[..., None] + pv
                m_w = m_new
            mc = m_w.amax(dim=0)
            f = torch.exp2(m_w - mc)
            parts.append((mc, (l_w * f).sum(dim=0),
                          (acc * f[..., None]).sum(dim=0)))
        if len(parts) == 1:
            mc, lc, ac = parts[0]
        else:
            ms = torch.stack([p[0] for p in parts])
            mc = ms.amax(dim=0)
            f = torch.exp2(ms - mc)
            lc = (torch.stack([p[1] for p in parts]) * f).sum(dim=0)
            ac = (torch.stack([p[2] for p in parts]) * f[..., None]).sum(dim=0)
        out[i] = (ac / lc[..., None]).reshape(h, dh).to(torch.bfloat16)
        m_out[i] = (mc * LN2).reshape(h)
        l_out[i] = lc.reshape(h)
    return out, m_out, l_out
