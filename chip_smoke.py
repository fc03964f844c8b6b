#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``production_stack_tpu_torch``) on one
NVIDIA GPU and check it.

Phases, each printing what it finds (serving and check run before the
kernel phase, whose profiler would otherwise stay attached during serving):
  1. the card: ``nvidia-smi`` name and power limit, torch's device name;
  2. build: the paged flash-decode kernel (bf16 and int8 variants) compiled
     by nvcc from the checkout; per template instance, ptxas's registers,
     spills and static shared memory, the launch's dynamic shared memory
     and resident blocks per SM;
  3. kernel: one call of each variant captured in a CUDA graph and
     replayed after kv_lens and the block tables change in place (it must
     give the plain version's output on the new inputs, and the captured
     inputs' eager output again bit for bit); then
     ``paged_flash_decode_stats`` (CUDA) against its plain PyTorch
     version on the card, for each variant (bf16 pools; int8 pools with
     bf16 per-slot scales), at llama-3b heads (H=24, Hkv=8, Dh=128) and
     llama-1b heads (H=32, Hkv=4, Dh=64), block size 16, B in {1, 8, 32}
     and the main path's shape, ragged kv_lens (0, 1, 17, >= 4000),
     shuffled block tables, NaN-poisoned slots (bf16) or scales (int8)
     past kv_len and in the block-table padding; faulty plain versions
     must fail the same check (bf16: PV summed in bf16, a row's last value
     dropped; int8: l summed over p * v_scale, K scales read from the
     neighbouring slot); ``paged_attention_decode`` and ``paged_attention``
     must give the kernel's output; device times (torch.profiler) of the
     kernel (per CUDA kernel name; exactly one launch per call), the plain
     version and an SDPA yardstick (int8: over K/V dequantized
     beforehand, untimed), the bound and the kernel's share of it;
  4. serving, twice: llama-3b at full width (random bf16 weights from
     --seed) behind the port's HTTP server with a bf16 KV pool, then with
     an int8 KV pool of the same bytes; each: one untimed warm-up request,
     then 4 concurrent requests (greedy and seeded, completions and
     streamed chat), /v1/models and /health; the run's kernel variant must
     launch for every decode step of every layer, the other not at all;
  5. check: one decode step at llama-3b width (depth cut to 2 layers)
     through the kernel path against the plain window path, over a bf16
     pool and over an int8 pool; the seeded-sampling Gumbel field on the
     card bit for bit against the CPU's.

Any failure exits non-zero before the result lines. The last two lines are
``{"kernels": [...]}`` and ``{"ok": true, "device": {...}}``.

Run: ``python3 chip_smoke.py`` from the root of the repository.
"""

import argparse
import asyncio
import gc
import json
import os
import random
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor-core peak
KERNEL_SOURCE = "production_stack_tpu_torch/csrc/paged_decode.cu"
# The TPU kernel each variant replaces: _decode_kernel, and its
# quantized=True branch (int8 scores and weights).
KERNEL_REPLACES = {
    "bf16": "production_stack_tpu/ops/pallas/paged_attention.py:57",
    "int8": "production_stack_tpu/ops/pallas/paged_attention.py:175",
}
BF16_KV_BLOCKS = 8 * 4096 // 16 + 1   # 8 sequences x 4096 tokens + null block
# out is bf16 in both versions and their fp32 sums differ only in order, so
# they differ by at most one bf16 rounding step (< 2**-7 relative, inside
# OUT_RTOL). A typical |out| is ~0.03 at kv_len in the thousands, so each
# row is also held to its norm: ||out - ref|| / ||ref|| <= OUT_ROW_RTOL.
# A CPU emulation of the kernel's fp32 order gives row errors <= ~5e-4; a
# PV sum rounded to bf16 gives >= ~1.6e-2. The kernel phase runs such
# faulty versions as controls and fails if the check lets one through.
OUT_ATOL = 2e-3
OUT_RTOL = 1e-2
OUT_ROW_RTOL = 5e-3
STATS_RTOL = 1e-3              # m, l are fp32 in both versions
STATS_ATOL = 1e-5


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- phase 3
def kernel_instances(pa, ptxas: str):
    """Per template instance of the kernel: ptxas's registers, spills and
    static shared memory, and the launch's dynamic shared memory and
    resident blocks per SM (CUDA occupancy calculator, 128 threads)."""
    import re

    insts, cur = [], None
    for line in ptxas.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(r"paged_decode_kernelI(13__nv_bfloat16|a)Li(\d+)ELi(\d+)E",
                          m.group(1))
            cur = None if t is None else {
                "variant": "bf16" if t.group(1) != "a" else "int8",
                "Dh": int(t.group(2)), "KG": int(t.group(3))}
            if cur:
                insts.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            cur["registers"], cur["static_smem"] = int(m.group(1)), int(m.group(2))
    if len(insts) != 8:
        fail(f"build: ptxas reported {len(insts)} kernel instances, want 8")
    for inst in insts:
        blocks, smem = pa.occupancy(inst["variant"] == "int8", inst["Dh"], inst["KG"])
        inst.update(dynamic_smem=smem, blocks_per_sm=blocks,
                    warps_per_sm=4 * blocks)
        if blocks < 1:
            fail(f"build: instance {inst} cannot launch")
    return insts


def graph_check(torch, pa, device, seed, main_lens):
    """Capture one call of each variant in a CUDA graph, then change
    kv_lens and the block tables in place and replay: the output must be
    the plain version's on the new inputs (no host decision read device
    data), and replaying the first inputs again must give the eager output
    bit for bit (the merge tickets were reset)."""
    b, h, hkv, dh, bs = 4, 24, 8, 128, 16
    for quant in (False, True):
        name = f"graph [{'int8' if quant else 'bf16'}]"
        q, kp, vp, ks, vs, bt, kvl = make_case(torch, b, h, hkv, dh, main_lens, 2,
                                               bs, seed, device, quant)
        sc = dict(k_scale=ks, v_scale=vs)
        want = pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, 1, block_size=bs, **sc)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            got = pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, 1, block_size=bs, **sc)
        kernels, nodes = pa.graph_node_counts(graph)
        if kernels != 1 or nodes != 1:
            fail(f"{name}: one call captured as {nodes} graph nodes, {kernels} "
                 "of them kernels; the kernel is one launch per call")
        bt0, kvl0 = bt.clone(), kvl.clone()
        # Rows rotated by one and shortened (row 0 emptied): other pages,
        # other chunk counts; every position kept is clean in the pool.
        new_lens = [0] + [max(1, main_lens[(i + 1) % b] - 97 * i) for i in range(1, b)]
        bt.copy_(torch.roll(bt0, -1, dims=0))
        kvl.copy_(torch.tensor(new_lens, dtype=torch.int32, device=device))
        graph.replay()
        ro, rm, rl = pa.paged_flash_decode_stats_ref(q, kp, vp, bt, kvl, 1,
                                                     block_size=bs, **sc)
        torch.cuda.synchronize()
        live = kvl > 0
        err, row_rel, ok = out_error(torch, got[0], ro, live)
        ok = (ok and stats_close(torch, got[1][live], rm[live])
              and stats_close(torch, got[2][live], rl[live])
              and bool((got[0][0] == 0).all()) and bool((got[1][0] == float("-inf")).all()))
        if not ok:
            fail(f"{name}: replay with new kv_lens {new_lens} and tables disagrees "
                 f"with the plain version (max abs {err:.3e}, row rel {row_rel:.3e})")
        bt.copy_(bt0)
        kvl.copy_(kvl0)
        graph.replay()
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got, want)):
            fail(f"{name}: replay of the captured inputs differs from the eager call")
        log(f"{name}: one call is 1 graph node (a kernel); replay with kv_lens "
            f"{new_lens} and rotated tables matches "
            f"the plain version (max abs {err:.3e}, row rel {row_rel:.3e}); "
            "replay of the captured inputs equals the eager call bit for bit")
        del graph, got, want, q, kp, vp, ks, vs
        torch.cuda.empty_cache()


def make_case(torch, b, h, hkv, dh, kv_lens, n_layers, bs, seed, device,
              quant=False):
    """Pool, shuffled block tables and queries for one kernel case. Slots
    past each kv_len and the block the table padding points at hold NaN
    (int8: NaN scales over a payload of +-127): a kernel that reads them
    poisons its output. Returns (q, k_pool, v_pool, k_scale, v_scale,
    block_tables, kv_lens); the scales are None for bf16."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pages = [-(-n // bs) for n in kv_lens]
    mb = 1
    while mb < max(max(pages), 1):
        mb *= 2
    num_blocks = sum(pages) + 2                 # + null block 0 + NaN block
    nan_blk = num_blocks - 1
    perm = torch.randperm(num_blocks - 2, generator=gen, device=device) + 1
    bt = torch.full((b, mb), nan_blk, dtype=torch.int32, device=device)
    ofs = 0
    for i, n in enumerate(pages):
        bt[i, :n] = perm[ofs:ofs + n].to(torch.int32)
        ofs += n
    shape = (n_layers, hkv, num_blocks * bs, dh)
    k_pool = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    v_pool = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    k_scale = v_scale = None
    poisoned = [(k_pool, float("nan")), (v_pool, float("nan"))]
    if quant:
        from production_stack_tpu_torch.ops.quantization import quantize_kv

        k_pool, k_scale = quantize_kv(k_pool)
        v_pool, v_scale = quantize_kv(v_pool)
        poisoned = [(k_pool, 127), (v_pool, -127), (k_scale, float("nan")),
                    (v_scale, float("nan"))]
    for pool, bad in poisoned:
        pool[:, :, nan_blk * bs:(nan_blk + 1) * bs] = bad
        for i, n in enumerate(kv_lens):
            if n % bs:
                blk = int(bt[i, n // bs])
                pool[:, :, blk * bs + n % bs:(blk + 1) * bs] = bad
    q = torch.randn((b, h, dh), generator=gen, device=device).to(torch.bfloat16)
    kvl = torch.tensor(kv_lens, dtype=torch.int32, device=device)
    return q, k_pool, v_pool, k_scale, v_scale, bt, kvl


def device_profile(torch, fn, n_calls: int, what: str, per_call=None):
    """Device time of n_calls calls from one torch.profiler trace (host
    gaps excluded): (ms per call summed over every kernel, {kernel name: ms
    per call}, kernel launches per call). A trace with no device time, or
    with another count of launches per call than ``per_call`` (CUPTI can
    drop records), is taken again, up to three times; no device time at
    all fails the run."""
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    found = None
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(n_calls):
                fn(i)
            torch.cuda.synchronize()
        by_name, count = {}, 0
        for evt in prof.events():
            if str(evt.device_type).endswith("CUDA"):
                count += 1
                by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
        total_us = sum(by_name.values())
        if total_us > 0:
            found = (total_us / n_calls / 1e3,
                     {k: v / n_calls / 1e3 for k, v in by_name.items()},
                     count / n_calls)
            if per_call is None or found[2] == per_call:
                return found
    if found is None:
        fail(f"{what}: torch.profiler recorded no device time")
    return found


def device_ms(torch, fn, n_calls: int, what: str) -> float:
    """Mean device time per call (ms), every kernel of the call summed."""
    return device_profile(torch, fn, n_calls, what)[0]


def bound_of(kv_lens, b, h, hkv, dh, bs, quant=False):
    """Least time for the work this input needs: each K/V row of the live
    pages read once (bf16: 2 B an element; int8: 1 B an element plus the
    slot's 2-byte bf16 scale), q read, out/m/l written, the block-table
    entries in use and kv_lens read; operations 4*kv_len*H*Dh (QK and PV)."""
    toks = sum(kv_lens)
    kv_row_bytes = dh + 2 if quant else dh * 2
    nbytes = (toks * hkv * kv_row_bytes * 2 + b * h * dh * 2 * 2 + b * h * 4 * 2
              + sum(-(-n // bs) for n in kv_lens) * 4 + b * 4)
    ops = 4 * toks * h * dh
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def out_error(torch, out, ref, live):
    """(max |out - ref|, worst row's ||out - ref|| / ||ref||, passes) over
    the rows with kv_len > 0."""
    o, r = out.float()[live], ref.float()[live]
    diff = (o - r).abs()
    row_rel = ((o - r).norm(dim=-1) / r.norm(dim=-1).clamp_min(1e-30)).max().item()
    ok = bool((diff <= OUT_ATOL + OUT_RTOL * r.abs()).all()) and row_rel <= OUT_ROW_RTOL
    return diff.max().item(), row_rel, ok


def plain_with_fault(torch, q, kp, vp, bt, kvl, layer, bs, fault):
    """The plain version with one deliberate fault, to show that the out
    check catches it: "bf16 PV sum" rounds the running PV sum to bf16 after
    each page; "last V dropped" leaves each row's last value out of PV."""
    b, h, dh = q.shape
    hkv = kp.shape[1]
    s_max = -(-max(int(kvl.max()), 1) // bs) * bs
    slots = (bt.long()[:, :, None] * bs
             + torch.arange(bs, device=q.device)).reshape(b, -1)[:, :s_max]
    keys = torch.stack([kp[layer][:, slots[i]] for i in range(b)]).float()
    vals = torch.stack([vp[layer][:, slots[i]] for i in range(b)]).float()
    pos = torch.arange(s_max, device=q.device)[None, :]
    valid = pos < kvl.long()[:, None]                              # [B, S]
    vvalid = valid & (pos != kvl.long()[:, None] - 1) if fault == "last V dropped" \
        else valid
    keys = torch.where(valid[:, None, :, None], keys, 0.0)
    vals = torch.where(vvalid[:, None, :, None], vals, 0.0)
    qf = q.float().reshape(b, hkv, h // hkv, dh) * dh ** -0.5
    s = torch.einsum("bkgd,bksd->bkgs", qf, keys)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    if fault == "bf16 PV sum":
        acc = torch.zeros(p.shape[:-1] + (dh,), dtype=torch.bfloat16,
                          device=q.device)
        for t in range(0, s_max, bs):
            acc = (acc.float() + torch.einsum("bkgs,bksd->bkgd", p[..., t:t + bs],
                                              vals[:, :, t:t + bs])).to(torch.bfloat16)
        acc = acc.float()
    else:
        acc = torch.einsum("bkgs,bksd->bkgd", p, vals)
    return (acc / l.clamp(min=1e-30)[..., None]).reshape(b, h, dh).to(q.dtype)


def int8_plain_with_fault(torch, pa, q, kp, vp, ks, vs, bt, kvl, layer, bs,
                          fault):
    """The int8 plain version with one deliberate fault, to show that the
    check catches it: "l over p*v_scale" sums the V-scaled weights into l;
    "K scale of the next slot" reads each slot's K scale from its
    neighbour. Returns (out, m, l)."""
    if fault == "K scale of the next slot":
        # The poisoned (NaN) scales become 0 first, so that the control
        # fails by its arithmetic and not by a NaN rolled into a live slot.
        return pa.paged_flash_decode_stats_ref(
            q, kp, vp, bt, kvl, layer, block_size=bs,
            k_scale=torch.roll(torch.nan_to_num(ks, nan=0.0), -1, dims=2),
            v_scale=vs)
    b, h, dh = q.shape
    hkv = kp.shape[1]
    s_max = -(-max(int(kvl.max()), 1) // bs) * bs
    slots = (bt.long()[:, :, None] * bs
             + torch.arange(bs, device=q.device)).reshape(b, -1)[:, :s_max]
    pos = torch.arange(s_max, device=q.device)[None, :]
    valid = pos < kvl.long()[:, None]                              # [B, S]

    def rows(pool, n_dims):
        x = torch.stack([pool[layer][:, slots[i]] for i in range(b)]).float()
        return torch.where(valid.view(b, 1, s_max, *[1] * n_dims), x, 0.0)

    keys, vals = rows(kp, 1), rows(vp, 1)                          # [B,Hkv,S,Dh]
    ksc, vsc = rows(ks, 0), rows(vs, 0)                            # [B,Hkv,S]
    qf = q.float().reshape(b, hkv, h // hkv, dh) * dh ** -0.5
    sc = torch.einsum("bkgd,bksd->bkgs", qf, keys) * ksc[:, :, None, :]
    sc = sc.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = sc.amax(dim=-1)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    pv = torch.exp(sc - m[..., None]) * vsc[:, :, None, :]
    l = pv.sum(dim=-1)
    acc = torch.einsum("bkgs,bksd->bkgd", pv, vals)
    out = (acc / l.clamp(min=1e-30)[..., None]).reshape(b, h, dh).to(q.dtype)
    return out, m.reshape(b, h), l.reshape(b, h)


def stats_close(torch, got, want):
    return torch.allclose(got, want, rtol=STATS_RTOL, atol=STATS_ATOL)


def run_kernel_case(torch, pa, name, b, h, hkv, dh, kv_lens, n_layers, seed,
                    device, quant, bs=16):
    import torch.nn.functional as F

    from production_stack_tpu_torch.ops.quantization import dequantize_kv

    q, kp, vp, ks, vs, bt, kvl = make_case(torch, b, h, hkv, dh, kv_lens,
                                           n_layers, bs, seed, device, quant)
    sc = dict(k_scale=ks, v_scale=vs)
    max_err = max_row_rel = 0.0
    controls = {}
    for layer in sorted({0, n_layers - 1}):
        out, m, l = pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, layer,
                                                block_size=bs, **sc)
        ro, rm, rl = pa.paged_flash_decode_stats_ref(q, kp, vp, bt, kvl, layer,
                                                     block_size=bs, **sc)
        torch.cuda.synchronize()
        for i, n in enumerate(kv_lens):
            if n == 0:
                if not (torch.all(out[i] == 0) and torch.all(m[i] == float("-inf"))
                        and torch.all(l[i] == 0)):
                    fail(f"{name}: kv_len=0 row {i} is not (0, -inf, 0)")
        live = kvl > 0
        for t, what in ((out[live], "out"), (m[live], "m"), (l[live], "l")):
            if not torch.isfinite(t).all():
                fail(f"{name} layer {layer}: non-finite {what} (a masked or "
                     "padding slot leaked into the result)")
        err, row_rel, ok = out_error(torch, out, ro, live)
        if not ok:
            fail(f"{name} layer {layer}: kernel out disagrees with plain version: "
                 f"max abs {err:.3e}, row rel {row_rel:.3e} (atol {OUT_ATOL}, "
                 f"rtol {OUT_RTOL}, row rtol {OUT_ROW_RTOL})")
        try:
            torch.testing.assert_close(m[live], rm[live], rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
            torch.testing.assert_close(l[live], rl[live], rtol=STATS_RTOL,
                                       atol=STATS_ATOL)
        except AssertionError as e:
            fail(f"{name} layer {layer}: kernel stats disagree with plain version: {e}")
        max_err = max(max_err, err)
        max_row_rel = max(max_row_rel, row_rel)
        if layer == 0 and quant:
            for fault in ("l over p*v_scale", "K scale of the next slot"):
                bo, bm, bl = int8_plain_with_fault(torch, pa, q, kp, vp, ks, vs,
                                                   bt, kvl, 0, bs, fault)
                c_err, c_row, c_ok = out_error(torch, bo, ro, live)
                c_ok = (c_ok and stats_close(torch, bm[live], rm[live])
                        and stats_close(torch, bl[live], rl[live]))
                controls[fault] = c_row
                if c_ok:
                    fail(f"{name}: control '{fault}' passed the out/m/l check "
                         f"(max abs {c_err:.3e}, row rel {c_row:.3e}): the "
                         "tolerance is too loose to see that fault")
                del bo, bm, bl
        elif layer == 0:
            for fault in ("bf16 PV sum", "last V dropped"):
                bad = plain_with_fault(torch, q, kp, vp, bt, kvl, 0, bs, fault)
                c_err, c_row, c_ok = out_error(torch, bad, ro, live)
                controls[fault] = c_row
                if c_ok:
                    fail(f"{name}: control '{fault}' passed the out check "
                         f"(max abs {c_err:.3e}, row rel {c_row:.3e}): the "
                         "tolerance is too loose to see that fault")
                del bad
        if layer == 0 and name.startswith("main path"):
            # The single-layer wrapper and the by-shape dispatch reach the
            # same kernel: their output is the kernel's, bit for bit.
            one = dict(k_scale=ks[0], v_scale=vs[0]) if quant else {}
            dec = pa.paged_attention_decode(q[:, None], kp[0], vp[0], bt, kvl,
                                            block_size=bs, **one)
            disp = pa.paged_attention(q[:, None], kp[0], vp[0], bt, kvl,
                                      (kvl - 1)[:, None], block_size=bs, **one)
            if not (torch.equal(dec[:, 0], out) and torch.equal(disp[:, 0], out)):
                fail(f"{name}: paged_attention_decode / paged_attention differ "
                     "from the kernel's output")
            log(f"{name}: paged_attention_decode and paged_attention give the "
                "kernel's output")

    # Cycle through the layers so each launch meets its pages cold in L2,
    # as the decode step does (28 layers apart).
    def kern(i):
        return pa.paged_flash_decode_stats(q, kp, vp, bt, kvl, i % n_layers,
                                           block_size=bs, **sc)

    def plain(i):
        return pa.paged_flash_decode_stats_ref(q, kp, vp, bt, kvl, i % n_layers,
                                               block_size=bs, **sc)

    # Yardstick: SDPA over the same K/V gathered contiguous per layer
    # (int8: dequantized to bf16; gather and dequantization not timed),
    # padded to the longest row with a key mask.
    s_max = max(max(kv_lens), 1)
    n_lib = min(4, n_layers)
    wins = []
    slots = (bt.long()[:, :, None] * bs
             + torch.arange(bs, device=device)).reshape(b, -1)[:, :s_max]
    for layer in range(n_lib):
        win = []
        for pool, scale in ((kp, ks), (vp, vs)):
            w = torch.stack([pool[layer][:, slots[i]] for i in range(b)])
            if quant:
                w = dequantize_kv(w, torch.stack(
                    [scale[layer][:, slots[i]] for i in range(b)]), torch.bfloat16)
            win.append(w.contiguous())                     # [B, Hkv, S, Dh]
        wins.append(win)
    mask = (torch.arange(s_max, device=device)[None, :] < kvl[:, None].long())
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa(i):
        kw, vw = wins[i % n_lib]
        return F.scaled_dot_product_attention(q4, kw, vw, attn_mask=mask,
                                              enable_gqa=True)

    what = f"{name} [{'int8' if quant else 'bf16'}]"
    ms, ms_by_kernel, per_call = device_profile(torch, kern, 2 * n_layers,
                                                f"{what} kernel", per_call=1)
    if len(ms_by_kernel) != 1 or not 0 < per_call <= 1:
        fail(f"{what}: {per_call} device kernels per call "
             f"({sorted(ms_by_kernel)}); the kernel is one launch per call")
    # CUPTI may drop a record (per_call < 1): the mean recorded launch.
    ms /= per_call
    ms_by_kernel = {k: v / per_call for k, v in ms_by_kernel.items()}
    plain_ms = device_ms(torch, plain, min(8, n_layers), f"{what} plain")
    library_ms = device_ms(torch, sdpa, 4 * n_lib, f"{what} SDPA")
    bound_ms, bound_by = bound_of(kv_lens, b, h, hkv, dh, bs, quant)
    del q, kp, vp, ks, vs, bt, kvl, wins, sc
    torch.cuda.empty_cache()
    row = {"case": name, "variant": "int8" if quant else "bf16", "B": b, "H": h,
           "Hkv": hkv, "Dh": dh, "kv_tokens": sum(kv_lens),
           "max_kv_len": max(kv_lens), "max_abs_err": max_err,
           "max_row_rel_err": max_row_rel, "control_row_rel_err": controls,
           "ms": ms, "ms_by_kernel": ms_by_kernel, "recorded_per_call": per_call,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / ms, "library_ms": library_ms,
           "vs_library": ms / library_ms}
    log(f"kernel case {json.dumps(row)}")
    return row


def kernel_phase(torch, pa, device, seed, main_lens):
    rng = random.Random(seed)
    cases = []
    for (h, hkv, dh, n_layers, label) in ((24, 8, 128, 28, "llama-3b heads"),
                                          (32, 4, 64, 22, "llama-1b heads")):
        for b in (1, 8, 32):
            lens = [0, 1, 17, 4001][:b] if b > 1 else [4001]
            lens = lens + [rng.randint(1, 4096) for _ in range(b - len(lens))]
            cases.append((f"{label} B={b}", b, h, hkv, dh, lens, n_layers))
    # The main path's shape: the served batch mid-decode.
    cases.append(("main path llama-3b B=4", 4, 24, 8, 128, main_lens, 28))
    return [run_kernel_case(torch, pa, *c, seed=seed + i, device=device,
                            quant=quant)
            for quant in (False, True) for i, c in enumerate(cases)]


# ---------------------------------------------------------------- phase 4
def http(method, url, body=None, stream=False, timeout=600):
    """(status, parsed JSON or list of SSE payloads, t_first_event, t_end)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        if not stream:
            return resp.status, json.loads(resp.read()), None, time.monotonic()
        events, t_first = [], None
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: "):
                continue
            if t_first is None:
                t_first = time.monotonic()
            payload = line[len("data: "):]
            events.append(payload if payload == "[DONE]" else json.loads(payload))
        return resp.status, events, t_first, time.monotonic()


def make_prompts(seed: int, n: int):
    rng = random.Random(seed)
    words = ("the quick brown fox jumps over a lazy dog while serving "
             "paged attention kernels on one card keeps every stream busy "
             "tokens flow through the scheduler into the runner").split()
    out = []
    for i in range(n):
        target = 1000 + 250 * i            # ~1-2 kB of ByteTokenizer tokens
        text = []
        while sum(len(w) + 1 for w in text) < target:
            text.append(rng.choice(words))
        out.append(" ".join(text))
    return out


def trace_requests(torch, loop_run, n_tokens):
    """Profile one served round (prefill + one fused decode dispatch of the
    same 4 rows): host wall time, device busy time (sum of kernel times on
    the one stream) and the kernels that take it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        loop_run(n_tokens)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    by_name = {}
    count = 0
    for evt in prof.events():
        if str(evt.device_type).endswith("CUDA"):
            count += 1
            by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us()
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": wall, "device_busy_s": busy,
            "busy_share": busy / wall if wall else None, "kernel_launches": count,
            "top_ms": [[name[:80], us / 1e3] for name, us in top]}


def serving_phase(torch, pa, device, seed, prompts, card, kv_cache_dtype,
                  trace=False):
    """Serve llama-3b over HTTP with a KV pool of ``kv_cache_dtype``; the
    int8 pool gets the bf16 pool's bytes (so ~1.97x its blocks). Returns
    the launch counts of this run's main path."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.engine.engine import ServingEngine
    from production_stack_tpu_torch.models.config import resolve_model_config
    from production_stack_tpu_torch.server.api_server import OpenAIServer

    max_tokens = 64
    common = dict(model="llama-3b", dtype="bfloat16", attn_impl="paged",
                  device="cuda", max_model_len=4096, num_decode_steps=32,
                  seed=seed)
    mc = resolve_model_config("llama-3b")
    # 8 sequences x 4096 tokens of bf16 KV (~3.8 GB) + the null block
    pool_bytes = BF16_KV_BLOCKS * EngineConfig(**common).kv_cache_bytes_per_block(mc)
    cfg = EngineConfig(**common, kv_cache_dtype=kv_cache_dtype)
    cfg.num_kv_blocks = pool_bytes // cfg.kv_cache_bytes_per_block(mc)
    variant = pa.INT8 if cfg.kv_cache_quantized else pa.BF16
    t0 = time.monotonic()
    engine = ServingEngine(cfg)
    torch.cuda.synchronize()
    log(f"serving [{kv_cache_dtype} KV]: llama-3b engine up in "
        f"{time.monotonic() - t0:.3f} s (random bf16 weights, "
        f"{engine.runner.num_kv_blocks} KV blocks, "
        f"kv_pool_bytes {engine.runner.kv_pool_bytes}, "
        f"attn={engine.runner.attn_impl}, "
        f"weights+pool {torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    results = {}

    async def run():
        server = OpenAIServer(engine, "127.0.0.1", 0)
        await server.start()
        base = f"http://127.0.0.1:{server.port}"
        loop = asyncio.get_running_loop()
        reqs = [
            ("completion greedy", "/v1/completions", False,
             {"prompt": prompts[0], "max_tokens": max_tokens,
              "temperature": 0.0, "ignore_eos": True}),
            ("completion seeded", "/v1/completions", False,
             {"prompt": prompts[1], "max_tokens": max_tokens,
              "temperature": 0.8, "top_p": 0.9, "seed": 1234,
              "ignore_eos": True}),
            ("chat stream greedy", "/v1/chat/completions", True,
             {"messages": [{"role": "user", "content": prompts[2]}],
              "max_tokens": max_tokens, "temperature": 0.0, "stream": True,
              "stream_options": {"include_usage": True}, "ignore_eos": True}),
            ("chat stream seeded", "/v1/chat/completions", True,
             {"messages": [{"role": "user", "content": prompts[3]}],
              "max_tokens": max_tokens, "temperature": 0.7, "top_k": 50,
              "seed": 7, "stream": True,
              "stream_options": {"include_usage": True}, "ignore_eos": True}),
        ]
        st, body, _, _ = await loop.run_in_executor(
            None, http, "GET", base + "/health")
        if st != 200 or body.get("status") != "healthy":
            fail(f"/health: {st} {body}")
        st, body, _, _ = await loop.run_in_executor(
            None, http, "GET", base + "/v1/models")
        if st != 200 or body["data"][0]["id"] != cfg.model_name:
            fail(f"/v1/models: {st} {body}")
        # One short untimed request first: a served engine is warm (cuBLAS
        # handles, allocator pools, the kernel library's first load).
        st, body, _, _ = await loop.run_in_executor(
            None, http, "POST", base + "/v1/completions",
            {"prompt": "warm up", "max_tokens": 4, "temperature": 0.0,
             "ignore_eos": True})
        if st != 200 or body["usage"]["completion_tokens"] != 4:
            fail(f"warm-up request: {st} {body}")
        for key in ("decode_steps_total", "decode_tokens_total",
                    "decode_seconds_total", "prefill_seconds_total"):
            setattr(engine.runner, key, 0)
        engine.decode_dispatches_total = engine.prefill_dispatches_total = 0
        for key in pa.LAUNCHES:
            pa.LAUNCHES[key] = 0
        torch.cuda.reset_peak_memory_stats()
        t_start = time.monotonic()

        def one(name, path, stream, body):
            t = time.monotonic()
            st, out, t_first, t_end = http("POST", base + path, body, stream)
            results[name] = (st, out, t, t_first, t_end)

        await asyncio.gather(*[loop.run_in_executor(None, one, *r) for r in reqs])
        results["_wall"] = time.monotonic() - t_start
        results["_launches"] = dict(pa.LAUNCHES)
        results["_stats"] = engine.stats()
        results["_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if trace:
            def round_of(n_tokens):
                # The 4 greedy prompts again (their prefixes now hit the
                # prefix cache), 1 prefill token + one 32-step decode.
                def go(i):
                    http("POST", base + "/v1/completions", {
                        "prompt": prompts[i] + " again", "max_tokens": n_tokens,
                        "temperature": 0.0, "ignore_eos": True})
                threads = [threading.Thread(target=go, args=(i,)) for i in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()

            tr = await loop.run_in_executor(
                None, trace_requests, torch, round_of, 33)
            log(f"trace {json.dumps(tr)}")
        await server.stop()

    asyncio.run(run())
    engine.shutdown()
    stats = results["_stats"]
    ttfts = []
    for name in ("completion greedy", "completion seeded",
                 "chat stream greedy", "chat stream seeded"):
        st, out, t0_, t_first, t_end = results[name]
        if st != 200:
            fail(f"{name}: HTTP {st}")
        if isinstance(out, list):
            if out[-1] != "[DONE]":
                fail(f"{name}: stream did not end in [DONE]")
            usage = [e for e in out[:-1] if e.get("usage")]
            if not usage:
                fail(f"{name}: no usage chunk")
            n_out = usage[-1]["usage"]["completion_tokens"]
            finish = [c["finish_reason"] for e in out[:-1]
                      for c in e["choices"] if c.get("finish_reason")]
            ttfts.append(t_first - t0_)
        else:
            n_out = out["usage"]["completion_tokens"]
            finish = [out["choices"][0]["finish_reason"]]
        if n_out != max_tokens or finish != ["length"]:
            fail(f"{name}: {n_out} tokens (want {max_tokens}), finish {finish}")
        log(f"serving [{kv_cache_dtype} KV]: {name}: HTTP 200, {n_out} tokens, "
            f"finish=length, {t_end - t0_:.3f} s")
    steps = stats["decode_steps_total"]
    counts = results["_launches"]
    launches = counts[variant]
    n_layers = engine.model_config.num_layers
    if steps <= 0 or launches < n_layers * steps:
        fail(f"{variant} launches {launches} < {n_layers} layers x {steps} "
             "decode steps: decode did not go through the kernel")
    others = {k: v for k, v in counts.items() if k != variant and v}
    if others:
        fail(f"{kv_cache_dtype} KV run launched another variant: {others}")
    decode_tok_s = stats["decode_tokens_total"] / stats["decode_seconds_total"]
    log(f"serving [{kv_cache_dtype} KV]: {launches} {variant} launches over "
        f"{steps} decode steps ({stats['decode_dispatches_total']} decode "
        f"dispatches, {stats['prefill_dispatches_total']} prefill dispatches)")
    summary = {
        "card": card, "kv_cache_dtype": kv_cache_dtype,
        "kv_blocks": stats["kv_num_blocks"],
        "kv_pool_bytes": stats["kv_pool_bytes"], "wall_s": results["_wall"],
        "ttft_s_streamed": ttfts,
        "prefill_s_total": stats["prefill_seconds_total"],
        "decode_tokens": stats["decode_tokens_total"],
        "decode_s_total": stats["decode_seconds_total"],
        "decode_tok_s": decode_tok_s,
        "decode_ms_per_step": 1e3 * stats["decode_seconds_total"] / steps,
        "peak_mem_gib": results["_peak_gib"],
        "launches": counts, "decode_steps": steps,
    }
    log(f"serving result {json.dumps(summary)}")
    return counts


# ---------------------------------------------------------------- phase 5
def check_phase(torch, device, seed, quant):
    """One decode step at llama-3b width, depth cut to 2 layers: the paged
    path (kernel + dense ring segment + merge) against the plain window
    path (gathered window + window_attention) on the same pool, bf16 or
    int8 (the window path then dequantizes in its gather)."""
    from dataclasses import replace

    from production_stack_tpu_torch.models import llama
    from production_stack_tpu_torch.models.config import resolve_model_config
    from production_stack_tpu_torch.ops.attention import gather_window
    from production_stack_tpu_torch.ops.quantization import quantize_kv

    mc = replace(resolve_model_config("llama-3b"), num_layers=2)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    params = llama.init_params(mc, gen, torch.bfloat16, device)
    bs, b = 16, 4
    lens = [0, 33, 700, 1500]
    mb = 128
    blocks = torch.randperm(b * mb, generator=gen, device=device) + 1
    bt = blocks.view(b, mb).to(torch.int32).contiguous()
    shape = (mc.num_layers, mc.num_kv_heads, (b * mb + 1) * bs, mc.head_dim_)
    kp = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    vp = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
    ks = vs = None
    if quant:
        kp, ks = quantize_kv(kp)
        vp, vs = quantize_kv(vp)
    pos = torch.tensor(lens, dtype=torch.int32, device=device)
    toks = torch.randint(0, 256, (b, 1), generator=gen, device=device)
    ones = torch.ones((b,), dtype=torch.int32, device=device)
    h_p, _, _ = llama.forward(params, mc, toks, pos[:, None], ones,
                              paged=(kp, vp, ks, vs, bt, pos, bs))
    wk, wv = gather_window(kp, vp, bt, bs, ks, vs, out_dtype=torch.bfloat16)
    h_w, _, _ = llama.forward(params, mc, toks, pos[:, None], ones, wk, wv, pos)
    head = llama.lm_head_f32(params, mc)
    lg_p = llama.compute_logits(params, mc, h_p[:, 0], head)
    lg_w = llama.compute_logits(params, mc, h_w[:, 0], head)
    if not (torch.isfinite(lg_p).all() and tuple(lg_p.shape) == (b, mc.vocab_size)):
        fail("check: paged-path logits not finite or wrong shape")
    rel = ((h_p.float() - h_w.float()).norm() / h_w.float().norm()).item()
    agree = (lg_p.argmax(-1) == lg_w.argmax(-1)).float().mean().item()
    log(f"check [{'int8' if quant else 'bf16'} KV]: llama-3b width x2 layers, "
        f"paged (kernel) vs window (plain): "
        f"hidden rel err {rel:.3e}, logits max abs diff "
        f"{(lg_p - lg_w).abs().max().item():.3e}, argmax agreement {agree:.2f}")
    # bf16 activations, and the two paths round at different points (two
    # normalized segments merged vs one softmax): ~1e-2 is rounding.
    if rel > 5e-2:
        fail(f"check [{'int8' if quant else 'bf16'} KV]: hidden rel err "
             f"{rel:.3e} > 5e-2")


def check_noise(torch, device):
    """The seeded-sampling noise (jax.random's threefry Gumbel field, as
    the port computes it) is the same bits on the card as on the CPU, where
    the tests hold it to the JAX package's."""
    from production_stack_tpu_torch.engine.sampling import gumbel_noise

    seeds = [0, 1234, 2**32 - 1]
    on_card = gumbel_noise(seeds, 128256, device).cpu()
    on_cpu = gumbel_noise(seeds, 128256, torch.device("cpu"))
    n_diff = int((on_card.view(torch.int32) != on_cpu.view(torch.int32)).sum())
    log(f"check: Gumbel noise [3 x 128256] on the card vs the CPU: "
        f"{n_diff} values differ")
    if n_diff:
        fail(f"check: {n_diff} Gumbel values differ between the card and the CPU")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernel,serving,check",
                    help="comma list of kernel,serving,check,trace (build always "
                         "runs; trace profiles one more served round after "
                         "serving)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script needs "
              "one NVIDIA GPU", flush=True)
        sys.exit(2)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "production_stack_tpu_torch")):
        print("FAIL: the port package production_stack_tpu_torch/ is not "
              "beside this script (run it from a checkout)", flush=True)
        sys.exit(3)
    sys.path.insert(0, here)
    from production_stack_tpu_torch.engine.tokenizer import ByteTokenizer
    from production_stack_tpu_torch.ops import paged_attention as pa
    # Full-precision f32 products in every plain reference below.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    log(f"card: {card}")
    log(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.monotonic()
    lib_path, ptxas = pa.build_kernels()
    log(f"build: {lib_path} in {time.monotonic() - t0:.1f} s")
    for inst in kernel_instances(pa, ptxas):
        log(f"build: {json.dumps(inst)}")

    tok = ByteTokenizer(128256)
    prompts = make_prompts(args.seed, 4)
    # Served rows mid-decode: chat prompts carry the template's bytes.
    main_lens = [len(tok.encode(p)) + 32 for p in prompts]
    # Serving runs before the kernel phase: the kernel phase's profiler
    # must not perturb the serving numbers. Each serving run is one main
    # path: its launch counts are set to 0 before it and read after it.
    launches = {"bf16": None, "int8": None}
    if "serving" in phases:
        for kv in ("bfloat16", "int8"):
            variant = "int8" if kv == "int8" else "bf16"
            launches[variant] = serving_phase(
                torch, pa, device, args.seed, prompts, card, kv,
                trace="trace" in phases and kv == "bfloat16")[
                    pa.INT8 if variant == "int8" else pa.BF16]
            gc.collect()
            torch.cuda.empty_cache()
    if "check" in phases:
        for quant in (False, True):
            check_phase(torch, device, args.seed, quant)
        check_noise(torch, device)
    rows = []
    if "kernel" in phases:
        graph_check(torch, pa, device, args.seed, main_lens)
        rows = kernel_phase(torch, pa, device, args.seed, main_lens)

    kernels = []
    for variant, name in (("bf16", pa.BF16), ("int8", pa.INT8)):
        mine = [r for r in rows if r["variant"] == variant]
        main_row = next((r for r in mine if r["case"].startswith("main path")),
                        {})
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": KERNEL_REPLACES[variant],
            "launches": launches[variant],
            "max_abs_err": max((r["max_abs_err"] for r in mine), default=None),
            **{key: main_row.get(key) for key in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
