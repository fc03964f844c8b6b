"""Llama-family decoder (Llama 2/3, Mistral, Qwen2) in PyTorch.

Counterpart of ``production_stack_tpu/models/llama.py``. Parameters keep the
JAX package's layout: a plain dict whose decoder layers are STACKED on a
leading ``L`` axis, projections oriented ``x @ w`` ([in, out]). The forward
runs a Python loop over layers where the JAX package ran ``lax.scan``. The
rounding order follows the JAX code (``rms_norm`` casts back to the
activation dtype BEFORE the weight multiply; rope math in f32).

The caller (engine/runner.py) owns the paged pool. Window path: it gathers
the window before ``forward`` and scatters the returned (k_new, v_new)
after. Paged path (decode only): each layer attends against its slice of the
stacked pool through ops/paged_attention.py:paged_flash_decode_stats, merged
with the small dense ring + current-token segment.

Tensor parallelism (``tp``, a ``parallel/mesh.py:TPGroup``): every rank
holds its shard of the params (``parallel/sharding.py``) and runs the same
forward on its own heads; activations between the projections are
replicated. The collectives sit where the JAX package's sharding puts them:
the embedding rows are gathered over the hidden dim, the row-parallel
``wo`` and ``w_down`` products are all-reduced, and the head either
all-gathers each rank's vocab slice of the logits (``lm_head`` split on V)
or all-reduces partial logits (a tied head, ``embed`` split on D). The
paged decode runs ``paged_flash_decode_stats_tp`` over the rank's kv heads.
Where tp does not divide a leaf's split dim the leaf is replicated (the
reference's fallback), and its collective goes with it: a replicated
``wo``, ``w_down``, ``embed`` or head is a full product, never reduced or
gathered. Where tp does not divide the kv heads the pool is replicated
(``models/tp_plan.py:TPPlan``): every rank computes every kv head
(gathering the columns of a split ``wk`` / ``wv``), writes them all, and
attends its query heads against the kv heads their GQA groups read.

Sequence parallelism (``sp``, a ``parallel/mesh.py:SPRing``, prefill
only): each sp rank keeps its contiguous token shard of the chunk through
every layer, and attention is the distributed ring
(``ops/ring_attention.py``): a first chunk rings the chunk itself, a
continuation chunk its shard of the history window (slots at or past the
row's history length at ``WINDOW_SENTINEL``) followed by its chunk
tokens. The runner engages it under the reference's condition and gathers
what follows the forward.
"""

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.lora import lora_delta
from production_stack_tpu_torch.ops.attention import (
    _NEG_INF,
    dense_decode_stats,
    merge_attention_segments,
    window_attention,
)
from production_stack_tpu_torch.ops.paged_attention import (
    paged_flash_decode_stats,
    paged_flash_decode_stats_tp,
)
from production_stack_tpu_torch.models.tp_plan import (
    TPPlan,
    head_logits,
    tp_plan,
)
from production_stack_tpu_torch.ops import ring_attention
from production_stack_tpu_torch.parallel.sharding import check_tp, shard_leaf

Params = Dict


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def _rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables for the given absolute positions. positions: [B, T]."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    base = torch.full((), theta, dtype=torch.float32, device=positions.device)
    inv_freq = 1.0 / torch.pow(base, exps)
    angles = positions[..., None].float() * inv_freq             # [B, T, Dh/2]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """HF-convention rotary embedding (rotate-half). x: [B, T, H, Dh]."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# XLA's CPU f32 ``exp`` (Cephes): clamp, 2**n split with a two-part ln2,
# degree-5 polynomial; constants as the IR jax emits them.
_EXP_LO, _EXP_HI, _LOG2E, _LN2_HI, _LN2_LO = map(float.fromhex, (
    "-0x1.5f3334p+6", "0x1.633334p+6", "0x1.715476p+0", "0x1.63p-1",
    "-0x1.bd0106p-13"))
_EXP_P = tuple(map(float.fromhex, ("0x1.a0d2cep-13", "0x1.6e879cp-10",
                                   "0x1.11121p-7", "0x1.555382p-5",
                                   "0x1.555554p-3", "0x1p-1")))
_F32_TINY = float(torch.finfo(torch.float32).tiny)
_silu_tables: Dict[torch.device, torch.Tensor] = {}


def _ftz(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU runtime flushes subnormal f32 inputs and results to zero."""
    return torch.where(x.abs() < _F32_TINY, x * 0.0, x)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add through f64 (the f32 product is exact there)."""
    return (a.double() * b + c).float()


def _xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.exp`` of f32 values bit for bit as jax's CPU backend computes
    it on an x86 machine with FMA: every multiply-add of the range
    reduction and the polynomial is contracted into an FMA."""
    x = torch.clamp(_ftz(x), _EXP_LO, _EXP_HI)
    n = torch.clamp(torch.floor(_fma(x, _LOG2E, 0.5)), -127.0, 127.0)
    r = _fma(-n, _LN2_LO, _fma(-n, _LN2_HI, x))
    y = _fma(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma(y, r, p)
    y = _fma(y, r * r, r) + 1.0
    two_n = ((n.to(torch.int32) << 23) + 0x3F800000).view(torch.float32)
    return _ftz(y * two_n)


def _silu_table() -> torch.Tensor:
    """Jitted ``jax.nn.silu`` of every bf16 value, indexed by its 16 bits.
    XLA's CPU fusion rounds to bf16 after each op of ``x * (1 / (1 +
    exp(-x)))``, with its own ``exp``; a NaN comes out as the quiet NaN of
    its sign (x86's default NaN is negative: silu(-inf) = -inf * 0)."""
    bits = torch.arange(65536, dtype=torch.int32).to(torch.int16)
    x = _ftz(bits.view(torch.bfloat16).float())

    def bf(v):
        return v.to(torch.bfloat16).float()

    e = bf(_xla_exp_f32(bf(-x)))
    r = bf(_ftz(1.0 / bf(e + 1.0)))
    out = _ftz(x * r).to(torch.bfloat16).view(torch.int16)
    nan_bits = torch.where(x.isnan(), bits & -0x8000, -0x8000) | 0x7FC0
    return torch.where((x * r).isnan(), nan_bits.to(torch.int16),
                       out).view(torch.bfloat16)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the JAX package computes it. bf16: a lookup in a
    table of all 65,536 results (one gather, bit for bit the jitted JAX
    function on the CPU); other dtypes: ``F.silu``."""
    if x.dtype != torch.bfloat16:
        return F.silu(x)
    table = _silu_tables.get(x.device)
    if table is None:
        table = _silu_tables[x.device] = _silu_table().to(x.device)
    return table[x.view(torch.int16).long()]


def empty_params(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None,
                 rank: int = 0, tp: int = 1) -> Params:
    """Zeroed params of their final shapes (rank ``rank``'s shard at
    ``tp`` > 1), dtype and device: what ``init_params`` and
    ``models/weights.py:load_hf_params`` fill in place. Allocating them
    first lets the runner size its KV pool net of the weights before a
    background thread fills them."""
    check_tp(tp)
    d, f, dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    h, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size

    def leaf(name, shape):
        shape = shard_leaf(name, torch.empty(shape, device="meta"), rank,
                           tp).shape
        return torch.zeros(shape, dtype=dtype, device=device)

    layers = {
        "attn_norm": leaf("attn_norm", (nl, d)),
        "mlp_norm": leaf("mlp_norm", (nl, d)),
        "wq": leaf("wq", (nl, d, h * dh)),
        "wk": leaf("wk", (nl, d, hkv * dh)),
        "wv": leaf("wv", (nl, d, hkv * dh)),
        "wo": leaf("wo", (nl, h * dh, d)),
        "w_gate": leaf("w_gate", (nl, d, f)),
        "w_up": leaf("w_up", (nl, d, f)),
        "w_down": leaf("w_down", (nl, f, d)),
    }
    if cfg.attention_bias:
        layers["bq"] = leaf("bq", (nl, h * dh))
        layers["bk"] = leaf("bk", (nl, hkv * dh))
        layers["bv"] = leaf("bv", (nl, hkv * dh))
    params = {"embed": leaf("embed", (v, d)), "layers": layers,
              "final_norm": leaf("final_norm", (d,))}
    if not cfg.tie_word_embeddings:
        params["lm_head"] = leaf("lm_head", (d, v))
    return params


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None,
                rank: int = 0, tp: int = 1, out: Optional[Params] = None
                ) -> Params:
    """Random weights (the JAX package's scheme: N(0, 1/fan_in), unit norms),
    drawn on ``device`` from ``generator`` (which must live on that device)
    into ``out`` (``empty_params``; allocated here when None) in place.
    Each stacked leaf is drawn one layer at a time in f32 so the peak extra
    memory is one layer, not the whole model. With ``tp`` > 1 every leaf
    is still drawn in full, in the same order, and rank ``rank`` keeps its
    slice (parallel/sharding.py): the ranks together hold exactly the
    weights a tp=1 engine draws from the same seed."""
    device = device if device is not None else generator.device
    if out is None:
        out = empty_params(cfg, dtype, device, rank, tp)
    d, f, dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    h, hkv, nl, v = cfg.num_heads, cfg.num_kv_heads, cfg.num_layers, cfg.vocab_size
    layers = out["layers"]

    def draw(name, shape, fan_in):
        x = (torch.randn(shape, generator=generator, device=device,
                         dtype=torch.float32) * fan_in ** -0.5).to(dtype)
        return shard_leaf(name, x, rank, tp)

    def w(name, shape, fan_in):
        for i in range(shape[0]):
            layers[name][i] = draw(name, shape[1:], fan_in)

    layers["attn_norm"].fill_(1)
    layers["mlp_norm"].fill_(1)
    w("wq", (nl, d, h * dh), d)
    w("wk", (nl, d, hkv * dh), d)
    w("wv", (nl, d, hkv * dh), d)
    w("wo", (nl, h * dh, d), h * dh)
    w("w_gate", (nl, d, f), d)
    w("w_up", (nl, d, f), d)
    w("w_down", (nl, f, d), f)
    for name in ("bq", "bk", "bv"):
        if name in layers:
            layers[name].zero_()
    out["embed"].copy_(draw("embed", (v, d), d))
    out["final_norm"].fill_(1)
    if not cfg.tie_word_embeddings:
        out["lm_head"].copy_(draw("lm_head", (d, v), d))
    return out


def _layer_body(
    cfg: ModelConfig,
    hidden: torch.Tensor,       # [B, T, D]
    lp: Dict,                   # one layer's params (leading L axis sliced off)
    cos: torch.Tensor,
    sin: torch.Tensor,
    positions: torch.Tensor,
    chunk_lens: torch.Tensor,
    win_k, win_v, win_len,
    ring_k, ring_v, ring_pos,
    paged=None,                 # (pool_k, pool_v, k_scale, v_scale,
                                #  block_tables, kv_lens, bs)
    layer_idx: int = 0,
    tp=None,                    # TPGroup when tensor_parallel_size > 1
    chunk_bias=None,            # [T, T] additive in-chunk bias (tree verify)
    lora=None,                  # (adapter_idx [B], {target: (A, B)} ONE layer)
    plan: TPPlan = None,        # forward's, for this rank of ``tp``
    sp=None,                    # SPRing: the prefill chunk rings
    win_pos=None,               # [B, S/sp] positions of the rank's window shard
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t, d = hidden.shape
    dh = cfg.head_dim_

    def proj(x, target):
        out = x @ lp[target]
        if lora is not None and target in lora[1]:
            la, lb = lora[1][target]
            out = out + lora_delta(x, la, lb, lora[0])
        return out

    x = rms_norm(hidden, lp["attn_norm"], cfg.rms_norm_eps)
    q = proj(x, "wq")
    k = proj(x, "wk")
    v = proj(x, "wv")
    if cfg.attention_bias:
        q = q + lp["bq"]
        k = k + lp["bk"]
        v = v + lp["bv"]
    if plan.q_gather:
        q = tp.all_gather(q, dim=-1)[..., plan.h0 * dh:plan.h1 * dh]
    if plan.kv_gather:
        k, v = tp.all_gather(torch.stack([k, v]), dim=-1).unbind(0)
    # This rank's query heads and the pool's kv heads.
    h, hkv = q.shape[-1] // dh, k.shape[-1] // dh
    q = apply_rope(q.reshape(b, t, h, dh), cos, sin)
    k = apply_rope(k.reshape(b, t, hkv, dh), cos, sin)
    v = v.reshape(b, t, hkv, dh)

    if sp is not None:
        # Sequence-parallel prefill (the reference's ring engagement): q, k
        # and v hold this rank's token shard; a continuation chunk's keys
        # are its window shard followed by its chunk tokens.
        ks, vs = plan.kv(k, 2), plan.kv(v, 2)
        if win_k is None:
            attn = ring_attention.ring_attention_shard(
                q, positions, ks, vs, positions, sp, "first")
        else:
            kw = plan.kv(win_k, 0).permute(1, 2, 0, 3)   # [B, S/sp, Hkv, Dh]
            vw = plan.kv(win_v, 0).permute(1, 2, 0, 3)
            attn = ring_attention.ring_attention_shard(
                q, positions, torch.cat([kw, ks], dim=1),
                torch.cat([vw, vs], dim=1),
                torch.cat([win_pos, positions], dim=1), sp, "continuation")
    elif paged is not None:
        # Paged decode (T == 1): the pool segment runs in the flash-decode
        # kernel directly against this layer of the stacked pool; the
        # intra-dispatch ring + the current token form a small dense
        # segment; the two merge by their softmax stats. Int8 pools carry
        # their scale pools (None for bf16) into the kernel's int8 variant.
        pool_k, pool_v, k_scale, v_scale, block_tables, kv_lens, block_size = paged
        q2 = q.reshape(b, h, dh)
        # tp > 1: the pool holds this rank's kv heads and q2 the matching
        # query heads; tables and lengths are replicated.
        decode = paged_flash_decode_stats_tp if tp is not None \
            else paged_flash_decode_stats
        out_p, m_p, l_p = decode(
            q2, pool_k, pool_v, block_tables, kv_lens, layer_idx,
            block_size=block_size, k_scale=k_scale, v_scale=v_scale,
        )
        kc = k.permute(2, 0, 1, 3)              # [Hkv, B, 1, Dh] current token
        vc = v.permute(2, 0, 1, 3)
        self_bias = torch.zeros((b, 1), dtype=torch.float32, device=hidden.device)
        if ring_k is not None:
            keys = torch.cat([ring_k, kc], dim=2)
            vals = torch.cat([ring_v, vc], dim=2)
            ring_bias = torch.zeros(
                ring_pos.shape, dtype=torch.float32, device=hidden.device
            ).masked_fill_(ring_pos >= positions, _NEG_INF)   # [B, R]
            bias = torch.cat([ring_bias, self_bias], dim=1)
        else:
            keys, vals, bias = kc, vc, self_bias
        out_d, m_d, l_d = dense_decode_stats(q2, keys, vals, bias)
        attn = merge_attention_segments(out_p, m_p, l_p, out_d, m_d, l_d)
        attn = attn.reshape(b, t, h, dh)
    else:
        attn = window_attention(
            q, plan.kv(k, 2), plan.kv(v, 2), positions, chunk_lens,
            plan.kv(win_k, 0), plan.kv(win_v, 0), win_len,
            plan.kv(ring_k, 0), plan.kv(ring_v, 0), ring_pos,
            chunk_bias=chunk_bias,
        )
    # Row-parallel products (and their LoRA deltas, over this rank's input
    # rows of A) are partial sums until the all-reduce; a replicated wo or
    # w_down is the full product.
    attn = attn.reshape(b, t, h * dh)
    if plan.o_cols is not None:
        o = tp.all_reduce(proj(attn[..., plan.o_cols[0]:plan.o_cols[1]], "wo"))
    else:
        o = proj(attn, "wo")
    hidden = hidden + o

    x = rms_norm(hidden, lp["mlp_norm"], cfg.rms_norm_eps)
    gated = silu(proj(x, "w_gate")) * proj(x, "w_up")
    mlp = proj(gated, "w_down")
    if plan.mlp_reduce:
        mlp = tp.all_reduce(mlp)
    # New KV in pool layout [Hkv, B, T, Dh] for the runner's single scatter.
    return hidden + mlp, k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3)


def forward(
    params: Params,
    cfg: ModelConfig,
    token_ids: torch.Tensor,     # [B, T]
    positions: torch.Tensor,     # [B, T]
    chunk_lens: torch.Tensor,    # [B] valid tokens per row
    win_k: Optional[torch.Tensor] = None,    # [L, Hkv, B, S, Dh] gathered window
    win_v: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,  # [B]
    ring_k: Optional[torch.Tensor] = None,   # [L, Hkv, B, R, Dh]
    ring_v: Optional[torch.Tensor] = None,
    ring_pos: Optional[torch.Tensor] = None,  # [B, R]
    *,
    paged=None,  # (pool_k [L,Hkv,S,Dh], pool_v, k_scale [L,Hkv,S] | None,
                 #  v_scale | None, block_tables [B,Mb], kv_lens [B],
                 #  block_size) — paged decode path
    tp=None,     # TPGroup when tensor_parallel_size > 1 (Hkv: the pool's)
    chunk_bias=None,  # [T, T] additive in-chunk bias: the speculative
                      # token-tree verify (ops/tree_mask.py), window path
    lora=None,   # (adapter_idx [B], {target: (A [L,Na+1,in,r], B [L,Na+1,r,out])})
    sp=None,     # SPRing: ring-attend this prefill chunk over the sp ranks
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (hidden [B,T,D], k_new [L,Hkv,B,T,Dh], v_new [L,Hkv,B,T,Dh]).
    ``lora``: each row's adapter index and the registry's stacks (models/
    lora.py), indexed by layer like the params; index 0 adds exactly 0.
    With ``sp`` (sp ranks, T divisible by them, a window's S too) this
    rank keeps tokens [s*T/sp, (s+1)*T/sp) of the chunk: hidden, k_new and
    v_new hold those (T/sp of them); the window holds every slot."""
    win_pos = None
    if sp is not None:
        n = token_ids.shape[1] // sp.size
        part = slice(sp.rank * n, (sp.rank + 1) * n)
        token_ids, positions = token_ids[:, part], positions[:, part]
        if win_k is not None:
            w = win_k.shape[3] // sp.size
            lo = sp.rank * w
            slots = torch.arange(lo, lo + w, dtype=torch.int32,
                                 device=positions.device)
            win_pos = torch.where(
                slots[None, :] < win_len[:, None], slots[None, :],
                torch.full((), ring_attention.WINDOW_SENTINEL,
                           dtype=torch.int32, device=positions.device))
            win_k, win_v = win_k[:, :, :, lo:lo + w], win_v[:, :, :, lo:lo + w]
    plan = tp_plan(cfg, tp)
    hidden = params["embed"][token_ids.long()]
    if plan.embed_split:
        # embed is split on D: every rank's columns of the same rows.
        hidden = tp.all_gather(hidden, dim=-1)
    hidden = hidden.to(win_k.dtype if win_k is not None else params["embed"].dtype)
    cos, sin = _rope_cos_sin(positions, cfg.head_dim_, cfg.rope_theta)
    layers = params["layers"]
    k_out, v_out = [], []
    for i in range(cfg.num_layers):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        hidden, k_l, v_l = _layer_body(
            cfg, hidden, lp, cos, sin, positions, chunk_lens,
            win_k[i] if win_k is not None else None,
            win_v[i] if win_v is not None else None,
            win_len,
            ring_k[i] if ring_k is not None else None,
            ring_v[i] if ring_v is not None else None,
            ring_pos,
            paged=paged, layer_idx=i, tp=tp, chunk_bias=chunk_bias,
            lora=(None if lora is None else
                  (lora[0], {n: (a[i], b[i]) for n, (a, b) in lora[1].items()})),
            plan=plan, sp=sp, win_pos=win_pos,
        )
        k_out.append(k_l)
        v_out.append(v_l)
    hidden = rms_norm(hidden, params["final_norm"], cfg.rms_norm_eps)
    return hidden, torch.stack(k_out), torch.stack(v_out)


def lm_head_f32(params: Params, cfg: ModelConfig,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The output projection [D, V] widened to f32 once: ``compute_logits``
    then multiplies bf16 values exactly in f32 with f32 accumulation, as the
    JAX package's ``preferred_element_type=float32`` dot does. From sharded
    params it is this rank's share: [D, V/tp] (``lm_head`` split), [D/tp,
    V] (a tied ``embed`` split), or all of it where the leaf is replicated.
    ``out``: an f32 tensor of that shape to fill in place (the same
    values)."""
    head = params["embed"].t() if cfg.tie_word_embeddings else params["lm_head"]
    if out is not None:
        return out.copy_(head)
    return head.float().contiguous()


def compute_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
                   head_f32: Optional[torch.Tensor] = None,
                   tp=None) -> torch.Tensor:
    """hidden [..., D] -> logits [..., V] in float32. ``head_f32`` is the
    cached ``lm_head_f32`` (computed here when not given). With ``tp``, the
    full logits on every rank, bit-identical across ranks
    (``tp_plan.head_logits``)."""
    if head_f32 is None:
        head_f32 = lm_head_f32(params, cfg)
    return head_logits(cfg, hidden, head_f32, tp)
