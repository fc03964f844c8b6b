"""OPT-family decoder (facebook/opt-125m, tiny-opt) in PyTorch.

Counterpart of ``production_stack_tpu/models/opt.py``, in the idiom of
``models/llama.py``: a plain param dict with decoder layers STACKED on a
leading ``L`` axis, projections oriented ``x @ w``, a Python loop over
layers. OPT's architecture: LayerNorm with bias (normalized in f32, cast
back to the activation dtype before the affine), learned position
embeddings with OPT's +2 offset, a ReLU MLP, the LM head tied to the
embedding. It serves on the window path only (the paged kernel is
llama-family by policy, ``engine/config.py:resolved_attn_impl``), at any
tensor_parallel_size; the speculative engine takes it as a draft.

Tensor parallelism (``tp``, a ``parallel/mesh.py:TPGroup``) follows
``models/llama.py`` through the same ``models/tp_plan.py:TPPlan``: every
rank holds its shard (``parallel/sharding.py``: q, k, v, ``fc1`` and their
biases split by columns, ``wo`` and ``fc2`` by rows, ``embed`` and
``pos_embed`` on D) and runs its own heads. The two embedding lookups give
each rank its D slice of the sum, gathered in rank order before the first
layer norm; the ``wo`` and ``fc2`` products are partial sums, all-reduced
before the replicated ``bo`` / ``fc2_b`` are added, once; the tied head,
split on D, gives partial logits over the whole vocab that are all-reduced
in f32. Where tp does not divide the heads the pool is replicated and the
plan's gathers apply (``q_gather``, ``kv_gather``, ``o_cols``). Prefill
chunks are never rung over an sp ring (the reference rings the llama
family only).
"""

from typing import Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.models.tp_plan import (
    TPPlan,
    head_logits,
    tp_plan,
)
from production_stack_tpu_torch.ops.attention import window_attention
from production_stack_tpu_torch.parallel.sharding import check_tp, shard_leaf

Params = Dict
_OPT_POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _shapes(cfg: ModelConfig) -> Dict:
    """Every leaf's shape: {top-level name: shape, "layers": {name: shape}}."""
    d, f = cfg.hidden_size, cfg.intermediate_size
    h, dh, nl, v = cfg.num_heads, cfg.head_dim_, cfg.num_layers, cfg.vocab_size
    return {
        "embed": (v, d),
        "pos_embed": (cfg.max_position_embeddings + _OPT_POS_OFFSET, d),
        "layers": {
            "ln1_w": (nl, d), "ln1_b": (nl, d),
            "ln2_w": (nl, d), "ln2_b": (nl, d),
            "wq": (nl, d, h * dh), "bq": (nl, h * dh),
            "wk": (nl, d, h * dh), "bk": (nl, h * dh),
            "wv": (nl, d, h * dh), "bv": (nl, h * dh),
            "wo": (nl, h * dh, d), "bo": (nl, d),
            "fc1": (nl, d, f), "fc1_b": (nl, f),
            "fc2": (nl, f, d), "fc2_b": (nl, d),
        },
        "final_ln_w": (d,),
        "final_ln_b": (d,),
    }


def empty_params(cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                 device: Optional[torch.device] = None,
                 rank: int = 0, tp: int = 1) -> Params:
    """Zeroed params of their final shapes (rank ``rank``'s shard at
    ``tp`` > 1), dtype and device (see ``models/llama.py:empty_params``)."""
    check_tp(tp)

    def leaf(name, shape):
        shape = shard_leaf(name, torch.empty(shape, device="meta"), rank,
                           tp).shape
        return torch.zeros(shape, dtype=dtype, device=device)

    return {k: ({n: leaf(n, s) for n, s in v.items()} if k == "layers"
                else leaf(k, v))
            for k, v in _shapes(cfg).items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None,
                rank: int = 0, tp: int = 1, out: Optional[Params] = None
                ) -> Params:
    """Random weights (the JAX package's scheme: N(0, 1/fan_in), unit
    norms, zero biases), drawn on ``device`` from ``generator`` into
    ``out`` (``empty_params``; allocated here when None) in place. With
    ``tp`` > 1 every leaf is still drawn in full, in the same order, and
    rank ``rank`` keeps its slice: the ranks together hold exactly the
    weights a tp = 1 engine draws from the same seed."""
    device = device if device is not None else generator.device
    if out is None:
        out = empty_params(cfg, dtype, device, rank, tp)
    d, f = cfg.hidden_size, cfg.intermediate_size
    h, dh = cfg.num_heads, cfg.head_dim_
    shapes = _shapes(cfg)
    layers = out["layers"]

    def w(tree, full, name, fan_in):
        x = (torch.randn(full[name], generator=generator, device=device,
                         dtype=torch.float32) * fan_in ** -0.5).to(dtype)
        tree[name].copy_(shard_leaf(name, x, rank, tp))

    for name in ("ln1_w", "ln2_w"):
        layers[name].fill_(1)
    for name in ("ln1_b", "ln2_b", "bq", "bk", "bv", "bo", "fc1_b", "fc2_b"):
        layers[name].zero_()
    for name, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", h * dh),
                         ("fc1", d), ("fc2", f)):
        w(layers, shapes["layers"], name, fan_in)
    w(out, shapes, "embed", d)
    w(out, shapes, "pos_embed", d)
    out["final_ln_w"].fill_(1)
    out["final_ln_b"].zero_()
    return out


def _layer_body(cfg: ModelConfig, hidden: torch.Tensor, lp: Dict,
                positions, chunk_lens, win_k, win_v, win_len,
                ring_k, ring_v, ring_pos, chunk_bias=None, tp=None,
                plan: TPPlan = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t, d = hidden.shape
    dh = cfg.head_dim_

    x = layer_norm(hidden, lp["ln1_w"], lp["ln1_b"])
    q = x @ lp["wq"] + lp["bq"]
    k = x @ lp["wk"] + lp["bk"]
    v = x @ lp["wv"] + lp["bv"]
    if plan.q_gather:
        q = tp.all_gather(q, dim=-1)[..., plan.h0 * dh:plan.h1 * dh]
    if plan.kv_gather:
        k, v = tp.all_gather(torch.stack([k, v]), dim=-1).unbind(0)
    # This rank's heads and the pool's (OPT: kv heads are heads).
    h, hkv = q.shape[-1] // dh, k.shape[-1] // dh
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, hkv, dh)
    v = v.reshape(b, t, hkv, dh)
    attn = window_attention(
        q, plan.kv(k, 2), plan.kv(v, 2), positions, chunk_lens,
        plan.kv(win_k, 0), plan.kv(win_v, 0), win_len,
        plan.kv(ring_k, 0), plan.kv(ring_v, 0), ring_pos,
        chunk_bias=chunk_bias,
    ).reshape(b, t, h * dh)
    # Row-parallel products are partial sums until the all-reduce; the
    # replicated biases join once, after it.
    if plan.o_cols is not None:
        o = tp.all_reduce(attn[..., plan.o_cols[0]:plan.o_cols[1]] @ lp["wo"])
    else:
        o = attn @ lp["wo"]
    hidden = hidden + o + lp["bo"]

    x = layer_norm(hidden, lp["ln2_w"], lp["ln2_b"])
    # OPT's activation is ReLU (HF OPTConfig's default, facebook/opt-125m's).
    mlp = torch.relu(x @ lp["fc1"] + lp["fc1_b"]) @ lp["fc2"]
    if plan.mlp_reduce:
        mlp = tp.all_reduce(mlp)
    return (hidden + (mlp + lp["fc2_b"]), k.permute(2, 0, 1, 3),
            v.permute(2, 0, 1, 3))


def forward(
    params: Params,
    cfg: ModelConfig,
    token_ids: torch.Tensor,     # [B, T]
    positions: torch.Tensor,     # [B, T]
    chunk_lens: torch.Tensor,    # [B]
    win_k: Optional[torch.Tensor] = None,
    win_v: Optional[torch.Tensor] = None,
    win_len: Optional[torch.Tensor] = None,
    ring_k: Optional[torch.Tensor] = None,
    ring_v: Optional[torch.Tensor] = None,
    ring_pos: Optional[torch.Tensor] = None,
    *,
    paged=None,
    tp=None,
    chunk_bias=None,
    lora=None,
    sp=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Same contract as ``models/llama.py:forward``, window path only; no
    chunk rings (the reference rings the llama family only). With ``tp``
    the embedding sum is each rank's D slice where ``embed`` and
    ``pos_embed`` are split, gathered in rank order here."""
    assert paged is None, "paged decode is llama-family only (policy)"
    assert lora is None, "LoRA serving is llama-family only"
    assert sp is None, "ring attention is llama-family only"
    plan = tp_plan(cfg, tp)
    hidden = (params["embed"][token_ids.long()]
              + params["pos_embed"][positions.long() + _OPT_POS_OFFSET])
    if plan.embed_split:
        hidden = tp.all_gather(hidden, dim=-1)
    hidden = hidden.to(win_k.dtype if win_k is not None
                       else params["embed"].dtype)
    layers = params["layers"]
    k_out, v_out = [], []
    for i in range(cfg.num_layers):
        lp = {name: leaf[i] for name, leaf in layers.items()}
        hidden, k_l, v_l = _layer_body(
            cfg, hidden, lp, positions, chunk_lens,
            win_k[i] if win_k is not None else None,
            win_v[i] if win_v is not None else None,
            win_len,
            ring_k[i] if ring_k is not None else None,
            ring_v[i] if ring_v is not None else None,
            ring_pos, chunk_bias=chunk_bias, tp=tp, plan=plan,
        )
        k_out.append(k_l)
        v_out.append(v_l)
    hidden = layer_norm(hidden, params["final_ln_w"], params["final_ln_b"])
    return hidden, torch.stack(k_out), torch.stack(v_out)


def lm_head_f32(params: Params, cfg: ModelConfig,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tied output projection [D, V] widened to f32 once (see
    ``models/llama.py:lm_head_f32``; this rank's [D/tp, V] where ``embed``
    is split; ``out`` is filled in place)."""
    if out is not None:
        return out.copy_(params["embed"].t())
    return params["embed"].t().float().contiguous()


def compute_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
                   head_f32: Optional[torch.Tensor] = None,
                   tp=None) -> torch.Tensor:
    """hidden [..., D] -> logits [..., V] in float32 (the reference's bf16
    dot with f32 accumulation, exact in f32 here); with ``tp`` the full
    logits on every rank (``tp_plan.head_logits``: the partial logits of
    each rank's D slice all-reduced in f32)."""
    if head_f32 is None:
        head_f32 = lm_head_f32(params, cfg)
    return head_logits(cfg, hidden, head_f32, tp)
