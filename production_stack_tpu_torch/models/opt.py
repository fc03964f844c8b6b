"""OPT-family decoder (facebook/opt-125m, tiny-opt) in PyTorch.

Counterpart of ``production_stack_tpu/models/opt.py``, in the idiom of
``models/llama.py``: a plain param dict with decoder layers STACKED on a
leading ``L`` axis, projections oriented ``x @ w``, a Python loop over
layers. OPT's architecture: LayerNorm with bias (normalized in f32, cast
back to the activation dtype before the affine), learned position
embeddings with OPT's +2 offset, a ReLU MLP, the LM head tied to the
embedding. It serves on the window path only (the paged kernel is
llama-family by policy, ``engine/config.py:resolved_attn_impl``), at
tensor_parallel_size 1; the speculative engine takes it as a draft.
"""

from typing import Dict, Optional, Tuple

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.ops.attention import window_attention

Params = Dict
_OPT_POS_OFFSET = 2  # HF OPTLearnedPositionalEmbedding offset


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def _check_tp(tp: int) -> None:
    if tp != 1:
        raise ValueError("the OPT family is served at tensor_parallel_size 1 "
                         f"only, got {tp}")


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
    """Zeroed params of their final shapes, dtype and device (see
    ``models/llama.py:empty_params``)."""
    _check_tp(tp)
    return {k: ({n: torch.zeros(s, dtype=dtype, device=device)
                 for n, s in v.items()} if k == "layers"
                else torch.zeros(v, dtype=dtype, device=device))
            for k, v in _shapes(cfg).items()}


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device: Optional[torch.device] = None,
                rank: int = 0, tp: int = 1, out: Optional[Params] = None
                ) -> Params:
    """Random weights (the JAX package's scheme: N(0, 1/fan_in), unit
    norms, zero biases), drawn on ``device`` from ``generator`` into
    ``out`` (``empty_params``; allocated here when None) in place."""
    _check_tp(tp)
    device = device if device is not None else generator.device
    if out is None:
        out = empty_params(cfg, dtype, device, rank, tp)
    d, f = cfg.hidden_size, cfg.intermediate_size
    h, dh = cfg.num_heads, cfg.head_dim_
    layers = out["layers"]

    def w(dst, fan_in):
        dst.copy_((torch.randn(dst.shape, generator=generator, device=device,
                               dtype=torch.float32) * fan_in ** -0.5).to(dtype))

    for name in ("ln1_w", "ln2_w"):
        layers[name].fill_(1)
    for name in ("ln1_b", "ln2_b", "bq", "bk", "bv", "bo", "fc1_b", "fc2_b"):
        layers[name].zero_()
    for name, fan_in in (("wq", d), ("wk", d), ("wv", d), ("wo", h * dh),
                         ("fc1", d), ("fc2", f)):
        w(layers[name], fan_in)
    w(out["embed"], d)
    w(out["pos_embed"], d)
    out["final_ln_w"].fill_(1)
    out["final_ln_b"].zero_()
    return out


def _layer_body(cfg: ModelConfig, hidden: torch.Tensor, lp: Dict,
                positions, chunk_lens, win_k, win_v, win_len,
                ring_k, ring_v, ring_pos, chunk_bias=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, t, d = hidden.shape
    h, dh = cfg.num_heads, cfg.head_dim_

    x = layer_norm(hidden, lp["ln1_w"], lp["ln1_b"])
    q = (x @ lp["wq"] + lp["bq"]).reshape(b, t, h, dh)
    k = (x @ lp["wk"] + lp["bk"]).reshape(b, t, h, dh)
    v = (x @ lp["wv"] + lp["bv"]).reshape(b, t, h, dh)
    attn = window_attention(
        q, k, v, positions, chunk_lens,
        win_k, win_v, win_len, ring_k, ring_v, ring_pos,
        chunk_bias=chunk_bias,
    )
    hidden = hidden + attn.reshape(b, t, h * dh) @ lp["wo"] + lp["bo"]

    x = layer_norm(hidden, lp["ln2_w"], lp["ln2_b"])
    # OPT's activation is ReLU (HF OPTConfig's default, facebook/opt-125m's).
    mlp = torch.relu(x @ lp["fc1"] + lp["fc1_b"]) @ lp["fc2"] + lp["fc2_b"]
    return hidden + mlp, k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3)


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
    chunk rings (the reference rings the llama family only)."""
    assert paged is None, "paged decode is llama-family only (policy)"
    assert lora is None, "LoRA serving is llama-family only"
    assert tp is None, "the OPT family is served at tensor_parallel_size 1"
    assert sp is None, "ring attention is llama-family only"
    hidden = (params["embed"][token_ids.long()]
              + params["pos_embed"][positions.long() + _OPT_POS_OFFSET])
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
            ring_pos, chunk_bias=chunk_bias,
        )
        k_out.append(k_l)
        v_out.append(v_l)
    hidden = layer_norm(hidden, params["final_ln_w"], params["final_ln_b"])
    return hidden, torch.stack(k_out), torch.stack(v_out)


def lm_head_f32(params: Params, cfg: ModelConfig,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tied output projection [D, V] widened to f32 once (see
    ``models/llama.py:lm_head_f32``; ``out`` is filled in place)."""
    if out is not None:
        return out.copy_(params["embed"].t())
    return params["embed"].t().float().contiguous()


def compute_logits(params: Params, cfg: ModelConfig, hidden: torch.Tensor,
                   head_f32: Optional[torch.Tensor] = None,
                   tp=None) -> torch.Tensor:
    """hidden [..., D] -> logits [..., V] in float32 (the reference's bf16
    dot with f32 accumulation, exact in f32 here)."""
    assert tp is None, "the OPT family is served at tensor_parallel_size 1"
    if head_f32 is None:
        head_f32 = lm_head_f32(params, cfg)
    return torch.matmul(hidden.float(), head_f32)
