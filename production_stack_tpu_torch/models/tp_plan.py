"""How one tensor-parallel rank's forward reads its shard, for both model
families (``models/llama.py``, ``models/opt.py``).

Which leaves are split is ``parallel/sharding.py``'s rule alone
(``split_dim``, ``kv_heads_split``), asked of the config's leaf shapes;
``TPPlan`` says what follows from it for the forward: the rank's query
heads, what to gather, and which products are partial sums that the
model all-reduces. ``head_logits`` is the one output projection of both
families at any tp.
"""

import functools
from typing import Optional

import torch

from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel.sharding import (
    kv_heads_split,
    split_dim,
)


class TPPlan:
    """How one tp rank's forward reads its shard (the identity at tp = 1):
    the rank's query heads [h0, h1); whether its ``wq`` columns end
    mid-head (``q_gather``: q is gathered whole, then its heads taken);
    whether ``wk`` / ``wv`` are split while the pool is replicated
    (``kv_gather``: k and v are gathered whole); the kv heads its queries
    read (``kv``: the pool's heads as they stand where tp splits them, else
    the range its GQA groups cover, repeated per query head where its heads
    cut a group); and which products are partial sums (``o_cols``: the
    columns of the heads' output its ``wo`` rows take, None where ``wo`` is
    replicated; ``mlp_reduce``: the MLP's row-parallel leaf, llama's
    ``w_down`` or OPT's ``fc2``; ``embed_split``: ``embed``, and OPT's
    ``pos_embed`` beside it, split on D; ``head_split``). OPT's kv heads
    are its heads (no GQA). ``tp_plan`` builds one per (config, tp size,
    rank)."""

    def __init__(self, cfg: ModelConfig, n: int = 1, r: int = 0):
        h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size

        def split(name, shape):
            return split_dim(name, shape, n) is not None

        self.g = h // hkv
        self.h0, self.h1 = 0, h
        self.q_gather = self.kv_gather = False
        self.kv_range = None       # (first kv head, end) read from the pool
        self.expand = None         # (offset, count) of the repeated heads
        self.o_cols = None
        self.mlp_reduce = split("fc2" if cfg.arch == "opt" else "w_down",
                                (f, d))
        self.embed_split = split("embed", (v, d))
        # OPT's head is its embedding, whatever the config says.
        self.tied = cfg.tie_word_embeddings or cfg.arch == "opt"
        self.head_split = self.embed_split if self.tied \
            else split("lm_head", (d, v))
        if n == 1:
            return
        if kv_heads_split(hkv, n):
            # Heads, kv heads and their GQA groups split together.
            self.h0, self.h1 = r * h // n, (r + 1) * h // n
            self.o_cols = (0, (self.h1 - self.h0) * dh)
            return
        # The replicated pool: every kv head on every rank.
        self.kv_gather = split("wk", (d, hkv * dh))
        if split("wq", (d, h * dh)):
            c = h * dh // n
            c0, c1 = r * c, (r + 1) * c
            self.h0, self.h1 = c0 // dh, -(-c1 // dh)
            self.q_gather = c0 % dh != 0 or c1 % dh != 0
            self.o_cols = (c0 - self.h0 * dh, c1 - self.h0 * dh)
        k0, k1 = self.h0 // self.g, -(-self.h1 // self.g)
        self.kv_range = (k0, k1)
        if self.h0 % self.g or self.h1 % self.g:
            self.expand = (self.h0 - k0 * self.g, self.h1 - self.h0)

    def kv(self, t: Optional[torch.Tensor], dim: int) -> Optional[torch.Tensor]:
        """The kv heads this rank's queries read, of ``t`` (heads on
        ``dim``)."""
        if t is None or self.kv_range is None:
            return t
        k0, k1 = self.kv_range
        t = t.narrow(dim, k0, k1 - k0)
        if self.expand is not None:
            t = t.repeat_interleave(self.g, dim=dim).narrow(dim, *self.expand)
        return t


@functools.lru_cache(maxsize=None)
def _plan(cfg: ModelConfig, n: int, r: int) -> TPPlan:
    return TPPlan(cfg, n, r)


def tp_plan(cfg: ModelConfig, tp=None) -> TPPlan:
    """This rank's ``TPPlan`` under ``tp`` (None: tp = 1), built once per
    (config, tp size, rank)."""
    return _plan(cfg, tp.size, tp.rank) if tp is not None else _plan(cfg, 1, 0)


def head_logits(cfg: ModelConfig, hidden: torch.Tensor,
                head_f32: torch.Tensor, tp=None) -> torch.Tensor:
    """hidden [..., D] times this rank's f32 head (``lm_head_f32`` of the
    family) -> the full logits [..., V] in float32 on every rank,
    bit-identical across ranks: the vocab slices all-gathered (an untied
    ``lm_head`` split on V), or the partial logits over each rank's D
    slice all-reduced in f32 (a tied head, ``embed`` split on D); a
    replicated head is the full product."""
    plan = tp_plan(cfg, tp)
    if not plan.head_split:
        return torch.matmul(hidden.float(), head_f32)
    if plan.tied:
        dl = head_f32.shape[0]
        part = hidden[..., tp.rank * dl:(tp.rank + 1) * dl]
        return tp.all_reduce(torch.matmul(part.float(), head_f32))
    return tp.all_gather(torch.matmul(hidden.float(), head_f32), dim=-1)
