"""Megatron-style tensor-parallel sharding of the llama params and the KV
pools: rank r's slices.

Counterpart of ``production_stack_tpu/parallel/sharding.py``
(``param_shardings``, ``kv_pool_sharding``, ``kv_scale_sharding``), with the
same rules by leaf name:
  * column-parallel ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up`` (and the
    biases ``bq``, ``bk``, ``bv``): the OUTPUT (last) dim is split;
  * row-parallel ``wo``, ``w_down``: the INPUT dim (second to last) is
    split, so their products are partial sums that ``models/llama.py``
    all-reduces;
  * ``embed`` [V, D]: the hidden dim D is split; ``lm_head`` [D, V]: the
    vocab V is split; norms are replicated;
  * KV pools [L, Hkv, slots, Dh] and int8 scale pools [L, Hkv, slots]:
    the kv-head dim is split.
Splits are contiguous blocks: rank r holds q heads [r*H/tp, (r+1)*H/tp)
and the kv heads of those GQA groups, [r*Hkv/tp, (r+1)*Hkv/tp).

A batch of whole KV blocks (the offload tier's and the handoff's payload
[n, L, Hkv, bs, Dh], an int8 pool's scales [n, L, Hkv, bs]) splits into
the same head ranges along its head axis (``shard_kv_blocks``), and
``join_kv_blocks`` puts the ranks' slices back in rank order: the blob a
tp > 1 pool writes is the one a tp = 1 pool writes.

Where the JAX package replicates a leaf whose dim tp does not divide
(``_shard_if_divisible``), the port raises a ``ValueError``: the
replication fallback is not ported (ROADMAP).
"""

from typing import Dict, Optional

import torch

from production_stack_tpu_torch.models.config import ModelConfig

COLUMN = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "bq", "bk", "bv"})
ROW = frozenset({"wo", "w_down"})


def check_tp(cfg: ModelConfig, tp: int) -> None:
    """Raise a ValueError unless ``tp`` divides both head counts and every
    dim the rules split (hidden, intermediate, vocab)."""
    if tp < 1:
        raise ValueError(f"tensor_parallel_size must be >= 1, got {tp}")
    if cfg.num_heads % tp or cfg.num_kv_heads % tp:
        raise ValueError(
            f"--tensor-parallel-size {tp} must divide the model's head "
            f"counts: model {cfg.name!r} has {cfg.num_heads} query heads and "
            f"{cfg.num_kv_heads} kv heads (heads are split into contiguous "
            "blocks per rank; replicating them is not ported)")
    for what, n in (("hidden_size", cfg.hidden_size),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(
                f"--tensor-parallel-size {tp} must divide the model's {what} "
                f"{n} (replicating an indivisible leaf is not ported)")


def _split(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def shard_leaf(name: str, leaf: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the param leaf ``name`` (a layer leaf with
    or without its leading L axis: the rules index dims from the end)."""
    if tp == 1:
        return leaf
    if name in COLUMN or name in ("embed", "lm_head"):
        return _split(leaf, -1, rank, tp)
    if name in ROW:
        return _split(leaf, -2, rank, tp)
    return leaf


def shard_params(params: Dict, cfg: ModelConfig, rank: int, tp: int) -> Dict:
    """Rank ``rank``'s shard of the port's param dict (the layout of
    ``models/llama.py``): the leaves of device r of the JAX package's
    ``jax.device_put(params, param_shardings(cfg, mesh, params))``."""
    check_tp(cfg, tp)
    return {k: ({n: shard_leaf(n, t, rank, tp) for n, t in v.items()}
                if k == "layers" else shard_leaf(k, v, rank, tp))
            for k, v in params.items()}


def shard_kv_pool(pool: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s kv heads of a payload pool [L, Hkv, slots, Dh] or a
    scale pool [L, Hkv, slots]."""
    return _split(pool, 1, rank, tp) if tp > 1 else pool


# The head axis of a block batch [n, L, Hkv, bs(, Dh)].
BLOCK_HEAD_AXIS = 2


def shard_kv_blocks(blocks: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s kv heads of a block batch [n, L, Hkv, bs, Dh] (or
    scales [n, L, Hkv, bs]): the heads ``shard_kv_pool`` gives the rank."""
    return _split(blocks, BLOCK_HEAD_AXIS, rank, tp) if tp > 1 else blocks


def join_kv_blocks(parts, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse of ``shard_kv_blocks``: every rank's slice of a block
    batch, in rank order, joined along the head axis (into ``out`` when
    given)."""
    return torch.cat(list(parts), BLOCK_HEAD_AXIS, out=out)
