"""Megatron-style tensor-parallel sharding of the params (llama and OPT)
and the KV pools: rank r's slices.

Counterpart of ``production_stack_tpu/parallel/sharding.py``
(``param_shardings``, ``kv_pool_sharding``, ``kv_scale_sharding``), with the
same rules by leaf name, for both families:
  * column-parallel ``wq``, ``wk``, ``wv``, ``w_gate``, ``w_up``, ``fc1``
    (and the biases ``bq``, ``bk``, ``bv``, ``fc1_b``): the OUTPUT (last)
    dim is split;
  * row-parallel ``wo``, ``w_down``, ``fc2``: the INPUT dim (second to
    last) is split, so their products are partial sums that the model
    all-reduces (OPT's ``bo`` and ``fc2_b`` are then added once);
  * ``embed`` [V, D] and OPT's ``pos_embed`` [P, D]: the hidden dim D is
    split; ``lm_head`` [D, V]: the vocab V is split; norms, OPT's
    layer norms and its ``bo`` / ``fc2_b`` are replicated;
  * KV pools [L, Hkv, slots, Dh] and int8 scale pools [L, Hkv, slots]:
    the kv-head dim is split.
Splits are contiguous blocks: rank r holds columns (or rows) [r*n/tp,
(r+1)*n/tp) of a split dim of size n.

The replication fallback is the reference's (``_shard_if_divisible``): a
leaf whose split dim tp does not divide is replicated, whole on every rank
(``split_dim`` says which dim a leaf splits, or None). The pools split
their kv heads only when tp divides Hkv. A split need not fall on head
boundaries (``wk`` at Hkv 2, Dh 32, tp 4 splits 64 columns into 16s);
``models/tp_plan.py`` says what a rank's heads then need gathered, and
which products are partial sums.

A batch of whole KV blocks (the offload tier's and the handoff's payload
[n, L, Hkv, bs, Dh], an int8 pool's scales [n, L, Hkv, bs]) splits into
the same head ranges along its head axis (``shard_kv_blocks``), and
``join_kv_blocks`` puts the ranks' slices back in rank order: the blob a
tp > 1 pool writes is the one a tp = 1 pool writes.
"""

from typing import Dict, Optional

import torch

from production_stack_tpu_torch.models.config import ModelConfig

COLUMN = frozenset({"wq", "wk", "wv", "w_gate", "w_up", "fc1",
                    "bq", "bk", "bv", "fc1_b"})
ROW = frozenset({"wo", "w_down", "fc2"})
# Split on their hidden dim D (the last).
EMBEDDINGS = frozenset({"embed", "pos_embed"})


def check_tp(tp: int) -> None:
    """The one check the reference makes of the degree itself."""
    if tp < 1:
        raise ValueError(f"tensor_parallel_size must be >= 1, got {tp}")


def split_dim(name: str, shape, tp: int) -> Optional[int]:
    """The dim of param leaf ``name`` (of ``shape``, with or without its
    leading L axis) that tp ranks split, or None where the leaf is
    replicated: tp is 1, the leaf is a norm, or tp does not divide the
    dim the rules name (the reference's ``_shard_if_divisible``)."""
    if tp == 1:
        return None
    if name in COLUMN or name in EMBEDDINGS or name == "lm_head":
        dim = -1
    elif name in ROW:
        dim = -2
    else:
        return None
    return dim if shape[dim] % tp == 0 else None


def _split(t: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    n = t.shape[dim] // tp
    return t.narrow(dim, rank * n, n).contiguous()


def shard_leaf(name: str, leaf: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s slice of the param leaf ``name`` (a layer leaf with
    or without its leading L axis: the rules index dims from the end);
    the whole leaf where it is replicated."""
    dim = split_dim(name, leaf.shape, tp)
    return leaf if dim is None else _split(leaf, dim, rank, tp)


def shard_params(params: Dict, cfg: ModelConfig, rank: int, tp: int) -> Dict:
    """Rank ``rank``'s shard of the port's param dict (the layout of
    ``models/llama.py`` or ``models/opt.py``): the leaves of device r of the JAX package's
    ``jax.device_put(params, param_shardings(cfg, mesh, params))``."""
    check_tp(tp)
    return {k: ({n: shard_leaf(n, t, rank, tp) for n, t in v.items()}
                if k == "layers" else shard_leaf(k, v, rank, tp))
            for k, v in params.items()}


def kv_heads_split(num_kv_heads: int, tp: int) -> bool:
    """Whether tp ranks split the kv heads of the pools (else every rank
    holds all of them: the reference's ``kv_pool_sharding``)."""
    return tp > 1 and num_kv_heads % tp == 0


def shard_kv_pool(pool: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s kv heads of a payload pool [L, Hkv, slots, Dh] or a
    scale pool [L, Hkv, slots]."""
    return _split(pool, 1, rank, tp) if kv_heads_split(pool.shape[1], tp) \
        else pool


# The head axis of a block batch [n, L, Hkv, bs(, Dh)].
BLOCK_HEAD_AXIS = 2


def shard_kv_blocks(blocks: torch.Tensor, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s kv heads of a block batch [n, L, Hkv, bs, Dh] (or
    scales [n, L, Hkv, bs]): the heads ``shard_kv_pool`` gives the rank."""
    if kv_heads_split(blocks.shape[BLOCK_HEAD_AXIS], tp):
        return _split(blocks, BLOCK_HEAD_AXIS, rank, tp)
    return blocks


def join_kv_blocks(parts, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The inverse of ``shard_kv_blocks``: every rank's slice of a block
    batch, in rank order, joined along the head axis (into ``out`` when
    given)."""
    return torch.cat(list(parts), BLOCK_HEAD_AXIS, out=out)
