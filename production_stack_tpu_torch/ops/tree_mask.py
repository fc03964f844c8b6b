"""Token-tree layout and attention bias for tree speculation.

A copy of ``production_stack_tpu/ops/tree_mask.py`` (numpy only; the port
imports nothing of the JAX package). The verify chunk of one draft/verify
cycle is a small tree (SpecInfer, arXiv:2305.09781): the draft proposes W
alternatives at the FIRST speculated position and a linear continuation
behind the first. For draft depth N and width W the chunk holds T = N + W
nodes, laid out so that W == 1 is exactly the linear chunk [t0, p1, .., pN]:

    index 0              — root: the row's current token t0 (depth 0)
    index 1              — the seeded common-random-number draft sample p1
                           (depth 1), the linear path's first proposal
    indices 2 .. W       — the draft's top (W-1) OTHER step-1 tokens
                           (depth 1, siblings of index 1)
    indices W+1 .. W+N-1 — the linear continuation p2 .. pN behind p1
                           (depth 2 .. N; the parent chain starts at 1)

Siblings share an absolute position (root position + depth), so the
position-causal in-chunk mask of ``ops/attention.py:window_attention``
would let them attend each other; the tree enters attention as an ADDITIVE
bias [T, T]: 0 where the key node is an ancestor-or-self of the query node,
the f32 floor elsewhere. Every ancestor is also position-causal (strictly
smaller depth), so adding it to the causal bias is an exact AND.

The runner turns the bias into a device tensor once, when it is built.
"""

from typing import Tuple

import numpy as np
import torch  # noqa: F401 — every module of the port is a torch module

_NEG_INF = float(np.finfo(np.float32).min)


def tree_structure(n_spec: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(parents, depths) int32 arrays of length n_spec + width for the
    first-position-branching tree of the module docstring; parents[0] is -1
    (the root), depths[0] is 0."""
    if n_spec < 1:
        raise ValueError(f"n_spec must be >= 1, got {n_spec}")
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    t = n_spec + width
    parents = np.empty((t,), np.int32)
    depths = np.empty((t,), np.int32)
    parents[0], depths[0] = -1, 0
    # Depth-1 fan: the CRN sample (index 1) plus width-1 alternatives.
    parents[1:width + 1] = 0
    depths[1:width + 1] = 1
    # Linear continuation behind index 1 only.
    prev = 1
    for d in range(2, n_spec + 1):
        idx = width + d - 1
        parents[idx] = prev
        depths[idx] = d
        prev = idx
    return parents, depths


def ancestor_matrix(parents: np.ndarray) -> np.ndarray:
    """Boolean [T, T]: anc[q, k] is True iff node k is node q or one of its
    ancestors — the keys node q's query may attend inside the chunk."""
    t = parents.shape[0]
    anc = np.zeros((t, t), bool)
    for q in range(t):
        node = q
        while node >= 0:
            anc[q, node] = True
            node = int(parents[node])
    return anc


def tree_attention_bias(parents: np.ndarray) -> np.ndarray:
    """Additive float32 bias [T, T] of the in-chunk attention segment: 0 on
    ancestor-or-self pairs, the f32 floor elsewhere (the floor
    ``window_attention`` masks with)."""
    anc = ancestor_matrix(parents)
    return np.where(anc, 0.0, _NEG_INF).astype(np.float32)


def main_chain_indices(n_spec: int, width: int) -> np.ndarray:
    """Node indices of the linear chain [t0, p1, p2 .. pN] in the tree
    layout, in chain order (length n_spec + 1); arange(n_spec + 1) at
    width 1."""
    return np.array(
        [0, 1] + list(range(width + 1, width + n_spec)), np.int32
    )
