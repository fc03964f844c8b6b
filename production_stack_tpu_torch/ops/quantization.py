"""Symmetric int8 KV-cache quantization (``kv_cache_dtype="int8"``).

Counterpart of ``production_stack_tpu/ops/quantization.py``, with the same
arithmetic so the two packages store bit-identical pools from the same K/V.
K/V are stored as int8 with one bf16 scale per (layer, kv head, slot):
``scale = max|x| / 127`` over the head dim, rounded to bf16 BEFORE q is
derived (so ``dequantize(quantize(x))`` is exactly what every later reader
reconstructs), ``q = clip(round(x / scale), -127, 127)`` with round half to
even; an all-zero vector keeps scale 0 and q 0. Dequantization is one f32
multiply.

An int8 pool costs ``Dh + 2`` bytes per (slot, head) against ``2 * Dh`` for
bf16, so it holds ``2 * Dh / (Dh + 2)`` times the tokens in the same memory
(1.97x at Dh = 128) and the decode kernel reads about half the bytes.
"""

from typing import Tuple

import torch

KV_CACHE_DTYPES = ("bfloat16", "int8")
SCALE_DTYPE = torch.bfloat16
SCALE_ITEMSIZE = 2
_QMAX = 127.0


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., Dh] float -> (int8 [..., Dh], scale SCALE_DTYPE [...])."""
    xf = x.float()
    scale = (xf.abs().amax(dim=-1) / _QMAX).to(SCALE_DTYPE)
    sf = scale.float()
    # 0-scale rows (all-zero KV vectors, e.g. the null block) divide by 1.
    safe = torch.where(sf > 0, sf, torch.ones_like(sf))
    q = torch.clamp(torch.round(xf / safe[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """(int8 [..., Dh], scale [...]) -> [..., Dh] in ``dtype``: one f32
    multiply, shared by every reader of the pool."""
    return (q.float() * scale.float()[..., None]).to(dtype)
