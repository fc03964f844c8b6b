"""Parameters for the port: the bridge from the JAX package's param pytree,
and the port's own random init.

``params_from_jax`` takes the JAX params exported as numpy
(``jax.tree.map(np.asarray, params)``, llama or OPT) and returns the same
stacked-layer dict as torch tensors, so a test can make both frameworks compute with the
same weights; ``kv_pools_from_jax`` carries the JAX runner's KV pools (state,
not weights) across the same way. The port's own random init is
``models/llama.py:init_params`` / ``models/opt.py:init_params``.
Checkpoint loading from a HuggingFace directory is not ported yet (ROADMAP).
"""

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models.config import ModelConfig

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {name!r} ({', '.join(_DTYPES)})")
    return _DTYPES[name]


def _to_tensor(arr, dtype: torch.dtype, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        # numpy has no bf16: reinterpret the raw 16 bits.
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr).copy())
    return t.to(device=device, dtype=dtype)


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    dtype: torch.dtype = torch.bfloat16,
                    device: Optional[torch.device] = None,
                    rank: int = 0, tp: int = 1) -> Dict:
    """JAX llama or OPT param tree (numpy leaves) -> the port's param dict,
    same keys, same ``[L, ...]`` layouts, ``x @ w`` orientation; with ``tp``
    > 1, tp rank ``rank``'s shard of it (parallel/sharding.py; llama
    only)."""
    from production_stack_tpu_torch.parallel.sharding import shard_params

    if cfg.arch not in ("llama", "opt"):
        raise ValueError(f"params_from_jax: arch {cfg.arch!r} is not ported")
    if cfg.arch == "opt" and tp > 1:
        raise ValueError("params_from_jax: OPT trees are not sharded (tp 1)")
    device = device if device is not None else torch.device("cpu")
    out = {
        k: _to_tensor(v, dtype, device)
        for k, v in np_tree.items() if k != "layers"
    }
    out["layers"] = {
        k: _to_tensor(v, dtype, device) for k, v in np_tree["layers"].items()
    }
    return shard_params(out, cfg, rank, tp) if tp > 1 else out


def _bf16_tensor(arr) -> torch.Tensor:
    """ml_dtypes bf16, or its raw bits viewed as uint16 -> torch bf16."""
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype == np.uint16:
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return _to_tensor(arr, torch.bfloat16, "cpu")


def kv_pools_from_jax(k, v, k_scale=None, v_scale=None,
                      device: Optional[torch.device] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                 Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The JAX runner's KV pools as numpy (``np.asarray(runner.kv_k)``
    etc.) -> the port's pool tensors, same ``[L, Hkv, num_slots, Dh]``
    layout and bits: int8 payload pools with bf16 scale pools
    ``[L, Hkv, num_slots]`` (ml_dtypes bf16 or its bits as uint16), or bf16
    / f32 pools with no scales."""
    device = device if device is not None else torch.device("cpu")

    def pool(arr):
        arr = np.asarray(arr)
        if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
            return _bf16_tensor(arr).to(device)
        return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)

    scales = [None if s is None else _bf16_tensor(s).to(device)
              for s in (k_scale, v_scale)]
    if (scales[0] is None) != (scales[1] is None):
        raise ValueError("kv_pools_from_jax: pass both scale pools or neither")
    return pool(k), pool(v), scales[0], scales[1]
