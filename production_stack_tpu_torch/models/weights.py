"""Parameters for the port: the bridge from the JAX package's param pytree,
and the port's own random init.

``params_from_jax`` takes the JAX params exported as numpy
(``jax.tree.map(np.asarray, params)``) and returns the same stacked-layer
dict as torch tensors, so a test can make both frameworks compute with the
same weights. The port's own random init is ``models/llama.py:init_params``.
Checkpoint loading from a HuggingFace directory is not ported yet (ROADMAP).
"""

from typing import Dict, Optional

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
                    device: Optional[torch.device] = None) -> Dict:
    """JAX llama param tree (numpy leaves) -> the port's param dict, same
    keys, same ``[L, ...]`` layouts, ``x @ w`` orientation."""
    if cfg.arch != "llama":
        raise ValueError(f"params_from_jax: arch {cfg.arch!r} is not ported")
    device = device if device is not None else torch.device("cpu")
    out = {
        k: _to_tensor(v, dtype, device)
        for k, v in np_tree.items() if k != "layers"
    }
    out["layers"] = {
        k: _to_tensor(v, dtype, device) for k, v in np_tree["layers"].items()
    }
    return out
