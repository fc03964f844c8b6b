"""Parameters for the port: HuggingFace checkpoint loading, the bridge
from the JAX package's param pytree, and the port's own random init.

``load_hf_params`` is ``production_stack_tpu/models/weights.py``'s loader:
a LOCAL model directory of ``*.safetensors`` shards (through
``model.safetensors.index.json`` when there is one; read by
``models/safetensors_io.py``, the port's own reader) or
``pytorch_model*.bin`` files, mapped onto the stacked-layer dict by the
same name maps, transposed to ``x @ w`` the same way, and refused on the
same gaps. Each tensor goes to the device as it is read, into its layer
of a preallocated ``[L, ...]`` stack there (the caller's, when it
allocated the params beforehand: the runner fills them on a background
thread), so host memory holds about one tensor, not the checkpoint; at
tp > 1 each rank keeps only its shard (``parallel/sharding.py``).

``params_from_jax`` takes the JAX params exported as numpy
(``jax.tree.map(np.asarray, params)``, llama or OPT) and returns the same
stacked-layer dict as torch tensors, so a test can make both frameworks compute with the
same weights; ``kv_pools_from_jax`` carries the JAX runner's KV pools (state,
not weights) across the same way. The port's own random init is
``models/llama.py:init_params`` / ``models/opt.py:init_params``.
"""

import os
import re
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"Unknown dtype {name!r} ({', '.join(_DTYPES)})")
    return _DTYPES[name]


_LAYER_RE = re.compile(r"\.(?:layers|decoder\.layers)\.(\d+)\.")

# HF suffix -> (our leaf name, transpose?) for llama-family models.
_LLAMA_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.o_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "mlp.gate_proj.weight": ("w_gate", True),
    "mlp.up_proj.weight": ("w_up", True),
    "mlp.down_proj.weight": ("w_down", True),
    "input_layernorm.weight": ("attn_norm", False),
    "post_attention_layernorm.weight": ("mlp_norm", False),
}
_LLAMA_TOP = {
    "model.embed_tokens.weight": ("embed", False),
    "model.norm.weight": ("final_norm", False),
    "lm_head.weight": ("lm_head", True),
}

_OPT_MAP = {
    "self_attn.q_proj.weight": ("wq", True),
    "self_attn.k_proj.weight": ("wk", True),
    "self_attn.v_proj.weight": ("wv", True),
    "self_attn.out_proj.weight": ("wo", True),
    "self_attn.q_proj.bias": ("bq", False),
    "self_attn.k_proj.bias": ("bk", False),
    "self_attn.v_proj.bias": ("bv", False),
    "self_attn.out_proj.bias": ("bo", False),
    "self_attn_layer_norm.weight": ("ln1_w", False),
    "self_attn_layer_norm.bias": ("ln1_b", False),
    "final_layer_norm.weight": ("ln2_w", False),
    "final_layer_norm.bias": ("ln2_b", False),
    "fc1.weight": ("fc1", True),
    "fc1.bias": ("fc1_b", False),
    "fc2.weight": ("fc2", True),
    "fc2.bias": ("fc2_b", False),
}
_OPT_TOP = {
    "model.decoder.embed_tokens.weight": ("embed", False),
    "model.decoder.embed_positions.weight": ("pos_embed", False),
    "model.decoder.final_layer_norm.weight": ("final_ln_w", False),
    "model.decoder.final_layer_norm.bias": ("final_ln_b", False),
}


def _required_layer_leaves(cfg: ModelConfig) -> set:
    """Per-layer leaves every valid checkpoint must provide for the arch."""
    if cfg.arch == "llama":
        req = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
               "attn_norm", "mlp_norm"}
        if cfg.attention_bias:
            req |= {"bq", "bk", "bv"}
        return req
    # OPT: the forward unconditionally reads the bias/norm leaves too.
    return {"wq", "wk", "wv", "wo", "bq", "bk", "bv", "bo",
            "fc1", "fc1_b", "fc2", "fc2_b",
            "ln1_w", "ln1_b", "ln2_w", "ln2_b"}


def _iter_checkpoint_tensors(model_dir: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (hf_name, CPU tensor) streaming over the checkpoint's shards:
    safetensors files through the port's reader (each tensor views the
    file's memory map until the next one), else ``pytorch_model*.bin``."""
    st_files = safetensors_io.checkpoint_files(model_dir)
    if st_files:
        for path in st_files:
            yield from safetensors_io.iter_file(path)
        return
    bin_files = sorted(
        f for f in os.listdir(model_dir)
        if f.startswith("pytorch_model") and f.endswith(".bin")
    )
    if not bin_files:
        raise FileNotFoundError(
            f"No *.safetensors or pytorch_model*.bin in {model_dir}"
        )
    for fname in bin_files:
        state = torch.load(os.path.join(model_dir, fname), map_location="cpu",
                           weights_only=True)
        for name in list(state):
            yield name, state.pop(name)


def load_hf_params(cfg: ModelConfig, model_dir: str,
                   dtype: torch.dtype = torch.bfloat16, device="cuda",
                   rank: int = 0, tp: int = 1,
                   out: Optional[Dict] = None) -> Dict:
    """Load an HF checkpoint directory into the stacked-layer dict of
    ``models/llama.py`` / ``models/opt.py`` (the JAX ``load_hf_params``:
    its maps, transposes and refusals), in ``dtype`` on ``device`` (the
    card unless the caller asks for the CPU). ``out``: the params to fill
    in place (``models.empty_params``; allocated here when None). Each
    tensor is cast and transposed on the device and written into its layer
    of the leaf's ``[L, ...]`` stack there; with ``tp`` > 1 only rank
    ``rank``'s slice of it is kept (``parallel/sharding.py``). A tensor
    whose leaf the model has no use for is skipped; one of another shape
    than its leaf, and a leaf left without a tensor, are refused."""
    from production_stack_tpu_torch.models import empty_params
    from production_stack_tpu_torch.parallel.sharding import shard_leaf

    device = torch.device(device)
    if out is None:
        out = empty_params(cfg, dtype, device, rank, tp)
    per_layer_map = _LLAMA_MAP if cfg.arch == "llama" else _OPT_MAP
    top_map = _LLAMA_TOP if cfg.arch == "llama" else _OPT_TOP
    nl = cfg.num_layers
    stacks = out["layers"]                 # our layer leaf -> [L, ...] stack

    def place(hf_name, ours, tensor, transpose, dst):
        t = tensor.to(device).to(dtype)
        t = shard_leaf(ours, t.t() if transpose else t, rank, tp)
        if t.shape != dst.shape:
            raise ValueError(
                f"Checkpoint tensor {hf_name} has shape {tuple(t.shape)} "
                f"(rank {rank} of {tp}) where the config's {ours} has "
                f"{tuple(dst.shape)}")
        dst.copy_(t)

    filled: Dict[str, set] = {k: set() for k in stacks}  # layer indices
    top_filled = set()
    for hf_name, tensor in _iter_checkpoint_tensors(model_dir):
        m = _LAYER_RE.search(hf_name)
        if m is not None:
            layer_idx = int(m.group(1))
            mapped = per_layer_map.get(hf_name[m.end():])
            if mapped is None:
                logger.debug("Skipping unmapped tensor %s", hf_name)
                continue
            ours, transpose = mapped
            if layer_idx >= nl:
                raise ValueError(
                    f"Checkpoint tensor {hf_name} indexes layer {layer_idx} "
                    f"but the config has only {nl} layers"
                )
            if ours not in stacks:
                logger.debug("Skipping tensor %s: the config has no %s",
                             hf_name, ours)
                continue
            place(hf_name, ours, tensor, transpose, stacks[ours][layer_idx])
            filled[ours].add(layer_idx)
        else:
            mapped = top_map.get(hf_name)
            if mapped is None or mapped[0] not in out:
                # a tied config's lm_head among them
                logger.debug("Skipping unmapped tensor %s", hf_name)
                continue
            ours, transpose = mapped
            place(hf_name, ours, tensor, transpose, out[ours])
            top_filled.add(ours)

    # Completeness is checked per LAYER-INDEX SET, not by count: a sharded
    # checkpoint that repeats layer 0 and omits layer 7 has the right count
    # but would serve garbage for the missing layer.
    all_layers = set(range(nl))
    holes = {k: sorted(all_layers - s) for k, s in filled.items()
             if s and s != all_layers}
    if holes:
        raise ValueError(f"Incomplete checkpoint: missing layer indices {holes}")
    absent = sorted(k for k, s in filled.items()
                    if not s and k in _required_layer_leaves(cfg))
    absent += sorted(k for k in out if k != "layers" and k not in top_filled)
    if absent:
        raise ValueError(
            f"Incomplete checkpoint: no tensors at all for {absent}"
        )
    logger.info("Loaded %d layer stacks + %d top-level tensors from %s",
                len(stacks), len(top_filled), model_dir)
    return out


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
    > 1, tp rank ``rank``'s shard of it (parallel/sharding.py, either
    family)."""
    from production_stack_tpu_torch.parallel.sharding import shard_params

    if cfg.arch not in ("llama", "opt"):
        raise ValueError(f"params_from_jax: arch {cfg.arch!r} is not ported")
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
