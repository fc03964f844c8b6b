"""LoRA adapters for the llama-family serving path.

Counterpart of ``production_stack_tpu/models/lora.py``:

  * Adapters load from HF PEFT checkpoints (``adapter_config.json`` +
    ``adapter_model.safetensors``, read by ``models/safetensors_io.py``)
    into the ``x @ W`` convention of the base params, with per-layer stacks
    on a leading L axis; the ``alpha / r`` scaling is folded into B.
  * The engine stacks ALL registered adapters per target into
    ``[L, Na+1, in, r_max]`` / ``[L, Na+1, r_max, out]`` device tensors
    (index 0 is the zero adapter = base model; ranks pad to r_max). One
    batch mixes adapters freely: each row carries an adapter index (packed
    scalar row 8) and the delta is two small per-row batched products
    inside the layer loop, so one captured decode graph serves any mix.
  * Per-request selection follows the vLLM API convention: requesting
    ``model=<adapter name>`` serves base weights + that adapter's delta.

The delta runs as two ``torch.bmm`` calls, as the JAX package runs it as two
``jnp.einsum`` outside any Pallas kernel. At tensor_parallel_size > 1 each
rank keeps its slice of the stacks (``shard_stacks``): B's output columns
for the column-parallel targets, A's input rows for the row-parallel ones,
whose partial delta joins the partial product before the all-reduce.
"""

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch

from production_stack_tpu_torch.models import safetensors_io
from production_stack_tpu_torch.models.config import ModelConfig
from production_stack_tpu_torch.parallel.sharding import COLUMN, ROW, _split
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

# Model param name -> HF PEFT module name.
TARGET_TO_PEFT = {
    "wq": "q_proj", "wk": "k_proj", "wv": "v_proj", "wo": "o_proj",
    "w_gate": "gate_proj", "w_up": "up_proj", "w_down": "down_proj",
}
PEFT_TO_TARGET = {v: k for k, v in TARGET_TO_PEFT.items()}


def _target_dims(cfg: ModelConfig, target: str) -> Tuple[int, int]:
    d, f, dh = cfg.hidden_size, cfg.intermediate_size, cfg.head_dim_
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    return {
        "wq": (d, h * dh), "wk": (d, hkv * dh), "wv": (d, hkv * dh),
        "wo": (h * dh, d), "w_gate": (d, f), "w_up": (d, f),
        "w_down": (f, d),
    }[target]


@dataclass
class LoRAAdapter:
    """One adapter: per-target (A [L, in, r], B [L, r, out]) with the
    alpha/rank scaling already folded into B."""

    name: str
    rank: int
    layers: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict
    )


def load_peft_adapter(name: str, path: str, cfg: ModelConfig,
                      dtype: torch.dtype = torch.bfloat16) -> LoRAAdapter:
    """Load an HF PEFT checkpoint directory.

    Key format: ``base_model.model.model.layers.{i}.self_attn.q_proj.
    lora_A.weight`` (A: [r, in], B: [out, r], torch out-major) — transposed
    here into the x@W convention (A' [in, r], B' [r, out]). Scaled and
    cast in f32, as the JAX loader does on numpy."""
    with open(os.path.join(path, "adapter_config.json")) as f:
        acfg = json.load(f)
    rank = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", rank))
    scaling = alpha / rank

    nl = cfg.num_layers
    per_target: Dict[str, Tuple[list, list]] = {}
    st_path = os.path.join(path, "adapter_model.safetensors")
    for key, t in safetensors_io.iter_file(st_path):
        parts = key.split(".")
        try:
            li = int(parts[parts.index("layers") + 1])
        except (ValueError, IndexError):
            continue
        module = next((p for p in parts if p in PEFT_TO_TARGET), None)
        if module is None:
            continue
        target = PEFT_TO_TARGET[module]
        a_list, b_list = per_target.setdefault(
            target, ([None] * nl, [None] * nl)
        )
        if "lora_A" in key:
            a_list[li] = t.float().t().clone()  # [in, r]
        elif "lora_B" in key:
            b_list[li] = t.float().t().clone()  # [r, out]

    out: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}
    for target, (a_list, b_list) in per_target.items():
        din, dout = _target_dims(cfg, target)
        a = torch.stack([
            x if x is not None else torch.zeros((din, rank))
            for x in a_list
        ])
        b = torch.stack([
            x if x is not None else torch.zeros((rank, dout))
            for x in b_list
        ])
        out[target] = (a.to(dtype), (b * scaling).to(dtype))
    logger.info("Loaded LoRA adapter %r: rank=%d targets=%s",
                name, rank, sorted(out))
    return LoRAAdapter(name=name, rank=rank, layers=out)


def init_random_adapter(name: str, cfg: ModelConfig,
                        generator: torch.Generator, rank: int = 8,
                        targets: Tuple[str, ...] = ("wq", "wv"),
                        dtype: torch.dtype = torch.bfloat16,
                        scale: float = 1.0) -> LoRAAdapter:
    """Random adapter for tests and the smoke script (both A and B nonzero
    so two different adapters produce different outputs), drawn in f32
    from ``generator`` (on its device) in target order, A then B."""
    dev = generator.device
    layers = {}
    for target in targets:
        din, dout = _target_dims(cfg, target)
        a = torch.randn((cfg.num_layers, din, rank), generator=generator,
                        device=dev)
        b = torch.randn((cfg.num_layers, rank, dout), generator=generator,
                        device=dev)
        layers[target] = (
            (a * din ** -0.5).to(dtype),
            (b * scale * rank ** -0.5).to(dtype),
        )
    return LoRAAdapter(name=name, rank=rank, layers=layers)


class LoRARegistry:
    """Engine-side adapter registry: stacks every adapter into batched
    device tensors for per-row selection inside the decode train.

    Index 0 is the reserved ZERO adapter (base model); adapter i occupies
    index i+1. Stacks are keyed by target:
    ``{"wq": (A [L, Na+1, in, r_max], B [L, Na+1, r_max, out]), ...}``.
    """

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16):
        self.cfg = cfg
        self.dtype = dtype
        self.adapters: List[LoRAAdapter] = []
        self._stacks: Optional[Dict] = None

    @property
    def names(self) -> List[str]:
        return [a.name for a in self.adapters]

    def add(self, adapter: LoRAAdapter) -> None:
        if adapter.name in self.names:
            raise ValueError(f"duplicate LoRA adapter {adapter.name!r}")
        self.adapters.append(adapter)
        self._stacks = None

    def adapter_index(self, model_name: Optional[str]) -> int:
        """0 for the base model; i+1 for adapter i; KeyError if unknown."""
        if model_name is None:
            return 0
        for i, a in enumerate(self.adapters):
            if a.name == model_name:
                return i + 1
        raise KeyError(model_name)

    def stacks(self, device: Optional[torch.device] = None) -> Optional[Dict]:
        """Materialize (cached) the per-target stacks on ``device``; None
        if no adapter is registered."""
        if not self.adapters:
            return None
        if self._stacks is not None:
            return self._stacks
        cfg = self.cfg
        nl = cfg.num_layers
        na = len(self.adapters)
        r_max = max(a.rank for a in self.adapters)
        targets = sorted({t for a in self.adapters for t in a.layers})
        stacks = {}
        for target in targets:
            din, dout = _target_dims(cfg, target)
            a_stack = torch.zeros((nl, na + 1, din, r_max))
            b_stack = torch.zeros((nl, na + 1, r_max, dout))
            for i, ad in enumerate(self.adapters):
                if target not in ad.layers:
                    continue
                a, b = ad.layers[target]
                r = a.shape[-1]
                a_stack[:, i + 1, :, :r] = a.float().cpu()
                b_stack[:, i + 1, :r, :] = b.float().cpu()
            stacks[target] = (a_stack.to(device=device, dtype=self.dtype),
                              b_stack.to(device=device, dtype=self.dtype))
        self._stacks = stacks
        return stacks


def load_registry(modules: Dict[str, str], cfg: ModelConfig
                  ) -> Optional[LoRARegistry]:
    """The registry of an engine's ``lora_modules`` (name -> PEFT
    directory), in their order; None when there are none. Every tp rank
    builds its own from the same directories."""
    if not modules:
        return None
    if cfg.arch != "llama":
        raise ValueError("LoRA serving is llama-family only")
    reg = LoRARegistry(cfg)
    for name, path in modules.items():
        reg.add(load_peft_adapter(name, path, cfg))
    return reg


def stack_bytes(stacks: Optional[Dict]) -> int:
    """Device bytes of a registry's stacks (0 without adapters)."""
    if not stacks:
        return 0
    return sum(t.numel() * t.element_size()
               for pair in stacks.values() for t in pair)


def shard_stacks(stacks: Optional[Dict], rank: int, tp: int) -> Optional[Dict]:
    """Rank ``rank``'s slice of the stacks, as its base weights are split:
    a column-parallel target's B keeps its output columns, a row-parallel
    target's A its input rows; the other factor stays whole, and so does
    the split one where its base weight is replicated (tp does not divide
    the dim)."""
    if not stacks or tp == 1:
        return stacks
    out = {}
    for target, (a, b) in stacks.items():
        if target in COLUMN and b.shape[-1] % tp == 0:
            b = _split(b, -1, rank, tp)
        elif target in ROW and a.shape[-2] % tp == 0:
            a = _split(a, -2, rank, tp)
        out[target] = (a, b)
    return out


def lora_delta(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
    """Per-row low-rank delta: x [B, T, in] -> [B, T, out].

    a: [Na+1, in, r], b: [Na+1, r, out] (ONE layer's stacks — the layer
    loop indexes the leading L axis); idx: [B] int adapter index per row
    (0 = zero adapter). The stacks are cast to x's dtype (the JAX einsum
    promotes a bf16 stack against f32 activations the same way)."""
    idx = idx.long()
    a_rows = a[idx].to(x.dtype)                  # [B, in, r]
    b_rows = b[idx].to(x.dtype)                  # [B, r, out]
    return torch.bmm(torch.bmm(x, a_rows), b_rows)
