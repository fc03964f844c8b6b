"""Model architecture config, copied from
``production_stack_tpu/models/config.py`` (the port imports nothing of the
JAX package). The llama family serves on both attention paths; the OPT
family (``models/opt.py``) on the window path, as a target or as a
speculative draft."""

import json
import os
from dataclasses import dataclass
from typing import Optional

import torch  # noqa: F401 — every module of the port is a torch module


@dataclass(frozen=True)
class ModelConfig:
    arch: str = "llama"  # "llama" | "opt"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    head_dim: Optional[int] = None
    max_position_embeddings: int = 4096
    rope_theta: float = 10000.0
    rms_norm_eps: float = 1e-5
    tie_word_embeddings: bool = False
    attention_bias: bool = False  # Qwen2-style qkv bias
    dtype: str = "bfloat16"
    name: str = "model"

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    @property
    def q_per_kv(self) -> int:
        assert self.num_heads % self.num_kv_heads == 0
        return self.num_heads // self.num_kv_heads

    @staticmethod
    def from_hf_config(d: dict, name: str = "model") -> "ModelConfig":
        """Map a HuggingFace config.json dict onto ModelConfig."""
        model_type = d.get("model_type", "llama")
        if model_type in ("llama", "mistral", "qwen2"):
            return ModelConfig(
                arch="llama",
                vocab_size=d["vocab_size"],
                hidden_size=d["hidden_size"],
                intermediate_size=d["intermediate_size"],
                num_layers=d["num_hidden_layers"],
                num_heads=d["num_attention_heads"],
                num_kv_heads=d.get("num_key_value_heads", d["num_attention_heads"]),
                head_dim=d.get("head_dim"),
                max_position_embeddings=d.get("max_position_embeddings", 4096),
                rope_theta=d.get("rope_theta", 10000.0),
                rms_norm_eps=d.get("rms_norm_eps", 1e-5),
                tie_word_embeddings=d.get("tie_word_embeddings", False),
                attention_bias=model_type == "qwen2" or d.get("attention_bias", False),
                name=name,
            )
        if model_type == "opt":
            return ModelConfig(
                arch="opt",
                vocab_size=d["vocab_size"],
                hidden_size=d["hidden_size"],
                intermediate_size=d.get("ffn_dim", 4 * d["hidden_size"]),
                num_layers=d["num_hidden_layers"],
                num_heads=d["num_attention_heads"],
                num_kv_heads=d["num_attention_heads"],
                max_position_embeddings=d.get("max_position_embeddings", 2048),
                tie_word_embeddings=d.get("tie_word_embeddings", True),
                name=name,
            )
        raise ValueError(f"Unsupported model_type: {model_type}")

    @staticmethod
    def from_pretrained_dir(path: str, name: Optional[str] = None) -> "ModelConfig":
        with open(os.path.join(path, "config.json")) as f:
            return ModelConfig.from_hf_config(json.load(f), name=name or path)


TINY_LLAMA = ModelConfig(
    arch="llama", vocab_size=512, hidden_size=128, intermediate_size=256,
    num_layers=2, num_heads=4, num_kv_heads=2, max_position_embeddings=512,
    name="tiny-llama",
)

TINY_LLAMA_8KV = ModelConfig(
    arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
    num_layers=2, num_heads=8, num_kv_heads=8, max_position_embeddings=512,
    name="tiny-llama-8kv",
)

LLAMA_1B = ModelConfig(
    arch="llama", vocab_size=32000, hidden_size=2048, intermediate_size=5632,
    num_layers=22, num_heads=32, num_kv_heads=4, max_position_embeddings=2048,
    name="llama-1b",
)

TINY_OPT = ModelConfig(
    arch="opt", vocab_size=512, hidden_size=64, intermediate_size=128,
    num_layers=2, num_heads=2, num_kv_heads=2, max_position_embeddings=512,
    tie_word_embeddings=True, name="tiny-opt",
)

OPT_125M = ModelConfig(
    arch="opt", vocab_size=50272, hidden_size=768, intermediate_size=3072,
    num_layers=12, num_heads=12, num_kv_heads=12, max_position_embeddings=2048,
    tie_word_embeddings=True, name="facebook/opt-125m",
)

LLAMA3_8B = ModelConfig(
    arch="llama", vocab_size=128256, hidden_size=4096, intermediate_size=14336,
    num_layers=32, num_heads=32, num_kv_heads=8, max_position_embeddings=8192,
    rope_theta=500000.0, name="meta-llama/Meta-Llama-3-8B",
)

# meta-llama/Llama-3.2-3B architecture: head_dim 128, tied embeddings. The
# port's first served configuration.
LLAMA32_3B = ModelConfig(
    arch="llama", vocab_size=128256, hidden_size=3072, intermediate_size=8192,
    num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
    max_position_embeddings=131072, rope_theta=500000.0,
    tie_word_embeddings=True, name="llama-3b",
)

TINY_LLAMA_128DH = ModelConfig(
    arch="llama", vocab_size=512, hidden_size=256, intermediate_size=512,
    num_layers=2, num_heads=2, num_kv_heads=2, head_dim=128,
    max_position_embeddings=512, name="tiny-llama-128dh",
)

NAMED_CONFIGS = {
    "tiny-llama": TINY_LLAMA,
    "tiny-llama-8kv": TINY_LLAMA_8KV,
    "tiny-llama-128dh": TINY_LLAMA_128DH,
    "tiny-opt": TINY_OPT,
    "llama-1b": LLAMA_1B,
    "llama-3b": LLAMA32_3B,
    "facebook/opt-125m": OPT_125M,
    "meta-llama/Meta-Llama-3-8B": LLAMA3_8B,
    "llama-3-8b": LLAMA3_8B,
}


def resolve_model_config(model: str) -> ModelConfig:
    """Resolve a model name or local HF directory to a ModelConfig."""
    if model in NAMED_CONFIGS:
        return NAMED_CONFIGS[model]
    if os.path.isdir(model) and os.path.exists(os.path.join(model, "config.json")):
        return ModelConfig.from_pretrained_dir(model)
    raise ValueError(
        f"Unknown model {model!r}: not a named config ({list(NAMED_CONFIGS)}) "
        "and not a local HuggingFace directory"
    )
