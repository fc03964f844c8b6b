"""K8s-style feature gates (``Name=true,Other=false``).

Contract parity with reference src/vllm_router/experimental/feature_gates.py:
registry of known gates with maturity levels (:17-47), parse from flag or the
VLLM_FEATURE_GATES env var, unknown names rejected (:50-141).

The port's copy of ``production_stack_tpu/router/feature_gates.py``.
"""

import os
from dataclasses import dataclass
from typing import Dict, Optional

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

SEMANTIC_CACHE = "SemanticCache"
PII_DETECTION = "PIIDetection"


@dataclass(frozen=True)
class FeatureSpec:
    name: str
    default: bool
    pre_release: str  # "Alpha" | "Beta" | "GA"


KNOWN_FEATURES: Dict[str, FeatureSpec] = {
    SEMANTIC_CACHE: FeatureSpec(SEMANTIC_CACHE, False, "Alpha"),
    PII_DETECTION: FeatureSpec(PII_DETECTION, False, "Alpha"),
}


class FeatureGates:
    def __init__(self, overrides: Optional[Dict[str, bool]] = None):
        self._enabled = {
            name: spec.default for name, spec in KNOWN_FEATURES.items()
        }
        for name, value in (overrides or {}).items():
            if name not in KNOWN_FEATURES:
                raise ValueError(f"Unknown feature gate: {name!r}")
            self._enabled[name] = value
            logger.info("Feature gate %s=%s (%s)", name, value,
                        KNOWN_FEATURES[name].pre_release)

    def enabled(self, name: str) -> bool:
        return self._enabled.get(name, False)


def parse_feature_gates(spec: str) -> Dict[str, bool]:
    out: Dict[str, bool] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"Feature gate {part!r} must be of form Name=true|false"
            )
        name, _, value = part.partition("=")
        if value.lower() not in ("true", "false"):
            raise ValueError(f"Feature gate {part!r} value must be true|false")
        out[name.strip()] = value.lower() == "true"
    return out


_gates: Optional[FeatureGates] = None


def initialize_feature_gates(spec: str = "") -> FeatureGates:
    global _gates
    combined = ",".join(
        s for s in (os.environ.get("VLLM_FEATURE_GATES", ""), spec) if s
    )
    _gates = FeatureGates(parse_feature_gates(combined))
    return _gates


def get_feature_gates() -> FeatureGates:
    global _gates
    if _gates is None:
        _gates = FeatureGates()
    return _gates
