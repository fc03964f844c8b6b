"""OpenAI-compatible wire objects the router answers with, copied from
``production_stack_tpu/protocols.py``: plain dataclasses with explicit
``to_dict`` serialization, the same JSON shapes on the wire."""

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from production_stack_tpu_torch.utils import random_uuid  # noqa: F401


@dataclass
class ModelCard:
    id: str
    object: str = "model"
    created: int = field(default_factory=lambda: int(time.time()))
    owned_by: str = "production-stack-tpu"
    root: Optional[str] = None
    parent: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "object": self.object,
            "created": self.created,
            "owned_by": self.owned_by,
            "root": self.root,
            "parent": self.parent,
        }


@dataclass
class ModelList:
    data: List[ModelCard] = field(default_factory=list)
    object: str = "list"

    def to_dict(self) -> Dict[str, Any]:
        return {"object": self.object, "data": [m.to_dict() for m in self.data]}


@dataclass
class ErrorResponse:
    message: str
    type: str = "invalid_request_error"
    code: int = 400
    param: Optional[str] = None

    def to_dict(self) -> Dict[str, Any]:
        return {
            "error": {
                "message": self.message,
                "type": self.type,
                "code": self.code,
                "param": self.param,
            }
        }
