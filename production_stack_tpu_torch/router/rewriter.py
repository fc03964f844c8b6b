"""Pre-proxy request body rewriting hook.

Contract parity with reference src/vllm_router/services/request_service/rewriter.py:
an abstract rewriter + the shipped no-op, selected by name (:31-72).

The port's copy of ``production_stack_tpu/router/rewriter.py``.
"""

import abc
from typing import Optional


class RequestRewriter(abc.ABC):
    @abc.abstractmethod
    def rewrite(self, body: dict, endpoint: str) -> dict:
        raise NotImplementedError


class NoopRequestRewriter(RequestRewriter):
    def rewrite(self, body: dict, endpoint: str) -> dict:
        return body


def get_request_rewriter(name: Optional[str] = None) -> RequestRewriter:
    if name in (None, "", "noop"):
        return NoopRequestRewriter()
    raise ValueError(f"Unknown request rewriter: {name!r}")
