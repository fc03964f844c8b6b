"""User-supplied pre/post request hooks loaded by dotted path.

Contract parity with reference src/vllm_router/services/callbacks_service/:
``--callbacks module.path.instance`` imports the module and fetches the
attribute; the object may define ``pre_request(request, body, endpoint)``
(returning a response short-circuits routing) and ``post_request(request,
body)`` (:6-42, invoked at request.py:168-173/:138-141).

The port's copy of ``production_stack_tpu/router/callbacks.py``.
"""

import asyncio
import importlib
from typing import Optional

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class CustomCallbackHandler:
    def __init__(self, dotted_path: str):
        module_path, _, attr = dotted_path.rpartition(".")
        if not module_path:
            raise ValueError(
                f"--callbacks must be module.attribute, got {dotted_path!r}"
            )
        module = importlib.import_module(module_path)
        self._obj = getattr(module, attr)
        logger.info("Loaded custom callbacks from %s", dotted_path)

    async def _call(self, name: str, *args):
        fn = getattr(self._obj, name, None)
        if fn is None:
            return None
        result = fn(*args)
        if asyncio.iscoroutine(result):
            result = await result
        return result

    async def pre_request(self, request, body, endpoint):
        return await self._call("pre_request", request, body, endpoint)

    async def post_request(self, request, body):
        return await self._call("post_request", request, body)


def initialize_custom_callbacks(dotted_path: str) -> Optional[CustomCallbackHandler]:
    if not dotted_path:
        return None
    return CustomCallbackHandler(dotted_path)
