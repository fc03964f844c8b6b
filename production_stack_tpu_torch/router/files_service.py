"""OpenAI Files API storage backend (local disk).

Contract parity with reference src/vllm_router/services/files_service/:
``Storage`` ABC (storage.py:7-139), local-disk implementation persisting
content + metadata (file_storage.py:14-123), OpenAI file object shape
(openai_files.py).

The port's copy of ``production_stack_tpu/router/files_service.py``: the
same on-disk layout (``<id>.bin`` beside ``<id>.json``), so a directory
written by either package loads in the other.
"""

import abc
import asyncio
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional

from production_stack_tpu_torch.utils import random_uuid

DEFAULT_STORAGE_PATH = "/tmp/production_stack_tpu_files"


@dataclass
class OpenAIFile:
    id: str
    bytes: int
    created_at: int
    filename: str
    object: str = "file"
    purpose: str = "batch"

    def to_dict(self) -> dict:
        return asdict(self)


class Storage(abc.ABC):
    @abc.abstractmethod
    async def save_file(self, filename: str, content: bytes,
                        purpose: str = "batch") -> OpenAIFile: ...

    @abc.abstractmethod
    async def get_file(self, file_id: str) -> OpenAIFile: ...

    @abc.abstractmethod
    async def get_file_content(self, file_id: str) -> bytes: ...

    @abc.abstractmethod
    async def list_files(self) -> List[OpenAIFile]: ...

    @abc.abstractmethod
    async def delete_file(self, file_id: str) -> None: ...


class FileStorage(Storage):
    def __init__(self, base_path: str = DEFAULT_STORAGE_PATH):
        self.base_path = base_path
        os.makedirs(base_path, exist_ok=True)
        self._index: Dict[str, OpenAIFile] = {}
        self._load_index()

    def _meta_path(self, file_id: str) -> str:
        return os.path.join(self.base_path, f"{file_id}.json")

    def _data_path(self, file_id: str) -> str:
        return os.path.join(self.base_path, f"{file_id}.bin")

    def _load_index(self) -> None:
        for name in os.listdir(self.base_path):
            if name.endswith(".json"):
                try:
                    with open(os.path.join(self.base_path, name)) as f:
                        meta = json.load(f)
                    self._index[meta["id"]] = OpenAIFile(**meta)
                except (OSError, json.JSONDecodeError, TypeError):
                    continue

    async def save_file(self, filename: str, content: bytes,
                        purpose: str = "batch") -> OpenAIFile:
        file_id = random_uuid("file-")
        info = OpenAIFile(
            id=file_id, bytes=len(content), created_at=int(time.time()),
            filename=filename, purpose=purpose,
        )

        def _write() -> None:
            with open(self._data_path(file_id), "wb") as f:
                f.write(content)
            with open(self._meta_path(file_id), "w") as f:
                f.write(json.dumps(info.to_dict()))

        # Plain file I/O in the default executor, off the event loop.
        await asyncio.get_running_loop().run_in_executor(None, _write)
        self._index[file_id] = info
        return info

    async def get_file(self, file_id: str) -> OpenAIFile:
        info = self._index.get(file_id)
        if info is None:
            raise FileNotFoundError(file_id)
        return info

    async def get_file_content(self, file_id: str) -> bytes:
        await self.get_file(file_id)

        def _read() -> bytes:
            with open(self._data_path(file_id), "rb") as f:
                return f.read()

        return await asyncio.get_running_loop().run_in_executor(None, _read)

    async def list_files(self) -> List[OpenAIFile]:
        return list(self._index.values())

    async def delete_file(self, file_id: str) -> None:
        self._index.pop(file_id, None)
        for path in (self._meta_path(file_id), self._data_path(file_id)):
            try:
                os.remove(path)
            except OSError:
                pass


def initialize_storage(kind: str = "local_file",
                       base_path: Optional[str] = None) -> Storage:
    if kind == "local_file":
        return FileStorage(base_path or DEFAULT_STORAGE_PATH)
    raise ValueError(f"Unknown storage backend: {kind!r}")
