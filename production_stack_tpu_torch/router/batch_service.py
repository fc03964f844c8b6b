"""OpenAI Batch API: SQLite-backed queue + background processor.

Contract parity with reference src/vllm_router/services/batch_service/
(batch.py:6-91, local_processor.py:19-208) with two deliberate upgrades:
  * the reference's stale ``vllm_router.batch.*`` imports crash
    ``--enable-batch-api`` (SURVEY.md §2.1); this implementation works.
  * the reference's processor marks batches completed WITHOUT executing them
    (local_processor.py docstring admits it); here each JSONL line is
    actually proxied through the router's routing logic and the output file
    is written with per-line responses.

The port's copy of ``production_stack_tpu/router/batch_service.py``: the
same ``batches`` table and the same JSON rows, so a batch database written
by either package loads in the other.
"""

import asyncio
import enum
import json
import sqlite3
import time
from dataclasses import dataclass, field
from typing import Optional

from production_stack_tpu_torch.utils import random_uuid
from production_stack_tpu_torch.router.files_service import Storage
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


class BatchStatus(str, enum.Enum):
    VALIDATING = "validating"
    IN_PROGRESS = "in_progress"
    COMPLETED = "completed"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclass
class BatchInfo:
    id: str
    input_file_id: str
    endpoint: str
    completion_window: str = "24h"
    status: str = BatchStatus.VALIDATING.value
    created_at: int = field(default_factory=lambda: int(time.time()))
    output_file_id: Optional[str] = None
    error_file_id: Optional[str] = None
    completed_at: Optional[int] = None
    request_counts_total: int = 0
    request_counts_completed: int = 0
    request_counts_failed: int = 0
    metadata: Optional[dict] = None

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "object": "batch",
            "endpoint": self.endpoint,
            "input_file_id": self.input_file_id,
            "completion_window": self.completion_window,
            "status": self.status,
            "created_at": self.created_at,
            "output_file_id": self.output_file_id,
            "error_file_id": self.error_file_id,
            "completed_at": self.completed_at,
            "request_counts": {
                "total": self.request_counts_total,
                "completed": self.request_counts_completed,
                "failed": self.request_counts_failed,
            },
            "metadata": self.metadata or {},
        }


_SCHEMA = """
CREATE TABLE IF NOT EXISTS batches (
    id TEXT PRIMARY KEY,
    data TEXT NOT NULL
)
"""


class LocalBatchProcessor:
    def __init__(self, storage: Storage, db_path: str = "/tmp/pstpu_batch.db",
                 send_fn=None, poll_interval: float = 2.0):
        """``send_fn(endpoint, body) -> dict`` executes one batch line; the
        app wires it to the in-process proxy path."""
        self.storage = storage
        self.db_path = db_path
        self.send_fn = send_fn
        self.poll_interval = poll_interval
        self._db = sqlite3.connect(db_path, check_same_thread=False)
        self._db.execute(_SCHEMA)
        self._db.commit()
        self._task: Optional[asyncio.Task] = None
        self._running = False

    # -------------------------------------------------------------- storage
    def _put(self, info: BatchInfo) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO batches (id, data) VALUES (?, ?)",
            (info.id, json.dumps(info.to_dict())),
        )
        self._db.commit()

    def _get(self, batch_id: str) -> Optional[BatchInfo]:
        row = self._db.execute(
            "SELECT data FROM batches WHERE id = ?", (batch_id,)
        ).fetchone()
        return self._from_dict(json.loads(row[0])) if row else None

    @staticmethod
    def _from_dict(d: dict) -> BatchInfo:
        counts = d.get("request_counts", {})
        return BatchInfo(
            id=d["id"], input_file_id=d["input_file_id"],
            endpoint=d["endpoint"],
            completion_window=d.get("completion_window", "24h"),
            status=d["status"], created_at=d["created_at"],
            output_file_id=d.get("output_file_id"),
            error_file_id=d.get("error_file_id"),
            completed_at=d.get("completed_at"),
            request_counts_total=counts.get("total", 0),
            request_counts_completed=counts.get("completed", 0),
            request_counts_failed=counts.get("failed", 0),
            metadata=d.get("metadata"),
        )

    # ------------------------------------------------------------ public API
    async def create_batch(self, input_file_id: str, endpoint: str,
                           completion_window: str = "24h",
                           metadata: Optional[dict] = None) -> BatchInfo:
        info = BatchInfo(
            id=random_uuid("batch_"), input_file_id=input_file_id,
            endpoint=endpoint, completion_window=completion_window,
            metadata=metadata,
        )
        self._put(info)
        return info

    async def retrieve_batch(self, batch_id: str) -> Optional[BatchInfo]:
        return self._get(batch_id)

    async def list_batches(self) -> list:
        rows = self._db.execute("SELECT data FROM batches").fetchall()
        return [self._from_dict(json.loads(r[0])) for r in rows]

    async def cancel_batch(self, batch_id: str) -> Optional[BatchInfo]:
        info = self._get(batch_id)
        if info is None:
            return None
        if info.status in (BatchStatus.VALIDATING.value,
                           BatchStatus.IN_PROGRESS.value):
            info.status = BatchStatus.CANCELLED.value
            self._put(info)
        return info

    # ----------------------------------------------------------- processing
    def start(self) -> None:
        self._running = True
        self._task = asyncio.get_event_loop().create_task(self._process_loop())

    async def stop(self) -> None:
        self._running = False
        if self._task:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _process_loop(self) -> None:
        active: set = set()  # ids this process is currently working on
        while self._running:
            try:
                pending = [
                    b for b in await self.list_batches()
                    # in_progress batches are re-picked too: they were
                    # orphaned by a previous process crash/restart.
                    if b.status in (BatchStatus.VALIDATING.value,
                                    BatchStatus.IN_PROGRESS.value)
                    and b.id not in active
                ]
                for info in pending:
                    active.add(info.id)
                    try:
                        await self._process_one(info)
                    finally:
                        active.discard(info.id)
            except Exception:  # noqa: BLE001 — keep the queue draining
                logger.exception("Batch processing pass failed")
            await asyncio.sleep(self.poll_interval)

    async def _process_one(self, info: BatchInfo) -> None:
        info.status = BatchStatus.IN_PROGRESS.value
        self._put(info)
        try:
            content = await self.storage.get_file_content(info.input_file_id)
        except FileNotFoundError:
            info.status = BatchStatus.FAILED.value
            self._put(info)
            return
        lines = [ln for ln in content.decode().splitlines() if ln.strip()]
        info.request_counts_total = len(lines)
        out_lines = []
        for line in lines:
            cur = self._get(info.id)
            if cur is not None and cur.status == BatchStatus.CANCELLED.value:
                return  # a concurrent cancel wins; drop progress
            try:
                req = json.loads(line)
                body = req.get("body", {})
                endpoint = req.get("url", info.endpoint)
                if self.send_fn is None:
                    raise RuntimeError("Batch processor has no send_fn wired")
                resp = await self.send_fn(endpoint, body)
                out_lines.append(json.dumps({
                    "id": random_uuid("batch_req_"),
                    "custom_id": req.get("custom_id"),
                    "response": {"status_code": 200, "body": resp},
                    "error": None,
                }))
                info.request_counts_completed += 1
            except Exception as e:  # noqa: BLE001 — per-line isolation
                out_lines.append(json.dumps({
                    "id": random_uuid("batch_req_"),
                    "custom_id": None,
                    "response": None,
                    "error": {"message": str(e)},
                }))
                info.request_counts_failed += 1
            # Guarded write: never clobber a concurrent cancel (the cancel
            # handler persisted CANCELLED while send_fn was in flight).
            cur = self._get(info.id)
            if cur is not None and cur.status == BatchStatus.CANCELLED.value:
                return
            self._put(info)
        out_file = await self.storage.save_file(
            f"{info.id}_output.jsonl", "\n".join(out_lines).encode(),
            purpose="batch_output",
        )
        info.output_file_id = out_file.id
        info.status = BatchStatus.COMPLETED.value
        info.completed_at = int(time.time())
        cur = self._get(info.id)
        if cur is not None and cur.status == BatchStatus.CANCELLED.value:
            return
        self._put(info)
        logger.info("Batch %s completed: %d ok, %d failed", info.id,
                    info.request_counts_completed, info.request_counts_failed)
