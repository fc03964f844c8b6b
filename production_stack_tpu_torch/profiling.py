"""On-demand device profiling: ``POST /debug/profile`` arms
``torch.profiler`` for a bounded window.

Counterpart of ``production_stack_tpu/profiling.py`` (which arms
``jax.profiler.trace``), with its rules: one capture at a time
(``ProfilerBusy``, answered 409), a window in (0, 300] seconds stopped by a
scheduled task so a forgotten capture never runs on, ``status()``, and a
plain 404 when profiling is unavailable or the debug surface is off.

The capture records CPU activity and, on the card, CUDA activity (CUPTI:
every kernel of the process, those inside replayed CUDA graphs included),
and is written as one Chrome / perfetto trace file into ``trace_dir`` (a
fresh temporary directory by default).

Threads: torch.profiler's CPU op callbacks belong to the thread that starts
it, and the same thread must stop it. The server hands the profiler the
engine's worker thread (``executor``), the one thread that launches device
work, so a capture records the engine's own ops, starts and stops between
dispatches, and never opens inside a CUDA graph capture (``lock``: the
runner's ``kv_io_lock``, which warm-up holds while it captures). A capture
asked for before the engine is ready (``not_ready`` returns a reason) is
refused with ``ProfilerNotReady``, answered 503 with ``Retry-After``.
"""

import asyncio
import contextlib
import os
import tempfile
import time
from typing import Callable, Optional

import torch

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

MAX_CAPTURE_SECONDS = 300.0


class ProfilerBusy(RuntimeError):
    """A capture is already in flight (one at a time)."""


class ProfilerNotReady(RuntimeError):
    """The engine cannot take a capture yet (warm-up is not done)."""


class DeviceProfiler:
    """Arms torch.profiler for a bounded window and stops it from a
    scheduled task."""

    def __init__(self, executor=None, lock=None,
                 not_ready: Optional[Callable[[], Optional[str]]] = None):
        self.executor = executor
        self.lock = lock
        self.not_ready = not_ready
        self.active: Optional[dict] = None
        self.last: Optional[dict] = None
        self._prof = None
        self._stop_task: Optional[asyncio.Task] = None
        self._finishing: Optional[asyncio.Future] = None

    @staticmethod
    def available() -> bool:
        return hasattr(torch, "profiler") and hasattr(torch.profiler, "profile")

    @staticmethod
    def activities() -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    async def _on_thread(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            self.executor, fn, *args)

    def _start(self, prof) -> None:
        with self.lock if self.lock is not None else contextlib.nullcontext():
            prof.start()

    async def arm(self, duration_s: float,
                  trace_dir: Optional[str] = None) -> dict:
        """Start a capture; a background task stops it after
        ``duration_s``. Raises ProfilerBusy while one is in flight and
        ProfilerNotReady before the engine is ready."""
        if self.active is not None:
            raise ProfilerBusy(
                f"a capture into {self.active['trace_dir']!r} is already "
                f"running")
        reason = self.not_ready() if self.not_ready is not None else None
        if reason:
            raise ProfilerNotReady(reason)
        duration_s = min(max(0.1, float(duration_s)), MAX_CAPTURE_SECONDS)
        trace_dir = trace_dir or tempfile.mkdtemp(prefix="pstpu-profile-")
        os.makedirs(trace_dir, exist_ok=True)
        acts = self.activities()
        # Claimed before the first await: a second arm meanwhile is a 409.
        self.active = {"trace_dir": trace_dir, "duration_s": duration_s,
                       "activities": [a.name for a in acts]}
        try:
            prof = torch.profiler.profile(activities=acts)
            await self._on_thread(self._start, prof)
        except BaseException:
            self.active = None
            raise
        self._prof = prof
        self.active["started_at"] = time.time()
        self._stop_task = asyncio.get_running_loop().create_task(
            self._stop_after(duration_s))
        logger.info("Device profiling armed: dir=%s duration=%.1fs",
                    trace_dir, duration_s)
        return dict(self.active)

    async def _stop_after(self, duration_s: float) -> None:
        await asyncio.sleep(duration_s)
        # Shielded: a close() meanwhile waits for the same stop.
        await asyncio.shield(self._finish())

    def _finish(self) -> asyncio.Future:
        """The one stop of the capture in flight (started once)."""
        if self._finishing is None:
            self._finishing = asyncio.ensure_future(self._finish_capture())
        return self._finishing

    async def _finish_capture(self) -> None:
        prof, self._prof = self._prof, None
        if prof is None:
            self._finishing = None
            return
        info = self.active
        try:
            # Stopped on the thread that started it; the trace is written
            # off that thread, so the engine's next dispatch need not wait.
            await self._on_thread(prof.stop)
            info["stopped_at"] = time.time()
            path = os.path.join(
                info["trace_dir"],
                f"pstpu-{os.getpid()}-{int(info['started_at'] * 1000)}"
                f".pt.trace.json")
            await asyncio.get_running_loop().run_in_executor(
                None, prof.export_chrome_trace, path)
            info["trace_file"] = path
        except Exception as e:  # noqa: BLE001 — a failed stop must not wedge arm
            logger.exception("torch.profiler stop or export failed")
            info = {**info, "error": f"stop or export failed: {e}"}
        info.setdefault("stopped_at", time.time())
        self.last = info
        self.active = None
        self._finishing = None
        logger.info("Device profiling capture complete: %s",
                    info.get("trace_file", info["trace_dir"]))

    def status(self) -> dict:
        return {
            "available": self.available(),
            "active": dict(self.active) if self.active else None,
            "last": dict(self.last) if self.last else None,
        }

    async def close(self) -> None:
        """Stop any in-flight capture (server shutdown)."""
        task, self._stop_task = self._stop_task, None
        if task is not None and not task.done():
            task.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await task
        if self._prof is not None or self._finishing is not None:
            await self._finish()
