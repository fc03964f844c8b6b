"""Small shared helpers, copied from the JAX package so the port imports
nothing of it: logging (``production_stack_tpu/utils/logging.py``), the
shape-bucketing rules (``production_stack_tpu/utils/misc.py``) and
``random_uuid`` (``production_stack_tpu/protocols.py``)."""

import logging
import os
import sys
import uuid

import torch

_FORMAT = "[%(asctime)s] %(levelname)s %(name)s: %(message)s"
_DATEFMT = "%Y-%m-%d %H:%M:%S"
_ROOT = "production_stack_tpu_torch"

_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    level = os.environ.get("PSTPU_LOG_LEVEL", "INFO").upper()
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    root = logging.getLogger(_ROOT)
    root.setLevel(level)
    if not root.handlers:
        root.addHandler(handler)
    root.propagate = False
    _configured = True


def init_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith(_ROOT):
        name = f"{_ROOT}.{name}"
    return logging.getLogger(name)


def random_uuid(prefix: str = "") -> str:
    return f"{prefix}{uuid.uuid4().hex}"


def pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power-of-two >= n, clamped to [lo, hi]. The runner's
    dispatch widths and the scheduler's window-budget estimates must agree
    on it, so both use this single definition."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(max(b, lo), hi)


def window_mb_bucket(live_blocks: int, max_blocks: int) -> int:
    """Block-table width for dispatches that gather a window: the
    power-of-two bucket of the live block count, floored at 1/4 of the max
    bucket. Shared by the runner and the scheduler's window budget."""
    full = pow2_bucket(max_blocks, 1, max(1, max_blocks))
    return pow2_bucket(live_blocks, max(1, full // 4), full)


def prefill_t_floor(token_budget: int) -> int:
    """Floor for the prefill chunk-length bucket: min(128, largest
    power-of-two <= token_budget). Shared by the runner and the scheduler's
    admission accounting."""
    f = 16
    while f * 2 <= min(128, max(16, token_budget)):
        f *= 2
    return f


def resolve_device(name: str) -> torch.device:
    """The device an entry point runs on. ``cuda`` (the default of every
    entry point) raises when no card is present; the CPU is used only when
    the caller asks for it."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {name!r} (cuda or cpu)")
    return dev
