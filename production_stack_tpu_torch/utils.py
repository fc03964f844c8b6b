"""Small shared helpers, copied from the JAX package so the port imports
nothing of it: logging (``production_stack_tpu/utils/logging.py``), the
shape-bucketing rules, the router's singletons and flag parsers
(``production_stack_tpu/utils/misc.py``), the consistent hash ring
(``production_stack_tpu/utils/hashring.py``) and ``random_uuid``
(``production_stack_tpu/protocols.py``)."""

import abc
import bisect
import hashlib
import logging
import os
import re
import resource
import sys
import uuid
from typing import Any, Dict, Iterable, List, Optional

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


def resolve_device(name: str):
    """The device an entry point runs on. ``cuda`` (the default of every
    entry point) raises when no card is present; the CPU is used only when
    the caller asks for it. (torch is imported here, not with the module:
    the router imports this module and never loads torch.)"""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={name!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {name!r} (cuda or cpu)")
    return dev


# ------------------------------------------------------------------ router
class SingletonMeta(type):
    """Metaclass giving each class a process-wide single instance. The
    registry (``_instances``) is exposed so tests can reset global state
    between cases."""

    _instances: Dict[type, Any] = {}

    def __call__(cls, *args, **kwargs):
        if cls not in cls._instances:
            cls._instances[cls] = super().__call__(*args, **kwargs)
        return cls._instances[cls]


class SingletonABCMeta(abc.ABCMeta, SingletonMeta):
    pass


_URL_RE = re.compile(r"^https?://[-A-Za-z0-9.:_\[\]]+(?:/[-A-Za-z0-9._~%/]*)?$")


def validate_url(url: str) -> bool:
    return bool(_URL_RE.match(url))


def parse_comma_separated(value: str) -> List[str]:
    return [v for v in (s.strip() for s in value.split(",")) if v]


def parse_static_urls(static_backends: str) -> List[str]:
    urls = parse_comma_separated(static_backends)
    for url in urls:
        if not validate_url(url):
            raise ValueError(f"Invalid backend URL: {url!r}")
    return urls


def parse_static_model_names(static_models: str) -> List[str]:
    return parse_comma_separated(static_models)


def set_ulimit(target_soft: int = 65535) -> None:
    """Raise RLIMIT_NOFILE so the router can hold many concurrent streams."""
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft < target_soft:
            resource.setrlimit(
                resource.RLIMIT_NOFILE, (min(target_soft, hard), hard)
            )
    except (ValueError, OSError) as e:
        init_logger(__name__).warning("Could not raise RLIMIT_NOFILE: %s", e)


def _ring_hash(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hash ring: a stable key -> node mapping that moves only
    ~1/N of the keys when a node joins or leaves (the session router's and
    the placement ring's structure; the JAX package's positions exactly)."""

    def __init__(self, nodes: Optional[Iterable[str]] = None, vnodes: int = 160):
        self._vnodes = vnodes
        self._ring: Dict[int, str] = {}
        self._sorted_keys: List[int] = []
        self._nodes: set = set()
        for n in nodes or []:
            self.add_node(n)

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def add_node(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self._vnodes):
            h = _ring_hash(f"{node}#{i}")
            self._ring[h] = node
            bisect.insort(self._sorted_keys, h)

    def remove_node(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for i in range(self._vnodes):
            h = _ring_hash(f"{node}#{i}")
            if self._ring.get(h) == node:
                del self._ring[h]
                idx = bisect.bisect_left(self._sorted_keys, h)
                if idx < len(self._sorted_keys) and self._sorted_keys[idx] == h:
                    self._sorted_keys.pop(idx)

    def set_nodes(self, nodes: Iterable[str]) -> None:
        target = set(nodes)
        for n in list(self._nodes - target):
            self.remove_node(n)
        for n in target - self._nodes:
            self.add_node(n)

    def get_node(self, key: str) -> Optional[str]:
        if not self._sorted_keys:
            return None
        idx = bisect.bisect(self._sorted_keys, _ring_hash(key))
        if idx == len(self._sorted_keys):
            idx = 0
        return self._ring[self._sorted_keys[idx]]

    def get_node_among(self, key: str,
                       allowed: Iterable[str]) -> Optional[str]:
        """First ring successor of ``key`` that is in ``allowed``: a key
        whose successor is allowed maps as ``get_node`` would, and
        excluding a node moves only the keys that landed on it."""
        allowed = set(allowed)
        if not self._sorted_keys or not allowed:
            return None
        start = bisect.bisect(self._sorted_keys, _ring_hash(key))
        n = len(self._sorted_keys)
        for step in range(n):
            node = self._ring[self._sorted_keys[(start + step) % n]]
            if node in allowed:
                return node
        return None

    def __len__(self) -> int:
        return len(self._nodes)
