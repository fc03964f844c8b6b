"""Dynamic router config: watch a JSON file, hot-swap discovery + routing.

Counterpart of ``production_stack_tpu/router/dynamic_config.py``. One
deliberate difference (``ROADMAP.md`` Queue 3): each gossip write goes
through a temporary file of its own (``tempfile.mkstemp`` beside the
target), where the JAX file shares ``breakers-<id>.json.tmp`` between every
writer of one router id, so two writers can no longer rename one file.

Contract parity with reference src/vllm_router/dynamic_config.py:
  * ``DynamicRouterConfig`` mirrors the JSON schema the Go StaticRoute
    operator renders into its ConfigMap (:34-90; operator side
    staticroute_controller.go:134-184).
  * ``DynamicConfigWatcher`` polls the file every `watch_interval`, diffs,
    and applies by swapping the discovery/routing singletons in place
    (:93-223); current state is surfaced via /health (:216-223).
"""

import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Optional

from production_stack_tpu_torch.utils import (
    init_logger,
    parse_static_model_names,
    parse_static_urls,
)

logger = init_logger(__name__)


def _decay_remaining(open_circuits, age: float):
    """Age a peer snapshot's remaining-open seconds by how long ago it was
    published, so a frozen file converges to closed instead of re-opening
    the circuit on every tick. Malformed entries pass through untouched —
    apply_peer_state skips them."""
    if age <= 0 or not isinstance(open_circuits, dict):
        return open_circuits
    out = {}
    for url, rem in open_circuits.items():
        try:
            out[url] = float(rem) - age
        except (TypeError, ValueError):
            out[url] = rem
    return out


@dataclasses.dataclass
class DynamicRouterConfig:
    service_discovery: Optional[str] = None
    routing_logic: Optional[str] = None
    static_backends: Optional[str] = None
    static_models: Optional[str] = None
    session_key: Optional[str] = None
    k8s_namespace: Optional[str] = None
    k8s_port: Optional[int] = None
    k8s_label_selector: Optional[str] = None

    @staticmethod
    def from_json(path: str) -> "DynamicRouterConfig":
        with open(path) as f:
            raw = json.load(f)
        fields = {f.name for f in dataclasses.fields(DynamicRouterConfig)}
        return DynamicRouterConfig(
            **{k: v for k, v in raw.items() if k in fields}
        )

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class DynamicConfigWatcher:
    """Polls the config file AND (when ``peer_dir`` is set) carries the
    router tier's breaker-state gossip: each tick publishes this replica's
    OPEN circuits to ``peer_dir/breakers-<router_id>.json`` and adopts
    peers' OPEN circuits (docs/ROUTER_SCALE.md). One watch interval is thus
    the worst-case time for replica B to learn a backend replica A already
    ejected — local observations still take effect immediately.

    A dead/replaced replica stops republishing, so its file's frozen
    ``remaining_s`` values must not be re-adopted forever: each payload
    carries a wall-clock publish timestamp, remaining times are decayed by
    the snapshot's age on read, snapshots older than a few watch intervals
    are ignored outright, and long-dead files are garbage-collected.
    ``config_path`` may be None when only the peer plane is wanted."""

    def __init__(self, config_path: Optional[str],
                 watch_interval: float = 10.0,
                 peer_dir: Optional[str] = None,
                 router_id: Optional[str] = None):
        self.config_path = config_path
        self.watch_interval = watch_interval
        self.peer_dir = peer_dir
        self.router_id = router_id or "router"
        self.current_config: Optional[DynamicRouterConfig] = None
        self._running = True
        self._thread = threading.Thread(
            target=self._watch_worker, daemon=True, name="dynamic-config-watcher"
        )
        self._thread.start()

    def _watch_worker(self) -> None:
        while self._running:
            if self.config_path:
                try:
                    config = DynamicRouterConfig.from_json(self.config_path)
                    if self.current_config is None or \
                            config != self.current_config:
                        logger.info("Dynamic config changed; applying %s",
                                    config.to_dict())
                        self._apply(config)
                        self.current_config = config
                except FileNotFoundError:
                    pass
                except Exception:  # noqa: BLE001 — watcher survives bad JSON
                    logger.exception("Failed to load dynamic config")
            try:
                self.sync_peer_state()
            except Exception:  # noqa: BLE001 — gossip is best-effort
                logger.exception("Failed to sync peer breaker state")
            time.sleep(self.watch_interval)

    def sync_peer_state(self) -> None:
        """One publish+reconcile pass of the breaker gossip (public so
        tests can drive a deterministic tick)."""
        if not self.peer_dir:
            return
        from production_stack_tpu_torch.router.resilience import get_resilience

        manager = get_resilience()
        if manager is None:
            return
        os.makedirs(self.peer_dir, exist_ok=True)
        mine = f"breakers-{self.router_id}.json"
        now = time.time()
        # Remaining-seconds deltas, not deadlines: monotonic clocks don't
        # transfer between processes and wall clocks skew. The wall-clock
        # ``ts`` only measures the SNAPSHOT's age (skew on the order of a
        # watch interval is harmless); apply_remote_open clamps the rest.
        payload = {"router_id": self.router_id, "ts": now,
                   "open": manager.peer_snapshot()}
        fd, tmp = tempfile.mkstemp(prefix=mine + ".", suffix=".tmp",
                                   dir=self.peer_dir)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, os.path.join(self.peer_dir, mine))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        # A live replica rewrites its file every tick; one that stopped is
        # dead or replaced. Its frozen remaining_s must not re-open the
        # circuit forever: decay by snapshot age, drop snapshots older
        # than a few intervals, delete files long past that.
        stale_after = max(3.0 * self.watch_interval, 15.0)
        for name in sorted(os.listdir(self.peer_dir)):
            if name == mine or not name.startswith("breakers-") \
                    or not name.endswith(".json"):
                continue
            path = os.path.join(self.peer_dir, name)
            try:
                if now - os.stat(path).st_mtime > 4.0 * stale_after:
                    os.remove(path)   # garbage-collect a long-dead replica
                    continue
                with open(path) as f:
                    peer = json.load(f)
                try:
                    age = max(0.0, now - float(peer.get("ts")))
                except (TypeError, ValueError):
                    age = max(0.0, now - os.stat(path).st_mtime)
                if age > stale_after:
                    continue
                manager.apply_peer_state(
                    str(peer.get("router_id") or name),
                    _decay_remaining(peer.get("open") or {}, age),
                )
            except (OSError, ValueError):
                continue   # partially-written / vanished peer file

    def _apply(self, config: DynamicRouterConfig) -> None:
        from production_stack_tpu_torch.router.routing_logic import (
            reconfigure_routing_logic,
        )
        from production_stack_tpu_torch.router.service_discovery import (
            reconfigure_service_discovery,
        )

        if config.service_discovery == "static":
            urls = parse_static_urls(config.static_backends or "")
            models = [
                [m] for m in parse_static_model_names(config.static_models or "")
            ]
            if len(models) == 1 and len(urls) > 1:
                # Same broadcast rule as startup wiring (app.initialize_all):
                # one model name means every backend serves it.
                models = models * len(urls)
            reconfigure_service_discovery("static", urls=urls, models=models)
        elif config.service_discovery == "k8s":
            reconfigure_service_discovery(
                "k8s",
                namespace=config.k8s_namespace or "default",
                port=config.k8s_port or 8000,
                label_selector=config.k8s_label_selector,
            )
        if config.routing_logic:
            reconfigure_routing_logic(
                config.routing_logic, session_key=config.session_key
            )

    def get_current_config(self) -> Optional[dict]:
        return self.current_config.to_dict() if self.current_config else None

    def get_health(self) -> bool:
        return self._thread.is_alive()

    def close(self) -> None:
        self._running = False


_watcher: Optional[DynamicConfigWatcher] = None


def initialize_dynamic_config_watcher(
    config_path: Optional[str], watch_interval: float = 10.0,
    peer_dir: Optional[str] = None, router_id: Optional[str] = None,
) -> DynamicConfigWatcher:
    global _watcher
    if _watcher is not None:
        _watcher.close()
    _watcher = DynamicConfigWatcher(config_path, watch_interval,
                                    peer_dir=peer_dir, router_id=router_id)
    return _watcher


def get_dynamic_config_watcher() -> Optional[DynamicConfigWatcher]:
    return _watcher
