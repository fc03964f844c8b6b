"""Backend endpoint discovery: a static list.

Counterpart of ``production_stack_tpu/router/service_discovery.py``:
  * ``EndpointInfo`` records url + model names + added timestamp + role;
  * ``StaticServiceDiscovery`` serves a fixed url/model list;
  * module-level initialize/get/reconfigure singletons.

Kubernetes pod discovery (the JAX package's ``K8sPodIPServiceDiscovery``)
is not ported yet (``ROADMAP.md`` Queue 1): ``initialize_service_discovery
("k8s")`` refuses it.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

K8S_NOT_PORTED = ("Kubernetes service discovery is not ported to "
                  "production_stack_tpu_torch yet (ROADMAP.md, Queue 1); "
                  "use --service-discovery static")


@dataclass
class EndpointInfo:
    url: str
    model_names: List[str] = field(default_factory=list)
    added_timestamp: float = field(default_factory=time.time)
    pod_name: Optional[str] = None
    # Disagg role (unified|prefill|decode) from --static-backend-roles or
    # the pod's pstpu-role label; None = unknown (the DisaggRouter falls
    # back to the scraped pstpu:disagg_role metric, then "unified").
    role: Optional[str] = None

    # Back-compat alias: parts of the reference treat this as a single name
    # (reference service_discovery.py:30-47 stores `model_name`).
    @property
    def model_name(self) -> Optional[str]:
        return self.model_names[0] if self.model_names else None


class ServiceDiscovery:
    def get_endpoint_info(self) -> List[EndpointInfo]:
        raise NotImplementedError

    def get_health(self) -> bool:
        return True

    def close(self) -> None:
        pass


class StaticServiceDiscovery(ServiceDiscovery):
    """Fixed backend list from --static-backends/--static-models
    (+ optional --static-backend-roles for disagg pools).

    ``known_timestamps`` ({url: added_timestamp}) carries discovery ages
    across a reconfigure (dynamic-config scale-out): a backend that was
    already serving must NOT get a fresh timestamp — the router's ramp-in
    slow-start (docs/ELASTIC.md) keys on added_timestamp, and resetting it
    would re-ramp the whole fleet every time one engine joins."""

    def __init__(self, urls: List[str], models: List[List[str]],
                 roles: Optional[List[Optional[str]]] = None,
                 known_timestamps: Optional[Dict[str, float]] = None):
        assert len(urls) == len(models), (urls, models)
        if roles is not None:
            assert len(roles) == len(urls), (urls, roles)
        known = known_timestamps or {}
        self._endpoints = [
            EndpointInfo(url=u, model_names=list(m),
                         role=(roles[i] if roles else None),
                         **({"added_timestamp": known[u]} if u in known
                            else {}))
            for i, (u, m) in enumerate(zip(urls, models))
        ]

    def get_endpoint_info(self) -> List[EndpointInfo]:
        return list(self._endpoints)


_service_discovery: Optional[ServiceDiscovery] = None


def initialize_service_discovery(kind: str, **kwargs) -> ServiceDiscovery:
    global _service_discovery
    known_timestamps: Dict[str, float] = {}
    if _service_discovery is not None:
        # Reconfigure (dynamic-config scale-out): surviving backends keep
        # their discovery age so the router's ramp-in slow-start
        # (docs/ELASTIC.md) applies only to the genuinely new ones.
        try:
            known_timestamps = {
                ep.url: ep.added_timestamp
                for ep in _service_discovery.get_endpoint_info()
            }
        except Exception:  # noqa: BLE001 — a dying watcher must not block
            logger.warning("Could not snapshot endpoint ages before "
                           "reconfigure", exc_info=True)
        _service_discovery.close()
    if kind == "static":
        _service_discovery = StaticServiceDiscovery(
            kwargs["urls"], kwargs["models"], roles=kwargs.get("roles"),
            known_timestamps=known_timestamps,
        )
    elif kind == "k8s":
        raise ValueError(K8S_NOT_PORTED)
    else:
        raise ValueError(f"Unknown service discovery type: {kind!r}")
    return _service_discovery


def reconfigure_service_discovery(kind: str, **kwargs) -> ServiceDiscovery:
    return initialize_service_discovery(kind, **kwargs)


def get_service_discovery() -> ServiceDiscovery:
    assert _service_discovery is not None, "service discovery not initialized"
    return _service_discovery
