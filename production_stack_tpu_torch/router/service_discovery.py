"""Backend endpoint discovery: static list or live Kubernetes pod watch.

Counterpart of ``production_stack_tpu/router/service_discovery.py``:
  * ``EndpointInfo`` records url + model names + added timestamp + role;
  * ``StaticServiceDiscovery`` serves a fixed url/model list;
  * ``K8sPodIPServiceDiscovery`` lists, then watches labeled pods, gates on
    readiness, probes each ready pod's /v1/models;
  * module-level initialize/get/reconfigure singletons.

The pod watch runs on ``http.client`` in a daemon thread (the JAX class
runs aiohttp on an event loop of its own in one): the LIST, then the watch
stream read line by line whatever its framing (chunked or not, events of
any size), a 60 s socket read timeout, and ``close()`` shuts the stream's
socket so the thread leaves at once.
"""

import http.client
import json
import os
import socket
import ssl
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional
from urllib.parse import urlencode, urlsplit

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
#: Socket read timeout of the LIST, the watch stream and the model probe.
_READ_TIMEOUT_S = 60.0


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


class K8sPodIPServiceDiscovery(ServiceDiscovery):
    """Watch labeled pods via the Kubernetes API; serve ready pods only.

    A daemon thread runs the watch stream (reference pattern
    service_discovery.py:131,171-196) and keeps `_endpoints` fresh under a
    lock; readiness transitions add/remove endpoints so failed engines stop
    receiving traffic (the stack's elasticity story, SURVEY.md §5).
    """

    def __init__(
        self,
        namespace: str = "default",
        port: int = 8000,
        label_selector: Optional[str] = None,
        api_base: Optional[str] = None,
        token: Optional[str] = None,
        probe_models: bool = True,
    ):
        self.namespace = namespace
        self.port = port
        self.label_selector = label_selector
        self.probe_models = probe_models
        self._api_base = api_base or self._in_cluster_api_base()
        self._token = token if token is not None else self._read_sa_token()
        self._endpoints: Dict[str, EndpointInfo] = {}
        self._lock = threading.Lock()
        self._running = True
        self._watch_alive = time.time()
        self._conn: Optional[http.client.HTTPConnection] = None
        self._thread = threading.Thread(
            target=self._watch_loop, daemon=True, name="k8s-discovery"
        )
        self._thread.start()

    # ------------------------------------------------------------- k8s plumbing
    @staticmethod
    def _in_cluster_api_base() -> str:
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        return f"https://{host}:{port}"

    @staticmethod
    def _read_sa_token() -> Optional[str]:
        try:
            with open(f"{_SA_DIR}/token") as f:
                return f.read().strip()
        except OSError:
            return None

    def _ssl_context(self):
        try:
            return ssl.create_default_context(cafile=f"{_SA_DIR}/ca.crt")
        except (OSError, ssl.SSLError):
            ctx = ssl.create_default_context()
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
            return ctx

    def _open(self, url: str) -> http.client.HTTPConnection:
        parts = urlsplit(url)
        if parts.scheme == "https":
            return http.client.HTTPSConnection(
                parts.hostname, parts.port or 443, timeout=_READ_TIMEOUT_S,
                context=self._ssl_context())
        return http.client.HTTPConnection(parts.hostname, parts.port or 80,
                                          timeout=_READ_TIMEOUT_S)

    def _get(self, path: str, params: Dict[str, str]):
        """GET ``path`` on the API server: the open response (its status
        checked), on a connection ``close()`` can shut."""
        headers = {"Accept": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"
        conn = self._open(self._api_base)
        self._conn = conn
        prefix = urlsplit(self._api_base).path.rstrip("/")
        query = f"?{urlencode(params)}" if params else ""
        conn.request("GET", f"{prefix}{path}{query}", headers=headers)
        resp = conn.getresponse()
        if resp.status >= 400:
            conn.close()
            raise RuntimeError(f"GET {path} answered {resp.status}")
        return conn, resp

    # ------------------------------------------------------------- watch loop
    def _watch_loop(self) -> None:
        while self._running:
            try:
                self._watch_once()
            except Exception as e:  # noqa: BLE001 — stream must self-heal
                if not self._running:
                    return
                logger.warning("K8s watch stream error: %s; retrying", e)
                time.sleep(0.5)

    def _watch_once(self) -> None:
        path = f"/api/v1/namespaces/{self.namespace}/pods"
        base_params = {}
        if self.label_selector:
            base_params["labelSelector"] = self.label_selector
        # LIST + reconcile first: DELETED events lost across reconnects
        # would otherwise leave dead pods routable forever.
        conn, resp = self._get(path, base_params)
        try:
            listing = json.loads(resp.read())
        finally:
            conn.close()
        resource_version = (listing.get("metadata") or {}).get(
            "resourceVersion"
        )
        live_names = set()
        for pod in listing.get("items", []):
            name = (pod.get("metadata") or {}).get("name")
            if name:
                live_names.add(name)
            self._on_pod_event("ADDED", pod)
        with self._lock:
            for name in list(self._endpoints):
                if name not in live_names:
                    logger.info("Discovery: reconciling away %s", name)
                    del self._endpoints[name]
        self._watch_alive = time.time()

        params = {"watch": "true", "timeoutSeconds": "30", **base_params}
        if resource_version:
            params["resourceVersion"] = resource_version
        conn, resp = self._get(path, params)
        try:
            # Pod events routinely exceed 64 KiB (managedFields, env,
            # volumes): readline() has no length limit, so an oversized
            # event never wedges the watch in a reconnect loop.
            while self._running:
                line = resp.readline()
                if not line:
                    return
                self._watch_alive = time.time()
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                self._on_pod_event(event.get("type"), event.get("object", {}))
        finally:
            conn.close()

    @staticmethod
    def _pod_ready(pod: dict) -> bool:
        statuses = (pod.get("status") or {}).get("containerStatuses") or []
        return bool(statuses) and all(s.get("ready") for s in statuses)

    def _probe_models(self, url: str) -> List[str]:
        # Engines behind --api-key expect the probe to authenticate with the
        # shared VLLM_API_KEY, like the reference probe
        # (reference src/vllm_router/service_discovery.py:156-169).
        headers = {}
        api_key = os.environ.get("VLLM_API_KEY")
        if api_key:
            headers["Authorization"] = f"Bearer {api_key}"
        parts = urlsplit(url)
        conn = http.client.HTTPConnection(parts.hostname, parts.port,
                                          timeout=_READ_TIMEOUT_S)
        try:
            conn.request("GET", "/v1/models", headers=headers)
            data = json.loads(conn.getresponse().read())
            return [m["id"] for m in data.get("data", [])]
        except Exception as e:  # noqa: BLE001 — pod may not be serving yet
            logger.debug("Model probe of %s failed (pod may not be "
                         "serving yet): %s", url, e)
            return []
        finally:
            conn.close()

    def _on_pod_event(self, etype: str, pod: dict) -> None:
        meta = pod.get("metadata") or {}
        name = meta.get("name")
        ip = (pod.get("status") or {}).get("podIP")
        if not name:
            return
        ready = self._pod_ready(pod)
        if etype == "DELETED" or not ready or not ip:
            with self._lock:
                if name in self._endpoints:
                    logger.info("Discovery: removing engine %s", name)
                    del self._endpoints[name]
            return
        url = f"http://{ip}:{self.port}"
        models = self._probe_models(url) if self.probe_models else []
        # Disagg role from the pod label the Helm chart stamps on role-split
        # engine deployments (helm/templates/deployment-engine.yaml). A
        # typo'd label must not silently orphan the pod into a nonexistent
        # pool (every request would then take the pool_empty fallback).
        role = ((meta.get("labels") or {}).get("pstpu-role") or "") \
            .strip().lower() or None
        if role is not None and role not in ("unified", "prefill", "decode"):
            logger.warning(
                "Pod %s has invalid pstpu-role label %r; treating as "
                "role-less (scraped pstpu:disagg_role may still apply)",
                name, role,
            )
            role = None
        with self._lock:
            known = self._endpoints.get(name)
            if known is None or known.url != url \
                    or known.model_names != models or known.role != role:
                logger.info("Discovery: adding engine %s at %s (%s, role=%s)",
                            name, url, models, role)
                self._endpoints[name] = EndpointInfo(
                    url=url, model_names=models, pod_name=name, role=role,
                    # A metadata refresh (models/role) on a pod ALREADY
                    # serving keeps its discovery age — the ramp-in
                    # slow-start must not restart on label churn.
                    **({"added_timestamp": known.added_timestamp}
                       if known is not None and known.url == url else {}),
                )

    # -------------------------------------------------------------- interface
    def get_endpoint_info(self) -> List[EndpointInfo]:
        with self._lock:
            return list(self._endpoints.values())

    def get_health(self) -> bool:
        # Healthy if the watch thread is alive and has heard from the API
        # server recently (reference service_discovery.py:266-273).
        return self._thread.is_alive() and time.time() - self._watch_alive < 120

    def close(self) -> None:
        self._running = False
        conn = self._conn
        sock = getattr(conn, "sock", None)
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass


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
        _service_discovery = K8sPodIPServiceDiscovery(
            namespace=kwargs.get("namespace", "default"),
            port=kwargs.get("port", 8000),
            label_selector=kwargs.get("label_selector"),
            api_base=kwargs.get("api_base"),
            token=kwargs.get("token"),
        )
    else:
        raise ValueError(f"Unknown service discovery type: {kind!r}")
    return _service_discovery


def reconfigure_service_discovery(kind: str, **kwargs) -> ServiceDiscovery:
    return initialize_service_discovery(kind, **kwargs)


def get_service_discovery() -> ServiceDiscovery:
    assert _service_discovery is not None, "service discovery not initialized"
    return _service_discovery
