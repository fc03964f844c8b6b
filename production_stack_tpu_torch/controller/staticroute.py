"""StaticRoute operator: CRD -> dynamic_config.json ConfigMap + router health.

Control-loop contract of the reference Go operator (reference
src/router-controller/internal/controller/staticroute_controller.go:71-398,
api/v1alpha1/staticroute_types.go:28-133), reimplemented against the raw
Kubernetes REST API (no kubernetes client dependency, matching the router's
service discovery):

  * Reconcile(cr): render the CR spec into a ``dynamic_config.json``
    ConfigMap (CreateOrUpdate, owner-referenced to the CR so deletion
    cascades) — the router's DynamicConfigWatcher hot-reloads the mounted
    file (production_stack_tpu_torch/router/dynamic_config.py).
  * Resolve the router via ``routerRef`` and poll its ``/health`` with
    success/failure thresholds; record ``HealthCheckSucceeded`` /
    ``HealthCheckFailed`` conditions and status.configMapRef /
    lastAppliedTime.
  * Requeue every max(healthCheck.periodSeconds, 60s), default 300s.

Run in-cluster:  ``python -m production_stack_tpu_torch.controller`` (see
__main__).

The port's copy of ``production_stack_tpu/controller/staticroute.py`` on the
standard library: ``KubeClient`` (one ``urllib`` request per call, on the
event loop's default executor) stands in for the aiohttp session, and the
reconcilers take a ``client`` where the JAX ones take a ``session``. The
ConfigMaps, status patches and health conditions are the JAX operator's.
"""

import asyncio
import datetime
import json
import urllib.error
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

GROUP = "production-stack.tpu"
VERSION = "v1alpha1"
PLURAL = "staticroutes"


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


class KubeClient:
    """The controllers' HTTP client: each call is one ``urllib`` request,
    run on the event loop's default executor. ``request`` returns (status,
    body) for every HTTP status and raises on a transport failure or a
    timeout (``timeout`` seconds, by default the aiohttp session's 300 s
    total)."""

    def __init__(self):
        # No proxies from the environment, as aiohttp's trust_env=False.
        self._opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def _send(self, method: str, url: str, data: Optional[bytes],
              headers: dict, timeout: float) -> Tuple[int, bytes]:
        req = urllib.request.Request(url, data=data, headers=headers,
                                     method=method)
        try:
            with self._opener.open(req, timeout=timeout) as resp:
                return resp.status, resp.read()
        except urllib.error.HTTPError as e:
            with e:
                return e.code, e.read()

    async def request(self, method: str, url: str,
                      data: Optional[bytes] = None,
                      headers: Optional[dict] = None,
                      timeout: float = 300.0) -> Tuple[int, bytes]:
        return await asyncio.get_running_loop().run_in_executor(
            None, self._send, method, url, data, dict(headers or {}), timeout)

    async def close(self) -> None:
        pass


def json_body(data: bytes):
    """A response body as JSON whatever its content type (aiohttp's
    ``resp.json(content_type=None)``: None for an empty body)."""
    return json.loads(data) if data.strip() else None


@dataclass
class HealthCheckConfig:
    timeout_seconds: int = 5
    period_seconds: int = 10
    success_threshold: int = 1
    failure_threshold: int = 3

    @staticmethod
    def from_dict(d: Optional[dict]) -> "HealthCheckConfig":
        d = d or {}
        return HealthCheckConfig(
            timeout_seconds=d.get("timeoutSeconds", 5),
            period_seconds=d.get("periodSeconds", 10),
            success_threshold=d.get("successThreshold", 1),
            failure_threshold=d.get("failureThreshold", 3),
        )


@dataclass
class StaticRoute:
    """Parsed StaticRoute custom resource (reference
    staticroute_types.go:28-133 field set)."""

    name: str
    namespace: str
    uid: str = ""
    service_discovery: str = "static"
    routing_logic: str = "roundrobin"
    static_backends: str = ""
    static_models: str = ""
    session_key: Optional[str] = None
    router_ref: Optional[dict] = None       # {name, namespace, port?}
    health_check: HealthCheckConfig = field(default_factory=HealthCheckConfig)
    config_map_name: Optional[str] = None

    @staticmethod
    def from_manifest(obj: dict) -> "StaticRoute":
        meta, spec = obj.get("metadata", {}), obj.get("spec", {})
        return StaticRoute(
            name=meta.get("name", ""),
            namespace=meta.get("namespace", "default"),
            uid=meta.get("uid", ""),
            service_discovery=spec.get("serviceDiscovery", "static"),
            routing_logic=spec.get("routingLogic", "roundrobin"),
            static_backends=spec.get("staticBackends", ""),
            static_models=spec.get("staticModels", ""),
            session_key=spec.get("sessionKey"),
            router_ref=spec.get("routerRef"),
            health_check=HealthCheckConfig.from_dict(spec.get("healthCheck")),
            config_map_name=spec.get("configMapName"),
        )

    @property
    def configmap_name(self) -> str:
        return self.config_map_name or f"{self.name}-dynamic-config"

    def dynamic_config(self) -> dict:
        """The router-consumed dynamic_config.json payload
        (production_stack_tpu_torch/router/dynamic_config.py:DynamicRouterConfig)."""
        out = {
            "service_discovery": self.service_discovery,
            "routing_logic": self.routing_logic,
            "static_backends": self.static_backends,
            "static_models": self.static_models,
        }
        if self.session_key:
            out["session_key"] = self.session_key
        return out


class StaticRouteReconciler:
    """Reconciles StaticRoute objects against a Kubernetes API base URL.

    ``api_base`` + optional bearer ``token`` abstract the cluster: production
    uses the in-cluster service account endpoint; tests point it at a fake
    API server (the envtest analogue, tests/test_staticroute_operator.py).
    """

    def __init__(self, api_base: str, token: Optional[str] = None,
                 client: Optional[KubeClient] = None):
        self.api_base = api_base.rstrip("/")
        self.token = token
        self._client = client
        # per-CR consecutive health counters (uid -> (successes, failures))
        self._health_counts: Dict[str, List[int]] = {}

    # ------------------------------------------------------------- k8s client
    def _headers(self) -> dict:
        h = {"Content-Type": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    async def _request(self, method: str, path: str, body: Optional[dict] = None,
                       content_type: Optional[str] = None):
        client = self._client
        assert client is not None, "call run() or pass a client"
        headers = self._headers()
        data = None
        if content_type:
            # merge-patch etc.: send pre-encoded JSON with the patch type
            headers["Content-Type"] = content_type
            data = json.dumps(body).encode()
        elif body is not None:
            data = json.dumps(body).encode()
        status, raw = await client.request(
            method, f"{self.api_base}{path}", data=data, headers=headers)
        return status, json_body(raw)

    async def list_staticroutes(self, namespace: Optional[str] = None) -> List[dict]:
        path = (
            f"/apis/{GROUP}/{VERSION}/namespaces/{namespace}/{PLURAL}"
            if namespace else f"/apis/{GROUP}/{VERSION}/{PLURAL}"
        )
        status, data = await self._request("GET", path)
        if status != 200:
            logger.warning("list %s -> %s", PLURAL, status)
            return []
        return data.get("items", [])

    # -------------------------------------------------------------- reconcile
    async def reconcile(self, obj: dict) -> dict:
        """One reconcile pass for a StaticRoute manifest. Returns the status
        patch that was applied (reference staticroute_controller.go:71-131)."""
        cr = StaticRoute.from_manifest(obj)
        await self._reconcile_configmap(cr)
        conditions = await self._check_router_health(cr)
        status = {
            "configMapRef": cr.configmap_name,
            "lastAppliedTime": _now(),
            "conditions": conditions,
        }
        await self._update_status(cr, status)
        return status

    async def _reconcile_configmap(self, cr: StaticRoute) -> None:
        """CreateOrUpdate the owner-ref'd ConfigMap holding
        dynamic_config.json (reference staticroute_controller.go:134-184)."""
        cm = {
            "apiVersion": "v1",
            "kind": "ConfigMap",
            "metadata": {
                "name": cr.configmap_name,
                "namespace": cr.namespace,
                "labels": {"app.kubernetes.io/managed-by": "pstpu-operator"},
                "ownerReferences": [{
                    "apiVersion": f"{GROUP}/{VERSION}",
                    "kind": "StaticRoute",
                    "name": cr.name,
                    "uid": cr.uid,
                    "controller": True,
                    "blockOwnerDeletion": True,
                }],
            },
            "data": {
                "dynamic_config.json": json.dumps(
                    cr.dynamic_config(), indent=2, sort_keys=True
                ),
            },
        }
        base = f"/api/v1/namespaces/{cr.namespace}/configmaps"
        status, _ = await self._request("GET", f"{base}/{cr.configmap_name}")
        if status == 404:
            status, data = await self._request("POST", base, cm)
            if status not in (200, 201):
                logger.warning("create configmap -> %s %s", status, data)
        else:
            status, data = await self._request(
                "PUT", f"{base}/{cr.configmap_name}", cm
            )
            if status not in (200, 201):
                logger.warning("update configmap -> %s %s", status, data)

    async def _router_health_url(self, cr: StaticRoute) -> Optional[str]:
        """Resolve routerRef -> service clusterIP URL (reference
        staticroute_controller.go:187-290)."""
        ref = cr.router_ref
        if not ref or ref.get("kind", "Service") != "Service":
            return None
        ns = ref.get("namespace") or cr.namespace
        status, svc = await self._request(
            "GET", f"/api/v1/namespaces/{ns}/services/{ref['name']}"
        )
        if status != 200:
            return None
        spec = svc.get("spec", {})
        ip = spec.get("clusterIP")
        ports = spec.get("ports") or []
        port = ref.get("port") or (ports[0].get("port") if ports else 80)
        if not ip:
            return None
        return f"http://{ip}:{port}/health"

    async def _check_router_health(self, cr: StaticRoute) -> List[dict]:
        url = await self._router_health_url(cr)
        if url is None:
            return [{
                "type": "HealthCheckSkipped",
                "status": "True",
                "reason": "NoRouterRef",
                "message": "spec.routerRef not set or unresolvable",
                "lastTransitionTime": _now(),
            }]
        hc = cr.health_check
        counts = self._health_counts.setdefault(cr.uid or cr.name, [0, 0])
        ok = False
        try:
            status, _ = await self._client.request(
                "GET", url, timeout=hc.timeout_seconds)
            ok = status == 200
        except Exception as e:  # noqa: BLE001 — any failure counts
            logger.debug("health probe %s failed: %s", url, e)
        if ok:
            counts[0] += 1
            counts[1] = 0
        else:
            counts[1] += 1
            counts[0] = 0
        conditions = []
        if counts[0] >= hc.success_threshold:
            conditions.append({
                "type": "HealthCheckSucceeded", "status": "True",
                "reason": "RouterHealthy",
                "message": f"{counts[0]} consecutive successful probes of {url}",
                "lastTransitionTime": _now(),
            })
        elif counts[1] >= hc.failure_threshold:
            conditions.append({
                "type": "HealthCheckFailed", "status": "True",
                "reason": "RouterUnhealthy",
                "message": f"{counts[1]} consecutive failed probes of {url}",
                "lastTransitionTime": _now(),
            })
        else:
            conditions.append({
                "type": "HealthCheckPending", "status": "True",
                "reason": "ThresholdNotReached",
                "message": (
                    f"successes={counts[0]}/{hc.success_threshold} "
                    f"failures={counts[1]}/{hc.failure_threshold}"
                ),
                "lastTransitionTime": _now(),
            })
        return conditions

    async def _update_status(self, cr: StaticRoute, status: dict) -> None:
        """JSON merge-patch against the status subresource — the form a real
        kube-apiserver accepts without resourceVersion round-trips (a bare
        PUT of {"status": ...} would be rejected with 422)."""
        path = (
            f"/apis/{GROUP}/{VERSION}/namespaces/{cr.namespace}/"
            f"{PLURAL}/{cr.name}/status"
        )
        st, data = await self._request(
            "PATCH", path, {"status": status},
            content_type="application/merge-patch+json",
        )
        if st not in (200, 201):
            logger.warning("status update for %s/%s -> %s %s",
                           cr.namespace, cr.name, st, data)

    # ------------------------------------------------------------------- loop
    def requeue_after(self, cr: StaticRoute) -> float:
        """max(healthCheck.period, 60s); 300s without health check
        (reference staticroute_controller.go:117-130)."""
        if cr.router_ref:
            return max(float(cr.health_check.period_seconds), 60.0)
        return 300.0

    async def run(self, namespace: Optional[str] = None,
                  stop_event: Optional[asyncio.Event] = None,
                  min_interval: float = 1.0) -> None:
        """Reconcile all StaticRoutes on their requeue schedule."""
        own_client = self._client is None
        if own_client:
            self._client = KubeClient()
        try:
            while stop_event is None or not stop_event.is_set():
                delay = 300.0
                for obj in await self.list_staticroutes(namespace):
                    try:
                        await self.reconcile(obj)
                    except Exception:  # noqa: BLE001 — keep reconciling
                        logger.exception(
                            "reconcile failed for %s",
                            obj.get("metadata", {}).get("name"),
                        )
                    delay = min(
                        delay,
                        self.requeue_after(StaticRoute.from_manifest(obj)),
                    )
                delay = max(delay, min_interval)
                if stop_event is not None:
                    try:
                        await asyncio.wait_for(stop_event.wait(), timeout=delay)
                    except asyncio.TimeoutError:
                        pass
                else:
                    await asyncio.sleep(delay)
        finally:
            if own_client:
                await self._client.close()
                self._client = None
