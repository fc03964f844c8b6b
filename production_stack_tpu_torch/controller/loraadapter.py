"""LoraAdapter controller: resolve adapter sources into shared storage.

Contract of the reference lora-controller (reference
helm/templates/loraadapter-crd.yaml:1-225, deployment-lora-controller.yaml):
watch LoraAdapter CRs, fetch the adapter (local path copy or HF hub
download) into the shared adapter directory engines mount, and report
status.phase Pending -> Downloading -> Ready/Failed. Engines then serve the
adapter via ``--lora-modules name=path`` (production_stack_tpu_torch/models/lora.py).

The port's copy of ``production_stack_tpu/controller/loraadapter.py``, on
``staticroute.KubeClient`` in place of an aiohttp session.
"""

import asyncio
import datetime
import os
import shutil
from typing import Optional

from production_stack_tpu_torch.controller.staticroute import (
    GROUP,
    VERSION,
    KubeClient,
    json_body,
)
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

PLURAL = "loraadapters"


def _now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%M:%SZ"
    )


class LoraAdapterReconciler:
    """Reconcile LoraAdapter CRs against a Kubernetes API base URL (same
    client conventions as StaticRouteReconciler)."""

    def __init__(self, api_base: str, adapters_dir: str,
                 token: Optional[str] = None,
                 client: Optional[KubeClient] = None):
        self.api_base = api_base.rstrip("/")
        self.adapters_dir = adapters_dir
        self.token = token
        self._client = client

    def _headers(self, content_type: Optional[str] = None) -> dict:
        h = {"Content-Type": content_type or "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    async def list_adapters(self, namespace: str) -> list:
        url = (f"{self.api_base}/apis/{GROUP}/{VERSION}/namespaces/"
               f"{namespace}/{PLURAL}")
        status, data = await self._client.request("GET", url,
                                                  headers=self._headers())
        if status != 200:
            return []
        return json_body(data).get("items", [])

    async def _set_phase(self, ns: str, name: str, phase: str,
                         message: str = "", path: str = "",
                         spec_hash: str = "") -> None:
        url = (f"{self.api_base}/apis/{GROUP}/{VERSION}/namespaces/{ns}/"
               f"{PLURAL}/{name}/status")
        import json as _json

        body = _json.dumps({"status": {
            "phase": phase, "message": message, "adapterPath": path,
            "observedSpecHash": spec_hash, "lastUpdated": _now(),
        }})
        status, _ = await self._client.request(
            "PATCH", url, data=body.encode(),
            headers=self._headers("application/merge-patch+json"),
        )
        if status not in (200, 201):
            logger.warning("status patch %s/%s -> %s", ns, name, status)

    def _resolve(self, source: dict) -> str:
        """Fetch the adapter into adapters_dir; returns the local path."""
        name = source["adapterName"]
        dest = os.path.join(self.adapters_dir, name)
        stype = source.get("type", "local")
        if stype == "local":
            src = source.get("adapterPath")
            if not src or not os.path.isdir(src):
                raise FileNotFoundError(f"adapterPath {src!r} not found")
            if os.path.abspath(src) != os.path.abspath(dest):
                if os.path.isdir(dest):
                    shutil.rmtree(dest)
                shutil.copytree(src, dest)
            else:
                dest = src
        elif stype == "huggingface":
            repo = source.get("repository") or source.get("adapterPath")
            if not repo:
                raise ValueError("huggingface source needs 'repository'")
            from huggingface_hub import snapshot_download

            dest = snapshot_download(repo, local_dir=dest)
        else:
            raise ValueError(f"unsupported adapterSource.type {stype!r}")
        # sanity: a PEFT checkpoint has an adapter_config.json
        if not os.path.exists(os.path.join(dest, "adapter_config.json")):
            raise FileNotFoundError(
                f"{dest} is not a PEFT checkpoint (no adapter_config.json)"
            )
        return dest

    async def reconcile(self, obj: dict) -> str:
        """Returns the resulting phase."""
        meta = obj.get("metadata", {})
        ns, name = meta.get("namespace", "default"), meta.get("name", "")
        spec = obj.get("spec", {})
        source = spec.get("adapterSource") or {}
        status = obj.get("status") or {}
        import hashlib as _hashlib
        import json as _json

        spec_hash = _hashlib.sha256(
            _json.dumps(spec, sort_keys=True).encode()
        ).hexdigest()[:16]
        # Skip only while BOTH ready and unchanged: editing a Ready CR's
        # spec must re-resolve the adapter.
        if status.get("phase") == "Ready" \
                and status.get("observedSpecHash") == spec_hash:
            return "Ready"
        await self._set_phase(ns, name, "Downloading",
                              f"fetching {source.get('adapterName')}")
        try:
            loop = asyncio.get_running_loop()
            path = await loop.run_in_executor(None, self._resolve, source)
        except Exception as e:  # noqa: BLE001 — recorded on the CR
            await self._set_phase(ns, name, "Failed", str(e))
            return "Failed"
        await self._set_phase(ns, name, "Ready", "adapter available", path,
                              spec_hash=spec_hash)
        return "Ready"

    async def run(self, namespace: str = "default", period: float = 30.0,
                  stop_event: Optional[asyncio.Event] = None) -> None:
        own = self._client is None
        if own:
            self._client = KubeClient()
        try:
            while stop_event is None or not stop_event.is_set():
                for obj in await self.list_adapters(namespace):
                    try:
                        await self.reconcile(obj)
                    except Exception:  # noqa: BLE001
                        logger.exception("lora reconcile failed")
                if stop_event is not None:
                    try:
                        await asyncio.wait_for(stop_event.wait(), period)
                    except asyncio.TimeoutError:
                        pass
                else:
                    await asyncio.sleep(period)
        finally:
            if own:
                await self._client.close()
                self._client = None
