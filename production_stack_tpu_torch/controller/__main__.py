"""In-cluster entry point for the StaticRoute operator.

Usage: ``python -m production_stack_tpu_torch.controller [--namespace ns]``.
Resolves the API server + service-account token the standard in-cluster way
(same convention as the router's K8s service discovery).
"""

import argparse
import asyncio
import os

from production_stack_tpu_torch.controller.staticroute import StaticRouteReconciler
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_SA = "/var/run/secrets/kubernetes.io/serviceaccount"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--namespace", default=os.environ.get("WATCH_NAMESPACE"))
    ap.add_argument("--api-base", default=None,
                    help="Kubernetes API base URL (default: in-cluster)")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    api_base = args.api_base
    token = None
    if api_base is None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        api_base = f"https://{host}:{port}"
        token_path = os.path.join(_SA, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
    logger.info("StaticRoute operator watching %s (ns=%s)",
                api_base, args.namespace or "<all>")
    asyncio.run(
        StaticRouteReconciler(api_base, token=token).run(args.namespace)
    )


if __name__ == "__main__":
    main()
