"""In-cluster entry point for the LoraAdapter controller."""

import argparse
import asyncio
import os

from production_stack_tpu_torch.controller.loraadapter import LoraAdapterReconciler
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)

_SA = "/var/run/secrets/kubernetes.io/serviceaccount"


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--namespace", default=os.environ.get(
        "WATCH_NAMESPACE", "default"))
    ap.add_argument("--adapters-dir", default="/adapters")
    ap.add_argument("--api-base", default=None)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    api_base = args.api_base
    token = None
    if api_base is None:
        host = os.environ.get("KUBERNETES_SERVICE_HOST",
                              "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        api_base = f"https://{host}:{port}"
        token_path = os.path.join(_SA, "token")
        if os.path.exists(token_path):
            with open(token_path) as f:
                token = f.read().strip()
    os.makedirs(args.adapters_dir, exist_ok=True)
    logger.info("LoraAdapter controller watching %s ns=%s dir=%s",
                api_base, args.namespace, args.adapters_dir)
    asyncio.run(
        LoraAdapterReconciler(api_base, args.adapters_dir, token=token)
        .run(args.namespace)
    )


if __name__ == "__main__":
    main()
