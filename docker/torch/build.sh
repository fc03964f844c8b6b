#!/usr/bin/env bash
# Build the PyTorch/CUDA port's images (engine, router, cache server),
# tagged production-stack-tpu-torch/<name>. The StaticRoute operator and the
# LoRA controller stay on the JAX package's images (docker/build.sh).
#
#   ./docker/torch/build.sh [TAG] [REGISTRY_PREFIX]
set -euo pipefail

TAG="${1:-latest}"
PREFIX="${2:-}"
[ -n "$PREFIX" ] && PREFIX="${PREFIX%/}/"

cd "$(dirname "$0")/../.."

build() {
    local name="$1" dockerfile="$2"
    echo "==> building ${PREFIX}production-stack-tpu-torch/${name}:${TAG}"
    docker build -f "docker/torch/${dockerfile}" \
        -t "${PREFIX}production-stack-tpu-torch/${name}:${TAG}" .
}

build engine       Dockerfile.engine
build router       Dockerfile.router
build cache-server Dockerfile.cache-server

echo "All port images built."
