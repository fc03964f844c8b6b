"""The stack's control plane, the port of ``production_stack_tpu/controller/``
(same module names) on the standard library: the StaticRoute operator
(``python -m production_stack_tpu_torch.controller``) and the LoraAdapter
controller (``python -m production_stack_tpu_torch.controller.lora_main``),
CPU processes against the Kubernetes REST API."""

from production_stack_tpu_torch.controller.staticroute import (
    HealthCheckConfig,
    StaticRoute,
    StaticRouteReconciler,
)

__all__ = ["StaticRoute", "HealthCheckConfig", "StaticRouteReconciler"]
