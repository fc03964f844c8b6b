"""The engine's ``/metrics`` text exposition, on the standard library.

Counterpart of ``production_stack_tpu/server/metrics.py``: the same series
names and label sets on the same ``stats()`` (``engine/metrics.py:
engine_families`` lists them), so the router's ``EngineStatsScraper``,
the reference dashboard and the stack's metric registry read a port engine
as they read a JAX one. At tp > 1 the gauges are rank 0's, except
``pstpu:hbm_kv_bytes``, which has one series per rank.
"""

import torch  # noqa: F401 — every module of the port is a torch module

from production_stack_tpu_torch.engine.metrics import engine_families


def _value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6f}"
    return str(int(v))


def _labels(lv: dict, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in lv.items()]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}"


def render_engine_metrics(engine, model_name: str) -> str:
    """The Prometheus text of every series of ``engine``."""
    lines = []
    for name, kind, doc, samples in engine_families(engine, model_name):
        lines.append(f"# HELP {name} {doc}")
        lines.append(f"# TYPE {name} {kind}")
        for lv, v in samples:
            if kind != "histogram":
                lines.append(f"{name}{_labels(lv)} {_value(v)}")
                continue
            for bound, cum in v.cumulative():
                le = 'le="%s"' % bound
                lines.append(f"{name}_bucket{_labels(lv, le)} {cum}")
            lines.append(f"{name}_sum{_labels(lv)} {v.sum:.6f}")
            lines.append(f"{name}_count{_labels(lv)} {v.count}")
    return "\n".join(lines) + "\n"
