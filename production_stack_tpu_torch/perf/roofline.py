"""Decode HBM-bandwidth roofline, for the engine's live telemetry.

Counterpart of ``production_stack_tpu/perf/roofline.py`` (the port keeps
its own copy). Each fused decode step reads every weight byte once,
amortized over the batch, plus each row's live KV, so the aggregate
ceiling is ``peak / (param_bytes / batch + kv_bytes_per_token * avg_ctx)``
tokens per second. ``ServingEngine._live_perf`` holds the rolling dispatch
window's tokens per second against it as ``pstpu:live_hbm_bw_pct``.

The peak comes from ``EngineConfig.hbm_peak_gbps`` (``--hbm-peak-gbps``);
its default is looked up from the card's name in ``HBM_PEAK_GBPS_BY_CARD``.
A card not in the table, with no explicit peak, has no ceiling: the gauge
reads 0 and one warning is logged.
"""

from typing import Optional

import torch  # noqa: F401 — every module of the port is a torch module

# Peak HBM bandwidth, GB/s, by a substring of torch.cuda.get_device_name().
# Source: NVIDIA H100 Tensor Core GPU data sheet (H100 SXM: HBM3,
# 3.35 TB/s), the figure chip_smoke.py's bounds use.
HBM_PEAK_GBPS_BY_CARD = {
    "H100 80GB HBM3": 3350.0,
}

def peak_gbps_for(device_name: Optional[str]) -> Optional[float]:
    """The table's peak for a card name, or None."""
    for key, gbps in HBM_PEAK_GBPS_BY_CARD.items():
        if device_name and key in device_name:
            return gbps
    return None


def param_bytes(mc, weight_dtype_bytes: float) -> float:
    """Bytes of the weights one decode step reads (layers + embedding, and
    the head when untied), in the compute dtype."""
    d, f, v = mc.hidden_size, mc.intermediate_size, mc.vocab_size
    dh, h, hkv, nl = mc.head_dim_, mc.num_heads, mc.num_kv_heads, mc.num_layers
    per_layer = d * (h * dh) + 2 * d * (hkv * dh) + (h * dh) * d + 3 * d * f
    embed = v * d * (1 if mc.tie_word_embeddings else 2)
    return (nl * per_layer + embed) * weight_dtype_bytes


def roofline_components(model: str, weight_dtype_bytes: float,
                        kv_cache_dtype: str, batch: int, avg_ctx: float,
                        peak_gbs: float, tokens_per_target_step: float = 1.0,
                        num_chips: int = 1) -> dict:
    """Aggregate decode roofline from the model's byte counts: weight
    bytes (compute dtype, amortized over the batch) apart from KV bytes
    (the KV-cache storage dtype and its per-slot scales, per row). The
    reference's pure function, with the peak an argument: the port has no
    default device. ``num_chips`` multiplies the peak (each tp rank reads
    its shard over its own memory)."""
    from production_stack_tpu_torch.engine.config import EngineConfig
    from production_stack_tpu_torch.models.config import resolve_model_config

    peak = float(peak_gbs) * max(1, int(num_chips))
    mc = resolve_model_config(model)
    weights = param_bytes(mc, weight_dtype_bytes)
    kv_bytes_per_token = EngineConfig(
        model=model, kv_cache_dtype=kv_cache_dtype, device="cpu",
    ).kv_cache_bytes_per_token(mc)
    step_bytes_per_row = weights / batch + kv_bytes_per_token * avg_ctx
    factor = max(1.0, float(tokens_per_target_step))
    return {
        "kv_cache_dtype": kv_cache_dtype,
        "param_bytes": weights,
        "kv_bytes_per_token": kv_bytes_per_token,
        "kv_bytes_per_step_per_row": kv_bytes_per_token * avg_ctx,
        "tokens_per_target_step": factor,
        "num_chips": max(1, int(num_chips)),
        "roofline_tok_s": peak * 1e9 / step_bytes_per_row * factor,
    }
