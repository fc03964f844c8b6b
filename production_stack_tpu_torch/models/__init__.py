"""Model definitions of the port: the llama family (target and draft) and
the OPT family (window path), both at any tensor_parallel_size
(``models/tp_plan.py``)."""

from production_stack_tpu_torch.models import llama, opt

# arch -> (init_params, forward, compute_logits, lm_head_f32)
_ARCHS = {
    "llama": (llama.init_params, llama.forward, llama.compute_logits,
              llama.lm_head_f32),
    "opt": (opt.init_params, opt.forward, opt.compute_logits,
            opt.lm_head_f32),
}


def get_model_fns(cfg):
    """(init_params, forward, compute_logits, lm_head_f32) of ``cfg``'s
    arch (the reference's ``models.get_model_fns`` plus the f32 head)."""
    if cfg.arch not in _ARCHS:
        raise ValueError(f"Unknown arch {cfg.arch!r}; available: {list(_ARCHS)}")
    return _ARCHS[cfg.arch]


def empty_params(cfg, dtype, device, rank: int = 0, tp: int = 1):
    """Zeroed params of ``cfg``'s arch at their final shapes (this rank's
    shard), for ``init_params`` / ``weights.load_hf_params`` to fill in
    place (the arch's ``empty_params``)."""
    get_model_fns(cfg)
    return {"llama": llama, "opt": opt}[cfg.arch].empty_params(
        cfg, dtype, device, rank, tp)
