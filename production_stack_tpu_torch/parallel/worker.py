"""Entry point of mesh ranks 1..world-1.

``ServingEngine`` (rank 0) starts one process per worker rank, as
``python -m production_stack_tpu_torch.parallel.worker --rank R --port P
--spec JSON`` (``argv`` builds the line). A worker joins rank 0's mesh
(``parallel/mesh.py``), builds the same ``ModelRunner`` over its own tp
shard (its params loaded from the same checkpoint directory, drawn from
the same seed, or rank 0's broadcast; the speculative draft the config
names, the same way; its slice of the same LoRA adapters), runs rank 0's dispatch descriptors in order until the stop
descriptor (``ModelRunner.serve``), reports and exits. It dies with its
parent.
"""

import argparse
import dataclasses
import json
import os
import sys
from typing import List, Optional

import torch

from production_stack_tpu_torch.engine.config import EngineConfig
from production_stack_tpu_torch.engine.runner import ModelRunner
from production_stack_tpu_torch.models.config import resolve_model_config
from production_stack_tpu_torch.models.lora import load_registry
from production_stack_tpu_torch.parallel.mesh import RankMesh, die_with_parent
from production_stack_tpu_torch.utils import init_logger

logger = init_logger(__name__)


def argv(config: EngineConfig, rank: int, port: int, *,
         broadcast_params: bool, num_kv_blocks: Optional[int],
         broadcast_draft_params: bool = False) -> List[str]:
    """The command line of worker ``rank``. It runs with rank 0's intra-op
    thread count, so reductions over the replicated logits take the same
    order on every rank. ``broadcast_params`` / ``broadcast_draft_params``:
    rank 0 was given the target's / the draft's params and broadcasts
    them."""
    spec = {"config": dataclasses.asdict(config),
            "broadcast_params": broadcast_params,
            "broadcast_draft_params": broadcast_draft_params,
            "num_kv_blocks": num_kv_blocks,
            "threads": torch.get_num_threads(), "parent": os.getpid()}
    return [sys.executable, "-m", "production_stack_tpu_torch.parallel.worker",
            "--rank", str(rank), "--port", str(port), "--spec", json.dumps(spec)]


def main(args: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(description="mesh worker rank")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--spec", required=True)
    a = p.parse_args(args)
    spec = json.loads(a.spec)
    die_with_parent(spec["parent"])
    torch.set_num_threads(spec["threads"])
    cfg = EngineConfig(**spec["config"])
    mesh = RankMesh.join(a.rank, cfg.data_parallel_size,
                         cfg.sequence_parallel_size, cfg.tensor_parallel_size,
                         a.port, torch.device(cfg.device), cfg.tp_timeout_s)
    try:
        mc = resolve_model_config(cfg.model)
        runner = ModelRunner(cfg, mc, num_kv_blocks=spec["num_kv_blocks"],
                             mesh=mesh, broadcast_params=spec["broadcast_params"],
                             broadcast_draft_params=spec[
                                 "broadcast_draft_params"],
                             lora_registry=load_registry(cfg.lora_modules, mc))
        runner.serve()
        logger.info("rank %d: stopped after %d dispatches", a.rank,
                    runner._dispatches)
    finally:
        mesh.close()


if __name__ == "__main__":
    main()
