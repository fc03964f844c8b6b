"""Tensor parallelism for the port: one process per tp rank
(``mesh.py``), the JAX package's Megatron sharding rules (``sharding.py``)
and the worker entry point of ranks 1..tp-1 (``worker.py``)."""
