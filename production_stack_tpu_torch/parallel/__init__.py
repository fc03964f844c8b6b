"""The port's mesh: one process per rank of the dp x sp x tp grid
(``mesh.py``), the JAX package's Megatron sharding rules with their
replication fallback (``sharding.py``) and the worker entry point of ranks
1..world-1 (``worker.py``)."""
