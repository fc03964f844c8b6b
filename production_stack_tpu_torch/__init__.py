"""PyTorch/CUDA port of the production-stack-tpu serving engine.

A package of its own beside ``production_stack_tpu`` (the JAX reference): it
imports ``torch`` and nothing of JAX or of the JAX package. Module names
follow the JAX package so each counterpart is easy to find.
"""
