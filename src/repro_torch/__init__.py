"""PyTorch/CUDA port of MatRel (relational query processing on matrices).

Laid out module for module like the JAX package it ports: ``core`` (the
``Session``/``Matrix`` API, the optimizer, the join tiers), ``plan`` (the
physical planner and DAG executor), ``kernels`` (the kernel registry and
the hand-written CUDA kernels with their plain PyTorch versions) and
``obs`` (span tracing). Importing this package imports ``torch`` and
numpy only.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
