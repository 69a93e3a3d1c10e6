"""Ambient activation-sharding context.

Model code is pure; a launcher installs the mesh + rules here and model
layers call ``shard_act(x, *logical_axes)`` at materialization points.
Without an installed context the calls are the identity (one card, and
every test). The port has no multi-card program yet, so an installed
context makes ``shard_act`` raise instead of silently ignoring it.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional, Tuple

from repro_torch.models.module import MeshRules

_STATE = threading.local()


def current() -> Optional[Tuple[Any, MeshRules]]:
    return getattr(_STATE, "ctx", None)


@contextlib.contextmanager
def use_sharding(mesh, rules: MeshRules):
    prev = current()
    _STATE.ctx = (mesh, rules)
    try:
        yield
    finally:
        _STATE.ctx = prev


def shard_act(x, *logical: Optional[str]):
    """Constrain an activation to the logical axes (identity w/o context)."""
    if current() is None:
        return x
    raise NotImplementedError(
        "activation sharding needs a multi-card mesh; the port runs the "
        f"models on one device (logical axes {logical})")
