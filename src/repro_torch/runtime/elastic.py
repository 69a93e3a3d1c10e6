"""Elastic scaling: recompute mesh + batch partitioning after world changes.

Given a new device count after failures/scale-up, pick the largest valid
(data, model) factorization that (a) keeps the model-parallel degree fixed
(weights re-shard along data/fsdp only — cheap) and (b) keeps the global
batch divisible; emit the re-shard plan consumed by Checkpointer.restore.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    n_devices: int
    data: int
    model: int
    pod: int = 1

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.pod, self.data, self.model) if self.pod > 1 \
            else (self.data, self.model)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pod > 1 \
            else ("data", "model")


def replan_mesh(n_devices: int, model_parallel: int,
                global_batch: int, pods: int = 1) -> MeshPlan:
    if n_devices % (model_parallel * pods):
        # drop devices to the nearest multiple (the reserve pool absorbs
        # the remainder)
        n_devices = (n_devices // (model_parallel * pods)) \
            * model_parallel * pods
    if n_devices == 0:
        raise ValueError("not enough devices for the model-parallel degree")
    data = n_devices // (model_parallel * pods)
    while data > 1 and global_batch % data:
        data -= 1
    return MeshPlan(data * model_parallel * pods, data, model_parallel,
                    pods)


def rebalance_batch(global_batch: int, old_data: int, new_data: int
                    ) -> List[int]:
    """Per-data-shard batch sizes after a world change (as even as
    possible; sum preserved)."""
    base = global_batch // new_data
    extra = global_batch % new_data
    return [base + (1 if i < extra else 0) for i in range(new_data)]
