"""Three-term roofline model of a traced step.

Per (arch × shape) cell, from the op counts of ``analysis/opstats.py``:

    compute    = FLOPs / peak FLOP/s
    memory     = bytes accessed / HBM bandwidth
    collective = collective bytes / interconnect bandwidth

The constants are the NVIDIA H100 SXM5 80 GB datasheet's peaks, not
measurements: 989 TFLOP/s bf16 dense on the tensor cores, 3.35 TB/s of
HBM3 and 450 GB/s of NVLink 4 a direction. MODEL_FLOPS = 6·N·D (dense
train) / 6·N_active·D (MoE) / 2·N·D (inference) is reported alongside as
the usefulness ratio.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.analysis.opstats import OpStats
from repro_torch.models.module import tree_items

PEAK_FLOPS = 989e12       # bf16 dense tensor core / card
HBM_BW = 3.35e12          # bytes / s / card
ICI_BW = 450e9            # bytes / s / direction (NVLink 4)


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops_per_chip: float
    usefulness: float          # MODEL_FLOPS / FLOPs (per chip)
    dominant: str
    step_time_s: float         # max of the three terms (no overlap model)
    mfu: float                 # model_flops / (step_time × peak)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def analyze(stats: OpStats, model_flops_total: float, n_chips: int,
            peak=PEAK_FLOPS, hbm=HBM_BW, ici=ICI_BW) -> Roofline:
    compute = stats.flops / peak
    memory = stats.bytes_accessed / hbm
    collective = stats.collective_bytes / ici
    terms = {"compute": compute, "memory": memory, "collective": collective}
    dominant = max(terms, key=terms.get)
    model_pc = model_flops_total / max(1, n_chips)
    step = max(compute, memory, collective)
    return Roofline(
        compute_s=compute, memory_s=memory, collective_s=collective,
        hlo_flops=stats.flops, hlo_bytes=stats.bytes_accessed,
        collective_bytes=stats.collective_bytes,
        model_flops_per_chip=model_pc,
        usefulness=model_pc / max(stats.flops, 1.0),
        dominant=dominant,
        step_time_s=step,
        mfu=model_pc / max(step, 1e-12) / peak,
    )


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """6·N·D train / 2·N·D inference (N = active params for MoE)."""
    n = active_param_count
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def active_params(spec_tree) -> int:
    """Parameter count of a spec tree (every leaf, experts included)."""
    return active_param_count(spec_tree)


def active_param_count(spec_tree, top_k: Optional[int] = None,
                       n_experts: Optional[int] = None) -> int:
    """Parameter count with MoE expert tensors scaled by top_k/E."""
    total = 0
    for _, leaf in tree_items(spec_tree):
        n = int(math.prod(leaf.shape))
        if top_k and n_experts and "experts" in (leaf.axes or ()):
            n = int(n * top_k / n_experts)
        total += n
    return total
