"""Render a physical plan: per-node cost, strategy, backend and sharding.

The output is the EXPLAIN surface for plan decisions — what the paper's
optimizer chooses (join strategy, partition schemes) plus what this
reproduction adds (kernel backend, CSE sharing, plan-wide SPMD schemes).
Shared nodes print once with their full annotation; later references
render as ``(shared)`` so the DAG structure is visible in the tree layout.

On multi-worker plans each node shows its propagated output scheme, the
schemes it consumes its children in, and the predicted entries moved at
its boundary (``scheme=r←(r,b) comm=…``); the header totals them. Pass
``measured_bytes`` (from ``plan.executor.staged_collective_bytes``) to
print the HLO-measured collectives next to the prediction — the
end-to-end validation of the paper's cost model.
"""
from __future__ import annotations

from typing import List, Optional, Set

from repro_torch.plan.ops import PhysicalNode, PhysicalPlan
from repro_torch.plan.schemes import ENTRY_BYTES


def _annotations(n: PhysicalNode) -> str:
    parts: List[str] = []
    if n.strategy:
        parts.append(f"strategy={n.strategy}")
    if n.kernel:
        parts.append(f"kernel={n.kernel}")
    if n.backend:
        parts.append(f"backend={n.backend}")
    if "nnz_bound" in n.meta:
        # mask-propagation annotations (repro.plan.masks): certified nnz
        # bound, live/total block-mask density, COO device capacity
        parts.append(f"nnz≈{n.meta['nnz_bound']:.4g}")
        mask = n.meta.get("mask")
        if mask is not None:
            parts.append(f"mask={int(mask.sum())}/{mask.size}")
        if n.meta.get("cap") is not None:
            parts.append(f"cap={n.meta['cap']}")
        if n.meta.get("device") is False:
            parts.append("exec=host-fallback")
    if n.partition is not None:
        parts.append(
            f"schemes=({n.partition.scheme_a},{n.partition.scheme_b})"
            f" comm={n.partition.total:.3g}")
    if n.scheme is not None:
        ins = ",".join(n.in_schemes)
        parts.append(f"scheme={n.scheme}" + (f"←({ins})" if ins else "")
                     + f" moved={n.comm_est:.3g}")
    return ("  [" + " ".join(parts) + "]") if parts else ""


def render_optimizer(opt) -> List[str]:
    """EXPLAIN section for the optimizer's decision: search mode, fired
    rules, chosen cost, and the top rejected alternatives with their
    ``cost=flops/comm/nnz`` breakdown (``core.optimizer.Alternative``)."""
    fired = ", ".join(opt.fired) or "(none)"
    head = f"== optimizer: search={opt.search} | fired: {fired}"
    if opt.physical is not None:
        head += (f" | cost={opt.physical.total:.4g}"
                 f" (flops/comm/nnz {opt.physical.breakdown()})"
                 f" from {opt.physical_original.total:.4g}")
    lines = [head + " =="]
    phys = opt.physical
    if phys is not None and phys.calibrated_s is not None \
            and phys.alpha < 1.0:
        # calibrated cost model active (core.calibrate): show both sides
        # of the blend so EXPLAIN exposes analytic-vs-calibrated per plan
        lines.append(
            f"== cost model: analytic={phys.analytic:.4g}"
            f" calibrated={phys.calibrated_s*1e3:.4g}ms"
            f" alpha={phys.alpha:.2f} blended={phys.total:.4g} ==")
    if opt.alternatives:
        lines.append(f"== rejected alternatives"
                     f" (top {len(opt.alternatives)}) ==")
        for alt in opt.alternatives:
            lines.append(f"  {alt.describe()}")
    return lines


def render(plan: PhysicalPlan,
           measured_bytes: Optional[int] = None,
           opt=None) -> str:
    header = (f"== physical plan: mode={plan.mode} workers={plan.n_workers}"
              f" | {plan.n_nodes} ops from {plan.logical_nodes} logical"
              f" nodes ({plan.shared_nodes} shared)"
              f" | est {plan.est_flops:.4g} flops ==")
    lines = ([] if opt is None else render_optimizer(opt)) + [header]
    if plan.total_comm_est:
        comm = (f"== comm: predicted {plan.total_comm_est:.4g}"
                f" entries moved"
                f" (~{plan.total_comm_est * ENTRY_BYTES:.4g} B)")
        if measured_bytes is not None:
            comm += f" | measured {measured_bytes} collective bytes"
        lines.append(comm + " ==")
    seen: Set[int] = set()

    def walk(op_id: int, indent: int) -> None:
        n = plan.node(op_id)
        pad = "  " * indent
        if op_id in seen:
            lines.append(f"{pad}#{op_id} {n.label()} (shared)")
            return
        seen.add(op_id)
        lines.append(
            f"{pad}#{op_id} {n.label()}  shape={n.shape}"
            f" sp={n.sparsity:.3g} cost={n.est_flops:.4g}"
            f"{_annotations(n)}")
        for c in n.children:
            walk(c, indent + 1)

    walk(plan.root, 0)
    return "\n".join(lines)
