"""Execute a physical operator DAG (the default ``collect()`` path).

Evaluation walks ``plan.nodes`` in order — the builder emits children
before parents, so the list *is* a topological order — and memoizes every
result by op id. Because hash-consing gives one node per distinct subplan,
each shared subexpression is computed exactly once (``stats`` records the
per-kind evaluation counts so tests can assert it).

Paths:

* **eager** — per-node evaluation reusing the exact primitive semantics of
  the tree-walk oracle (``core.executor.agg_dense``/``select_dense``,
  ``core.joins``), so the DAG executor is value-equivalent by construction;
* **staged dense** — when every node is stageable and the plan was built
  for ``mode="dense"``, the whole DAG becomes one function of the leaf
  tensors, cached on the ``PhysicalPlan``;
* **staged sparse** — sparse-tier plans stage too: overlay joins are gated
  by the *plan-time propagated* block masks (``repro_torch.plan.masks``),
  and COO-producing joins run the device-resident tier
  (``repro_torch.core.joins_device``) over static-capacity buffers sized
  from the propagated nnz bounds. Guarded: a plan whose capacity bound
  exceeds ``masks.device_cap_limit()``, or whose buffers overflow at
  runtime (leaf values drifted under an unchanged block mask), falls back
  to the eager host oracle for that run.

PyTorch has nothing to trace, so a staged function is the per-node
closure run eagerly; it keeps the plan-time static masks and capacities
and is cached under the mask fingerprint and capacities, as in the JAX
package. Building it passes the ``stage_compile`` fault seam
(``runtime.faults``).

Both staged paths have an **SPMD variant**: given a worker mesh
(session-owned, ``Session.mesh``) and a multi-worker plan, every node
runs on the mesh's workers (``core.spmd``). A node takes each child in
the scheme the plan-wide pass chose for that edge (``node.in_schemes``,
a counted reshard where the child's layout differs, once per child and
scheme), computes on its workers' shards by the operator algebra of
``plan.schemes`` and leaves its output in ``node.scheme``; the counted
collectives are the reshards the scheme pass predicted. On the sparse
tier overlays, masked matmuls and masked aggregations launch their
kernel once a worker on that worker's shard and block-mask slice (a
split off the block edges all-gathers the operands and launches once),
and COO-producing joins run once on whole operands.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.obs.trace import TRACER, span
from repro_torch.runtime import faults

from repro_torch.core import joins as joinsmod
from repro_torch.core import joins_device as joinsdev
# shared primitive semantics: defined once next to the tree-walk oracle so
# the two engines cannot drift
from repro_torch.core.executor import (
    agg_dense, as_matrix, dense_join_result, env_device, ew_values,
    leaf_value, select_dense,
)
from repro_torch.core.expr import (
    Agg, AggDim, ElemWise, EWOp, Join, MatScalar, Select,
)
from repro_torch.core.joins import COOTensor
from repro_torch.core.matrix import BlockMatrix
from repro_torch.plan import ops as P

Result = Union[BlockMatrix, COOTensor]

# kernel-facing spelling of the fusable aggregation dims (DIAG never fuses —
# the builder only emits MASKED_AGG for these three)
_AGG_DIM = {AggDim.ROW: "row", AggDim.COL: "col", AggDim.ALL: "all"}


class PlanExecutor:
    """Memoized topological evaluator for ``PhysicalPlan``s.

    ``device`` is where synthesized leaves are made (default: the device
    of the catalog's tensors). ``stage_jit=False`` forces the per-node
    eager walk (the serving tier's degraded path: it never passes the
    staged-build fault seam). ``mesh`` (session-owned,
    ``core.partitioner.worker_mesh``) selects the SPMD staged paths for
    multi-worker plans: each worker's work runs on its device, and the
    result is handed back on ``device``.
    """

    def __init__(self, env: Dict[str, BlockMatrix], device=None,
                 stage_jit: bool = True, mesh=None, node_cache=None,
                 metrics=None):
        self.env = env
        self.device = env_device(env) if device is None \
            else torch.device(device)
        self.stage_jit = stage_jit
        self.mesh = mesh
        # cross-query materialized-result cache (the serving tier's
        # inter-query CSE): an object with ``get(plan, node)`` →
        # result-or-None and ``put(plan, node, result)``. Sharing happens
        # per *node*, so it composes with the eager path only — ``run``
        # skips staging when a cache is installed.
        self.node_cache = node_cache
        # optional ``obs.metrics.MetricsRegistry``: every counter bump
        # below mirrors into it as ``executor_<name>`` (the serving tier
        # passes its per-engine registry); ``stats`` remains the per-run
        # view the tests and engine read
        self.metrics = metrics
        self.stats: Dict[str, int] = {
            "node_evals": 0, "node_reuses": 0, "matmuls": 0,
            "masked_matmuls": 0, "masked_aggs": 0, "joins": 0,
            "staged": 0, "staged_spmd": 0, "staged_sparse": 0,
            "staged_sparse_spmd": 0, "sparse_fallbacks": 0,
            "sparse_overflows": 0, "blocks_skipped": 0, "blocks_total": 0,
            # SPMD runs: collective bytes counted between workers, and
            # the block-mask-gated nodes (overlays, masked matmuls and
            # aggregations) that ran once a worker on its shard vs once
            # on all-gathered operands (a split off the block edges)
            "collective_bytes": 0, "spmd_sharded_nodes": 0,
            "spmd_gathered_nodes": 0,
        }
        # wall-clock split of the most recent ``run``: building the staged
        # function vs running it
        self.timings: Dict[str, float] = {"compile_s": 0.0, "execute_s": 0.0}

    def _bump(self, name: str, n: int = 1) -> None:
        """Single increment site: the per-run dict and (when installed)
        the registry counter move together."""
        self.stats[name] += n
        if self.metrics is not None:
            self.metrics.counter("executor_" + name).inc(n)

    # -- public ---------------------------------------------------------------
    def run(self, plan: P.PhysicalPlan) -> Result:
        if self.stage_jit and plan.jit_safe and self.node_cache is None:
            mesh = self.mesh if plan.n_workers > 1 else None
            if mesh is not None and mesh.n != plan.n_workers:
                raise ValueError(f"plan built for {plan.n_workers} workers, "
                                 f"mesh has {mesh.n}")
            if plan.mode == "dense":
                return self._run_staged(plan, mesh)
            out = self._run_staged_sparse(plan, mesh)
            if out is not _FALLBACK:
                return out
        return self._run_eager(plan)

    # -- eager path -----------------------------------------------------------
    def _run_eager(self, plan: P.PhysicalPlan) -> Result:
        traced = TRACER.active()
        results: Dict[int, Result] = {}
        with span("execute", path="eager", nodes=plan.n_nodes):
            for node in plan.nodes:
                if self.node_cache is not None:
                    hit = self.node_cache.get(plan, node)
                    if hit is not None:
                        results[node.op_id] = hit
                        self._bump("node_reuses")
                        continue
                args = [results[c] for c in node.children]
                # per-node wall time: only traced runs synchronize (so
                # span times mean device work, not launch time)
                with span("node", op=node.label(), kind=node.kind):
                    out = self._eval(plan, node, args)
                    if traced:
                        _sync(out)
                results[node.op_id] = out
                self._bump("node_evals")
                if self.node_cache is not None:
                    self.node_cache.put(plan, node, out)
        return results[plan.root]

    def _eval(self, plan: P.PhysicalPlan, node: P.PhysicalNode,
              args: List[Result]) -> Result:
        bs = plan.block_size
        k = node.kind
        if k == P.LEAF:
            return leaf_value(node.expr, self.env, bs, self.device)
        if k == P.TRANSPOSE:
            return BlockMatrix.from_dense(as_matrix(args[0]).value.T, bs)
        if k == P.MATSCALAR:
            e: MatScalar = node.expr
            x = as_matrix(args[0]).value
            v = x + e.beta if e.op is EWOp.ADD else x * e.beta
            return BlockMatrix.from_dense(v, bs)
        if k == P.ELEMWISE:
            e: ElemWise = node.expr
            v = ew_values(e.op, as_matrix(args[0]).value,
                          as_matrix(args[1]).value)
            return BlockMatrix.from_dense(v, bs)
        if k == P.MASKED_ELEMWISE:
            return self._masked_elemwise(plan, node, args)
        if k == P.MASKED_AGG:
            return self._masked_agg(plan, node, args)
        if k == P.MATMUL:
            a, b = as_matrix(args[0]).value, as_matrix(args[1]).value
            self._bump("matmuls")
            return BlockMatrix.from_dense(torch.matmul(a, b), bs)
        if k == P.INVERSE:
            return BlockMatrix.from_dense(
                torch.linalg.inv(as_matrix(args[0]).value), bs)
        if k == P.SELECT:
            e: Select = node.expr
            return BlockMatrix.from_dense(
                select_dense(as_matrix(args[0]).value, e.pred), bs)
        if k == P.AGG:
            e: Agg = node.expr
            return BlockMatrix.from_dense(
                agg_dense(as_matrix(args[0]).value, e.fn, e.dim), bs)
        if k == P.JOIN:
            return self._join(plan, node, args)
        raise TypeError(k)

    def _masked_elemwise(self, plan: P.PhysicalPlan, node: P.PhysicalNode,
                         args: List[Result]) -> BlockMatrix:
        e: ElemWise = node.expr
        flip = node.meta["flip"]
        sp = as_matrix(args[0])
        w, h = as_matrix(args[1]), as_matrix(args[2])
        from repro_torch.kernels import registry
        prod = registry.dispatch(
            "masked_matmul", w.value, h.value, sp.block_mask,
            backend=node.backend, block_size=plan.block_size)
        self._bump("masked_matmuls")
        if e.op is EWOp.MUL:
            v = sp.value * prod
        else:
            num, den = (prod, sp.value) if flip else (sp.value, prod)
            v = torch.where((num == 0) | (den == 0), 0.0,
                            num / torch.where(den == 0, 1.0, den))
        return BlockMatrix(v, sp.block_mask, plan.block_size)

    def _masked_agg(self, plan: P.PhysicalPlan, node: P.PhysicalNode,
                    args: List[Result]) -> BlockMatrix:
        """Fused Σ(sp ∘ (W×H)): the m×n masked product never exists."""
        e: Agg = node.expr
        sp = as_matrix(args[0])
        w, h = as_matrix(args[1]), as_matrix(args[2])
        from repro_torch.kernels import registry
        v = registry.dispatch(
            "sddmm_agg", sp.value, w.value, h.value, sp.block_mask,
            backend=node.backend, dim=_AGG_DIM[e.dim],
            block_size=plan.block_size)
        self._bump("masked_aggs")
        return BlockMatrix.from_dense(v, plan.block_size)

    def _join(self, plan: P.PhysicalPlan, node: P.PhysicalNode,
              args: List[Result]) -> Result:
        e: Join = node.expr
        a, b = as_matrix(args[0]), as_matrix(args[1])
        self._bump("joins")
        if plan.mode == "dense":
            out = joinsmod.join_dense(a.value, b.value, e.pred, e.merge)
            return dense_join_result(out, plan.block_size)
        # node.strategy overrides use_bloom inside v2v_sparse; other join
        # kinds ignore both
        return joinsmod.join_sparse(
            a, b, e.pred, e.merge,
            kernel_backend=node.backend, strategy=node.strategy)

    # -- staged dense path ----------------------------------------------------
    def _run_staged(self, plan: P.PhysicalPlan, mesh=None) -> Result:
        spmd = mesh is not None
        staged = plan._staged_spmd_fn if spmd else plan._staged_fn
        if staged is None:
            with span("stage_compile", mode="dense", spmd=spmd):
                faults.check("stage_compile", mode="dense", spmd=spmd)
                t0 = time.perf_counter()
                staged = _stage_spmd(plan, mesh) if spmd \
                    else _stage(plan, self.device)
                self.timings["compile_s"] += time.perf_counter() - t0
            if spmd:
                plan._staged_spmd_fn = staged
            else:
                plan._staged_fn = staged
        fn, leaf_names = staged[:2]
        leaf_vals = self._leaf_vals(leaf_names)
        self._bump("staged_spmd" if spmd else "staged")
        self._bump("node_evals", plan.n_nodes)
        out = self._call_staged(fn, leaf_vals, "spmd" if spmd else "plain",
                                mesh)
        if spmd:
            out = self._spmd_result(out)
        return dense_join_result(out, plan.block_size)

    def _leaf_vals(self, leaf_names):
        for name in leaf_names:
            if name not in self.env:
                raise KeyError(f"unbound matrix {name!r}")
        return tuple(self.env[name].value for name in leaf_names)

    def _call_staged(self, fn, leaf_vals, key: str, mesh=None):
        """Run one staged call, timing it into ``execute_s``. Traced runs
        synchronize (every card of ``mesh`` too) so span times mean
        finished device work."""
        traced = TRACER.active()
        with span("execute", path=f"staged-{key}"):
            t0 = time.perf_counter()
            out = fn(*leaf_vals)
            if traced:
                _sync(out[0] if isinstance(out, tuple) else out, mesh)
            self.timings["execute_s"] += time.perf_counter() - t0
        return out

    def _spmd_result(self, out):
        """Unpack an SPMD call's ``(value, info)`` into the stats. The
        value leaves the mesh on worker 0's device and is handed back on
        the executor's (a copy only where the two differ)."""
        value, info = out
        self._bump("collective_bytes", info["bytes"])
        self._bump("spmd_sharded_nodes", info["sharded"])
        self._bump("spmd_gathered_nodes", info["gathered"])
        if isinstance(value, torch.Tensor):
            value = value.to(self.device)
        return value

    # -- staged sparse path ---------------------------------------------------
    def _run_staged_sparse(self, plan: P.PhysicalPlan, mesh=None):
        """Run a sparse-tier plan as one staged function, or return
        ``_FALLBACK`` when the mask pass vetoes staging / buffers overflow."""
        from repro_torch.plan import masks as masksmod
        masksmod.annotate(plan, self.env)
        if not masksmod.stageable(plan):
            self._bump("sparse_fallbacks")
            return _FALLBACK
        spmd = mesh is not None
        # the staged function bakes in the propagated masks and the COO
        # capacities (expansion AND side buffers), which can change under
        # an unchanged expr — key the staged cache on all of them
        caps = tuple((n.op_id, n.meta.get("cap"), n.meta.get("cap_sides"))
                     for n in plan.nodes if n.kind == P.JOIN)
        key = (plan._mask_key, caps,
               mesh if spmd else str(self.device))
        slot = "_staged_sparse_spmd_fn" if spmd else "_staged_sparse_fn"
        cache = getattr(plan, slot)
        if cache is None:
            cache = {}
            setattr(plan, slot, cache)
        entry = cache.get(key)
        if entry is None:
            while len(cache) >= _STAGED_SPARSE_CACHE_LIMIT:
                cache.pop(next(iter(cache)))
            with span("stage_compile", mode="sparse", spmd=spmd):
                faults.check("stage_compile", mode="sparse", spmd=spmd)
                t0 = time.perf_counter()
                entry = _stage_spmd(plan, mesh, sparse=True) if spmd \
                    else _stage_sparse(plan, self.device)
                self.timings["compile_s"] += time.perf_counter() - t0
            cache[key] = entry
        fn, leaf_names, skip_stats = entry
        out = self._call_staged(fn, self._leaf_vals(leaf_names),
                                "sparse-spmd" if spmd else "sparse", mesh)
        if spmd:
            out = self._spmd_result(out)
        root = plan.node(plan.root)
        if isinstance(out, joinsdev.DeviceCOO) and joinsdev.overflowed(out):
            # leaf values drifted under an unchanged block mask: the
            # exact plan-time capacity went stale. Recover on the host
            # oracle now (which counts its own evaluations) and force a
            # re-annotation for the next run.
            plan._mask_key = None
            self._bump("sparse_overflows")
            return _FALLBACK
        self._bump("staged_sparse_spmd" if spmd else "staged_sparse")
        self._bump("node_evals", plan.n_nodes)
        # the staged function computes every DAG node exactly once, so the
        # per-kind compute counters (the CSE evidence) stay meaningful
        self._bump("matmuls", plan.count(P.MATMUL))
        self._bump("masked_matmuls", plan.count(P.MASKED_ELEMWISE))
        self._bump("masked_aggs", plan.count(P.MASKED_AGG))
        self._bump("joins", plan.count(P.JOIN))
        self._bump("blocks_skipped", skip_stats[0])
        self._bump("blocks_total", skip_stats[1])
        if isinstance(out, joinsdev.DeviceCOO):
            return joinsdev.coo_to_host(out, root.shape)
        mask = root.meta.get("mask")
        if mask is not None:
            return BlockMatrix(out, torch.as_tensor(mask, device=out.device),
                               plan.block_size)
        return BlockMatrix.from_dense(out, plan.block_size)


_FALLBACK = object()  # sentinel: staged sparse declined; run the eager oracle


def _sync(x, mesh=None) -> None:
    """Wait for the device work behind ``x`` (traced runs only): on its
    card, and on every card of ``mesh`` when it ran there."""
    v = getattr(x, "value", x)
    devices = set(mesh.devices) if mesh is not None else set()
    if isinstance(v, torch.Tensor):
        devices.add(v.device)
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


# Bounds the per-plan staged-sparse cache: sessions alternating among a
# few leaf bindings stay staged, pathological churn evicts oldest-first.
_STAGED_SPARSE_CACHE_LIMIT = 4


def _leaf_index(plan: P.PhysicalPlan):
    env_leaves = [n for n in plan.nodes
                  if n.kind == P.LEAF and not n.expr.name.startswith("ones(")]
    leaf_names = tuple(n.expr.name for n in env_leaves)
    arg_index = {n.op_id: i for i, n in enumerate(env_leaves)}
    return leaf_names, arg_index


def _stage(plan: P.PhysicalPlan, device):
    """The whole dense DAG as one function of the leaf tensors.

    Synthesized ``ones(...)`` leaves are constants made inside the
    function; only catalog leaves become arguments.
    """
    leaf_names, arg_index = _leaf_index(plan)

    def fn(*leaf_vals):
        vals: Dict[int, torch.Tensor] = {}
        for node in plan.nodes:
            k = node.kind
            e = node.expr
            ch = [vals[c] for c in node.children]
            if k == P.LEAF:
                if node.op_id in arg_index:
                    v = leaf_vals[arg_index[node.op_id]]
                else:
                    v = torch.ones(e.shape, dtype=torch.float32,
                                   device=device)
            elif k == P.TRANSPOSE:
                v = ch[0].T
            elif k == P.MATSCALAR:
                v = ch[0] + e.beta if e.op is EWOp.ADD else ch[0] * e.beta
            elif k == P.ELEMWISE:
                v = ew_values(e.op, ch[0], ch[1])
            elif k == P.MATMUL:
                v = torch.matmul(ch[0], ch[1])
            elif k == P.INVERSE:
                v = torch.linalg.inv(ch[0])
            elif k == P.SELECT:
                v = select_dense(ch[0], e.pred)
            elif k == P.AGG:
                v = agg_dense(ch[0], e.fn, e.dim)
            elif k == P.JOIN:
                v = joinsmod.join_dense(ch[0], ch[1], e.pred, e.merge)
            else:
                raise TypeError(f"node kind {k!r} is not stageable")
            vals[node.op_id] = v
        return vals[plan.root]

    return fn, leaf_names


# ---------------------------------------------------------------------------
# The sparse tier's per-node work, shared by the single-worker and the
# SPMD stage (which calls it once a worker on that worker's shards).
# ---------------------------------------------------------------------------

def _skip_stats(plan: P.PhysicalPlan):
    """Static block-gating totals (masks are plan-time data)."""
    from repro_torch.core.predicates import JoinKind
    skipped = total = 0
    for n in plan.nodes:
        gated = (n.kind == P.MASKED_ELEMWISE
                 and not n.meta.get("demote_dense")) \
            or (n.kind == P.JOIN and n.expr.pred.kind in
                (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY))
        if gated and n.meta.get("mask") is not None:
            skipped += int(n.meta["mask"].size - n.meta["mask"].sum())
            total += int(n.meta["mask"].size)
        if n.kind == P.MASKED_AGG and not n.meta.get("demote_dense"):
            # the fused kernel's gate is the sparse child's mask (the
            # node's own mask is the tiny aggregation output)
            g = plan.node(n.children[0]).meta.get("mask")
            if g is not None:
                skipped += int(g.size - g.sum())
                total += int(g.size)
    return skipped, total


def _dev_mask(m: np.ndarray, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(m), device=device)


def _overlay_path(out_mask: np.ndarray) -> str:
    """All live: the merge itself; mostly live (> 0.5): one block-masked
    kernel (the host tier's adaptive cutover); else the live blocks
    gathered, merged and scattered back. Decided on the whole output."""
    if out_mask.all():
        return "merge"
    return "kernel" if out_mask.mean() > 0.5 else "blocks"


def _overlay_value(node, av, bval, out_mask, ma, mb, path: str, bs: int):
    """One overlay of ``av`` and ``bval`` (B already transposed) under
    its block masks, by ``path`` (``_overlay_path``)."""
    from repro_torch.core.matrix import blocks_of, unblock
    from repro_torch.core.sparsity import analyze_merge
    from repro_torch.kernels import registry
    from repro_torch.kernels.merge_join import mode_for
    e: Join = node.expr
    if path == "merge":
        return e.merge.fn(av, bval)
    m, n = av.shape
    dt = torch.promote_types(av.dtype, bval.dtype)
    if m == 0 or n == 0:
        return torch.zeros((m, n), dtype=dt, device=av.device)
    if path == "kernel":
        prof = analyze_merge(e.merge)
        return registry.dispatch(
            "merge_join", av, bval, _dev_mask(ma, av.device),
            _dev_mask(mb, av.device), backend=node.backend,
            merge=e.merge.fn,
            mode=mode_for(prof.inducing_x, prof.inducing_y), block_size=bs)
    # gather the live blocks (static indices — skipped blocks are never
    # read), merge the stacked tiles, scatter back. The output carries
    # the promoted input dtype so mask density never changes the result
    # dtype vs. the all-live / host paths.
    ib, jb = np.nonzero(out_mask)
    if ib.size == 0:
        return torch.zeros((m, n), dtype=dt, device=av.device)
    ibt = torch.as_tensor(ib, device=av.device)
    jbt = torch.as_tensor(jb, device=av.device)
    at = blocks_of(av, bs)
    bt = blocks_of(bval, bs)
    merged = e.merge.fn(at[ibt, jbt], bt[ibt, jbt])
    full = torch.zeros(at.shape, dtype=dt, device=av.device)
    full[ibt, jbt] = merged.to(dt)
    return unblock(full, m, n)


def _coo_join_value(node, av, bv):
    from repro_torch.core import cost as costmod
    from repro_torch.core.predicates import JoinKind
    from repro_torch.core.sparsity import analyze_merge
    e: Join = node.expr
    prof = analyze_merge(e.merge)
    cap = node.meta["cap"]
    k = e.pred.kind
    ca, cb = node.meta.get("cap_sides", (None, None))
    if k is JoinKind.CROSS:
        return joinsdev.cross_device(av, bv, e.merge.fn, prof, cap,
                                     cap_a=ca, cap_b=cb)
    if k is JoinKind.D2D:
        return joinsdev.d2d_device(av, bv, e.pred.left, e.pred.right,
                                   e.merge.fn, prof, cap,
                                   cap_a=ca, cap_b=cb,
                                   kernel_backend=node.backend)
    if k is JoinKind.V2V:
        return joinsdev.v2v_device(
            av, bv, e.merge.fn, prof, cap, cap_a=ca, cap_b=cb,
            use_bloom=(node.strategy == costmod.BLOOM_SORTMERGE),
            kernel_backend=node.backend)
    if k is JoinKind.D2V:
        return joinsdev.d2v_device(av, bv, e.pred.left, e.merge.fn,
                                   prof, cap, cap_a=ca)
    if k is JoinKind.V2D:
        # the line-matrix side of the mirror is B (child 1)
        return joinsdev.v2d_device(av, bv, e.pred.right, e.merge.fn,
                                   prof, cap, cap_a=cb)
    raise ValueError(k)


def _masked_agg_value(node, sp, w, h, gate, bs: int):
    from repro_torch.kernels import registry
    e: Agg = node.expr
    if node.meta.get("demote_dense"):
        # mostly-live gate: the fused kernel buys nothing over a plain
        # product + reduce
        return agg_dense(sp * torch.matmul(w, h), e.fn, e.dim)
    return registry.dispatch(
        "sddmm_agg", sp, w, h, _dev_mask(gate, sp.device),
        backend=node.backend, dim=_AGG_DIM[e.dim], block_size=bs)


def _masked_value(node, sp, w, h, gate, bs: int):
    from repro_torch.kernels import registry
    e: ElemWise = node.expr
    flip = node.meta["flip"]
    if node.meta.get("demote_dense"):
        prod = torch.matmul(w, h)
    else:
        prod = registry.dispatch(
            "masked_matmul", w, h, _dev_mask(gate, w.device),
            backend=node.backend, block_size=bs)
    if e.op is EWOp.MUL:
        return sp * prod
    num, den = (prod, sp) if flip else (sp, prod)
    return torch.where((num == 0) | (den == 0), 0.0,
                       num / torch.where(den == 0, 1.0, den))


def _stage_sparse(plan: P.PhysicalPlan, device):
    """A sparse-tier DAG as one function of the leaf tensors.

    Identical skeleton to ``_stage``, but sparsity-aware per node: overlay
    joins and masked matmuls are gated by the plan-time propagated block
    masks (static host arrays — dead blocks are never gathered), and
    COO-producing joins run the device tier with their plan-time
    capacities. Returns ``(fn, leaf_names, (blocks_skipped,
    blocks_total))``, the skip counts being the static gating totals.
    """
    from repro_torch.core.predicates import JoinKind

    bs = plan.block_size
    leaf_names, arg_index = _leaf_index(plan)
    skip_stats = _skip_stats(plan)

    def _overlay(node, av, bv):
        transpose = node.expr.pred.kind is JoinKind.TRANSPOSE_OVERLAY
        mb = plan.node(node.children[1]).meta.get("mask")
        return _overlay_value(
            node, av, bv.T if transpose else bv, node.meta["mask"],
            plan.node(node.children[0]).meta.get("mask"),
            None if mb is None else (mb.T if transpose else mb),
            _overlay_path(node.meta["mask"]), bs)

    def fn(*leaf_vals):
        vals: Dict[int, Union[torch.Tensor, joinsdev.DeviceCOO]] = {}
        for node in plan.nodes:
            k = node.kind
            e = node.expr
            ch = [vals[c] for c in node.children]
            if k == P.LEAF:
                if node.op_id in arg_index:
                    v = leaf_vals[arg_index[node.op_id]]
                else:
                    v = torch.ones(e.shape, dtype=torch.float32,
                                   device=device)
            elif k == P.TRANSPOSE:
                v = ch[0].T
            elif k == P.MATSCALAR:
                v = ch[0] + e.beta if e.op is EWOp.ADD else ch[0] * e.beta
            elif k == P.ELEMWISE:
                v = ew_values(e.op, ch[0], ch[1])
            elif k == P.MASKED_ELEMWISE:
                v = _masked_value(node, ch[0], ch[1], ch[2],
                                  node.meta["mask"], bs)
            elif k == P.MASKED_AGG:
                v = _masked_agg_value(
                    node, ch[0], ch[1], ch[2],
                    plan.node(node.children[0]).meta["mask"], bs)
            elif k == P.MATMUL:
                v = torch.matmul(ch[0], ch[1])
            elif k == P.INVERSE:
                v = torch.linalg.inv(ch[0])
            elif k == P.SELECT:
                v = select_dense(ch[0], e.pred)
            elif k == P.AGG:
                v = agg_dense(ch[0], e.fn, e.dim)
            elif k == P.JOIN:
                pk = e.pred.kind
                if pk in (JoinKind.DIRECT_OVERLAY,
                          JoinKind.TRANSPOSE_OVERLAY):
                    v = _overlay(node, ch[0], ch[1])
                else:
                    # COO outputs have no matrix consumers (the builder
                    # un-stages any such plan), so this is the root
                    assert node.op_id == plan.root
                    v = _coo_join_value(node, ch[0], ch[1])
            else:
                raise TypeError(f"node kind {k!r} is not stageable")
            vals[node.op_id] = v
        return vals[plan.root]

    return fn, leaf_names, skip_stats


# ---------------------------------------------------------------------------
# SPMD: the same DAGs over the workers of a mesh.
# ---------------------------------------------------------------------------

def _stage_spmd(plan: P.PhysicalPlan, mesh, sparse: bool = False):
    """The whole DAG over ``mesh``'s workers (``core.spmd``).

    The function returns ``(root value, info)``: the root as the caller
    receives it (the workers' shards assembled, uncounted — a staged
    program's output), and ``info`` with the collective bytes counted in
    the call and the kernel nodes that ran on shards / on gathered
    operands. Dense: returns ``(fn, leaf_names)``; sparse (``sparse``):
    ``(fn, leaf_names, skip_stats)`` as ``_stage_sparse``.
    """
    from repro_torch.core import spmd
    from repro_torch.core.predicates import JoinKind
    from repro_torch.plan.schemes import _size

    bs = plan.block_size
    n = mesh.n
    devices = mesh.devices
    leaf_names, arg_index = _leaf_index(plan)
    overlays = (JoinKind.DIRECT_OVERLAY, JoinKind.TRANSPOSE_OVERLAY)

    def mask_of(op_id):
        return plan.node(op_id).meta.get("mask")

    def factors(sp, w, h):
        """W and H where a worker's sp slice needs them: W's rows of a row
        slice and all of H, or all of W and H's columns of a column slice
        (a replica needs both whole)."""
        if sp.dim == 0:
            return spmd.redistribute(w, 0, sp.bounds), \
                spmd.redistribute(h, None)
        if sp.dim == 1:
            return spmd.redistribute(w, None), \
                spmd.redistribute(h, 1, sp.bounds)
        return spmd.redistribute(w, None), spmd.redistribute(h, None)

    def gated(node, info, ops, one, needs_mask: bool):
        """Run ``one(i, *worker i's operand shards)`` on every worker (on
        its device, where its shards are), or — where the node reads a
        block mask and the split is off the block edges — ``one(None,
        *whole operands)`` once on all-gathered operands, on worker 0's
        device. Returns ``("shards", outputs)`` or ``("full", output)``."""
        if needs_mask and not ops[0].block_aligned(bs):
            full = [spmd.redistribute(o, None) for o in ops]
            info["gathered"] += 1
            return "full", one(None, *(o.shards[0] for o in full))
        info["sharded"] += needs_mask
        return "shards", [one(i, *(o.shards[i] for o in ops))
                          for i in range(n)]

    def overlay_sparse(node, info, a, b):
        transpose = node.expr.pred.kind is JoinKind.TRANSPOSE_OVERLAY
        if transpose:
            b = spmd.transpose(b)
        if a.dim is None and b.dim is not None:
            a = spmd.align(a, b)
        else:
            b = spmd.align(b, a)
        out_mask = node.meta["mask"]
        ma = mask_of(node.children[0])
        mb = mask_of(node.children[1])
        mb = None if mb is None else (mb.T if transpose else mb)
        path = _overlay_path(out_mask)

        def one(i, x, y):
            sl = (lambda m_: m_) if i is None else \
                (lambda m_: None if m_ is None
                 else spmd.block_slice(m_, a, i, bs))
            return _overlay_value(node, x, y, sl(out_mask), sl(ma),
                                  sl(mb), path, bs)
        kind, out = gated(node, info, (a, b), one, path != "merge")
        if kind == "full":
            return spmd.split(out, None, devices)
        return spmd.Sharded(out, a.dim, a.bounds, a.shape)

    def masked(node, info, sp, w, h):
        w, h = factors(sp, w, h)
        gate = node.meta["mask"]

        def one(i, s, x, y):
            if s.numel() == 0:
                return s.clone()
            g = gate if i is None else spmd.block_slice(gate, sp, i, bs)
            return _masked_value(node, s, x, y, g, bs)
        kind, out = gated(node, info, (sp, w, h), one,
                          not node.meta.get("demote_dense"))
        if kind == "full":
            return spmd.split(out, None, devices)
        return spmd.Sharded(out, sp.dim, sp.bounds, sp.shape)

    def masked_agg(node, info, sp, w, h):
        w, h = factors(sp, w, h)
        gate = mask_of(node.children[0])

        def one(i, s, x, y):
            if s.numel() == 0:
                return None
            g = gate if i is None else spmd.block_slice(gate, sp, i, bs)
            return _masked_agg_value(node, s, x, y, g, bs)
        kind, out = gated(node, info, (sp, w, h), one,
                          not node.meta.get("demote_dense"))
        if kind == "full":
            return spmd.split(out, None, devices)
        if sp.dim is None:
            return spmd.replicated(out)
        e: Agg = node.expr
        keep = {AggDim.ROW: 0, AggDim.COL: 1}.get(e.dim)
        parts = [p for p in out if p is not None]
        if keep == sp.dim:
            return spmd.reduce(parts, lambda p: torch.cat(p, dim=keep),
                               devices)

        def total(p):
            acc = p[0]
            for x in p[1:]:
                acc = acc + x
            return acc
        return spmd.reduce(parts, total, devices)

    def node_value(node, ch, leaf_vals, info):
        k = node.kind
        e = node.expr
        if k == P.LEAF:
            if node.op_id in arg_index:
                t = leaf_vals[arg_index[node.op_id]]
            else:
                t = torch.ones(e.shape, dtype=torch.float32,
                               device=mesh.device)
            return spmd.place(t, node.scheme, devices)
        if k == P.TRANSPOSE:
            return spmd.transpose(ch[0])
        if k == P.MATSCALAR:
            beta = e.beta
            return ch[0].map((lambda x: x + beta) if e.op is EWOp.ADD
                             else (lambda x: x * beta))
        if k == P.ELEMWISE:
            return spmd.elementwise(lambda x, y: ew_values(e.op, x, y),
                                    ch[0], ch[1])
        if k == P.MASKED_ELEMWISE:
            return masked(node, info, *ch)
        if k == P.MASKED_AGG:
            return masked_agg(node, info, *ch)
        if k == P.MATMUL:
            return spmd.matmul(ch[0], ch[1])
        if k == P.INVERSE:
            return spmd.redistribute(ch[0], None).map(torch.linalg.inv)
        if k == P.SELECT:
            return spmd.select(ch[0], e.pred)
        if k == P.AGG:
            return spmd.agg(ch[0], e.fn, e.dim)
        if k == P.JOIN:
            if not sparse:
                return spmd.join(
                    ch[0], ch[1], e.pred, e.merge,
                    _size(plan.node(node.children[0])),
                    _size(plan.node(node.children[1])))
            if e.pred.kind in overlays:
                return overlay_sparse(node, info, ch[0], ch[1])
            # COO outputs have no matrix consumers (the builder un-stages
            # any such plan), so this is the root: one device-tier join on
            # the whole operands, gathered to worker 0's device
            assert node.op_id == plan.root
            return _coo_join_value(node, spmd.gather(ch[0]),
                                   spmd.gather(ch[1]))
        raise TypeError(f"node kind {k!r} is not stageable")

    def fn(*leaf_vals):
        info = {"sharded": 0, "gathered": 0, "bytes": 0}
        vals: Dict[int, object] = {}
        taken: Dict[tuple, spmd.Sharded] = {}

        def take(cid, scheme):
            # one reshard per child and consumed scheme: a shared node is
            # moved once per distinct consumer layout, as the pass prices
            if (cid, scheme) not in taken:
                taken[(cid, scheme)] = spmd.consume(vals[cid], scheme)
            return taken[(cid, scheme)]

        with spmd.recording() as rec:
            for node in plan.nodes:
                ch = [take(c, s)
                      for c, s in zip(node.children, node.in_schemes)]
                v = node_value(node, ch, leaf_vals, info)
                if isinstance(v, spmd.Sharded) and v.ndim == 2 \
                        and node.scheme is not None:
                    # leave the output in the node's scheme
                    v = spmd.consume(v, node.scheme)
                vals[node.op_id] = v
        info["bytes"] = rec.total
        root = vals[plan.root]
        if isinstance(root, spmd.Sharded):
            root = spmd.assemble(root)
        return root, info

    if sparse:
        return fn, leaf_names, _skip_stats(plan)
    return fn, leaf_names


def execute_plan(plan: P.PhysicalPlan, env: Dict[str, BlockMatrix],
                 stage_jit: bool = True, mesh=None) -> Result:
    return PlanExecutor(env, stage_jit=stage_jit, mesh=mesh).run(plan)


def staged_collective_bytes(plan: P.PhysicalPlan,
                            env: Dict[str, BlockMatrix],
                            mesh) -> Optional[int]:
    """Network-wide collective bytes of the whole-plan SPMD function,
    counted as it runs once on ``env``, for validating the scheme pass's
    ``total_comm_est`` (same unit: entries moved × dtype bytes). ``None``
    when there is no mesh or the plan cannot stage (non-jit-safe or
    sparse tier), as in the JAX package."""
    if mesh is None or plan.mode != "dense" or not plan.jit_safe:
        return None
    from repro_torch.core.partitioner import measured_network_bytes
    if plan._staged_spmd_fn is None:
        plan._staged_spmd_fn = _stage_spmd(plan, mesh)
    fn, leaf_names = plan._staged_spmd_fn
    leaf_vals = tuple(env[name].value for name in leaf_names)
    return measured_network_bytes(fn, *leaf_vals, n_workers=mesh.n)
