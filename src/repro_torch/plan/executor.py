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
package. Multi-worker (SPMD) staging waits for its slice.
"""
from __future__ import annotations

import time
from typing import Dict, List, Union

import numpy as np
import torch

from repro_torch.obs.trace import TRACER, span

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
    of the catalog's tensors).
    """

    def __init__(self, env: Dict[str, BlockMatrix], device=None):
        self.env = env
        self.device = env_device(env) if device is None \
            else torch.device(device)
        self.stats: Dict[str, int] = {
            "node_evals": 0, "matmuls": 0,
            "masked_matmuls": 0, "masked_aggs": 0, "joins": 0,
            "staged": 0, "staged_sparse": 0, "sparse_fallbacks": 0,
            "sparse_overflows": 0, "blocks_skipped": 0, "blocks_total": 0,
        }
        # wall-clock split of the most recent ``run``: building the staged
        # function vs running it
        self.timings: Dict[str, float] = {"compile_s": 0.0, "execute_s": 0.0}

    def _bump(self, name: str, n: int = 1) -> None:
        self.stats[name] += n

    # -- public ---------------------------------------------------------------
    def run(self, plan: P.PhysicalPlan) -> Result:
        if plan.n_workers > 1:
            raise NotImplementedError(
                "multi-worker plans wait for the multi-worker slice")
        if plan.jit_safe:
            if plan.mode == "dense":
                return self._run_staged(plan)
            out = self._run_staged_sparse(plan)
            if out is not _FALLBACK:
                return out
        return self._run_eager(plan)

    # -- eager path -----------------------------------------------------------
    def _run_eager(self, plan: P.PhysicalPlan) -> Result:
        traced = TRACER.active()
        results: Dict[int, Result] = {}
        with span("execute", path="eager", nodes=plan.n_nodes):
            for node in plan.nodes:
                args = [results[c] for c in node.children]
                # per-node wall time: only traced runs synchronize (so
                # span times mean device work, not launch time)
                with span("node", op=node.label(), kind=node.kind):
                    out = self._eval(plan, node, args)
                    if traced:
                        _sync(out)
                results[node.op_id] = out
                self._bump("node_evals")
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
    def _run_staged(self, plan: P.PhysicalPlan) -> Result:
        staged = plan._staged_fn
        if staged is None:
            with span("stage_compile", mode="dense"):
                t0 = time.perf_counter()
                staged = _stage(plan, self.device)
                self.timings["compile_s"] += time.perf_counter() - t0
            plan._staged_fn = staged
        fn, leaf_names = staged
        leaf_vals = self._leaf_vals(leaf_names)
        self._bump("staged")
        self._bump("node_evals", plan.n_nodes)
        out = self._call_staged(fn, leaf_vals, "plain")
        return dense_join_result(out, plan.block_size)

    def _leaf_vals(self, leaf_names):
        for name in leaf_names:
            if name not in self.env:
                raise KeyError(f"unbound matrix {name!r}")
        return tuple(self.env[name].value for name in leaf_names)

    def _call_staged(self, fn, leaf_vals, key: str):
        """Run one staged call, timing it into ``execute_s``. Traced runs
        synchronize so span times mean finished device work."""
        traced = TRACER.active()
        with span("execute", path=f"staged-{key}"):
            t0 = time.perf_counter()
            out = fn(*leaf_vals)
            if traced:
                _sync(out)
            self.timings["execute_s"] += time.perf_counter() - t0
        return out

    # -- staged sparse path ---------------------------------------------------
    def _run_staged_sparse(self, plan: P.PhysicalPlan):
        """Run a sparse-tier plan as one staged function, or return
        ``_FALLBACK`` when the mask pass vetoes staging / buffers overflow."""
        from repro_torch.plan import masks as masksmod
        masksmod.annotate(plan, self.env)
        if not masksmod.stageable(plan):
            self._bump("sparse_fallbacks")
            return _FALLBACK
        # the staged function bakes in the propagated masks and the COO
        # capacities (expansion AND side buffers), which can change under
        # an unchanged expr — key the staged cache on all of them
        caps = tuple((n.op_id, n.meta.get("cap"), n.meta.get("cap_sides"))
                     for n in plan.nodes if n.kind == P.JOIN)
        key = (plan._mask_key, caps, str(self.device))
        cache = plan._staged_sparse_fn
        if cache is None:
            cache = plan._staged_sparse_fn = {}
        entry = cache.get(key)
        if entry is None:
            while len(cache) >= _STAGED_SPARSE_CACHE_LIMIT:
                cache.pop(next(iter(cache)))
            with span("stage_compile", mode="sparse"):
                t0 = time.perf_counter()
                entry = _stage_sparse(plan, self.device)
                self.timings["compile_s"] += time.perf_counter() - t0
            cache[key] = entry
        fn, leaf_names, skip_stats = entry
        out = self._call_staged(fn, self._leaf_vals(leaf_names), "sparse")
        root = plan.node(plan.root)
        if isinstance(out, joinsdev.DeviceCOO) and joinsdev.overflowed(out):
            # leaf values drifted under an unchanged block mask: the
            # exact plan-time capacity went stale. Recover on the host
            # oracle now (which counts its own evaluations) and force a
            # re-annotation for the next run.
            plan._mask_key = None
            self._bump("sparse_overflows")
            return _FALLBACK
        self._bump("staged_sparse")
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


def _sync(x) -> None:
    """Wait for the device work behind ``x`` (traced runs only)."""
    v = getattr(x, "value", x)
    if isinstance(v, torch.Tensor) and v.device.type == "cuda":
        torch.cuda.synchronize(v.device)


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


def _stage_sparse(plan: P.PhysicalPlan, device):
    """A sparse-tier DAG as one function of the leaf tensors.

    Identical skeleton to ``_stage``, but sparsity-aware per node: overlay
    joins and masked matmuls are gated by the plan-time propagated block
    masks (static host arrays — dead blocks are never gathered), and
    COO-producing joins run the device tier with their plan-time
    capacities. Returns ``(fn, leaf_names, (blocks_skipped,
    blocks_total))``, the skip counts being the static gating totals.
    """
    from repro_torch.core.sparsity import analyze_merge
    from repro_torch.kernels import registry
    from repro_torch.kernels.merge_join import mode_for
    from repro_torch.core import cost as costmod
    from repro_torch.core.matrix import blocks_of, unblock
    from repro_torch.core.predicates import JoinKind

    bs = plan.block_size
    leaf_names, arg_index = _leaf_index(plan)

    # static block-gating totals (masks are plan-time data)
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
    skip_stats = (skipped, total)

    def _dev_mask(m: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(m), device=device)

    def _overlay(node, av, bv):
        e: Join = node.expr
        transpose = e.pred.kind is JoinKind.TRANSPOSE_OVERLAY
        bval = bv.T if transpose else bv
        out_mask = node.meta["mask"]
        prof = analyze_merge(e.merge)
        if out_mask.all():
            return e.merge.fn(av, bval)
        if out_mask.mean() > 0.5:
            # mostly-live: one block-masked kernel over the full matrices
            # (mirrors the host tier's adaptive cutover)
            ma = plan.node(node.children[0]).meta["mask"]
            mb = plan.node(node.children[1]).meta["mask"]
            if transpose:
                mb = mb.T
            return registry.dispatch(
                "merge_join", av, bval, _dev_mask(ma), _dev_mask(mb),
                backend=node.backend, merge=e.merge.fn,
                mode=mode_for(prof.inducing_x, prof.inducing_y),
                block_size=bs)
        # sparse: gather the live blocks (static indices — skipped blocks
        # are never read), merge the stacked tiles, scatter back. The
        # output carries the promoted input dtype so mask density never
        # changes the result dtype vs. the all-live / host paths.
        ib, jb = np.nonzero(out_mask)
        m, n = node.shape
        dt = torch.promote_types(av.dtype, bval.dtype)
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

    def _coo_join(node, av, bv):
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

    def _masked_agg(node, sp, w, h):
        e: Agg = node.expr
        if node.meta.get("demote_dense"):
            # mostly-live gate: the fused kernel buys nothing over a
            # plain product + reduce
            return agg_dense(sp * torch.matmul(w, h), e.fn, e.dim)
        gate = _dev_mask(plan.node(node.children[0]).meta["mask"])
        return registry.dispatch(
            "sddmm_agg", sp, w, h, gate, backend=node.backend,
            dim=_AGG_DIM[e.dim], block_size=bs)

    def _masked(node, sp, w, h):
        e: ElemWise = node.expr
        flip = node.meta["flip"]
        if node.meta.get("demote_dense"):
            prod = torch.matmul(w, h)
        else:
            gate = _dev_mask(node.meta["mask"])  # static propagated mask
            prod = registry.dispatch("masked_matmul", w, h, gate,
                                     backend=node.backend, block_size=bs)
        if e.op is EWOp.MUL:
            return sp * prod
        num, den = (prod, sp) if flip else (sp, prod)
        return torch.where((num == 0) | (den == 0), 0.0,
                           num / torch.where(den == 0, 1.0, den))

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
                v = _masked(node, ch[0], ch[1], ch[2])
            elif k == P.MASKED_AGG:
                v = _masked_agg(node, ch[0], ch[1], ch[2])
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
                    v = _coo_join(node, ch[0], ch[1])
            else:
                raise TypeError(f"node kind {k!r} is not stageable")
            vals[node.op_id] = v
        return vals[plan.root]

    return fn, leaf_names, skip_stats

