"""Plan-wide partition-scheme propagation over the physical DAG.

The paper's §4.7 algorithm assigns partitioning schemes to the two inputs
of a *single* join. This pass lifts that to the whole physical plan: every
node of the hash-consed DAG gets one output scheme (Row / Column /
Broadcast) chosen by dynamic programming over the paper's cost tables
(Table 3 conversions + the per-join-family communication costs), so a
node's layout is picked *knowing its consumers* — one operator's output
feeds the next without a reshard whenever the model says that's cheapest.

Two passes:

1. **bottom-up DP** — for each node and each candidate output scheme,
   the minimal cumulative communication (entries moved) to materialize
   the node in that scheme, with backpointers recording which child
   schemes achieved it. Operator algebra:

   * leaves arrive randomly partitioned (ξ) and pay Table-3 conversion;
   * transpose flips Row↔Column for free (a locally transposed
     row-partitioned matrix *is* column-partitioned);
   * elementwise-family ops (matscalar / elemwise / masked_elemwise /
     select) require aligned inputs and preserve the scheme;
   * matmul uses the 1-D algebra: (Row, Broadcast) → Row,
     (Broadcast, Column) → Column, (Broadcast, Broadcast) → Broadcast;
   * inverse gathers (Broadcast in, Broadcast out);
   * aggregation outputs are small — replicated via one output-sized
     collective;
   * joins score (s_A, s_B) with ``core.cost.join_comm_cost`` and derive
     the output scheme from the surviving side (order-3/4 outputs shard
     their leading dimension, the D1-first layout of §5.1).

2. **top-down resolution** — parents demand schemes on their children
   (from the DP backpointers); a node with several parents picks the
   single output scheme minimizing its own cost plus one conversion per
   *distinct* demanded scheme. That is the CSE amortization: a shared
   subexpression is materialized once and resharded at most once per
   distinct consumer layout, not once per consumer.

The pass is pure plan-time analysis (no matrix data is touched); the SPMD
staged executor realizes the chosen schemes as ``with_sharding_constraint``
at node boundaries, and EXPLAIN renders them next to the predicted comm
entries so the model can be validated against HLO-measured collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import cost as costmod
from repro_torch.core.cost import BCAST, COL, RANDOM, ROW, broadcastable
from repro_torch.core.expr import Join
from repro_torch.plan import ops as P

# Candidate output schemes for the DP. ξ only ever appears as the *initial*
# scheme of a leaf (Table 3 has no conversions into it).
DOMAIN = (ROW, COL, BCAST)

# Bytes per matrix entry when converting model entries → wire bytes:
# the catalog is f32 throughout (Session.load casts to float32).
ENTRY_BYTES = 4

_INF = float("inf")


def transpose_scheme(s: str) -> str:
    """Scheme of Aᵀ given the scheme of A: Row↔Column, Broadcast/ξ fixed.

    This is the algebraic form of the ad-hoc PartitionSpec swap the
    per-call overlay path used to carry: transposing a row-partitioned
    matrix locally yields a column-partitioned one without moving data.
    """
    return {ROW: COL, COL: ROW}.get(s, s)


@dataclasses.dataclass
class NodeScheme:
    """Resolved scheme assignment for one physical node."""

    scheme: str                      # output scheme (r / c / b)
    in_schemes: Tuple[str, ...]      # scheme each child is consumed in
    comm_entries: float              # predicted entries moved at this node
    demanded: Tuple[str, ...] = ()   # distinct schemes parents consume


@dataclasses.dataclass
class SchemeAssignment:
    """Whole-plan result: one ``NodeScheme`` per op id + the total."""

    nodes: Dict[int, NodeScheme]
    total_comm: float

    def scheme_of(self, op_id: int) -> str:
        return self.nodes[op_id].scheme


def _size(node: P.PhysicalNode) -> float:
    """|A| in the paper's convention: nnz estimate for sparse, m·n dense."""
    n = 1.0
    for d in node.shape:
        n *= d
    if node.sparsity < 1.0:
        return n * node.sparsity
    return n


def _feasible(node: P.PhysicalNode, s: str) -> bool:
    return s != BCAST or broadcastable(_size(node))


def _conv(node: P.PhysicalNode, s_from: str, s_to: str, n: int) -> float:
    return costmod.conversion_cost(_size(node), s_from, s_to, n)


# ---------------------------------------------------------------------------
# Pass 1: bottom-up DP tables.
# ---------------------------------------------------------------------------

def _node_table(node: P.PhysicalNode, plan: P.PhysicalPlan,
                tables: Dict[int, Dict[str, Tuple[float, Tuple[str, ...]]]],
                n: int) -> Dict[str, Tuple[float, Tuple[str, ...]]]:
    """DP table for one node: scheme → (min cost, child in-schemes)."""
    out = _node_table_rules(node, plan, tables, n)
    if not out:
        # degenerate: every child is only realizable in schemes infeasible
        # for this node (e.g. a forced-Broadcast inverse output feeding an
        # over-the-limit elemwise). Row is always realizable — consume
        # every child in Row via its cheapest scheme + Table-3 conversion.
        ch = [plan.node(c) for c in node.children]
        tot, ins = 0.0, []
        for i, t in enumerate([tables[c] for c in node.children]):
            tot += min(c + _conv(ch[i], have, ROW, n)
                       for have, (c, _) in t.items())
            ins.append(ROW)
        out[ROW] = (tot, tuple(ins))
    return out


def _node_table_rules(
        node: P.PhysicalNode, plan: P.PhysicalPlan,
        tables: Dict[int, Dict[str, Tuple[float, Tuple[str, ...]]]],
        n: int) -> Dict[str, Tuple[float, Tuple[str, ...]]]:
    k = node.kind
    ch = [plan.node(c) for c in node.children]
    ct = [tables[c] for c in node.children]
    out: Dict[str, Tuple[float, Tuple[str, ...]]] = {}

    def consider(s_out: str, cost: float, ins: Tuple[str, ...]) -> None:
        if not _feasible(node, s_out):
            return
        if s_out not in out or cost < out[s_out][0]:
            out[s_out] = (cost, ins)

    if k == P.LEAF:
        for s in DOMAIN:
            consider(s, _conv(node, RANDOM, s, n), ())
        return out

    if k == P.TRANSPOSE:
        for s_in, (c, _) in ct[0].items():
            consider(transpose_scheme(s_in), c, (s_in,))
        return out

    if k in (P.MATSCALAR, P.SELECT):
        for s_in, (c, _) in ct[0].items():
            consider(s_in, c, (s_in,))
        return out

    if k in (P.ELEMWISE, P.MASKED_ELEMWISE):
        # aligned inputs, scheme-preserving (masked_elemwise consumes the
        # sparse gate plus both matmul factors; factors are small — align
        # them with the gate's scheme via their own conversion tables)
        for s in DOMAIN:
            tot, ins = 0.0, []
            for t in ct:
                if s not in t:
                    tot = _INF
                    break
                tot += t[s][0]
                ins.append(s)
            if tot < _INF:
                consider(s, tot, tuple(ins))
        return out

    if k == P.MATMUL:
        # 1-D matmul algebra; a side too large for the BROADCAST_LIMIT
        # guard is still gatherable — charge the honest all-gather cost
        def cost_in(i: int, s: str) -> float:
            t = ct[i]
            if s in t:
                return t[s][0]
            return min(c + _conv(ch[i], have, s, n)
                       for have, (c, _) in t.items())

        for (sa, sb, s_out) in ((ROW, BCAST, ROW), (BCAST, COL, COL),
                                (BCAST, BCAST, BCAST)):
            consider(s_out, cost_in(0, sa) + cost_in(1, sb), (sa, sb))
        return out

    if k == P.INVERSE:
        if BCAST in ct[0]:
            consider(BCAST, ct[0][BCAST][0], (BCAST,))
        if not out:  # too large to broadcast: gather anyway (model as ξ→b)
            s_in, (c, _) = min(ct[0].items(), key=lambda kv: kv[1][0])
            out[BCAST] = (c + (n - 1) * _size(ch[0]), (s_in,))
        return out

    if k == P.AGG:
        # the reduction over the sharded dim is one output-sized collective;
        # aggregation outputs (vectors / scalars) are replicated
        for s_in, (c, _) in ct[0].items():
            extra = 0.0 if s_in == BCAST else _size(node)
            consider(BCAST, c + extra, (s_in,))
        return out

    if k == P.MASKED_AGG:
        # fused SDDMM+reduction: inputs align on one scheme (like
        # MASKED_ELEMWISE) and the sharded-dim reduction is one
        # output-sized collective (like AGG); the output replicates
        for s in DOMAIN:
            tot, ins = 0.0, []
            for t in ct:
                if s not in t:
                    tot = _INF
                    break
                tot += t[s][0]
                ins.append(s)
            if tot < _INF:
                extra = 0.0 if s == BCAST else _size(node)
                consider(BCAST, tot + extra, tuple(ins))
        return out

    if k == P.JOIN:
        e: Join = node.expr
        for sa in ct[0]:
            for sb in ct[1]:
                cc = costmod.join_comm_cost(
                    e.pred, sa, sb, _size(ch[0]), _size(ch[1]), n)
                consider(_join_out_scheme(sa, sb, len(node.shape)),
                         ct[0][sa][0] + ct[1][sb][0] + cc, (sa, sb))
        return out

    raise TypeError(f"no scheme rule for node kind {k!r}")


def _join_out_scheme(sa: str, sb: str, out_ndim: int = 2) -> str:
    """Output scheme of a join under input schemes (sa, sb).

    Overlays keep the layout of the non-broadcast side (the paper
    repartitions the smaller input with the larger one's scheme); joins
    producing order-3/4 tensors shard the leading dimension, which the
    executor realizes as Row over dim 0 (§5.1 D1-first layout) — Column
    does not exist at rank > 2.
    """
    s = sa if sa != BCAST else sb
    if out_ndim != 2 and s == COL:
        return ROW
    return s


# ---------------------------------------------------------------------------
# Pass 2: top-down demand resolution (one scheme per node).
# ---------------------------------------------------------------------------

def propagate(plan: P.PhysicalPlan,
              n_workers: Optional[int] = None) -> SchemeAssignment:
    """Assign one output scheme to every node of ``plan`` (see module doc)."""
    n = n_workers or plan.n_workers
    assert n > 1, "scheme propagation is defined for multi-worker plans"

    tables: Dict[int, Dict[str, Tuple[float, Tuple[str, ...]]]] = {}
    for node in plan.nodes:
        tables[node.op_id] = _node_table(node, plan, tables, n)

    # demands[child] = list of schemes in which parents consume it
    demands: Dict[int, List[str]] = {i: [] for i in range(plan.n_nodes)}
    resolved: Dict[int, NodeScheme] = {}
    total = 0.0

    for node in reversed(plan.nodes):
        table = tables[node.op_id]
        distinct = tuple(sorted(set(demands[node.op_id])))
        # cheapest scheme given the consumers (the root serves the caller)
        scheme = min(
            table,
            key=lambda s: table[s][0] + sum(
                _conv(node, s, d, n) for d in distinct if d != s))
        cost, ins = table[scheme]
        # one conversion per *distinct* demanded scheme — shared (CSE)
        # nodes reshard once per consumer layout, not once per consumer
        reshard = sum(_conv(node, scheme, d, n)
                      for d in distinct if d != scheme)
        own = _own_comm(node, plan, ins, n)
        resolved[node.op_id] = NodeScheme(
            scheme=scheme, in_schemes=ins,
            comm_entries=own + reshard, demanded=distinct)
        total += own + reshard
        for cid, s_in in zip(node.children, ins):
            demands[cid].append(s_in)

    # Leaf ξ→scheme conversions guide the DP (they are the paper's Table-3
    # placement cost) but are NOT in comm_entries/total: in the staged
    # GSPMD program leaves enter at the jit call boundary as host→device
    # placement, not as in-program collectives, so the totals here stay
    # directly comparable to HLO-measured collective traffic.
    return SchemeAssignment(nodes=resolved, total_comm=total)


def _own_comm(node: P.PhysicalNode, plan: P.PhysicalPlan,
              ins: Tuple[str, ...], n: int) -> float:
    """Entries this operator itself moves under its chosen input schemes
    (join communication / aggregation reduction), excluding conversions —
    those are charged at the producing child."""
    if node.kind == P.JOIN:
        e: Join = node.expr
        ch = [plan.node(c) for c in node.children]
        return costmod.join_comm_cost(
            e.pred, ins[0], ins[1], _size(ch[0]), _size(ch[1]), n)
    if node.kind in (P.AGG, P.MASKED_AGG) and ins and ins[0] != BCAST:
        return _size(node)
    if node.kind == P.INVERSE and ins and ins[0] != BCAST:
        return (n - 1) * _size(plan.node(node.children[0]))
    return 0.0


def annotate(plan: P.PhysicalPlan) -> SchemeAssignment:
    """Run the propagation and write the results onto the plan's nodes
    (``scheme`` / ``in_schemes`` / ``comm_est``). Called by the builder
    for multi-worker plans; idempotent — the DP depends only on the
    immutable node structure and worker count, so the assignment is
    computed once per plan and cached (repeated EXPLAIN / cost-only
    lowerings skip the DP)."""
    from repro_torch.obs.trace import span
    if plan._scheme_assignment is not None:
        return plan._scheme_assignment
    with span("schemes_dp", nodes=plan.n_nodes, workers=plan.n_workers):
        assignment = propagate(plan)
    for node in plan.nodes:
        ns = assignment.nodes[node.op_id]
        node.scheme = ns.scheme
        node.in_schemes = ns.in_schemes
        node.comm_est = ns.comm_entries
    plan.total_comm_est = assignment.total_comm
    plan._scheme_assignment = assignment
    return assignment
