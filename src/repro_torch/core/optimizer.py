"""Plan optimizer: memoized cost-based rule search + the greedy oracle.

Two search modes share one rule set (``core.rules``):

``search="memo"`` (default) — a Cascades-lite memo search. Expressions are
hash-consed into groups by ``expr_key``; every rule acts as an *alternative
generator* (``rules.iter_alternatives``) whose candidates are costed by
actually lowering them through the physical layer — builder strategy
selection, partition-scheme DP, mask-propagated nnz bounds — via
``core.cost.physical_cost``. Each group keeps its cheapest member, so a
pushdown that destroys a sparsity mask or forces an extra reshard loses to
the alternative *per-subtree* rather than all-or-nothing. The greedy
result and the unrewritten input are seeded as root candidates, so the
memo answer is never costlier than either.

``search="greedy"`` — the original pipeline, kept as the oracle the memo
search is property-tested against:
  1. normalize        — structural cleanups (double transpose, scalar folds)
  2. pushdown fixpoint— apply ALL_RULES bottom-up until no rule fires
  3. chain reorder    — DP over matrix-multiplication chains using dims and
                        sparsity estimates ("matrix order" opt in Fig. 8b)
  4. cost gate        — keep the rewritten plan only if its estimated flop
                        cost does not regress; note this gate is
                        all-or-nothing (a beneficial prefix of rewrites is
                        discarded whenever one later rule regresses) — the
                        memo search subsumes the fix
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core import cost as costmod
from repro_torch.core import rules as rulesmod
from repro_torch.core.expr import (
    Expr, MatMul, expr_key, signature, transform_bottom_up,
)
from repro_torch.core.rules import ALL_RULES

# Cap on physical-cost lowerings per optimize() call: bounds the memo
# search on adversarial rule orbits (e.g. long reassociation chains).
DEFAULT_BUDGET = 256

# Rejected-alternative records kept on the result for EXPLAIN.
TOP_K_ALTERNATIVES = 8


@dataclasses.dataclass(frozen=True)
class Alternative:
    """A rejected candidate rewrite (of any memo group, i.e. possibly a
    subtree): the rules that produced it, its physical cost, the candidate
    itself, and ``delta`` — how much costlier it is than the group member
    the search chose (the regression the search avoided)."""

    rules: Tuple[str, ...]
    cost: costmod.PhysicalCost
    plan: Expr
    delta: float

    def describe(self) -> str:
        via = "+".join(self.rules) if self.rules else "(unrewritten)"
        return (f"Δ+{self.delta:.4g} cost={self.cost.total:.4g}"
                f" (flops/comm/nnz {self.cost.breakdown()})"
                f" via {via}: {signature(self.plan)}")


@dataclasses.dataclass
class OptimizeResult:
    plan: Expr
    original_cost: float
    optimized_cost: float
    iterations: int
    fired: List[str]
    search: str = "greedy"
    physical: Optional[costmod.PhysicalCost] = None           # chosen plan
    physical_original: Optional[costmod.PhysicalCost] = None
    alternatives: List[Alternative] = dataclasses.field(default_factory=list)

    @property
    def speedup_estimate(self) -> float:
        return self.original_cost / max(self.optimized_cost, 1e-12)

    def describe(self, original: Expr) -> str:
        """Logical EXPLAIN text: original vs. rewritten plan with costs."""
        out = (f"== original (cost {self.original_cost:.4g}) ==\n"
               f"{original.pretty()}\n"
               f"== optimized (cost {self.optimized_cost:.4g}, "
               f"est speedup {self.speedup_estimate:.2f}x, "
               f"search={self.search}) ==\n"
               f"{self.plan.pretty()}\n"
               f"fired: {', '.join(self.fired) or '(none)'}")
        if self.alternatives:
            out += "\nrejected alternatives:"
            for alt in self.alternatives:
                out += f"\n  {alt.describe()}"
        return out


def _apply_rules_once(e: Expr, fired: List[str]) -> Expr:
    def visit(node: Expr) -> Optional[Expr]:
        for rule in ALL_RULES:
            out = rule(node)
            if out is not None:
                fired.append(rule.__name__)
                return out
        return None

    return transform_bottom_up(e, visit)


# ---------------------------------------------------------------------------
# Matrix-chain multiplication reordering (classic DP, sparsity-aware flops).
# ---------------------------------------------------------------------------

def _collect_chain(e: Expr) -> List[Expr]:
    if isinstance(e, MatMul):
        return _collect_chain(e.a) + _collect_chain(e.b)
    return [e]


def _chain_dp(terms: List[Expr]) -> Expr:
    n = len(terms)
    if n == 1:
        return terms[0]
    best_cost = [[0.0] * n for _ in range(n)]
    best_plan: List[List[Optional[Expr]]] = \
        [[None] * n for _ in range(n)]
    for i, t in enumerate(terms):
        best_plan[i][i] = t
    for span in range(2, n + 1):
        for i in range(0, n - span + 1):
            j = i + span - 1
            best = None
            for k in range(i, j):
                left, right = best_plan[i][k], best_plan[k + 1][j]
                node = MatMul(left, right)
                c = (best_cost[i][k] + best_cost[k + 1][j]
                     + costmod.node_flops(node))
                if best is None or c < best[0]:
                    best = (c, node)
            best_cost[i][j], best_plan[i][j] = best
    return best_plan[0][n - 1]


def reorder_chains(e: Expr) -> Expr:
    def visit(node: Expr) -> Optional[Expr]:
        if isinstance(node, MatMul):
            terms = _collect_chain(node)
            if len(terms) > 2:
                return _chain_dp(terms)
        return None

    return transform_bottom_up(e, visit)


def _gen_chain_reorder(e: Expr):
    """Generator wrapper over the chain DP: one candidate, the DP's pick.

    The reassociation generator explores orders step by step; this jumps
    straight to the DP optimum so long chains converge within budget.
    """
    if isinstance(e, MatMul) and len(_collect_chain(e)) > 2:
        out = _chain_dp(_collect_chain(e))
        if out is not e:
            yield "chain_reorder_dp", out


# ---------------------------------------------------------------------------
# Memo search (Cascades-lite).
# ---------------------------------------------------------------------------

class _Memo:
    """Memo table: group key → (best member, rules on the chosen path).

    ``cost`` memoizes physical lowerings by group key, and a shared
    ``plan.masks.Leaves`` view (when a session with bound leaves exists)
    lets every candidate lowering reuse the catalog arrays, block masks
    and join-capacity scans fetched by the first one.
    """

    def __init__(self, session, budget: int,
                 enable_chain_reorder: bool = True,
                 enable_pushdown: bool = True,
                 cost_cache: Optional[Dict] = None, leaves=None):
        self.session = session
        self.budget = budget
        # generator configuration for iter_alternatives: pushdowns off →
        # empty rule set; chain reorder off → no reassociation / chain DP
        self.rules = None if enable_pushdown else []
        self.search_only = enable_chain_reorder
        self.extra = ((_gen_chain_reorder,) if enable_chain_reorder
                      else ())
        self.costings = 0
        self.best: Dict[tuple, Tuple[Expr, Tuple[str, ...]]] = {}
        # ``cost_cache`` may be shared across optimize() calls (the serving
        # tier passes one per catalog version): overlapping queries then
        # cost each shared subexpression's candidates once, not once per
        # query. Keys are ``expr_key`` — structural, so only valid while
        # the catalog the costs were measured against is unchanged.
        self._cost: Dict[tuple, costmod.PhysicalCost] = \
            cost_cache if cost_cache is not None else {}
        self.alts: List[Alternative] = []   # rejected members, all groups
        self.leaves = leaves
        if session is not None and leaves is None:
            from repro_torch.plan import masks as masksmod
            self.leaves = masksmod.Leaves(session.env, session.block_size)

    def cost(self, e: Expr) -> costmod.PhysicalCost:
        k = expr_key(e)
        hit = self._cost.get(k)
        if hit is None:
            self.costings += 1
            hit = costmod.physical_cost(e, self.session, leaves=self.leaves)
            self._cost[k] = hit
        return hit

    @property
    def exhausted(self) -> bool:
        return self.costings >= self.budget


def _best_children(e: Expr, memo: _Memo) -> Tuple[Expr, Tuple[str, ...]]:
    """Rebuild ``e`` over the best-known version of each child group."""
    ch = e.children()
    if not ch:
        return e, ()
    fired: List[str] = []
    new = []
    for c in ch:
        bc, fc = _search(c, memo)
        new.append(bc)
        fired.extend(fc)
    if any(n is not o for n, o in zip(new, ch)):
        e = e.with_children(*new)
    return e, tuple(fired)


def _search(e: Expr, memo: _Memo) -> Tuple[Expr, Tuple[str, ...]]:
    """Exploration of the group of expressions equal to ``e``.

    Children are optimized first (their winners are memoized per group),
    then the rule generators expand the root's group to a fixed point
    under the ``seen`` set and the global costing budget (the frontier is
    a depth-first stack; when the budget exhausts mid-group, which
    members got generated depends on generator emission order); the
    cheapest member by physical cost wins and is memoized for every key
    that reached it. Rejected members of every group are recorded (with
    the cost delta the rejection avoided) for EXPLAIN.
    """
    key = expr_key(e)
    hit = memo.best.get(key)
    if hit is not None:
        return hit
    base = _best_children(e, memo)
    members = [base]
    seen = {expr_key(base[0])}
    frontier = [base]
    if key not in seen:
        # child winners are chosen per-group, but costs are not perfectly
        # additive across group boundaries (scheme demands, CSE): keep the
        # unrewritten subtree as a member of its own group so a bad
        # composition of child winners can lose to it locally, not only
        # via the whole-plan root guard
        rec = (e, ())
        members.append(rec)
        seen.add(key)
        frontier.append(rec)
    while frontier and not memo.exhausted:
        x, fx = frontier.pop()
        for name, alt in rulesmod.iter_alternatives(
                x, extra=memo.extra, rules=memo.rules,
                search_only=memo.search_only):
            # a rewrite exposes new subtrees (e.g. a pushdown wraps a
            # child in Select): optimize them through their own groups
            alt, f_ch = _best_children(alt, memo)
            k2 = expr_key(alt)
            if k2 in seen:
                continue
            seen.add(k2)
            rec = (alt, fx + (name,) + f_ch)
            members.append(rec)
            frontier.append(rec)
    winner = min(members, key=lambda m: memo.cost(m[0]).total)
    won = memo.cost(winner[0]).total
    memo.alts.extend(
        Alternative(rules=m[1], cost=memo.cost(m[0]), plan=m[0],
                    delta=memo.cost(m[0]).total - won)
        for m in members if m is not winner)
    memo.best[key] = winner
    memo.best[expr_key(winner[0])] = winner
    return winner


# ---------------------------------------------------------------------------
# Entry points.
# ---------------------------------------------------------------------------

MAX_ITERS = 32


def optimize_greedy(e: Expr, enable_chain_reorder: bool = True,
                    enable_pushdown: bool = True) -> OptimizeResult:
    """The original fixed-point rewriter (the memo search's oracle)."""
    original_cost = costmod.plan_flops(e)
    fired: List[str] = []
    plan = e
    iters = 0
    if enable_pushdown:
        for iters in range(1, MAX_ITERS + 1):
            before = plan
            plan = _apply_rules_once(plan, fired)
            if plan is before:
                break
    if enable_chain_reorder:
        plan = reorder_chains(plan)
        if enable_pushdown:
            # chain reordering may open new pushdown opportunities
            for _ in range(MAX_ITERS):
                before = plan
                plan = _apply_rules_once(plan, fired)
                if plan is before:
                    break
    optimized_cost = costmod.plan_flops(plan)
    if optimized_cost > original_cost:
        # all-or-nothing cost gate: never regress, but also never keep a
        # beneficial prefix (fall back to the input plan wholesale)
        plan, optimized_cost = e, original_cost
    return OptimizeResult(plan, original_cost, optimized_cost, iters, fired,
                          search="greedy")


def optimize_memo(e: Expr, session=None, budget: int = DEFAULT_BUDGET,
                  enable_chain_reorder: bool = True,
                  enable_pushdown: bool = True,
                  cost_cache: Optional[Dict] = None,
                  leaves=None) -> OptimizeResult:
    """Memoized cost-based search (see module docstring).

    ``cost_cache`` / ``leaves`` may be shared across calls over one
    unchanged catalog (the serving tier's cross-query optimizer state):
    physical-cost lowerings and catalog fetches for subexpressions that
    overlap between queries then happen once per catalog version.
    """
    greedy = optimize_greedy(e, enable_chain_reorder, enable_pushdown)
    memo = _Memo(session, budget, enable_chain_reorder, enable_pushdown,
                 cost_cache=cost_cache, leaves=leaves)
    best, fired = _search(e, memo)
    # root guard: the greedy oracle's answer and the unrewritten input are
    # candidates too, so the memo result is never costlier than either.
    # When greedy's gate reverted to the input its fired list describes
    # rewrites that are NOT in its plan — report none for that candidate.
    greedy_fired = tuple(greedy.fired) if greedy.plan is not e else ()
    candidates = [(best, fired), (greedy.plan, greedy_fired), (e, ())]
    plan, chosen_fired = min(candidates,
                             key=lambda m: memo.cost(m[0]).total)
    phys = memo.cost(plan)
    phys_orig = memo.cost(e)
    # rejected alternatives (all groups, i.e. subtrees too), ranked by the
    # regression the search avoided; drop zero-delta ties — they carry no
    # decision information
    alts = sorted((a for a in memo.alts if a.delta > 0),
                  key=lambda a: -a.delta)
    return OptimizeResult(
        plan=plan, original_cost=phys_orig.total, optimized_cost=phys.total,
        iterations=memo.costings, fired=list(chosen_fired), search="memo",
        physical=phys, physical_original=phys_orig,
        alternatives=alts[:TOP_K_ALTERNATIVES])


def optimize(e: Expr, enable_chain_reorder: bool = True,
             enable_pushdown: bool = True, *, search: str = "memo",
             session=None, budget: int = DEFAULT_BUDGET,
             cost_cache: Optional[Dict] = None,
             leaves=None) -> OptimizeResult:
    """Optimize ``e``; ``search`` picks the memo search (default) or the
    greedy oracle. ``session`` makes the memo search cost candidates
    against the session's mode, block size, mesh and bound leaf data;
    ``cost_cache``/``leaves`` optionally share that costing state across
    calls over one catalog version (see ``optimize_memo``)."""
    from repro_torch.obs.trace import TRACER
    if search == "greedy":
        with TRACER.span("optimize", search="greedy"):
            return optimize_greedy(e, enable_chain_reorder, enable_pushdown)
    if search != "memo":
        raise ValueError(f"unknown search {search!r}")
    with TRACER.span("optimize", search="memo"):
        out = optimize_memo(e, session=session, budget=budget,
                            enable_chain_reorder=enable_chain_reorder,
                            enable_pushdown=enable_pushdown,
                            cost_cache=cost_cache, leaves=leaves)
        TRACER.annotate(costings=out.iterations,
                        fired=",".join(out.fired) or "(none)")
        return out
