"""Synthetic multi-tenant serving workloads (bench_serve + launch.serve).

Models the paper's serving premise: many clients issuing queries drawn
from a small set of analytical *templates* over one shared catalog —
gram-matrix pipelines, selections over shared subexpressions, overlay
joins, aggregation reports. Template popularity is zipf-distributed (a
few hot dashboards, a long tail), which is exactly the regime where
cross-query CSE pays: hot templates repeat wholesale (root hits) and even
distinct templates overlap on shared subplans (``XᵀX`` feeds four of
them below).

Everything is seeded and deterministic so benchmark runs and concurrency
tests can compare engine output against serial ``collect()``. The same
seed makes the same catalog and stream as the JAX package's
``serve.workload``; the catalog lives on ``session.device``.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from repro_torch.core.api import Matrix, Session
from repro_torch.core.expr import Expr, MergeFn

# one shared MergeFn instance per merge semantics: join CSE keys include
# callable identity, so templates that share a merge must share the object
MERGE_ADD = MergeFn("add", lambda x, y: x + y)
MERGE_MUL = MergeFn("mul", lambda x, y: x * y)


def synthetic_catalog(session: Session, rng: np.random.Generator,
                      n: int = 48, density: float = 0.25
                      ) -> dict:
    """Load a small shared catalog onto ``session.device``: two sparse
    feature matrices, one dense factor pair (the PNMF-style workload), one
    selection target."""
    def sparse(m, k, d):
        v = rng.normal(size=(m, k)).astype(np.float32)
        keep = rng.uniform(size=(m, k)) < d
        return np.where(keep, v, 0).astype(np.float32)

    mats = {
        "X": session.load(sparse(n, n, density), "X"),
        "Y": session.load(sparse(n, n, density), "Y"),
        "W": session.load(rng.normal(size=(n, n // 4))
                          .astype(np.float32), "W"),
        "H": session.load(rng.normal(size=(n // 4, n))
                          .astype(np.float32), "H"),
    }
    return mats


def query_templates(mats: dict) -> List[Tuple[str, Expr]]:
    """The template set: ``(name, logical plan)`` pairs. Several templates
    share the gram pipeline ``XᵀX`` and the factor product ``W×H`` so the
    serving tier has real inter-query structure to dedupe."""
    X, Y, W, H = mats["X"], mats["Y"], mats["W"], mats["H"]
    gram = X.t().multiply(X)
    wh = W.multiply(H)
    templates: List[Tuple[str, Matrix]] = [
        ("gram", gram),
        ("gram_trace", gram.trace()),
        ("gram_rowsum", gram.sum("r")),
        ("gram_shift", gram.add(1.0)),
        ("sddmm", X.emul(wh)),                  # sparse ∘ (W×H)
        ("factor_residual", X.add(wh.emul(-1.0))),
        ("overlay", X.join(Y, "RID=RID AND CID=CID", MERGE_ADD)),
        ("xy", X.multiply(Y)),
        ("xy_colsum", X.multiply(Y).sum("c")),
        ("y_select", Y.select("VAL>0")),
    ]
    return [(name, m.plan) for name, m in templates]


def client_stream(rng: np.random.Generator,
                  templates: List[Tuple[str, Expr]],
                  n_clients: int = 1000, n_tenants: int = 8,
                  zipf_a: float = 1.4) -> List[Tuple[str, str, Expr]]:
    """One query per client: ``(tenant, template name, plan)``, template
    picked zipf-over-popularity, clients round-robined over tenants."""
    k = len(templates)
    draws = rng.zipf(zipf_a, size=n_clients)
    out = []
    for i, d in enumerate(draws):
        name, expr = templates[min(int(d) - 1, k - 1)]
        out.append((f"tenant{i % n_tenants}", name, expr))
    return out


def run_workload(session: Session,
                 stream: List[Tuple[str, str, Expr]],
                 cse: bool = True, warmup: bool = True,
                 **engine_kw) -> dict:
    """Serve ``stream`` through one engine; returns sustained qps,
    latency percentiles (ms) and the engine stats snapshot.

    ``warmup=True`` first runs each distinct plan in the stream once and
    drains, so the timed phase measures *sustained* serving rather than
    one-time planning and staging — the warmup applies identically to the
    CSE and no-CSE configurations (it warms the optimize, plan and staged
    caches of both; for CSE it additionally seeds the shared result cache,
    which is precisely the steady state being measured).

    Chaos tolerance: under an active fault schedule (``runtime.faults``)
    some tickets legitimately finish with an error — those are *terminal*
    outcomes, counted in ``failures``, and the workload keeps going. A
    ticket that never finishes at all (the failure mode the robustness
    tier exists to prevent) is counted in ``hung`` — a chaos gate asserts
    that stays zero.
    """
    from repro_torch.serve.engine import (
        AdmissionError, DeadlineExceeded, ServeEngine,
    )

    tickets = []
    rejected = failures = hung = 0
    with ServeEngine(session, cse=cse, **engine_kw) as eng:
        if warmup:
            distinct = {name: expr for _t, name, expr in stream}
            for expr in distinct.values():
                try:
                    eng.run(expr, timeout=300.0)
                except Exception:
                    pass        # a faulted warmup must not abort the run
        t0 = time.perf_counter()
        for tenant, _name, expr in stream:
            while True:
                try:
                    tickets.append(eng.submit(expr, tenant=tenant))
                    break
                except AdmissionError:
                    rejected += 1       # back off and retry, like a client
                    time.sleep(0.0005)
        for t in tickets:
            try:
                t.result(timeout=300.0)
            except DeadlineExceeded:
                failures += 1           # terminal: the engine cancelled it
            except TimeoutError:
                hung += 1               # NOT terminal: the client gave up
            except Exception:
                failures += 1           # terminal: finished with an error
        wall = time.perf_counter() - t0
        snap = eng.snapshot()
    lat_ms = sorted(t.latency * 1e3 for t in tickets)
    pct = (lambda q: lat_ms[min(len(lat_ms) - 1,
                                int(q * (len(lat_ms) - 1)))])
    return {
        "queries": len(tickets),
        "wall_s": wall,
        "qps": len(tickets) / wall,
        "p50_ms": pct(0.50),
        "p99_ms": pct(0.99),
        "admission_backoffs": rejected,
        "failures": failures,
        "hung": hung,
        "stats": snap,
    }
