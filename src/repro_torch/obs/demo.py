"""End-to-end observability demo: full span tree + cost ledger.

The port of the JAX package's ``obs/demo.py``. It runs one traced query
through every lifecycle phase —

    lower → optimize (memo) → physical_cost → schemes_dp →
    mask_propagation → stage_compile → execute

— and a small served workload that fills a JSONL cost ledger. The
``schemes_dp`` phase exists only on multi-worker plans. The port's
workers are logical (N workers on the session's one device), so any
``--workers`` runs in this process: there is no re-exec with more host
devices and no ``--no-respawn``.

    PYTHONPATH=src python -m repro_torch.obs.demo --workers 4 --json
    PYTHONPATH=src python -m repro_torch.obs.demo --workers 4 --json --device cpu

The demo ledger lands in a temporary directory by default (deleted on
exit), so demo runs never litter the checkout; ``--ledger-out PATH``
keeps the JSONL, ``--ledger-out ''`` keeps it in memory only.
``--json`` appends one machine-readable line (``DEMO_JSON {...}``) with
the covered phase names and the ledger summary.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile

EXPECTED_PHASES = (
    "lower", "optimize", "physical_cost", "schemes_dp",
    "mask_propagation", "stage_compile", "execute",
)


def run_demo(workers: int, ledger_path: str, emit_json: bool,
             device=None) -> int:
    """The traced query and the served workload on ``device`` (None: the
    card). Returns 0, or 1 when a phase or the ledger rows are missing."""
    import numpy as np

    from repro_torch.core.api import Session
    from repro_torch.obs.ledger import CostLedger
    from repro_torch.serve.engine import ServeEngine

    rng = np.random.default_rng(0)

    def sparse(n, d=0.3):
        v = rng.normal(size=(n, n)).astype(np.float32)
        return np.where(rng.uniform(size=(n, n)) < d, v, 0) \
            .astype(np.float32)

    # -- 1. one traced query covering every lifecycle phase ------------------
    s = Session(block_size=8, n_workers=workers, device=device)
    X = s.load(sparse(32), name="X")
    q = X.t().multiply(X).trace()
    tr = q._traced_run()
    print(tr.render())
    phases = set(tr.phase_names())
    missing = [p for p in EXPECTED_PHASES if p not in phases]
    if missing:
        print(f"[demo] FAIL: phases missing from trace: {missing}")
        return 1
    print(f"[demo] span tree covers all {len(EXPECTED_PHASES)} phases")

    # -- 2. a served workload writing the cost ledger ------------------------
    if ledger_path and os.path.exists(ledger_path):
        os.remove(ledger_path)
    ledger = CostLedger(ledger_path or None)
    Y = s.load(sparse(32), name="Y")
    queries = [X.t().multiply(X), X.multiply(Y),
               X.t().multiply(X).trace(), X.multiply(Y).sum("c")]
    with ServeEngine(s, n_threads=2, trace_sample=1.0,
                     ledger=ledger) as eng:
        tickets = [eng.submit(m) for m in queries for _ in range(3)]
        eng.drain()
        for t in tickets:
            t.result(timeout=300.0)
    summary = ledger.summary()
    ledger.close()
    print(f"[demo] ledger: {summary['rows']} rows, paths="
          f"{ {k: v['rows'] for k, v in summary['paths'].items()} }")
    if summary["rows"] < len(queries):
        print("[demo] FAIL: expected >=1 ledger row per executed plan")
        return 1
    if emit_json:
        print("DEMO_JSON " + json.dumps({
            "workers": workers,
            "device": str(s.device),
            "phases": sorted(phases),
            "ledger": summary,
            "ledger_path": ledger_path,
        }))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs.demo")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--ledger-out", default=None,
                    help="keep the demo ledger JSONL at this path "
                         "(default: a tempdir, deleted on exit; '' for "
                         "in-memory only)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the demo runs (default cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)
    if args.ledger_out is None:
        with tempfile.TemporaryDirectory(prefix="repro-demo-") as td:
            return run_demo(args.workers,
                            os.path.join(td, "demo_ledger.jsonl"),
                            args.json, args.device)
    return run_demo(args.workers, args.ledger_out, args.json, args.device)


if __name__ == "__main__":
    raise SystemExit(main())
