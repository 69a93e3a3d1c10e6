"""Serving launcher: the relational query-serving tier.

Relational serving (the paper's premise — queries over big matrix data as
a service): spin a ``ServeEngine`` over a synthetic catalog and serve a
zipf multi-tenant workload, printing sustained qps and p50/p99 latency
with and without cross-query CSE:

    PYTHONPATH=src python -m repro_torch.launch.serve --relational \\
        --clients 1000 --dim 48 --threads 2          # on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --relational \\
        --device cpu --clients 200 --dim 24 --threads 2

The same arguments and seed give the JAX package's catalog, stream and
counters (``python -m repro.launch.serve --relational``).
``--measure-comm`` records each ledger row's collective bytes, as there
(0: the launcher's session has one worker). The LM demo of that launcher
(``--arch``) is not ported yet.
"""
from __future__ import annotations

import argparse

import numpy as np


def serve_relational(args) -> int:
    import json

    from repro_torch.core import Session
    from repro_torch.obs.ledger import CostLedger
    from repro_torch.serve import workload as wl

    rng = np.random.default_rng(args.seed)
    cost_model = None
    if args.costmodel_out or args.refit_every:
        from repro_torch.core.calibrate import CostModel
        cost_model = CostModel(args.costmodel_out or None)
    session = Session(block_size=args.block_size, cost_model=cost_model,
                      device=args.device)
    mats = wl.synthetic_catalog(session, rng, n=args.dim)
    templates = wl.query_templates(mats)
    stream = wl.client_stream(rng, templates, n_clients=args.clients,
                              n_tenants=args.tenants)
    print(f"[serve] catalog={list(mats)} templates={len(templates)} "
          f"clients={args.clients} tenants={args.tenants} "
          f"device={session.device}")
    ledger = None
    if args.ledger_out or args.metrics_out or args.refit_every:
        # refit without an explicit output still needs the in-memory
        # rows as its fitting corpus
        ledger = CostLedger(args.ledger_out or None)
    snapshots = {}
    perf = {}
    violations = []
    for cse in (True, False):
        r = wl.run_workload(session, stream, cse=cse,
                            n_threads=args.threads,
                            tenant_max_inflight=args.tenant_inflight,
                            trace_sample=args.trace_sample,
                            ledger=ledger,
                            measure_comm=args.measure_comm,
                            refit_every=args.refit_every,
                            deadline_s=args.deadline)
        st = r["stats"]
        arm = f"cse_{'on' if cse else 'off'}"
        snapshots[arm] = st
        perf[arm] = {k: r[k] for k in ("queries", "wall_s", "qps",
                                       "p50_ms", "p99_ms", "failures",
                                       "hung", "admission_backoffs")}
        print(f"[serve] cse={'on ' if cse else 'off'} "
              f"qps={r['qps']:.0f} p50={r['p50_ms']:.2f}ms "
              f"p99={r['p99_ms']:.2f}ms root_hits={st['root_hits']} "
              f"shared_nodes={st['inter_query_cse_nodes']} "
              f"leaf_scans={st['leaf_scans']}/{st['leaf_refs']}"
              + (f" refits={st['refits']}" if args.refit_every else "")
              + (f" failures={r['failures']} hung={r['hung']} "
                 f"worker_restarts={st['worker_restarts']}"
                 if r["failures"] or r["hung"] or st["worker_crashes"]
                 else ""))
        # the chaos job's liveness gate (docs/robustness.md): every
        # admitted ticket must reach a terminal state, and the counters
        # must balance — a hung client or a lost/double-counted
        # completion is a hard failure, faults or no faults
        if st["completed"] + st["errors"] != st["submitted"]:
            violations.append(
                f"{arm}: completed({st['completed']}) + "
                f"errors({st['errors']}) != submitted({st['submitted']})")
        if r["hung"]:
            violations.append(f"{arm}: {r['hung']} ticket(s) hung past "
                              "the client timeout")
    if cost_model is not None and args.costmodel_out:
        path = cost_model.save()
        print(f"[serve] cost model v{cost_model.version} "
              f"({', '.join(cost_model.fitted_devices()) or 'unfitted'})"
              f" → {path}")
    if args.metrics_out:
        from repro_torch.runtime import faults
        out = {"engine": snapshots, "perf": perf,
               "faults": faults.stats()}
        if ledger is not None:
            out["ledger"] = {"path": args.ledger_out,
                             "summary": ledger.summary()}
        with open(args.metrics_out, "w") as f:
            json.dump(out, f, indent=2, default=str)
        print(f"[serve] metrics → {args.metrics_out}"
              + (f", ledger → {args.ledger_out}"
                 if args.ledger_out else ""))
    if ledger is not None:
        ledger.close()
    if args.assert_complete:
        if violations:
            for v in violations:
                print(f"[serve] COMPLETENESS VIOLATION: {v}")
            return 1
        print("[serve] completeness: all tickets terminal, "
              "completed+errors == submitted in every arm")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--relational", action="store_true",
                    help="serve the relational matrix-query workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the catalog and every query run (default "
                         "cuda; raises without a card)")
    ap.add_argument("--clients", type=int, default=1000)
    ap.add_argument("--tenants", type=int, default=8)
    ap.add_argument("--dim", type=int, default=48)
    ap.add_argument("--block-size", type=int, default=8)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--tenant-inflight", type=int, default=None,
                    help="admission: max queued+running per tenant")
    ap.add_argument("--trace-sample", type=float, default=None,
                    help="engine trace sampling rate (0..1; default: "
                         "REPRO_TRACE_SAMPLE / off)")
    ap.add_argument("--ledger-out", default=None,
                    help="append the predicted-vs-actual cost ledger "
                         "to this JSONL file")
    ap.add_argument("--metrics-out", default=None,
                    help="dump engine metric snapshots (+ ledger "
                         "summary) as JSON at exit")
    ap.add_argument("--measure-comm", action="store_true",
                    help="record measured collective bytes in ledger "
                         "rows (counted on a mesh, 0 off-mesh)")
    ap.add_argument("--refit-every", type=int, default=None,
                    help="online calibration: background-refit the "
                         "session cost model every N executed plans "
                         "from the accumulated ledger rows")
    ap.add_argument("--costmodel-out", default=None,
                    help="persist fitted cost-model coefficients "
                         "(core.calibrate) to this JSON at exit")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-ticket deadline seconds (queue wait + "
                         "execution); past it the engine finishes the "
                         "ticket with DeadlineExceeded")
    ap.add_argument("--assert-complete", action="store_true",
                    help="exit 1 unless every admitted ticket reached a "
                         "terminal state and completed+errors == "
                         "submitted (the chaos gate; pair with "
                         "REPRO_FAULTS=...)")
    ap.add_argument("--arch", default=None,
                    help="the LM serving demo (not ported: raises)")
    args = ap.parse_args(argv)
    if args.relational:
        return serve_relational(args)
    raise NotImplementedError(
        f"LM serving (--arch {args.arch or 'qwen3-1.7b'}) is not ported yet "
        "(ROADMAP: the LM substrate); pass --relational")


if __name__ == "__main__":
    raise SystemExit(main())
