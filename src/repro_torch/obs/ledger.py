"""Predicted-vs-actual cost ledger: one JSONL row per executed plan.

The optimizer's cost model predicts flops / communication / materialized
nnz per candidate plan (``core.cost.physical_cost``, the schemes DP); this
ledger records those predictions next to what execution actually measured
— wall time, staged-build-vs-execute split, collective bytes (none are
measured yet: the port runs one worker on one device), realized nnz and
overflow outcomes. Persisted append-only as JSONL beside ``results/autotune.json``
(same convention: ``REPRO_LEDGER_PATH`` overrides), it is the training
corpus the ROADMAP's learned cost model will re-fit from: "log
predicted-vs-actual per executed plan and re-fit".

Row schema (versioned; ``docs/observability.md``):

    {"schema": 1, "ts": <unix>, "trace_id": <str|null>,
     "query": <root signature>, "plan_nodes": N, "mode": "sparse|dense",
     "n_workers": W, "exec_path": "staged|staged_sparse|eager|
     eager_reuse|root_hit|tree", "predicted": {"flops", "comm_entries",
     "comm_bytes", "nnz", "features": {core.calibrate.FEATURES}},
     "measured": {"wall_s", "compile_s", "comm_bytes", "nnz",
     "overflow"}}

Writers hold an internal lock per append, so many engine worker threads
can share one ledger; rows are also kept in a bounded in-memory deque for
``summary()`` and tests.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch.runtime import faults

SCHEMA = 1

_PATH_ENV = "REPRO_LEDGER_PATH"


def default_ledger_path() -> str:
    """Beside the autotune cache: ``results/ledger.jsonl`` unless
    ``REPRO_LEDGER_PATH`` points elsewhere."""
    return os.environ.get(_PATH_ENV,
                          os.path.join("results", "ledger.jsonl"))


def predicted_of(plan, opt=None) -> Dict[str, Any]:
    """The cost model's prediction for ``plan``: flops and comm from the
    physical DAG annotations (free — already computed at plan time), nnz
    from the memo search's dry-lowered breakdown when one exists.
    Memoized on the plan — predictions are plan-time constants, and the
    serving tier records a row per ticket on the hot path."""
    phys = getattr(opt, "physical", None) if opt is not None else None
    nnz_key = None if phys is None else float(phys.nnz)
    cached = getattr(plan, "_ledger_predicted", None)
    if cached is not None and cached[0] == nnz_key:
        return cached[1]
    from repro_torch.core.calibrate import features_from_plan
    from repro_torch.plan.schemes import ENTRY_BYTES
    out = {
        "flops": float(plan.est_flops),
        "comm_entries": float(plan.total_comm_est),
        "comm_bytes": float(plan.total_comm_est) * ENTRY_BYTES,
        "nnz": nnz_key,
        # the calibrated cost model's feature vector (core.calibrate):
        # persisted per row so the serving ledger doubles as the fitting
        # corpus — measured wall_s lands beside these in the same row;
        # best-effort: a partial plan (no node list) records without it
        # rather than failing the row
        "features": (features_from_plan(plan, nnz=nnz_key)
                     if hasattr(plan, "nodes") else None),
    }
    plan._ledger_predicted = (nnz_key, out)
    return out


def exec_path_of(stats: Dict[str, int]) -> str:
    """Classify which executor path a run took from its stats delta."""
    for key in ("staged_spmd", "staged", "staged_sparse_spmd",
                "staged_sparse"):
        if stats.get(key, 0):
            return key
    return "eager"


def measured_comm_bytes(plan, env, mesh) -> Optional[int]:
    """Measured network-wide collective bytes of the staged multi-worker
    program. The JAX package parses the XLA HLO of its SPMD program; the
    port runs one worker on one device and has no such program yet
    (ROADMAP: multi-worker schemes), so there is nothing to measure and
    the row records None."""
    return None


class CostLedger:
    """Append-only predicted-vs-actual record of executed plans.

    ``path=None`` keeps rows in memory only (tests, ad-hoc sessions);
    with a path every row is appended as one JSON line, flushed per
    write so a crashed server loses at most the in-flight row.

    Degradation contract: ledger IO failures (a full disk, a yanked
    volume, an injected ``ledger_io`` fault) must never fail the query
    that produced the row — the disk write is dropped and counted
    (``dropped_writes``; the in-memory row is kept, so online refits
    keep their corpus even while the disk is unwritable).
    """

    def __init__(self, path: Optional[str] = None, keep: int = 4096):
        self.path = path
        self._rows: "deque[Dict[str, Any]]" = deque(maxlen=keep)
        self._lock = threading.Lock()
        self._fh = None
        self.dropped_writes = 0
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a")

    # -- recording ------------------------------------------------------------
    def record(self, *, query: str, plan, exec_path: str,
               wall_s: float, compile_s: float = 0.0,
               measured_comm: Optional[int] = None,
               measured_nnz: Optional[float] = None,
               overflow: bool = False, opt=None,
               trace_id: Optional[str] = None,
               **extra) -> Dict[str, Any]:
        row = {
            "schema": SCHEMA,
            "ts": time.time(),
            "trace_id": trace_id,
            "query": query,
            "plan_nodes": plan.n_nodes,
            "mode": plan.mode,
            "n_workers": plan.n_workers,
            "exec_path": exec_path,
            "predicted": predicted_of(plan, opt=opt),
            "measured": {
                "wall_s": float(wall_s),
                "compile_s": float(compile_s),
                "comm_bytes": (None if measured_comm is None
                               else int(measured_comm)),
                "nnz": (None if measured_nnz is None
                        else float(measured_nnz)),
                "overflow": bool(overflow),
            },
        }
        if extra:
            row.update(extra)
        with self._lock:
            self._rows.append(row)
            if self._fh is not None:
                try:
                    faults.check("ledger_io")
                    self._fh.write(json.dumps(row) + "\n")
                    self._fh.flush()
                except (OSError, ValueError, faults.FaultInjected):
                    # drop-and-count (module docstring): the query must
                    # not fail because its audit row could not persist
                    self.dropped_writes += 1
                    from repro_torch.obs.metrics import REGISTRY
                    REGISTRY.counter("ledger_dropped_writes").inc()
        return row

    # -- reading ---------------------------------------------------------------
    def rows(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._rows)

    def __len__(self) -> int:
        with self._lock:
            return len(self._rows)

    def summary(self) -> Dict[str, Any]:
        """Aggregate predicted-vs-actual view: per-exec-path counts/wall
        totals and the comm-bytes ratio over rows that measured both."""
        rows = self.rows()
        paths: Dict[str, Dict[str, float]] = {}
        pred_comm = meas_comm = 0.0
        comm_rows = 0
        for r in rows:
            p = paths.setdefault(r["exec_path"],
                                 {"rows": 0, "wall_s": 0.0,
                                  "compile_s": 0.0})
            p["rows"] += 1
            p["wall_s"] += r["measured"]["wall_s"]
            p["compile_s"] += r["measured"]["compile_s"]
            mc = r["measured"]["comm_bytes"]
            if mc is not None:
                pred_comm += r["predicted"]["comm_bytes"]
                meas_comm += mc
                comm_rows += 1
        ratio = None
        if comm_rows:
            # both-zero (no collectives predicted, none emitted) is exact
            # agreement, not 0/0
            ratio = (1.0 if pred_comm == meas_comm == 0.0
                     else pred_comm / max(meas_comm, 1e-12))
        return {"rows": len(rows), "paths": paths,
                "comm_rows": comm_rows,
                "predicted_comm_bytes": pred_comm,
                "measured_comm_bytes": meas_comm,
                "comm_ratio": ratio,
                "dropped_writes": self.dropped_writes}

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    # -- loading ---------------------------------------------------------------
    @staticmethod
    def load_rows(path: str) -> List[Dict[str, Any]]:
        out = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
