"""Calibrated physical cost model: per-device wall-time regression.

The memo search costs candidate plans with analytic flops/comm/nnz
(``core.cost.physical_cost``); those estimates carry deliberate modeling
fictions — most importantly, matmul flops are *density-scaled*
(2·m·k·n·s_a·s_b) while a dense product executes the full 2·m·k·n
regardless of sparsity. This module closes the gap: extract a per-plan
feature vector (dot vs elementwise flops, memory traffic,
transcendentals, collective bytes, launch count), fit ridge-regression
coefficients per ``(device, kernel backend)`` key against measured wall
times, and let ``physical_cost`` blend ``alpha·analytic +
(1-alpha)·calibrated``. The schema, the fit and the file format are the
JAX package's, so one ``costmodel.json`` holds both packages' keys.

Two fitting corpora feed the model:

* the predicted-vs-actual serving ledger (``obs.ledger`` JSONL rows —
  ``predicted.features`` next to ``measured.wall_s``), and
* ad-hoc bench corpora.

Coefficients persist to ``results/costmodel.json`` (``REPRO_COSTMODEL_PATH``
overrides) with a versioned schema. The fit is *relative* least squares
— rows are scaled by 1/wall so the optimizer minimizes multiplicative
error, matching the median |log(pred/meas)| acceptance metric — with
per-feature max-abs normalization and an intercept absorbing fixed
launch overhead.

When no coefficients exist for the current device key, ``alpha`` falls
back to 1.0: a cold machine plans exactly as before.

CLI (fit from a serving ledger):

    PYTHONPATH=src python -m repro_torch.core.calibrate fit \
        --ledger results/ledger.jsonl --out results/costmodel.json
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Canonical feature schema — the JAX package's (its
# analysis.hlo.FEATURE_NAMES). ``features_from_plan`` emits exactly these
# keys, so ledger rows of either package are interchangeable fit/predict
# inputs.
FEATURES = ("dot_flops", "ew_flops", "bytes", "transcendentals",
            "comm_bytes", "nnz", "ops")

SCHEMA = 1

_PATH_ENV = "REPRO_COSTMODEL_PATH"
_ALPHA_ENV = "REPRO_COSTMODEL_ALPHA"
_UNIT_ENV = "REPRO_CALIBRATED_UNIT_FLOPS"

# Analytic weight once a fitted model exists for the device key. The
# calibrated term gets the majority because it is trained on *this*
# machine; the analytic term is kept as a regularizer so a thin fitting
# corpus cannot invert obviously-ordered candidates.
DEFAULT_ALPHA = 0.35

# Converts calibrated wall seconds into the analytic cost unit ("scalar
# ops") when no fitted unit exists: the effective scalar throughput
# assumed when comparing a predicted wall time against an analytic flop
# count. Each fit learns the real per-device unit from its corpus
# (geometric-mean dense ops/second of the contraction-bearing rows) —
# with a unit far below the machine's true rate the calibrated term is
# numerically too small to ever overrule the analytic one, and the
# blend degenerates to pure analytic no matter how good the fit is.
CALIBRATED_UNIT_FLOPS = 5e8

# Refuse to fit below this many corpus rows: a 7-feature ridge on fewer
# rows memorizes noise and alpha-blending would amplify it.
MIN_FIT_ROWS = 8

# A refit bumps ``version`` — retiring every version-keyed optimize /
# serving cache — only when its predictions drift by more than this
# median |log(new/anchor)| from the last *bumped* coefficients. The
# threshold must sit ABOVE the fit's own noise floor: two independent
# fits of the same regime differ by roughly their median log error
# (~0.2–0.35 on small serving corpora), so a tight threshold re-plans
# the world every refit for coefficient wiggle that cannot change a
# single decision — the blend keeps an analytic anchor precisely so
# sub-2x prediction moves don't flip orderings. 0.5 ≈ a 1.65x median
# prediction shift: a genuine regime change, worth re-optimizing for.
# Hysteresis on top: the bump fires only when DRIFT_BUMP_STREAK
# consecutive fits all drift past the threshold — one unlucky fitting
# window (a GC-polluted burst of walls) must not retire every staged
# plan in a serving tier, while a real regime change keeps drifting on
# the next window and bumps one refit interval later.
DRIFT_BUMP_LOGERR = 0.5
DRIFT_BUMP_STREAK = 2

_DENSIFY_FLOOR = 0.05  # masked-elemwise dense-work floor (SDDMM tiles)


def default_costmodel_path() -> str:
    """``results/costmodel.json`` (as the JAX package) unless
    ``REPRO_COSTMODEL_PATH`` points elsewhere."""
    return os.environ.get(_PATH_ENV,
                          os.path.join("results", "costmodel.json"))


def default_alpha() -> float:
    try:
        return float(os.environ.get(_ALPHA_ENV, DEFAULT_ALPHA))
    except ValueError:
        return DEFAULT_ALPHA


def calibrated_unit_flops() -> float:
    try:
        return float(os.environ.get(_UNIT_ENV, CALIBRATED_UNIT_FLOPS))
    except ValueError:
        return CALIBRATED_UNIT_FLOPS


def device_key(device=None, backend: Optional[str] = None) -> str:
    """``platform:device_name|kernel_backend`` — the coefficient-table
    key. Coefficients are machine- and backend-specific; a model fitted
    on one device must not predict for another.

    ``device`` is the session's device (``cuda`` →
    ``cuda:<torch.cuda.get_device_name()>``, ``cpu`` → ``cpu:unknown``);
    None names this machine's card where there is one, else its CPU.
    ``backend`` defaults to the kernel backend of that device (``cuda``
    or ``torch``, ``kernels.registry.backend_for``)."""
    import torch
    from repro_torch.kernels.registry import backend_for
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    hw = (f"cuda:{torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
          else f"{dev.type}:unknown")
    return f"{hw}|{backend or backend_for(dev)}"


# ---------------------------------------------------------------------------
# Feature extraction.
# ---------------------------------------------------------------------------

def features_from_plan(plan, nnz: Optional[float] = None
                       ) -> Dict[str, float]:
    """Analytic feature vector of one dry-lowered ``PhysicalPlan``.

    Used both at fit time (persisted in ledger rows) and at predict time
    (``physical_cost``), so the two sides can never drift. The critical
    difference from ``plan.est_flops``: dot flops here are **dense**
    (2·m·k·n from the child shapes) because a dense product does the
    full multiply regardless of operand sparsity — exactly the
    miscalibration the fitted model corrects for.
    """
    from repro_torch.plan import ops as P
    from repro_torch.plan.schemes import ENTRY_BYTES
    dot = ew = byts = 0.0
    n_ops = 0
    nnz_fallback = 0.0
    for node in plan.nodes:
        if node.kind == P.LEAF:
            continue
        n_ops += 1
        out_numel = 1.0
        for d in node.shape:
            out_numel *= d
        nnz_fallback += out_numel * max(node.sparsity, 0.0)
        child_numel = 0.0
        for cid in node.children:
            cn = 1.0
            for d in plan.node(cid).shape:
                cn *= d
            child_numel += cn
        byts += ENTRY_BYTES * (out_numel + child_numel)
        if node.kind == P.MATMUL:
            m, k = plan.node(node.children[0]).shape
            n = node.shape[1] if len(node.shape) > 1 else 1
            dot += 2.0 * m * k * n
        elif node.kind == P.MASKED_ELEMWISE:
            # SDDMM: dense factor tiles are multiplied where the mask is
            # live; charge the dense work above a density floor
            w = plan.node(node.children[0])
            m, k = w.shape
            n = node.shape[1] if len(node.shape) > 1 else 1
            frac = max(node.sparsity, _DENSIFY_FLOOR)
            dot += 2.0 * m * k * n * frac
        elif node.kind == P.MASKED_AGG:
            # fused SDDMM+reduce: gated contraction work, but no m×n
            # intermediate ever hits memory — the bytes term already
            # reflects that because the node's own output is tiny
            sp = plan.node(node.children[0])
            w = plan.node(node.children[1])
            m, k = w.shape
            n = sp.shape[1] if len(sp.shape) > 1 else 1
            frac = max(sp.sparsity, _DENSIFY_FLOOR)
            dot += 2.0 * m * k * n * frac
        elif node.kind == P.INVERSE:
            n = node.shape[0]
            dot += 2.0 * float(n) ** 3
        elif node.kind == P.JOIN:
            # join work is data-dependent; the logical estimator is the
            # best plan-time number available
            ew += node.est_flops
        else:
            ew += out_numel
    return {
        "dot_flops": dot,
        "ew_flops": ew,
        "bytes": byts,
        "transcendentals": 0.0,   # no transcendental physical ops (yet)
        "comm_bytes": float(plan.total_comm_est) * ENTRY_BYTES,
        "nnz": nnz_fallback if nnz is None else float(nnz),
        "ops": float(n_ops),
    }


def _vec(features: Dict[str, float]) -> np.ndarray:
    return np.array([float(features.get(k, 0.0)) for k in FEATURES],
                    dtype=np.float64)


def _predict_params(m: dict, features: Dict[str, float]) -> float:
    x = _vec(features) / np.array(m["scale"], dtype=np.float64)
    pred = float(x @ np.array(m["weights"], dtype=np.float64)
                 + m["intercept"])
    # a regression can extrapolate negative; clamp to a strictly
    # positive floor so blended totals stay ordered and finite
    return max(pred, 1e-9)


def _predict_matrix(m: dict, X: np.ndarray) -> np.ndarray:
    """Vectorized ``_predict_params`` over raw (unscaled) feature rows —
    the background refit's drift probe runs on the serving thread budget
    and a per-row python predict loop is most of a fit's CPU."""
    pred = (X / np.array(m["scale"], dtype=np.float64)) \
        @ np.array(m["weights"], dtype=np.float64) + m["intercept"]
    return np.maximum(pred, 1e-9)


def _corpus_unit_flops(X: np.ndarray, y: np.ndarray) -> float:
    """Measured dense throughput of the corpus (scalar ops / second):
    geometric-mean (dot+ew)/wall over the contraction-bearing rows —
    the seconds→scalar-op unit the blend uses so the calibrated term is
    commensurate with analytic totals on *this* machine."""
    i_dot = FEATURES.index("dot_flops")
    i_ew = FEATURES.index("ew_flops")
    raw = X[:, i_dot] + X[:, i_ew]
    mask = X[:, i_dot] > 0.0
    if not mask.any():
        mask = raw > 0.0
    if not mask.any():
        return 0.0
    return float(np.exp(np.mean(np.log(raw[mask] / y[mask]))))


# ---------------------------------------------------------------------------
# Corpus plumbing.
# ---------------------------------------------------------------------------

def rows_to_corpus(rows: Sequence[dict]
                   ) -> List[Tuple[Dict[str, float], float]]:
    """Ledger JSONL rows → ``(features, wall_s)`` pairs.

    Rows without persisted features (older ledgers), root hits (they
    execute nothing — the wall time is a cache lookup) and non-positive
    walls are dropped.
    """
    out: List[Tuple[Dict[str, float], float]] = []
    for r in rows:
        if r.get("exec_path") == "root_hit":
            continue
        feats = (r.get("predicted") or {}).get("features")
        wall = (r.get("measured") or {}).get("wall_s")
        if not feats or wall is None or wall <= 0.0:
            continue
        out.append((feats, float(wall)))
    return out


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------

class CostModel:
    """Per-device-key ridge regression from feature vectors to wall
    seconds, with versioned JSON persistence.

    Thread-safe: serving-tier background refits call ``fit`` while
    worker threads call ``predict``; the coefficient table is swapped
    atomically under a lock and ``version`` bumps per successful fit so
    version-keyed plan/optimize caches retire stale decisions.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.version = 0
        self._lock = threading.Lock()
        # device key → {"weights": [...], "intercept": w0,
        #               "scale": [...], "rows": n, "unit_flops": u}
        self._models: Dict[str, dict] = {}
        # device key → params at the last version bump; a refit only
        # bumps (and retires caches) when it drifts from this anchor
        self._anchors: Dict[str, dict] = {}
        # device key → consecutive drifting fits (bump hysteresis)
        self._drift_streak: Dict[str, int] = {}
        if path and os.path.exists(path):
            try:
                self._load_file(path)
            except (OSError, ValueError, KeyError):
                self._models = {}

    # -- persistence ----------------------------------------------------------
    def _load_file(self, path: str) -> None:
        with open(path) as f:
            data = json.load(f)
        if data.get("_schema") != SCHEMA:
            raise ValueError(f"unknown costmodel schema "
                             f"{data.get('_schema')!r}")
        models = {}
        for key, m in data.get("models", {}).items():
            if (list(m.get("features", [])) == list(FEATURES)
                    and len(m.get("weights", [])) == len(FEATURES)):
                models[key] = {"weights": [float(w) for w in m["weights"]],
                               "intercept": float(m.get("intercept", 0.0)),
                               "scale": [float(s) for s in m["scale"]],
                               "rows": int(m.get("rows", 0)),
                               "unit_flops": float(m.get("unit_flops",
                                                         0.0))}
        with self._lock:
            self._models = models
            self._anchors = dict(models)
            if models:
                self.version += 1

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path or default_costmodel_path()
        with self._lock:
            payload = {
                "_schema": SCHEMA,
                "models": {
                    key: {"features": list(FEATURES),
                          "weights": m["weights"],
                          "intercept": m["intercept"],
                          "scale": m["scale"],
                          "rows": m["rows"],
                          "unit_flops": m.get("unit_flops", 0.0)}
                    for key, m in self._models.items()},
            }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: Optional[str] = None) -> "CostModel":
        return cls(path or default_costmodel_path())

    # -- fitting --------------------------------------------------------------
    def fit(self, corpus: Sequence[Tuple[Dict[str, float], float]],
            device: Optional[str] = None, ridge: float = 1e-3,
            min_rows: int = MIN_FIT_ROWS) -> bool:
        """Fit coefficients for ``device`` (default: this machine) from
        ``(features, wall_s)`` pairs. Relative least squares: each row is
        scaled by 1/wall, so the residual is (pred/wall − 1) and the fit
        minimizes multiplicative, not absolute, error — small fast plans
        count as much as big slow ones. Coefficients are constrained
        non-negative (active-set clamp): more flops/bytes/launches can
        never make a plan *faster*, and an unconstrained ridge on the
        collinear feature set happily goes negative on one of a
        correlated pair — which inverts the predicted ordering of plans
        outside the corpus envelope, exactly where the optimizer needs
        the model most. Returns True on success (enough rows, solvable
        system); the model is untouched on False."""
        key = device or device_key()
        pairs = [(f, w) for f, w in corpus if w > 0.0]
        if len(pairs) < min_rows:
            return False
        X = np.array([[float(f.get(k, 0.0)) for k in FEATURES]
                      for f, _ in pairs], dtype=np.float64)   # (n, d)
        y = np.array([w for _, w in pairs], dtype=np.float64)
        scale = np.abs(X).max(axis=0)
        scale[scale == 0.0] = 1.0
        Xs = X / scale
        # intercept column models fixed dispatch/launch overhead
        Xi = np.concatenate([Xs, np.ones((len(y), 1))], axis=1)
        Xr = Xi / y[:, None]                               # relative LS
        d = Xi.shape[1]
        active = np.ones(d, dtype=bool)
        w = np.zeros(d)
        try:
            for _ in range(d):                 # active-set clamp to >= 0
                Xa = Xr[:, active]
                A = Xa.T @ Xa + ridge * np.eye(int(active.sum()))
                b = Xa.T @ np.ones_like(y)
                wa = np.linalg.solve(A, b)
                w = np.zeros(d)
                w[active] = wa
                neg = w < 0.0
                if not neg.any():
                    break
                active &= ~neg
                if not active.any():
                    return False
        except np.linalg.LinAlgError:
            return False
        if not np.all(np.isfinite(w)) or not np.any(w > 0.0):
            return False
        new_m = {
            "weights": [float(v) for v in w[:-1]],
            "intercept": float(w[-1]),
            "scale": [float(s) for s in scale],
            "rows": len(pairs),
            "unit_flops": _corpus_unit_flops(X, y),
        }
        with self._lock:
            anchor = self._anchors.get(key)
            bump = anchor is None
            if not bump:
                probe = X[:64]
                drift = np.abs(np.log(_predict_matrix(new_m, probe)
                                      / _predict_matrix(anchor, probe)))
                if float(np.median(drift)) > DRIFT_BUMP_LOGERR:
                    streak = self._drift_streak.get(key, 0) + 1
                    self._drift_streak[key] = streak
                    bump = streak >= DRIFT_BUMP_STREAK
                else:
                    self._drift_streak[key] = 0
            self._models[key] = new_m
            if bump:
                self._anchors[key] = new_m
                self._drift_streak[key] = 0
                self.version += 1
        return True

    def fit_from_rows(self, rows: Sequence[dict],
                      device: Optional[str] = None, **kw) -> bool:
        return self.fit(rows_to_corpus(rows), device=device, **kw)

    # -- prediction -----------------------------------------------------------
    def model_for(self, device: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            return self._models.get(device or device_key())

    def predict(self, features: Dict[str, float],
                device: Optional[str] = None) -> Optional[float]:
        """Predicted wall seconds for one feature vector, or None when
        no coefficients exist for the device key (caller falls back to
        the pure-analytic cost, alpha → 1)."""
        m = self.model_for(device)
        if m is None:
            return None
        return _predict_params(m, features)

    def unit_flops(self, device: Optional[str] = None) -> float:
        """Seconds→scalar-op conversion for the blend: the env override
        when set, else the unit fitted for this device key (the
        corpus's measured dense throughput), else the static default."""
        if os.environ.get(_UNIT_ENV):
            return calibrated_unit_flops()
        m = self.model_for(device)
        if m and m.get("unit_flops"):
            return float(m["unit_flops"])
        return CALIBRATED_UNIT_FLOPS

    def alpha(self, device: Optional[str] = None) -> float:
        """Analytic blend weight: ``default_alpha()`` when a fitted model
        exists for the device key, 1.0 (pure analytic) otherwise."""
        return default_alpha() if self.model_for(device) is not None \
            else 1.0

    def fitted_devices(self) -> List[str]:
        with self._lock:
            return sorted(self._models)


# ---------------------------------------------------------------------------
# CLI: fit from a ledger JSONL (CI's smoke corpus) and persist.
# ---------------------------------------------------------------------------

def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.calibrate")
    sub = ap.add_subparsers(dest="cmd", required=True)
    fit = sub.add_parser("fit", help="fit coefficients from a ledger")
    fit.add_argument("--ledger", required=True,
                     help="predicted-vs-actual JSONL (obs.ledger rows)")
    fit.add_argument("--out", default=None,
                     help="costmodel.json path (default: "
                          "results/costmodel.json)")
    fit.add_argument("--device", default=None,
                     help="device key override (default: this machine)")
    fit.add_argument("--ridge", type=float, default=1e-3)
    fit.add_argument("--min-rows", type=int, default=MIN_FIT_ROWS)
    args = ap.parse_args(argv)

    from repro_torch.obs.ledger import CostLedger
    rows = CostLedger.load_rows(args.ledger)
    corpus = rows_to_corpus(rows)
    model = CostModel(args.out or default_costmodel_path())
    ok = model.fit(corpus, device=args.device, ridge=args.ridge,
                   min_rows=args.min_rows)
    if not ok:
        print(f"[calibrate] NOT fitted: {len(corpus)} usable rows "
              f"(min {args.min_rows}) from {len(rows)} ledger rows")
        return 1
    path = model.save()
    key = args.device or device_key()
    m = model.model_for(key)
    print(f"[calibrate] fitted {key} from {m['rows']} rows → {path}")
    errs = []
    for f, w in corpus:
        p = model.predict(f, device=key)
        if p is not None and w > 0:
            errs.append(abs(np.log(p / w)))
    if errs:
        print(f"[calibrate] median |log(pred/meas)| = "
              f"{float(np.median(errs)):.3f} over {len(errs)} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
