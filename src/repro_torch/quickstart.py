"""Quickstart: relational queries over matrix data with the PyTorch port.

The queries of the JAX package's ``examples/quickstart.py``, in its order
and from its seed, through ``Session(device=...)``; it prints the same
lines (``trace = 2065.559…``, ``G[1,1] = 2.831…``, ``direct overlay nnz:
6``, ``D2D join → order-3 tensor, 3468 matches``).

    PYTHONPATH=src python -m repro_torch.quickstart               # on the card
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import Session


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.quickstart")
    ap.add_argument("--device", default="cuda",
                    help="where the catalog and the queries run (default "
                         "cuda; raises without a card)")
    args = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    s = Session(device=args.device)

    # A sparse 2000×1000 feature matrix (1e-3 density)
    x = np.where(rng.uniform(size=(2000, 1000)) < 1e-3,
                 rng.normal(size=(2000, 1000)), 0).astype(np.float32)
    X = s.load(x, "X")

    # --- Code 1 from the paper: trace of a Gram matrix ---------------------
    tr = X.t().multiply(X).trace()
    print("== plan + rewrite for trace(XᵀX) ==")
    print(tr.explain())
    print("trace =", float(tr.to_numpy().ravel()[0]), "\n")

    # --- selection pushdown (Code 2) ----------------------------------------
    g11 = X.t().multiply(X).select("RID=1 AND CID=1")
    print("== σ_{RID=1∧CID=1}(XᵀX) becomes a vector inner product ==")
    print(g11.explain())
    print("G[1,1] =", float(g11.to_numpy().ravel()[0]), "\n")

    # --- joins (Codes 4, 5) ---------------------------------------------------
    a = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    b = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    A, B = s.load(a, "A"), s.load(b, "B")
    overlay = A.join(B, "RID=RID AND CID=CID", lambda x_, y_: x_ * y_)
    out = overlay.collect()
    print("direct overlay nnz:", int(out.nnz()))

    d2d = A.join(B, "RID=RID", lambda x_, y_: x_ * y_)
    t = d2d.collect()
    print(f"D2D join → order-{t.order} tensor, {t.nnz} matches")

    v2v = A.join(B, "VAL=VAL", lambda x_, y_: x_ + y_)
    tv = v2v.collect()
    print(f"V2V (Bloom) join → order-{tv.order} tensor, {tv.nnz} matches")

    # --- relational cleaning (σ_rows≠NULL) -----------------------------------
    dirty = a.copy()
    dirty[::7] = 0.0
    D = s.load(dirty, "D")
    clean = D.select("rows != NULL").to_numpy()
    print(f"rows≠NULL: {dirty.shape[0]} → {clean.shape[0]} rows")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
