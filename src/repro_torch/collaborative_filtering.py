"""Paper Example 1: collaborative filtering with side information.

The port of the JAX package's ``examples/collaborative_filtering.py``:
the same constants, one module-level ``np.random.default_rng(0)`` drawn
in the example's order (the data, then the W/H initial values), and the
same printed lines. Pipeline, the relational steps through
``Session(device=...)``:

 1. data cleaning    — σ cols≠NULL drops the empty feature columns of X
 2. cross-validation — RID-range selections split Y into k folds
 3. model            — two-factor ALS-style updates for Ŷ = W×Hᵀ, a plain
                       torch step on the session's device in float32 (as
                       the example's ``jnp.asarray`` makes it; float32
                       products never run as TF32)
 4. post-processing  — Γmax over the columns of the prediction masked to
                       the items not yet recommended (top-1 per user)

``pipeline`` runs the four steps at any size and returns their results
on the device. Each update sums over all users (W) or all training items
(H), so its step scales as ``LR · N_USERS / users``: at the example's
size that is its 0.05, and at any size with its 3:2 items:users each sum
takes the example's step (0.05 itself diverges to NaN already at 1536 x
1024).

    PYTHONPATH=src python -m repro_torch.collaborative_filtering            # card
    PYTHONPATH=src python -m repro_torch.collaborative_filtering --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import Session

N_ITEMS, N_USERS, N_FEAT, RANK = 600, 400, 64, 16
STEPS = 200
FOLDS = 5
LAM = 0.1
LR = 0.05
rng = np.random.default_rng(0)


def make_data(n_items: int = N_ITEMS, n_users: int = N_USERS,
              n_feat: int = N_FEAT, rank: int = RANK,
              gen: Optional[np.random.Generator] = None):
    """Ratings Y [items, users] (1 where observed and above 0.5) and the
    side information X [items, features] with about a fifth of its
    columns empty. Draws from ``gen`` (default: the module's ``rng``)."""
    gen = rng if gen is None else gen
    w_true = gen.normal(size=(n_items, rank)).astype(np.float32)
    h_true = gen.normal(size=(n_users, rank)).astype(np.float32)
    full = w_true @ h_true.T
    observed = gen.uniform(size=full.shape) < 0.05
    y = np.where(observed & (full > 0.5), 1.0, 0.0).astype(np.float32)
    x = gen.normal(size=(n_items, n_feat)).astype(np.float32)
    x[:, gen.uniform(size=n_feat) < 0.2] = 0.0   # empty (unscraped) features
    return y, x


def init_factors(m: int, n_users: int, rank: int = RANK,
                 gen: Optional[np.random.Generator] = None):
    """W [m, rank] and H [users, rank]: |normal| · 0.1, drawn in float64
    and rounded to float32 as the example's ``jnp.asarray`` does."""
    gen = rng if gen is None else gen
    w = np.abs(gen.normal(size=(m, rank))) * 0.1
    h = np.abs(gen.normal(size=(n_users, rank))) * 0.1
    return w.astype(np.float32), h.astype(np.float32)


def als_step(y: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
             lam: float = LAM, lr: float = LR):
    """One update of W, then of H against the new W (the example's jitted
    ``step``, in its order of operations)."""
    w = w + lr * ((y - w @ h.T) @ h - lam * w)
    h = h + lr * ((y - w @ h.T).T @ w - lam * h)
    return w, h


def step_size(n_users: int) -> float:
    """The update's step at ``n_users`` users (``LR`` at the example's)."""
    return LR * N_USERS / n_users


def pipeline(device=None, n_items: int = N_ITEMS, n_users: int = N_USERS,
             n_feat: int = N_FEAT, rank: int = RANK, steps: int = STEPS,
             gen: Optional[np.random.Generator] = None) -> Dict[str, object]:
    """The four steps at these sizes. Returns the numpy inputs (``y``,
    ``x``, the initial ``w0``/``h0``), the relational results as tensors
    on the device (``x_clean``, ``test``, ``train``, ``best_scores``),
    the trained ``w``/``h``, the step size ``lr``, the masked prediction
    ``masked``, ``mse``, ``top_items`` and the wall ``seconds`` of each
    step (``data``, made with numpy; ``relational``; ``train``; ``post``),
    each ending in a synchronize of the device."""
    seconds = {}
    t0 = time.perf_counter()
    y, x = make_data(n_items, n_users, n_feat, rank, gen)
    seconds["data"] = time.perf_counter() - t0
    s = Session(device=device)

    def lap(name, t):
        if s.device.type == "cuda":
            torch.cuda.synchronize(s.device)
        seconds[name] = time.perf_counter() - t
        return time.perf_counter()

    # 1. relational cleaning of the side-information matrix
    t0 = time.perf_counter()
    x_clean = s.load(x, "X").select("cols != NULL").collect().value

    # 2. k-fold split on the row dimension of Y (relational selects)
    y_m = s.load(y, "Y")
    fold = n_items // FOLDS
    test = y_m.select(f"RID>=0 AND RID<={fold - 1}").collect().value
    train = y_m.select(f"RID>={fold} AND RID<={n_items - 1}").collect().value
    t0 = lap("relational", t0)

    # 3. factorization on the training fold (simple ALS-ish updates)
    w0, h0 = init_factors(train.shape[0], n_users, rank, gen)
    w = torch.as_tensor(w0, device=s.device)
    h = torch.as_tensor(h0, device=s.device)
    lr = step_size(n_users)
    for _ in range(steps):
        w, h = als_step(train, w, h, lr=lr)
    t0 = lap("train", t0)
    pred = w @ h.T
    mse = float(torch.mean((train - pred) ** 2))

    # 4. post-processing: mask out already-recommended items, Γmax per user
    unseen = train == 0
    masked = torch.where(unseen, pred, 0.0)
    s2 = Session(device=device)
    best = s2.load(masked, "pred").max("c").collect().value.reshape(-1)
    top = torch.argmax(torch.where(unseen, pred, -torch.inf), dim=0)
    lap("post", t0)
    return {"y": y, "x": x, "w0": w0, "h0": h0, "x_clean": x_clean,
            "test": test, "train": train, "w": w, "h": h, "lr": lr,
            "mse": mse, "masked": masked, "best_scores": best,
            "top_items": top, "seconds": seconds}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.collaborative_filtering")
    ap.add_argument("--device", default="cuda",
                    help="where the pipeline runs (default cuda; raises "
                         "without a card)")
    args = ap.parse_args(argv)
    r = pipeline(args.device)
    print(f"[clean] feature matrix {r['x'].shape} → "
          f"{tuple(r['x_clean'].shape)} (σ_cols≠NULL)")
    print(f"[split] train {tuple(r['train'].shape)} / test "
          f"{tuple(r['test'].shape)}")
    print(f"[train] mse={r['mse']:.4f}")
    top = r["top_items"][:8].cpu().numpy()
    best = r["best_scores"][:8].cpu().numpy()
    print(f"[recommend] top-1 item for first 8 users: {top}")
    print(f"[recommend] their scores: {np.round(best, 3)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
