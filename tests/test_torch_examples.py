"""The port's example and demo entry points against the JAX package's, on
the CPU.

* ``python -m repro_torch.collaborative_filtering --device cpu`` against
  ``examples/collaborative_filtering.py``, both run in a subprocess: line
  by line where the strings agree, else by their numbers (mse to rtol
  1e-4: float32 sums of 192,000 squares in another order; top-1 items
  equal; scores atol 1e-3, the printed rounding). On this CPU the two
  print the same lines.
* ``repro_torch.obs.demo.run_demo`` with 4 logical workers: the
  reference's ``EXPECTED_PHASES`` in its trace, and a ledger row or more
  per query.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.obs import demo as jdemo
from repro_torch import collaborative_filtering as cf
from repro_torch.obs import demo

ROOT = Path(__file__).resolve().parents[1]


def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, *args], env=env, cwd=str(ROOT),
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return [ln for ln in res.stdout.splitlines() if ln.startswith("[")]


def _floats(line):
    return [float(x) for x in re.findall(r"-?\d+\.\d+|-?\d+", line)]


def test_collaborative_filtering_prints_what_the_example_prints():
    want = _run(["examples/collaborative_filtering.py"])
    got = _run(["-m", "repro_torch.collaborative_filtering",
                "--device", "cpu"])
    assert [ln.split("]")[0] for ln in got] == \
        ["[clean", "[split", "[train", "[recommend", "[recommend"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if g == w:
            continue
        if g.startswith("[train]"):
            assert _floats(g)[0] == pytest.approx(_floats(w)[0], rel=1e-4)
        elif "top-1 item" in g:
            assert _floats(g) == _floats(w), (g, w)
        elif "scores" in g:
            np.testing.assert_allclose(_floats(g), _floats(w), atol=1e-3)
        else:
            assert g == w


def test_collaborative_filtering_relational_steps_equal_numpy():
    """The pipeline's relational results at a small size, exactly: the
    columns σ cols≠NULL keeps, the two folds, and Γmax over the columns of
    the pipeline's own masked prediction."""
    r = cf.pipeline("cpu", n_items=90, n_users=60, n_feat=24, rank=4,
                    steps=3, gen=np.random.default_rng(5))
    x, y = r["x"], r["y"]
    keep = np.any(x != 0, axis=0)
    assert 0 < keep.sum() < x.shape[1]
    np.testing.assert_array_equal(r["x_clean"].numpy(), x[:, keep])
    fold = 90 // cf.FOLDS
    np.testing.assert_array_equal(r["test"].numpy(), y[:fold])
    np.testing.assert_array_equal(r["train"].numpy(), y[fold:])
    masked = r["masked"].numpy()
    np.testing.assert_array_equal(r["best_scores"].numpy(),
                                  masked.max(axis=0))
    pred = (r["w"] @ r["h"].T).numpy()
    assert np.array_equal(r["top_items"].numpy(), np.argmax(
        np.where(y[fold:] == 0, pred, -np.inf), axis=0))


def test_collaborative_filtering_step_matches_float64():
    """One ALS step in float32 within 1e-5 of the Σ|terms| of a float64
    numpy step (sums of 200 products: float32 reads ~1e-7)."""
    rng = np.random.default_rng(2)
    y = (rng.uniform(size=(150, 200)) < 0.05).astype(np.float32)
    w0, h0 = cf.init_factors(150, 200, 16, rng)
    w, h = cf.als_step(*(torch.as_tensor(v) for v in (y, w0, h0)))
    y64, w64, h64 = (v.astype(np.float64) for v in (y, w0, h0))
    aw, ah = np.abs(w64), np.abs(h64)
    w_want = w64 + cf.LR * ((y64 - w64 @ h64.T) @ h64 - cf.LAM * w64)
    w_scale = aw + cf.LR * ((y64 + aw @ ah.T) @ ah + cf.LAM * aw)
    w2 = w.double().numpy()          # H's half against the port's new W
    h_want = h64 + cf.LR * ((y64 - w2 @ h64.T).T @ w2 - cf.LAM * h64)
    h_scale = ah + cf.LR * ((y64 + np.abs(w2) @ ah.T).T @ np.abs(w2)
                            + cf.LAM * ah)
    assert np.max(np.abs(w2 - w_want) / w_scale) <= 1e-5
    assert np.max(np.abs(h.double().numpy() - h_want) / h_scale) <= 1e-5


def test_collaborative_filtering_needs_a_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cf.main([])


def test_demo_covers_the_reference_phases_and_fills_the_ledger(tmp_path,
                                                              capsys):
    assert demo.EXPECTED_PHASES == jdemo.EXPECTED_PHASES
    ledger = tmp_path / "demo_ledger.jsonl"
    assert demo.run_demo(4, str(ledger), True, device="cpu") == 0
    line, = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("DEMO_JSON ")]
    blob = json.loads(line[len("DEMO_JSON "):])
    assert blob["workers"] == 4 and blob["device"] == "cpu"
    assert set(blob["phases"]) - {"query"} == set(jdemo.EXPECTED_PHASES)
    assert blob["ledger"]["rows"] >= 4          # one or more per query
    rows = [json.loads(r) for r in ledger.read_text().splitlines()]
    assert len(rows) == blob["ledger"]["rows"]


def test_demo_cli_runs_on_the_cpu_and_needs_a_card_by_default(monkeypatch,
                                                             capsys):
    assert demo.main(["--workers", "4", "--json", "--device", "cpu",
                      "--ledger-out", ""]) == 0
    assert "DEMO_JSON" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--workers", "4"])
