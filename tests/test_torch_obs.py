"""The port's metrics registry, cost ledger and calibrated cost model,
against the JAX package's on the CPU.

Same numpy inputs from a seed go to both packages' sessions. Exact: metric
snapshots, ledger row schemas, exec paths, feature vectors, chosen plans.
Fitted coefficients and blended costs: rtol 1e-6 (the same float64 numpy
fit on the same rows). The reference runs with JAX on the CPU; its device
key is ``cpu:cpu|default``, the port's CPU session's ``cpu:unknown|torch``,
so each package fits and reads under its own key."""
import json
import threading

import numpy as np
import pytest
import torch

from repro.core import Session as JSession
from repro.core import calibrate as j_cal
from repro.core import cost as j_cost
from repro.core.expr import signature as j_signature
from repro.obs import ledger as j_ledger
from repro.obs import metrics as j_metrics
from repro_torch.core import Session
from repro_torch.core import calibrate as t_cal
from repro_torch.core import cost as t_cost
from repro_torch.core.expr import signature as t_signature
from repro_torch.obs import ledger as t_ledger
from repro_torch.obs import metrics as t_metrics
from repro_torch.obs.ledger import CostLedger
from repro_torch.serve.engine import ServeEngine

T_KEY = "cpu:unknown|torch"


def _corpus(n=32, seed=0):
    """Feature vectors with walls from a known linear law + noise."""
    rng = np.random.default_rng(seed)
    corpus = []
    for _ in range(n):
        f = {
            "dot_flops": float(rng.uniform(1e5, 1e8)),
            "ew_flops": float(rng.uniform(1e3, 1e6)),
            "bytes": float(rng.uniform(1e4, 1e7)),
            "transcendentals": 0.0,
            "comm_bytes": 0.0,
            "nnz": float(rng.uniform(1e2, 1e5)),
            "ops": float(rng.integers(1, 20)),
        }
        wall = (f["dot_flops"] / 1e9 + f["bytes"] / 1e10
                + f["ops"] * 1e-4 + 1e-4)
        corpus.append((f, wall * float(rng.uniform(0.95, 1.05))))
    return corpus


def _sparse(rng, n, d=0.4):
    v = rng.normal(size=(n, n)).astype(np.float32)
    return np.where(rng.uniform(size=(n, n)) < d, v, 0).astype(np.float32)


def _pair(seed=0, n=32, **kw):
    """A reference session and a CPU port session over the same catalog."""
    rng = np.random.default_rng(seed)
    arrays = {"A": _sparse(rng, n), "B": rng.normal(size=(n, n))
              .astype(np.float32), "C": _sparse(rng, n, 0.05)}
    out = []
    for s in (JSession(block_size=8, **kw.get("ref", {})),
              Session(block_size=8, device="cpu", **kw.get("port", {}))):
        mats = {k: s.load(v, k) for k, v in arrays.items()}
        out.append((s, mats))
    return out


def _queries(m):
    A, B, C = m["A"], m["B"], m["C"]
    return [A.multiply(B), A.t().multiply(A).trace(), A.add(B),
            C.emul(A.multiply(B)), A.multiply(B).sum("r"),
            C.join(A, "RID=RID AND CID=CID", lambda x, y: x * y),
            A.emul(B).add(1.0), B.t().multiply(C).sum("c")]


# ---------------------------------------------------------------------------
# metrics


def _metric_ops(mod):
    reg = mod.MetricsRegistry()
    reg.counter("hits", cache="a").inc()
    reg.counter("hits", cache="a").inc(2)
    reg.counter("hits", cache="b").inc()
    reg.gauge("depth").set(7)
    h = reg.histogram("lat")
    rng = np.random.default_rng(7)
    for v in rng.lognormal(mean=-6.0, sigma=1.2, size=2000):
        h.observe(float(v))
    reg.histogram("empty")
    return reg


def test_metrics_snapshots_equal_the_reference():
    got, want = _metric_ops(t_metrics), _metric_ops(j_metrics)
    assert got.snapshot() == want.snapshot()
    assert got.series() == want.series()
    assert got.snapshot()["hits{cache=a}"] == 3
    for q in (0.5, 0.9, 0.99):
        assert got.histogram("lat").percentile(q) == \
            want.histogram("lat").percentile(q)


def test_histogram_concurrent_observe_counts_every_sample():
    h = t_metrics.Histogram()

    def worker():
        for _ in range(1000):
            h.observe(0.001)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
        assert not t.is_alive()
    assert h.count == 4000
    assert h.sum == pytest.approx(4.0)


# ---------------------------------------------------------------------------
# features and the ledger


def test_features_and_ledger_rows_equal_the_reference(tmp_path):
    paths = [str(tmp_path / "ref.jsonl"), str(tmp_path / "port.jsonl")]
    ledgers = [j_ledger.CostLedger(paths[0]), t_ledger.CostLedger(paths[1])]
    (js, jm), (ts, tm) = _pair(ref={"ledger": ledgers[0]},
                               port={"ledger": ledgers[1]})
    for q in _queries(jm):
        q.collect()
    for q in _queries(tm):
        q.collect()
    for led in ledgers:
        led.close()
    want, got = (j_ledger.CostLedger.load_rows(p) for p in paths)
    assert len(got) == len(want) == len(_queries(tm))
    for g, w in zip(got, want):
        assert set(g) == set(w)
        assert g["schema"] == w["schema"] == 1
        for k in ("query", "plan_nodes", "mode", "n_workers", "exec_path"):
            assert g[k] == w[k], k
        assert g["predicted"]["features"] == w["predicted"]["features"]
        for k in ("flops", "comm_entries", "comm_bytes", "nnz"):
            assert g["predicted"][k] == pytest.approx(w["predicted"][k],
                                                      rel=1e-12), k
        assert set(g["measured"]) == set(w["measured"])
        assert g["measured"]["wall_s"] > 0
        assert g["measured"]["overflow"] is False
    # features straight from the same plans
    for jq, tq in zip(_queries(jm), _queries(tm)):
        assert t_cal.features_from_plan(ts.physical_plan(tq.plan)) == \
            j_cal.features_from_plan(js.physical_plan(jq.plan))


def test_warm_rerun_records_no_staging_time(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    led = CostLedger(path)
    s = Session(block_size=4, ledger=led, device="cpu")
    rng = np.random.default_rng(0)
    X = s.load(_sparse(rng, 8), name="X")
    q = X.t().multiply(X).trace()
    q.collect()
    q.collect()
    led.close()
    rows = CostLedger.load_rows(path)
    assert len(rows) == 2
    assert [r["exec_path"] for r in rows] == ["staged_sparse"] * 2
    assert rows[0]["predicted"]["flops"] > 0
    assert rows[1]["measured"]["compile_s"] == 0.0
    assert [r["measured"]["wall_s"] for r in rows] == \
        [r["measured"]["wall_s"] for r in led.rows()]


def test_ledger_summary_exec_path_and_comm_match_the_reference():
    class _Plan:
        n_nodes = 3
        mode = "dense"
        n_workers = 1
        est_flops = 100.0
        total_comm_est = 0.0

    summaries = []
    for mod in (j_ledger, t_ledger):
        led = mod.CostLedger()
        led.record(query="q", plan=_Plan(), exec_path="staged",
                   wall_s=0.01, measured_comm=0)
        s = led.summary()
        summaries.append((s["comm_ratio"], s["paths"], s["rows"]))
        for stats in ({"staged": 1}, {"staged_sparse": 2}, {"node_evals": 5}):
            assert mod.exec_path_of(stats) == j_ledger.exec_path_of(stats)
    assert summaries[0] == summaries[1]
    assert summaries[1][0] == 1.0
    assert t_ledger.measured_comm_bytes(None, {}, None) is None


def test_session_ledger_default_off():
    assert Session(block_size=4, device="cpu").ledger is None


# ---------------------------------------------------------------------------
# the calibrated cost model


def test_fit_gives_the_reference_coefficients():
    rows = [{"exec_path": "staged", "predicted": {"features": f},
             "measured": {"wall_s": w}} for f, w in _corpus()]
    jm, tm = j_cal.CostModel(), t_cal.CostModel()
    assert jm.fit_from_rows(rows, device="k") and \
        tm.fit_from_rows(rows, device="k")
    a, b = jm.model_for("k"), tm.model_for("k")
    for key in ("weights", "scale"):
        np.testing.assert_allclose(b[key], a[key], rtol=1e-6)
    assert b["intercept"] == pytest.approx(a["intercept"], rel=1e-6)
    assert b["unit_flops"] == pytest.approx(a["unit_flops"], rel=1e-6)
    assert b["rows"] == a["rows"] and tm.version == jm.version == 1
    f = _corpus(n=1, seed=9)[0][0]
    assert tm.predict(f, device="k") == \
        pytest.approx(jm.predict(f, device="k"), rel=1e-6)
    assert t_cal.FEATURES == j_cal.FEATURES


def test_blended_cost_and_chosen_plan_equal_the_reference():
    jm, tm = j_cal.CostModel(), t_cal.CostModel()
    (js, jmats), (ts, tmats) = _pair(seed=3, ref={"cost_model": jm},
                                     port={"cost_model": tm})
    assert t_cal.device_key(ts.device) == T_KEY
    assert jm.fit(_corpus(), device=j_cal.device_key())
    assert tm.fit(_corpus(), device=T_KEY)
    for jq, tq in zip(_queries(jmats), _queries(tmats)):
        want = j_cost.physical_cost(jq.plan, js)
        got = t_cost.physical_cost(tq.plan, ts)
        assert got.calibrated_s is not None and got.alpha < 1.0
        assert got.analytic == pytest.approx(want.analytic, rel=1e-6)
        assert got.calibrated_s == pytest.approx(want.calibrated_s,
                                                 rel=1e-6)
        assert got.total == pytest.approx(want.total, rel=1e-6)
        assert (got.alpha, got.breakdown()) == (want.alpha,
                                                want.breakdown())
        assert t_signature(ts.optimize_result(tq.plan).plan) == \
            j_signature(js.optimize_result(jq.plan).plan)


def test_fit_refuses_a_thin_corpus():
    model = t_cal.CostModel()
    assert not model.fit(_corpus(n=3))
    assert model.version == 0
    assert model.predict({k: 1.0 for k in t_cal.FEATURES}) is None
    assert model.alpha() == 1.0


def test_device_key_isolation_and_default():
    model = t_cal.CostModel()
    assert model.fit(_corpus(), device="tpu:v9|default")
    assert model.predict({k: 1.0 for k in t_cal.FEATURES},
                         device=T_KEY) is None
    assert model.alpha(device=T_KEY) == 1.0
    assert t_cal.device_key("cpu", backend="cuda") == "cpu:unknown|cuda"
    if not torch.cuda.is_available():
        assert t_cal.device_key() == T_KEY


def test_save_load_schema(tmp_path):
    path = str(tmp_path / "costmodel.json")
    model = t_cal.CostModel(path)
    assert model.fit(_corpus(), device=T_KEY)
    model.save()
    blob = json.loads((tmp_path / "costmodel.json").read_text())
    assert blob["_schema"] == 1
    assert list(blob["models"][T_KEY]["features"]) == list(t_cal.FEATURES)
    loaded = t_cal.CostModel.load(path)
    f = _corpus(n=1, seed=7)[0][0]
    assert loaded.predict(f, device=T_KEY) == \
        pytest.approx(model.predict(f, device=T_KEY))
    # the reference reads the port's file (one format for both)
    assert j_cal.CostModel(path).predict(f, device=T_KEY) == \
        pytest.approx(model.predict(f, device=T_KEY))
    (tmp_path / "bad.json").write_text(json.dumps({"_schema": 99}))
    assert t_cal.CostModel(str(tmp_path / "bad.json")).predict(
        f, device=T_KEY) is None


def test_refit_reoptimizes_and_explain_shows_the_blend():
    rng = np.random.default_rng(0)
    model = t_cal.CostModel()
    s = Session(block_size=8, cost_model=model, device="cpu")
    A = s.load(rng.normal(size=(16, 16)).astype(np.float32), "A")
    e = A.multiply(A).plan
    r1 = s.optimize_result(e)
    assert s.optimize_result(e) is r1
    assert r1.physical.calibrated_s is None and r1.physical.alpha == 1.0
    assert "calibrated=" not in A.multiply(A).explain(physical=True)
    assert model.fit(_corpus(), device=T_KEY)
    r2 = s.optimize_result(e)
    assert r2 is not r1 and r2.physical.calibrated_s is not None
    txt = A.multiply(A).explain(physical=True)
    assert "analytic=" in txt and "calibrated=" in txt and "alpha=" in txt


def test_calibrate_cli_fits_from_a_session_ledger(tmp_path):
    ledger_path = str(tmp_path / "ledger.jsonl")
    led = CostLedger(ledger_path)
    (_, _), (s, m) = _pair(port={"ledger": led})
    for q in _queries(m):
        q.collect()
    led.close()
    out = str(tmp_path / "costmodel.json")
    rc = t_cal._main(["fit", "--ledger", ledger_path, "--out", out,
                      "--device", T_KEY])
    assert rc == 0
    assert T_KEY in json.loads((tmp_path / "costmodel.json").read_text())[
        "models"]


# ---------------------------------------------------------------------------
# the engine's ledger rows, traces and online refit


def test_engine_trace_and_ledger(tmp_path):
    path = str(tmp_path / "serve_ledger.jsonl")
    led = CostLedger(path)
    s = Session(block_size=4, device="cpu")
    rng = np.random.default_rng(1)
    X = s.load(_sparse(rng, 8), name="X")
    q = X.t().multiply(X)
    with ServeEngine(s, n_threads=2, trace_sample=1.0,
                     ledger=led, ledger_root_hits=True) as eng:
        tickets = [eng.submit(q) for _ in range(4)]
        eng.drain(timeout=60.0)
        for t in tickets:
            t.result(timeout=60.0)
        snap = eng.snapshot()
    led.close()
    for t in tickets:
        assert t.trace is not None and t.trace.root.t1 is not None
    assert {"optimize", "lower", "execute"} <= \
        set(tickets[0].trace.phase_names())
    assert "execute" not in tickets[-1].trace.phase_names()
    assert snap["completed"] == 4
    assert snap["latency"]["count"] == snap["queue_wait"]["count"] == 4
    assert snap["latency"]["p99"] >= snap["latency"]["p50"] > 0
    rows = CostLedger.load_rows(path)
    assert len(rows) == 4
    assert {r["exec_path"] for r in rows} <= \
        {"staged_sparse", "staged", "eager", "root_hit"}
    assert all(r["trace_id"] for r in rows)


def test_engine_background_refit_fits_under_the_session_key():
    rng = np.random.default_rng(0)
    model = t_cal.CostModel()
    led = CostLedger()
    s = Session(block_size=8, cost_model=model, device="cpu")
    A = s.load(rng.normal(size=(16, 16)).astype(np.float32), "A")
    B = s.load(rng.normal(size=(16, 16)).astype(np.float32), "B")
    queries = [A.multiply(B), A.multiply(B).trace(), A.add(B),
               B.multiply(A), A.multiply(B).sum("r"), B.add(A),
               A.t().multiply(B), B.t().multiply(A), A.emul(B),
               A.multiply(B).add(1.0)]
    with ServeEngine(s, n_threads=2, ledger=led, refit_every=4,
                     cse=False) as eng:
        k1 = eng._state_key(s._env_version)
        for q in queries:
            eng.run(q, timeout=60.0)
        eng.drain(timeout=60.0)
        t = eng._refit_thread
        if t is not None:
            t.join(timeout=60.0)
            assert not t.is_alive()
        snap = eng.snapshot()
        k2 = eng._state_key(s._env_version)
    assert snap["refits"] >= 1 and snap["refit_rows"] >= 8
    assert model.version >= 1 and model.fitted_devices() == [T_KEY]
    assert k1 != k2                    # the model version keys the state


# ---------------------------------------------------------------------------
# measured collective bytes on a worker mesh


def _mesh_queries(s, mod):
    rng = np.random.default_rng(3)
    x = s.load(rng.normal(size=(32, 16)).astype(np.float32), "X")
    y = s.load(rng.normal(size=(16, 16)).astype(np.float32), "Y")
    add = mod.MergeFn("mc_add", lambda p, q: p + q)
    gram = x.t().multiply(x)
    return [gram, gram.join(y, "RID=CID AND CID=RID", add),
            x.multiply(y).sum("c"), gram.trace()]


@pytest.mark.parametrize("cse", [True, False])
def test_engine_measure_comm_rows_on_a_mesh(cse):
    """Four workers: every dense plan's row measures the bytes the scheme
    pass predicted, some of them nonzero; the summary ratio is 1."""
    from repro_torch.core import expr as t_expr
    s = Session(block_size=8, mode="dense", n_workers=4, device="cpu")
    queries = _mesh_queries(s, t_expr)
    led = CostLedger()
    with ServeEngine(s, cse=cse, n_threads=1, ledger=led,
                     measure_comm=True) as eng:
        for q in queries:
            eng.submit(q).result(timeout=120.0)
    rows = led.rows()
    assert len(rows) == len(queries)
    assert all(r["n_workers"] == 4 for r in rows)
    assert [r["measured"]["comm_bytes"] for r in rows] == \
        [r["predicted"]["comm_bytes"] for r in rows]
    assert any(r["measured"]["comm_bytes"] > 0 for r in rows)
    assert led.summary()["comm_ratio"] == 1.0
    if not cse:
        assert {r["exec_path"] for r in rows} == {"staged_spmd"}


def test_engine_measure_comm_is_zero_off_mesh_as_the_reference():
    from repro.core import expr as j_expr
    from repro.serve.engine import ServeEngine as JServeEngine
    from repro_torch.core import expr as t_expr
    measured = []
    for sess, mod, engine in (
            (JSession(block_size=8, mode="dense", n_workers=1), j_expr,
             JServeEngine),
            (Session(block_size=8, mode="dense", device="cpu"), t_expr,
             ServeEngine)):
        queries = _mesh_queries(sess, mod)
        led = (j_ledger if mod is j_expr else t_ledger).CostLedger()
        with engine(sess, cse=False, n_threads=1, ledger=led,
                    measure_comm=True) as eng:
            for q in queries:
                eng.submit(q).result(timeout=120.0)
        measured.append([(r["predicted"]["comm_bytes"],
                          r["measured"]["comm_bytes"]) for r in led.rows()])
    assert measured[0] == measured[1] == [(0.0, 0)] * 4
