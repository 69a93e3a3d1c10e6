"""The port's serving tier on the CPU: the JAX package's engine contract
(``tests/test_serve_engine.py``) run on ``repro_torch.serve.engine``, and
the port's engine against the reference engine on the same seeded
catalog and stream.

The engine contract: any stream of submissions, from any number of
client threads, returns exactly the results serial ``Session.execute``
would — cross-query CSE, batching and version retirement are invisible
except in the stats counters. Against the reference: f32 values atol
1e-5, reductions (trace, row/column sums) rtol 1e-4; with one worker
thread the CSE counters are equal."""
import threading

import numpy as np
import pytest

from repro.core import Session as JSession
from repro.serve import workload as j_wl
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core import Session
from repro_torch.serve import workload as wl
from repro_torch.serve.engine import AdmissionError, ServeEngine

REDUCTIONS = {"gram_trace", "gram_rowsum", "xy_colsum"}


def _mk(n=16, seed=0):
    rng = np.random.default_rng(seed)
    s = Session(block_size=4, device="cpu")
    mats = wl.synthetic_catalog(s, rng, n=n)
    return s, wl.query_templates(mats), rng


def _val(x):
    v = getattr(x, "value", x)
    return v.numpy() if hasattr(v, "numpy") else np.asarray(v)


# ---------------------------------------------------------------------------
# parity: engine results == serial collect, cse on and off


@pytest.mark.parametrize("cse", [True, False])
def test_engine_matches_serial_execute(cse):
    s, templates, _rng = _mk()
    serial = {name: _val(s.execute(expr)) for name, expr in templates}
    with ServeEngine(s, cse=cse, n_threads=2) as eng:
        tickets = [(name, eng.submit(expr)) for name, expr in templates
                   for _ in range(3)]
        for name, t in tickets:
            got = _val(t.result(timeout=120.0))
            np.testing.assert_allclose(got, serial[name],
                                       rtol=1e-4, atol=1e-4)
        snap = eng.snapshot()
    assert snap["completed"] == len(tickets)
    assert snap["errors"] == 0


# ---------------------------------------------------------------------------
# CSE accounting


def test_repeat_query_is_root_hit():
    s, templates, _rng = _mk()
    expr = dict(templates)["gram"]
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        r1 = _val(eng.run(expr, timeout=120.0))
        r2 = _val(eng.run(expr, timeout=120.0))
        snap = eng.snapshot()
    np.testing.assert_allclose(r1, r2)
    assert snap["root_hits"] >= 1
    assert snap["result_cache"]["hits"] >= 1


def test_overlapping_templates_share_arena_nodes():
    s, templates, _rng = _mk()
    by = dict(templates)
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        for name in ("gram", "gram_trace", "gram_rowsum", "gram_shift"):
            eng.run(by[name], timeout=120.0)
        snap = eng.snapshot()
    assert snap["inter_query_cse_nodes"] > 0
    assert snap["arena_nodes"] > 0
    assert snap["leaf_scans"] < snap["leaf_refs"]  # batched leaf dedupe


def test_no_cse_has_no_sharing():
    s, templates, _rng = _mk()
    expr = dict(templates)["gram"]
    with ServeEngine(s, cse=False, n_threads=1) as eng:
        eng.run(expr, timeout=120.0)
        eng.run(expr, timeout=120.0)
        snap = eng.snapshot()
    assert snap["root_hits"] == 0
    assert snap["inter_query_cse_nodes"] == 0


# ---------------------------------------------------------------------------
# admission control


def test_queue_full_rejects():
    s, templates, _rng = _mk(n=8)
    expr = dict(templates)["gram"]
    with ServeEngine(s, cse=True, n_threads=1, max_queue=0) as eng:
        with pytest.raises(AdmissionError):
            eng.submit(expr)
        assert eng.snapshot()["rejected_queue"] == 1


def test_tenant_inflight_budget_rejects():
    s, templates, _rng = _mk(n=8)
    expr = dict(templates)["gram"]
    gate = threading.Event()
    eng = ServeEngine(s, cse=True, n_threads=1, tenant_max_inflight=2)
    orig = eng._execute

    def gated(state, ticket, lw):
        gate.wait(30.0)
        orig(state, ticket, lw)

    eng._execute = gated
    try:
        t1 = eng.submit(expr, tenant="a")
        t2 = eng.submit(expr, tenant="a")
        with pytest.raises(AdmissionError):
            eng.submit(expr, tenant="a")      # over budget while in flight
        t3 = eng.submit(expr, tenant="b")     # other tenants unaffected
        gate.set()
        for t in (t1, t2, t3):
            t.result(timeout=120.0)
        assert eng.snapshot()["rejected_tenant"] == 1
    finally:
        gate.set()
        eng.close()


# ---------------------------------------------------------------------------
# catalog versioning: rebind retires shared results


def test_rebind_gives_fresh_results_not_stale_cache():
    rng = np.random.default_rng(7)
    s = Session(block_size=4, device="cpu")
    a = rng.normal(size=(8, 8)).astype(np.float32)
    A = s.load(a, "A")
    q = A.t().multiply(A)
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        r1 = _val(eng.run(q, timeout=120.0))
        np.testing.assert_allclose(r1, a.T @ a, rtol=1e-4, atol=1e-4)
        b = rng.normal(size=(8, 8)).astype(np.float32)
        s.load(b, "A")                        # bump catalog version
        r2 = _val(eng.run(q, timeout=120.0))
        np.testing.assert_allclose(r2, b.T @ b, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# concurrency smoke: many client threads, overlapping plans


@pytest.mark.parametrize("cse", [True, False])
def test_concurrent_clients_match_serial(cse):
    s, templates, rng = _mk()
    serial = {name: _val(s.execute(expr)) for name, expr in templates}
    stream = wl.client_stream(rng, templates, n_clients=60, n_tenants=4)
    errs = []

    with ServeEngine(s, cse=cse, n_threads=2) as eng:
        def client(chunk):
            try:
                for tenant, name, expr in chunk:
                    got = _val(eng.run(expr, tenant=tenant, timeout=120.0))
                    np.testing.assert_allclose(got, serial[name],
                                               rtol=1e-4, atol=1e-4)
            except Exception as e:            # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=client, args=(stream[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
            assert not t.is_alive()
        snap = eng.snapshot()
    assert not errs
    assert snap["completed"] == len(stream)
    assert snap["errors"] == 0
    if cse:
        assert snap["root_hits"] > 0          # hot zipf templates repeat


def test_concurrent_rebind_no_version_races():
    rng = np.random.default_rng(11)
    s = Session(block_size=4, device="cpu")
    a = rng.normal(size=(8, 8)).astype(np.float32)
    A = s.load(a, "A")
    q = A.add(A)
    errs = []
    with ServeEngine(s, cse=True, n_threads=2) as eng:
        def client():
            try:
                for _ in range(30):
                    _val(eng.run(q, timeout=120.0))
            except Exception as e:            # pragma: no cover
                errs.append(e)

        def rebinder():
            try:
                for i in range(10):
                    s.load(a * (i + 2), "A")
            except Exception as e:            # pragma: no cover
                errs.append(e)

        ts = [threading.Thread(target=client) for _ in range(3)]
        ts.append(threading.Thread(target=rebinder))
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120.0)
            assert not t.is_alive()
        final = _val(eng.run(q, timeout=120.0))
        snap = eng.snapshot()
    assert not errs
    assert snap["errors"] == 0
    np.testing.assert_allclose(final, (a * 11) + (a * 11),
                               rtol=1e-4, atol=1e-4)


def test_closed_engine_rejects_submit():
    s, templates, _rng = _mk(n=8)
    eng = ServeEngine(s, n_threads=1)
    eng.close()
    with pytest.raises(RuntimeError):
        eng.submit(dict(templates)["gram"])


# ---------------------------------------------------------------------------
# against the reference engine


def _both(n, block_size=4, seed=0):
    """The same seeded catalog and templates in both packages."""
    out = []
    for sess, mod in ((JSession(block_size=block_size), j_wl),
                      (Session(block_size=block_size, device="cpu"), wl)):
        rng = np.random.default_rng(seed)
        mats = mod.synthetic_catalog(sess, rng, n=n)
        out.append((sess, mod.query_templates(mats), rng))
    return out


@pytest.mark.parametrize("cse", [True, False])
def test_each_template_matches_the_reference_engine(cse):
    (js, jt, _), (ts, tt, _) = _both(n=32, block_size=8)
    results = []
    for sess, templates, Engine in ((js, jt, JServeEngine),
                                    (ts, tt, ServeEngine)):
        with Engine(sess, cse=cse, n_threads=2) as eng:
            tickets = [(name, eng.submit(expr)) for name, expr in templates]
            results.append({name: _val(t.result(timeout=120.0))
                            for name, t in tickets})
    want, got = results
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        if name in REDUCTIONS:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        else:
            np.testing.assert_allclose(got[name], want[name], atol=1e-5,
                                       rtol=1e-5, err_msg=name)


COUNTERS = ("submitted", "completed", "errors", "root_hits",
            "inter_query_cse_nodes", "leaf_scans", "leaf_refs", "arena_nodes",
            "node_reuses", "node_evals")


def test_single_thread_counters_equal_the_reference():
    """The launcher's stream (``--clients 200 --dim 24 --threads 1``)
    through both engines: the CSE accounting is the same number for
    number, with CSE on and off."""
    (js, jt, jrng), (ts, tt, trng) = _both(n=24, block_size=8)
    jstream = j_wl.client_stream(jrng, jt, n_clients=200, n_tenants=8)
    tstream = wl.client_stream(trng, tt, n_clients=200, n_tenants=8)
    assert [(t, n) for t, n, _ in tstream] == [(t, n) for t, n, _ in jstream]
    for cse in (True, False):
        want = j_wl.run_workload(js, jstream, cse=cse, n_threads=1)
        got = wl.run_workload(ts, tstream, cse=cse, n_threads=1)
        for key in ("queries", "failures", "hung"):
            assert got[key] == want[key], key
        for key in COUNTERS:
            assert got["stats"][key] == want["stats"][key], (cse, key)
        if cse:
            assert got["stats"]["root_hits"] == 200
            assert got["stats"]["inter_query_cse_nodes"] > 0
            assert got["stats"]["leaf_scans"] < got["stats"]["leaf_refs"]


# ---------------------------------------------------------------------------
# the launcher


def test_launcher_serves_on_the_cpu_and_reports_the_cse_counters(capsys):
    from repro_torch.launch import serve
    rc = serve.main(["--relational", "--device", "cpu", "--clients", "200",
                     "--dim", "24", "--threads", "2", "--assert-complete"])
    out = capsys.readouterr().out
    assert rc == 0, out
    on = next(line for line in out.splitlines() if "cse=on" in line)
    fields = dict(f.split("=", 1) for f in on.split()[2:])
    assert fields["root_hits"] == "200"
    assert int(fields["shared_nodes"]) > 0
    scans, refs = map(int, fields["leaf_scans"].split("/"))
    assert scans * 10 < refs
    assert "completeness: all tickets terminal" in out


def test_launcher_without_a_card_raises(monkeypatch):
    import torch
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--relational", "--clients", "4", "--dim", "8"])
