"""Chaos suite of the port: its serving tier under injected faults, on
the CPU (the JAX package's ``tests/test_chaos_serve.py`` run on
``repro_torch``).

Every test drives a real ``ServeEngine`` against a deterministic fault
schedule (``runtime.faults``) and asserts the robustness contract:

* no hung clients — every submitted ticket reaches a terminal state
  within its timeout;
* no lost or double-counted completions — ``completed + errors ==
  submitted`` and each ticket finishes exactly once;
* graceful degradation — contained failures (prewarm, ledger IO,
  transient staged execution) still return correct results;
* supervision — a killed worker thread is detected, its batch is failed
  to the clients, and a replacement worker keeps the engine serving;
* the kernel breaker follows the port's rule: a failing or faulted
  ``cuda`` dispatch raises (there is no plain version to fall back to on
  a CUDA tensor), and at the threshold the backend is quarantined —
  dispatch then raises ``KernelQuarantined`` and launches nothing; a
  wrapper's refusal of its arguments feeds neither the breaker nor the
  retry ladder.

Every wait takes an explicit timeout.
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import Session
from repro_torch.kernels import registry as kreg
from repro_torch.obs.ledger import CostLedger
from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime import faults
from repro_torch.serve import workload as wl
from repro_torch.serve.engine import DeadlineExceeded, ServeEngine


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.uninstall()
    kreg.BREAKER.reset()
    yield
    faults.uninstall()
    kreg.BREAKER.reset()


def _mk(n=12, seed=0):
    rng = np.random.default_rng(seed)
    s = Session(block_size=4, device="cpu")
    mats = wl.synthetic_catalog(s, rng, n=n)
    return s, wl.query_templates(mats), rng


def _val(x):
    return getattr(x, "value", x).numpy()


def _count_finishes(eng):
    """Instrument ``_finish_ticket`` to count *effective* finishes per
    ticket (the exactly-once regression: crash containment layers may
    race to finish a ticket; only one may win)."""
    finishes = {}
    orig = eng._finish_ticket

    def counted(ticket, result=None, error=None):
        before = ticket.done()
        orig(ticket, result=result, error=error)
        if not before and ticket.done():
            finishes[id(ticket)] = finishes.get(id(ticket), 0) + 1
    eng._finish_ticket = counted
    return finishes


# ---------------------------------------------------------------------------
# batch stranding regression (satellite a)


def test_prewarm_fault_is_contained_per_batch():
    # regression: an exception in the batched leaf prewarm used to escape
    # the per-ticket try, kill the worker loop, and strand every ticket
    # in the batch forever. Now it degrades to un-prewarmed execution.
    s, templates, _ = _mk()
    serial = {name: _val(s.execute(expr)) for name, expr in templates}
    with faults.inject("prewarm"):           # fires on every batch
        with ServeEngine(s, cse=True, n_threads=2) as eng:
            finishes = _count_finishes(eng)
            tickets = [(name, eng.submit(expr))
                       for name, expr in templates]
            for name, t in tickets:
                np.testing.assert_allclose(
                    _val(t.result(timeout=120.0)), serial[name],
                    rtol=1e-4, atol=1e-4)
            snap = eng.snapshot()
    assert snap["prewarm_failures"] >= 1
    assert snap["errors"] == 0
    assert snap["completed"] == len(tickets) == len(finishes)
    assert set(finishes.values()) == {1}     # exactly once, every ticket
    assert faults.stats() == {}              # uninstalled on exit


def test_batch_level_failure_finishes_every_ticket():
    # a failure between dequeue and the per-ticket loop (here: the
    # worker-scope seam, standing in for a version-snapshot crash) must
    # error the whole batch out to its clients, not strand it
    s, templates, _ = _mk()
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        finishes = _count_finishes(eng)
        with faults.inject("worker:times=1"):
            tickets = [eng.submit(expr) for _, expr in templates[:4]]
            outcomes = []
            for t in tickets:
                try:
                    t.result(timeout=60.0)
                    outcomes.append("ok")
                except faults.FaultInjected:
                    outcomes.append("fault")
        snap = eng.snapshot()
    assert "fault" in outcomes               # the schedule really fired
    assert snap["batch_failures"] >= 1
    assert snap["completed"] + snap["errors"] == len(tickets)
    assert len(finishes) == len(tickets)
    assert set(finishes.values()) == {1}


# ---------------------------------------------------------------------------
# worker supervision (tentpole hardening 1)


def test_worker_kill_restarts_and_engine_keeps_serving():
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    serial = _val(s.execute(expr))
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        with faults.inject("worker:kind=kill,times=1"):
            t = eng.submit(expr)
            # the kill is a BaseException: batch containment lets it
            # through, the worker thread dies, and _worker_exit fails the
            # stranded batch out to us as a plain RuntimeError
            with pytest.raises(RuntimeError, match="died"):
                t.result(timeout=60.0)
        # fault exhausted: the replacement worker serves the retry
        got = _val(eng.run(expr, timeout=120.0))
        snap = eng.snapshot()
    np.testing.assert_allclose(got, serial, rtol=1e-4, atol=1e-4)
    assert snap["worker_crashes"] == 1
    assert snap["worker_restarts"] == 1
    assert snap["completed"] + snap["errors"] == snap["submitted"] == 2


def test_killed_worker_is_replaced_in_monitor_and_straggler():
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    with ServeEngine(s, cse=True, n_threads=2) as eng:
        with faults.inject("worker:kind=kill,times=1"):
            t = eng.submit(expr)
            with pytest.raises(RuntimeError):
                t.result(timeout=60.0)
        eng.run(expr, timeout=120.0)
        with eng._ft_lock:
            alive = set(eng._monitor.nodes)
            tracked = set(eng._straggler.times)
    # two workers remain, one of them the w2 replacement
    assert len(alive) == 2
    assert alive == tracked
    assert "w2" in alive


# ---------------------------------------------------------------------------
# deadlines + client timeout (tentpole hardening 2, satellite b)


def test_deadline_exceeded_at_plan_checkpoint():
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        t = eng.submit(expr, tenant="acme", deadline_s=0.0)
        with pytest.raises(DeadlineExceeded) as ei:
            t.result(timeout=60.0)
        snap = eng.snapshot()
    msg = str(ei.value)
    assert "tenant='acme'" in msg and "trace_id" in msg
    assert snap["deadline_exceeded"] == 1
    assert snap["errors"] == 1 and snap["completed"] == 0


def test_engine_default_deadline_applies_to_submit():
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    with ServeEngine(s, cse=True, n_threads=1, deadline_s=0.0) as eng:
        with pytest.raises(DeadlineExceeded):
            eng.run(expr, timeout=60.0)
        # per-submit override beats the engine default
        _val(eng.run(expr, deadline_s=120.0, timeout=120.0))


def test_client_timeout_default_and_message():
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    gate = threading.Event()
    eng = ServeEngine(s, cse=True, n_threads=1, default_timeout_s=0.05)
    orig = eng._execute
    eng._execute = lambda state, ticket, lw: (gate.wait(30.0),
                                              orig(state, ticket, lw))
    try:
        t = eng.submit(expr, tenant="slowpoke")
        with pytest.raises(TimeoutError, match="tenant='slowpoke'") as ei:
            t.result()                       # engine default: 0.05s
        assert "trace_id" in str(ei.value)
        assert not isinstance(ei.value, DeadlineExceeded)  # client-side
        gate.set()
        t.result(timeout=120.0)              # same ticket, later: fine
    finally:
        gate.set()
        eng.close()


# ---------------------------------------------------------------------------
# retry + degradation ladder (tentpole hardening 3)


def test_transient_execute_fault_is_retried():
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    serial = _val(s.execute(expr))
    with faults.inject("execute:times=1"):
        with ServeEngine(s, cse=False, n_threads=1) as eng:
            got = _val(eng.run(expr, timeout=120.0))
            snap = eng.snapshot()
    np.testing.assert_allclose(got, serial, rtol=1e-4, atol=1e-4)
    assert snap["exec_retries"] >= 1
    assert snap["degraded_eager"] == 0
    assert snap["errors"] == 0


def test_persistent_staged_failure_degrades_to_eager():
    # stage_compile fires on every staged attempt: the retry loop
    # exhausts, then execution falls down the ladder to the per-node
    # eager path — which never touches the staged-compile seam — and the
    # client still gets the right answer
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    serial = _val(s.execute(expr))
    with faults.inject("stage_compile") as plan:
        with ServeEngine(s, cse=False, n_threads=1,
                         retry_backoff_s=0.0) as eng:
            got = _val(eng.run(expr, timeout=120.0))
            snap = eng.snapshot()
        fired = plan.stats()["stage_compile"]["fires"]
    np.testing.assert_allclose(got, serial, rtol=1e-4, atol=1e-4)
    assert fired >= eng.exec_retries + 1     # every attempt was faulted
    assert snap["degraded_eager"] == 1
    assert snap["errors"] == 0 and snap["completed"] == 1


def test_deterministic_errors_are_not_retried():
    s, templates, _ = _mk()
    with ServeEngine(s, cse=True, n_threads=1) as eng:
        with pytest.raises(TypeError):
            eng.submit("not a plan")
        snap = eng.snapshot()
    assert snap["exec_retries"] == 0
    assert snap["submitted"] == 0            # rejected before admission


# ---------------------------------------------------------------------------
# ledger / refit isolation (tentpole hardening 5)


def test_ledger_io_faults_drop_and_count_without_failing_queries(tmp_path):
    s, templates, _ = _mk()
    expr = dict(templates)["gram"]
    ledger = CostLedger(path=str(tmp_path / "ledger.jsonl"))
    with faults.inject("ledger_io"):
        with ServeEngine(s, cse=False, n_threads=1, ledger=ledger) as eng:
            _val(eng.run(expr, timeout=120.0))
            _val(eng.run(expr, timeout=120.0))
            snap = eng.snapshot()
    assert snap["errors"] == 0 and snap["completed"] == 2
    assert ledger.dropped_writes == 2        # every disk append dropped
    assert len(ledger) == 2                  # in-memory corpus intact
    assert ledger.summary()["dropped_writes"] == 2
    ledger.close()
    assert (tmp_path / "ledger.jsonl").read_text() == ""


def test_refit_crash_is_counted_and_trigger_stays_armed():
    s, templates, _ = _mk()
    s.cost_model = type("M", (), {"version": 1})()
    ledger = CostLedger()
    with ServeEngine(s, cse=False, n_threads=1, ledger=ledger,
                     refit_every=1) as eng:
        with faults.inject("refit"):
            eng._refit(ledger.rows())        # the background thread body
        snap = eng.snapshot()
        # the crash rewound the trigger: the next ledgered row may refit
        assert eng._refit_last_at <= eng._refit_rows_seen
    assert snap["refit_crashes"] == 1
    assert snap["refits"] == 0


# ---------------------------------------------------------------------------
# kernel circuit breaker (tentpole hardening 4)


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_breaker_trips_half_opens_and_closes():
    clock = _Clock()
    br = kreg.CircuitBreaker(threshold=3, cooldown_s=30.0, clock=clock)
    b = kreg.CUDA
    assert br.state(b) == "closed" and not br.quarantined(b)
    for _ in range(3):
        br.record_failure(b)
    assert br.state(b) == "open" and br.quarantined(b)
    clock.t = 31.0
    assert br.state(b) == "half-open"
    assert not br.quarantined(b)             # this caller is the probe
    assert br.quarantined(b)                 # concurrent callers are not
    br.record_success(b)                     # probe succeeds → closed
    assert br.state(b) == "closed" and not br.quarantined(b)


def test_breaker_failed_probe_reopens_with_fresh_cooldown():
    clock = _Clock()
    br = kreg.CircuitBreaker(threshold=3, cooldown_s=30.0, clock=clock)
    b = kreg.CUDA
    for _ in range(3):
        br.record_failure(b)
    clock.t = 31.0
    assert not br.quarantined(b)             # probe admitted
    br.record_failure(b)                     # probe fails → re-open
    assert br.state(b) == "open"
    clock.t = 60.0
    assert br.quarantined(b)                 # fresh cooldown from t=31
    clock.t = 62.0
    assert not br.quarantined(b)


def test_breaker_success_resets_consecutive_count():
    br = kreg.CircuitBreaker(threshold=3, cooldown_s=30.0, clock=_Clock())
    b = kreg.CUDA
    br.record_failure(b)
    br.record_failure(b)
    br.record_success(b)                     # streak broken
    br.record_failure(b)
    br.record_failure(b)
    assert br.state(b) == "closed"           # 2 < threshold again


def test_breaker_never_quarantines_torch():
    br = kreg.CircuitBreaker(threshold=1, cooldown_s=30.0, clock=_Clock())
    br.record_failure(kreg.TORCH)
    assert not br.quarantined(kreg.TORCH)
    assert br.state(kreg.TORCH) == "closed"


def test_faulted_dispatch_raises_then_quarantines(rng, monkeypatch):
    """The port's rule on a ``cuda``-named backend: a faulted dispatch
    raises (it never falls back to the plain version), each failure is
    counted and feeds the breaker, and once the breaker is open dispatch
    raises ``KernelQuarantined`` without calling the kernel. The CUDA
    entry is a recording stand-in (this test runs without a card) and
    the tensors are claimed to be on the card."""
    clock = _Clock()
    monkeypatch.setattr(kreg, "BREAKER", kreg.CircuitBreaker(
        threshold=3, cooldown_s=30.0, clock=clock))
    spec = kreg.get("masked_matmul")
    plain = spec.impls[kreg.TORCH]
    calls = {"cuda": 0, "torch": 0}

    def fake_cuda(*args, **kw):
        calls["cuda"] += 1
        return plain(*args, **kw)

    def spy_plain(*args, **kw):
        calls["torch"] += 1
        return plain(*args, **kw)

    monkeypatch.setitem(spec.impls, kreg.CUDA, fake_cuda)
    monkeypatch.setitem(spec.impls, kreg.TORCH, spy_plain)
    monkeypatch.setattr(kreg, "_device_of",
                        lambda args: torch.device("cuda"))
    a = torch.as_tensor(rng.normal(size=(32, 16)), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(16, 32)), dtype=torch.float32)
    mask = torch.ones((2, 2), dtype=torch.bool)
    labels = {"kernel": "masked_matmul", "backend": kreg.CUDA}
    f0 = REGISTRY.counter("kernel_dispatch_failures", **labels).value
    q0 = REGISTRY.counter("kernel_dispatch_quarantined", **labels).value
    with faults.inject("kernel_dispatch:backend=cuda") as plan:
        for _ in range(3):                   # threshold consecutive faults
            with pytest.raises(faults.FaultInjected):
                kreg.dispatch("masked_matmul", a, b, mask, block_size=16)
        assert kreg.BREAKER.state(kreg.CUDA) == "open"
        with pytest.raises(kreg.KernelQuarantined):
            kreg.dispatch("masked_matmul", a, b, mask, block_size=16)
        assert plan.stats()["kernel_dispatch"] == {"calls": 3, "fires": 3}
    assert calls == {"cuda": 0, "torch": 0}  # nothing ran, no plain version
    assert REGISTRY.counter("kernel_dispatch_failures",
                            **labels).value == f0 + 3
    assert REGISTRY.counter("kernel_dispatch_quarantined",
                            **labels).value == q0 + 1
    clock.t = 31.0                           # half-open: one probe runs
    got = kreg.dispatch("masked_matmul", a, b, mask, block_size=16)
    np.testing.assert_allclose(got.numpy(), (a @ b).numpy(), rtol=1e-5,
                               atol=1e-5)
    assert calls == {"cuda": 1, "torch": 0}
    assert kreg.BREAKER.state(kreg.CUDA) == "closed"


def _cubic(x, y):                           # degree 3: no kernel evaluates it
    return x * x * y


def _prod(x, y):
    return x * y


def _overlay_operands(seed=0):
    """A CPU session and two 16×16 operands whose overlay is a
    block-skip ``merge_join`` (9 of 16 blocks live)."""
    rng = np.random.default_rng(seed)
    s = Session(block_size=4, device="cpu")
    a = rng.normal(size=(16, 16)).astype(np.float32)
    b = rng.normal(size=(16, 16)).astype(np.float32)
    a[:4, :] = 0.0
    b[:, :4] = 0.0
    return s, a, b, s.load(a, "A"), s.load(b, "B")


def _refusing_card_merge_join(monkeypatch):
    """Every device is claimed to run on ``cuda`` (the test runs without a
    card) and the ``cuda`` ``merge_join`` is a stand-in that refuses as the
    card's wrapper does (``ValueError`` for masks of another grid,
    ``merge_code``'s ``NotImplementedError`` for a merge outside the
    kernels' family) and otherwise records the launch and runs the plain
    version. Returns the list of launches."""
    from repro_torch.kernels.merge_codes import merge_code
    spec = kreg.get("merge_join")
    plain = spec.impls[kreg.TORCH]
    launches = []

    def fake_cuda(a, b, mask_a, mask_b, *, merge, **kw):
        if mask_a.shape != mask_b.shape:
            raise ValueError("masks of different grids")
        merge_code(merge)
        launches.append(getattr(merge, "__name__", merge))
        return plain(a, b, mask_a, mask_b, merge=merge, **kw)

    monkeypatch.setitem(spec.impls, kreg.CUDA, fake_cuda)
    monkeypatch.setattr(kreg, "backend_for", lambda device: kreg.CUDA)
    return launches


def test_refused_dispatch_feeds_no_breaker(monkeypatch):
    """A wrapper's refusal of its arguments (an unsupported merge, a bad
    shape) raises, is not counted as a dispatch failure and leaves the
    breaker as it was; a refused half-open probe hands the probe on."""
    clock = _Clock()
    monkeypatch.setattr(kreg, "BREAKER", kreg.CircuitBreaker(
        threshold=3, cooldown_s=30.0, clock=clock))
    launches = _refusing_card_merge_join(monkeypatch)
    _, a, b, _, _ = _overlay_operands()
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    ma, mb = torch.ones((4, 4), dtype=torch.bool), torch.ones(
        (4, 4), dtype=torch.bool)
    labels = {"kernel": "merge_join", "backend": kreg.CUDA}
    f0 = REGISTRY.counter("kernel_dispatch_failures", **labels).value
    for _ in range(4):                       # past the threshold
        with pytest.raises(NotImplementedError):
            kreg.dispatch("merge_join", a, b, ma, mb, merge=_cubic,
                          block_size=4)
    with pytest.raises(ValueError):          # masks of the wrong grid
        kreg.dispatch("merge_join", a, b, ma[:2], mb, merge=_prod,
                      block_size=4)
    assert kreg.BREAKER.state(kreg.CUDA) == "closed"
    assert REGISTRY.counter("kernel_dispatch_failures",
                            **labels).value == f0
    assert launches == []
    for _ in range(3):                       # real failures open it
        kreg.BREAKER.record_failure(kreg.CUDA)
    clock.t = 31.0
    with pytest.raises(NotImplementedError):  # the probe is refused ...
        kreg.dispatch("merge_join", a, b, ma, mb, merge=_cubic,
                      block_size=4)
    assert kreg.BREAKER.state(kreg.CUDA) == "half-open"
    got = kreg.dispatch("merge_join", a, b, ma, mb, merge=_prod,
                        block_size=4)       # ... so the next caller probes
    np.testing.assert_allclose(got.numpy(), (a * b).numpy(), rtol=1e-6)
    assert kreg.BREAKER.state(kreg.CUDA) == "closed"
    assert launches == ["_prod"]


def test_unsupported_merges_do_not_quarantine_the_card(monkeypatch):
    """Three tickets whose overlay the card's kernel cannot evaluate each
    fail alone, without retries or the eager ladder; the breaker stays
    closed, and another tenant's supported overlay still runs on the
    ``cuda`` backend."""
    monkeypatch.setattr(kreg, "BREAKER", kreg.CircuitBreaker(
        threshold=3, cooldown_s=30.0))
    launches = _refusing_card_merge_join(monkeypatch)
    s, a, b, A, B = _overlay_operands()
    with ServeEngine(s, cse=False, n_threads=1, retry_backoff_s=0.0) as eng:
        for _ in range(3):
            with pytest.raises(NotImplementedError):
                eng.run(A.join(B, "RID=RID AND CID=CID", _cubic),
                        tenant="t0", timeout=60.0)
        got = eng.run(A.join(B, "RID=RID AND CID=CID", _prod),
                      tenant="t1", timeout=60.0)
        snap = eng.snapshot()
    np.testing.assert_allclose(_val(got), a * b, rtol=1e-6)
    assert kreg.BREAKER.state(kreg.CUDA) == "closed"
    assert launches == ["_prod"]
    assert snap["exec_retries"] == 0 and snap["degraded_eager"] == 0
    assert snap["errors"] == 3 and snap["completed"] == 1


def test_faulted_torch_dispatch_raises_into_the_ticket():
    """The plain backend is never quarantined: a fault on every CPU
    dispatch fails the staged attempts, the eager bottom of the ladder
    too, and the ticket finishes with the fault — nothing hangs."""
    rng = np.random.default_rng(0)
    s = Session(block_size=4, device="cpu")
    a = rng.normal(size=(16, 16)).astype(np.float32)
    a[:, :12] = 0.0                          # a quarter of the blocks live
    A = s.load(a, "A")
    W = s.load(rng.normal(size=(16, 4)).astype(np.float32), "W")
    H = s.load(rng.normal(size=(4, 16)).astype(np.float32), "H")
    expr = A.emul(W.multiply(H))             # masked_matmul on every path
    with faults.inject("kernel_dispatch:backend=torch"):
        with ServeEngine(s, cse=False, n_threads=1,
                         retry_backoff_s=0.0) as eng:
            with pytest.raises(faults.FaultInjected):
                eng.run(expr, timeout=60.0)
            snap = eng.snapshot()
    assert snap["errors"] == 1 and snap["completed"] == 0
    assert not kreg.BREAKER.quarantined(kreg.TORCH)


# ---------------------------------------------------------------------------
# the full storm


def test_mixed_fault_schedule_loses_nothing(tmp_path):
    # compile faults + prewarm faults + flaky ledger IO, concurrently,
    # against the invariants the CI chaos job gates on: every ticket
    # terminal, completed + errors == submitted, results that do complete
    # are correct
    s, templates, _ = _mk()
    serial = {name: _val(s.execute(expr)) for name, expr in templates}
    ledger = CostLedger(path=str(tmp_path / "ledger.jsonl"))
    schedule = ("stage_compile:p=0.5,seed=3;prewarm:every=2;"
                "ledger_io:p=0.5,seed=5")
    with faults.inject(schedule) as plan:
        with ServeEngine(s, cse=True, n_threads=2, ledger=ledger,
                         retry_backoff_s=0.0) as eng:
            finishes = _count_finishes(eng)
            tickets = [(name, eng.submit(expr))
                       for name, expr in templates for _ in range(3)]
            failures = 0
            for name, t in tickets:
                try:
                    got = _val(t.result(timeout=120.0))
                except Exception:
                    failures += 1
                else:
                    np.testing.assert_allclose(got, serial[name],
                                               rtol=1e-4, atol=1e-4)
            snap = eng.snapshot()
        stats = plan.stats()
    assert sum(v["fires"] for v in stats.values()) > 0   # storm was real
    assert snap["submitted"] == len(tickets)
    assert snap["completed"] + snap["errors"] == len(tickets)
    assert snap["errors"] == failures
    assert len(finishes) == len(tickets)
    assert set(finishes.values()) == {1}                 # exactly once
    ledger.close()
