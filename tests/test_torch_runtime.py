"""The port's runtime trio against the JAX package's, on the CPU.

One fault-schedule string must drive both packages the same way (the
``REPRO_FAULTS`` grammar, ``install``/``inject``/``check``/``stats``,
``FaultInjected`` and ``WorkerKilled``), and the heartbeat monitor, the
restart policy, the straggler detector and the elastic re-plan must walk
the same states on the same scripted inputs. Everything here is exact:
fire patterns, stats, states; z-scores within 1e-12."""
import numpy as np
import pytest

from repro.runtime import elastic as j_elastic
from repro.runtime import fault_tolerance as j_ft
from repro.runtime import faults as j_faults
from repro.runtime import straggler as j_straggler
from repro_torch.runtime import elastic as t_elastic
from repro_torch.runtime import fault_tolerance as t_ft
from repro_torch.runtime import faults as t_faults
from repro_torch.runtime import straggler as t_straggler

PACKAGES = ((j_faults, j_ft, j_straggler), (t_faults, t_ft, t_straggler))


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(t_faults.ENV, raising=False)
    for mod in (j_faults, t_faults):
        mod.uninstall()
    yield
    for mod in (j_faults, t_faults):
        mod.uninstall()


def _drive(faults, text, calls):
    """Run ``calls`` ((scope, attrs) pairs) against a parsed plan; return
    the outcome of each call and the plan's stats."""
    plan = faults.parse(text)
    out = []
    for scope, attrs in calls:
        try:
            plan.check(scope, attrs)
            out.append("pass")
        except faults.WorkerKilled:
            out.append("kill")
        except faults.FaultInjected as e:
            out.append(f"fault:{e}")
    return out, plan.stats()


_CALLS = ([("stage_compile", {"mode": "sparse", "spmd": False})] * 7
          + [("kernel_dispatch", {"kernel": "masked_matmul",
                                  "backend": b}) for b in
             ("cuda", "torch", "cuda", "cuda", "torch", "cuda")]
          + [("worker", {"worker": f"w{i % 2}"}) for i in range(6)]
          + [("prewarm", {"worker": "w0"})] * 5
          + [("ledger_io", {})] * 4 + [("execute", {"attempt": 0})] * 40
          + [("refit", {})] * 3)


@pytest.mark.parametrize("text", [
    "stage_compile",
    "prewarm:every=2",
    "execute:after=2,times=3",
    "execute:p=0.4,seed=11",
    "execute:p=0.0",
    "kernel_dispatch:backend=cuda,every=2",
    "worker:worker=w1,kind=kill,times=1",
    "stage_compile:p=0.5,seed=3;prewarm:every=2;ledger_io:p=0.5,seed=5",
    ";; refit:times=2 ;",
])
def test_fault_schedule_fires_as_the_reference(text):
    want = _drive(j_faults, text, _CALLS)
    got = _drive(t_faults, text, _CALLS)
    assert got == want
    assert any(o != "pass" for o in got[0]) or "p=0.0" in text


@pytest.mark.parametrize("text,match", [
    ("not_a_seam:p=0.5", "unknown fault scope"),
    ("prewarm:banana", "malformed fault item"),
    ("worker:kind=maim", "unknown fault kind"),
])
def test_parse_refuses_what_the_reference_refuses(text, match):
    for faults in (j_faults, t_faults):
        with pytest.raises(ValueError, match=match):
            faults.parse(text)


def test_env_schedule_and_inject_act_as_the_reference(monkeypatch):
    monkeypatch.setenv(t_faults.ENV, "ledger_io:every=2")
    outcomes = {}
    for faults in (j_faults, t_faults):
        seq = []
        for _ in range(4):
            try:
                faults.check("ledger_io")
                seq.append(False)
            except faults.FaultInjected:
                seq.append(True)
        with faults.inject("prewarm") as plan:
            assert faults.active() is plan     # installed beats the env
            faults.check("ledger_io")           # env plan masked
            with pytest.raises(faults.FaultInjected):
                faults.check("prewarm")
            seq.append(faults.stats())
        assert faults.active() is not plan      # back to the env plan
        outcomes[faults.__name__.split(".")[0]] = seq
    assert outcomes["repro_torch"] == outcomes["repro"]
    assert outcomes["repro"][:4] == [False, True, False, True]


def test_worker_kill_is_a_base_exception_in_both():
    for faults in (j_faults, t_faults):
        assert not issubclass(faults.WorkerKilled, Exception)
        assert issubclass(faults.FaultInjected, RuntimeError)
    assert t_faults.SCOPES == j_faults.SCOPES
    assert t_faults.ENV == j_faults.ENV == "REPRO_FAULTS"


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _monitor_walk(ft, script):
    """Apply ``script`` to a monitor + coordinator; snapshot after each
    step: node states, missed counts, sweep results and plans."""
    clock = _Clock()
    mon = ft.HeartbeatMonitor(["w0", "w1", "w2"], suspect_after=10.0,
                              fail_after=30.0, clock=clock)
    coord = ft.FaultCoordinator(mon, reserves=["w3"], min_world=1)
    snaps = []
    for op, arg in script:
        res = None
        if op == "t":
            clock.t = arg
        elif op == "beat":
            mon.beat(arg)
        elif op == "sweep":
            res = mon.sweep()
        elif op == "force_fail":
            mon.force_fail(arg)
        elif op == "suspect":
            mon.suspect(arg)
        elif op == "add":
            mon.add_node(arg)
        elif op == "plan":
            p = coord.plan(last_ckpt_step=arg)
            res = (p.action, p.failed, p.replacements, p.new_world_size,
                   p.restore_step)
        snaps.append((res, sorted((n, i.state.value, i.last_beat)
                                  for n, i in mon.nodes.items()),
                      mon.healthy(), list(coord.reserves)))
    return snaps


_SCRIPT = [("beat", "w0"), ("t", 12.0), ("sweep", None), ("beat", "w0"),
           ("suspect", "w1"), ("t", 15.0), ("beat", "w1"), ("t", 31.0),
           ("beat", "w0"), ("sweep", None), ("plan", 7), ("plan", None),
           ("force_fail", "w0"), ("force_fail", "nobody"), ("sweep", None),
           ("suspect", "w0"), ("add", "w9"), ("t", 62.0), ("sweep", None),
           ("plan", 9)]


def test_heartbeat_monitor_and_restart_policy_walk_as_the_reference():
    got = _monitor_walk(t_ft, _SCRIPT)
    assert got == _monitor_walk(j_ft, _SCRIPT)
    actions = [s[0][0] for (op, _), s in zip(_SCRIPT, got) if op == "plan"]
    assert actions == ["replace", "none", "shrink"]


def _straggler_walk(mod, seed):
    rng = np.random.default_rng(seed)
    hosts = [f"w{i}" for i in range(4)]
    det = mod.StragglerDetector(list(hosts), window=8, persist=2)
    slow_host = hosts[seed % 4]
    reports = []
    for step in range(12):
        if step == 6:
            det.drop_host(hosts[(seed + 1) % 4])
            det.add_host("w9")
        for h in list(det.hosts):
            base = 0.9 if h == slow_host and step < 9 else 0.1
            det.record(h, float(base * rng.uniform(0.9, 1.1)))
        det.record("gone", 1.0)                # retired host: ignored
        rep = det.detect()
        reports.append((rep.slow_hosts, rep.reassignment,
                        sorted(rep.z_scores.items()), dict(det.strikes)))
    return reports


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_detector_walks_as_the_reference(seed):
    got, want = _straggler_walk(t_straggler, seed), \
        _straggler_walk(j_straggler, seed)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1] == w[1] and g[3] == w[3]
        assert [k for k, _ in g[2]] == [k for k, _ in w[2]]
        np.testing.assert_allclose([v for _, v in g[2]],
                                   [v for _, v in w[2]], rtol=1e-12)
    assert any(r[0] for r in got)              # an outlier was reported


def test_elastic_replan_matches_reference():
    for n in (1, 3, 8, 12, 16, 31):
        for mp in (1, 2, 4):
            for batch in (6, 8, 12):
                if n < mp:
                    for mod in (j_elastic, t_elastic):
                        with pytest.raises(ValueError):
                            mod.replan_mesh(n, mp, batch)
                    continue
                got = t_elastic.replan_mesh(n, mp, batch)
                want = j_elastic.replan_mesh(n, mp, batch)
                assert (got.n_devices, got.data, got.model, got.shape,
                        got.axes) == (want.n_devices, want.data,
                                      want.model, want.shape, want.axes)
    assert t_elastic.rebalance_batch(10, 4, 3) == \
        j_elastic.rebalance_batch(10, 4, 3) == [4, 3, 3]
