"""Deterministic fault injection: seeded, scope-keyed failure schedules.

The serving tier crosses several layers — planner, staged-function
build, kernel dispatch, ledger IO, worker and refit threads — and each
seam is a place a production engine must *degrade* rather than deadlock.
This module is the fault injector those degradation paths are tested
against: every identified seam calls ``check(scope, **attrs)``, and an
installed fault plan decides deterministically whether that call raises.

Activation, most specific wins:

* programmatic — ``with faults.inject("stage_compile:p=0.3,seed=7"): ...``
  (or ``install(parse(...))`` / ``uninstall()`` for non-scoped control);
* environment — ``REPRO_FAULTS="stage_compile:p=0.3,seed=7;..."`` is read
  lazily and re-parsed when the variable changes, so a CI chaos job
  configures the whole process without code changes.

DSL: ``;``-separated specs, each ``scope[:key=val,...]``. Reserved keys
(all optional): ``p`` — fire probability per matching call, from a
``seed``-ed PRNG private to the spec (default fire always); ``every`` —
fire on every Nth matching call (exact schedules, no randomness);
``after`` — skip the first N matching calls; ``times`` — stop after N
fires. Any other key is a *match filter*: the spec only applies when the
call site passed an attribute of that name whose ``str()`` equals the
value (e.g. ``kernel_dispatch:backend=cuda,every=5``).

Determinism: a spec's PRNG is seeded at parse time and consumed once per
matching call in call order, so a single-threaded replay with the same
plan fires identically. ``every``/``times`` schedules are exact under
concurrency too (counters are lock-protected).

Injected faults raise ``FaultInjected`` (a ``RuntimeError``: ordinary
containment — retries, fallbacks, drop-and-count — handles it like any
transient failure). A spec with ``kind=kill`` raises ``WorkerKilled``
instead, which deliberately subclasses ``BaseException`` so batch-level
``except Exception`` containment does NOT stop it: it kills the worker
thread for real and exercises the supervision/restart path.

``stats()`` reports per-scope calls/fires so chaos tests can assert the
schedule actually executed (a chaos run whose faults never fired proves
nothing).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import random
import threading
from typing import Any, Dict, List, Optional, Tuple

ENV = "REPRO_FAULTS"

# Scopes wired into the codebase (documentation + typo guard for specs;
# the same names as the JAX package's, so one schedule string drives both).
SCOPES = (
    "stage_compile",    # plan/executor.py: staged function build (dense+sparse)
    "execute",          # serve/engine.py: staged execution attempt
    "kernel_dispatch",  # kernels/registry.py: one kernel impl call
    "ledger_io",        # obs/ledger.py: one JSONL append
    "prewarm",          # serve/engine.py: batched leaf prewarm
    "worker",           # serve/engine.py: top of one worker batch
    "refit",            # serve/engine.py: background cost-model refit
)


class FaultInjected(RuntimeError):
    """An injected fault. Containment layers treat it exactly like the
    transient failure it simulates; it must never be *silently*
    swallowed (drop-and-count and fallback-and-count are fine)."""

    def __init__(self, scope: str, attrs: Optional[Dict[str, Any]] = None):
        self.scope = scope
        self.attrs = dict(attrs or {})
        detail = "".join(f" {k}={v}" for k, v in self.attrs.items())
        super().__init__(f"injected fault at {scope!r}{detail}")


class WorkerKilled(BaseException):
    """A ``kind=kill`` fault: subclasses ``BaseException`` so per-batch
    ``except Exception`` containment lets it through and the worker
    thread actually dies (the supervision path under test)."""

    def __init__(self, scope: str):
        self.scope = scope
        super().__init__(f"injected worker kill at {scope!r}")


@dataclasses.dataclass
class FaultSpec:
    """One parsed spec: schedule + match filters + mutable fire state."""

    scope: str
    p: Optional[float] = None
    every: Optional[int] = None
    after: int = 0
    times: Optional[int] = None
    seed: int = 0
    kind: str = "error"              # "error" | "kill"
    match: Dict[str, str] = dataclasses.field(default_factory=dict)
    # state (guarded by the owning plan's lock)
    calls: int = 0
    fires: int = 0
    _rng: random.Random = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def matches(self, attrs: Dict[str, Any]) -> bool:
        return all(str(attrs.get(k)) == v for k, v in self.match.items())

    def should_fire(self) -> bool:
        """Advance this spec's schedule by one matching call (caller
        holds the plan lock)."""
        self.calls += 1
        if self.times is not None and self.fires >= self.times:
            return False
        if self.calls <= self.after:
            return False
        if self.every is not None:
            fire = (self.calls - self.after) % self.every == 0
        elif self.p is not None:
            fire = self._rng.random() < self.p
        else:
            fire = True
        if fire:
            self.fires += 1
        return fire


class FaultPlan:
    """A set of specs, indexed by scope, with one lock for schedule
    state. Cheap when a scope has no specs (one dict lookup)."""

    def __init__(self, specs: List[FaultSpec]):
        self.specs = list(specs)
        self._by_scope: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_scope.setdefault(s.scope, []).append(s)
        self._lock = threading.Lock()

    def check(self, scope: str, attrs: Dict[str, Any]) -> None:
        specs = self._by_scope.get(scope)
        if not specs:
            return
        for spec in specs:
            if not spec.matches(attrs):
                continue
            with self._lock:
                fire = spec.should_fire()
            if fire:
                if spec.kind == "kill":
                    raise WorkerKilled(scope)
                raise FaultInjected(scope, attrs)

    def stats(self) -> Dict[str, Dict[str, int]]:
        out: Dict[str, Dict[str, int]] = {}
        with self._lock:
            for s in self.specs:
                agg = out.setdefault(s.scope, {"calls": 0, "fires": 0})
                agg["calls"] += s.calls
                agg["fires"] += s.fires
        return out


def parse(text: str) -> FaultPlan:
    """Parse the DSL (see module docstring) into a ``FaultPlan``."""
    specs = []
    for part in text.split(";"):
        part = part.strip()
        if not part:
            continue
        scope, _, rest = part.partition(":")
        scope = scope.strip()
        if scope not in SCOPES:
            raise ValueError(
                f"unknown fault scope {scope!r}; expected one of {SCOPES}")
        kw: Dict[str, Any] = {"scope": scope, "match": {}}
        for item in filter(None, (i.strip() for i in rest.split(","))):
            k, eq, v = item.partition("=")
            if not eq:
                raise ValueError(f"malformed fault item {item!r} "
                                 f"(expected key=value) in {part!r}")
            k = k.strip()
            v = v.strip()
            if k == "p":
                kw["p"] = float(v)
            elif k in ("every", "after", "times", "seed"):
                kw[k] = int(v)
            elif k == "kind":
                if v not in ("error", "kill"):
                    raise ValueError(f"unknown fault kind {v!r}")
                kw["kind"] = v
            else:
                kw["match"][k] = v
        specs.append(FaultSpec(**kw))
    return FaultPlan(specs)


# -- activation ---------------------------------------------------------------

_installed: Optional[FaultPlan] = None
_env_cache: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)
_state_lock = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Install a programmatic plan (overrides ``REPRO_FAULTS``)."""
    global _installed
    with _state_lock:
        _installed = plan
    return plan


def uninstall() -> None:
    global _installed
    with _state_lock:
        _installed = None


@contextlib.contextmanager
def inject(text: str):
    """Scoped programmatic activation: ``with faults.inject("prewarm:every=2"):``"""
    plan = install(parse(text))
    try:
        yield plan
    finally:
        uninstall()


def active() -> Optional[FaultPlan]:
    """The plan in force: the installed one, else a (cached) parse of
    ``REPRO_FAULTS``. Re-parsing only happens when the variable's text
    changes, so the no-fault fast path is one env read + one tuple
    compare."""
    global _env_cache
    if _installed is not None:
        return _installed
    raw = os.environ.get(ENV)
    if raw is None:
        return None
    cached_raw, cached_plan = _env_cache
    if raw != cached_raw:
        with _state_lock:
            cached_raw, cached_plan = _env_cache
            if raw != cached_raw:
                cached_plan = parse(raw)
                _env_cache = (raw, cached_plan)
    return cached_plan


def check(scope: str, **attrs: Any) -> None:
    """The seam hook: raises ``FaultInjected`` (or ``WorkerKilled`` for
    ``kind=kill`` specs) when the active plan schedules a fault for this
    call; no-op (one env read) otherwise."""
    plan = active()
    if plan is not None:
        plan.check(scope, attrs)


def stats() -> Dict[str, Dict[str, int]]:
    """Per-scope calls/fires of the active plan (empty when none)."""
    plan = active()
    return plan.stats() if plan is not None else {}
