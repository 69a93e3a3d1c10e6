"""Multi-query serving engine: one session, thousands of concurrent queries.

The paper's premise is relational query processing as a *service* over big
matrix data; its Spark prototype amortizes optimization across a query
stream. This module is that serving tier for the PyTorch port (the JAX
package's ``serve.engine``, same names, counters and semantics):

* ``submit()`` accepts a stream of logical plans (``Expr`` or ``Matrix``)
  from many clients/tenants and returns a ``Ticket`` (an async handle);
  worker threads drain the queue in batches.
* **Cross-query CSE** — all queries over one catalog version lower into a
  single shared hash-consing arena (``plan.builder.SharedBuildState``):
  a subplan any earlier query lowered resolves to the same shared node
  id, and a shared LRU of materialized node results
  (``core.plancache.VersionedLRU``) turns that structural sharing into
  *execution* sharing — overlapping pipelines compute each shared
  subexpression once per catalog version. A whole-query repeat is a root
  hit and returns without touching the evaluator.
* **Shared optimizer state** — optimize results, the memo search's
  physical-cost cache and the catalog ``Leaves`` view are shared per
  catalog version, so overlapping queries cost each shared candidate
  subexpression once (``core.optimizer.optimize(cost_cache=...,
  leaves=...)``).
* **Batched leaf scans** — before a drained batch executes, the distinct
  leaves referenced by the whole batch are materialized once each into
  the shared result cache (one scan per leaf per batch, not per query).
* **Versioned caches** — every shared structure is keyed by the catalog
  version (bumped by ``Session.load``): a leaf rebind retires the old
  arena/results atomically for *new* queries while in-flight queries keep
  the version they started against. Invariant: every cache keyed on
  data-dependent annotations carries the catalog version.
* **Admission control** — a bounded queue plus per-tenant in-flight
  quotas reject excess load at submit time (``AdmissionError``), and
  per-tenant result-cache budgets stop one tenant's churn from flushing
  another's hot entries.

``cse=False`` disables the shared result cache and the arena reuse, and
executes each query standalone through the session's staged path — the
baseline the serving benchmark compares against.

On the card every worker thread launches on the device's current
(default) stream, so results one worker publishes to the shared cache are
ordered before any later launch that reads them; a ticket's latency ends
when an event recorded after its result on that stream has completed.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Dict, List, Optional

import torch

from repro_torch.core import optimizer as optmod
from repro_torch.core.expr import Expr, signature
from repro_torch.core.plancache import VersionedLRU
from repro_torch.kernels.registry import REFUSALS
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TRACER
from repro_torch.plan import builder as buildermod
from repro_torch.plan.executor import PlanExecutor
from repro_torch.plan import ops as P
from repro_torch.runtime import faults
from repro_torch.runtime.fault_tolerance import (
    FaultCoordinator, HeartbeatMonitor, NodeState,
)
from repro_torch.runtime.straggler import StragglerDetector


class AdmissionError(RuntimeError):
    """Submit rejected by admission control (queue full / tenant over
    budget). Clients are expected to back off and retry."""


class DeadlineExceeded(TimeoutError):
    """A ticket blew its ``deadline_s`` budget at a cooperative
    cancellation checkpoint (plan / prewarm / execute boundaries). The
    query is finished with this error instead of burning more engine
    time on a result the client has stopped waiting for."""


_UNSET = object()


class Ticket:
    """Async handle for one submitted query."""

    def __init__(self, query: Expr, tenant: str,
                 deadline_s: Optional[float] = None,
                 default_timeout: Optional[float] = None):
        self.query = query
        self.tenant = tenant
        self.submitted_at = time.perf_counter()
        self.deadline_s = deadline_s
        self.deadline = (None if deadline_s is None
                         else self.submitted_at + deadline_s)
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.reused_nodes = 0        # node results served from the shared LRU
        self.evaluated_nodes = 0
        self.trace = None            # obs.trace.Trace when sampled at submit
        self.opt = None              # OptimizeResult (predicted nnz → ledger)
        self._default_timeout = default_timeout
        self._done = threading.Event()
        self._finish_guard = threading.Lock()
        self._result = None
        self._error: Optional[BaseException] = None

    @property
    def trace_id(self) -> Optional[str]:
        return self.trace.trace_id if self.trace is not None else None

    # -- worker side ----------------------------------------------------------
    def _finish(self, result=None,
                error: Optional[BaseException] = None) -> bool:
        """Record the outcome exactly once. Returns False when the
        ticket was already finished — crash containment means several
        layers (per-ticket, batch-level, worker-exit, supervisor) may
        legitimately race to finish the same ticket, and only the first
        may count."""
        with self._finish_guard:
            if self._done.is_set():
                return False
            self._result, self._error = result, error
            self.finished_at = time.perf_counter()
            self._done.set()
            return True

    # -- client side ----------------------------------------------------------
    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout=_UNSET):
        """Wait for the outcome. With no ``timeout`` argument the
        engine's ``default_timeout_s`` applies (pass ``timeout=None``
        explicitly to wait forever)."""
        t = self._default_timeout if timeout is _UNSET else timeout
        if not self._done.wait(t):
            raise TimeoutError(
                f"query still in flight after {t}s "
                f"(tenant={self.tenant!r}, trace_id={self.trace_id})")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency(self) -> float:
        """Submit→finish wall seconds (meaningful once ``done()``)."""
        return (self.finished_at or time.perf_counter()) - self.submitted_at


@dataclasses.dataclass
class _VersionState:
    """All cross-query shared state for one (catalog version × settings):
    the hash-consing arena, an immutable catalog snapshot, per-version
    optimizer caches, and the extracted-plan cache. Retired wholesale when
    the catalog version moves on (old instances keep serving their
    in-flight queries until unreferenced)."""

    key: tuple
    env: Dict                       # catalog snapshot (name → BlockMatrix)
    shared: buildermod.SharedBuildState
    leaves: object                  # plan.masks.Leaves over the snapshot
    cost_cache: Dict = dataclasses.field(default_factory=dict)
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    opt_cache: Optional[VersionedLRU] = None
    plans: Optional[VersionedLRU] = None       # optimized expr → SharedLowering
    plan_locks: Dict[int, threading.Lock] = \
        dataclasses.field(default_factory=dict)


class _NodeCache:
    """Adapter from the executor's ``get(plan, node)/put`` seam to the
    engine's shared result LRU, keyed by (version-state key, shared node
    id) and attributed to the submitting tenant for budget accounting."""

    def __init__(self, results: VersionedLRU, state_key: tuple, tenant: str):
        self._results = results
        self._state_key = state_key
        self._tenant = tenant

    def get(self, plan: P.PhysicalPlan, node: P.PhysicalNode):
        return self._results.get((self._state_key,
                                  node.meta.get("shared_id", node.op_id)))

    def put(self, plan: P.PhysicalPlan, node: P.PhysicalNode, result):
        self._results.put(
            (self._state_key, node.meta.get("shared_id", node.op_id)),
            result, tenant=self._tenant)


class ServeEngine:
    """Serving front end over one ``Session`` (see module docstring).

    Parameters
    ----------
    n_threads: worker threads draining the submit queue.
    max_queue: admission bound on queued tickets (global).
    tenant_max_inflight: admission bound on queued+running per tenant.
    cse: enable the cross-query shared arena + result cache.
    result_entries / tenant_result_budget: shared result LRU capacity and
        the per-tenant entry budget within it.
    batch_max: tickets drained per worker wakeup (the leaf-scan batching
        window).
    """

    # snapshot() compatibility keys, all registry-backed (``serve_<name>``)
    _COUNTERS = (
        "submitted", "completed", "errors",
        "rejected_queue", "rejected_tenant",
        "root_hits", "node_reuses", "node_evals",
        "inter_query_cse_nodes",
        "leaf_scans", "leaf_refs", "batches",
        "refits", "refit_rows",
        # robustness: every degradation is counted
        "worker_crashes", "worker_restarts", "batch_failures",
        "prewarm_failures", "deadline_exceeded",
        "exec_retries", "degraded_eager",
        "ledger_errors", "refit_crashes", "stragglers_suspected",
        # dispatches served from a shared autotune artifact: the port has
        # no autotuner yet (ROADMAP: autotuner), so this reads 0
        "autotune_warm_hits",
    )

    # errors the staged-execution retry loop must NOT retry: they are
    # deterministic (config / cancellation / a kernel refusing its
    # arguments), not transient
    _NON_RETRYABLE = (DeadlineExceeded, AdmissionError, KeyError) + REFUSALS

    def __init__(self, session, *, n_threads: int = 2, max_queue: int = 1024,
                 tenant_max_inflight: Optional[int] = None, cse: bool = True,
                 result_entries: int = 1024,
                 tenant_result_budget: Optional[int] = None,
                 plan_entries: int = 128, opt_entries: int = 256,
                 batch_max: int = 32, keep_versions: int = 2,
                 registry: Optional[MetricsRegistry] = None,
                 trace_sample: Optional[float] = None,
                 ledger=None, ledger_root_hits: bool = False,
                 refit_every: Optional[int] = None,
                 default_timeout_s: Optional[float] = 300.0,
                 deadline_s: Optional[float] = None,
                 exec_retries: int = 2, retry_backoff_s: float = 0.005,
                 suspect_after_s: float = 10.0, fail_after_s: float = 30.0,
                 supervise_every_s: float = 0.5):
        self.session = session
        self.cse = cse
        self.max_queue = max_queue
        self.tenant_max_inflight = tenant_max_inflight
        self.batch_max = batch_max
        self._plan_entries = plan_entries
        self._opt_entries = opt_entries
        # per-engine registry by default: tests assert exact counter
        # values per engine; pass ``obs.metrics.REGISTRY`` to aggregate
        # process-wide instead
        self.metrics = registry if registry is not None else MetricsRegistry()
        # engine-level sampling override: None defers to the global
        # tracer's rate (REPRO_TRACE_SAMPLE); a float forces this
        # engine's own deterministic 1-in-N choice
        self.trace_sample = trace_sample
        self._trace_seq = 0
        # optional obs.ledger.CostLedger: one predicted-vs-actual row per
        # executed plan (its measured collective bytes are None: the port
        # has no multi-worker program yet). Root hits execute nothing (the row would record a cache lookup,
        # useless for cost-model re-fitting) so they are skipped unless
        # ledger_root_hits is set — this keeps the ledger off the
        # hottest serving path.
        self.ledger = ledger
        self.ledger_root_hits = ledger_root_hits
        # online calibration: with a ledger AND a session cost model,
        # every ``refit_every`` executed (ledgered) plans a background
        # daemon thread re-fits the model from the accumulated rows. A
        # drift-exceeding fit bumps ``cost_model.version``, which is
        # part of the state key below — new queries admit the refreshed
        # coefficients while in-flight queries keep the version-state
        # they started against (the same retire machinery a catalog
        # rebind uses). The trigger interval backs off exponentially
        # while fits keep converging (no version bump) and snaps back
        # to ``refit_every`` on a bump: a converged model stops paying
        # fit CPU against the serving threads, a regime change is
        # tracked closely again.
        self.refit_every = refit_every
        self._refit_rows_seen = 0
        self._refit_interval = refit_every
        self._refit_last_at = 0
        self._refit_lock = threading.Lock()
        self._refit_thread: Optional[threading.Thread] = None
        self._results = VersionedLRU(result_entries,
                                     tenant_budget=tenant_result_budget,
                                     name="results", registry=self.metrics)
        self._counters = {name: self.metrics.counter("serve_" + name)
                          for name in self._COUNTERS}
        self._arena_nodes = self.metrics.gauge("serve_arena_nodes")
        self._costmodel_version = self.metrics.gauge(
            "serve_costmodel_version")
        self._latency = self.metrics.histogram("serve_latency_s")
        self._queue_wait = self.metrics.histogram("serve_queue_wait_s")
        self._states: "deque[_VersionState]" = deque(maxlen=keep_versions)
        self._queue: "deque[Ticket]" = deque()
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._stop = False
        # degradation policy knobs (see docs/robustness.md)
        self.default_timeout_s = default_timeout_s
        self.deadline_s = deadline_s
        self.exec_retries = exec_retries
        self.retry_backoff_s = retry_backoff_s
        # worker supervision: every worker is a node in the seed
        # HeartbeatMonitor / FaultCoordinator (runtime.fault_tolerance);
        # workers beat per batch and per ticket, a dead thread is
        # force-failed immediately, and the coordinator's replace policy
        # names the replacement worker the supervisor spawns. The
        # straggler detector is fed per-ticket worker wall times and
        # hands persistent outliers to the monitor as SUSPECT.
        self._ft_lock = threading.Lock()
        worker_ids = [f"w{i}" for i in range(n_threads)]
        self._monitor = HeartbeatMonitor(
            worker_ids, suspect_after=suspect_after_s,
            fail_after=fail_after_s)
        self._coord = FaultCoordinator(self._monitor, reserves=[],
                                       min_world=1)
        self._straggler = StragglerDetector(list(worker_ids), window=16)
        self._next_worker = n_threads
        self._heartbeat_s = min(0.2, supervise_every_s)
        self._worker_batches: Dict[str, List[Ticket]] = {}
        self._workers: Dict[str, threading.Thread] = {}
        for wid in worker_ids:
            t = threading.Thread(target=self._worker_loop, args=(wid,),
                                 daemon=True, name=f"serve-worker-{wid}")
            self._workers[wid] = t
            t.start()
        self._supervisor_stop = threading.Event()
        self._supervisor = threading.Thread(
            target=self._supervise_loop, args=(supervise_every_s,),
            daemon=True, name="serve-supervisor")
        self._supervisor.start()

    # -- lifecycle ------------------------------------------------------------
    def close(self) -> None:
        with self._lock:
            self._stop = True
            self._work.notify_all()
        self._supervisor_stop.set()
        self._supervisor.join(timeout=10.0)
        with self._lock:
            threads = list(self._workers.values())
        for t in threads:
            # a genuinely hung worker cannot be joined — bounded wait so
            # close() never inherits the hang it exists to contain
            t.join(timeout=10.0)

    def __enter__(self) -> "ServeEngine":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client API -----------------------------------------------------------
    def submit(self, query, tenant: str = "default",
               deadline_s: Optional[float] = None) -> Ticket:
        """Enqueue one logical plan (an ``Expr`` or a ``core.api.Matrix``);
        raises ``AdmissionError`` when the queue or the tenant budget is
        full. ``deadline_s`` (default: the engine's ``deadline_s``)
        bounds queue wait + execution: past it, the next cooperative
        checkpoint finishes the ticket with ``DeadlineExceeded``."""
        expr = query.plan if hasattr(query, "plan") else query
        if not isinstance(expr, Expr):
            raise TypeError(f"not a logical plan: {type(query)}")
        ticket = Ticket(
            expr, tenant,
            deadline_s=self.deadline_s if deadline_s is None else deadline_s,
            default_timeout=self.default_timeout_s)
        with self._lock:
            if self._stop:
                raise RuntimeError("engine is closed")
            if len(self._queue) >= self.max_queue:
                self._counters["rejected_queue"].inc()
                raise AdmissionError(
                    f"queue full ({self.max_queue} tickets)")
            if (self.tenant_max_inflight is not None
                    and self._inflight.get(tenant, 0)
                    >= self.tenant_max_inflight):
                self._counters["rejected_tenant"].inc()
                raise AdmissionError(
                    f"tenant {tenant!r} over budget "
                    f"({self.tenant_max_inflight} in flight)")
            self._inflight[tenant] = self._inflight.get(tenant, 0) + 1
            self._counters["submitted"].inc()
            sample = self._sample_locked()
            self._queue.append(ticket)
            self._work.notify()
        # trace starts at submit (client thread) and is *activated* on
        # whichever worker thread executes the ticket — queue wait is the
        # gap between the two
        ticket.trace = TRACER.start("query", sample=sample, tenant=tenant,
                                    query=signature(expr))
        return ticket

    def _sample_locked(self) -> Optional[bool]:
        """Engine-level trace sampling decision (``self._lock`` held).
        None → defer to the global tracer's rate."""
        r = self.trace_sample
        if r is None:
            return None
        if r <= 0.0:
            return False
        if r >= 1.0:
            return True
        period = max(1, round(1.0 / r))
        self._trace_seq += 1
        return self._trace_seq % period == 0

    def run(self, query, tenant: str = "default", timeout=_UNSET,
            deadline_s: Optional[float] = None):
        """Submit and wait (the synchronous convenience path)."""
        return self.submit(query, tenant=tenant,
                           deadline_s=deadline_s).result(timeout)

    def drain(self, timeout: float = 60.0) -> None:
        """Block until every submitted ticket has finished."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            with self._lock:
                if not self._queue and not any(self._inflight.values()):
                    return
            time.sleep(0.001)
        raise TimeoutError("engine did not drain")

    # -- version-state management ---------------------------------------------
    def _state_key(self, version: int) -> tuple:
        s = self.session
        return (version, s.mode, s.block_size, s.use_bloom, s.n_workers,
                str(s.device), s._costmodel_key())

    def _current_state(self) -> _VersionState:
        """The shared state for the catalog as of *now*. The version is
        read on both sides of the snapshot so a concurrent ``load`` can
        never produce a state whose snapshot mixes versions."""
        from repro_torch.plan import masks as masksmod
        s = self.session
        while True:
            v = s._env_version
            key = self._state_key(v)
            with self._lock:
                for st in self._states:
                    if st.key == key:
                        return st
            env = dict(s.env)
            if s._env_version != v:
                continue                      # rebind raced the snapshot
            st = _VersionState(
                key=key, env=env,
                shared=buildermod.SharedBuildState(
                    mode=s.mode, block_size=s.block_size,
                    use_bloom=s.use_bloom, n_workers=s.n_workers or 1,
                    device=s.device),
                leaves=masksmod.Leaves(env, s.block_size),
                opt_cache=VersionedLRU(self._opt_entries),
                plans=VersionedLRU(self._plan_entries))
            with self._lock:
                for other in self._states:
                    if other.key == key:      # another thread won the race
                        return other
                self._states.append(st)
            return st

    # -- worker side ----------------------------------------------------------
    def _finish_ticket(self, ticket: Ticket, result=None,
                       error: Optional[BaseException] = None) -> None:
        """The single completion site: every ticket — success, plan
        failure, execution failure, deadline, worker crash — ends here
        EXACTLY once (``Ticket._finish`` is first-wins), so
        ``completed``/``errors``, the latency histogram and the
        per-tenant in-flight accounting can never drift from the ticket
        stream even when crash containment races normal completion."""
        if not ticket._finish(result=result, error=error):
            return
        self._counters["errors" if error is not None
                       else "completed"].inc()
        if isinstance(error, DeadlineExceeded):
            self._counters["deadline_exceeded"].inc()
        self._latency.observe(ticket.latency)
        with self._lock:
            n = self._inflight.get(ticket.tenant, 0) - 1
            if n > 0:
                self._inflight[ticket.tenant] = n
            else:
                self._inflight.pop(ticket.tenant, None)
        if ticket.trace is not None:
            ticket.trace.finish()

    def _check_deadline(self, ticket: Ticket, phase: str) -> None:
        """Cooperative cancellation checkpoint (plan / prewarm / execute
        boundaries)."""
        if (ticket.deadline is not None
                and time.perf_counter() > ticket.deadline):
            raise DeadlineExceeded(
                f"deadline of {ticket.deadline_s}s exceeded at {phase!r} "
                f"(tenant={ticket.tenant!r}, trace_id={ticket.trace_id})")

    def _beat(self, wid: str) -> bool:
        """Heartbeat ``wid`` into the monitor; False when the restart
        policy has retired this worker (it must exit its loop)."""
        with self._ft_lock:
            if wid not in self._monitor.nodes:
                return False
            self._monitor.beat(wid)
        return True

    def _worker_loop(self, wid: str) -> None:
        """One worker thread: drain batches until stopped, retired, or
        killed. ANY abnormal exit flows through ``_worker_exit``, which
        finishes the in-flight batch with the error and hands the crash
        to the coordinator-driven restart policy — a worker death can
        strand neither its tickets nor its queue slot."""
        err: Optional[BaseException] = None
        try:
            while True:
                batch = self._next_batch(wid)
                if batch is None:
                    return
                if batch:
                    self._process_batch(wid, batch)
        except BaseException as e:
            err = e
        finally:
            self._worker_exit(wid, err)

    def _next_batch(self, wid: str) -> Optional[List[Ticket]]:
        """One drain attempt: ``None`` → exit (stop/retired), ``[]`` →
        idle wakeup (beat again, re-check). Idle waits are bounded by
        the heartbeat interval so a quiet worker still beats."""
        if not self._beat(wid):
            return None
        with self._lock:
            if self._stop and not self._queue:
                return None
            if not self._queue:
                self._work.wait(timeout=self._heartbeat_s)
                return []
            batch: List[Ticket] = []
            while self._queue and len(batch) < self.batch_max:
                batch.append(self._queue.popleft())
            self._counters["batches"].inc()
            self._worker_batches[wid] = batch
        return batch

    def _process_batch(self, wid: str, batch: List[Ticket]) -> None:
        """Plan, prewarm and execute one batch. Failure containment, in
        order of blast radius: per-ticket failures finish that ticket;
        prewarm failures degrade the batch to un-prewarmed execution;
        batch-level failures (version snapshot, bookkeeping) finish
        every ticket in the batch with the error — the regression this
        pins is an exception between dequeue and the per-ticket loop
        stranding a whole batch of clients in ``result()``. Worker-kill
        faults (``BaseException``) pass through to ``_worker_exit``."""
        t_batch0 = time.perf_counter()
        try:
            faults.check("worker", worker=wid)
            state = self._current_state()
            lowered = [self._plan_ticket(state, t) for t in batch]
            if self.cse:
                t0 = time.perf_counter()
                try:
                    faults.check("prewarm", worker=wid)
                    self._prewarm_leaves(state, [p for p in lowered
                                                 if p is not None])
                except Exception:
                    # contained per-batch: leaves will materialize
                    # per-query through the result cache instead
                    self._counters["prewarm_failures"].inc()
                t1 = time.perf_counter()
                # batch-level phase, attributed to every traced ticket
                for ticket in batch:
                    if ticket.trace is not None:
                        with TRACER.activate(ticket.trace):
                            TRACER.add_event("batch_prewarm", t0, t1,
                                             batch=len(batch))
            for ticket, lw in zip(batch, lowered):
                if lw is None:
                    continue        # already finished in _plan_ticket
                self._beat(wid)     # long batches must not look hung
                try:
                    self._check_deadline(ticket, "execute")
                    with TRACER.activate(ticket.trace):
                        self._execute(state, ticket, lw)
                except Exception as e:  # propagate to the client
                    self._finish_ticket(ticket, error=e)
        except BaseException as e:
            if not isinstance(e, Exception):
                raise               # worker-killing: _worker_exit cleans up
            self._counters["batch_failures"].inc()
            for t in batch:
                self._finish_ticket(t, error=e)
        self._worker_batches.pop(wid, None)
        with self._ft_lock:
            self._straggler.record(
                wid, (time.perf_counter() - t_batch0) / len(batch))

    def _worker_exit(self, wid: str, err: Optional[BaseException]) -> None:
        """Last act of a worker thread (normal exit, retirement, or
        death): finish any batch it still held, then — for a crash —
        report the node failed and run the restart policy inline so
        recovery does not wait for the next supervisor sweep."""
        batch = self._worker_batches.pop(wid, None)
        if batch:
            e = (err if isinstance(err, Exception)
                 else RuntimeError(f"serve worker {wid} died: {err!r}"))
            for t in batch:
                self._finish_ticket(t, error=e)
        if err is None or self._stop:
            return
        self._counters["worker_crashes"].inc()
        with self._ft_lock:
            self._monitor.force_fail(wid)
        self._supervise_once()

    # -- supervision ----------------------------------------------------------
    def _supervise_loop(self, every_s: float) -> None:
        while not self._supervisor_stop.wait(every_s):
            try:
                self._supervise_once()
            except Exception:       # supervision must outlive its bugs
                self.metrics.counter("serve_supervisor_errors").inc()

    def _supervise_once(self) -> None:
        """One sweep of the restart policy: force-fail dead threads,
        SUSPECT/FAILED transitions from heartbeats, straggler hand-off,
        and coordinator-planned replacement of FAILED workers."""
        to_spawn: List[tuple] = []
        with self._ft_lock:
            for wid, th in list(self._workers.items()):
                # a dead thread cannot beat again: fail it immediately
                # rather than waiting out the fail_after window
                if not th.is_alive() and wid in self._monitor.nodes:
                    self._monitor.force_fail(wid)
            self._monitor.sweep()
            failed = [n for n, i in self._monitor.nodes.items()
                      if i.state is NodeState.FAILED]
            if failed:
                # top up the reserve pool so the policy always replaces
                # (a serving engine shrinks only when told to)
                while len(self._coord.reserves) < len(failed):
                    self._coord.reserves.append(f"w{self._next_worker}")
                    self._next_worker += 1
                plan = self._coord.plan()
                if plan.action == "replace":
                    for old, new in zip(plan.failed, plan.replacements):
                        self._straggler.drop_host(old)
                        self._straggler.add_host(new)
                        to_spawn.append((old, new))
            else:
                # persistent latency outliers become SUSPECT: a later
                # hard failure is pre-diagnosed, and the transition is
                # visible in the snapshot before anything breaks
                rep = self._straggler.detect()
                for slow in rep.slow_hosts:
                    info = self._monitor.nodes.get(slow)
                    if info is not None and \
                            info.state is NodeState.HEALTHY:
                        self._monitor.suspect(slow)
                        self._counters["stragglers_suspected"].inc()
        for old, new in to_spawn:
            # a hung (not dead) worker may still hold a batch; its
            # clients get an error now instead of a silent hang. If the
            # hung thread later resumes, every completion path is
            # idempotent and its next beat tells it to exit.
            batch = self._worker_batches.pop(old, None)
            if batch:
                e = RuntimeError(
                    f"serve worker {old} removed by restart policy")
                for t in batch:
                    self._finish_ticket(t, error=e)
            with self._lock:
                if self._stop:
                    continue
                th = threading.Thread(
                    target=self._worker_loop, args=(new,),
                    daemon=True, name=f"serve-worker-{new}")
                self._workers.pop(old, None)
                self._workers[new] = th
                th.start()
            self._counters["worker_restarts"].inc()

    def _plan_ticket(self, state: _VersionState, ticket: Ticket
                     ) -> Optional[buildermod.SharedLowering]:
        """Optimize + lower one ticket against the shared per-version
        state; on failure the ticket is finished with the error and None
        is returned."""
        s = self.session
        try:
            ticket.started_at = time.perf_counter()
            self._queue_wait.observe(ticket.started_at
                                     - ticket.submitted_at)
            self._check_deadline(ticket, "plan")
            with TRACER.activate(ticket.trace):
                TRACER.add_event("queue_wait", ticket.submitted_at,
                                 ticket.started_at)
                TRACER.annotate(admitted_version=state.key[0])
                opt = state.opt_cache.get_or_create(
                    (ticket.query, s.search),
                    lambda: optmod.optimize(
                        ticket.query, search=s.search, session=s,
                        cost_cache=state.cost_cache, leaves=state.leaves),
                    tenant=ticket.tenant)
                ticket.opt = opt
                if not self.cse:
                    # standalone lowering: no shared arena, a fresh
                    # per-expr plan (staged execution path)
                    plan = state.plans.get_or_create(
                        opt.plan, lambda: buildermod.build_plan(
                            opt.plan, mode=s.mode, block_size=s.block_size,
                            use_bloom=s.use_bloom, n_workers=s.n_workers,
                            device=s.device),
                        tenant=ticket.tenant)
                    return buildermod.SharedLowering(
                        plan=plan, root_shared_id=-1, reused_nodes=0,
                        new_nodes=plan.n_nodes)
                def _lower():
                    with state.lock:
                        lw = buildermod.lower_shared(state.shared, opt.plan)
                    self._counters["inter_query_cse_nodes"].inc(
                        lw.reused_nodes)
                    self._arena_nodes.set(len(state.shared.nodes))
                    return lw
                return state.plans.get_or_create(opt.plan, _lower,
                                                 tenant=ticket.tenant)
        except Exception as e:      # kills (BaseException) escape to
            self._finish_ticket(ticket, error=e)      # _worker_exit
            return None

    def _prewarm_leaves(self, state: _VersionState,
                        lowered: List[buildermod.SharedLowering]) -> None:
        """Batched leaf scans: materialize each distinct leaf the batch
        references once into the shared result cache."""
        from repro_torch.core.executor import leaf_value
        seen = set()
        for lw in lowered:
            for node in lw.plan.nodes:
                if node.kind != P.LEAF:
                    continue
                key = (state.key, node.meta["shared_id"])
                self._counters["leaf_refs"].inc()
                if key in seen or self._results.get(key) is not None:
                    continue
                seen.add(key)
                val = leaf_value(node.expr, state.env,
                                 state.shared.block_size, state.shared.device)
                self._results.put(key, val)
                self._counters["leaf_scans"].inc()

    # Minimum fraction of a plan's estimated flops that cached subresults
    # must cover before the engine prefers per-node eager reuse over the
    # staged path (eager pays per-node dispatch overhead; staged pays
    # recomputing the overlap).
    EAGER_REUSE_MIN_COVERAGE = 0.5

    def _cse_coverage(self, state: _VersionState,
                      plan: P.PhysicalPlan) -> float:
        """Fraction of ``plan``'s estimated flops already materialized in
        the shared result cache: a cached node covers its whole subtree
        (evaluation stops there). Leaf hits contribute nothing — leaves
        carry no flops, and re-scanning one is cheap."""
        cached = {
            n.op_id for n in plan.nodes
            if n.kind != P.LEAF
            and (state.key, n.meta["shared_id"]) in self._results}
        if not cached:
            return 0.0
        need = set()
        stack = [plan.root]
        while stack:
            i = stack.pop()
            if i in need or i in cached:
                continue
            need.add(i)
            stack.extend(plan.node(i).children)
        total = plan.est_flops
        if total <= 0:
            return 1.0
        return 1.0 - sum(plan.node(i).est_flops for i in need) / total

    def _execute(self, state: _VersionState, ticket: Ticket,
                 lw: buildermod.SharedLowering) -> None:
        t0 = time.perf_counter()
        exec_path = None
        ex = None
        if self.cse:
            root_key = (state.key,
                        lw.plan.node(lw.plan.root).meta["shared_id"])
            hit = self._results.get(root_key)
            if hit is not None:
                self._counters["root_hits"].inc()
                ticket.reused_nodes = lw.plan.n_nodes
                if self.ledger_root_hits:
                    self._ledger_row(state, ticket, lw.plan, "root_hit",
                                     time.perf_counter() - t0, 0.0)
                self._finish_ticket(ticket, result=hit)
                return
            if (self._cse_coverage(state, lw.plan)
                    >= self.EAGER_REUSE_MIN_COVERAGE):
                # substantial overlap with earlier queries: evaluate
                # eagerly, reusing every shared node result and publishing
                # the new ones (inter-query subexpression sharing)
                ex = PlanExecutor(
                    state.env, device=self.session.device,
                    metrics=self.metrics,
                    node_cache=_NodeCache(self._results, state.key,
                                          ticket.tenant))
                out = ex.run(lw.plan)
                exec_path = "eager_reuse"
            else:
                # cold pipeline: run the fast (staged) path once and
                # publish its root, which seeds subplan reuse for every
                # later query that embeds this one
                out, ex = self._run_staged(state, lw)
                self._results.put(root_key, out, tenant=ticket.tenant)
        else:
            out, ex = self._run_staged(state, lw)
        _wait_for(out)                         # latency = finished work
        ticket.reused_nodes = ex.stats["node_reuses"]
        ticket.evaluated_nodes = ex.stats["node_evals"]
        self._counters["node_reuses"].inc(ex.stats["node_reuses"])
        self._counters["node_evals"].inc(ex.stats["node_evals"])
        if exec_path is None:
            from repro_torch.obs.ledger import exec_path_of
            exec_path = exec_path_of(ex.stats)
        self._ledger_row(state, ticket, lw.plan, exec_path,
                         time.perf_counter() - t0,
                         ex.timings["compile_s"],
                         overflow=ex.stats["sparse_overflows"] > 0)
        self._finish_ticket(ticket, result=out)

    def _ledger_row(self, state: _VersionState, ticket: Ticket, plan,
                    exec_path: str, wall_s: float, compile_s: float,
                    overflow: bool = False) -> None:
        if self.ledger is None:
            return
        try:
            self.ledger.record(
                query=signature(ticket.query), plan=plan,
                exec_path=exec_path, wall_s=wall_s, compile_s=compile_s,
                measured_comm=None, overflow=overflow,
                opt=ticket.opt, trace_id=ticket.trace_id,
                tenant=ticket.tenant)
        except Exception:
            # isolation contract: the audit row is subordinate to the
            # query — a ledger failure (including an injected
            # ``ledger_io`` fault that escaped drop-and-count) is
            # counted, never propagated
            self._counters["ledger_errors"].inc()
            return
        if exec_path != "root_hit":
            self._maybe_refit()

    # -- online calibration ---------------------------------------------------

    # Each background refit fits from at most this many of the ledger's
    # most recent rows: bounded work per fit (a full-history refit would
    # grow O(n) per trigger, O(n²) over a serving session) that also
    # weights the fit toward the current workload regime.
    REFIT_WINDOW_ROWS = 512

    # Convergence backoff cap: while successive fits stay within the
    # model's drift threshold (no version bump) the trigger interval
    # doubles per fit, up to refit_every * this factor.
    REFIT_BACKOFF_MAX = 32

    def _maybe_refit(self) -> None:
        """Count one executed (ledgered) plan; when the backoff interval
        has elapsed, kick a background refit of the session cost model
        from the tail window of the ledger's in-memory rows. The hot
        path pays one lock + counter — fitting happens off-thread, and
        at most one refit runs at a time (a still-running fit skips the
        trigger rather than queue)."""
        if (self.refit_every is None
                or getattr(self.session, "cost_model", None) is None):
            return
        with self._refit_lock:
            self._refit_rows_seen += 1
            if (self._refit_rows_seen - self._refit_last_at
                    < self._refit_interval):
                return
            if (self._refit_thread is not None
                    and self._refit_thread.is_alive()):
                return
            self._refit_last_at = self._refit_rows_seen
            rows = self.ledger.rows()[-self.REFIT_WINDOW_ROWS:]
            t = threading.Thread(target=self._refit, args=(rows,),
                                 daemon=True, name="serve-refit")
            self._refit_thread = t
            t.start()

    def _refit(self, rows) -> None:
        from repro_torch.core.calibrate import device_key
        model = self.session.cost_model
        v0 = model.version
        try:
            faults.check("refit")
            ok = model.fit_from_rows(
                rows, device=device_key(self.session.device))
        except Exception:
            # a crashed refit thread must not take online calibration
            # down with it: count the crash and leave the trigger armed —
            # ``_maybe_refit`` sees the dead thread and relaunches at the
            # next interval
            self._counters["refit_crashes"].inc()
            with self._refit_lock:
                self._refit_last_at = (self._refit_rows_seen
                                       - self._refit_interval)
            return
        if not ok:
            return
        self._counters["refits"].inc()
        self._counters["refit_rows"].inc(len(rows))
        self._costmodel_version.set(model.version)
        with self._refit_lock:
            if model.version != v0:         # regime change: track closely
                self._refit_interval = self.refit_every
            else:                           # converged: back off
                self._refit_interval = min(
                    self._refit_interval * 2,
                    self.refit_every * self.REFIT_BACKOFF_MAX)
        if model.path:
            try:
                model.save()
            except OSError:
                pass  # persistence is best-effort; serving keeps going

    def _run_staged(self, state: _VersionState,
                    lw: buildermod.SharedLowering):
        """Standalone (staged when possible) execution of one plan,
        hardened with the degradation ladder (docs/robustness.md):
        transient staged-path failures (a flaky staged build, an injected
        ``execute`` fault) are retried with exponential backoff up to
        ``exec_retries`` times, then execution falls down to the per-node
        eager path (``stage_jit=False``) — semantically identical, slower,
        and immune to staging failures. Deterministic errors
        (``_NON_RETRYABLE``) propagate immediately. A kernel that raises
        on the card raises on the eager path too: the ladder never trades
        a CUDA kernel for its plain version.

        The staged-function caches live on the shared ``PhysicalPlan``,
        so execution is serialized per plan object across worker
        threads."""
        with self._lock:
            lock = state.plan_locks.setdefault(id(lw.plan),
                                               threading.Lock())
        for attempt in range(self.exec_retries + 1):
            ex = PlanExecutor(state.env, device=self.session.device,
                              metrics=self.metrics)
            try:
                with lock:
                    faults.check("execute", attempt=attempt)
                    out = ex.run(lw.plan)
                return out, ex
            except self._NON_RETRYABLE:
                raise
            except Exception:
                if attempt == self.exec_retries:
                    break           # ladder: degrade instead of raising
                self._counters["exec_retries"].inc()
                time.sleep(self.retry_backoff_s * (2 ** attempt))
        # bottom of the ladder: per-node eager execution never touches
        # the staged-compile seam; a failure here is genuine and
        # propagates to the client through per-ticket containment
        self._counters["degraded_eager"].inc()
        ex = PlanExecutor(state.env, device=self.session.device,
                          stage_jit=False, metrics=self.metrics)
        with lock:
            out = ex.run(lw.plan)
        return out, ex

    # -- introspection --------------------------------------------------------
    def snapshot(self) -> Dict[str, object]:
        """Stats snapshot: the legacy flat counter keys (now views over
        the metrics registry), the shared result-cache stats read
        atomically under that cache's lock, and serve-tier latency /
        queue-wait histogram summaries (p50/p90/p99 from buckets)."""
        out: Dict[str, object] = {
            name: c.value for name, c in self._counters.items()}
        out["arena_nodes"] = int(self._arena_nodes.value)
        out["result_cache"] = self._results.stats_snapshot()
        out["latency"] = self._latency.snapshot()
        out["queue_wait"] = self._queue_wait.snapshot()
        return out


def _wait_for(out) -> None:
    """Wait until the device work behind a result has finished: an event
    recorded after it on the calling thread's current stream, then a wait
    on that event alone (not the whole device). Host-side results (COO
    tensors) have nothing to wait for."""
    value = getattr(out, "value", out)
    if isinstance(value, torch.Tensor) and value.is_cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(value.device))
        event.synchronize()
