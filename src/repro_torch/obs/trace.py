"""Lightweight thread-safe span tracer for the query lifecycle.

Design constraints (docs/observability.md):

* **Near-zero cost when off.** ``span(...)`` consults one thread-local
  slot; with no active trace on the calling thread it returns a shared
  no-op context manager — no allocation, no locking, no timestamps. The
  default global sample rate is 0.0 (``REPRO_TRACE_SAMPLE`` overrides),
  so un-opted-in workloads pay only the thread-local read.
* **No jit interference.** Spans only read the wall clock and append to a
  Python list; they never touch traced values, change arguments or branch
  on data, so enabling tracing can never retrace a jitted function
  (pinned by ``tests/test_obs.py``). Never open spans *inside* a function
  being ``jax.jit``-traced — they would measure trace time, not run time.
* **Cross-thread traces.** A ``Trace`` is created where the query enters
  (e.g. ``ServeEngine.submit``) and *activated* on whichever worker
  thread executes it (``TRACER.activate(trace)``); spans opened while a
  trace is active on the current thread attach under it. A trace is
  active on at most one thread at a time — activation is a handoff, not
  sharing — so span mutation is single-threaded per trace while the
  tracer itself serves any number of threads, each with its own stack.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional


class Span:
    """One timed section of a trace: name, wall-clock bounds, free-form
    attributes, child spans. Times are ``perf_counter`` seconds."""

    __slots__ = ("name", "t0", "t1", "attrs", "children")

    def __init__(self, name: str, t0: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.name = name
        self.t0 = time.perf_counter() if t0 is None else t0
        self.t1: Optional[float] = None
        self.attrs: Dict[str, Any] = attrs or {}
        self.children: List["Span"] = []

    @property
    def duration(self) -> float:
        """Seconds; open spans measure up to now."""
        return (self.t1 if self.t1 is not None else time.perf_counter()) \
            - self.t0

    def finish(self) -> None:
        if self.t1 is None:
            self.t1 = time.perf_counter()

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "duration_ms": self.duration * 1e3,
            "attrs": dict(self.attrs),
            "children": [c.to_dict() for c in self.children],
        }


_trace_ids = itertools.count(1)


class Trace:
    """One query's span tree, addressed by a process-unique trace id."""

    def __init__(self, name: str, **attrs):
        self.trace_id = f"t{next(_trace_ids)}"
        self.root = Span(name, attrs=attrs)

    def finish(self) -> None:
        self.root.finish()

    def spans(self) -> List[Span]:
        return list(self.root.walk())

    def phase_names(self) -> List[str]:
        """Distinct span names in first-seen order (lifecycle coverage)."""
        seen, out = set(), []
        for s in self.root.walk():
            if s.name not in seen:
                seen.add(s.name)
                out.append(s.name)
        return out

    def render(self) -> str:
        """ASCII span tree with per-span wall time and self time."""
        lines = [f"== trace {self.trace_id} =="]

        def walk(s: Span, indent: int) -> None:
            child_s = sum(c.duration for c in s.children)
            self_ms = (s.duration - child_s) * 1e3
            attrs = " ".join(f"{k}={v}" for k, v in s.attrs.items())
            lines.append(
                f"{'  ' * indent}{s.name}  {s.duration * 1e3:.3f}ms"
                + (f" (self {self_ms:.3f}ms)" if s.children else "")
                + (f"  [{attrs}]" if attrs else ""))
            for c in s.children:
                walk(c, indent + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "root": self.root.to_dict()}


class _NoopSpan:
    """Shared do-nothing context manager: the disabled-tracing fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _ActiveSpan:
    """Context manager that appends a child span to the thread's stack."""

    __slots__ = ("_local", "_span")

    def __init__(self, local, sp: Span):
        self._local = local
        self._span = sp

    def __enter__(self) -> Span:
        self._local.stack.append(self._span)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        self._span.finish()
        if exc_type is not None:
            self._span.attrs["error"] = exc_type.__name__
        popped = self._local.stack.pop()
        assert popped is self._span, "span stack corrupted"
        return False


class _Activation:
    """Context manager binding a trace to the current thread."""

    __slots__ = ("_tracer", "_trace", "_prev")

    def __init__(self, tracer: "Tracer", trace: Optional[Trace]):
        self._tracer = tracer
        self._trace = trace

    def __enter__(self) -> Optional[Trace]:
        local = self._tracer._local
        self._prev = getattr(local, "stack", None)
        local.stack = [self._trace.root] if self._trace is not None else None
        return self._trace

    def __exit__(self, *exc):
        self._tracer._local.stack = self._prev
        return False


class Tracer:
    """Sampling span tracer; one global instance (``TRACER``) serves the
    whole engine, but tests and embedded servers may build their own."""

    def __init__(self, sample_rate: float = 0.0):
        self.sample_rate = float(sample_rate)
        self._local = threading.local()
        self._rng_lock = threading.Lock()
        self._seq = 0

    # -- sampling ------------------------------------------------------------
    def sampled(self) -> bool:
        """Deterministic 1-in-N sampling (rate r → every round(1/r)-th
        start); deterministic so benchmark overhead numbers reproduce."""
        r = self.sample_rate
        if r <= 0.0:
            return False
        if r >= 1.0:
            return True
        period = max(1, round(1.0 / r))
        with self._rng_lock:
            self._seq += 1
            return self._seq % period == 0

    def start(self, name: str, sample: Optional[bool] = None,
              **attrs) -> Optional[Trace]:
        """Begin a trace, or return None when the sampler says no. The
        caller decides where the trace lives (e.g. on a ``Ticket``)."""
        if sample is None:
            sample = self.sampled()
        return Trace(name, **attrs) if sample else None

    # -- span recording ------------------------------------------------------
    def current(self) -> Optional[Span]:
        stack = getattr(self._local, "stack", None)
        return stack[-1] if stack else None

    def active(self) -> bool:
        return bool(getattr(self._local, "stack", None))

    def span(self, name: str, **attrs):
        stack = getattr(self._local, "stack", None)
        if not stack:
            return _NOOP
        sp = Span(name, attrs=attrs or {})
        stack[-1].children.append(sp)
        return _ActiveSpan(self._local, sp)

    def annotate(self, **attrs) -> None:
        """Attach attributes to the innermost open span (no-op when off)."""
        sp = self.current()
        if sp is not None:
            sp.attrs.update(attrs)

    def add_event(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record an already-measured section (e.g. a batch-level phase
        timed once and attributed to each traced ticket in the batch)."""
        sp = self.current()
        if sp is not None:
            ev = Span(name, t0=t0, attrs=attrs or {})
            ev.t1 = t1
            sp.children.append(ev)

    def activate(self, trace: Optional[Trace]) -> _Activation:
        """Bind ``trace`` to the current thread for the with-block;
        ``activate(None)`` is a cheap no-op binding (spans stay off)."""
        return _Activation(self, trace)


TRACER = Tracer(sample_rate=float(os.environ.get("REPRO_TRACE_SAMPLE", "0")))


def span(name: str, **attrs):
    """Module-level shorthand over the global tracer — the form every
    instrumentation site uses: ``with span("optimize", search=...):``."""
    return TRACER.span(name, **attrs)


def annotate(**attrs) -> None:
    TRACER.annotate(**attrs)


def trace_active() -> bool:
    return TRACER.active()
