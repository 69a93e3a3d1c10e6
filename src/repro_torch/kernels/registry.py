"""Kernel registry: logical kernel names → per-backend implementations.

Callers above this layer (``core.executor``, ``core.joins``,
``core.joins_device``, the plan executor) name the *logical* kernel; the
registry runs the implementation that belongs to the tensors' device:

* ``torch`` — the plain PyTorch version; the backend of CPU tensors;
* ``cuda``  — the hand-written CUDA kernel; the backend of CUDA tensors.

There is no fallback between the two: a CUDA tensor runs its kernel or
raises, and the plain version runs only because its tensors lie on the
CPU. An explicit ``backend=`` that disagrees with the tensors' device
raises. The planner annotates each kernel node with the backend of the
session's device (``planned_backend``), so EXPLAIN and dispatch agree.

Faults (the JAX package's ``kernel_dispatch`` seam and circuit breaker,
without its degradation ladder): every dispatch passes the
``kernel_dispatch`` fault seam (``runtime.faults``). A ``cuda`` launch
that fails or is faulted raises; it is counted as
``kernel_dispatch_failures{kernel,backend}`` and feeds the per-backend
``BREAKER``. At its threshold the ``cuda`` backend is quarantined: while
the breaker is open, dispatch raises ``KernelQuarantined`` and launches
nothing; after the cooldown one probe dispatch is let through. The
``torch`` backend plays the JAX package's ``dense`` role: it is never
quarantined and its failures propagate. A refusal of the call's
arguments (``REFUSALS``: a dtype, a shape, a capacity, a merge no kernel
can evaluate), raised before anything is launched, says nothing of the
backend's health: it propagates without being counted and leaves the
breaker as it was, so one caller's unsupported query cannot quarantine
the card for everyone else.

Tiles (the JAX package's autotune metadata, over the CUDA kernels' launch
parameters): a kernel registers its ``tile_grid`` (the candidates, named
by the CUDA kernel's parameter) and ``default_tiles``. ``dispatch`` passes
``tiles=`` to the impl when the caller gives them or, with
``REPRO_AUTOTUNE`` set, when ``autotune.cached_tiles`` has an entry for
the call's shape bucket; the ``torch`` impls ignore them, and a CUDA
wrapper refuses (``ValueError``, before any launch) a tile outside its
grid. Tiles change scheduling, never the result.

    from repro_torch.kernels import registry

    @registry.register("my_kernel", registry.TORCH)
    def _my_kernel_torch(x): ...

    @registry.register("my_kernel", registry.CUDA)
    def _my_kernel_cuda(x): ...
"""
from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.obs.metrics import REGISTRY
from repro_torch.runtime import faults

TORCH = "torch"
CUDA = "cuda"
BACKENDS = (TORCH, CUDA)
# what a wrapper raises when it refuses its arguments before launching
REFUSALS = (ValueError, TypeError, NotImplementedError)
_AUTOTUNE_ENV = "REPRO_AUTOTUNE"

Tiles = Optional[Dict[str, int]]


@dataclasses.dataclass
class KernelSpec:
    """One logical kernel: its per-backend impls and autotune metadata."""
    name: str
    impls: Dict[str, Callable] = dataclasses.field(default_factory=dict)
    tile_grid: Tuple[Dict[str, int], ...] = ()
    default_tiles: Optional[Dict[str, int]] = None

    def backends(self) -> Tuple[str, ...]:
        return tuple(b for b in BACKENDS if b in self.impls)


_REGISTRY: Dict[str, KernelSpec] = {}
_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    """Importing ``repro_torch.kernels.ops`` registers the built-ins."""
    global _BUILTINS_LOADED
    if not _BUILTINS_LOADED:
        import repro_torch.kernels.ops  # noqa: F401  (side effect)
        _BUILTINS_LOADED = True


def register(name: str, backend: str, *,
             tile_grid: Tuple[Dict[str, int], ...] = (),
             default_tiles: Optional[Dict[str, int]] = None):
    """Decorator: register ``fn`` as the ``backend`` impl of kernel ``name``.

    ``tile_grid``/``default_tiles`` attach autotune metadata to the spec;
    the first registration to provide them wins (they describe the kernel,
    not the backend).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")

    def deco(fn: Callable) -> Callable:
        spec = _REGISTRY.setdefault(name, KernelSpec(name=name))
        spec.impls[backend] = fn
        if tile_grid and not spec.tile_grid:
            spec.tile_grid = tuple(dict(t) for t in tile_grid)
        if default_tiles and not spec.default_tiles:
            spec.default_tiles = dict(default_tiles)
        return fn

    return deco


def get(name: str) -> KernelSpec:
    _ensure_builtins()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no kernel {name!r} registered; have {sorted(_REGISTRY)}"
        ) from None


def kernels() -> Tuple[str, ...]:
    _ensure_builtins()
    return tuple(sorted(_REGISTRY))


def backend_for(device: Union[str, torch.device]) -> str:
    """The backend that runs tensors on ``device``."""
    return CUDA if torch.device(device).type == "cuda" else TORCH


def resolve_backend(name: str, backend: Optional[str] = None,
                    device: Union[str, torch.device] = "cpu") -> str:
    """The backend of one dispatch of ``name`` on ``device``; an explicit
    ``backend`` must be that one."""
    spec = get(name)
    native = backend_for(device)
    if backend is not None and backend != native:
        if backend not in BACKENDS:
            raise ValueError(
                f"unknown backend {backend!r}; expected one of {BACKENDS}")
        raise ValueError(
            f"backend {backend!r} does not run tensors on {device!s} "
            f"(their backend is {native!r})")
    if native not in spec.impls:
        raise KeyError(f"kernel {name!r} has no {native!r} impl "
                       f"(has {spec.backends()})")
    return native


def planned_backend(name: str, backend: Optional[str] = None,
                    device: Union[str, torch.device] = "cpu") -> str:
    """Resolve kernel ``name``'s backend at *plan time* for a session on
    ``device`` — the same rule ``dispatch`` applies to the tensors."""
    return resolve_backend(name, backend, device)


def checked_tiles(name: str, tiles: Tiles, grid: Sequence[Dict[str, int]],
                  default: Dict[str, int]) -> Dict[str, int]:
    """The tiles a CUDA wrapper launches with: ``default`` for None or
    empty tiles, else ``tiles`` if they are a member of ``grid``. Anything
    else raises ``ValueError`` before a launch (a refusal, so it never
    feeds the breaker)."""
    if not tiles:
        return default
    if tiles in grid:
        return tiles
    raise ValueError(f"{name}: tiles {tiles} outside its grid "
                     f"{list(grid) or 'none (no launch parameter)'}")


def _device_of(args: Tuple[Any, ...]) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("kernel dispatch needs at least one tensor argument")


class KernelQuarantined(RuntimeError):
    """Dispatch refused: the backend's circuit breaker is open, so nothing
    was launched (and no plain version ran in its place)."""


class CircuitBreaker:
    """Per-backend dispatch circuit breaker (closed → open → half-open).

    ``record_failure`` counts *consecutive* dispatch failures per
    ``cuda`` backend; at ``threshold`` the backend is quarantined
    (``open``): ``quarantined()`` turns true and dispatch raises
    ``KernelQuarantined`` without attempting the launch. After
    ``cooldown_s`` the breaker goes half-open — exactly one in-flight
    probe dispatch is re-admitted; its success closes the breaker, its
    failure re-opens it (fresh cooldown). Every transition feeds the
    metrics registry (``kernel_breaker_*{backend=...}``), so the serving
    tier's snapshot shows quarantines as they happen.

    The ``torch`` backend is never quarantined: it is the plain version
    the kernels are held against, and its failures always propagate.
    """

    def __init__(self, threshold: int = 3, cooldown_s: float = 30.0,
                 clock: Callable[[], float] = time.monotonic,
                 registry=None):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self.clock = clock
        self._lock = threading.Lock()
        # backend → [consecutive_failures, opened_at|None, probing]
        self._state: Dict[str, list] = {}
        self._registry = REGISTRY if registry is None else registry

    def _entry(self, backend: str) -> list:
        return self._state.setdefault(backend, [0, None, False])

    def state(self, backend: str) -> str:
        with self._lock:
            ent = self._entry(backend)
            if ent[1] is None:
                return "closed"
            if self.clock() - ent[1] >= self.cooldown_s:
                return "half-open"
            return "open"

    def quarantined(self, backend: str) -> bool:
        """True when dispatch must refuse ``backend`` right now. In the
        half-open window the first caller is admitted as the probe and
        subsequent callers stay quarantined until the probe resolves."""
        if backend == TORCH:
            return False
        ent = self._state.get(backend)
        if ent is None or ent[1] is None:   # closed: no lock on the hot path
            return False
        with self._lock:
            ent = self._entry(backend)
            if ent[1] is None:
                return False
            if self.clock() - ent[1] < self.cooldown_s:
                return True
            if ent[2]:                  # a probe is already in flight
                return True
            ent[2] = True               # this caller becomes the probe
            self._gauge(backend, 0.5)
            return False

    def record_success(self, backend: str) -> None:
        ent = self._state.get(backend)
        if ent is None or (ent[0] == 0 and ent[1] is None):
            return                          # closed, no streak to reset
        with self._lock:
            ent = self._entry(backend)
            reopened = ent[1] is not None
            ent[0] = 0
            ent[1] = None
            ent[2] = False
        if reopened:
            self._registry.counter("kernel_breaker_closes",
                                   backend=backend).inc()
            self._gauge(backend, 0.0)

    def record_failure(self, backend: str) -> None:
        if backend == TORCH:
            return
        with self._lock:
            ent = self._entry(backend)
            ent[0] += 1
            tripped = ent[0] >= self.threshold or ent[2]
            if tripped:
                ent[1] = self.clock()   # open (or re-open after probe)
                ent[2] = False
        if tripped:
            self._registry.counter("kernel_breaker_trips",
                                   backend=backend).inc()
            self._gauge(backend, 1.0)

    def release_probe(self, backend: str) -> None:
        """The half-open probe ended in a refusal of its arguments, which
        proves nothing either way: the next caller becomes the probe."""
        with self._lock:
            self._entry(backend)[2] = False

    def _gauge(self, backend: str, v: float) -> None:
        self._registry.gauge("kernel_breaker_open", backend=backend).set(v)

    def reset(self) -> None:
        with self._lock:
            self._state.clear()


def _breaker_config() -> Tuple[int, float]:
    return (int(os.environ.get("REPRO_BREAKER_THRESHOLD", "3")),
            float(os.environ.get("REPRO_BREAKER_COOLDOWN", "30.0")))


BREAKER = CircuitBreaker(*_breaker_config())


def dispatch(name: str, *args: Any, backend: Optional[str] = None,
             tiles: Tiles = None, **kw: Any):
    """Run kernel ``name`` on the backend of its tensors' device.

    When ``tiles`` is None and ``REPRO_AUTOTUNE`` is set, previously tuned
    tiles are looked up in the autotune cache (cache-only: dispatch never
    times; populating the cache is ``autotune.best_tiles``'s job). Tiles
    reach the impl only when there are some.

    A ``cuda`` dispatch that fails (or is faulted through the
    ``kernel_dispatch`` seam) raises after feeding the breaker; while the
    breaker is open it raises ``KernelQuarantined`` and launches nothing.
    A refusal of the arguments (``REFUSALS``) raises and feeds nothing.
    """
    chosen = resolve_backend(name, backend, _device_of(args))
    impl = get(name).impls[chosen]
    if chosen == CUDA and BREAKER.quarantined(chosen):
        REGISTRY.counter("kernel_dispatch_quarantined", kernel=name,
                         backend=chosen).inc()
        raise KernelQuarantined(
            f"kernel {name!r}: backend {chosen!r} is quarantined by its "
            f"circuit breaker ({BREAKER.state(chosen)})")
    if tiles is None and _autotune_enabled():
        from repro_torch.kernels import autotune
        tiles = autotune.cached_tiles(name, _arg_shapes(args),
                                      _arg_dtype(args), chosen)
    if tiles is not None:
        kw["tiles"] = tiles
    if chosen == TORCH:
        faults.check("kernel_dispatch", kernel=name, backend=chosen)
        return impl(*args, **kw)
    try:
        faults.check("kernel_dispatch", kernel=name, backend=chosen)
        out = impl(*args, **kw)
    except REFUSALS:
        BREAKER.release_probe(chosen)
        raise
    except Exception:
        # counted and fed to the breaker, then raised: a CUDA tensor has
        # no other backend to run on
        REGISTRY.counter("kernel_dispatch_failures", kernel=name,
                         backend=chosen).inc()
        BREAKER.record_failure(chosen)
        raise
    BREAKER.record_success(chosen)
    return out


def _autotune_enabled() -> bool:
    val = os.environ.get(_AUTOTUNE_ENV, "")
    return val.lower() not in ("", "0", "false", "no", "off")


def _arg_shapes(args: Tuple[Any, ...]) -> Tuple[Tuple[int, ...], ...]:
    return tuple(tuple(a.shape) for a in args if hasattr(a, "shape"))


def _arg_dtype(args: Tuple[Any, ...]) -> str:
    """The first floating payload dtype, numpy-style (``"float32"``), not
    an auxiliary integer argument's (``bloom_probe``'s leading words are
    uint32, its values float); the first dtype where none floats."""
    first = None
    for a in args:
        dt = getattr(a, "dtype", None)
        if not isinstance(dt, torch.dtype):
            continue
        if first is None:
            first = str(dt).replace("torch.", "")
        if dt.is_floating_point:
            return str(dt).replace("torch.", "")
    return first or "float32"
