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

    from repro_torch.kernels import registry

    @registry.register("my_kernel", registry.TORCH)
    def _my_kernel_torch(x): ...

    @registry.register("my_kernel", registry.CUDA)
    def _my_kernel_cuda(x): ...
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

TORCH = "torch"
CUDA = "cuda"
BACKENDS = (TORCH, CUDA)


@dataclasses.dataclass
class KernelSpec:
    """One logical kernel: its per-backend impls."""
    name: str
    impls: Dict[str, Callable] = dataclasses.field(default_factory=dict)

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


def register(name: str, backend: str):
    """Decorator: register ``fn`` as the ``backend`` impl of kernel ``name``."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected {BACKENDS}")

    def deco(fn: Callable) -> Callable:
        _REGISTRY.setdefault(name, KernelSpec(name=name)).impls[backend] = fn
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


def _device_of(args: Tuple[Any, ...]) -> torch.device:
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    raise TypeError("kernel dispatch needs at least one tensor argument")


def dispatch(name: str, *args: Any, backend: Optional[str] = None,
             **kw: Any):
    """Run kernel ``name`` on the backend of its tensors' device."""
    chosen = resolve_backend(name, backend, _device_of(args))
    return get(name).impls[chosen](*args, **kw)
