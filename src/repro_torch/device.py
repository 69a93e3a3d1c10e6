"""Device resolution for the port.

Every entry point takes an explicit device. ``None`` means the card
(``"cuda"``); a session asked for the card on a machine without one
raises instead of carrying on on the CPU. The CPU is used only when the
caller names it (the tests do).

``worker_devices`` maps the workers of a mesh onto the cards a session
sees, as the JAX package's ``worker_mesh`` takes ``jax.devices()[:n]``:
one worker a card while there are cards enough, contiguous groups of
logical workers on a card beyond that, every worker on the CPU there. A
card the machine does not have raises; nothing moves to fewer cards or
to the CPU.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is present; "
            "pass device='cpu' to run the plain PyTorch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def card_count(device: Union[str, torch.device]) -> int:
    """The devices a session on ``device`` sees: every visible card on
    ``cuda`` (the JAX package's ``jax.device_count()``), one CPU."""
    dev = torch.device(device)
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def worker_devices(n: int, device: Union[str, torch.device],
                   cards: Optional[int] = None) -> Tuple[torch.device, ...]:
    """The device of each of ``n`` workers of a session on ``device``.

    On the CPU every worker is ``cpu``. On ``cuda``, of ``cards`` visible
    cards (``None``: ``torch.cuda.device_count()``), worker i goes on
    card i while n <= cards, else on card ``i * cards // n`` (contiguous
    groups of workers share a card, so one card holds all n). The
    session's own card must be one of them; a machine without cards, or
    without that card, raises."""
    dev = torch.device(device)
    if n < 1:
        raise ValueError(f"a worker mesh needs n >= 1 workers, got {n!r}")
    if dev.type == "cpu":
        return (dev,) * n
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {str(dev)!r}")
    cards = torch.cuda.device_count() if cards is None else int(cards)
    if cards < 1:
        raise RuntimeError(f"device {str(dev)!r} requested but no CUDA "
                           "device is present")
    if dev.index is not None and not 0 <= dev.index < cards:
        raise RuntimeError(f"card {dev.index} requested but only {cards} "
                           "card(s) are visible")
    return tuple(torch.device("cuda", i if n <= cards else i * cards // n)
                 for i in range(n))
