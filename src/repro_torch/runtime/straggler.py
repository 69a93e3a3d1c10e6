"""Straggler mitigation: per-host step-time tracking + outlier response.

Detection: robust z-score (median/MAD) over a ring buffer of recent step
times per host. Response ladder: (1) flag; (2) shift data-loading work away
from the slow host (its shard is served by neighbors' prefetch queues);
(3) if persistent, hand the host to the FaultCoordinator as SUSPECT so the
restart policy can swap in a reserve before it hard-fails.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class StragglerReport:
    slow_hosts: List[str]
    z_scores: Dict[str, float]
    reassignment: Dict[str, str]     # slow host → helper host


class StragglerDetector:
    def __init__(self, hosts: List[str], window: int = 32,
                 z_threshold: float = 3.5, persist: int = 3):
        self.hosts = hosts
        self.window = window
        self.z = z_threshold
        self.persist = persist
        self.times: Dict[str, Deque[float]] = {
            h: deque(maxlen=window) for h in hosts}
        self.strikes: Dict[str, int] = {h: 0 for h in hosts}

    def add_host(self, host: str) -> None:
        """Track a new host (e.g. a replacement serving worker spawned
        by the restart policy) from a cold window."""
        if host not in self.times:
            self.hosts.append(host)
            self.times[host] = deque(maxlen=self.window)
            self.strikes[host] = 0

    def drop_host(self, host: str) -> None:
        """Stop tracking a retired host."""
        if host in self.times:
            self.hosts.remove(host)
            del self.times[host]
            del self.strikes[host]

    def record(self, host: str, step_time: float) -> None:
        if host in self.times:      # retired hosts may still report once
            self.times[host].append(step_time)

    def detect(self) -> StragglerReport:
        means = {h: (np.mean(t) if t else 0.0)
                 for h, t in self.times.items()}
        vals = np.array([v for v in means.values() if v > 0])
        if len(vals) < 2:
            return StragglerReport([], {}, {})
        med = np.median(vals)
        mad = np.median(np.abs(vals - med)) + 1e-9
        zs = {h: float(0.6745 * (m - med) / mad) for h, m in means.items()}
        slow = []
        for h, z in zs.items():
            if z > self.z:
                self.strikes[h] += 1
                if self.strikes[h] >= self.persist:
                    slow.append(h)
            else:
                self.strikes[h] = 0
        helpers = sorted((h for h in self.hosts if h not in slow),
                         key=lambda h: zs.get(h, 0.0))
        reassign = {s: helpers[i % len(helpers)]
                    for i, s in enumerate(slow)} if helpers else {}
        return StragglerReport(slow, zs, reassign)
