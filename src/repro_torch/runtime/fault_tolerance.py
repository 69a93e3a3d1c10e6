"""Fault tolerance runtime: heartbeats, failure detection, restart policy.

On a real fleet each host runs a heartbeat agent; the coordinator detects
missed beats and executes a restart policy (replace from reserve pool, else
shrink the mesh and elastically restore from the last checkpoint — see
``checkpoint.ckpt.Checkpointer.restore(shardings=...)``). This module is the
coordinator logic, fully unit-testable on one host with a simulated clock.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Dict, List, Optional, Tuple


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    FAILED = "failed"


@dataclasses.dataclass
class NodeInfo:
    node_id: str
    last_beat: float
    state: NodeState = NodeState.HEALTHY
    missed: int = 0


@dataclasses.dataclass
class RestartPlan:
    action: str                      # none | replace | shrink
    failed: List[str]
    replacements: List[str]
    new_world_size: int
    restore_step: Optional[int] = None


class HeartbeatMonitor:
    """Tracks per-node heartbeats; marks SUSPECT after ``suspect_after``
    seconds and FAILED after ``fail_after`` seconds without a beat."""

    def __init__(self, nodes: List[str], suspect_after: float = 10.0,
                 fail_after: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        now = clock()
        self.nodes: Dict[str, NodeInfo] = {
            n: NodeInfo(n, now) for n in nodes}
        self.suspect_after = suspect_after
        self.fail_after = fail_after

    def beat(self, node_id: str) -> None:
        info = self.nodes[node_id]
        info.last_beat = self.clock()
        info.state = NodeState.HEALTHY
        info.missed = 0

    def add_node(self, node_id: str) -> None:
        """Start tracking a node mid-flight (fresh beat)."""
        self.nodes[node_id] = NodeInfo(node_id, self.clock())

    def force_fail(self, node_id: str) -> None:
        """Mark a node as having missed every beat — used when an
        out-of-band signal (a dead worker thread) proves the node is
        gone without waiting ``fail_after`` wall seconds. The next
        ``sweep`` reports it FAILED."""
        info = self.nodes.get(node_id)
        if info is not None:
            info.last_beat = self.clock() - self.fail_after

    def suspect(self, node_id: str) -> None:
        """Externally mark a node SUSPECT (e.g. the straggler detector's
        persistent-outlier hand-off) unless it is already FAILED."""
        info = self.nodes.get(node_id)
        if info is not None and info.state is not NodeState.FAILED:
            info.state = NodeState.SUSPECT

    def sweep(self) -> List[str]:
        """Returns newly-failed node ids."""
        now = self.clock()
        newly_failed = []
        for info in self.nodes.values():
            if info.state is NodeState.FAILED:
                continue
            silent = now - info.last_beat
            if silent >= self.fail_after:
                info.state = NodeState.FAILED
                newly_failed.append(info.node_id)
            elif silent >= self.suspect_after:
                info.state = NodeState.SUSPECT
        return newly_failed

    def healthy(self) -> List[str]:
        return [n for n, i in self.nodes.items()
                if i.state is NodeState.HEALTHY]


class FaultCoordinator:
    """Restart policy: prefer replacing failed nodes from the reserve pool;
    otherwise shrink the world to the largest feasible mesh and restore."""

    def __init__(self, monitor: HeartbeatMonitor, reserves: List[str],
                 min_world: int = 1, mesh_granularity: int = 1):
        self.monitor = monitor
        self.reserves = list(reserves)
        self.min_world = min_world
        self.gran = mesh_granularity

    def plan(self, last_ckpt_step: Optional[int] = None) -> RestartPlan:
        failed = [n for n, i in self.monitor.nodes.items()
                  if i.state is NodeState.FAILED]
        if not failed:
            return RestartPlan("none", [], [],
                               len(self.monitor.nodes))
        if len(self.reserves) >= len(failed):
            repl = [self.reserves.pop(0) for _ in failed]
            for old, new in zip(failed, repl):
                del self.monitor.nodes[old]
                self.monitor.nodes[new] = NodeInfo(
                    new, self.monitor.clock())
            return RestartPlan("replace", failed, repl,
                               len(self.monitor.nodes),
                               restore_step=last_ckpt_step)
        # shrink: drop failed nodes, round world size down to granularity
        for old in failed:
            del self.monitor.nodes[old]
        world = len(self.monitor.nodes)
        world = max(self.min_world, (world // self.gran) * self.gran)
        if world < self.min_world:
            raise RuntimeError("not enough healthy nodes to continue")
        return RestartPlan("shrink", failed, [], world,
                           restore_step=last_ckpt_step)
