"""Shared, versioned, LRU caches for plans / optimizer results / serving.

One cache class replaces the per-``Session`` plain-dict caches (which
evicted with ``pop(next(iter(...)))`` — insertion order, i.e. FIFO — and
never promoted hits, so a hot recurring query was evicted as readily as a
one-off under serving churn) and backs every serving-tier cache:

* **LRU, not FIFO** — ``get`` moves the entry to the MRU end, so recurring
  queries stay resident while one-offs age out.
* **versioned keys** — callers put the catalog version (or any
  data-dependence fingerprint) *inside* the key; the cache itself is
  version-agnostic, which keeps in-flight queries pinned to the version
  they were planned against while new versions warm up alongside.
  Invariant (docs/serving.md): every cache keyed on data-dependent
  annotations carries the catalog version in its key.
* **thread-safe** — all operations take an internal lock; the serving tier
  hits one shared instance from many worker threads.
* **per-tenant budgets** — entries are attributed to a tenant; a tenant at
  its budget evicts its *own* least-recently-used entry first, so one
  tenant's churn cannot flush another tenant's hot entries (the serving
  tier's cache-isolation knob).
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Hashable, Optional, Tuple


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    tenant_evictions: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


_DEFAULT_TENANT = "_shared"


class VersionedLRU:
    """Thread-safe LRU mapping with optional per-tenant entry budgets.

    ``capacity`` bounds total entries (evict global LRU); ``tenant_budget``
    bounds entries attributed to any single tenant (evict that tenant's
    LRU first). Both bounds hold after every ``put``.
    """

    def __init__(self, capacity: int, tenant_budget: Optional[int] = None,
                 name: Optional[str] = None, registry=None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if tenant_budget is not None and tenant_budget < 1:
            raise ValueError("tenant_budget must be >= 1")
        self.capacity = capacity
        self.tenant_budget = tenant_budget
        self._data: "OrderedDict[Hashable, Tuple[Any, str]]" = OrderedDict()
        self._tenant_counts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self.stats = CacheStats()
        # optional ``obs.metrics.MetricsRegistry``: every stat bump also
        # increments ``cache_<field>{cache=<name>}`` so all caches in a
        # process share one metrics surface; ``stats`` stays the
        # attribute-style compatibility view
        self._counters = None
        if registry is not None:
            labels = {"cache": name} if name else {}
            self._counters = {
                f: registry.counter(f"cache_{f}", **labels)
                for f in ("hits", "misses", "evictions",
                          "tenant_evictions")}

    def _count(self, field: str) -> None:
        """Single increment site per event (lock held by the caller)."""
        setattr(self.stats, field, getattr(self.stats, field) + 1)
        if self._counters is not None:
            self._counters[field].inc()

    def stats_snapshot(self) -> Dict[str, int]:
        """Stats as a dict, read atomically under the cache lock — the
        torn-read-safe form ``ServeEngine.snapshot`` embeds (a bare
        ``dataclasses.asdict(self.stats)`` races concurrent bumps)."""
        with self._lock:
            return dataclasses.asdict(self.stats)

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._data

    def keys(self):
        """LRU→MRU key order (snapshot; for tests and introspection)."""
        with self._lock:
            return list(self._data.keys())

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            hit = self._data.get(key)
            if hit is None:
                self._count("misses")
                return default
            self._data.move_to_end(key)      # the LRU promotion FIFO lacked
            self._count("hits")
            return hit[0]

    def put(self, key: Hashable, value: Any,
            tenant: str = _DEFAULT_TENANT) -> None:
        with self._lock:
            old = self._data.pop(key, None)
            if old is not None:
                self._tenant_counts[old[1]] -= 1
            if (self.tenant_budget is not None
                    and self._tenant_counts.get(tenant, 0)
                    >= self.tenant_budget):
                self._evict_tenant_lru(tenant)
            while len(self._data) >= self.capacity:
                self._evict_global_lru()
            self._data[key] = (value, tenant)
            self._tenant_counts[tenant] = \
                self._tenant_counts.get(tenant, 0) + 1

    def get_or_create(self, key: Hashable, factory: Callable[[], Any],
                      tenant: str = _DEFAULT_TENANT) -> Any:
        """One unified lookup-miss-insert path (replaces the two hand-rolled
        eviction loops in ``core.api``). ``factory`` runs outside the lock —
        concurrent misses on the same key may both compute; last write
        wins, which is safe because entries are pure functions of their
        (versioned) key."""
        sentinel = object()
        hit = self.get(key, sentinel)
        if hit is not sentinel:
            return hit
        value = factory()
        self.put(key, value, tenant=tenant)
        return value

    def tenant_entries(self, tenant: str) -> int:
        with self._lock:
            return self._tenant_counts.get(tenant, 0)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._tenant_counts.clear()

    # -- internal (lock held) -------------------------------------------------
    def _evict_global_lru(self) -> None:
        _, (_, t) = self._data.popitem(last=False)
        self._tenant_counts[t] -= 1
        self._count("evictions")

    def _evict_tenant_lru(self, tenant: str) -> None:
        for k, (_, t) in self._data.items():   # LRU→MRU order
            if t == tenant:
                del self._data[k]
                self._tenant_counts[t] -= 1
                self._count("evictions")
                self._count("tenant_evictions")
                return
