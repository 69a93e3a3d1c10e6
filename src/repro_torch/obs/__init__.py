"""Query-engine observability: span tracing, metrics, the cost ledger.

Three pillars, as in the JAX package:

* ``obs.trace`` — a lightweight thread-safe span tracer instrumented
  through the full query lifecycle (lower → optimize → physical_cost →
  schemes_dp → mask_propagation → stage_compile → execute), default-off
  sampling, per-query trace ids carried on serving ``Ticket``s;
* ``obs.metrics`` — process-wide counters / gauges / histograms with
  labeled series and lock-free-read snapshots; the engine, the plan
  caches, the plan executor and the kernel registry report through it;
* ``obs.ledger`` — the predicted-vs-actual cost ledger: one JSONL row per
  executed physical plan with predicted flops/comm/nnz next to measured
  wall time and the staged-build split — the training corpus of the
  calibrated cost model (``core.calibrate``).
"""
from repro_torch.obs.trace import (  # noqa: F401
    Span, Trace, Tracer, TRACER, span, annotate, trace_active,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter, Gauge, Histogram, MetricsRegistry, REGISTRY,
)
from repro_torch.obs.ledger import CostLedger, default_ledger_path  # noqa: F401
