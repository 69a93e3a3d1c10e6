"""Query-engine observability: span tracing (``obs.trace``).

The metrics registry and the predicted-vs-actual cost ledger of the JAX
package wait for a later slice of the port.
"""
from repro_torch.obs.trace import (  # noqa: F401
    Span, Trace, Tracer, TRACER, span, annotate, trace_active,
)
