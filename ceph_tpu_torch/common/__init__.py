"""Host services of the port's serving path, copied from ``ceph_tpu.common``:
the option schema and config store, perf counters, the span tracer, the
device-time attribution ledger and the nearest-rank percentile."""
from .options import ConfigProxy, Option, OPTIONS, SCHEMA, parse_size
from .perf_counters import (PerfCounters, PerfCountersBuilder,
                            PerfCountersCollection)
from .tracer import (LATENCY_BUCKETS_S, Span, TraceContext, Tracer,
                     activate_trace, current_trace, default_tracer,
                     new_trace, root_or_ambient, trace_span)
from .context import Context, default_context

__all__ = ["ConfigProxy", "Context", "LATENCY_BUCKETS_S", "OPTIONS",
           "Option", "PerfCounters", "PerfCountersBuilder",
           "PerfCountersCollection", "SCHEMA", "Span", "TraceContext",
           "Tracer", "activate_trace", "current_trace", "default_context",
           "default_tracer", "new_trace", "parse_size", "root_or_ambient",
           "trace_span"]
