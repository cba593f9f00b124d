"""Host services of the port's serving path and OSD backend, copied from
``ceph_tpu.common``: the option schema and config store, perf counters,
the span tracer, the device-time attribution ledger, the nearest-rank
percentile, the admin socket, the op tracker, the wire accounting, the
launch telemetry registry (``jit dump``), the roofline ledger and the
profiler capture windows."""
from .options import ConfigProxy, Option, OPTIONS, SCHEMA, parse_size
from .perf_counters import (PerfCounters, PerfCountersBuilder,
                            PerfCountersCollection)
from .tracer import (LATENCY_BUCKETS_S, Span, TraceContext, Tracer,
                     activate_trace, current_trace, default_tracer,
                     jit_dump, jit_perf_counters, new_trace,
                     root_or_ambient, trace_span)
from .admin_socket import AdminSocket
from .optracker import OpTracker, TrackedOp
from .context import Context, default_context
from .profiler_capture import ProfilerCapture
from . import roofline

__all__ = ["AdminSocket", "ConfigProxy", "Context", "LATENCY_BUCKETS_S",
           "OPTIONS", "OpTracker", "Option", "PerfCounters",
           "PerfCountersBuilder", "PerfCountersCollection",
           "ProfilerCapture", "SCHEMA",
           "Span", "TraceContext", "TrackedOp", "Tracer", "activate_trace",
           "current_trace", "default_context", "default_tracer",
           "jit_dump", "jit_perf_counters", "new_trace", "parse_size",
           "roofline", "root_or_ambient", "trace_span"]
