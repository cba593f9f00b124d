"""recovery_push_ms: a target shard applying a pushed or chained chunk
to its store, HashInfo included (``recovery.push`` spans), summed over
the profiled window per object recovered (``object_spans.py``)."""
from benchmark import object_spans


def read(run):
    return object_spans.per_object_ms(run, "recovery.push")
