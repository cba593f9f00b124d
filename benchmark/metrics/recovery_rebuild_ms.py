"""recovery_rebuild_ms: the rebuild of lost chunks, each survivor hop of
a partial-sum chain (``recovery.chain_hop``) and each fused decode wave
(``ec.decode_wave``), summed over the profiled window per object
recovered (``object_spans.py``)."""
from benchmark import object_spans


def read(run):
    return object_spans.per_object_ms(run, "recovery.chain_hop",
                                      "ec.decode_wave")
