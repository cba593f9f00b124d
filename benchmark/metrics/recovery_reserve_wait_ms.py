"""recovery_reserve_wait_ms: a PG recovery job's wait for its local and
remote reservations, from ``schedule_backend`` to the last grant (the
scheduler's ``recovery.reserve_wait`` spans), summed over the profiled
window per object recovered (``object_spans.py``)."""
from benchmark import object_spans


def read(run):
    return object_spans.per_object_ms(run, "recovery.reserve_wait")
